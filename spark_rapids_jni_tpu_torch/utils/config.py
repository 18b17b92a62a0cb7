"""The flag plane of the port (the part of ``utils/config.py`` it runs).

Flags are ``SPARK_RAPIDS_TPU_*`` environment variables, the same names
the JAX package reads, with an override set through :func:`set_flag`
taking precedence. Ported flags:

* ``KERNELS`` — the kernel tier (``kernels/registry.py``): ``on`` tries
  every applicable kernel route, ``off`` never, ``auto`` (the default)
  only for tables whose tensors are on a CUDA device. Any other value
  raises :class:`ValueError`.
* ``METRICS`` — the counters of ``utils/metrics.py``.

Every :func:`set_flag`/:func:`clear_flag` bumps :func:`generation`, the
key the hot-path gates cache their reading against.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

_PREFIX = "SPARK_RAPIDS_TPU_"


def _as_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


def _parse_kernels(v: str) -> str:
    got = v.strip().lower()
    if got not in ("on", "off", "auto"):
        raise ValueError(f"KERNELS must be on|off|auto, got {v!r}")
    return got


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str
    default: Any
    parse: Callable[[str], Any]
    doc: str

    @property
    def env_var(self) -> str:
        return _PREFIX + self.name


_FLAGS = {
    f.name: f
    for f in [
        Flag("METRICS", False, _as_bool,
             "op-level metrics counters (utils/metrics.py)"),
        Flag("KERNELS", "auto", _parse_kernels,
             "kernel tier (kernels/registry.py): on | off | auto (the "
             "default: only for tables on a CUDA device)"),
    ]
}

_overrides: dict = {}
_generation = 0


def generation() -> int:
    return _generation


def get_flag(name: str):
    """Current value of a declared flag (override > env > default)."""
    flag = _FLAGS[name]
    if name in _overrides:
        return _overrides[name]
    raw = os.environ.get(flag.env_var)
    if raw is None:
        return flag.default
    return flag.parse(raw)


def set_flag(name: str, value) -> None:
    global _generation
    if name not in _FLAGS:
        raise KeyError(f"unknown flag {name!r}")
    _overrides[name] = _FLAGS[name].parse(value) if isinstance(value, str) else value
    _generation += 1


def clear_flag(name: str) -> None:
    global _generation
    _overrides.pop(name, None)
    _generation += 1
