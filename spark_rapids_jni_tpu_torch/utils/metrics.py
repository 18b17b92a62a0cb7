"""Named event counters (the part of ``utils/metrics.py`` the port runs).

Counters tick only while the ``METRICS`` flag is on; the gate is cached
against the flag plane's generation, so a disabled site costs an int
compare. Spans, timers, Prometheus export and dumps are not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence

from . import config

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {}
_GATE_GEN = -1
_GATE_ENABLED = False


def enabled() -> bool:
    """True when the metrics plane is on."""
    global _GATE_GEN, _GATE_ENABLED
    g = config.generation()
    if g != _GATE_GEN:
        _GATE_ENABLED = bool(config.get_flag("METRICS"))
        _GATE_GEN = g
    return _GATE_ENABLED


def counter_add(name: str, n: int = 1) -> None:
    """Bump a named event counter; a no-op while the plane is off."""
    if not enabled():
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def counter_values(names: Sequence[str]) -> Dict[str, int]:
    """Point-in-time values of named counters (0 for one never ticked)."""
    with _LOCK:
        return {n: int(_COUNTERS.get(n, 0)) for n in names}


def snapshot() -> dict:
    """Everything counted so far, as the JAX package's snapshot shapes
    its ``counters`` table."""
    with _LOCK:
        return {"counters": dict(_COUNTERS)}


def reset() -> None:
    """Clear every counter."""
    with _LOCK:
        _COUNTERS.clear()
