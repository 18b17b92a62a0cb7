"""Structured log lines (port of ``utils/log.py``, in full).

One knob gates every channel::

    SPARK_RAPIDS_TPU_LOG_LEVEL = OFF|ERROR|WARN|INFO|DEBUG|TRACE

``SPARK_RAPIDS_TPU_ALLOC_LOG_LEVEL`` overrides the level for the
allocation channels (``hbm``, ``handles``), so a user can trace memory
planning alone. The fault, spill and HBM planes call it.

Format: one line per event to stderr::

    [srt][<channel>][<LEVEL>] <msg> key=value ...

Lines go to stderr unbuffered, so they never corrupt stdout protocols.
"""

from __future__ import annotations

import sys

LEVELS = {
    "OFF": 0,
    "ERROR": 1,
    "WARN": 2,
    "INFO": 3,
    "DEBUG": 4,
    "TRACE": 5,
}

_ALLOC_CHANNELS = frozenset({"hbm", "handles"})

# (flag, value) pairs already warned about — an invalid level must be
# reported exactly once, not on every gated call
_WARNED_INVALID: set = set()


def _warn_invalid_level(flag: str, value: str, fallback: str) -> None:
    """One-time, ungated WARN for a typo'd level value: the user
    explicitly asked for logging, so silently mapping the typo to OFF
    (the pre-fix behavior) silenced the one person who opted in."""
    key = (flag, value)
    if key in _WARNED_INVALID:
        return
    _WARNED_INVALID.add(key)
    print(
        f"[srt][log][WARN] invalid {flag}={value!r} "
        f"(expected {'|'.join(LEVELS)}); falling back to {fallback}",
        file=sys.stderr,
        flush=True,
    )


def _resolve_level(channel: str) -> int:
    from . import config

    if channel in _ALLOC_CHANNELS and config.flag_is_set(
        "ALLOC_LOG_LEVEL"
    ):
        alloc = str(config.get_flag("ALLOC_LOG_LEVEL")).upper()
        if alloc in LEVELS:
            # an explicitly SET value overrides in both directions:
            # ALLOC_LOG_LEVEL=OFF really silences hbm/handles even
            # under LOG_LEVEL=DEBUG
            return LEVELS[alloc]
        # invalid value: fall back to LOG_LEVEL rather than silently
        # killing the channel
        _warn_invalid_level(
            "SPARK_RAPIDS_TPU_ALLOC_LOG_LEVEL", alloc, "LOG_LEVEL"
        )
    level = str(config.get_flag("LOG_LEVEL")).upper()
    got = LEVELS.get(level)
    if got is None:
        default = str(config.flag_default("LOG_LEVEL")).upper()
        _warn_invalid_level("SPARK_RAPIDS_TPU_LOG_LEVEL", level, default)
        got = LEVELS.get(default, 0)
    return got


def enabled(level: str, channel: str = "general") -> bool:
    """True when an event at ``level`` on ``channel`` would print —
    callers guard expensive field construction with this."""
    return LEVELS.get(level, 0) <= _resolve_level(channel) and LEVELS.get(
        level, 0
    ) > 0


def log(level: str, channel: str, msg: str, **fields) -> None:
    """Emit one observability line if the channel's level admits it."""
    if not enabled(level, channel):
        return
    suffix = "".join(f" {k}={v}" for k, v in fields.items())
    print(
        f"[srt][{channel}][{level}] {msg}{suffix}",
        file=sys.stderr,
        flush=True,
    )
