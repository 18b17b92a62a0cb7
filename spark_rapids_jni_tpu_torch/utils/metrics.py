"""Named counters, byte counters, timers, gauges, histograms and spans
(the part of ``utils/metrics.py`` the port runs).

Everything ticks only while the ``METRICS`` flag is on; the gate is
cached against the flag plane's generation, so a disabled site costs an
int compare and a disabled :func:`span` returns a shared no-op object.
:func:`snapshot` has the JAX package's keys (``counters``, ``bytes``,
``timers``, ``gauges``, ``histograms``, ``span_self``). :func:`traced`
opens a ``torch.profiler.record_function`` range beside its span. Trace
ranges, the flight recorder, Prometheus export and dumps are not
ported.
"""

from __future__ import annotations

import bisect
import functools
import threading
import time
from typing import Dict, Optional, Sequence

from . import config

_LOCK = threading.RLock()
_COUNTERS: Dict[str, int] = {}
_BYTES: Dict[str, int] = {}
_TIMERS: Dict[str, list] = {}   # name -> [count, total_s, min_s, max_s]
_GAUGES: Dict[str, list] = {}   # name -> [value, high_water]
_HISTS: Dict[str, dict] = {}
_SELF: Dict[str, list] = {}     # name -> [count, self_s]
_DEFAULT_BOUNDS = tuple(4 ** i for i in range(16))
_TLS = threading.local()
_GATE_GEN = -1
_GATE_ENABLED = False

#: Span-duration histogram edges in milliseconds (the JAX package's);
#: ``pipeline.stall_ms`` and ``pipeline.overlap_ms`` share them.
SPAN_MS_BOUNDS = (
    0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0,
    1000.0, 3000.0, 10000.0, 30000.0,
)


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


def bytes_add(name: str, n: int) -> None:
    """Bump a named byte counter (spilled bytes, donated bytes, ...)."""
    if not enabled():
        return
    with _LOCK:
        _BYTES[name] = _BYTES.get(name, 0) + int(n)


def counter_values(names: Sequence[str]) -> Dict[str, int]:
    """Point-in-time values of named counters or byte counters (0 for
    one never ticked)."""
    with _LOCK:
        return {n: int(_COUNTERS.get(n) or _BYTES.get(n) or 0)
                for n in names}


def timer_record(name: str, seconds: float) -> None:
    """Fold one wall-clock duration into a named timer."""
    if not enabled():
        return
    s = float(seconds)
    with _LOCK:
        t = _TIMERS.get(name)
        if t is None:
            _TIMERS[name] = [1, s, s, s]
        else:
            t[0] += 1
            t[1] += s
            t[2] = min(t[2], s)
            t[3] = max(t[3], s)


def gauge_set(name: str, value) -> None:
    """Set a gauge, keeping its high-water mark."""
    if not enabled():
        return
    v = float(value)
    with _LOCK:
        g = _GAUGES.get(name)
        if g is None:
            _GAUGES[name] = [v, v]
        else:
            g[0] = v
            g[1] = max(g[1], v)


def hist_observe(name: str, value,
                 bounds: Optional[Sequence[float]] = None) -> None:
    """Record one observation into a bounded histogram; ``bounds`` (read
    on the first observation of ``name``) are inclusive upper edges, and
    one overflow bucket follows them."""
    if not enabled():
        return
    v = float(value)
    with _LOCK:
        h = _HISTS.get(name)
        if h is None:
            b = tuple(bounds) if bounds else _DEFAULT_BOUNDS
            h = _HISTS[name] = {"bounds": b, "counts": [0] * (len(b) + 1),
                                "count": 0, "sum": 0.0}
        h["counts"][bisect.bisect_left(h["bounds"], v)] += 1
        h["count"] += 1
        h["sum"] += v


def _self_time_record(name: str, seconds: float) -> None:
    with _LOCK:
        t = _SELF.get(name)
        if t is None:
            _SELF[name] = [1, max(seconds, 0.0)]
        else:
            t[0] += 1
            t[1] += max(seconds, 0.0)


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "_t0", "_child_s")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0
        self._child_s = 0.0

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        # recorded on the exception path too
        dur = time.perf_counter() - self._t0
        stack = _TLS.stack
        if stack and stack[-1] is self:
            stack.pop()
        if stack:
            stack[-1]._child_s += dur
        timer_record(self.name, dur)
        _self_time_record(self.name, dur - self._child_s)
        hist_observe("span_ms." + self.name, dur * 1e3, bounds=SPAN_MS_BOUNDS)
        if exc_type is not None:
            counter_add("span." + self.name + ".errors")
        return False


def span(name: str, **attrs):
    """Context manager: a named, nestable timed region. Its duration goes
    to the timer ``name`` (exception path included), its self time (the
    duration less its child spans on the same thread) to ``span_self``,
    and a ``span_ms.<name>`` histogram. ``attrs`` are accepted for the
    JAX package's call sites and not recorded. Returns a shared no-op
    object while the plane is off."""
    if not enabled():
        return NULL_SPAN
    return _Span(name)


def traced(name: str):
    """Decorator form of :func:`span` (the JAX package's
    ``metrics.traced``): the function body under ``span(name)`` and a
    ``torch.profiler.record_function`` range of the same name."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            from torch.profiler import record_function

            with span(name), record_function(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def snapshot() -> dict:
    """Everything measured so far, with the JAX package's keys."""
    with _LOCK:
        return {
            "counters": dict(_COUNTERS),
            "bytes": dict(_BYTES),
            "timers": {
                k: {"count": int(t[0]), "total_s": float(t[1]),
                    "min_s": float(t[2]), "max_s": float(t[3])}
                for k, t in _TIMERS.items()
            },
            "gauges": {k: {"value": g[0], "high_water": g[1]}
                       for k, g in _GAUGES.items()},
            "histograms": {
                k: {"bounds": list(h["bounds"]), "counts": list(h["counts"]),
                    "count": int(h["count"]), "sum": float(h["sum"])}
                for k, h in _HISTS.items()
            },
            "span_self": {k: {"count": int(t[0]), "self_s": float(t[1])}
                          for k, t in _SELF.items()},
        }


def reset() -> None:
    """Clear everything measured."""
    with _LOCK:
        for table in (_COUNTERS, _BYTES, _TIMERS, _GAUGES, _HISTS, _SELF):
            table.clear()
