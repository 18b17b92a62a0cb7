"""Op-level metrics registry and structured spans (port of
``utils/metrics.py``).

* A process-wide, thread-safe registry of named **counters**, **byte
  counters**, **wall-clock timers**, bounded **histograms** and
  high-water **gauges**; every mutator no-ops while the plane is off
  (``SPARK_RAPIDS_TPU_METRICS``, or a ``METRICS_DUMP`` path, or the
  plan-statistics store, which diffs counters around every session).
* ``span(name, **attrs)``: a nestable timed region (thread-local stack)
  recording its duration, self time and a ``span_ms.*`` histogram, its
  ``B``/``E`` events on the flight ring stamped with the active
  traceparent (``FLIGHT``), a ``tracing.trace_range`` of its qualified
  name (``TRACE``: a ``record_function`` range and, on CUDA, an NVTX
  range), and one stderr line when ``LOG_LEVEL`` admits TRACE.
  :func:`traced` is its decorator form; :func:`span_stack` gives the
  open spans' qualified names (the leak report's allocation sites).
* The export plane: :func:`snapshot` (the JAX package's keys),
  :func:`prometheus_text`, and :func:`dump` to ``METRICS_DUMP`` at
  interpreter exit.

The gate is cached against the flag plane's generation, so a disabled
span costs one int compare and returns a shared no-op object.
"""

from __future__ import annotations

import atexit
import bisect
import functools
import json
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from . import config
from . import flight
from . import log
from . import tracing

# ---------------------------------------------------------------------------
# registry state — one lock guards every table; mutations are a few dict
# ops so contention stays negligible under concurrent dispatch.
# RLock, not Lock: a signal handler on the MAIN thread that calls
# snapshot()/dump() while that same thread is inside a mutator's
# critical section must not self-deadlock.
# ---------------------------------------------------------------------------

_LOCK = threading.RLock()
_COUNTERS: Dict[str, int] = {}
_BYTES: Dict[str, int] = {}
# name -> [count, total_s, min_s, max_s]
_TIMERS: Dict[str, List[float]] = {}
# name -> [value, high_water]
_GAUGES: Dict[str, List[float]] = {}
# name -> {"bounds": tuple, "counts": list, "count": int, "sum": float}
_HISTS: Dict[str, dict] = {}
# name -> [count, total_s] of span SELF time (duration minus enclosed
# child spans on the same thread): total time alone buries the hot
# leaf under its wrappers
_SELF: Dict[str, List[float]] = {}

# bounded histogram default: powers of 4 from 1 to ~10^9 (17 buckets
# incl. overflow) — sized for row counts and byte volumes
_DEFAULT_BOUNDS = tuple(4 ** i for i in range(16))

_TLS = threading.local()

# Gate cache, invalidated by config.generation(): a disabled
# instrumentation site costs one int compare + attribute read instead
# of re-reading os.environ per call (measured ~6us/span uncached vs
# ~0.2us cached — the difference between "near-zero" and 0.5% of a
# small dispatch). Flags flipped via config.set_flag/clear_flag are
# picked up immediately; raw mid-process os.environ writes are not
# (see config.generation()).
_GATE_GEN = -1
_GATE_ENABLED = False
_GATE_SPAN = False
_GATE_FLIGHT = False


def _refresh_gate() -> None:
    global _GATE_GEN, _GATE_ENABLED, _GATE_SPAN, _GATE_FLIGHT
    _GATE_ENABLED = (
        bool(config.get_flag("METRICS"))
        or bool(config.get_flag("METRICS_DUMP"))
        # the plan-stats store diffs counters around every profile
        # session (utils/planstats.py) — stats with all-zero spill/
        # retry/shed columns would be silently wrong, so PLANSTATS
        # pulls the registry on with it
        or bool(config.get_flag("PLANSTATS"))
        or bool(str(config.get_flag("PLANSTATS_DIR") or ""))
    )
    _GATE_FLIGHT = flight.enabled()
    _GATE_SPAN = (
        _GATE_ENABLED
        or _GATE_FLIGHT
        or tracing.tracing_enabled()
        or log.enabled("TRACE", "span")
    )
    _GATE_GEN = config.generation()


def enabled() -> bool:
    """True when the metrics plane is on — instrumentation sites guard
    expensive field construction with this (the log.enabled() pattern);
    a configured dump path implies collection."""
    if _GATE_GEN != config.generation():
        _refresh_gate()
    return _GATE_ENABLED


# ---------------------------------------------------------------------------
# mutators — every one no-ops when the plane is off, so un-guarded call
# sites stay near-zero too
# ---------------------------------------------------------------------------


def counter_add(name: str, n: int = 1) -> None:
    """Bump a named event counter (op calls, rows, retries, ...)."""
    if not enabled():
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def bytes_add(name: str, n: int) -> None:
    """Bump a named byte counter (wire traffic, planned HBM, ...)."""
    if not enabled():
        return
    with _LOCK:
        _BYTES[name] = _BYTES.get(name, 0) + int(n)


def counter_values(names: Sequence[str]) -> Dict[str, int]:
    """Point-in-time values of named counters/byte-counters (0 when a
    name was never ticked) — the cheap targeted read planstats diffs
    around each profile session, vs snapshot() which copies every
    table."""
    with _LOCK:
        return {
            n: int(_COUNTERS.get(n) or _BYTES.get(n) or 0) for n in names
        }


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
            if s < t[2]:
                t[2] = s
            if s > t[3]:
                t[3] = s


def gauge_set(name: str, value) -> None:
    """Set a gauge, tracking its high-water mark (resident handles,
    planned capacities)."""
    if not enabled():
        return
    v = float(value)
    with _LOCK:
        g = _GAUGES.get(name)
        if g is None:
            _GAUGES[name] = [v, v]
        else:
            g[0] = v
            if v > g[1]:
                g[1] = v


def self_time_record(name: str, seconds: float) -> None:
    """Fold one span SELF-time observation (duration minus child spans)
    into the ``span_self`` table."""
    if not enabled():
        return
    s = max(float(seconds), 0.0)
    with _LOCK:
        t = _SELF.get(name)
        if t is None:
            _SELF[name] = [1, s]
        else:
            t[0] += 1
            t[1] += s


def hist_observe(
    name: str, value, bounds: Optional[Sequence[float]] = None
) -> None:
    """Record one observation into a bounded histogram. ``bounds`` (used
    only on the first observation of ``name``) are inclusive upper bucket
    edges; one overflow bucket is appended."""
    if not enabled():
        return
    v = float(value)
    with _LOCK:
        h = _HISTS.get(name)
        if h is None:
            b = tuple(bounds) if bounds else _DEFAULT_BOUNDS
            h = _HISTS[name] = {
                "bounds": b,
                "counts": [0] * (len(b) + 1),
                "count": 0,
                "sum": 0.0,
            }
        h["counts"][bisect.bisect_left(h["bounds"], v)] += 1
        h["count"] += 1
        h["sum"] += v


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


# span-duration histogram edges in MILLISECONDS: ~x3 rungs from 10us to
# 30s + overflow. Public: subsystem-owned duration histograms
# (pipeline.stall_ms / pipeline.overlap_ms) share these edges so
# percentiles line up across planes.
SPAN_MS_BOUNDS = (
    0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0,
    1000.0, 3000.0, 10000.0, 30000.0,
)


class _Span:
    __slots__ = ("name", "attrs", "qualname", "_t0", "_trace_cm",
                 "_child_s")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.qualname = name
        self._t0 = 0.0
        self._trace_cm = None
        self._child_s = 0.0

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        # nesting: the qualified name carries the enclosing span path so
        # the TRACE line / profiler range shows WHERE the op ran; the
        # timer aggregates under the plain name so repeated ops fold
        # into one stable registry row
        self.qualname = (
            stack[-1].qualname + "/" + self.name if stack else self.name
        )
        stack.append(self)
        if tracing.tracing_enabled():
            self._trace_cm = tracing.trace_range(self.qualname)
            self._trace_cm.__enter__()
        if _GATE_FLIGHT:
            # the ambient trace context rides the B arg (one contextvar
            # read; None outside a traced request, and flight omits
            # None args) — the join key tracequery/assign_trace_ids
            # merge per-process dumps on
            flight.record("B", self.qualname, tracing.current_traceparent())
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        # duration is recorded on the exception path too: a span that
        # dies mid-op is exactly the one the telemetry must explain
        dur = time.perf_counter() - self._t0
        if _GATE_FLIGHT:
            flight.record(
                "E", self.qualname,
                None if exc_type is None else exc_type.__name__,
            )
        stack = getattr(_TLS, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        if self._trace_cm is not None:
            self._trace_cm.__exit__(exc_type, exc, tb)
            self._trace_cm = None
        timer_record(self.name, dur)
        if _GATE_ENABLED:
            # self time: what THIS span spent outside its children —
            # the parent (still on the stack, same thread) absorbs our
            # whole duration into its child accumulator
            if stack:
                stack[-1]._child_s += dur
            self_time_record(self.name, dur - self._child_s)
            hist_observe(
                "span_ms." + self.name, dur * 1e3, bounds=SPAN_MS_BOUNDS
            )
        if exc_type is not None:
            counter_add("span." + self.name + ".errors")
        if log.enabled("TRACE", "span"):
            log.log(
                "TRACE", "span", self.qualname,
                dur_ms=round(dur * 1e3, 3),
                ok=exc_type is None,
                **self.attrs,
            )
        return False


def span(name: str, **attrs):
    """Context manager: a named, nestable timed region.

    Records duration into the timer registry under ``name`` (exception
    path included) plus self-time and a ``span_ms.*`` duration
    histogram, emits begin/end events into the flight recorder when
    ``SPARK_RAPIDS_TPU_FLIGHT`` is on, opens a profiler ``trace_range``
    when ``SPARK_RAPIDS_TPU_TRACE`` is on, and emits one
    ``[srt][span][TRACE]`` stderr line when the log level admits it.
    Returns a shared no-op object when every plane is off — the
    hot-path cost of a disabled span is one generation compare on the
    cached gate.
    """
    if _GATE_GEN != config.generation():
        _refresh_gate()
    if not _GATE_SPAN:
        return NULL_SPAN
    return _Span(name, attrs)


def traced(name: Optional[str] = None):
    """Decorator form of :func:`span` (tracing.annotate's metrics-aware
    sibling): wraps the function body in ``span(name or qualname)``."""

    def wrap(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return inner

    return wrap


def span_depth() -> int:
    """Current nesting depth on this thread (test/introspection aid)."""
    stack = getattr(_TLS, "stack", None)
    return len(stack) if stack else 0


def span_stack() -> tuple:
    """Qualified names of the spans open on THIS thread, outermost
    first — the allocation provenance the resident-table leak report
    attaches to each handle."""
    stack = getattr(_TLS, "stack", None)
    return tuple(s.qualname for s in stack) if stack else ()


# ---------------------------------------------------------------------------
# export plane
# ---------------------------------------------------------------------------


def snapshot() -> dict:
    """One JSON-able dict of everything measured so far."""
    with _LOCK:
        return {
            "counters": dict(_COUNTERS),
            "bytes": dict(_BYTES),
            "timers": {
                k: {
                    "count": int(t[0]),
                    "total_s": float(t[1]),
                    "min_s": float(t[2]),
                    "max_s": float(t[3]),
                }
                for k, t in _TIMERS.items()
            },
            "gauges": {
                k: {"value": g[0], "high_water": g[1]}
                for k, g in _GAUGES.items()
            },
            "histograms": {
                k: {
                    "bounds": list(h["bounds"]),
                    "counts": list(h["counts"]),
                    "count": int(h["count"]),
                    "sum": float(h["sum"]),
                }
                for k, h in _HISTS.items()
            },
            "span_self": {
                k: {"count": int(t[0]), "self_s": float(t[1])}
                for k, t in _SELF.items()
            },
        }


def _prom_name(name: str) -> str:
    """Registry name -> Prometheus metric name: ``srt_`` prefix, dots
    and every other non-[a-zA-Z0-9_] character become underscores."""
    return "srt_" + "".join(
        c if (c.isalnum() or c == "_") else "_" for c in name
    )


def prometheus_text(snap: Optional[dict] = None) -> str:
    """Prometheus text-exposition rendering of the metrics snapshot —
    the serving daemon's ``trace`` command returns this alongside the
    slow-request log so one scrape-shaped payload carries the whole
    registry. Counters/bytes render as ``counter``, gauges as ``gauge``
    (plus a ``_high_water`` series), timers as a summary-shaped
    ``_count``/``_total_seconds`` pair, histograms as a classic
    cumulative ``_bucket{le=...}`` family."""
    if snap is None:
        snap = snapshot()
    lines: List[str] = []

    def emit(name: str, kind: str, series) -> None:
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in series:
            lines.append(f"{name}{labels} {value}")

    for k in sorted(snap.get("counters", {})):
        emit(_prom_name(k) + "_total", "counter",
             [("", snap["counters"][k])])
    for k in sorted(snap.get("bytes", {})):
        emit(_prom_name(k) + "_bytes_total", "counter",
             [("", snap["bytes"][k])])
    for k in sorted(snap.get("gauges", {})):
        g = snap["gauges"][k]
        emit(_prom_name(k), "gauge", [("", g["value"])])
        emit(_prom_name(k) + "_high_water", "gauge",
             [("", g["high_water"])])
    for k in sorted(snap.get("timers", {})):
        t = snap["timers"][k]
        base = _prom_name(k) + "_seconds"
        emit(base + "_count", "counter", [("", t["count"])])
        emit(base + "_total", "counter", [("", t["total_s"])])
    for k in sorted(snap.get("histograms", {})):
        h = snap["histograms"][k]
        base = _prom_name(k)
        lines.append(f"# TYPE {base} histogram")
        cum = 0
        for bound, n in zip(h["bounds"], h["counts"]):
            cum += n
            lines.append(f'{base}_bucket{{le="{bound}"}} {cum}')
        cum += h["counts"][len(h["bounds"])] if (
            len(h["counts"]) > len(h["bounds"])
        ) else 0
        lines.append(f'{base}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{base}_count {h['count']}")
        lines.append(f"{base}_sum {h['sum']}")
    for k in sorted(snap.get("span_self", {})):
        s = snap["span_self"][k]
        base = _prom_name(k) + "_self_seconds"
        emit(base + "_count", "counter", [("", s["count"])])
        emit(base + "_total", "counter", [("", s["self_s"])])
    return "\n".join(lines) + "\n" if lines else ""


def reset() -> None:
    """Clear the registry (test isolation; per-measurement blocks)."""
    with _LOCK:
        _COUNTERS.clear()
        _BYTES.clear()
        _TIMERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
        _SELF.clear()


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write the snapshot as JSON to ``path`` (default: the
    ``SPARK_RAPIDS_TPU_METRICS_DUMP`` flag). Returns the path written,
    or None when no path is configured. Failures WARN on stderr instead
    of raising — a broken dump path must not take the process down at
    exit."""
    path = path or str(config.get_flag("METRICS_DUMP") or "")
    if not path:
        return None
    try:
        with open(path, "w") as f:
            json.dump(snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path
    except OSError as e:
        print(
            f"[srt][metrics][WARN] metrics dump to {path!r} failed: {e}",
            file=sys.stderr,
            flush=True,
        )
        return None


def _dump_at_exit() -> None:  # pragma: no cover - exercised via subprocess
    dump()


atexit.register(_dump_at_exit)
