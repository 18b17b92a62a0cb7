"""Profiler ranges and the request trace context (port of
``utils/tracing.py``).

The reference toggles NVTX ranges from Java
(``ai.rapids.cudf.nvtx.enabled``) and Nsight Systems shows them. Here
:func:`trace_range` / :func:`annotate` open a
``torch.profiler.record_function`` range (it shows in a
``torch.profiler`` trace, :func:`capture_trace`) and, on a CUDA device,
an NVTX range (``torch.cuda.nvtx.range_push``/``range_pop``) that Nsight
Systems shows. Both follow ``SPARK_RAPIDS_TPU_TRACE``: with the flag off
a range is a shared no-op object behind one cached gate check, and
nothing is opened.

On top of the ranges this module owns the **trace context**: a
per-request ``trace_id``/``span_id`` pair held in a ``contextvars``
ambient context, carried across a wire as a W3C-traceparent header, and
stamped onto every span the metrics plane records into the flight ring:

* the context is AMBIENT: ``activate(ctx)`` binds it on the current
  thread; calls and same-thread retries inherit it, so a replay never
  mints a new trace;
* contexts do not flow into pool threads by themselves: the pipeline
  captures the submitter's at ``Pending`` construction and re-activates
  it around the work body;
* span records reuse the flight ring's event path: the traceparent rides
  as the ``arg`` of the span's ``"B"`` event (:func:`span_begin` /
  :func:`span_end`; disabled, one cached gate check);
* instants recorded by code that never heard of tracing are attributed
  after the fact by :func:`assign_trace_ids`.

The tail-sampled slow-request log (:func:`note_request` /
:func:`slow_requests`) keeps the top-K finished requests by duration,
with span detail only for those that breached ``TRACE_SLO_MS`` or ended
in an error. :func:`to_chrome_trace` / :func:`merge_chrome_traces` turn
flight dumps into Chrome-trace JSON, as the JAX package's do.
"""

from __future__ import annotations

import contextlib
import contextvars
import heapq
import itertools
import os
import re
import sys
import time
from typing import Iterator, List, Optional

from . import config
from . import flight
from . import lockcheck

# cached gate (the metrics._GATE_GEN discipline): TRACE's reading and
# whether NVTX ranges can be pushed (a CUDA build with a device)
_GATE_GEN = -1
_GATE_ON = False
_NVTX = False


def _refresh_gate() -> None:
    global _GATE_GEN, _GATE_ON, _NVTX
    _GATE_ON = bool(config.get_flag("TRACE"))
    if _GATE_ON:
        import torch

        _NVTX = torch.cuda.is_available()
    _GATE_GEN = config.generation()


def tracing_enabled() -> bool:
    """True when profiler ranges open (cheap cached gate)."""
    if _GATE_GEN != config.generation():
        _refresh_gate()
    return _GATE_ON


class _NullRange:
    """Shared no-op range: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_RANGE = _NullRange()


class _Range:
    """A ``record_function`` range, plus an NVTX range on CUDA."""

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self):
        from torch.profiler import record_function

        self._rf = record_function(self.name)
        self._rf.__enter__()
        if _NVTX:
            import torch

            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        rf, self._rf = self._rf, None
        rf.__exit__(exc_type, exc, tb)
        return False


def trace_range(name: str):
    """Named range in the profiler timeline (and on CUDA the NVTX
    timeline); a shared no-op unless TRACE is on."""
    if _GATE_GEN != config.generation():
        _refresh_gate()
    if not _GATE_ON:
        return _NULL_RANGE
    return _Range(name)


def annotate(name: Optional[str] = None):
    """Decorator form: wraps a function body in a trace_range."""

    def wrap(fn):
        import functools

        label = name or fn.__qualname__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with trace_range(label):
                return fn(*args, **kwargs)

        return inner

    return wrap


# ---------------------------------------------------------------------------
# Trace context — per-request identity threaded through every layer
# ---------------------------------------------------------------------------


class TraceContext:
    """One request's identity: ``trace_id`` (32 hex chars, shared by
    every span of the request across threads and processes) plus
    ``span_id`` (16 hex chars, this hop). ``header`` is the precomputed
    W3C-traceparent wire form (``00-<trace_id>-<span_id>-01``) so the
    hot tagging path is an attribute read, not a format call."""

    __slots__ = ("trace_id", "span_id", "header")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id
        self.header = f"00-{trace_id}-{span_id}-01"

    def __repr__(self) -> str:
        return f"TraceContext({self.header})"


_CTX: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("srt_trace_ctx", default=None)
)

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def new_context(trace_id: Optional[str] = None) -> TraceContext:
    """Mint a context: a fresh trace when ``trace_id`` is None, else a
    new hop span under the given trace. THE id mint."""
    return TraceContext(trace_id or new_trace_id(), new_span_id())


def child_context(ctx: TraceContext) -> TraceContext:
    """A new hop under ``ctx``'s trace (the receiver side of a wire
    hop: same trace_id, fresh span_id)."""
    return new_context(ctx.trace_id)


def format_traceparent(ctx: TraceContext) -> str:
    """Wire encoding for hello/command headers (serving/frames.py)."""
    return ctx.header


def parse_traceparent(value) -> Optional[TraceContext]:
    """Wire header -> :class:`TraceContext`. Anything malformed (wrong
    field widths, non-hex, all-zero ids, the reserved ``ff`` version)
    degrades to None — a bad peer header must never fail the request
    it arrived on. Future versions with the same field shape are
    accepted, per the W3C forward-compatibility rule."""
    if not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff" or set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return TraceContext(trace_id, span_id)


def current() -> Optional[TraceContext]:
    """The ambient context (None outside any traced request)."""
    return _CTX.get()


def current_traceparent() -> Optional[str]:
    """Wire/tag form of the ambient context — THE hot tagging path
    (one contextvar read + one attribute access), called once per span
    begin by metrics._Span."""
    ctx = _CTX.get()
    return None if ctx is None else ctx.header


def current_trace_id() -> Optional[str]:
    ctx = _CTX.get()
    return None if ctx is None else ctx.trace_id


class activate:
    """Bind ``ctx`` as the ambient trace context for the scope's
    duration (``None`` = no-op scope). Restores the previous binding on
    exit, exception path included. This is how captured contexts cross
    thread hops: scheduler workers and pipeline workers re-activate the
    submitter's context around each work item."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._token = None

    def __enter__(self) -> Optional[TraceContext]:
        if self._ctx is not None:
            self._token = _CTX.set(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        return False


# cached gate (the metrics._GATE_GEN discipline): the context plane is
# live when the flight ring records (trace spans are only observable
# through it) or the TRACE flag is on
_CTX_GEN = -1
_CTX_ON = False


def context_enabled() -> bool:
    """True when serving should mint/propagate trace contexts (cheap
    cached gate, invalidated by config.generation())."""
    global _CTX_GEN, _CTX_ON
    if _CTX_GEN != config.generation():
        _CTX_ON = bool(config.get_flag("TRACE")) or flight.enabled()
        _CTX_GEN = config.generation()
    return _CTX_ON


def ensure_context(traceparent=None) -> Optional[TraceContext]:
    """Server-side context establishment for ONE incoming request: a
    valid peer header joins that trace with a fresh hop span id (a
    retried or replayed request therefore keeps its original trace —
    replay must never mint a new one), no header mints a fresh context
    when the plane is on, and a disabled plane yields None."""
    ctx = parse_traceparent(traceparent)
    if ctx is not None:
        return child_context(ctx)
    if context_enabled():
        return new_context()
    return None


def span_begin(name: str):
    """Trace-layer span open: one trace-tagged ``"B"`` event on the
    flight ring (the traceparent rides as the event arg). Returns the
    token ``span_end`` closes; None when the ring is off — the
    disabled path is one cached gate check, the flight ``record()``
    cost class (asserted within 2x of disabled record() in tests).
    Callers below metrics in the import graph (profiler) use this
    pair; everything else gets the same tagging through
    ``metrics.span``."""
    if not flight.enabled():
        return None
    ctx = _CTX.get()
    flight.record("B", name, None if ctx is None else ctx.header)
    return name


def span_end(token, error: Optional[str] = None) -> None:
    """Close a :func:`span_begin` span (no-op on a None token)."""
    if token is not None:
        flight.record("E", token, error)


# ---------------------------------------------------------------------------
# tail-sampled slow-request log — the serving `trace` command's data
# ---------------------------------------------------------------------------

_SLOW_LOCK = lockcheck.make_lock("tracing.slow")
_SLOW: List[tuple] = []  # min-heap of (ms, seq, record)
_SLOW_SEQ = itertools.count()


def note_request(label: str, duration_ms: float, *,
                 trace_id: Optional[str] = None,
                 session: Optional[str] = None,
                 error: Optional[str] = None,
                 spans=None) -> None:
    """Feed one FINISHED request into the slow-request log: top-K by
    duration (``SPARK_RAPIDS_TPU_TRACE_TOPK``), tail-sampled — the
    ``spans`` detail is kept only when the request breached the SLO
    threshold (``SPARK_RAPIDS_TPU_TRACE_SLO_MS``) or ended in a typed
    error, so the always-on cost stays one cached gate plus a bounded
    heap push. ``spans`` may be a callable evaluated only when the
    record samples in (pulling span detail out of the flight tail is
    itself not free)."""
    if not context_enabled():
        return
    slo_ms = float(config.get_flag("TRACE_SLO_MS"))
    topk = int(config.get_flag("TRACE_TOPK"))
    ms = float(duration_ms)
    rec: dict = {"label": str(label), "ms": round(ms, 3),
                 "t_s": time.time()}
    if trace_id:
        rec["trace_id"] = trace_id
    if session:
        rec["session"] = session
    if error:
        rec["error"] = str(error)
    if error or ms >= slo_ms:
        detail = spans() if callable(spans) else spans
        if detail:
            rec["spans"] = detail
    with _SLOW_LOCK:
        heapq.heappush(_SLOW, (ms, next(_SLOW_SEQ), rec))
        while len(_SLOW) > topk:
            heapq.heappop(_SLOW)


def slow_requests() -> List[dict]:
    """The slow-request log, slowest first (bounded to TRACE_TOPK)."""
    with _SLOW_LOCK:
        items = sorted(_SLOW, key=lambda t: (t[0], t[1]), reverse=True)
    return [dict(rec) for _, _, rec in items]


def reset_requests() -> None:
    """Drop the slow-request log (test isolation; serving restarts)."""
    with _SLOW_LOCK:
        del _SLOW[:]


# ---------------------------------------------------------------------------
# trace attribution over flight events — the tracequery substrate
# ---------------------------------------------------------------------------


def assign_trace_ids(events) -> List[dict]:
    """Annotate flight-event dicts with the trace that owns them.

    Per thread, walked in seq order: a ``"B"`` whose arg parses as a
    traceparent opens a trace scope; every event recorded while a scope
    is open inherits the innermost scope's trace id — so instants
    emitted by code that never heard of tracing (``mesh.replay``,
    ``shuffle.giveup``, compile-cache misses) land in the right
    request. Returns copies with a ``trace_id`` key added where one
    applies; events outside any scope pass through untagged. Tolerates
    older/partial dumps (missing seq/tid/arg keys, non-dict rows)."""
    out: List[dict] = []
    stacks: dict = {}  # tid -> [(name, trace_id-or-None), ...]
    evs = [e for e in events if isinstance(e, dict)]
    for e in sorted(evs, key=lambda e: e.get("seq", 0)):
        tid = e.get("tid", 0)
        stack = stacks.setdefault(tid, [])
        ph, name = e.get("ph"), e.get("name", "?")
        e = dict(e)
        if ph == "B":
            ctx = parse_traceparent(e.get("arg"))
            trace = ctx.trace_id if ctx is not None else (
                stack[-1][1] if stack else None
            )
            stack.append((name, trace))
        elif ph == "E":
            trace = stack[-1][1] if stack else None
            # same top-down match as the Chrome exporter: an E closes
            # the innermost open span with its name
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == name:
                    trace = stack.pop(i)[1]
                    break
        else:
            trace = stack[-1][1] if stack else None
        if trace:
            e["trace_id"] = trace
        out.append(e)
    return out


def trace_span_records(events, trace_id: str) -> List[dict]:
    """Flattened span/instant records of ONE trace: the compact span
    detail the slow-request log samples and tests assert on. Begin/end
    pairs are matched per thread into ``{name, tid, t_ns, dur_ms}``
    records (plus ``error`` from the E arg); unmatched opens — the
    kill-mid-stage case — come back with ``unterminated: true``;
    instants keep their payload under ``arg``."""
    spans: List[dict] = []
    open_: dict = {}  # tid -> stack of B events
    for e in assign_trace_ids(events):
        if e.get("trace_id") != trace_id:
            continue
        ph = e.get("ph")
        tid = e.get("tid", 0)
        if ph == "B":
            open_.setdefault(tid, []).append(e)
        elif ph == "E":
            stack = open_.get(tid) or []
            begin = None
            for i in range(len(stack) - 1, -1, -1):
                if stack[i].get("name") == e.get("name"):
                    begin = stack.pop(i)
                    break
            rec: dict = {"name": e.get("name", "?"), "tid": tid}
            if begin is not None:
                rec["t_ns"] = begin.get("t_ns", 0)
                rec["dur_ms"] = round(
                    (e.get("t_ns", 0) - begin.get("t_ns", 0)) / 1e6, 3
                )
            if e.get("arg") is not None:
                rec["error"] = e["arg"]
            spans.append(rec)
        elif ph in ("I", "C"):
            rec = {"name": e.get("name", "?"), "tid": tid,
                   "t_ns": e.get("t_ns", 0), "instant": True}
            if e.get("arg") is not None:
                rec["arg"] = e["arg"]
            spans.append(rec)
    for tid, stack in open_.items():
        for b in stack:
            spans.append({
                "name": b.get("name", "?"), "tid": tid,
                "t_ns": b.get("t_ns", 0), "unterminated": True,
            })
    spans.sort(key=lambda r: r.get("t_ns", 0))
    return spans


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export of flight-recorder events
#
# The flight recorder (utils/flight.py) captures span begin/end,
# instants and counter samples with perf_counter_ns timestamps + thread
# ids; this converter turns that tail into the Chrome Trace Event JSON
# that chrome://tracing and https://ui.perfetto.dev load directly —
# the Nsight-timeline role for a postmortem that has no live profiler
# attached. Pure stdlib: usable from tools/trace2chrome.py on a dump
# file long after the process that wrote it died.
# ---------------------------------------------------------------------------


def _chrome_cat(name: str) -> str:
    """Category = the subsystem prefix of the LEAF span (dispatch,
    wire, bucketed, shuffle, distributed, resident, ...) so Perfetto
    can filter by plane. Span names are qualified paths
    ('dispatch.sort_by/bucketed.sort_by'): the leaf segment names the
    subsystem that actually ran, not the outermost wrapper."""
    leaf = name.rsplit("/", 1)[-1]
    return leaf.split(".", 1)[0] if "." in leaf else leaf


def to_chrome_trace(
    events,
    pid: int = 0,
    process_name: Optional[str] = None,
    process_sort_index: Optional[int] = None,
    t0_ns: Optional[int] = None,
) -> dict:
    """Flight-recorder event dicts -> a Chrome Trace Event JSON object.

    ``events`` is the ``tail_records()`` / flight-dump ``"events"``
    list. Span begin/end pairs are matched per thread into complete
    ``"X"`` events (ts/dur in microseconds), which keeps the file valid
    even when the ring's wraparound or a mid-span crash broke the
    pairing:

    * an ``E`` whose ``B`` fell off the ring becomes an ``X`` starting
      at the timeline origin with ``args.truncated_begin`` — the span
      was already running when the recorder's window opened;
    * a ``B`` that never saw its ``E`` (the SIGTERM/abort case — the
      exact spans the flight recorder exists to explain) becomes an
      ``X`` running to the end of the timeline with
      ``args.unterminated``.

    ``I`` events become instants (``ph:"i"``), ``C`` events become
    counter tracks (``ph:"C"``, one series per name). Thread-name
    metadata rows give each tid a stable label; ``process_name`` /
    ``process_sort_index`` label the process track (a multi-process
    merge passes "host:pid" per dump so timelines stop colliding on tid
    alone), and ``t0_ns`` pins the timeline origin so several dumps
    share one clock (``merge_chrome_traces``).
    """
    # tolerate older/partial flight formats: non-dict rows are dropped,
    # missing keys degrade (tid 0, t_ns 0, unknown ph -> instant)
    evs = sorted(
        (e for e in events if isinstance(e, dict)),
        key=lambda e: e.get("seq", 0),
    )
    if not evs:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(e.get("t_ns", 0) for e in evs) if t0_ns is None else t0_ns
    t_end = max(e.get("t_ns", 0) for e in evs)

    def us(t_ns: int) -> float:
        return round((t_ns - t0) / 1e3, 3)

    out = []
    tids: list = []
    open_spans: dict = {}  # tid -> stack of B events
    for e in evs:
        tid = e.get("tid", 0)
        if tid not in open_spans:
            open_spans[tid] = []
            tids.append(tid)
        ph, name = e.get("ph", "I"), e.get("name", "?")
        if "t_ns" not in e:
            e = dict(e, t_ns=t0)
        if ph == "B":
            open_spans[tid].append(e)
        elif ph == "E":
            stack = open_spans[tid]
            begin = None
            # match from the top down: a same-thread E always closes
            # the innermost open span with its name; mismatches (lost
            # B's) leave deeper frames alone
            for i in range(len(stack) - 1, -1, -1):
                if stack[i]["name"] == name:
                    begin = stack.pop(i)
                    break
            x = {
                "name": name,
                "cat": _chrome_cat(name),
                "ph": "X",
                "pid": pid,
                "tid": tid,
            }
            args = {}
            if e.get("arg") is not None:
                args["error"] = e["arg"]
            if begin is not None and begin.get("arg") is not None:
                # a trace-tagged span: the traceparent rode the B arg
                args["traceparent"] = begin["arg"]
            if begin is None:
                x["ts"] = us(t0)
                x["dur"] = us(e["t_ns"])
                args["truncated_begin"] = True
            else:
                x["ts"] = us(begin["t_ns"])
                x["dur"] = round((e["t_ns"] - begin["t_ns"]) / 1e3, 3)
            if args:
                x["args"] = args
            out.append(x)
        elif ph == "C":
            arg = e.get("arg", 0)
            if isinstance(arg, (int, float)):
                out.append({
                    "name": name,
                    "ph": "C",
                    "pid": pid,
                    "tid": tid,
                    "ts": us(e["t_ns"]),
                    "args": {"value": arg},
                })
            else:
                # a counter sample with a non-numeric payload would
                # break the Chrome counter track (and used to be
                # dropped silently): keep it visible as an instant
                # carrying the string form
                out.append({
                    "name": name,
                    "cat": _chrome_cat(name),
                    "ph": "i",
                    "s": "t",
                    "pid": pid,
                    "tid": tid,
                    "ts": us(e["t_ns"]),
                    "args": {"arg": str(arg)},
                })
        else:  # "I" and anything future-shaped degrades to an instant
            ev = {
                "name": name,
                "cat": _chrome_cat(name),
                "ph": "i",
                "s": "t",
                "pid": pid,
                "tid": tid,
                "ts": us(e["t_ns"]),
            }
            if e.get("arg") is not None:
                ev["args"] = {"arg": e["arg"]}
            out.append(ev)
    # crash case: spans still open at the end of the tail run to t_end
    for tid, stack in open_spans.items():
        for begin in stack:
            args = {"unterminated": True}
            if begin.get("arg") is not None:
                args["traceparent"] = begin["arg"]
            out.append({
                "name": begin["name"],
                "cat": _chrome_cat(begin["name"]),
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "ts": us(begin["t_ns"]),
                "dur": round((t_end - begin["t_ns"]) / 1e3, 3),
                "args": args,
            })
    meta = [{
        "name": "process_name",
        "ph": "M",
        "pid": pid,
        "tid": 0,
        "args": {"name": process_name or "spark-rapids-tpu"},
    }]
    if process_sort_index is not None:
        meta.append({
            "name": "process_sort_index",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"sort_index": int(process_sort_index)},
        })
    for i, tid in enumerate(tids):
        meta.append({
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"name": f"thread-{i} ({tid})"},
        })
        meta.append({
            "name": "thread_sort_index",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"sort_index": i},
        })
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def merge_chrome_traces(dumps) -> dict:
    """Several flight dumps -> ONE Chrome/Perfetto trace with one
    process track per dump.

    Each dump's ``perf_counter_ns`` timestamps are epoch-less and
    process-local; the wall-clock anchors every dump carries
    (``epoch_ns`` + ``anchor_perf_ns``, utils/flight.py) shift each
    event to wall time, and the earliest event across ALL dumps becomes
    the shared origin — so two processes' timelines line up the way
    they actually overlapped. Per dump: its own ``pid`` (bumped on
    collision — two hosts can reuse a pid), a ``process_name`` of
    "host:pid" (plus the profiler session id when stamped), and a
    ``process_sort_index`` preserving input order."""
    prepped = []
    for d in dumps:
        evs = [
            e for e in (d.get("events") or [])
            if isinstance(e, dict) and "t_ns" in e
        ]
        if not evs:
            continue
        epoch = d.get("epoch_ns")
        anchor = d.get("anchor_perf_ns")
        shift = (epoch - anchor) if (
            epoch is not None and anchor is not None
        ) else 0
        evs = [dict(e, t_ns=e["t_ns"] + shift) for e in evs]
        prepped.append((d, evs))
    if not prepped:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    origin = min(e["t_ns"] for _, evs in prepped for e in evs)
    merged: list = []
    used_pids: set = set()
    for i, (d, evs) in enumerate(prepped):
        pid = int(d.get("pid") or (i + 1))
        while pid in used_pids:
            pid += 1
        used_pids.add(pid)
        name = f"{d.get('host', '?')}:{d.get('pid', pid)}"
        sid = d.get("session_id")
        if sid:
            name = f"{name} [{str(sid)[:8]}]"
        tr = to_chrome_trace(
            evs, pid=pid, process_name=name, process_sort_index=i,
            t0_ns=origin,
        )
        merged.extend(tr["traceEvents"])
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


@contextlib.contextmanager
def capture_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA
    activity when a device is there) and export it as a Chrome trace
    into ``log_dir`` (``trace-<pid>-<n>.json``).

    Creates ``log_dir`` if missing, and WARNs (ungated) when the capture
    leaves the directory empty, which means the profiler never attached.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    path = os.path.join(
        log_dir, f"trace-{os.getpid()}-{next(_CAPTURES)}.json")
    try:
        prof.export_chrome_trace(path)
    except (OSError, RuntimeError) as e:
        print(f"[srt][trace][WARN] capture_trace export failed: {e}",
              file=sys.stderr, flush=True)
    if not any(files for _, _, files in os.walk(log_dir)):
        print(
            f"[srt][trace][WARN] capture_trace({log_dir!r}) produced no "
            "files — the profiler backend likely never attached; the "
            "capture is empty",
            file=sys.stderr,
            flush=True,
        )


_CAPTURES = itertools.count()
