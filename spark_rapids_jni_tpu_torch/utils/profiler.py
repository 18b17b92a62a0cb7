"""Query profiler (port of ``utils/profiler.py``): per-plan EXPLAIN
ANALYZE sessions.

* ``with profile_session(plan_json) as prof:`` opens a session around
  one execution; ``runtime_bridge.table_plan_wire`` /
  ``table_plan_resident`` / ``table_stream_wire`` and
  ``factories.run_plan`` open one when ``SPARK_RAPIDS_TPU_PROFILE`` is on
  (:func:`maybe_session`).
* ``plan.run_plan`` brackets each segment (:func:`segment_begin` /
  :func:`segment_end`); instrumented subsystems report into whatever
  segment (or session) is active on their thread: ``buckets`` its
  runner-cache hits and misses, first-call time and padding,
  ``runtime_bridge`` wire serde time and bytes, ``pipeline`` and the
  spill tier stall seconds, ``hbm`` donated bytes, the kernel tier and
  the bucket plane their fallbacks, ``parallel/shuffle.py`` its
  exchanges. Per segment ``execute = wall - compile - serde - stall``
  (clamped at 0), so the splits sum to the segment's wall; what the
  session's wall covers outside every segment is ``boundary`` and
  ``unattributed_s``.
* Compile attribution: :func:`time_first_call` times a freshly built
  runner's first call whole and reports it as compile time. On a CUDA
  device that first call includes the lazy ``nvcc`` build of a kernel
  source (``kernels.build``) and the host work of the call, but not the
  device's own time of its launches, which return before the device
  finishes; no synchronisation is added for it.
* Finished sessions land in a bounded registry, ride flight dumps as the
  ``profile_sessions`` exit section, and are written to
  ``SPARK_RAPIDS_TPU_PROFILE_DUMP`` at exit; :func:`merge_sessions`
  combines dumps of several processes (either package's), and
  :func:`summarize` aggregates segments across sessions.

Every hot hook bails on one module-global bool (``_ACTIVE``) when no
session is open, and the flag gate is cached against
``config.generation()``. This module imports only ``config``,
``flight``, ``lockcheck`` and ``tracing``; the plan-stats hook
(``utils/planstats.py``) is imported lazily at session open and close.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import socket
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

from . import config
from . import flight
from . import lockcheck
from . import tracing

_HOST = socket.gethostname()

_TRUTHY = frozenset({"1", "true", "yes", "on"})

# ---------------------------------------------------------------------------
# flag gate (the metrics._GATE_GEN discipline)
# ---------------------------------------------------------------------------

_GATE_GEN = -1
_GATE_ON = False
_GATE_STATS = False


def _refresh_gate() -> None:
    global _GATE_GEN, _GATE_ON, _GATE_STATS
    v = config.get_flag("PROFILE")
    on = (v is True) or str(v or "").strip().lower() in _TRUTHY
    # the plan-stats store (utils/planstats.py) records per finished
    # session, so PLANSTATS implies auto-sessions; the flags are read
    # here directly (planstats imports metrics which imports us, so it
    # must never be imported at module load)
    s = config.get_flag("PLANSTATS")
    _GATE_STATS = (
        (s is True) or str(s or "").strip().lower() in _TRUTHY
        or bool(str(config.get_flag("PLANSTATS_DIR") or ""))
    )
    # a configured dump path implies profiling, the
    # METRICS_DUMP-implies-METRICS convention
    _GATE_ON = (
        on
        or bool(str(config.get_flag("PROFILE_DUMP") or ""))
        or _GATE_STATS
    )
    _GATE_GEN = config.generation()


def enabled() -> bool:
    """True when auto-sessions should open (cheap cached gate)."""
    if _GATE_GEN != config.generation():
        _refresh_gate()
    return _GATE_ON


def _planstats_on() -> bool:
    """True when finished sessions should append a stats record
    (same cached gate refresh; no planstats import on this path)."""
    if _GATE_GEN != config.generation():
        _refresh_gate()
    return _GATE_STATS


# ---------------------------------------------------------------------------
# session / segment state
# ---------------------------------------------------------------------------

# every OPEN session, in open order; the module-global fallback target
# for notes arriving on threads with no thread-local session (pipeline
# workers decoding for a stream session on the caller thread)
_OPEN: List["ProfileSession"] = []
_OPEN_LOCK = lockcheck.make_lock("profiler.open")

# THE hot-path gate: True iff any session is open anywhere. Every
# note_* hook reads this one bool first, so the no-session cost is a
# global load + branch regardless of the flag plane.
_ACTIVE = False

_TLS = threading.local()  # .sessions: list, .seg: (session, _Seg) or None

# finished session docs, newest last (bounded: a long-lived daemon must
# not grow a profile registry without bound)
_SESSIONS_KEEP = 64
_SESSIONS: "collections.deque" = collections.deque(maxlen=_SESSIONS_KEEP)
_SESSIONS_LOCK = lockcheck.make_lock("profiler.sessions")

_BOUNDARY_KEYS = (
    "compile_s", "serde_s", "serde_bytes_in", "serde_bytes_out",
    "stall_s", "cache_hits", "cache_misses", "pad_rows",
    "pad_waste_bytes", "donated_bytes", "fallbacks", "shuffle_rows",
    "shuffles",
)


class _Seg:
    """Accumulator for one plan segment (summed across stream batches)."""

    __slots__ = (
        "index", "kind", "ops", "calls", "wall_s", "compile_s",
        "serde_s", "stall_s", "cache_hits", "cache_misses", "rows_in",
        "rows_out", "out_bytes", "pad_rows", "pad_waste_bytes",
        "donated_bytes", "fallbacks",
    )

    def __init__(self, index: int, kind: str, ops: Sequence[str]):
        self.index = index
        self.kind = kind
        self.ops = list(ops)
        self.calls = 0
        self.wall_s = 0.0
        self.compile_s = 0.0
        self.serde_s = 0.0
        self.stall_s = 0.0
        self.cache_hits = 0
        self.cache_misses = 0
        self.rows_in = 0
        self.rows_out = 0
        self.out_bytes = 0
        self.pad_rows = 0
        self.pad_waste_bytes = 0
        self.donated_bytes = 0
        self.fallbacks = 0

    def to_doc(self) -> dict:
        execute = max(
            self.wall_s - self.compile_s - self.serde_s - self.stall_s,
            0.0,
        )
        return {
            "index": self.index,
            "kind": self.kind,
            "ops": list(self.ops),
            "calls": self.calls,
            "wall_s": self.wall_s,
            "compile_s": self.compile_s,
            "execute_s": execute,
            "serde_s": self.serde_s,
            "stall_s": self.stall_s,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "launches": self.cache_hits + self.cache_misses,
            "rows_in": self.rows_in,
            "rows_out": self.rows_out,
            "out_bytes": self.out_bytes,
            "pad_rows": self.pad_rows,
            "pad_waste_bytes": self.pad_waste_bytes,
            "donated_bytes": self.donated_bytes,
            "fallbacks": self.fallbacks,
        }


def _schema_token(schema) -> Optional[str]:
    """Normalize a schema argument (ColType sequence or string) to the
    compact comma-joined token the stats store keys on; anything else
    degrades to None — same never-fail rule as :func:`_plan_ops`."""
    if schema is None:
        return None
    if isinstance(schema, str):
        return schema or None
    try:
        return ",".join(c.pretty() for c in schema) or None
    # srt: allow-broad-except(unrecognized schema shape degrades to None; the profiler must never fail the query it observes)
    except Exception:
        return None


def _compact_static(report) -> Optional[dict]:
    """Shrink a plancheck analyze/check report to the prediction fields
    the drift layer compares against — full reports carry per-op
    reasons/schemas that would bloat every stats record."""
    if not isinstance(report, dict):
        return None
    try:
        return {
            "segments": [
                {
                    "kind": s.get("kind"),
                    "ops": list(s.get("ops") or []),
                    "rows_bound": s.get("rows_bound"),
                    "est_hbm_bytes": s.get("est_hbm_bytes"),
                }
                for s in report.get("segments") or []
            ],
            "rows_out_bound": report.get("rows_out_bound"),
            "est_hbm_peak_bytes": report.get("est_hbm_peak_bytes"),
            # statically kernel-eligible op indices (plancheck kernel
            # tier) — lets planstats correlate predicted eligibility
            # with observed kernel.launches/declines
            "kernel_ops": list(report.get("kernel_ops") or []),
        }
    # srt: allow-broad-except(malformed static report degrades to no prediction; the profiler must never fail the query it observes)
    except Exception:
        return None


class ProfileSession:
    """Attribution state for ONE plan/stream execution."""

    def __init__(self, plan=None, label: str = "plan",
                 batches: Optional[int] = None, schema=None,
                 bucket: Optional[int] = None, static=None):
        self.session_id = uuid.uuid4().hex[:16]
        self.label = label
        self.plan = _plan_ops(plan)
        self.pid = os.getpid()
        self.host = _HOST
        self.epoch_ns = time.time_ns()
        # the request trace this session observes (None outside any
        # traced request): lets a tracequery join profile sessions to
        # the flight-ring span tree by one key
        self.trace_id = tracing.current_trace_id()
        self.batches = batches
        # the stats-store key parts + embedded static prediction
        # (planstats drift layer); None when the caller has none
        self.schema = _schema_token(schema)
        self.bucket = int(bucket) if bucket is not None else None
        self.pred = _compact_static(static)
        self._counter_base: Optional[Dict[str, int]] = None
        self.wall_s = 0.0
        self._t0 = time.perf_counter()
        self._lock = lockcheck.make_lock("profiler.session")
        self._segs: Dict[tuple, _Seg] = {}
        self._order: List[tuple] = []
        self.boundary: Dict[str, Any] = {k: 0 for k in _BOUNDARY_KEYS}
        self.boundary["compile_s"] = 0.0
        self.boundary["serde_s"] = 0.0
        self.boundary["stall_s"] = 0.0

    def _seg_for(self, index: int, kind: str, op_names: tuple) -> _Seg:
        key = (index, kind, op_names)
        with self._lock:
            seg = self._segs.get(key)
            if seg is None:
                seg = _Seg(index, kind, op_names)
                self._segs[key] = seg
                self._order.append(key)
            return seg

    def _close(self) -> None:
        self.wall_s = time.perf_counter() - self._t0

    def to_doc(self) -> dict:
        """One JSON-able session record — the profiler's wire format."""
        with self._lock:
            segs = [self._segs[k].to_doc() for k in self._order]
            boundary = dict(self.boundary)
        covered = (
            sum(s["wall_s"] for s in segs)
            + boundary["serde_s"] + boundary["stall_s"]
            + boundary["compile_s"]
        )
        doc = {
            "version": 1,
            "session_id": self.session_id,
            "label": self.label,
            "pid": self.pid,
            "host": self.host,
            "epoch_ns": self.epoch_ns,
            "wall_s": self.wall_s,
            "plan": self.plan,
            "segments": segs,
            "boundary": boundary,
            "unattributed_s": max(self.wall_s - covered, 0.0),
        }
        if self.trace_id is not None:
            doc["trace_id"] = self.trace_id
        if self.batches is not None:
            doc["batches"] = self.batches
        if self.schema is not None:
            doc["schema"] = self.schema
        if self.bucket is not None:
            doc["bucket"] = self.bucket
        if self.pred is not None:
            doc["pred"] = self.pred
        return doc


def _plan_ops(plan) -> Optional[list]:
    """Normalize a plan argument (JSON string, op-dict list, or None)
    to a list of op dicts; anything unparsable degrades to None — a
    profiler must never fail the query it observes."""
    if plan is None:
        return None
    if isinstance(plan, str):
        try:
            plan = json.loads(plan)
        # srt: allow-broad-except(unparsable plan degrades to None; the profiler must never fail the query it observes)
        except Exception:
            return None
    if isinstance(plan, (list, tuple)):
        out = []
        for op in plan:
            if isinstance(op, dict):
                out.append(dict(op))
            else:
                return None
        return out
    return None


def _session_fallback() -> Optional[ProfileSession]:
    """Session for a note with no thread-local binding: the thread's
    innermost session, else the process's most recently opened one
    (worker threads serving a caller-thread session)."""
    stack = getattr(_TLS, "sessions", None)
    if stack:
        return stack[-1]
    open_ = _OPEN  # snapshot the list object; append/pop are atomic
    return open_[-1] if open_ else None


def session_active() -> bool:
    """True iff any profile session is open in this process."""
    return _ACTIVE


def current_session_id() -> Optional[str]:
    """Session id for provenance stamping (``_RESIDENT_META``)."""
    if not _ACTIVE:
        return None
    sess = _session_fallback()
    return sess.session_id if sess is not None else None


# ---------------------------------------------------------------------------
# session scopes
# ---------------------------------------------------------------------------


class _SessionScope:
    """Context manager binding a new session to the opening thread (and
    as the process-wide fallback for worker-thread notes)."""

    def __init__(self, plan=None, label: str = "plan",
                 batches: Optional[int] = None, schema=None,
                 bucket: Optional[int] = None, static=None):
        self._plan = plan
        self._label = label
        self._batches = batches
        self._schema = schema
        self._bucket = bucket
        self._static = static
        self.session: Optional[ProfileSession] = None

    def __enter__(self) -> ProfileSession:
        global _ACTIVE
        sess = ProfileSession(
            self._plan, self._label, self._batches,
            schema=self._schema, bucket=self._bucket,
            static=self._static,
        )
        self.session = sess
        if _planstats_on():
            try:
                from . import planstats
                sess._counter_base = planstats.counter_snapshot()
            # srt: allow-broad-except(stats capture must never fail the query it observes)
            except Exception:
                sess._counter_base = None
        stack = getattr(_TLS, "sessions", None)
        if stack is None:
            stack = _TLS.sessions = []
        stack.append(sess)
        with _OPEN_LOCK:
            _OPEN.append(sess)
            _ACTIVE = True
        # correlate with the flight timeline + stamp the dump's process
        # metadata so multi-process merges can line traces up
        flight.set_process_meta(session_id=sess.session_id)
        if flight.enabled():
            flight.record("I", "profile.session", sess.session_id)
        return sess

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _ACTIVE
        sess = self.session
        if sess is None:
            return False
        sess._close()
        stack = getattr(_TLS, "sessions", None)
        if stack and sess in stack:
            stack.remove(sess)
        with _OPEN_LOCK:
            if sess in _OPEN:
                _OPEN.remove(sess)
            _ACTIVE = bool(_OPEN)
        doc = sess.to_doc()
        with _SESSIONS_LOCK:
            _SESSIONS.append(doc)
        if _planstats_on():
            try:
                from . import planstats
                planstats.record_session(doc, sess._counter_base)
            # srt: allow-broad-except(stats persistence must never fail the query it observes)
            except Exception:
                pass
        return False


class bound_session:
    """Bind an already-OPEN :class:`ProfileSession` to the calling
    thread for the scope's duration.

    The serving daemon's executor threads interleave work from many
    tenants while several sessions are open at once; without an
    explicit binding their notes would fall through to the process-wide
    ``_OPEN[-1]`` fallback — i.e. whichever tenant opened a session
    most recently, not the tenant whose plan is actually running.
    ``sess=None`` is a no-op (work executed outside any stream)."""

    __slots__ = ("_sess",)

    def __init__(self, sess: Optional[ProfileSession]):
        self._sess = sess

    def __enter__(self):
        sess = self._sess
        if sess is not None:
            stack = getattr(_TLS, "sessions", None)
            if stack is None:
                stack = _TLS.sessions = []
            stack.append(sess)
        return sess

    def __exit__(self, exc_type, exc, tb) -> bool:
        sess = self._sess
        if sess is not None:
            stack = getattr(_TLS, "sessions", None)
            if stack and sess in stack:
                stack.remove(sess)
        return False


class _NullScope:
    """Shared no-op scope: the disabled ``maybe_session`` return."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SCOPE = _NullScope()


def profile_session(plan=None, label: str = "plan",
                    batches: Optional[int] = None, schema=None,
                    bucket: Optional[int] = None,
                    static=None) -> _SessionScope:
    """Explicit API: ``with profile_session(plan_json) as prof:`` scopes
    one plan/stream execution; ``prof.to_doc()`` (or
    ``profiler.sessions()[-1]`` after exit) is the structured record.
    Always collects, regardless of the PROFILE flag. ``schema`` /
    ``bucket`` / ``static`` (a plancheck report) key and seed the
    plan-stats record when PLANSTATS is on."""
    return _SessionScope(plan, label, batches, schema=schema,
                         bucket=bucket, static=static)


def maybe_session(plan=None, label: str = "plan",
                  batches: Optional[int] = None, schema=None,
                  bucket: Optional[int] = None, static=None):
    """Auto-session for the runtime_bridge entries: a real scope when
    ``SPARK_RAPIDS_TPU_PROFILE`` is on and this thread has no session
    yet (an explicit outer session owns nested plan runs), else the
    shared no-op — the disabled path is a cached-gate check plus one
    thread-local read."""
    if not enabled():
        return _NULL_SCOPE
    if getattr(_TLS, "sessions", None):
        return _NULL_SCOPE
    return _SessionScope(plan, label, batches, schema=schema,
                         bucket=bucket, static=static)


# ---------------------------------------------------------------------------
# attribution hooks (called by plan/buckets/pipeline/hbm/runtime_bridge)
#
# Every hook's first move is the _ACTIVE load — the no-session cost.
# Notes bind to the thread's current segment when one is open, else to
# the fallback session's boundary bucket (wire serde on pipeline
# workers, stalls between batches).
# ---------------------------------------------------------------------------


def segment_begin(index: int, kind: str, seg_ops: Sequence[dict],
                  rows_in: Optional[int] = None):
    """Open segment ``index`` on this thread; returns an opaque token
    for ``segment_end`` (None when no session is active)."""
    if not _ACTIVE:
        return None
    sess = _session_fallback()
    if sess is None:
        return None
    names = tuple(str(op.get("op", "?")) for op in seg_ops)
    seg = sess._seg_for(index, kind, names)
    with sess._lock:
        seg.calls += 1
        if rows_in:
            seg.rows_in += int(rows_in)
    prev = getattr(_TLS, "seg", None)
    _TLS.seg = (sess, seg)
    return (sess, seg, time.perf_counter(), prev)


def segment_end(token, rows_out: Optional[int] = None,
                out_bytes: int = 0, fallback: bool = False) -> None:
    if token is None:
        return
    sess, seg, t0, prev = token
    dur = time.perf_counter() - t0
    with sess._lock:
        seg.wall_s += dur
        if rows_out:
            seg.rows_out += int(rows_out)
        if out_bytes:
            seg.out_bytes += int(out_bytes)
        if fallback:
            seg.fallbacks += 1
    _TLS.seg = prev


def _target():
    """(session, segment-or-None) the calling thread's notes bind to."""
    entry = getattr(_TLS, "seg", None)
    if entry is not None:
        return entry
    sess = _session_fallback()
    return (sess, None) if sess is not None else (None, None)


def note_cache(hit: bool) -> None:
    """One compiled-executable cache lookup (buckets.cached_jit)."""
    if not _ACTIVE:
        return
    sess, seg = _target()
    if sess is None:
        return
    field = "cache_hits" if hit else "cache_misses"
    with sess._lock:
        if seg is not None:
            setattr(seg, field, getattr(seg, field) + 1)
        else:
            sess.boundary[field] += 1


def note_compile(name: str, seconds: float) -> None:
    """First-call (trace+compile) seconds of a cache-miss executable."""
    if not _ACTIVE:
        return
    sess, seg = _target()
    if sess is None:
        return
    with sess._lock:
        if seg is not None:
            seg.compile_s += seconds
        else:
            sess.boundary["compile_s"] += seconds


def note_serde(direction: str, seconds: float, nbytes: int) -> None:
    """One wire serialize/deserialize pass (``direction`` in/out)."""
    if not _ACTIVE:
        return
    sess, seg = _target()
    if sess is None:
        return
    with sess._lock:
        if seg is not None:
            seg.serde_s += seconds
        else:
            sess.boundary["serde_s"] += seconds
        sess.boundary[
            "serde_bytes_in" if direction == "in" else "serde_bytes_out"
        ] += int(nbytes)


def note_stall(seconds: float) -> None:
    """Pipeline backpressure/input wait seconds (pipeline._note_stall)."""
    if not _ACTIVE:
        return
    sess, seg = _target()
    if sess is None:
        return
    with sess._lock:
        if seg is not None:
            seg.stall_s += seconds
        else:
            sess.boundary["stall_s"] += seconds


def note_pad(pad_rows: int, waste_bytes: int) -> None:
    """Bucket padding applied to a table (buckets._record_pad_metrics)."""
    if not _ACTIVE:
        return
    sess, seg = _target()
    if sess is None:
        return
    with sess._lock:
        if seg is not None:
            seg.pad_rows += int(pad_rows)
            seg.pad_waste_bytes += int(waste_bytes)
        else:
            sess.boundary["pad_rows"] += int(pad_rows)
            sess.boundary["pad_waste_bytes"] += int(waste_bytes)


def note_donation(nbytes: int) -> None:
    """Buffer bytes donated in place (hbm.note_donation)."""
    if not _ACTIVE:
        return
    sess, seg = _target()
    if sess is None:
        return
    with sess._lock:
        if seg is not None:
            seg.donated_bytes += int(nbytes)
        else:
            sess.boundary["donated_bytes"] += int(nbytes)


def note_fallback(kind: str) -> None:
    """A fused/bucketed dispatch fell back to the exact path."""
    if not _ACTIVE:
        return
    sess, seg = _target()
    if sess is None:
        return
    with sess._lock:
        if seg is not None:
            seg.fallbacks += 1
        else:
            sess.boundary["fallbacks"] += 1


def note_shuffle(rows: int) -> None:
    """One mesh shuffle exchange (parallel/shuffle.py)."""
    if not _ACTIVE:
        return
    sess, _seg = _target()
    if sess is None:
        return
    with sess._lock:
        sess.boundary["shuffles"] += 1
        sess.boundary["shuffle_rows"] += int(rows)


def time_first_call(fn, name: str):
    """Wrap a freshly built runner so its FIRST invocation is timed
    whole on the host clock and reported via ``note_compile`` on
    whatever segment launches it. The wrapper is transient (the runner
    cache keeps the raw callable), so steady state pays nothing.

    On a CUDA device the number covers the host side of that first
    call: the lazy ``nvcc`` build of any kernel source it loads first
    (seconds) and the call's host work, but not the device's own time of
    its launches, which return before the device finishes. The JAX
    package's first call is asynchronous in the same way; no
    ``torch.cuda.synchronize()`` is added for it."""
    done = [False]

    def wrapper(*args, **kwargs):
        if done[0]:
            return fn(*args, **kwargs)
        done[0] = True
        # the compile span: trace-tagged on the flight ring, so the
        # request that paid the cache miss shows the trace+compile
        # wall in its merged trace (profiler sits below metrics in the
        # import graph — the tracing span pair is the sanctioned path)
        tok = tracing.span_begin("compile.jit")
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            note_compile(name, time.perf_counter() - t0)
            tracing.span_end(tok)

    wrapper.__name__ = getattr(fn, "__name__", name)
    return wrapper


# ---------------------------------------------------------------------------
# registry / dump / merge plane
# ---------------------------------------------------------------------------


def sessions(reset: bool = False) -> List[dict]:
    """Finished session docs, oldest first (bounded to the last
    ``_SESSIONS_KEEP``)."""
    with _SESSIONS_LOCK:
        out = list(_SESSIONS)
        if reset:
            _SESSIONS.clear()
    return out


def reset() -> None:
    """Drop finished sessions AND abandon open ones (test isolation)."""
    global _ACTIVE, _GATE_GEN
    with _SESSIONS_LOCK:
        _SESSIONS.clear()
    with _OPEN_LOCK:
        _OPEN.clear()
        _ACTIVE = False
    _TLS.sessions = []
    _TLS.seg = None
    _GATE_GEN = -1


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write finished sessions as JSON to ``path`` (default: the
    ``SPARK_RAPIDS_TPU_PROFILE_DUMP`` flag). The flight.dump()
    discipline: failures WARN instead of raising."""
    path = path or str(config.get_flag("PROFILE_DUMP") or "")
    if not path:
        return None
    doc = {
        "version": 1,
        "pid": os.getpid(),
        "host": _HOST,
        "sessions": sessions(),
    }
    try:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        return path
    except OSError as e:
        print(
            f"[srt][profiler][WARN] profile dump to {path!r} failed: {e}",
            file=sys.stderr,
            flush=True,
        )
        return None


def extract_sessions(doc) -> List[dict]:
    """Session docs found in ``doc``: a raw session, a profile dump
    (``{"sessions": [...]}``), a flight dump (``sections.
    profile_sessions``), a bench summary (per-config ``profile``
    blocks), or a list of any of those."""
    out: List[dict] = []
    if isinstance(doc, list):
        for d in doc:
            out.extend(extract_sessions(d))
        return out
    if not isinstance(doc, dict):
        return out
    if "segments" in doc and "session_id" in doc:
        return [doc]
    if isinstance(doc.get("sessions"), list):
        return [s for s in doc["sessions"] if isinstance(s, dict)]
    sections = doc.get("sections")
    if isinstance(sections, dict) and isinstance(
        sections.get("profile_sessions"), list
    ):
        return [
            s for s in sections["profile_sessions"] if isinstance(s, dict)
        ]
    summary = doc.get("parsed") or doc
    for e in summary.get("configs", []) or []:
        prof = e.get("profile") if isinstance(e, dict) else None
        if isinstance(prof, dict):
            # a bench block aggregates but keeps the last few full
            # session docs under "sessions_tail"
            tail = prof.get("sessions_tail") or prof.get("sessions")
            if isinstance(tail, list):
                out.extend(s for s in tail if isinstance(s, dict))
    return out


def merge_sessions(docs: Sequence) -> dict:
    """Combine session/dump docs from multiple processes/hosts into ONE
    report document: sessions ordered on the shared wall-clock timeline
    (``epoch_ns``), with a per-process index keyed by ``(pid, host)`` —
    the multi-process merge the mesh tier's one-dump-per-process
    reality needs."""
    sess: List[dict] = []
    for d in docs:
        sess.extend(extract_sessions(d))
    sess.sort(key=lambda s: (s.get("epoch_ns") or 0, s.get("session_id", "")))
    procs: Dict[tuple, list] = {}
    for s in sess:
        procs.setdefault((str(s.get("host", "?")), s.get("pid")), []).append(
            s.get("session_id")
        )
    return {
        "version": 1,
        "processes": [
            {"host": h, "pid": p, "session_ids": ids}
            for (h, p), ids in sorted(procs.items(), key=lambda kv: (
                kv[0][0], str(kv[0][1]),
            ))
        ],
        "sessions": sess,
    }


def summarize(docs: Optional[Sequence[dict]] = None) -> dict:
    """Aggregate per-segment summary across session docs — the compact
    ``profile`` block bench.py embeds per config (full session docs
    would bloat a many-batch config's record)."""
    if docs is None:
        docs = sessions()
    segs: Dict[tuple, dict] = {}
    order: List[tuple] = []
    wall = 0.0
    for s in docs:
        wall += float(s.get("wall_s") or 0.0)
        for sd in s.get("segments", []) or []:
            key = (sd.get("index"), sd.get("kind"), tuple(sd.get("ops", [])))
            agg = segs.get(key)
            if agg is None:
                agg = {
                    "index": sd.get("index"),
                    "kind": sd.get("kind"),
                    "ops": list(sd.get("ops", [])),
                }
                segs[key] = agg
                order.append(key)
            for f in (
                "calls", "wall_s", "compile_s", "execute_s", "serde_s",
                "stall_s", "cache_hits", "cache_misses", "launches",
                "rows_in", "rows_out", "pad_rows", "pad_waste_bytes",
                "donated_bytes", "fallbacks",
            ):
                agg[f] = agg.get(f, 0) + (sd.get(f) or 0)
    return {
        "sessions": len(list(docs)),
        "wall_s": wall,
        "segments": [segs[k] for k in order],
    }


def _dump_at_exit() -> None:  # pragma: no cover - exercised via subprocess
    dump()


atexit.register(_dump_at_exit)
# finished sessions ride every flight dump: one postmortem file carries
# the timeline AND the per-plan attribution that explains it
flight.register_exit_section("profile_sessions", lambda: sessions())
