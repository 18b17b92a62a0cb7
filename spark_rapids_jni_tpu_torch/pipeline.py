"""Pipelined dispatch plane: host/device overlap for batch streams
(port of ``pipeline.py``, in full).

* a **bounded worker pool** (``SPARK_RAPIDS_TPU_PIPELINE=<depth>|off``,
  default off) runs host-side stage work — wire decode
  (``runtime_bridge._table_from_wire``) and wire encode
  (``_table_to_wire``) — on background threads while the caller thread
  drives the plan, with **backpressure** at the configured depth;
* **ordered completion** via :class:`Pending` handles, resolved in input
  order at the blocking points (``table_download_wire`` /
  ``table_num_rows`` / the stream driver's final collect);
* a **sync-replay error contract**: a worker failure is replayed
  synchronously on the resolving thread, so pipelining can change
  timing, never results or which error surfaces.

On CUDA the stages also overlap on the card. A worker runs its stage on
a CUDA stream of its own (:func:`device_lane`, one per thread and role:
``decode`` or ``encode``), with its thread's device set to the table's.
Decode stages the wire buffers in pinned host memory, copies them with
``copy_(non_blocking=True)`` and records an event (:func:`mark`); the
plan runs on the caller's current stream, which first waits on that
event (:func:`hand_over`), and every uploaded tensor is marked as used
by it (``record_stream``), so the caching allocator cannot hand a block
to a later decode while the plan still reads it. Encode of batch N-1
waits on an event recorded after its plan, copies device -> host on its
own stream into pinned buffers and synchronises that event alone, so it
never waits behind batch N's kernels. The hand kernels launch on the
current stream (``kernels.stream_of``) and follow whichever stream a
plan runs on.

Telemetry: a ``pipeline.depth`` gauge, ``pipeline.stall_ms`` (time
blocked on backpressure or an unfinished stage) and
``pipeline.overlap_ms`` (worker busy time: host work that ran beside the
caller) histograms, ``pipeline.enqueued``/``completed``/``stalls``/
``replays`` counters, and a ``pipeline.<stage>`` span on the worker.
"""

from __future__ import annotations

import contextlib
import queue
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence

import torch

from .utils import (
    config, faults, flight, lockcheck, log, metrics, profiler, tracing,
)

DEFAULT_DEPTH = 2
MAX_DEPTH = 64
# serde stages are numpy/copy-bound: a couple of workers saturate the
# host memory bus; more would only add GIL churn
MAX_WORKERS = 4

_OFF_VALUES = frozenset({"", "off", "none", "false", "disabled", "no", "0"})
_ON_VALUES = frozenset({"on", "true", "yes"})

# marks pool worker threads: a worker resolving a failed dependency
# must PROPAGATE, not replay (see Pending.resolve)
_WORKER_TLS = threading.local()


def in_worker() -> bool:
    """True on a pipeline pool worker thread."""
    return bool(getattr(_WORKER_TLS, "on", False))


class DependencyFailed(Exception):
    """Internal marker: a stage failed while materializing its INPUTS,
    before its own work touched (or consumed) anything. Work closures
    raise it on worker threads so the blocking point knows a sync
    replay is safe even for non-replayable (donated) work — nothing
    was consumed yet. Never surfaces to callers: resolve() unwraps it
    (``__cause__`` carries the real error)."""


def _parse_depth(raw) -> int:
    got = str(raw).strip().lower()
    if got in _OFF_VALUES:
        return 0
    if got in _ON_VALUES:
        return DEFAULT_DEPTH
    try:
        d = int(got)
    except ValueError:
        # a typo'd depth must fail loudly, not silently run sync under
        # the wrong label (the SPARK_RAPIDS_TPU_BUCKETS discipline)
        raise ValueError(
            f"SPARK_RAPIDS_TPU_PIPELINE must be <depth>|on|off, "
            f"got {raw!r}"
        ) from None
    if d < 0 or d > MAX_DEPTH:
        # loud, like a typo'd string: a silently clamped depth would
        # run with a different backpressure bound than configured
        raise ValueError(
            f"SPARK_RAPIDS_TPU_PIPELINE depth must be 0..{MAX_DEPTH}, "
            f"got {d}"
        )
    return d


# depth cache, invalidated by config.generation(): a dispatch-path
# check costs an int compare
_DEPTH = 0
_DEPTH_GEN = -1
_DEPTH_LOCK = lockcheck.make_lock("pipeline.depth")


def depth() -> int:
    """Configured pipeline depth (0 = synchronous dispatch). Flipping
    the flag off also tears the live pool down (workers exit after the
    queued jobs drain; the GIL switch interval is restored)."""
    global _DEPTH, _DEPTH_GEN
    gen = config.generation()
    if _DEPTH_GEN != gen:
        with _DEPTH_LOCK:
            if _DEPTH_GEN != gen:
                _DEPTH = _parse_depth(config.get_flag("PIPELINE"))
                _DEPTH_GEN = gen
        if _DEPTH == 0:
            _teardown_pool()
    return _DEPTH


def _teardown_pool() -> None:
    global _POOL
    with _POOL_LOCK:
        if _POOL is not None:
            _POOL.shutdown()
            _POOL = None


def enabled() -> bool:
    """True when resident dispatch enqueues instead of blocking."""
    return depth() > 0


class Pending:
    """A deferred stage result with the sync-replay error contract.

    ``work`` is a zero-arg closure producing the stage's value; it runs
    once on a worker thread, and — if that run raised — exactly once
    more, synchronously, on the first resolving thread. The replay's
    outcome (value or exception) is terminal and shared by every later
    :meth:`resolve`, so a genuine op error surfaces identically to the
    synchronous path and a parallelism-induced flake self-heals.
    """

    __slots__ = (
        "label", "ctx", "_work", "_event", "_value", "_error",
        "_replayed", "_replayable", "_orphaned", "_lock",
    )

    def __init__(
        self, work: Callable[[], object], label: str,
        replayable: bool = True,
    ):
        self.label = label
        # trace context captured at construction (= enqueue time):
        # contextvars do not flow into the pool threads by themselves,
        # so the worker re-activates the submitter's context around the
        # stage, and a replay never mints a new trace
        self.ctx = tracing.current()
        self._work = work
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self._replayed = False
        # donated work is at-most-once: a failed run may already have
        # consumed its input buffers, and re-running it would surface a
        # freed-storage error instead of the op's own — the worker run
        # IS authoritative for non-replayable pendings. (A failure
        # while materializing INPUTS arrives wrapped in
        # DependencyFailed and stays replayable: nothing was consumed.)
        self._replayable = replayable
        self._orphaned = False
        self._lock = lockcheck.make_lock("pipeline.pending")

    # -- worker side ------------------------------------------------------
    def _run(self) -> None:
        t0 = time.perf_counter()
        _WORKER_TLS.stall_s = 0.0
        try:
            with tracing.activate(self.ctx), \
                    metrics.span("pipeline." + self.label):
                self._value = self._work()
        except BaseException as e:
            self._error = e
            # classify at the worker boundary (faults.class.* counters)
            # — the error itself still surfaces via the sync-replay
            # contract at the blocking point
            faults.note_error_class(e, "pipeline." + self.label)
            if self._orphaned:
                # fire-and-forget: the caller freed this handle before
                # the failure and no blocking point will ever resolve
                # it — this WARN is the only trace the op ever broke
                _log_dropped_failure(self.label, e)
        else:
            # drop the closure: it pins the captured inputs (and, for
            # a chain, the previous Pending and ITS result) — keeping
            # it would retain every intermediate table until the final
            # blocking point, exactly the peak the plane exists to cut
            self._work = None
        finally:
            # telemetry strictly BEFORE the event: a resolver that
            # snapshots metrics right after resolve() returns must see
            # this stage's overlap/completed already recorded
            try:
                if metrics.enabled():
                    # worker BUSY time == host work overlapped with the
                    # caller; time this job spent blocked on an
                    # unfinished input is stall, not overlap (it is
                    # already recorded in pipeline.stall_ms)
                    busy = (
                        time.perf_counter() - t0
                        - getattr(_WORKER_TLS, "stall_s", 0.0)
                    )
                    metrics.hist_observe(
                        "pipeline.overlap_ms",
                        max(busy, 0.0) * 1e3,
                        bounds=metrics.SPAN_MS_BOUNDS,
                    )
                    metrics.counter_add("pipeline.completed")
            finally:
                self._event.set()

    # -- consumer side ----------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def failed_nowait(self) -> bool:
        """True when the worker run already failed and no replay has
        resolved it (leak/free diagnostics; never blocks)."""
        return (
            self._event.is_set()
            and self._error is not None
            and not self._replayed
        )

    def value_nowait(self):
        """The settled value, or None when unfinished or failed (leak
        report sizing; never blocks, never replays, never raises)."""
        if self._event.is_set() and self._error is None:
            return self._value
        return None

    def orphan(self) -> None:
        """Mark this pending as never-to-be-resolved (its handle was
        freed): a LATER worker failure logs itself instead of vanishing
        (the fire-and-forget case — no blocking point remains)."""
        self._orphaned = True

    def wait_settled(self) -> None:
        """Block until the worker run finished — success OR failure —
        without replaying or raising."""
        if not self._event.is_set():
            t0 = time.perf_counter()
            self._event.wait()
            _note_stall(time.perf_counter() - t0)

    def settle_terminally(self) -> None:
        """The donate barrier: block until this pending can never touch
        its captured buffers again. A failed-but-replayable pending
        would still dereference them at its later blocking-point
        replay, so the barrier runs that replay NOW (outcome stored for
        the blocking point; errors swallowed here — they surface
        there). This is the one sanctioned off-blocking-point replay:
        donation is about to make replaying impossible, which is
        exactly the synchronous ordering (reader completes before the
        consumer starts)."""
        self.wait_settled()
        if self._error is not None and self._replayable:
            try:
                self._replay_locked()
            # srt: allow-broad-except(replay outcome is stored as terminal state; the true blocking point raises it)
            except BaseException:
                pass  # stored as terminal; the blocking point raises it

    def resolve(self):
        """Block until the stage settles; return its value or raise the
        synchronous path's error. The ONLY place worker errors surface.

        A WORKER resolving a failed input does not replay it — it
        propagates the error into its own pending instead, so every
        replay in a failed chain runs on the true blocking point's
        thread (the caller), exactly like the synchronous path would
        have: replays cascade caller-side, input-first. Non-replayable
        (donated) work is replayed only when its failure happened
        BEFORE anything was consumed (a DependencyFailed wrapper from
        input materialization); its own post-consumption error is
        authoritative and raises as-is."""
        self.wait_settled()
        err = self._error
        if err is None:
            return self._value
        if getattr(_WORKER_TLS, "on", False):
            # propagate raw (wrappers included): the blocking point
            # downstream owns all replay decisions
            raise err
        can_replay = self._replayable or isinstance(err, DependencyFailed)
        if not can_replay:
            raise err
        self._replay_locked()
        if self._error is not None:
            err = self._error
            if isinstance(err, DependencyFailed) and err.__cause__:
                raise err.__cause__
            raise err
        return self._value

    def _replay_locked(self) -> None:
        """Run the at-most-one synchronous replay (no-op when already
        settled terminally); the outcome lands in _value/_error."""
        with self._lock:
            if self._error is None or self._replayed:
                return
            self._replayed = True
            err = self._error
            metrics.counter_add("pipeline.replays")
            if flight.enabled():
                flight.record("I", "pipeline.replay", self.label)
            log.log(
                "WARN", "pipeline", "worker_failed_replaying_sync",
                stage=self.label,
                error=f"{type(err).__name__}: {str(err)[:200]}",
            )
            try:
                # the replay stays in the ORIGINAL request's trace
                with tracing.activate(self.ctx), \
                        metrics.span("pipeline.replay." + self.label):
                    self._value = self._work()
                self._error = None
            except BaseException as e:
                # terminal: this IS the sync path's own error
                self._error = e
                raise
            finally:
                # settled either way — release the captured inputs
                # (see _run)
                self._work = None


def materialize(value):
    """Resolve a possibly-Pending value (identity for settled ones)."""
    return value.resolve() if isinstance(value, Pending) else value


def materialize_inputs(values: Sequence) -> list:
    """Resolve a stage's input list. On a WORKER thread, any failure is
    wrapped in :class:`DependencyFailed`: it happened before this
    stage's own work ran, so even non-replayable (donated) work is
    safely replayable from the blocking point — nothing was consumed."""
    try:
        return [materialize(v) for v in values]
    except BaseException as e:
        if getattr(_WORKER_TLS, "on", False):
            raise DependencyFailed(str(e)) from e
        raise


def _log_dropped_failure(label: str, error: BaseException) -> None:
    """A freed (fire-and-forget) pending failed after its handle was
    gone: a WARN line and a flight instant, the only trace left."""
    log.log(
        "WARN", "pipeline", "freed_pending_failed", stage=label,
        error=f"{type(error).__name__}: {str(error)[:200]}",
    )
    if flight.enabled():
        flight.record("I", "pipeline.freed_failed", label)


def _note_stall(seconds: float) -> None:
    profiler.note_stall(seconds)
    if getattr(_WORKER_TLS, "on", False):
        # a worker blocked on an input: subtracted from that job's
        # overlap_ms so the wait isn't double-counted as overlap
        _WORKER_TLS.stall_s = (
            getattr(_WORKER_TLS, "stall_s", 0.0) + seconds
        )
    if metrics.enabled():
        metrics.counter_add("pipeline.stalls")
        metrics.hist_observe(
            "pipeline.stall_ms", seconds * 1e3,
            bounds=metrics.SPAN_MS_BOUNDS,
        )


class _Pool:
    """FIFO worker pool with depth-bounded in-flight jobs.

    The semaphore slot is held from submit until the job FINISHES, so
    at most ``depth`` jobs are queued-or-running and a producer that
    runs ahead blocks in :meth:`submit` — the backpressure that keeps a
    fast wire producer from buffering an unbounded resident set.
    """

    __slots__ = ("depth", "_q", "_slots", "_workers", "_old_switch")

    # CPython's default GIL switch interval is 5ms: a worker that
    # finishes a stage keeps the GIL through its next job's numpy glue
    # while the consumer sits runnable for multiple of those windows —
    # measured ~20% of stream wall on a saturated host. Stage handoffs
    # are the pipeline's heartbeat, so a live pool tightens the
    # interval (restored at shutdown).
    SWITCH_INTERVAL_S = 0.0005

    def __init__(self, d: int):
        self.depth = d
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._slots = threading.BoundedSemaphore(d)
        self._old_switch = sys.getswitchinterval()
        if self._old_switch > self.SWITCH_INTERVAL_S:
            sys.setswitchinterval(self.SWITCH_INTERVAL_S)
        self._workers = [
            threading.Thread(
                target=self._worker_loop,
                name=f"srt-pipeline-{i}",
                daemon=True,
            )
            for i in range(max(1, min(d, MAX_WORKERS)))
        ]
        for w in self._workers:
            w.start()
        metrics.gauge_set("pipeline.depth", d)

    def _worker_loop(self) -> None:
        _WORKER_TLS.on = True
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                item._run()
            finally:
                self._slots.release()

    def submit(self, pending: Pending) -> Pending:
        if not self._slots.acquire(blocking=False):
            t0 = time.perf_counter()
            self._slots.acquire()  # backpressure: depth jobs in flight
            _note_stall(time.perf_counter() - t0)
        metrics.counter_add("pipeline.enqueued")
        self._q.put(pending)
        return pending

    def shutdown(self) -> None:
        """Stop the workers after the queued jobs drain (config-change
        teardown; daemon threads make this best-effort at exit)."""
        for _ in self._workers:
            self._q.put(None)
        if self._old_switch > self.SWITCH_INTERVAL_S:
            sys.setswitchinterval(self._old_switch)


# pool cache keyed on the configured depth; rebuilt (and the old pool
# drained) when the flag changes mid-process (tests flip it freely)
_POOL: Optional[_Pool] = None
_POOL_LOCK = lockcheck.make_lock("pipeline.pool")


def _pool() -> _Pool:
    global _POOL
    d = depth()
    if d <= 0:
        # callers gate on enabled(); a zero-slot pool would deadlock
        # the first submit, so fail loudly instead
        raise RuntimeError("pipeline pool requested while disabled")
    p = _POOL
    if p is not None and p.depth == d:
        return p
    with _POOL_LOCK:
        if _POOL is None or _POOL.depth != d:
            if _POOL is not None:
                _POOL.shutdown()
            _POOL = _Pool(d)
        return _POOL


def submit(
    work: Callable[[], object], label: str, replayable: bool = True
) -> Pending:
    """Enqueue ``work`` on the pipeline pool; returns its Pending.
    Callers must have checked :func:`enabled` (a zero-depth pool cannot
    exist). Pass ``replayable=False`` for work that consumes its inputs
    (donation): its worker error surfaces as-is instead of replaying."""
    return _pool().submit(Pending(work, label, replayable=replayable))


def enqueue(pending: Pending) -> Pending:
    """Submit a pre-built Pending — for callers that must publish the
    handle (e.g. register it as a reader of its inputs) ATOMICALLY with
    capturing those inputs, before any worker can run it."""
    return _pool().submit(pending)


def drain() -> None:
    """Block until every in-flight job has finished (test isolation;
    flag teardown). Acquiring all depth slots means none are held."""
    p = _POOL
    if p is None:
        return
    for _ in range(p.depth):
        p._slots.acquire()
    for _ in range(p.depth):
        p._slots.release()


# ---------------------------------------------------------------------------
# dedicated IO lane: spill writes/restores (utils/spill.py)
#
# Spill IO must overlap compute WITHOUT competing for the dispatch
# pool's depth slots: an eviction triggered from inside a pool job that
# then blocked on the pool's own backpressure semaphore would deadlock
# at depth 1 (the only slot is held by the job doing the evicting), and
# spill traffic should never consume the stream's backpressure budget.
# One FIFO worker thread, created lazily, independent of the PIPELINE
# flag — disk writes overlap compute even when dispatch is synchronous.
# ---------------------------------------------------------------------------

_IO_Q: "queue.SimpleQueue" = queue.SimpleQueue()
_IO_LOCK = lockcheck.make_lock("pipeline.io")
_IO_THREAD: Optional[threading.Thread] = None


def _io_loop() -> None:
    while True:
        item = _IO_Q.get()
        if item is None:
            return
        item._run()


def submit_io(
    work: Callable[[], object], label: str, replayable: bool = True
) -> Pending:
    """Enqueue host-side I/O work on the dedicated IO worker; returns
    its Pending (same sync-replay error contract as pool stages —
    failures surface at ``resolve``)."""
    global _IO_THREAD
    p = Pending(work, label, replayable=replayable)
    with _IO_LOCK:
        if _IO_THREAD is None or not _IO_THREAD.is_alive():
            _IO_THREAD = threading.Thread(
                target=_io_loop, name="srt-io", daemon=True
            )
            _IO_THREAD.start()
    metrics.counter_add("pipeline.io_enqueued")
    _IO_Q.put(p)
    return p


def drain_io() -> None:
    """Block until every queued IO job has finished (test isolation):
    the lane is FIFO, so a no-op fence job is a barrier."""
    with _IO_LOCK:
        t = _IO_THREAD
    if t is None or not t.is_alive():
        return
    submit_io(lambda: None, "io.fence").wait_settled()


def stage_ahead(
    items: Sequence,
    prepare: Callable,
    execute: Callable,
    label: str = "prepare",
    lookahead: int = 1,
) -> List:
    """Drive ``items`` through prepare -> execute with the prepares run
    ahead on pool workers.

    ``prepare(item)`` is host-side staging work (a pack, a counts pass)
    that is safe to run for item N+1 while the caller thread is inside
    ``execute`` for item N. Up to ``lookahead`` prepares run ahead of the execute
    cursor; their worker busy time is the ``pipeline.overlap_ms``
    evidence that exchange launches and next-batch staging actually
    overlapped. Results return in input order; with the pipeline off
    both stages run inline per item — byte-identical, same errors.
    """
    items = list(items)
    if depth() == 0:
        out = []
        for it in items:
            faults.check_cancel()
            out.append(execute(prepare(it)))
        return out
    pool = _pool()
    n = len(items)
    ahead = max(1, min(int(lookahead) + 1, depth()))
    prepped: List[Optional[Pending]] = [None] * n
    submitted = 0
    out = []
    for i in range(n):
        faults.check_cancel()
        while submitted < min(n, i + ahead):
            j = submitted
            prepped[j] = pool.submit(
                Pending(lambda it=items[j]: prepare(it), label)
            )
            submitted += 1
        ready = prepped[i].resolve()
        prepped[i] = None  # drop the ref: consumed by execute below
        out.append(execute(ready))
    return out


def run_stream(
    items: Sequence,
    decode: Callable,
    compute: Callable,
    encode: Callable,
) -> List:
    """Drive ``items`` through decode -> compute -> encode with
    host/device overlap and ordered completion.

    ``decode`` (wire bytes -> device table) and ``encode`` (result
    table -> wire bytes) run on pool workers; ``compute`` (the plan)
    runs on the CALLER thread in input order, so batch N+1's decode and
    batch N-1's encode overlap batch N's plan (on CUDA, on the card too:
    see :func:`device_lane`). Results return in input order. With the pipeline off
    the three stages run inline per item — byte-identical, same errors,
    no threads.
    """
    items = list(items)
    d = depth()
    if d == 0:
        out = []
        for it in items:
            # the cooperative cancellation checkpoint between batches
            # (no-op without a bound faults.CancelToken)
            faults.check_cancel()
            out.append(encode(compute(decode(it))))
        return out
    pool = _pool()
    n = len(items)
    decoded: List[Optional[Pending]] = [None] * n
    encoded: List[Optional[Pending]] = [None] * n
    submitted = 0
    for i in range(n):
        faults.check_cancel()  # between-batch cancellation checkpoint
        # keep up to `depth` decodes in flight INCLUDING the current
        # one (submitting depth+1 against a depth-slot semaphore would
        # block every iteration and record phantom backpressure stalls)
        while submitted < min(n, max(i + d, i + 1)):
            j = submitted
            decoded[j] = pool.submit(
                Pending(lambda it=items[j]: decode(it), "decode")
            )
            submitted += 1
        tbl = decoded[i].resolve()
        decoded[i] = None  # drop the ref: the table is consumed below
        out = compute(tbl)
        encoded[i] = pool.submit(Pending(lambda o=out: encode(o), "encode"))
    return [p.resolve() for p in encoded]


# ---------------------------------------------------------------------------
# CUDA lanes: each worker stage on a stream of its own, with events
# between the streams (see the module docstring)
# ---------------------------------------------------------------------------


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _lane_stream(device: torch.device, role: str):
    """This thread's own stream for ``role`` on ``device`` (made once)."""
    streams = getattr(_WORKER_TLS, "streams", None)
    if streams is None:
        streams = _WORKER_TLS.streams = {}
    key = (device.index, role)
    s = streams.get(key)
    if s is None:
        s = streams[key] = torch.cuda.Stream(device)
    return s


@contextlib.contextmanager
def device_lane(device, role: str):
    """Run the body with ``device`` set on this thread and this thread's
    own CUDA stream for ``role`` current, where ``device`` is a CUDA
    device and this is a pool worker; a no-op otherwise (the CPU, and
    stages that run on the caller: the synchronous path and a replay)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not in_worker():
        yield None
        return
    dev = _cuda_device(dev)
    with torch.cuda.device(dev):
        stream = _lane_stream(dev, role)
        with torch.cuda.stream(stream):
            yield stream


def mark(device):
    """An event recorded on the current stream of ``device`` after the
    work enqueued so far (None for the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(_cuda_device(dev)))
    return ev


def hand_over(event, tensors, device) -> None:
    """Make the current stream of ``device`` wait for ``event`` (from
    :func:`mark` on another stream) and mark ``tensors`` as used by it
    (``record_stream``): the caching allocator then keeps their blocks
    until this stream has passed its work on them, whichever stream
    allocated them. A no-op for the CPU."""
    dev = torch.device(device)
    if event is None or dev.type != "cuda":
        return
    stream = torch.cuda.current_stream(_cuda_device(dev))
    stream.wait_event(event)
    for t in tensors:
        t.record_stream(stream)
