"""Admission control and weighted-deficit fair-share scheduling (port
of ``serving/scheduler.py``).

Every served request becomes a :class:`Ticket` in its session's FIFO
queue, and a small pool of worker threads pulls tickets in
**deficit-round-robin** order: each sweep credits every backlogged
session ``quantum x weight`` rows of deficit and runs its head request
only once the deficit covers the request's row cost, so a heavy session
cannot starve a light one.

Admission is two-layered:

* **queue depth**: a session may hold at most ``queue_depth`` queued
  tickets (``SPARK_RAPIDS_TPU_SERVE_QUEUE_DEPTH``); a request past that
  is *shed* with the typed :class:`Busy`.
* **device memory budget**: :meth:`session.Session.admit`, before the
  ticket is built.

The workers launch on the default stream of the server's device, so
launches from two sessions serialize on the card and no tensor crosses
streams. The work they run is the runtime bridge's decode ->
``run_plan`` -> encode path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ..utils import faults, flight, lockcheck, metrics, profiler, tracing
from .session import Session, SessionClosed, executing

# deficit credited to a backlogged session per sweep, in rows, before
# the weight multiplier — roughly one large batch
DEFAULT_QUANTUM_ROWS = 65536


class Busy(Exception):
    """Typed shed: the session's queue is at depth. Retry later."""


class Ticket:
    """One schedulable request: closure + cost + settlement event."""

    __slots__ = (
        "session", "fn", "cost", "label", "charge", "prof", "token",
        "ctx", "submit_t", "start_t", "end_t", "value", "error",
        "_event",
    )

    def __init__(self, session: Session, fn: Callable[[], object],
                 cost: int, label: str, charge: int, prof=None,
                 token=None):
        self.session = session
        self.fn = fn
        self.cost = max(int(cost), 1)
        self.label = label
        self.charge = max(int(charge), 0)
        self.prof = prof
        self.token = token  # faults.CancelToken or None
        # trace context captured at SUBMIT: contextvars do not flow
        # into the executor pool by themselves, so the worker
        # re-activates this around the work (utils/tracing.py)
        self.ctx = tracing.current()
        self.submit_t = time.perf_counter()
        self.start_t: Optional[float] = None
        self.end_t: Optional[float] = None
        self.value = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self):
        """Block until executed; return the value or raise the error."""
        self._event.wait()
        if self.error is not None:
            raise self.error
        return self.value

    def _settle(self) -> None:
        self._event.set()


class FairScheduler:
    """Deficit-round-robin scheduler over per-session FIFO queues."""

    def __init__(self, workers: int = 2, queue_depth: int = 16,
                 quantum_rows: int = DEFAULT_QUANTUM_ROWS):
        self.workers = max(int(workers), 1)
        self.queue_depth = max(int(queue_depth), 1)
        self.quantum_rows = max(int(quantum_rows), 1)
        self._lock = lockcheck.make_lock("scheduler.queues")
        self._cv = lockcheck.make_condition(self._lock)
        self._queues: Dict[str, deque] = {}
        self._deficit: Dict[str, float] = {}
        self._sessions: Dict[str, Session] = {}
        self._inflight: Dict[str, int] = {}
        self._order: list = []
        self._rr = 0
        self._stopping = False
        self._threads: list = []

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "FairScheduler":
        for i in range(self.workers):
            t = threading.Thread(
                target=self._worker_loop,
                name=f"srt-serve-exec-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            dropped = [t for q in self._queues.values() for t in q]
            for q in self._queues.values():
                q.clear()
            self._cv.notify_all()
        for t in dropped:
            t.error = SessionClosed(
                f"session {t.session.name}: scheduler stopped"
            )
            t.session.release(t.charge)
            t._settle()
        for th in self._threads:
            th.join(timeout=10)
        self._threads = []

    # -- session registration --------------------------------------------
    def register(self, session: Session) -> None:
        with self._cv:
            self._queues[session.id] = deque()
            self._deficit[session.id] = 0.0
            self._sessions[session.id] = session
            self._inflight[session.id] = 0
            self._order.append(session.id)

    def unregister(self, session: Session) -> None:
        """Drop the session's queued tickets (settled with the typed
        SessionClosed) and wait for its in-flight ones to finish, so a
        teardown that follows can reclaim tables no executor still
        touches."""
        with self._cv:
            q = self._queues.pop(session.id, None)
            self._deficit.pop(session.id, None)
            self._sessions.pop(session.id, None)
            if session.id in self._order:
                self._order.remove(session.id)
            dropped = list(q) if q else []
            self._cv.notify_all()
        for t in dropped:
            t.error = SessionClosed(
                f"session {session.name} closed while queued"
            )
            t.session.release(t.charge)
            t._settle()
        with self._cv:
            while self._inflight.get(session.id, 0) > 0:
                self._cv.wait()
            self._inflight.pop(session.id, None)

    # -- submission -------------------------------------------------------
    def submit(self, session: Session, fn: Callable[[], object],
               cost: int = 1, label: str = "req", charge: int = 0,
               prof=None, shed: bool = True, token=None) -> Ticket:
        """Queue one request. ``shed=True`` raises the typed
        :class:`Busy` when the session queue is at depth;
        ``shed=False`` (a stream's follow-on batches, whose in-flight
        window the server already bounds) waits for a slot instead —
        executors always drain, so the wait terminates. ``token`` is
        the request's :class:`faults.CancelToken`: the executor binds
        it around the work (so between-segment / between-batch
        checkpoints observe it) and settles an already-cancelled
        ticket without running it at all."""
        t = Ticket(session, fn, cost, label, charge, prof, token)
        shed_now = False
        with self._cv:
            while True:
                if self._stopping:
                    raise SessionClosed(
                        f"session {session.name}: scheduler stopped"
                    )
                q = self._queues.get(session.id)
                if q is None:
                    raise SessionClosed(
                        f"session {session.name} is not registered"
                    )
                if len(q) < self.queue_depth:
                    break
                if shed:
                    # bookkeeping happens OUTSIDE this block:
                    # Session.note_shed takes the session lock, and
                    # session orders BEFORE scheduler in the sanctioned
                    # lock order (lockcheck.LOCK_ORDER) — taking it
                    # here was the inversion srt-check's dynamic shim
                    # flagged across test_serving.py
                    shed_now = True
                    break
                self._cv.wait()
            if not shed_now:
                t.submit_t = time.perf_counter()
                q.append(t)
                self._cv.notify_all()
        if shed_now:
            session.note_shed()
            metrics.counter_add("serving.shed")
            if flight.enabled():
                flight.record("I", "serving.shed", session.name)
            raise Busy(
                f"session {session.name}: queue depth "
                f"{self.queue_depth} reached — request shed, "
                "retry later"
            )
        metrics.counter_add("serving.requests")
        return t

    # -- executor side ----------------------------------------------------
    def _next(self) -> Optional[Ticket]:
        """Pop the next ticket in deficit-round-robin order; None on
        stop. Each visit to a backlogged session credits
        ``quantum_rows × weight``; its head runs once covered."""
        with self._cv:
            while True:
                if self._stopping:
                    return None
                backlog = False
                for _ in range(max(len(self._order), 1)):
                    if not self._order:
                        break
                    sid = self._order[self._rr % len(self._order)]
                    self._rr += 1
                    q = self._queues.get(sid)
                    if not q:
                        continue
                    backlog = True
                    sess = self._sessions[sid]
                    self._deficit[sid] += self.quantum_rows * sess.weight
                    if q[0].cost <= self._deficit[sid]:
                        t = q.popleft()
                        self._deficit[sid] -= t.cost
                        if not q:
                            # standard DRR: an emptied queue forfeits
                            # accumulated credit (no bursting later)
                            self._deficit[sid] = 0.0
                        self._inflight[sid] = (
                            self._inflight.get(sid, 0) + 1
                        )
                        self._cv.notify_all()  # free queue slot
                        return t
                if not backlog:
                    self._cv.wait()
                # else: sweep again — deficits grow each sweep, so some
                # head request becomes runnable in bounded sweeps

    def _worker_loop(self) -> None:
        while True:
            t = self._next()
            if t is None:
                return
            t.start_t = time.perf_counter()
            wait_s = t.start_t - t.submit_t
            sess = t.session
            sess.note_wait(wait_s)
            metrics.hist_observe(
                "serving.queue_wait_ms", wait_s * 1e3,
                bounds=metrics.SPAN_MS_BOUNDS,
            )
            with tracing.activate(t.ctx):
                if flight.enabled():
                    # the wait is only measurable at dequeue: record
                    # the queue-wait span retroactively with backdated
                    # timestamps (both events on THIS thread, so the
                    # exporter's per-tid B/E pairing holds)
                    tp = None if t.ctx is None else t.ctx.header
                    flight.record("B", "serving.queue_wait", tp,
                                  t_ns=int(t.submit_t * 1e9))
                    flight.record("E", "serving.queue_wait",
                                  t_ns=int(t.start_t * 1e9))
                try:
                    if t.token is not None:
                        t.token.check()  # cancelled while queued
                    with executing(sess, t), \
                            profiler.bound_session(t.prof), \
                            faults.scoped_token(t.token):
                        with metrics.span(
                            "serving." + t.label, session=sess.name
                        ):
                            t.value = t.fn()
                except BaseException as e:
                    t.error = e
                    faults.note_error_class(e, "serving." + t.label)
            t.end_t = time.perf_counter()
            lat_s = t.end_t - t.submit_t
            sess.note_latency(lat_s)
            metrics.hist_observe(
                "serving.latency_ms", lat_s * 1e3,
                bounds=metrics.SPAN_MS_BOUNDS,
            )
            with self._cv:
                self._inflight[sess.id] = max(
                    self._inflight.get(sess.id, 1) - 1, 0
                )
                self._cv.notify_all()
            sess.release(t.charge)
            t._settle()

    # -- introspection ----------------------------------------------------
    def queued(self, session: Session) -> int:
        with self._lock:
            q = self._queues.get(session.id)
            return len(q) if q else 0

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until no queued or in-flight work remains across every
        session — the drain barrier for rolling restarts. Returns False
        if ``timeout`` (seconds) elapsed with work still pending."""
        deadline = (
            None if timeout is None else time.monotonic() + float(timeout)
        )
        with self._cv:
            while True:
                busy = any(self._queues.values()) or any(
                    n > 0 for n in self._inflight.values()
                )
                if not busy:
                    return True
                if deadline is None:
                    self._cv.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
