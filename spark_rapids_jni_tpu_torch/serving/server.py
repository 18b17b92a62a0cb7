"""The serving daemon: a long-lived multi-tenant query-stream server
(port of ``serving/server.py``).

One resident device process (the JVM executor that loads the shaded
``rapids-4-spark-jni`` artifact once) serving many concurrent Spark
tasks. Here the resident process is this :class:`Server`: it listens on
localhost TCP (length-prefixed JSON+binary frames, ``serving/frames.py``),
gives each client connection a :class:`~.session.Session` (namespace +
device memory budget), runs every request through the weighted-deficit
:class:`~.scheduler.FairScheduler`, and executes through the runtime
bridge on its ``device`` (default ``"cuda"``; without CUDA ``start()``
raises, it never serves from the CPU unless asked): shape buckets, plan
fusion, the pipelined plane and donation all apply per request, and the
bucketed runner cache is shared across sessions.

Commands (frame header ``cmd``):

* ``hello``      open (or re-attach to) a session; returns id + budget
* ``stream``     run a plan over N inline batches; returns N results
* ``upload``     wire batch -> session-resident table id
* ``plan``       plan over resident ids -> new resident id
* ``download``   resident id -> wire batch
* ``free``       reclaim one resident table's device memory now
* ``stats``      server + per-session statistics
* ``trace``      tail-sampled slow-request log + Prometheus-style text
                 exposition of the metrics
* ``drain``      rolling restart: stop admitting, finish, answer, exit
* ``bye``        detach this connection (last detach tears the session
                 down with full table reclamation, as does a crash)

Errors are typed responses ``{"ok": false, "error": {"type", ...,
"message"}}``; notably ``busy`` (queue shed) and ``over_budget``
(admission): a saturated daemon answers, it never hangs.

Every served stream opens a ``profiler.profile_session`` labeled
``serve:<session-name>``.
"""

from __future__ import annotations

import contextlib
import json
import os
import select
import socket
import threading
import time
import uuid
from collections import deque
from typing import Optional

import torch

from .. import pipeline, plan as plan_mod, plancheck, runtime_bridge as rb
from ..column import resolve_device
from ..parallel.mesh import on_device
from ..utils import (
    config,
    faults,
    flight,
    hbm,
    lockcheck,
    log,
    metrics,
    planstats,
    profiler,
    spill,
    tracing,
)
from . import durable, frames
from .scheduler import Busy, FairScheduler
from .session import (
    OverBudget,
    Session,
    SessionClosed,
    estimate_request_bytes,
)


class SessionLimit(Exception):
    """Typed HELLO rejection: the daemon is at SERVE_MAX_SESSIONS."""


# ordered most-specific first: the fault taxonomy entries must win
# over any generic base class they might share
_ERROR_TYPES = {
    durable.CheckpointCorrupt: "checkpoint_corrupt",
    durable.ResumeDenied: "resume_denied",
    durable.SessionQuarantined: "session_quarantined",
    durable.Draining: "draining",
    faults.Degraded: "degraded",
    faults.Cancelled: "cancelled",
    faults.DeadlineExceeded: "deadline_exceeded",
    faults.ResourceExhausted: "resource_exhausted",
    faults.TransientDeviceError: "transient_device",
    Busy: "busy",
    OverBudget: "over_budget",
    SessionLimit: "session_limit",
    SessionClosed: "session_closed",
    KeyError: "unknown_table",
    frames.ProtocolError: "bad_request",
    TypeError: "bad_request",
    ValueError: "bad_request",
}


def _error_type(exc: BaseException) -> str:
    for cls, name in _ERROR_TYPES.items():
        if isinstance(exc, cls):
            return name
    return "internal"


def _error_header(exc: BaseException) -> dict:
    msg = str(exc)
    if isinstance(exc, KeyError) and exc.args:
        msg = str(exc.args[0])  # un-repr the KeyError message
    err = {
        "type": _error_type(exc),
        "exception": type(exc).__name__,
        "message": msg,
    }
    # a plancheck rejection carries the full tagged report (per-op tier +
    # reason, GpuOverrides-style) — ship it so the client learns *why*
    # before paying upload or queue wait
    report = getattr(exc, "plan_report", None)
    if report is not None:
        err["plan_report"] = report
    return {"ok": False, "error": err}


class Server:
    """The resident daemon. ``with Server().start() as srv:`` or call
    :meth:`start` / :meth:`stop` explicitly; ``srv.port`` is the bound
    port (OS-assigned when SERVE_PORT / ``port`` is 0). Every upload and
    every bridge call goes to ``device``."""

    def __init__(self, port: Optional[int] = None,
                 max_sessions: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 session_hbm_fraction: Optional[float] = None,
                 workers: int = 2, device="cuda"):
        self.device = torch.device(device)
        self._port_req = (
            int(config.get_flag("SERVE_PORT")) if port is None else port
        )
        self.max_sessions = (
            int(config.get_flag("SERVE_MAX_SESSIONS"))
            if max_sessions is None else int(max_sessions)
        )
        self.queue_depth = (
            int(config.get_flag("SERVE_QUEUE_DEPTH"))
            if queue_depth is None else int(queue_depth)
        )
        self.session_hbm_fraction = (
            float(config.get_flag("SERVE_SESSION_HBM_FRACTION"))
            if session_hbm_fraction is None
            else float(session_hbm_fraction)
        )
        self.scheduler = FairScheduler(
            workers=workers, queue_depth=self.queue_depth
        )
        # N consecutive transient failures flip the daemon to typed
        # Degraded sheds; a background probe closes it again without
        # waiting for client traffic (faults.CircuitBreaker)
        self.breaker = faults.CircuitBreaker(name="serving")
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._lock = lockcheck.make_lock("session.server")
        self._sessions: dict = {}
        self._conns: set = set()
        self._conn_threads: list = []
        self._stopping = False
        self._stopped = threading.Event()
        self._sessions_served = 0
        # durable serving plane (serving/durable.py)
        self._draining = False
        self._durable_logs: dict = {}   # sid -> durable.SessionLog
        self._quarantined: dict = {}    # sid -> quarantine reason
        self._manifest: Optional[durable.Manifest] = None
        self._restore_doc: Optional[dict] = None
        # mesh-backed sessions (parallel/tolerant.py): one shared
        # MeshRunner per requested device count — the degradation
        # ladder's state (surviving mesh, counters) is daemon-wide, so
        # a mesh that shrank for one tenant stays shrunk for the next
        self._mesh_runners: dict = {}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Server":
        self.device = resolve_device(self.device)  # no CUDA: raises here
        self.scheduler.start()
        if durable.enabled():
            # recover BEFORE the listener opens: the first client to
            # connect sees restored sessions and a warm runner cache
            self._restore()
        s = socket.create_server(("127.0.0.1", self._port_req))
        self.port = s.getsockname()[1]
        self._listener = s
        t = threading.Thread(
            target=self._accept_loop, name="srt-serve-accept", daemon=True
        )
        t.start()
        self._accept_thread = t
        p = threading.Thread(
            target=self._probe_loop, name="srt-serve-probe", daemon=True
        )
        p.start()
        self._probe_thread = p
        if flight.enabled():
            flight.record("I", "serving.start", self.port)
        return self

    def stop(self) -> None:
        """Shut down: stop accepting, close connections (tearing their
        sessions down with full reclamation), stop executors, drain the
        pipelined plane."""
        with self._lock:
            if self._stopping:
                already = True
            else:
                already = False
                self._stopping = True
                conns = list(self._conns)
                threads = list(self._conn_threads)
        if already:
            # another stopper (e.g. the drain command's background
            # shutdown thread) is mid-teardown: wait for it so callers
            # see a fully-stopped daemon, not a racing one
            self._stopped.wait(timeout=30)
            return
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=10)
        if self._listener is not None:
            # closing a listening socket does NOT wake a thread blocked
            # in accept() on Linux — poke it with a throwaway connection
            # (the accept loop sees _stopping and exits) so shutdown is
            # immediate instead of eating the join timeout
            with contextlib.suppress(OSError):
                socket.create_connection(
                    ("127.0.0.1", self.port), timeout=1
                ).close()
            with contextlib.suppress(OSError):
                self._listener.close()
        for c in conns:
            with contextlib.suppress(OSError):
                c.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                c.close()
        for t in threads:
            t.join(timeout=10)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=10)
        # belt-and-braces: a session left attached by a hung handler
        with self._lock:
            leftovers = list(self._sessions.values())
            self._sessions.clear()
        for sess in leftovers:
            self.scheduler.unregister(sess)
            sess.teardown()
        # release journal handles; the files STAY — a stopped (or
        # drained) durable daemon restores them on its next start
        with self._lock:
            dlogs = list(self._durable_logs.values())
            self._durable_logs.clear()
        for dlog in dlogs:
            dlog.close()
        if self._manifest is not None:
            self._manifest.close()
        self.scheduler.stop()
        pipeline.drain()
        if flight.enabled():
            flight.record("I", "serving.stop", self.port)
        self._stopped.set()

    def __enter__(self) -> "Server":
        if self.port is None:
            self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    # -- durable restore --------------------------------------------------
    def _restore(self) -> None:
        """Crash recovery, before the listener opens: replay every
        session journal into a live session (tables repaged from their
        checkpoint payloads, budgets and HBM accounting re-charged),
        then replay each plan of the manifest once on the server's
        device (the warm start: bucketed runners cached, kernels loaded)
        so the restarted daemon's first request lands on recovered
        state. A session whose
        journal or payloads fail integrity checks is quarantined and
        skipped; restore itself never crashes the daemon."""
        t0 = time.perf_counter()
        with metrics.span("restore"):
            sessions, quarantined = durable.restore_scan()
            self._quarantined.update(quarantined)
            restored = 0
            for rs in sessions:
                try:
                    self._restore_session(rs)
                    restored += 1
                except (durable.CheckpointCorrupt, faults.FaultError,
                        OSError) as e:
                    durable.quarantine(rs.sid, str(e))
                    self._quarantined[rs.sid] = str(e)
            self._manifest = durable.Manifest()
            with on_device(self.device):
                replayed, failed = self._manifest.warm_start(self.device)
        self._restore_doc = {
            "sessions": restored,
            "quarantined": dict(self._quarantined),
            "warm_compiles": replayed,  # the JAX key; here, replays
            "warm_failures": failed,
            "took_ms": round((time.perf_counter() - t0) * 1e3, 3),
        }
        if flight.enabled():
            flight.record("I", "restore.done", restored)
        if restored or replayed or self._quarantined:
            log.log("INFO", "serving", "restore", **self._restore_doc)

    def _restore_session(self, rs: "durable.RestoredSession") -> None:
        budget = rs.budget or max(
            int(self.session_hbm_fraction * hbm.budget_bytes(self.device)),
            1,
        )
        sess = Session(rs.sid, rs.name, rs.weight, budget)
        sess.resume_token = rs.token
        sess.connections = 0
        total = 0
        try:
            for local in sorted(rs.tables):
                fname, nbytes = rs.tables[local]
                path = os.path.join(durable.checkpoint_dir(), fname)
                tbl = durable.load_payload(path, self.device)
                rb_id = rb._resident_put(tbl)
                sess.restore_table(local, rb_id, nbytes)
                total += nbytes
        except BaseException:
            sess.teardown()  # unwind the partially-restored namespace
            raise
        for req, resp in rs.dedup.items():
            sess.dedup_put(req, resp, cap=durable.DEDUP_CAP)
        sess.advance_locals(rs.next_local)
        with self._lock:
            self._sessions[rs.sid] = sess
            self._sessions_served += 1
            self._durable_logs[rs.sid] = durable.SessionLog(rs.sid)
            live = len(self._sessions)
        self.scheduler.register(sess)
        durable.count("restore.sessions")
        durable.count("restore.tables", len(rs.tables))
        durable.count("restore.bytes", total, as_bytes=True)
        metrics.gauge_set("serving.sessions_live", live)
        if flight.enabled():
            flight.record("I", "restore.session", rs.name)

    def _dlog(self, sess) -> Optional["durable.SessionLog"]:
        if not durable.enabled():
            return None
        with self._lock:
            return self._durable_logs.get(sess.id)

    @staticmethod
    def _journal_safe(dlog, method: str, *args, **kwargs) -> None:
        """Apply one journal mutation, degrading durability (counted,
        logged) instead of failing the live request — the in-memory
        state is authoritative; the journal self-heals on the next
        append (Journal tail recovery)."""
        if dlog is None:
            return
        try:
            getattr(dlog, method)(*args, **kwargs)
        except (faults.FaultError, OSError) as e:
            durable.count("checkpoint.errors")
            log.log("WARN", "serving", "journal_degraded",
                    session=dlog.sid, record=method, reason=str(e))

    # -- accept / connection plumbing ------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return  # listener closed: shutting down
            with self._lock:
                if self._stopping:
                    with contextlib.suppress(OSError):
                        sock.close()
                    return
                self._conns.add(sock)
                t = threading.Thread(
                    target=self._handle_conn, args=(sock,),
                    name="srt-serve-conn", daemon=True,
                )
                self._conn_threads.append(t)
            t.start()

    def _probe_loop(self) -> None:
        """Background half-open probing: while the breaker is OPEN,
        periodically run one trivial device op so the daemon recovers
        (closes the breaker) even with zero client traffic. Client
        requests race for the same half-open slot; whoever wins is the
        trial — the loser sheds typed Degraded as usual."""
        interval = max(self.breaker.probe_interval_s / 4, 0.05)
        while not self._probe_stop.wait(interval):
            if self.breaker.state == faults.CLOSED:
                continue
            try:
                if not self.breaker.allow():
                    continue  # closed between the check and the call
            except faults.Degraded:
                continue  # probe interval not yet elapsed
            try:
                faults.default_probe(self.device)
            except BaseException as e:
                self.breaker.note_failure(e)
            else:
                self.breaker.note_success()

    def _handle_conn(self, sock: socket.socket) -> None:
        sess: Optional[Session] = None
        clean = False
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                header, payload = frames.recv_frame(sock)
                cmd = header.get("cmd")
                # trace-context establishment, once per request: a
                # valid peer `traceparent` is joined (same trace id,
                # fresh hop span id), no header mints a fresh context
                # when the plane is on — every span/instant the
                # handlers record below inherits it ambiently
                ctx = tracing.ensure_context(header.get("traceparent"))
                if cmd == "hello":
                    with tracing.activate(ctx):
                        sess = self._cmd_hello(sock, header, sess)
                    continue
                if cmd == "bye":
                    # detach BEFORE the ack: the client treats the bye
                    # reply as "slot freed", and may immediately open a
                    # new session against max_sessions
                    clean = True
                    if sess is not None:
                        self._detach(sess, clean=True)
                        sess = None
                    frames.send_frame(sock, {"ok": True})
                    break
                if sess is None:
                    frames.send_frame(sock, _error_header(
                        frames.ProtocolError(
                            f"first frame must be hello, got {cmd!r}"
                        )
                    ))
                    continue
                t0 = time.perf_counter()
                err: Optional[BaseException] = None
                try:
                    with tracing.activate(ctx):
                        self._dispatch(sock, sess, cmd, header, payload)
                except (BrokenPipeError, ConnectionError, OSError):
                    raise
                # srt: allow-broad-except(every failure becomes a typed error frame via _error_header; the client always gets an answer, never a hang)
                except BaseException as e:
                    err = e
                    frames.send_frame(sock, _error_header(e))
                self._note_request(cmd, sess, ctx, t0, err)
        except (ConnectionError, OSError, frames.ProtocolError):
            # disconnect / crash mid-stream: the finally below detaches
            # and (on last detach) tears the session down with full
            # table reclamation — the "crash leaks zero tables" path
            pass
        finally:
            with contextlib.suppress(OSError):
                sock.close()
            with self._lock:
                self._conns.discard(sock)
            if sess is not None:
                self._detach(sess, clean=clean)

    @staticmethod
    def _note_request(cmd, sess, ctx, t0: float,
                      err: Optional[BaseException]) -> None:
        """Feed one finished request into the tail-sampled slow-request
        log behind the ``trace`` command. The span detail is passed as
        a callable so the flight-tail walk only runs when the record
        samples in (SLO breach or typed error — utils/tracing.py)."""
        if ctx is None:
            return
        ms = (time.perf_counter() - t0) * 1e3
        tracing.note_request(
            "serving." + str(cmd), ms,
            trace_id=ctx.trace_id,
            session=sess.name,
            error=_error_type(err) if err is not None else None,
            spans=lambda: tracing.trace_span_records(
                flight.tail_records(), ctx.trace_id
            ),
        )

    # -- session lifecycle ------------------------------------------------
    def _cmd_hello(self, sock, header, prev: Optional[Session]):
        try:
            sess = self._attach(header)
        except (SessionLimit, SessionClosed, ValueError, TypeError,
                durable.ResumeDenied, durable.SessionQuarantined,
                durable.Draining) as e:
            frames.send_frame(sock, _error_header(e))
            return prev
        if prev is not None and prev is not sess:
            self._detach(prev)
        doc = {
            "ok": True,
            "session": sess.id,
            "name": sess.name,
            "weight": sess.weight,
            "budget_bytes": sess.budget_bytes,
            "queue_depth": self.queue_depth,
        }
        if sess.resume_token is not None:
            doc["resume_token"] = sess.resume_token
            doc["tables"] = sess.table_count()
        frames.send_frame(sock, doc)
        return sess

    def _mesh_runner(self, n_devices: int):
        """The shared MeshRunner for ``n_devices`` (None when 0).

        Construction happens OUTSIDE the server lock (mesh setup probes
        its devices); a racing duplicate loses to ``setdefault`` and is
        dropped. ValueError from an impossible device count propagates
        to the hello/stream error path as a typed bad_request."""
        n = int(n_devices or 0)
        if not n:
            return None
        with self._lock:
            runner = self._mesh_runners.get(n)
        if runner is not None:
            return runner
        from ..parallel.tolerant import MeshRunner

        runner = MeshRunner(n, devices=self._mesh_pool(n))
        with self._lock:
            return self._mesh_runners.setdefault(n, runner)

    def _mesh_pool(self, n: int) -> list:
        """The devices a mesh-backed session's runner is cut from: every
        visible GPU where there are ``n``, else ``n`` logical shards of
        the server's one device (the single-controller form of
        ``parallel/mesh.py``)."""
        if (self.device.type == "cuda"
                and torch.cuda.device_count() >= n > 1):
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [self.device] * n

    def _on_device(self, fn):
        """``fn`` run with the server's device current: a worker thread
        launches on that device's default stream."""
        def work():
            with on_device(self.device):
                return fn()

        return work

    def _attach(self, header) -> Session:
        sid = header.get("session")
        weight = float(header.get("weight", 1.0) or 1.0)
        deadline_s = float(header.get("deadline_s") or 0.0)
        if deadline_s < 0:
            raise ValueError(
                f"hello: deadline_s must be >= 0, got {deadline_s}"
            )
        mesh_devices = int(header.get("mesh") or 0)
        if mesh_devices < 0:
            raise ValueError(
                f"hello: mesh must be >= 0 devices, got {mesh_devices}"
            )
        if mesh_devices:
            # eager loud-fail: a device count this host cannot mesh
            # answers a typed bad_request AT HELLO (make_mesh names the
            # remedy), not an internal error on the first stream
            self._mesh_runner(mesh_devices)
        dur = durable.enabled()
        with self._lock:
            if self._draining:
                raise durable.Draining(
                    "daemon is draining for restart; no new sessions"
                )
            if sid is not None:
                sess = self._sessions.get(sid)
                if sess is None:
                    reason = self._quarantined.get(sid)
                    if reason is not None:
                        raise durable.SessionQuarantined(
                            f"session {sid!r}: durable state quarantined"
                            f" ({reason}); open a fresh session"
                        )
                    raise SessionClosed(
                        f"unknown or already-closed session {sid!r}"
                    )
                if (dur and sess.resume_token is not None
                        and header.get("resume") != sess.resume_token):
                    raise durable.ResumeDenied(
                        f"session {sid!r}: missing or wrong resume "
                        "token"
                    )
                sess.connections += 1
                if deadline_s:
                    sess.deadline_s = deadline_s
                if mesh_devices:
                    sess.mesh_devices = mesh_devices
                return sess
            if len(self._sessions) >= self.max_sessions:
                raise SessionLimit(
                    f"daemon at max sessions ({self.max_sessions}); "
                    "retry after a session closes"
                )
            new_id = uuid.uuid4().hex[:8]
            name = str(header.get("name") or f"sess-{new_id}")
            budget = max(
                int(self.session_hbm_fraction
                    * hbm.budget_bytes(self.device)), 1
            )
            sess = Session(new_id, name, weight, budget)
            sess.deadline_s = deadline_s
            sess.mesh_devices = mesh_devices
            sess.connections = 1
            self._sessions[new_id] = sess
            self._sessions_served += 1
            live = len(self._sessions)
        if dur:
            # the session's durable birth record: resume token handed
            # to the client, journal opened before any mutation lands
            sess.resume_token = durable.new_resume_token()
            dlog = durable.SessionLog(new_id)
            self._journal_safe(
                dlog, "log_open", name, weight, budget,
                sess.resume_token,
            )
            with self._lock:
                self._durable_logs[new_id] = dlog
        self.scheduler.register(sess)
        metrics.counter_add("serving.sessions_opened")
        metrics.gauge_set("serving.sessions_live", live)
        if flight.enabled():
            flight.record("I", "serving.session_open", sess.name)
        return sess

    def _detach(self, sess: Session, clean: bool = False) -> None:
        with self._lock:
            sess.connections -= 1
            last = sess.connections <= 0
            # a durable session survives connection loss: the client
            # reconnects with its resume token (or the next daemon
            # life restores it). Only a clean bye — or server stop,
            # via the leftover sweep — ends it.
            linger = (
                last and not clean and not self._stopping
                and durable.enabled()
                and sess.resume_token is not None
            )
            if last and not linger:
                self._sessions.pop(sess.id, None)
                dlog = self._durable_logs.pop(sess.id, None)
            else:
                dlog = None
            live = len(self._sessions)
        if not last or linger:
            if linger and flight.enabled():
                flight.record("I", "serving.session_linger", sess.name)
            return
        # order matters: unregister drains the session's queued AND
        # in-flight work first, so teardown reclaims tables no executor
        # still touches (and table_reclaim's barrier covers any
        # pipelined reader beyond that)
        self.scheduler.unregister(sess)
        reclaimed = sess.teardown()
        if dlog is not None:
            if clean:
                dlog.log_bye()  # cleanly closed: erase durable state
            else:
                dlog.close()    # crash/stop: keep state for restore
        metrics.counter_add("serving.sessions_closed")
        metrics.bytes_add("serving.reclaimed_bytes", reclaimed)
        metrics.gauge_set("serving.sessions_live", live)
        if flight.enabled():
            flight.record("I", "serving.session_close", sess.name)

    # -- request dispatch -------------------------------------------------
    _DEVICE_CMDS = frozenset({"stream", "upload", "plan", "download"})
    _MUTATING_CMDS = frozenset({"upload", "plan", "free"})

    def _dispatch(self, sock, sess, cmd, header, payload) -> None:
        if cmd == "drain":
            self._cmd_drain(sock, header)
            return
        if self._draining and cmd in self._DEVICE_CMDS:
            raise durable.Draining(
                "daemon is draining for restart; no new device work"
            )
        req = header.get("req")
        if (req is not None and cmd in self._MUTATING_CMDS
                and durable.enabled()):
            # at-most-once: a request id this session already applied
            # re-sends the recorded response without re-applying — the
            # reconnect-after-crash-mid-reply path
            hit = sess.dedup_get(req)
            if hit is not None:
                metrics.counter_add("serving.idempotent_replays")
                if flight.enabled():
                    flight.record("I", "serving.replay", str(req))
                frames.send_frame(
                    sock, {"ok": True, "replayed": True, **hit}
                )
                return
        if cmd in self._DEVICE_CMDS:
            # breaker gate: an OPEN breaker sheds with typed Degraded
            # before any device work; a True return marks this request
            # as the half-open trial (the accounting below is the same
            # either way)
            self.breaker.allow()
            try:
                faults.inject("serve_accept")
                err = self._cmd_device(sock, sess, cmd, header, payload)
            except BaseException as e:
                # socket errors are peer failures, not device health:
                # a crashing client must never trip the breaker
                if not isinstance(e, (ConnectionError, OSError)):
                    self.breaker.note_failure(e)
                raise
            if err is not None:
                # _cmd_stream answered the client itself; the breaker
                # still needs to see the failure
                self.breaker.note_failure(err)
            else:
                self.breaker.note_success()
        elif cmd == "free":
            local = int(header.get("table"))
            nbytes = sess.free_table(local)
            resp = {"bytes": nbytes}
            dlog = self._dlog(sess)
            if dlog is not None:
                self._journal_safe(
                    dlog, "log_free", local, nbytes, req=req, resp=resp
                )
            if req is not None and durable.enabled():
                sess.dedup_put(req, resp, cap=durable.DEDUP_CAP)
            frames.send_frame(sock, {"ok": True, **resp})
        elif cmd == "stats":
            frames.send_frame(sock, {"ok": True, "stats": self.stats()})
        elif cmd == "trace":
            frames.send_frame(
                sock, {"ok": True, "trace": self.trace_doc()}
            )
        else:
            frames.send_frame(sock, _error_header(
                frames.ProtocolError(f"unknown command {cmd!r}")
            ))

    def _cmd_device(self, sock, sess, cmd, header, payload):
        """Route one device command. Returns the exception a handler
        answered itself (stream sends its own error frame) or None —
        the breaker accounting in :meth:`_dispatch` needs it."""
        if cmd == "stream":
            return self._cmd_stream(sock, sess, header, payload)
        if cmd == "upload":
            self._cmd_upload(sock, sess, header, payload)
        elif cmd == "plan":
            self._cmd_plan(sock, sess, header)
        else:
            self._cmd_download(sock, sess, header)
        return None

    @staticmethod
    def _plan_ops(header) -> list:
        ops = header.get("plan")
        if not isinstance(ops, list):
            raise TypeError("serving: plan must be a JSON list of ops")
        return ops

    def _request_token(self, header, sess) -> faults.CancelToken:
        """Per-request cancellation token. Deadline precedence:
        command header ``deadline_s`` > session hello ``deadline_s`` >
        SPARK_RAPIDS_TPU_DEADLINE_DEFAULT_S; 0 anywhere means none."""
        d = header.get("deadline_s")
        if d is None:
            d = sess.deadline_s or float(
                config.get_flag("DEADLINE_DEFAULT_S")
            )
        d = float(d)
        if d < 0:
            raise ValueError(
                f"serving: deadline_s must be >= 0, got {d}"
            )
        return faults.CancelToken(deadline_s=d if d > 0 else None)

    @staticmethod
    def _client_gone(sock) -> bool:
        """Liveness poll while this conn thread is busy serving: a
        readable socket whose peek returns no bytes is a closed or
        reset peer (a pipelined next command peeks non-empty and is
        NOT a disconnect)."""
        try:
            r, _, _ = select.select([sock], [], [], 0)
            if not r:
                return False
            return sock.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _cmd_stream(self, sock, sess, header, payload):
        """The main entry: one plan over N inline batches, scheduled
        per batch (so a heavy stream interleaves with other tenants),
        answered in one frame, byte-identical to ``table_plan_wire``
        / ``table_stream_wire`` run serially.

        Returns the exception it answered with, or None on success
        (breaker accounting). Every batch runs under the request's
        :class:`faults.CancelToken`; between batches the conn thread
        polls the socket, so a client that crashed mid-stream cancels
        the remaining work at its next checkpoint instead of leaving
        it running against a dead peer while holding HBM charge."""
        ops = self._plan_ops(header)
        tok = self._request_token(header, sess)
        batches = frames.batches_from_parts(
            header.get("batches") or [], payload
        )
        # pre-admission static analysis against the first batch's wire
        # schema: a plan that statically cannot run answers a typed
        # bad_request (tagged report attached) BEFORE any scheduler
        # admission, HBM charge, or upload
        if batches:
            schema = plancheck.schema_from_wire(
                batches[0][0], batches[0][1]
            )
            report = plancheck.check_plan(
                ops, schema=schema, rows=int(batches[0][4]),
            )
        else:
            schema = None
            report = plancheck.check_plan(ops)
        n = len(batches)
        sess.stats["bytes_in"] += len(payload)
        scope = profiler.profile_session(
            ops, label=f"serve:{sess.name}", batches=n,
            schema=schema, static=report,
        )
        prof = scope.__enter__()
        results = [None] * n
        window: deque = deque()

        def checkpoint():
            if self._client_gone(sock):
                tok.cancel("client disconnected mid-stream")
                metrics.counter_add("serving.cancelled")
                if flight.enabled():
                    flight.record(
                        "I", "serving.client_gone", sess.name
                    )
                raise ConnectionResetError(
                    f"session {sess.name}: client gone mid-stream"
                )
            tok.check()

        try:
            if flight.enabled():
                flight.record("I", "serving.stream", f"{sess.name}:{n}")

            man = self._manifest if durable.enabled() else None
            # mesh-backed session: offer every batch's plan to the
            # shared runner; run_plan falls back to the single-device
            # exact path on MeshUnsupported or a degraded-out mesh
            # (the keep-the-tenant guarantee — metered, typed), so
            # donation stays safe either way
            runner = self._mesh_runner(sess.mesh_devices)

            def make_work(b):
                def work():
                    type_ids, scales, datas, valids, rows = b
                    tbl = rb._table_from_wire(
                        type_ids, scales, datas, valids, rows,
                        self.device, rb._plan_pad_to(ops, rows),
                    )
                    if man is not None:
                        # warm-start manifest: the decoded (padded)
                        # table carries the exact signature
                        man.note(ops, [tbl], True)
                    out = plan_mod.run_plan(
                        ops, tbl, donate_input=True,
                        mesh_runner=runner,
                    )
                    return rb._table_to_wire(out)

                return work

            for i, b in enumerate(batches):
                checkpoint()
                est = estimate_request_bytes(b)
                sess.admit(est)  # typed OverBudget / queues on inflight
                try:
                    t = self.scheduler.submit(
                        sess, self._on_device(make_work(b)), cost=b[4],
                        label="stream", charge=est, prof=prof,
                        shed=(i == 0), token=tok,
                    )
                except BaseException:
                    sess.release(est)
                    raise
                window.append((i, t))
                # keep at most queue_depth batches of THIS stream in
                # flight; draining here (in order) bounds the window
                # without ever blocking the scheduler itself
                while len(window) >= self.queue_depth:
                    j, tj = window.popleft()
                    results[j] = tj.result()
                    checkpoint()
            while window:
                j, tj = window.popleft()
                results[j] = tj.result()
                if window:
                    # more results pending: a dead peer cancels them
                    # instead of computing for nobody
                    checkpoint()
        except BaseException as e:
            # drain stragglers before answering: their results are
            # discarded but their budget charges must settle. The
            # token is cancelled first so queued batches settle
            # without running and in-flight ones abort at their next
            # between-segment checkpoint
            if not tok.cancelled:
                tok.cancel(f"stream aborted: {type(e).__name__}")
            while window:
                _, tj = window.popleft()
                with contextlib.suppress(BaseException):
                    tj.result()
            if isinstance(e, (ConnectionError, OSError)):
                raise  # peer is gone: nobody to answer
            frames.send_frame(sock, _error_header(e))
            return e
        finally:
            scope.__exit__(None, None, None)
        with metrics.span("serving.reply_serialize", session=sess.name):
            metas, buffers = frames.batches_to_parts(results)
            sess.stats["bytes_out"] += sum(len(b) for b in buffers)
            frames.send_frame(
                sock, {"ok": True, "results": metas}, buffers
            )
        return None

    def _cmd_upload(self, sock, sess, header, payload) -> None:
        batch = frames.batches_from_parts(
            [header.get("batch") or {}], payload
        )[0]
        sess.stats["bytes_in"] += len(payload)
        est = estimate_request_bytes(batch)
        sess.admit(est)
        try:
            t = self.scheduler.submit(
                sess, self._on_device(
                    lambda: rb.table_upload_wire(*batch, device=self.device)),
                cost=batch[4], label="upload", charge=est,
            )
        except BaseException:
            sess.release(est)
            raise
        rb_id = t.result()
        tbl = rb._resident_peek(rb_id)
        actual = int(hbm.table_bytes(tbl))
        local = sess.put_table(rb_id, actual)
        resp = {"table": local, "bytes": actual}
        req = header.get("req")
        dlog = self._dlog(sess)
        if dlog is not None:
            self._journal_safe(
                dlog, "log_put", local, tbl, actual, req=req, resp=resp
            )
        if req is not None and durable.enabled():
            sess.dedup_put(req, resp, cap=durable.DEDUP_CAP)
        frames.send_frame(sock, {"ok": True, **resp})

    def _cmd_plan(self, sock, sess, header) -> None:
        ops = self._plan_ops(header)
        tok = self._request_token(header, sess)
        locals_ = [int(x) for x in (header.get("tables") or [])]
        if not locals_:
            raise ValueError("serving: plan needs at least one table id")
        donate = bool(header.get("donate"))
        rb_ids = [sess.rb_id(x) for x in locals_]
        # output estimate: the chain input's resident size (already
        # charged) approximates the result; charge it as in-flight
        # until the result's actual size lands as resident
        try:
            head = rb._resident_get(rb_ids[0])
        except KeyError:
            raise sess._unknown_local_error(locals_[0])
        # pre-admission static analysis against the resident schemas: a
        # statically-invalid plan answers bad_request before admit() or
        # the scheduler queue. Rest inputs degrade to structural checks
        # when pending or missing (the runtime surfaces those exactly as
        # before).
        rest_sigs = []
        rest_tabs = []
        for rid in rb_ids[1:]:
            try:
                t = rb._resident_peek(rid)
            except KeyError:
                t = None
            resolved = (
                t is not None and not isinstance(t, pipeline.Pending)
            )
            if resolved:
                rest_tabs.append(t)
            rest_sigs.append(
                (plancheck.schema_of_table(t), int(t.logical_row_count))
                if resolved else (None, None)
            )
        plancheck.check_plan(
            ops,
            schema=plancheck.schema_of_table(head),
            rows=int(head.logical_row_count),
            rest=rest_sigs,
            names=head.names,
        )
        if (self._manifest is not None and durable.enabled()
                and len(rest_tabs) == len(rb_ids) - 1):
            # every input resolved: record the signature for
            # the next life's warm start
            self._manifest.note(ops, [head] + rest_tabs, donate)
        est = int(hbm.table_bytes(head))
        sess.admit(est)
        plan_json = json.dumps(ops)
        try:
            t = self.scheduler.submit(
                sess,
                self._on_device(lambda: rb.table_plan_resident(
                    plan_json, rb_ids, donate)),
                cost=max(est // 64, 1), label="plan", charge=est,
                token=tok,
            )
        except BaseException:
            sess.release(est)
            raise
        out_id = t.result()
        if donate:
            sess.drop_local(locals_[0])
        out = rb._resident_peek(out_id)
        dlog = self._dlog(sess)
        if dlog is not None and isinstance(out, pipeline.Pending):
            # durability needs the real table to checkpoint: resolve
            # the pipelined result now (the documented durable-on cost)
            out = rb._resident_get(out_id)
        actual = (
            est if isinstance(out, pipeline.Pending)
            else int(hbm.table_bytes(out))
        )
        local = sess.put_table(out_id, actual)
        resp = {"table": local}
        req = header.get("req")
        if dlog is not None:
            self._journal_safe(
                dlog, "log_put", local, out, actual,
                drop=locals_[0] if donate else None,
                req=req, resp=resp,
            )
        if req is not None and durable.enabled():
            sess.dedup_put(req, resp, cap=durable.DEDUP_CAP)
        frames.send_frame(sock, {"ok": True, **resp})

    def _cmd_download(self, sock, sess, header) -> None:
        rb_id = sess.rb_id(header.get("table"))
        t = self.scheduler.submit(
            sess, self._on_device(lambda: rb.table_download_wire(rb_id)),
            cost=1, label="download",
        )
        result = t.result()
        meta, buffers = frames.batch_to_parts(result)
        sess.stats["bytes_out"] += sum(len(b) for b in buffers)
        frames.send_frame(sock, {"ok": True, "result": meta}, buffers)

    def _cmd_drain(self, sock, header) -> None:
        """Rolling restart: stop admitting (new sessions AND device
        work shed with typed ``draining``), finish in-flight work under
        the existing deadline/cancel machinery, checkpoint (every
        mutation was journaled at apply time — the drain barrier just
        guarantees nothing is mid-flight), answer, then exit. The
        optional ``deadline_s`` bounds the wait; a daemon that cannot
        drain in time answers ``drained: false`` and still exits."""
        with self._lock:
            already = self._draining
            self._draining = True
        metrics.counter_add("serving.drains")
        if flight.enabled():
            flight.record("I", "serving.drain", self.port)
        timeout = header.get("deadline_s")
        drained = self.scheduler.wait_idle(
            None if timeout is None else float(timeout)
        )
        frames.send_frame(sock, {"ok": True, "drained": bool(drained)})
        if not already:
            threading.Thread(
                target=self.stop, name="srt-serve-drain", daemon=True
            ).start()

    # -- introspection ----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            sessions = [s.to_doc() for s in self._sessions.values()]
            served = self._sessions_served
            runners = list(self._mesh_runners.values())
        return {
            "port": self.port,
            "max_sessions": self.max_sessions,
            "queue_depth": self.queue_depth,
            "session_hbm_fraction": self.session_hbm_fraction,
            "sessions_live": len(sessions),
            "sessions_served": served,
            "resident_tables": rb.resident_table_count(),
            "spill": spill.stats_doc(),
            "breaker": self.breaker.to_doc(),
            "planstats": planstats.stats_doc(),
            "mesh": [r.to_doc() for r in runners],
            "durability": {
                **durable.stats_doc(),
                "draining": self._draining,
                "quarantined_sessions": len(self._quarantined),
                "restore": self._restore_doc,
            },
            "sessions": sessions,
        }

    def trace_doc(self) -> dict:
        """The live introspection plane behind the ``trace`` command:
        the tail-sampled slow-request log (slowest first, bounded to
        TRACE_TOPK, span detail only for SLO breaches / typed errors)
        plus a Prometheus-style text exposition of the metrics
        snapshot — scrape-able without restarting the daemon."""
        return {
            "slo_ms": float(config.get_flag("TRACE_SLO_MS")),
            "topk": int(config.get_flag("TRACE_TOPK")),
            "slow_requests": tracing.slow_requests(),
            "prometheus": metrics.prometheus_text(),
        }


@contextlib.contextmanager
def serve(**kwargs):
    """``with serve(...) as srv:`` — start a daemon, always stop it."""
    srv = Server(**kwargs).start()
    try:
        yield srv
    finally:
        srv.stop()
