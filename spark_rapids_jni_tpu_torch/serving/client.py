"""Client of the serving daemon (port of ``serving/client.py``).

Speaks the frame protocol of ``serving/frames.py`` over a localhost
socket and maps the daemon's typed error responses back onto typed
Python exceptions: a shed request raises :class:`ServingBusy`, an
admission rejection :class:`ServingOverBudget` (the message names the
session budget), a cross-session table access :class:`ServingTableError`
(a KeyError naming the session), as an embedded JNI caller sees them as
status codes. It speaks to either package's server.
"""

from __future__ import annotations

import contextlib
import socket
from typing import List, Optional, Sequence

from ..utils import tracing
from . import frames


class ServingError(RuntimeError):
    """Base typed daemon error. ``type`` is the wire error type."""

    def __init__(self, type_: str, message: str, exception: str = ""):
        super().__init__(message)
        self.type = type_
        self.exception = exception


class ServingBusy(ServingError):
    """The session's queue was at depth: request shed, retry later."""


class ServingOverBudget(ServingError):
    """Admission rejected the request against the session HBM budget."""


class ServingSessionLimit(ServingError):
    """The daemon is at SERVE_MAX_SESSIONS."""


class ServingTableError(ServingError, KeyError):
    """Unknown (or cross-session) table id — labeled per session."""

    def __str__(self) -> str:  # KeyError reprs its arg; keep the label
        return self.args[0] if self.args else ""


class ServingDegraded(ServingError):
    """The daemon's circuit breaker is open: shed without device work.
    The message names when the next recovery probe runs."""


class ServingCancelled(ServingError):
    """The request was cancelled server-side before completing."""


class ServingDeadlineExceeded(ServingError):
    """The request's deadline elapsed before the work finished."""


class ServingResourceExhausted(ServingError):
    """Device memory pressure the daemon could not degrade around."""


class ServingTransientError(ServingError):
    """A transient device failure that outlived the retry budget —
    safe to retry client-side."""


class ServingResumeDenied(ServingError):
    """A reconnect hello carried a missing or wrong resume token."""


class ServingQuarantined(ServingError):
    """The session's durable state was quarantined during restore —
    its tables are unrecoverable; open a fresh session."""


class ServingDraining(ServingError):
    """The daemon is draining for a rolling restart: reconnect to its
    replacement (or retry after the restart)."""


class ServingCheckpointCorrupt(ServingError):
    """Durable state failed an integrity check server-side."""


_ERROR_CLASSES = {
    "busy": ServingBusy,
    "over_budget": ServingOverBudget,
    "session_limit": ServingSessionLimit,
    "unknown_table": ServingTableError,
    "degraded": ServingDegraded,
    "cancelled": ServingCancelled,
    "deadline_exceeded": ServingDeadlineExceeded,
    "resource_exhausted": ServingResourceExhausted,
    "transient_device": ServingTransientError,
    "resume_denied": ServingResumeDenied,
    "session_quarantined": ServingQuarantined,
    "draining": ServingDraining,
    "checkpoint_corrupt": ServingCheckpointCorrupt,
}


def _raise_error(err: dict) -> None:
    type_ = str(err.get("type", "internal"))
    cls = _ERROR_CLASSES.get(type_, ServingError)
    exc = cls(type_, str(err.get("message", "")),
              str(err.get("exception", "")))
    # a pre-admission static rejection ships its tagged plan report
    # (plancheck.analyze shape) alongside the message
    if "plan_report" in err:
        exc.plan_report = err["plan_report"]
    raise exc


class Client:
    """One connection to the daemon. ``with Client(port) as c:`` opens
    a session on connect; pass ``session=`` to attach another
    connection to an existing session (many Spark tasks, one tenant)."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 name: Optional[str] = None, weight: float = 1.0,
                 session: Optional[str] = None, timeout: float = 60.0,
                 deadline_s: Optional[float] = None,
                 resume: Optional[str] = None,
                 mesh: Optional[int] = None):
        self._addr = (host, int(port))
        # mesh=N asks for mesh-backed execution over N devices
        # (0/None = single-device); an impossible count is a typed
        # bad_request at hello, naming the remedy
        self._hello = {
            k: v for k, v in (
                ("name", name), ("weight", weight), ("session", session),
                ("deadline_s", deadline_s), ("resume", resume),
                ("mesh", mesh),
            ) if v is not None
        }
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self.session: Optional[str] = None
        self.name: Optional[str] = None
        self.budget_bytes: Optional[int] = None
        self.queue_depth: Optional[int] = None
        # durable daemons hand out a resume token at open: the secret
        # a reconnect presents to re-attach to this session
        self.resume_token: Optional[str] = resume

    # -- lifecycle --------------------------------------------------------
    def connect(self) -> "Client":
        s = socket.create_connection(self._addr, timeout=self._timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        resp = self._rpc({"cmd": "hello", **self._hello})
        self.session = resp.get("session")
        self.name = resp.get("name")
        self.budget_bytes = resp.get("budget_bytes")
        self.queue_depth = resp.get("queue_depth")
        if resp.get("resume_token") is not None:
            self.resume_token = resp["resume_token"]
        return self

    def reconnect(self) -> "Client":
        """Re-attach to the SAME session after a socket loss (or a
        daemon restart): fresh connection, hello carrying the session
        id + resume token. Pair with per-request ids (``req=``) on
        mutating commands for at-most-once semantics across the gap."""
        self.kill()
        if self.session is not None:
            self._hello["session"] = self.session
            if self.resume_token is not None:
                self._hello["resume"] = self.resume_token
        return self.connect()

    def close(self) -> None:
        """Graceful detach: bye + socket close (idempotent)."""
        s = self._sock
        if s is None:
            return
        self._sock = None
        with contextlib.suppress(Exception):
            frames.send_frame(s, {"cmd": "bye"})
            frames.recv_frame(s)
        with contextlib.suppress(OSError):
            s.close()

    def kill(self) -> None:
        """Abrupt disconnect WITHOUT bye — the client-crash path; the
        daemon must tear the session down and reclaim its tables."""
        s = self._sock
        self._sock = None
        if s is not None:
            with contextlib.suppress(OSError):
                s.close()

    def __enter__(self) -> "Client":
        if self._sock is None:
            self.connect()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # -- protocol ---------------------------------------------------------
    def _rpc(self, header: dict, buffers: Sequence[bytes] = ()):
        if self._sock is None:
            raise RuntimeError("client is not connected")
        # trace-context stamp: propagate the ambient context if the
        # caller has one, else mint a fresh per-request trace when the
        # plane is on — the server joins it, so both processes' flight
        # dumps share one trace id (tools/tracequery.py merges them)
        ctx = tracing.current()
        if ctx is None and tracing.context_enabled():
            ctx = tracing.new_context()
        if ctx is not None and "traceparent" not in header:
            header["traceparent"] = ctx.header
        with tracing.activate(ctx):
            tok = tracing.span_begin("client.rpc")
            try:
                frames.send_frame(self._sock, header, buffers)
                resp, payload = frames.recv_frame(self._sock)
            except BaseException as e:
                tracing.span_end(tok, error=type(e).__name__)
                raise
            tracing.span_end(
                tok,
                error=None if resp.get("ok")
                else str((resp.get("error") or {}).get("type", "error")),
            )
        if not resp.get("ok"):
            _raise_error(resp.get("error") or {})
        resp["_payload"] = payload
        return resp

    # -- commands ---------------------------------------------------------
    def stream(self, ops: list, batches: Sequence,
               deadline_s: Optional[float] = None) -> List[tuple]:
        """Run ``ops`` (a plan: JSON-able list of op dicts) over wire
        batches; returns one result 5-tuple per batch, in order.
        ``deadline_s`` bounds this one request (overrides the session
        default from hello)."""
        metas, buffers = frames.batches_to_parts(batches)
        header = {"cmd": "stream", "plan": list(ops), "batches": metas}
        if deadline_s is not None:
            header["deadline_s"] = float(deadline_s)
        resp = self._rpc(header, buffers)
        return frames.batches_from_parts(
            resp.get("results") or [], resp["_payload"]
        )

    def upload(self, batch, req: Optional[str] = None) -> int:
        meta, buffers = frames.batch_to_parts(batch)
        header = {"cmd": "upload", "batch": meta}
        if req is not None:
            header["req"] = str(req)
        resp = self._rpc(header, buffers)
        return int(resp["table"])

    def plan(self, ops: list, tables: Sequence[int],
             donate: bool = False,
             deadline_s: Optional[float] = None,
             req: Optional[str] = None) -> int:
        header = {
            "cmd": "plan", "plan": list(ops),
            "tables": [int(t) for t in tables], "donate": bool(donate),
        }
        if deadline_s is not None:
            header["deadline_s"] = float(deadline_s)
        if req is not None:
            header["req"] = str(req)
        resp = self._rpc(header)
        return int(resp["table"])

    def download(self, table: int) -> tuple:
        resp = self._rpc({"cmd": "download", "table": int(table)})
        batch, _ = frames.batch_from_parts(
            resp["result"], resp["_payload"], 0
        )
        return batch

    def free(self, table: int, req: Optional[str] = None) -> int:
        header = {"cmd": "free", "table": int(table)}
        if req is not None:
            header["req"] = str(req)
        resp = self._rpc(header)
        return int(resp.get("bytes", 0))

    def stats(self) -> dict:
        return self._rpc({"cmd": "stats"})["stats"]

    def trace(self) -> dict:
        """Live introspection plane: the daemon's slow-request log
        (top-K by duration, tail-sampled span detail) plus a
        Prometheus-style text exposition of the metrics snapshot."""
        return self._rpc({"cmd": "trace"})["trace"]

    def drain(self, deadline_s: Optional[float] = None) -> dict:
        """Rolling-restart drain: the daemon stops admitting, finishes
        in-flight work, checkpoints, answers, and exits. Returns the
        response (``drained`` False = deadline hit with work left)."""
        header = {"cmd": "drain"}
        if deadline_s is not None:
            header["deadline_s"] = float(deadline_s)
        return self._rpc(header)
