"""Per-client sessions: table namespace, device memory budget, teardown
(port of ``serving/session.py``).

A session is the serving daemon's tenant unit, the analog of one Spark
task attached to the resident executor process. It owns:

* a **table namespace**: session-local table ids mapping to the global
  resident registry (``runtime_bridge``). Ids are scoped per session; a
  cross-session access raises a labeled KeyError naming the session.
* a **device memory budget**: a fraction of ``hbm.budget_bytes()`` of
  the server's device (``SPARK_RAPIDS_TPU_SERVE_SESSION_HBM_FRACTION``).
  Admission charges each request's estimate against the remainder; a
  request that can never fit is rejected with a typed OverBudget naming
  the budget, one blocked only by in-flight work queues until that
  drains. Donation credits flow back: where the JAX package's plan
  donates its buffers to XLA, the port's plan releases a consumed
  input's storage once no later step reads it; either way
  ``hbm.note_donation`` reports the bytes, and they are credited against
  that request's in-flight charge. The budget arithmetic is the JAX
  package's for equal inputs.
* **teardown with full reclamation**: on disconnect or crash every table
  the session still holds is reclaimed through
  ``runtime_bridge.table_reclaim``, which settles a pipelined reader
  first.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

from .. import runtime_bridge as rb
from ..utils import buckets, faults, hbm, lockcheck, metrics, spill, tracing

# Global reverse map rb_id -> (owning session, charged bytes): the spill
# tier's residency events carry rb ids, and the owning session credits /
# re-charges its budget from them (listener below). Guarded by its own
# lock — never taken while a Session lock is held, only inside the
# deferred-event flush (spill.flush_events) and the table bookkeeping
# paths, so there is no ordering against Session._cv to get wrong.
_OWNERS_LOCK = lockcheck.make_lock("session.owners")
_RB_OWNERS: Dict[int, Tuple["Session", int]] = {}


class OverBudget(Exception):
    """Typed admission rejection: the request's HBM estimate exceeds
    the session's budget. The message names the session and its budget
    so the client can size down or negotiate a bigger fraction."""


class SessionClosed(Exception):
    """The session was torn down while this request was queued or
    waiting for budget headroom."""


def estimate_request_bytes(batch) -> int:
    """Conservative HBM estimate for serving one wire batch: the wire
    buffer bytes, scaled up to the shape bucket the decode will pad to,
    doubled for input + output resident simultaneously (a donating plan
    never holds both — the donation credit gives the difference back)."""
    type_ids, scales, datas, valids, num_rows = batch
    wire = sum(len(d) for d in datas if d is not None)
    wire += sum(len(v) for v in valids if v is not None)
    n = max(int(num_rows), 1)
    pad = buckets.bucket_for(n) if buckets.enabled() else None
    if pad:
        wire = int(wire * (pad / n))
    return max(2 * wire, 1)


class Session:
    """One tenant: namespace + budget + stats. Thread-safe."""

    def __init__(self, session_id: str, name: str, weight: float,
                 budget_bytes: int):
        self.id = session_id
        self.name = name
        self.weight = max(float(weight), 1e-3)
        self.budget_bytes = int(budget_bytes)
        # session-default request deadline (seconds) from the hello
        # frame; per-command headers override, 0 means none
        self.deadline_s = 0.0
        # mesh-backed execution: hello ``mesh`` header device count; 0
        # (default) = single-device. Streams offer their plans to the
        # server's MeshRunner for that count; the degradation ladder
        # falls back to the single-device exact path rather than
        # shedding this tenant
        self.mesh_devices = 0
        self.created = time.time()
        self.connections = 0
        self.closed = False
        # durable serving (serving/durable.py): the reconnect secret
        # handed out at open (None when durability is off) and the
        # idempotency window mapping request ids of applied mutations
        # to their recorded responses
        self.resume_token: Optional[str] = None
        self._dedup: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = lockcheck.make_lock("session.state")
        self._cv = lockcheck.make_condition(self._lock)
        self._tables: Dict[int, Tuple[int, int]] = {}  # local -> (rb, B)
        self._next_local = itertools.count(1)
        self._resident_bytes = 0
        self._inflight_bytes = 0
        self._spilled_bytes = 0         # charged bytes currently off-device
        self._spilled_rb: set = set()   # rb ids of ours that are spilled
        self._waits = deque(maxlen=4096)  # queue-wait seconds
        self._lats = deque(maxlen=4096)   # submit->done latency seconds
        self.stats = {
            "requests": 0,
            "shed": 0,
            "over_budget": 0,
            "donated_credit_bytes": 0,
            "bytes_in": 0,
            "bytes_out": 0,
        }

    # -- HBM budget -------------------------------------------------------
    def admit(self, estimate: int, wait: bool = True) -> int:
        """Charge ``estimate`` bytes against the budget, queueing behind
        in-flight work when that is what blocks it. Raises the typed
        :class:`OverBudget` when the estimate can never fit (it exceeds
        the budget minus the session's resident tables), and
        :class:`SessionClosed` if torn down while waiting. The whole
        wait — spill rounds included — shows up in the request's trace
        as a ``serving.admission`` span."""
        tok = tracing.span_begin("serving.admission")
        try:
            got = self._admit(estimate, wait)
        except BaseException as e:
            tracing.span_end(tok, error=type(e).__name__)
            raise
        tracing.span_end(tok)
        return got

    def _admit(self, estimate: int, wait: bool) -> int:
        est = max(int(estimate), 0)
        faults.inject("hbm_admit")
        while True:
            with self._cv:
                if self.closed:
                    raise SessionClosed(
                        f"session {self.name} closed while admitting"
                    )
                hard_remaining = self.budget_bytes - self._resident_bytes
                free = hard_remaining - self._inflight_bytes
                if est <= free:
                    self._inflight_bytes += est
                    return est
                deficit = est - max(
                    hard_remaining if est > hard_remaining else free, 0
                )
            # Blocked: before shedding or queueing, ask the spill tier
            # to demote the coldest resident tables (any session's —
            # global LRU) OUTSIDE the session lock. A freed victim of
            # OURS credits _resident_bytes via the residency listener;
            # re-evaluate either way. Terminates: each round either
            # evicts something (the evictable set strictly shrinks) or
            # frees nothing and falls through to the shed/queue verdict.
            if spill.request_headroom(deficit, reason="admit"):
                metrics.counter_add("serving.admit_spills")
                continue
            with self._cv:
                if self.closed:
                    raise SessionClosed(
                        f"session {self.name} closed while admitting"
                    )
                hard_remaining = self.budget_bytes - self._resident_bytes
                if est <= hard_remaining - self._inflight_bytes:
                    self._inflight_bytes += est
                    return est
                if est > hard_remaining:
                    self.stats["over_budget"] += 1
                    metrics.counter_add("serving.over_budget")
                    raise OverBudget(
                        f"session {self.name}: request estimate {est} B "
                        f"exceeds remaining HBM budget {hard_remaining} B "
                        f"(session budget {self.budget_bytes} B, "
                        f"resident {self._resident_bytes} B)"
                    )
                if not wait:
                    self.stats["over_budget"] += 1
                    metrics.counter_add("serving.over_budget")
                    raise OverBudget(
                        f"session {self.name}: request estimate {est} B "
                        f"exceeds free HBM budget "
                        f"{hard_remaining - self._inflight_bytes} B "
                        f"({self._inflight_bytes} B in flight, session "
                        f"budget {self.budget_bytes} B)"
                    )
                # blocked only by in-flight work: queue until it drains
                self._cv.wait()

    def release(self, charge: int) -> None:
        """Return an admitted in-flight charge (request completed)."""
        with self._cv:
            self._inflight_bytes = max(
                self._inflight_bytes - max(int(charge), 0), 0
            )
            self._cv.notify_all()

    def note_donation(self, nbytes: int, ticket=None) -> int:
        """Credit donated bytes back against the in-flight charge (and
        the ticket's remaining charge, so its completion-time release
        doesn't double-credit). Returns the bytes actually credited."""
        n = max(int(nbytes), 0)
        with self._cv:
            if ticket is not None:
                n = min(n, max(getattr(ticket, "charge", 0), 0))
                ticket.charge -= n
            credited = min(n, self._inflight_bytes)
            self._inflight_bytes -= credited
            self.stats["donated_credit_bytes"] += credited
            if credited:
                self._cv.notify_all()
        return credited

    # -- table namespace --------------------------------------------------
    def _unknown_local_error(self, local_id) -> KeyError:
        with self._lock:
            live = len(self._tables)
        return KeyError(
            f"table id {int(local_id)} not found in session {self.name} "
            f"({live} table(s) live in this session; resident table ids "
            "are session-scoped)"
        )

    def put_table(self, rb_id: int, nbytes: int) -> int:
        """Register a resident table under this session; returns its
        session-local id and charges its bytes as resident."""
        with self._cv:
            local = next(self._next_local)
            self._tables[local] = (int(rb_id), int(nbytes))
            self._resident_bytes += int(nbytes)
        with _OWNERS_LOCK:
            _RB_OWNERS[int(rb_id)] = (self, int(nbytes))
        return local

    def _note_residency(self, event: str, rb_id: int,
                        charged: int) -> None:
        """Spill credit (residency listener): a table of ours that left
        the device tier stops counting against the session HBM budget —
        that is WHY admission spills instead of shedding — and
        re-charges when a repage brings it back."""
        with self._cv:
            if event == "out":
                if rb_id in self._spilled_rb:
                    return
                self._spilled_rb.add(rb_id)
                self._spilled_bytes += charged
                self._resident_bytes = max(
                    self._resident_bytes - charged, 0
                )
                self._cv.notify_all()
            else:
                if rb_id not in self._spilled_rb:
                    return
                self._spilled_rb.discard(rb_id)
                self._spilled_bytes = max(
                    self._spilled_bytes - charged, 0
                )
                self._resident_bytes += charged

    def _forget_owner(self, ent) -> None:
        """Drop the reverse-owner entry for a (rb_id, bytes) table
        entry leaving this session (no further residency credits)."""
        with _OWNERS_LOCK:
            _RB_OWNERS.pop(ent[0], None)

    def rb_id(self, local_id: int) -> int:
        """Global resident id for a session-local id; labeled KeyError
        on a miss (including every cross-session access)."""
        with self._lock:
            ent = self._tables.get(int(local_id))
        if ent is None:
            raise self._unknown_local_error(local_id)
        return ent[0]

    def _uncharge_locked(self, ent) -> None:
        """Remove a departing table's budget charge — from the spill
        credit when it is currently off-device, from resident otherwise."""
        if ent[0] in self._spilled_rb:
            self._spilled_rb.discard(ent[0])
            self._spilled_bytes = max(self._spilled_bytes - ent[1], 0)
        else:
            self._resident_bytes = max(self._resident_bytes - ent[1], 0)

    def drop_local(self, local_id: int) -> None:
        """Forget a local id whose global table was CONSUMED (donated
        into a plan) — no reclaim, the bytes moved into the result."""
        with self._cv:
            ent = self._tables.pop(int(local_id), None)
            if ent is not None:
                self._uncharge_locked(ent)
                self._cv.notify_all()
        if ent is not None:
            self._forget_owner(ent)

    def free_table(self, local_id: int) -> int:
        """Reclaim one table's HBM now (donate-barrier-settling free);
        returns bytes reclaimed. Labeled KeyError on a miss."""
        with self._cv:
            ent = self._tables.pop(int(local_id), None)
            if ent is not None:
                self._uncharge_locked(ent)
                self._cv.notify_all()
        if ent is None:
            raise self._unknown_local_error(local_id)
        self._forget_owner(ent)
        try:
            return rb.table_reclaim(ent[0])
        except KeyError:
            return 0  # already consumed by a donating plan

    def table_count(self) -> int:
        with self._lock:
            return len(self._tables)

    # -- durability (serving/durable.py) ----------------------------------
    def dedup_get(self, req) -> Optional[dict]:
        """Recorded response for an already-applied request id, or
        None — the at-most-once check for reconnecting clients."""
        with self._lock:
            hit = self._dedup.get(str(req))
            return None if hit is None else dict(hit)

    def dedup_put(self, req, resp: dict, cap: int = 512) -> None:
        with self._lock:
            self._dedup[str(req)] = dict(resp)
            while len(self._dedup) > cap:
                self._dedup.popitem(last=False)

    def restore_table(self, local: int, rb_id: int,
                      nbytes: int) -> None:
        """Re-register a journal-recovered table under its ORIGINAL
        session-local id, re-charging its bytes as resident (the HBM
        accounting the journal's budget record expects)."""
        local = int(local)
        with self._cv:
            self._tables[local] = (int(rb_id), int(nbytes))
            self._resident_bytes += int(nbytes)
        with _OWNERS_LOCK:
            _RB_OWNERS[int(rb_id)] = (self, int(nbytes))

    def advance_locals(self, next_local: int) -> None:
        """Continue local-id allocation past the journal's high-water
        mark — restored ids and fresh ones must never collide."""
        with self._lock:
            self._next_local = itertools.count(max(int(next_local), 1))

    # -- stats ------------------------------------------------------------
    def note_wait(self, seconds: float) -> None:
        with self._lock:
            self._waits.append(float(seconds))
            self.stats["requests"] += 1

    def note_shed(self) -> None:
        with self._lock:
            self.stats["shed"] += 1

    def note_latency(self, seconds: float) -> None:
        """End-to-end submit->done latency of one scheduled request —
        queue wait PLUS execution, the number the tenant experiences."""
        with self._lock:
            self._lats.append(float(seconds))

    def _percentiles(self, samples) -> dict:
        with self._lock:
            vals = sorted(samples)
        if not vals:
            return {"p50_ms": 0.0, "p95_ms": 0.0, "max_ms": 0.0}

        def pct(p):
            i = min(int(p * (len(vals) - 1) + 0.5), len(vals) - 1)
            return round(vals[i] * 1e3, 3)

        return {
            "p50_ms": pct(0.50),
            "p95_ms": pct(0.95),
            "max_ms": round(vals[-1] * 1e3, 3),
        }

    def wait_percentiles(self) -> dict:
        return self._percentiles(self._waits)

    def latency_percentiles(self) -> dict:
        return self._percentiles(self._lats)

    def to_doc(self) -> dict:
        with self._cv:
            doc = {
                "session": self.id,
                "name": self.name,
                "weight": self.weight,
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self._resident_bytes,
                "inflight_bytes": self._inflight_bytes,
                "spilled_bytes": self._spilled_bytes,
                "spilled_tables": len(self._spilled_rb),
                "tables": len(self._tables),
                "connections": self.connections,
                "mesh_devices": self.mesh_devices,
                **dict(self.stats),
            }
        doc["queue_wait"] = self.wait_percentiles()
        doc["latency"] = self.latency_percentiles()
        return doc

    # -- teardown ---------------------------------------------------------
    def teardown(self) -> int:
        """Reclaim every table this session still holds (disconnect or
        crash path). Safe against in-flight pipelined readers: each
        reclaim settles them via the donation-barrier path before any
        buffer is deleted. Returns total bytes reclaimed."""
        with self._cv:
            self.closed = True
            tables = list(self._tables.values())
            self._tables.clear()
            self._resident_bytes = 0
            self._spilled_bytes = 0
            self._spilled_rb.clear()
            self._cv.notify_all()
        with _OWNERS_LOCK:
            for rb_id, _ in tables:
                _RB_OWNERS.pop(rb_id, None)
        reclaimed = 0
        for rb_id, _ in tables:
            try:
                reclaimed += rb.table_reclaim(rb_id)
            except KeyError:
                pass  # consumed by a donating plan before teardown
        return reclaimed


# ---------------------------------------------------------------------------
# execution-scope binding: which (session, ticket) the calling thread is
# serving — the donation listener credits budgets through this.
# ---------------------------------------------------------------------------

_TLS = threading.local()


class executing:
    """Scope marking the calling thread as executing ``ticket`` for
    ``session`` (scheduler executor threads)."""

    __slots__ = ("_prev", "_cur")

    def __init__(self, session: Optional[Session], ticket=None):
        self._cur = (session, ticket) if session is not None else None

    def __enter__(self):
        self._prev = getattr(_TLS, "current", None)
        _TLS.current = self._cur
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _TLS.current = self._prev
        return False


def _donation_listener(nbytes: int) -> None:
    cur = getattr(_TLS, "current", None)
    if cur is not None:
        sess, ticket = cur
        sess.note_donation(nbytes, ticket)


hbm.register_donation_listener(_donation_listener)


def _residency_listener(event: str, rb_id: int, nbytes: int) -> None:
    """Spill residency events -> session budget credit. Fired from
    spill.flush_events with NO registry lock held (deferred queue), so
    taking the owning session's lock here cannot invert against the
    teardown path that holds a session lock while reclaiming."""
    with _OWNERS_LOCK:
        ent = _RB_OWNERS.get(int(rb_id))
    if ent is None:
        return  # not a serving-owned table (library embedder)
    sess, charged = ent
    sess._note_residency(event, int(rb_id), charged)


spill.register_residency_listener(_residency_listener)
