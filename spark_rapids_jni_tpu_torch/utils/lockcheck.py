"""Dynamic lock-order detector (port of ``utils/lockcheck.py``).

* Modules construct their locks through :func:`make_lock` /
  :func:`make_rlock` / :func:`make_condition`, each with a **dotted
  name** (``"registry.resident"``, ``"pipeline.pending"``) whose first
  segment keys the sanctioned order :data:`LOCK_ORDER`.
* Under ``SPARK_RAPIDS_TPU_LOCKCHECK=on`` every acquisition records the
  per-thread held set and folds edges ``held -> acquiring`` into a
  global acquisition-order graph. :func:`report` gives the cycles in
  that graph (potential deadlocks), the **immediate** inversions of
  :data:`LOCK_ORDER`, and the locks held across a blocking call
  (:func:`note_blocking`: ``runtime_bridge``'s device dispatch and the
  spill tier's disk reads).
* The report rides a ``lockcheck`` flight-dump exit section, and folds
  ``lock.*`` counters into the metrics registry when it is taken.

Disabled, an acquisition costs the raw ``threading`` primitive plus one
cached generation compare. The detector's own bookkeeping takes ONE raw
lock and never calls into metrics or flight on the acquisition path;
``metrics.py``, ``flight.py`` and ``log.py`` keep raw locks, since the
detector reports through them.

Sanctioned order (data, checked on every ranked acquisition)::

    registry -> session -> scheduler -> spill

First segments not in the table (``pipeline``, ``buckets``, ``hbm``,
...) are unranked: they add graph edges (cycle detection covers them)
but skip the rank check.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Dict, List, Optional, Tuple

from . import config

# ---------------------------------------------------------------------------
# sanctioned acquisition order — data, not prose. Rank by the FIRST
# dotted segment of the lock name; lower rank must be acquired first.
# ---------------------------------------------------------------------------

LOCK_ORDER: Tuple[str, ...] = ("registry", "session", "scheduler", "spill")

_RANK = {seg: i for i, seg in enumerate(LOCK_ORDER)}

# detector bookkeeping lock — deliberately RAW: tracking it would
# recurse, and it is only ever taken with the gate already passed
_STATE_LOCK = threading.Lock()

# (held_name, acquired_name) -> {"count": int, "example": {...}}
_EDGES: Dict[Tuple[str, str], Dict[str, Any]] = {}
# sanctioned-order inversions, recorded at the acquiring call site
_ORDER_VIOLATIONS: List[Dict[str, Any]] = []
# locks held while entering a device dispatch / blocking-IO region
_BLOCKING_VIOLATIONS: List[Dict[str, Any]] = []
_ACQUISITIONS = 0

_MAX_VIOLATIONS = 256  # a broken loop must not grow these unbounded

_TLS = threading.local()

# gate cache on config.generation(), the metrics.py discipline
_GATE_GEN = -1
_GATE_ON = False


def _refresh_gate() -> None:
    global _GATE_GEN, _GATE_ON
    _GATE_ON = bool(config.get_flag("LOCKCHECK"))
    _GATE_GEN = config.generation()


def enabled() -> bool:
    """True when the detector is recording (cheap cached gate)."""
    if _GATE_GEN != config.generation():
        _refresh_gate()
    return _GATE_ON


def _held() -> list:
    got = getattr(_TLS, "held", None)
    if got is None:
        got = _TLS.held = []
    return got


def _site(skip: int = 3) -> str:
    """``file:line`` of the acquiring frame (best effort, first-edge
    cost only — never on the per-acquisition fast path)."""
    try:
        frames = traceback.extract_stack(limit=skip + 2)
        # walk outward past lockcheck frames to the caller
        for fr in reversed(frames):
            if "lockcheck" not in fr.filename:
                return f"{fr.filename}:{fr.lineno}"
        return "<unknown>"
    except Exception:  # srt: allow-broad-except(diagnostic provenance only; a stack-walk failure must not break the acquisition it annotates)
        return "<unknown>"


def _note_acquiring(lock: "_Tracked") -> None:
    """Order/graph bookkeeping at the acquisition ATTEMPT (before the
    raw acquire blocks — a true deadlock still leaves its edges)."""
    global _ACQUISITIONS
    held = _held()
    for entry in held:
        if entry[0] is lock:
            return  # RLock re-entry: no new edges, no rank check
    rank = _RANK.get(lock.name.split(".", 1)[0])
    with _STATE_LOCK:
        _ACQUISITIONS += 1
        for entry in held:
            other = entry[0]
            if other.name == lock.name:
                continue  # two instances of one class: not an order fact
            key = (other.name, lock.name)
            e = _EDGES.get(key)
            if e is None:
                _EDGES[key] = {"count": 1, "example": _site()}
            else:
                e["count"] += 1
            if (
                rank is not None
                and entry[1] is not None
                and entry[1] > rank
                and len(_ORDER_VIOLATIONS) < _MAX_VIOLATIONS
            ):
                _ORDER_VIOLATIONS.append({
                    "held": other.name,
                    "acquiring": lock.name,
                    "order": "->".join(LOCK_ORDER),
                    "thread": threading.current_thread().name,
                    "site": _site(),
                })


def _note_acquired(lock: "_Tracked") -> None:
    held = _held()
    for entry in held:
        if entry[0] is lock:
            entry[2] += 1
            return
    rank = _RANK.get(lock.name.split(".", 1)[0])
    held.append([lock, rank, 1])


def _note_released(lock: "_Tracked") -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            held[i][2] -= 1
            if held[i][2] <= 0:
                del held[i]
            return


def note_blocking(kind: str) -> None:
    """Hook for device-dispatch / blocking-IO entry points: records any
    tracked lock the calling thread still holds — holding the registry
    lock across a device launch serializes every other dispatcher
    behind the chip. Costs one cached gate compare when off."""
    if not enabled():
        return
    held = _held()
    if not held:
        return
    with _STATE_LOCK:
        if len(_BLOCKING_VIOLATIONS) < _MAX_VIOLATIONS:
            _BLOCKING_VIOLATIONS.append({
                "kind": kind,
                "held": [e[0].name for e in held],
                "thread": threading.current_thread().name,
                "site": _site(),
            })


# ---------------------------------------------------------------------------
# tracked primitives
# ---------------------------------------------------------------------------


class _Tracked:
    """Shared acquire/release shim over a raw threading primitive."""

    __slots__ = ("_lock", "name")

    def __init__(self, raw, name: str):
        self._lock = raw
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if enabled():
            _note_acquiring(self)
            got = self._lock.acquire(blocking, timeout)
            if got:
                _note_acquired(self)
            return got
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        self._lock.release()
        if enabled():
            _note_released(self)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {self.name!r}>"


class TrackedLock(_Tracked):
    __slots__ = ()


class TrackedRLock(_Tracked):
    __slots__ = ()

    # threading.Condition probes these when built over an RLock; they
    # must come in matched release/acquire pairs around a wait, so the
    # held-set bookkeeping rides along
    def _release_save(self):
        state = self._lock._release_save()
        if enabled():
            # a wait fully releases the RLock regardless of depth
            held = self._held_entry()
            if held is not None:
                held[2] = 1
                _note_released(self)
        return state

    def _acquire_restore(self, state) -> None:
        self._lock._acquire_restore(state)
        if enabled():
            _note_acquired(self)

    def _is_owned(self) -> bool:
        return self._lock._is_owned()

    def _held_entry(self):
        for entry in _held():
            if entry[0] is self:
                return entry
        return None


class TrackedCondition:
    """Condition over a tracked lock: waits release the held-set entry
    (the raw wait releases the raw lock) and re-add it on wake, so a
    waiter never looks like it holds the lock across the block."""

    __slots__ = ("_cond", "_owner")

    def __init__(self, owner: _Tracked):
        self._owner = owner
        if isinstance(owner, TrackedRLock):
            # Condition drives the tracked RLock directly through the
            # _release_save/_acquire_restore shims above
            self._cond = threading.Condition(owner)
        else:
            self._cond = threading.Condition(owner._lock)

    def __enter__(self):
        self._owner.__enter__()
        return self

    def __exit__(self, *exc):
        return self._owner.__exit__(*exc)

    def wait(self, timeout: Optional[float] = None):
        track = enabled() and not isinstance(self._owner, TrackedRLock)
        if track:
            _note_released(self._owner)
        try:
            return self._cond.wait(timeout)
        finally:
            if track:
                _note_acquired(self._owner)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # re-implemented over self.wait so the held-set bookkeeping
        # wraps every underlying wait slice
        import time as _time

        end = None if timeout is None else _time.monotonic() + timeout
        result = predicate()
        while not result:
            if end is not None:
                left = end - _time.monotonic()
                if left <= 0:
                    break
                self.wait(left)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


def make_lock(name: str) -> TrackedLock:
    """A named, order-tracked ``threading.Lock``."""
    return TrackedLock(threading.Lock(), name)


def make_rlock(name: str) -> TrackedRLock:
    """A named, order-tracked ``threading.RLock``."""
    return TrackedRLock(threading.RLock(), name)


def make_condition(lock: _Tracked) -> TrackedCondition:
    """A ``threading.Condition`` sharing a tracked lock."""
    if not isinstance(lock, _Tracked):
        raise TypeError(
            f"make_condition needs a lockcheck-tracked lock, got "
            f"{type(lock).__name__}"
        )
    return TrackedCondition(lock)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def _find_cycles(edges) -> List[List[str]]:
    """Elementary cycles in the (small) name graph: for each strongly
    connected component with more than one node (or a self-edge), one
    witness cycle via DFS. Deterministic: nodes walked sorted."""
    graph: Dict[str, List[str]] = {}
    for a, b in edges:
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    for v in graph.values():
        v.sort()
    cycles: List[List[str]] = []
    seen_keys = set()
    for start in sorted(graph):
        # DFS from start looking for a path back to start
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        visited = set()
        while stack:
            node, path = stack.pop()
            for nxt in graph.get(node, ()):
                if nxt == start and len(path) > 1:
                    key = frozenset(path)
                    if key not in seen_keys:
                        seen_keys.add(key)
                        cycles.append(path + [start])
                elif nxt not in visited and nxt != start:
                    visited.add(nxt)
                    stack.append((nxt, path + [nxt]))
    return cycles


def report() -> dict:
    """One JSON-able report: the acquisition-order graph, cycles found
    in it, sanctioned-order inversions, and locks held across blocking
    regions. Also folds ``lock.*`` counters into the metrics registry
    (report time, never the acquisition path)."""
    with _STATE_LOCK:
        edges = {
            f"{a}->{b}": dict(v) for (a, b), v in sorted(_EDGES.items())
        }
        edge_keys = list(_EDGES.keys())
        order_violations = [dict(v) for v in _ORDER_VIOLATIONS]
        blocking = [dict(v) for v in _BLOCKING_VIOLATIONS]
        acquisitions = _ACQUISITIONS
    cycles = _find_cycles(edge_keys)
    doc = {
        "enabled": enabled(),
        "order": list(LOCK_ORDER),
        "acquisitions": acquisitions,
        "edges": edges,
        "cycles": [" -> ".join(c) for c in cycles],
        "order_violations": order_violations,
        "held_across_blocking": blocking,
    }
    from . import metrics  # late: metrics imports nothing from here

    metrics.counter_add("lock.acquisitions", 0)  # ensure the row exists
    metrics.gauge_set("lock.tracked_edges", len(edges))
    if cycles:
        metrics.counter_add("lock.cycles", len(cycles))
    if order_violations:
        metrics.counter_add("lock.order_violations", len(order_violations))
    if blocking:
        metrics.counter_add("lock.held_across_blocking", len(blocking))
    return doc


def assert_clean(strict_blocking: bool = False) -> dict:
    """Raise AssertionError on any cycle or sanctioned-order inversion;
    returns the report when clean (test/CI helper). Held-across-
    blocking findings are informational by default — some are
    intentional (the repage path reads disk under the registry lock by
    design, so the table can't be freed mid-load) — pass
    ``strict_blocking=True`` to fail on them too."""
    doc = report()
    keys = ["cycles", "order_violations"]
    if strict_blocking:
        keys.append("held_across_blocking")
    problems = {k: doc[k] for k in keys if doc[k]}
    if problems:
        raise AssertionError(f"lockcheck found problems: {problems}")
    return doc


def summary_line() -> str:
    """The one-line findings summary CI prints."""
    doc = report()
    return (
        f"lockcheck: {doc['acquisitions']} acquisitions, "
        f"{len(doc['edges'])} order edges, {len(doc['cycles'])} cycles, "
        f"{len(doc['order_violations'])} order violations, "
        f"{len(doc['held_across_blocking'])} held-across-blocking"
    )


def reset() -> None:
    """Drop every recorded edge/violation (test isolation). Held sets
    are per-thread state and drain as their locks release."""
    global _ACQUISITIONS
    with _STATE_LOCK:
        _EDGES.clear()
        _ORDER_VIOLATIONS.clear()
        _BLOCKING_VIOLATIONS.clear()
        _ACQUISITIONS = 0


def _exit_section() -> dict:
    if not enabled():
        return {"enabled": False}
    return report()


# ride the flight dump: a crashed run's last act includes the lock
# graph (the postmortem that explains a hang-to-SIGKILL)
from . import flight as _flight  # noqa: E402  (import cycle: none — flight imports only config)

_flight.register_exit_section("lockcheck", _exit_section)
