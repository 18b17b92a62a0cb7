"""Flight recorder (port of ``utils/flight.py``): the crash-surviving
telemetry ring of the dispatch plane.

* A power-of-two **ring** of the last N events (span begin/end, wire
  transfers, cache misses, retries, counter samples) with monotonic
  nanosecond stamps and thread ids. :func:`record` takes no lock: a
  sequence fetch from ``itertools.count`` and one list-slot store are
  atomic under the GIL, so the pipeline's worker threads (each driving
  its own CUDA stream) write it without contending; a wraparound race
  only picks which of two complete events survives. :func:`dropped`
  counts the events lost to wraparound.
* **Exit sections**: subsystems register callables whose results ride
  every dump (``runtime_bridge`` the resident-table leak report,
  ``utils/lockcheck.py`` its report, ``utils/profiler.py`` its
  sessions, ``utils/spill.py`` and ``utils/planstats.py`` their stats).
* The **dump** at interpreter exit to ``SPARK_RAPIDS_TPU_FLIGHT_DUMP``:
  the JAX package's JSON format, so ``tools/trace2chrome.py``,
  ``tools/tracequery.py`` and ``tools/explain.py`` read a dump of either
  package.

``SPARK_RAPIDS_TPU_FLIGHT`` truthy (or an integer ring capacity), or a
``FLIGHT_DUMP`` path, turns the recorder on; a disabled :func:`record`
costs one cached generation compare.

Event format, one tuple a slot (``tail_records`` gives dicts)::

    (seq, t_ns, tid, ph, name, arg)

``ph`` is ``"B"``/``"E"`` (span begin/end; ``name`` the qualified span
path), ``"I"`` (an instant; ``arg`` its payload) or ``"C"`` (a counter
sample; ``arg`` its value).
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import socket
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import config

_HOSTNAME = socket.gethostname()

DEFAULT_CAPACITY = 8192
# pow2 ceiling on env-sized rings: a typo'd huge capacity must not
# allocate gigabytes of slots at the first record() call
MAX_CAPACITY = 1 << 22

_TRUTHY = frozenset({"1", "true", "yes", "on"})
_FALSY = frozenset({"", "0", "false", "no", "off", "none"})

# wall-clock anchor: perf_counter_ns is monotonic but epoch-less; the
# dump carries both so a postmortem can place the timeline in real time
_EPOCH_NS = time.time_ns()
_ANCHOR_NS = time.perf_counter_ns()

# ring state — (re)built under _SETUP_LOCK on config-generation change;
# the record() hot path reads the module globals without taking it.
# RLock: a signal handler that dumps from the main thread must not
# self-deadlock if the signal lands inside _refresh()
_SETUP_LOCK = threading.RLock()
_SLOTS: Optional[list] = None
_SEQ = itertools.count()
_GEN = -1
_WARNED_SPEC = False

_EXIT_SECTIONS: Dict[str, Callable[[], Any]] = {}

# (pid, host, session_id, ...) metadata stamped into every dump so a
# multi-process merge (tools/explain.py --merge) can tell the dumps
# apart; the profiler stamps the current session id through here
_PROCESS_META: Dict[str, Any] = {}


def set_process_meta(**kv) -> None:
    """Attach metadata keys to every future ``snapshot()``/``dump()``
    (``utils/profiler.py`` stamps ``session_id``); a None value removes
    the key."""
    for k, v in kv.items():
        if v is None:
            _PROCESS_META.pop(k, None)
        else:
            _PROCESS_META[k] = v


def _capacity_of(value) -> int:
    """Ring capacity implied by the FLIGHT flag value: 0 = disabled,
    truthy = DEFAULT_CAPACITY, an integer = that many slots (rounded up
    to a power of two, clamped to MAX_CAPACITY)."""
    global _WARNED_SPEC
    if value is None:
        return 0
    if isinstance(value, bool):
        return DEFAULT_CAPACITY if value else 0
    if isinstance(value, int):
        n = value
    else:
        s = str(value).strip().lower()
        if s in _FALSY:
            return 0
        if s in _TRUTHY:
            return DEFAULT_CAPACITY
        try:
            n = int(s)
        except ValueError:
            # the log.py invalid-LOG_LEVEL discipline: warn once and
            # fall back to the default capacity — the operator clearly
            # wanted the recorder ON, a typo must not silence the one
            # plane that explains the next crash
            if not _WARNED_SPEC:
                _WARNED_SPEC = True
                print(
                    f"[srt][flight][WARN] SPARK_RAPIDS_TPU_FLIGHT="
                    f"{value!r} is not on|off|<capacity>; using default "
                    f"capacity {DEFAULT_CAPACITY}",
                    file=sys.stderr,
                    flush=True,
                )
            return DEFAULT_CAPACITY
    if n <= 0:
        return 0
    n = min(n, MAX_CAPACITY)
    size = 1
    while size < n:
        size *= 2
    return size


def _refresh() -> None:
    global _SLOTS, _GEN
    with _SETUP_LOCK:
        cap = _capacity_of(config.get_flag("FLIGHT"))
        if cap == 0 and str(config.get_flag("FLIGHT_DUMP") or ""):
            # a configured dump path implies recording, the
            # METRICS_DUMP-implies-METRICS convention
            cap = DEFAULT_CAPACITY
        if cap == 0:
            _SLOTS = None
        elif _SLOTS is None or len(_SLOTS) != cap:
            _SLOTS = [None] * cap
        _GEN = config.generation()


def enabled() -> bool:
    """True when the recorder is collecting (cheap cached gate)."""
    if _GEN != config.generation():
        _refresh()
    return _SLOTS is not None


def capacity() -> int:
    """Current ring capacity in events (0 when disabled)."""
    if _GEN != config.generation():
        _refresh()
    return len(_SLOTS) if _SLOTS is not None else 0


def record(ph: str, name: str, arg=None, t_ns: Optional[int] = None) -> None:
    """Record one event. THE hot path: a generation compare when
    disabled; a sequence fetch + timestamp + one list-slot store when
    on. No lock — ``next()`` on ``itertools.count`` and a list index
    assignment are both atomic under the GIL, and each writer owns its
    slot outright (distinct seq => distinct slot modulo wraparound, and
    a wraparound race merely picks which of two complete events
    survives — torn events are impossible). The index mask is derived
    from the CAPTURED slots list (capacity is always a power of two),
    never from a second global — pairing the list with a separately
    published mask could index out of bounds across a concurrent
    resize.

    ``t_ns`` (perf_counter_ns timebase) backdates the event: the
    scheduler records a queue-wait span AFTER the wait is known, with
    the B stamped at submit time — both events land on the recording
    thread so the Chrome exporter's per-tid pairing still holds."""
    if _GEN != config.generation():
        _refresh()
    slots = _SLOTS
    if slots is None:
        return
    seq = next(_SEQ)
    slots[seq & (len(slots) - 1)] = (
        seq,
        time.perf_counter_ns() if t_ns is None else int(t_ns),
        threading.get_ident(),
        ph,
        name,
        arg,
    )


def events(limit: Optional[int] = None) -> List[tuple]:
    """The ring's surviving events, oldest -> newest (raw tuples).
    Sequence numbers are unique so the sort never compares payloads."""
    slots = _SLOTS
    if slots is None:
        return []
    got = sorted(e for e in slots if e is not None)
    if limit is not None and limit >= 0:
        got = got[len(got) - limit:] if limit < len(got) else got
    return got


def tail_records(limit: Optional[int] = None) -> List[dict]:
    """JSON-able view of the tail: the shape the flight dump and the
    Chrome exporter consume."""
    out = []
    for seq, t_ns, tid, ph, name, arg in events(limit):
        e = {"seq": seq, "t_ns": t_ns, "tid": tid, "ph": ph, "name": name}
        if arg is not None:
            e["arg"] = arg
        out.append(e)
    return out


def dropped() -> int:
    """Events lost to wraparound so far."""
    got = events()
    if not got:
        return 0
    return max(0, got[-1][0] + 1 - len(got))


def register_exit_section(name: str, fn: Callable[[], Any]) -> None:
    """Attach a named provider whose result is embedded in every dump
    (``runtime_bridge`` registers the resident-table leak report)."""
    _EXIT_SECTIONS[name] = fn


def snapshot(limit: Optional[int] = None) -> dict:
    """One JSON-able dict: the event tail + anchors + exit sections."""
    evs = tail_records(limit)
    doc = {
        "version": 1,
        "pid": os.getpid(),
        "host": _HOSTNAME,
        "capacity": capacity(),
        "dropped": dropped(),
        "epoch_ns": _EPOCH_NS,
        "anchor_perf_ns": _ANCHOR_NS,
        "events": evs,
    }
    for k, v in _PROCESS_META.items():
        doc.setdefault(k, v)
    sections = {}
    for name, fn in _EXIT_SECTIONS.items():
        try:
            sections[name] = fn()
        # srt: allow-broad-except(a broken exit-section provider must not eat the dump; its error is embedded instead)
        except Exception as e:
            sections[name] = {"error": f"{type(e).__name__}: {e}"}
    if sections:
        doc["sections"] = sections
    return doc


def reset() -> None:
    """Drop every recorded event and re-read the config (test isolation)."""
    global _SLOTS, _SEQ, _GEN
    with _SETUP_LOCK:
        _SLOTS = None
        _SEQ = itertools.count()
        _GEN = -1
        _PROCESS_META.clear()


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write the snapshot as JSON to ``path`` (default: the
    ``SPARK_RAPIDS_TPU_FLIGHT_DUMP`` flag). Returns the path written, or
    None when no path is configured. Failures WARN on stderr instead of
    raising — the metrics.dump() discipline: a broken dump path must not
    take the process down at exit (or inside a signal handler)."""
    path = path or str(config.get_flag("FLIGHT_DUMP") or "")
    if not path:
        return None
    try:
        with open(path, "w") as f:
            json.dump(snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path
    except OSError as e:
        print(
            f"[srt][flight][WARN] flight dump to {path!r} failed: {e}",
            file=sys.stderr,
            flush=True,
        )
        return None


def _dump_at_exit() -> None:  # pragma: no cover - exercised via subprocess
    dump()


atexit.register(_dump_at_exit)
