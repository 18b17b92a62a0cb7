"""Tiered memory: device -> host memory -> disk spill (port of
``utils/spill.py``, in full but for the serving checkpoint prefix).

* Every resident table (``runtime_bridge``'s registry) has a residency:
  ``device`` (a live Table), ``host`` (host copies of its storage
  tensors) or ``disk`` (an .npz file under ``SPILL_DIR``). Storage
  round-trips exactly (FLOAT64 is stored as its bits), so spill and
  repage are byte-identical by construction.
* Eviction is LRU by last touch: every registry access stamps a counter;
  pressure picks the coldest tables that nothing references. A table
  with live pipelined readers, active wire downloads or an explicit pin
  (the synchronous dispatch paths) is never evicted: the pin wins.
* Pressure comes from a dispatch raising ``ResourceExhausted`` (the plan
  runner's first rung), a footprint plan that does not fit (``hbm``'s
  pressure listeners) and a put that carries the tracked device tier
  past ``hbm.budget_bytes()``. The device tier's bytes are the tracked
  tables' bytes, not ``torch.cuda.mem_get_info``: the caching allocator
  keeps freed blocks reserved, so free device memory says little.
* On CUDA an eviction copies device -> host into pinned memory
  (``column.download_tensors``: ``non_blocking=True``, one event
  synchronised), and frees the table's storages at once
  (``untyped_storage().resize_(0)``); a repage uploads on the caller's
  current stream.
* The host tier is bounded by ``HOST_SPILL_BUDGET_GB``; past it the
  coldest host entries go to disk, the file write running on the
  pipeline's IO worker (``pipeline.submit_io``) so it overlaps compute.
  A repage resolves a pending write first.
* Counters: ``spill.evictions``, ``spill.demotions``, ``spill.repages``,
  ``spill.errors``; bytes ``spill.bytes_out``/``bytes_in``/
  ``disk_bytes_out``; tier gauges with high-water marks.

Flags: ``SPARK_RAPIDS_TPU_SPILL`` (off by default: one cached generation
compare per registry access), ``SPILL_DIR``, ``HOST_SPILL_BUDGET_GB``.
Files this process wrote are swept at exit.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import tempfile
import time as _time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..column import download_tensors, table_tensors
from . import config, faults, hbm, lockcheck, log, metrics

GIB = 1 << 30

DEVICE = "device"
HOST = "host"
DISK = "disk"

# ---------------------------------------------------------------------------
# flag gate (disabled costs one generation compare)
# ---------------------------------------------------------------------------

_GATE = (None, False)


def _truthy(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def enabled() -> bool:
    global _GATE
    gen = config.generation()
    if _GATE[0] != gen:
        _GATE = (gen, _truthy(config.get_flag("SPILL")))
    return _GATE[1]


def spill_dir() -> str:
    """Directory of disk-tier files, made on first use. The default is a
    per-process directory under the system temp dir, removed at exit when
    empty."""
    d = str(config.get_flag("SPILL_DIR") or "").strip()
    if not d:
        d = os.path.join(tempfile.gettempdir(), f"srt-spill-{os.getpid()}")
    os.makedirs(d, exist_ok=True)
    return d


def host_budget_bytes() -> int:
    """Host tier budget; past it the coldest host entries go to disk. 0
    skips the host tier."""
    return int(float(config.get_flag("HOST_SPILL_BUDGET_GB")) * GIB)


# ---------------------------------------------------------------------------
# registry binding: the spill tier works under the resident registry's
# own lock, so eviction, capture and reclaim are ordered by one lock
# ---------------------------------------------------------------------------

_REG_LOCK = None            # runtime_bridge._RESIDENT_LOCK (RLock)
_REG_TABLES: Optional[dict] = None   # id -> Table | Pending | SpilledTable
_REG_READERS: Optional[dict] = None  # id -> [in-flight reader Pendings]
_REG_ACTIVE_READS: Optional[dict] = None  # id -> wire-download count


def bind_registry(lock, tables, readers, active_reads) -> None:
    global _REG_LOCK, _REG_TABLES, _REG_READERS, _REG_ACTIVE_READS
    _REG_LOCK = lock
    _REG_TABLES = tables
    _REG_READERS = readers
    _REG_ACTIVE_READS = active_reads


# ---------------------------------------------------------------------------
# tracking state (under the bound registry lock unless noted)
# ---------------------------------------------------------------------------

_CLOCK = itertools.count(1)
_LAST_TOUCH: dict = {}      # id -> touch stamp (a dict write)
_TRACK: dict = {}           # id -> device bytes, for DEVICE-tier entries
_PINS: dict = {}            # id -> explicit pin count (sync dispatches)

_DEVICE_BYTES = 0
_HOST_BYTES = 0
_DISK_BYTES = 0
_HOST_HW = 0
_DISK_HW = 0

_FILE_SEQ = itertools.count(1)
_FILES: set = set()         # disk paths this process made, for the sweep

# Residency events for the serving tier, delivered with no lock held
# (flush_events): a listener takes its own locks.
_EVENTS_LOCK = lockcheck.make_lock("spill.events")
_EVENTS: deque = deque()
_RESIDENCY_LISTENERS: list = []


def register_residency_listener(fn) -> None:
    """Register ``fn(event, table_id, nbytes)`` with event ``"out"`` (a
    table left the device tier) or ``"in"`` (it was repaged). Fired from
    :func:`flush_events` with no spill or registry lock held; listeners
    must not raise."""
    if fn not in _RESIDENCY_LISTENERS:
        _RESIDENCY_LISTENERS.append(fn)


def flush_events() -> None:
    """Deliver queued residency events (the bridge calls it after it
    releases the registry lock at every repage site)."""
    while _EVENTS:
        with _EVENTS_LOCK:
            if not _EVENTS:
                return
            ev = _EVENTS.popleft()
        for fn in tuple(_RESIDENCY_LISTENERS):
            fn(*ev)


def _queue_event(event: str, tid: int, nbytes: int) -> None:
    if not _RESIDENCY_LISTENERS:
        return
    with _EVENTS_LOCK:
        _EVENTS.append((event, tid, nbytes))


# ---------------------------------------------------------------------------
# the spilled entry that replaces a Table in the registry
# ---------------------------------------------------------------------------


class SpilledTable:
    """Host or disk backing of one evicted resident table.

    ``cols`` (host tier) is a list of per-column tuples ``(type_id,
    scale, data, validity, lengths)`` of host copies of the storage
    tensors (CPU tensors after an eviction, numpy arrays after a disk
    load), so a repage is a plain upload to ``device``. On demotion the
    buffers move into the disk write's closure (``_write``, a pipeline IO
    Pending returning the path); a repage resolves it first."""

    __slots__ = (
        "tid", "state", "nbytes", "host_nbytes", "names", "rows",
        "logical_rows", "cols", "path", "device", "_write",
    )

    def __init__(self, tid, nbytes, host_nbytes, names, rows,
                 logical_rows, cols, device):
        self.tid = tid
        self.state = HOST
        self.nbytes = nbytes            # device bytes freed / re-added
        self.host_nbytes = host_nbytes  # host payload bytes
        self.names = names
        self.rows = rows                # logical row count
        self.logical_rows = logical_rows
        self.cols = cols
        self.path = None
        self.device = device            # where a repage uploads
        self._write = None

    @property
    def num_columns(self) -> int:
        return len(self.cols) if self.cols is not None else 0


def storage_key(t: torch.Tensor) -> int:
    """Identity of a tensor's storage (views of one buffer share it);
    0 for an empty storage."""
    st = t.untyped_storage()
    return st.data_ptr() if st.nbytes() else 0


def storage_freed(t: torch.Tensor) -> bool:
    """True when ``t`` has elements but its storage was freed (an
    eviction or a reclaim resized it to 0)."""
    return t.numel() > 0 and t.untyped_storage().nbytes() == 0


def free_storage(t: torch.Tensor) -> None:
    """Free a CUDA tensor's storage now (``resize_(0)``); the caching
    allocator keeps the block from other streams that ``record_stream``
    named until they pass it. A CPU tensor's memory goes with its last
    reference."""
    if t.is_cuda:
        t.untyped_storage().resize_(0)


def _host_copies(tensors: list) -> list:
    """Host copies of a table's tensors: the CUDA ones through
    ``column.download_tensors`` (pinned, so the copy runs at the link's
    DMA rate and a repage is an asynchronous copy); a CPU tensor is
    cloned, as the original is about to be dropped."""
    return [h.clone() if h is t and t is not None else h
            for t, h in zip(tensors, download_tensors(tensors))]


def _nbytes(a) -> int:
    if a is None:
        return 0
    if isinstance(a, np.ndarray):
        return int(a.nbytes)
    return int(a.numel() * a.element_size())


def _as_numpy(a):
    return a if a is None or isinstance(a, np.ndarray) else a.numpy()


# ---------------------------------------------------------------------------
# bookkeeping hooks the bridge calls (hot paths: one cached gate)
# ---------------------------------------------------------------------------


def note_put(tid: int, table) -> None:
    """Track a device-resident table (idempotent per id). Also the
    proactive pressure point: a put that carries the tracked device tier
    past ``hbm.budget_bytes()`` evicts the coldest entries first, which
    keeps a stream whose working set exceeds device memory running."""
    global _DEVICE_BYTES
    if not enabled() or _REG_LOCK is None:
        return
    tid = int(tid)
    nbytes = int(hbm.table_bytes(table))
    cols = getattr(table, "columns", None)
    device = cols[0].data.device if cols else None
    with _REG_LOCK:
        if tid not in _REG_TABLES:
            return  # freed while we sized it
        prev = _TRACK.get(tid)
        _TRACK[tid] = nbytes
        _DEVICE_BYTES += nbytes - (prev or 0)
        _LAST_TOUCH[tid] = next(_CLOCK)
        excess = _DEVICE_BYTES - hbm.budget_bytes(device)
    if excess > 0:
        request_headroom(excess, reason="put", exclude=(tid,))


def touch(tid: int) -> None:
    """LRU stamp on registry access (a stale stamp only makes LRU less
    exact, never wrong)."""
    if not enabled():
        return
    _LAST_TOUCH[int(tid)] = next(_CLOCK)


def note_free(tid: int, entry=None) -> int:
    """Drop all tracking of a freed, reclaimed or donated id; when the
    popped entry was a ``SpilledTable``, release its host or disk backing
    too. Returns the device bytes the entry would have taken (a spilled
    table's reclaim credit)."""
    global _DEVICE_BYTES, _HOST_BYTES, _DISK_BYTES
    if _REG_LOCK is None:
        return 0
    tid = int(tid)
    write = path = None
    nbytes = 0
    with _REG_LOCK:
        _LAST_TOUCH.pop(tid, None)
        _PINS.pop(tid, None)
        tracked = _TRACK.pop(tid, None)
        if tracked:
            _DEVICE_BYTES -= tracked
        if isinstance(entry, SpilledTable):
            nbytes = entry.nbytes
            if entry.state == HOST:
                _HOST_BYTES -= entry.host_nbytes
            else:
                _DISK_BYTES -= entry.host_nbytes
            entry.cols = None
            write, path = entry._write, entry.path
            entry._write = None
    if write is not None or path is not None:
        _drop_backing(write, path)
        _tier_gauges()
    return int(nbytes)


def _drop_backing(write, path) -> None:
    """Release a disk entry's file, waiting out an in-flight write first
    (so no file lands after the unlink)."""
    if write is not None:
        try:
            path = write.resolve()
        except Exception:  # the write failed: nothing on disk
            path = None
    if path:
        try:
            os.unlink(path)
        except OSError:
            pass
        _FILES.discard(path)


def pin_ids(ids) -> tuple:
    """Pin ids against eviction (the synchronous dispatch paths). Call
    under the registry lock or before an evictor can see the ids; returns
    the tuple for :func:`unpin_ids`."""
    if not enabled() or _REG_LOCK is None:
        return ()
    out = tuple(int(t) for t in ids)
    with _REG_LOCK:
        for t in out:
            _PINS[t] = _PINS.get(t, 0) + 1
    return out


def unpin_ids(ids) -> None:
    if _REG_LOCK is None:
        return
    with _REG_LOCK:
        for t in ids:
            n = _PINS.get(int(t), 0) - 1
            if n > 0:
                _PINS[int(t)] = n
            else:
                _PINS.pop(int(t), None)


def residency_of(entry) -> str:
    """Residency tier of one registry entry."""
    if isinstance(entry, SpilledTable):
        return entry.state
    return DEVICE


# ---------------------------------------------------------------------------
# eviction: device -> host (-> disk past the host budget)
# ---------------------------------------------------------------------------


def _buffer_counts_locked() -> dict:
    """Storage identity -> number of live registry tables holding it. A
    storage seen by more than one table is never freed under the other
    (an op output may alias its input): such tables are not eviction
    candidates this round."""
    counts: dict = {}
    for o in _REG_TABLES.values():
        if hasattr(o, "value_nowait"):  # a pipeline.Pending
            o = o.value_nowait()
            if o is None:
                continue
        if getattr(o, "columns", None) is None:
            continue
        for a in table_tensors(o):
            k = storage_key(a)
            if k:
                counts[k] = counts.get(k, 0) + 1
    return counts


def _evictable_locked(tid, entry, exclude, counts) -> bool:
    if tid in exclude or getattr(entry, "columns", None) is None:
        return False  # Pending or already spilled
    if _PINS.get(tid) or _REG_ACTIVE_READS.get(tid):
        return False  # the pin wins
    readers = _REG_READERS.get(tid)
    if readers and any(not p.done() for p in readers):
        return False
    if not entry.columns:
        return False
    for a in table_tensors(entry):
        if counts.get(storage_key(a), 0) > 1:
            return False  # aliased storage
        if storage_freed(a):
            return False  # already consumed
    return True


def _evict_one_locked(tid: int, table) -> int:
    """Spill one device table to the host tier; returns the device bytes
    freed. Runs under the registry lock: the copy-out stalls concurrent
    registry calls, but the swap (copy out, free, replace with the
    SpilledTable) must be atomic against a capture."""
    global _DEVICE_BYTES, _HOST_BYTES, _HOST_HW
    faults.inject("spill")
    with metrics.span("spill.evict"):
        nbytes = int(hbm.table_bytes(table))
        flat = []
        for c in table.columns:
            flat += [c.data, c.validity, c.lengths]
        host = _host_copies(flat)
        cols = []
        host_nbytes = 0
        for i, c in enumerate(table.columns):
            data, validity, lengths = host[3 * i:3 * i + 3]
            host_nbytes += _nbytes(data) + _nbytes(validity) + _nbytes(lengths)
            cols.append((int(c.dtype.id), int(c.dtype.scale), data, validity,
                         lengths))
        entry = SpilledTable(
            tid, nbytes, host_nbytes,
            None if table.names is None else list(table.names),
            int(table.logical_row_count), table.logical_rows, cols,
            table.columns[0].data.device,
        )
        for a in table_tensors(table):
            free_storage(a)
    _REG_TABLES[tid] = entry
    tracked = _TRACK.pop(tid, None)
    if tracked:
        _DEVICE_BYTES -= tracked
    _HOST_BYTES += host_nbytes
    _HOST_HW = max(_HOST_HW, _HOST_BYTES)
    metrics.counter_add("spill.evictions")
    metrics.bytes_add("spill.bytes_out", nbytes)
    log.log("INFO", "spill", "evict", table_id=tid, bytes=nbytes,
            host_bytes=_HOST_BYTES)
    _queue_event("out", tid, nbytes)
    return nbytes


def _npz_arrays(cols, names, logical_rows) -> dict:
    meta = {
        "type_ids": [c[0] for c in cols],
        "scales": [c[1] for c in cols],
        "names": names,
        "logical_rows": logical_rows,
    }
    arrays = {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
    for i, (_, _, data, validity, lengths) in enumerate(cols):
        arrays[f"d{i}"] = _as_numpy(data)
        if validity is not None:
            arrays[f"v{i}"] = _as_numpy(validity)
        if lengths is not None:
            arrays[f"l{i}"] = _as_numpy(lengths)
    return arrays


def _demote_one_locked(entry: SpilledTable) -> None:
    """Move one host entry's payload to disk: the buffers go into a write
    closure run on the pipeline's IO worker, so the file write overlaps
    whatever compute caused the pressure."""
    global _HOST_BYTES, _DISK_BYTES, _DISK_HW
    from .. import pipeline

    path = os.path.join(
        spill_dir(),
        f"srt-spill-{os.getpid()}-{entry.tid}-{next(_FILE_SEQ)}.npz",
    )
    cols, entry.cols = entry.cols, None
    names, logical_rows = entry.names, entry.logical_rows

    def write():
        with open(path, "wb") as f:
            np.savez(f, **_npz_arrays(cols, names, logical_rows))
        return path

    entry.state = DISK
    entry.path = path
    entry._write = pipeline.submit_io(write, "spill.write")
    _FILES.add(path)
    _HOST_BYTES -= entry.host_nbytes
    _DISK_BYTES += entry.host_nbytes
    _DISK_HW = max(_DISK_HW, _DISK_BYTES)
    metrics.counter_add("spill.demotions")
    metrics.bytes_add("spill.disk_bytes_out", entry.host_nbytes)
    log.log("INFO", "spill", "demote", table_id=entry.tid, path=path)


def _rebalance_host_locked() -> None:
    """Demote the coldest host entries until the host tier fits its
    budget (a 0 budget demotes everything)."""
    budget = host_budget_bytes()
    while _HOST_BYTES > budget:
        coldest = None
        for tid, o in _REG_TABLES.items():
            if isinstance(o, SpilledTable) and o.state == HOST:
                stamp = _LAST_TOUCH.get(tid, 0)
                if coldest is None or stamp < coldest[0]:
                    coldest = (stamp, o)
        if coldest is None:
            return
        _demote_one_locked(coldest[1])


def request_headroom(need_bytes: int, reason: str = "pressure",
                     exclude=()) -> int:
    """Evict the coldest unreferenced device tables until ``need_bytes``
    of device-tier bytes are freed (or no candidate is left). Returns the
    bytes freed."""
    if not enabled() or _REG_TABLES is None:
        return 0
    need = max(int(need_bytes), 1)
    freed = 0
    exclude = {int(t) for t in exclude}
    with _REG_LOCK:
        counts = _buffer_counts_locked()
        candidates = sorted(
            ((_LAST_TOUCH.get(tid, 0), tid, o)
             for tid, o in _REG_TABLES.items()
             if _evictable_locked(tid, o, exclude, counts)),
            key=lambda x: (x[0], x[1]),
        )
        for _, tid, table in candidates:
            if freed >= need:
                break
            try:
                freed += _evict_one_locked(tid, table)
            except faults.FaultError:
                metrics.counter_add("spill.errors")
                continue  # this victim failed: try the next
        if freed:
            _rebalance_host_locked()
        host, disk = _HOST_BYTES, _DISK_BYTES
    if freed:
        _tier_gauges(host, disk)
        log.log("INFO", "spill", "headroom", reason=reason,
                need=int(need_bytes), freed=freed)
    flush_events()
    return freed


# ---------------------------------------------------------------------------
# repage: host/disk -> device, on access
# ---------------------------------------------------------------------------


def _read_npz(path: str):
    """(cols, names, logical_rows) of a spill-format .npz."""
    lockcheck.note_blocking("spill_disk_read")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        cols = [
            (ti, sc, z[f"d{i}"],
             z[f"v{i}"] if f"v{i}" in z else None,
             z[f"l{i}"] if f"l{i}" in z else None)
            for i, (ti, sc) in enumerate(zip(meta["type_ids"],
                                             meta["scales"]))
        ]
    return cols, meta["names"], meta["logical_rows"]


def _load_cols(entry: SpilledTable) -> list:
    if entry.cols is not None:
        return entry.cols
    path = entry._write.resolve() if entry._write is not None else entry.path
    cols, entry.names, entry.logical_rows = _read_npz(path)
    return cols


def repage_locked(tid: int):
    """Rebuild the device Table of a spilled id and swap it back into the
    registry. Runs under the registry lock (every bridge access holds it
    at the lookup); the caller flushes residency events after releasing
    it. Retries under the fault plane: the backing is released only
    after a successful upload, so a transient failure is retryable."""
    global _DEVICE_BYTES, _HOST_BYTES, _DISK_BYTES
    entry = _REG_TABLES.get(int(tid))
    if not isinstance(entry, SpilledTable):
        return entry
    t0 = _time.perf_counter()

    def attempt():
        faults.inject("spill")
        return _upload(entry)

    with metrics.span("spill.repage"):
        table = faults.run_with_retry(attempt, "spill.in")
    _REG_TABLES[int(tid)] = table
    _TRACK[int(tid)] = entry.nbytes
    _DEVICE_BYTES += entry.nbytes
    if entry.state == HOST:
        _HOST_BYTES -= entry.host_nbytes
    else:
        _DISK_BYTES -= entry.host_nbytes
    entry.cols = None
    write, path = entry._write, entry.path
    entry._write = None
    _drop_backing(write, path)
    _LAST_TOUCH[int(tid)] = next(_CLOCK)
    dt_s = _time.perf_counter() - t0
    metrics.counter_add("spill.repages")
    metrics.bytes_add("spill.bytes_in", entry.nbytes)
    log.log("INFO", "spill", "repage", table_id=int(tid),
            bytes=entry.nbytes, tier=entry.state,
            stall_ms=round(dt_s * 1e3, 3))
    _queue_event("in", int(tid), entry.nbytes)
    _tier_gauges()
    return table


def _to_device(a, device: torch.device) -> torch.Tensor:
    """One host buffer (a CPU tensor, pinned or not, or a numpy array)
    uploaded to ``device`` on the current stream; from pinned memory the
    copy is asynchronous, and the caching host allocator holds the
    pinned block until it is done."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    if device.type != "cuda":
        return t  # the backing is released after the repage
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t, non_blocking=True)
    return out


def _upload_cols(cols, names, logical_rows, device):
    """Spill-format column tuples -> a Table on ``device``; shared by the
    repage and :func:`load_table_npz`."""
    from .. import dtype as dt
    from ..column import Column, Table

    device = torch.device(device)
    out = []
    for ti, sc, data, validity, lengths in cols:
        out.append(Column(
            _to_device(data, device), dt.DType(dt.TypeId(ti), sc),
            None if validity is None else _to_device(validity, device),
            None if lengths is None else _to_device(lengths, device)))
    return Table(out, names, logical_rows)


def _upload(entry: SpilledTable):
    cols = _load_cols(entry)  # sets entry.names/logical_rows from meta
    return _upload_cols(cols, entry.names, entry.logical_rows, entry.device)


# ---------------------------------------------------------------------------
# the disk tier's format as a save/load pair: meta + d{i}/v{i}/l{i}
# ---------------------------------------------------------------------------


def save_table_npz(path: str, table) -> int:
    """Write a Table's storage as a spill-format .npz at ``path`` (tmp +
    fsync + atomic rename, synchronous); returns the host bytes. The file
    is not registered for the exit sweep: the caller owns it."""
    flat = []
    for c in table.columns:
        flat += [c.data, c.validity, c.lengths]
    host = _host_copies(flat)
    cols = [(int(c.dtype.id), int(c.dtype.scale), *host[3 * i:3 * i + 3])
            for i, c in enumerate(table.columns)]
    nbytes = sum(_nbytes(a) for a in host)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_npz_arrays(
            cols, None if table.names is None else list(table.names),
            table.logical_rows))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return nbytes


def load_table_npz(path: str, device="cuda"):
    """Read a .npz written by :func:`save_table_npz` (or a demotion) back
    into a Table on ``device``."""
    cols, names, logical_rows = _read_npz(path)
    return _upload_cols(cols, names, logical_rows, device)


# ---------------------------------------------------------------------------
# stats / reset / exit sweep
# ---------------------------------------------------------------------------


def _tier_gauges(host: Optional[int] = None,
                 disk: Optional[int] = None) -> None:
    host = _HOST_BYTES if host is None else host
    disk = _DISK_BYTES if disk is None else disk
    metrics.gauge_set("spill.host_bytes", host)
    metrics.gauge_set("spill.disk_bytes", disk)
    metrics.gauge_set("spill.host_bytes_hw", _HOST_HW)
    metrics.gauge_set("spill.disk_bytes_hw", _DISK_HW)


def stats_doc() -> dict:
    """Per-tier bytes and high-water marks."""
    with _EVENTS_LOCK:
        pending_events = len(_EVENTS)
    return {
        "enabled": enabled(),
        "device_bytes": int(_DEVICE_BYTES),
        "host_bytes": int(_HOST_BYTES),
        "disk_bytes": int(_DISK_BYTES),
        "host_bytes_hw": int(_HOST_HW),
        "disk_bytes_hw": int(_DISK_HW),
        "files": len(_FILES),
        "pending_events": pending_events,
    }


def spill_file_count() -> int:
    """Disk-tier files on disk (0 after a clean teardown)."""
    return len(_FILES)


def reset() -> None:
    """Test hook: drop all tracking and remove every spill file."""
    global _DEVICE_BYTES, _HOST_BYTES, _DISK_BYTES, _HOST_HW, _DISK_HW
    if _REG_LOCK is not None:
        with _REG_LOCK:
            _LAST_TOUCH.clear()
            _TRACK.clear()
            _PINS.clear()
            _DEVICE_BYTES = _HOST_BYTES = _DISK_BYTES = 0
            _HOST_HW = _DISK_HW = 0
    with _EVENTS_LOCK:
        _EVENTS.clear()
    for path in list(_FILES):
        try:
            os.unlink(path)
        except OSError:
            pass
        _FILES.discard(path)


def _sweep_at_exit() -> None:  # pragma: no cover - atexit path
    """No orphaned spill files: remove what this process wrote, and the
    per-process default directory when it is left empty."""
    for path in list(_FILES):
        try:
            os.unlink(path)
        except OSError:
            pass
        _FILES.discard(path)
    try:
        os.rmdir(os.path.join(tempfile.gettempdir(),
                              f"srt-spill-{os.getpid()}"))
    except OSError:
        pass


atexit.register(_sweep_at_exit)


def _on_hbm_pressure(deficit: int) -> None:
    """hbm plan listener: a shape that does not fit the budget frees the
    deficit before the launch instead of reacting to the out-of-memory
    error."""
    if enabled():
        request_headroom(deficit, reason="hbm_plan")


hbm.register_pressure_listener(_on_hbm_pressure)
