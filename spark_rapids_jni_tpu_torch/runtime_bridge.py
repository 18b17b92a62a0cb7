"""Wire-level entry points of the port (port of ``runtime_bridge.py``).

The same names, signatures and wire format as the JAX package, so a C
shim can call either package: parallel (type id, scale) int arrays,
little-endian fixed-width data buffers (FLOAT64 as IEEE-754 doubles,
BOOL8 as one 0/1 byte), per-column 0/1 validity byte vectors, and STRING
and LIST columns as int32 offsets[n+1] followed by the payload (UTF-8
bytes; LIST: the child values, with the child type id in the scale
slot).

``table_op_wire`` and ``table_plan_wire`` take one wire table and give
back the wire 5-tuple: bytes in, bytes out; ``table_stream_wire`` runs
one plan over a list of wire tables, pipelined (``pipeline.run_stream``:
batch N+1's decode and batch N-1's encode beside batch N's plan).
Otherwise tables stay resident on the device between calls:
``table_upload_wire`` returns an id, ``table_plan_resident`` and
``table_op_resident`` run a plan or one op over ids and return a new id
(enqueued and returned at once when ``PIPELINE`` is on),
``table_download_wire`` serializes one, ``table_free`` drops it,
``table_reclaim`` also frees its device memory now. Every entry that
runs ops checks them first (``plancheck.check_plan``), before any upload
or donation. Every op of ``DISPATCH_OPS`` runs.

The execution services of the JAX package run under these entries: the
``dispatch`` and ``serde`` fault sites with transient retry
(``utils/faults.py``), the pipelined plane (``pipeline.py``), and the
spill tier (``utils/spill.py``: a resident id may be a
``SpilledTable``, repaged on access). On CUDA a wire table is staged in
pinned host memory and copied asynchronously, and a result comes back
through pinned buffers with one event synchronised
(``column.upload``/``column.download``).

The shape-bucket plane (``utils/buckets.py``, ``SPARK_RAPIDS_TPU_BUCKETS``)
runs under these entries as it does in the JAX package: a wire upload
whose first op can take a bucketed runner (``bucketed.is_bucketable``;
for a plan, its first segment, ``plan.segment_plan``), and every
resident upload, is padded to its row-count bucket on the host, in the
pinned staging buffer, and carries its real count as
``Table.logical_rows``; every op goes to the kernel tier, then to the
bucketed runner, then to the exact path on unpadded inputs; results
stay padded on the device, and the wire encode slices the padding away.
Row counters count logical rows.

The observability tier runs under them as in the JAX package: the plan
entries open a profile session under ``PROFILE`` (``utils/profiler.py``,
with the plan check's report as its prediction), the wire decode and
encode note their serde time and bytes to it and record ``wire.in`` /
``wire.out`` flight instants, every registry change records a
``resident.live`` counter sample, and a resident table's allocation site
(the open span stack, the profile session) is kept under
``REFCOUNT_DEBUG`` or any telemetry plane, for :func:`leak_report` (the
``resident_leaks`` flight-dump section, and a WARN at exit).

Where the JAX entries raise on an input Spark can send (a join with a
0-row side, a ``concat`` of unnamed tables), the port returns Spark's
result.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import sys
import time as _time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import dtype as dt
from . import pipeline
from .column import (
    Column, Table, download, host_storage_view, host_to_storage,
    resolve_device, table_tensors, upload,
)
from .utils import (
    buckets, config, faults, flight, hbm, lockcheck, log, metrics, profiler,
    spill,
)


class UnsupportedOpError(NotImplementedError):
    """A dispatch op of the JAX package that the port does not run yet."""


def _wire_np(d: dt.DType) -> np.dtype:
    """Host wire numpy dtype of a fixed-width column."""
    if not d.is_fixed_width:
        raise TypeError(f"wire format: fixed-width types only, got {d}")
    if d.id == dt.TypeId.FLOAT64:
        return np.dtype(np.float64)
    return d.host_dtype


def _padded_from_offsets(data: bytes, num_rows: int, child_np: np.dtype,
                         label: str):
    """Arrow offsets+payload wire buffer -> ((n, pad) matrix, lengths).
    Offsets are untrusted input and are validated first."""
    if len(data) < 4 * (num_rows + 1):
        raise ValueError(
            f"{label} wire buffer holds {len(data)} bytes, "
            f"{4 * (num_rows + 1)} needed for {num_rows + 1} offsets"
        )
    offs = np.frombuffer(data, np.int32, num_rows + 1)
    lens = np.diff(offs).astype(np.int32)
    if int(offs[0]) != 0 or (num_rows and bool((lens < 0).any())):
        raise ValueError(
            f"{label} wire offsets corrupt: must start at 0 and be "
            f"non-decreasing (first={int(offs[0])}, "
            f"min diff={int(lens.min()) if num_rows else 0})"
        )
    need = 4 * (num_rows + 1) + child_np.itemsize * int(offs[-1])
    if len(data) < need:
        raise ValueError(
            f"{label} wire buffer holds {len(data)} bytes, offsets "
            f"require {need}"
        )
    flat = np.frombuffer(data, child_np, count=int(offs[-1]),
                         offset=4 * (num_rows + 1))
    pad = max(int(lens.max()) if num_rows else 1, 1)
    if num_rows and int(offs[-1]) == num_rows * pad:
        return flat.reshape(num_rows, pad), lens  # constant width
    mat = np.zeros((num_rows, pad), child_np)
    mat[np.arange(pad)[None, :] < lens[:, None]] = flat
    return mat, lens


def _padded_to_offsets(mat: np.ndarray, lens: np.ndarray) -> bytes:
    """(n, pad) matrix + lengths -> offsets+payload wire bytes."""
    offs = np.zeros((lens.shape[0] + 1,), np.int32)
    np.cumsum(lens, out=offs[1:])
    if lens.shape[0] and int(offs[-1]) == lens.shape[0] * mat.shape[1]:
        return offs.tobytes() + mat.tobytes()
    mask = np.arange(mat.shape[1])[None, :] < lens[:, None]
    return offs.tobytes() + mat[mask].tobytes()


def _wire_validity(valid: Optional[bytes], num_rows: int):
    if valid is None:
        return None
    return np.frombuffer(valid, np.uint8, num_rows).astype(np.bool_)


def _column_from_wire(type_id: int, scale: int, data: Optional[bytes],
                      valid: Optional[bytes], num_rows: int,
                      device: torch.device,
                      pad_to: Optional[int] = None) -> Column:
    """Decode one wire column onto ``device``, every buffer zero-padded
    to ``pad_to`` rows in its staging copy when that is given."""
    v = _wire_validity(valid, num_rows)
    vt = None if v is None else upload(v, device, pad_to)
    tid = dt.TypeId(type_id)
    if tid in (dt.TypeId.LIST, dt.TypeId.STRING):
        child = (dt.UINT8 if tid == dt.TypeId.STRING
                 else dt.DType(dt.TypeId(scale)))
        mat, lens = _padded_from_offsets(data, num_rows, child.host_dtype,
                                         tid.name)
        return Column(upload(mat, device, pad_to), dt.DType(tid), vt,
                      upload(lens, device, pad_to))
    d = dt.DType(tid, scale)
    if d.id == dt.TypeId.DECIMAL128:
        arr = np.frombuffer(data, np.uint64, 2 * num_rows).reshape(num_rows, 2)
    else:
        arr = np.frombuffer(data, _wire_np(d), num_rows)
    return Column(host_to_storage(arr, d, device, pad_to), d, vt)


def _column_to_wire(c: Column, data: np.ndarray, valid, lens):
    """(type_id, scale, data bytes, valid bytes | None) of a column whose
    storage was copied to the host (``data``, ``valid``, ``lens``)."""
    vb = None if valid is None else valid.astype(np.uint8).tobytes()
    if c.dtype.id in (dt.TypeId.LIST, dt.TypeId.STRING):
        scale = 0 if c.dtype.is_string else int(c.list_child_dtype.id)
        return (int(c.dtype.id), scale,
                _padded_to_offsets(data, lens.astype(np.int32)), vb)
    return (int(c.dtype.id), int(c.dtype.scale),
            host_storage_view(data, c.dtype).tobytes(), vb)


def _table_from_wire(type_ids, scales, datas, valids, num_rows: int,
                     device: torch.device,
                     pad_to: Optional[int] = None) -> Table:
    """One wire decode: host decode per column, then the upload, padded
    to the bucket ``pad_to`` when that is given (the table then carries
    ``logical_rows``). A decode is pure (the caller's bytes are never
    consumed), so the ``serde`` fault site retries transient failures
    here freely."""

    def attempt():
        faults.inject("serde")
        prof = profiler.session_active()
        nbytes = (sum(len(d) for d in datas if d is not None)
                  if (prof or flight.enabled()) else 0)
        if flight.enabled():
            flight.record("I", "wire.in", nbytes)
        t0 = _time.perf_counter() if prof else 0.0
        with metrics.span("wire.deserialize"):
            tbl = Table([
                _column_from_wire(t, s, d, v, num_rows, device, pad_to)
                for t, s, d, v in zip(type_ids, scales, datas, valids)
            ], logical_rows=None if pad_to is None else num_rows)
        if prof:
            profiler.note_serde("in", _time.perf_counter() - t0, nbytes)
        if pad_to is not None:
            buckets.note_padded(tbl)
        return tbl

    return faults.run_with_retry(attempt, "wire.in")


def _table_to_wire(t: Table):
    """The 5-tuple every wire entry returns. Every tensor of the table
    crosses to the host in one pass (``column.download``: pinned buffers,
    one event), the padding of a bucketed table left behind: only the
    logical rows of each buffer (a view, no device work) are copied.
    Pure reads, so the ``serde`` fault site retries here too."""
    rows = t.logical_rows

    def cut(x):
        return x if x is None or rows is None else x[:rows]

    def attempt():
        faults.inject("serde")
        prof = profiler.session_active()
        t0 = _time.perf_counter() if prof else 0.0
        with metrics.span("wire.serialize"):
            flat = []
            for c in t.columns:
                flat += [cut(c.data), cut(c.validity), cut(c.lengths)]
            host = download(flat)
            out_t, out_s, out_d, out_v = [], [], [], []
            for i, c in enumerate(t.columns):
                ti, s, d, v = _column_to_wire(c, *host[3 * i:3 * i + 3])
                out_t.append(ti)
                out_s.append(s)
                out_d.append(d)
                out_v.append(v)
        if prof or flight.enabled():
            nbytes = sum(len(d) for d in out_d if d is not None)
            if flight.enabled():
                flight.record("I", "wire.out", nbytes)
            if prof:
                profiler.note_serde("out", _time.perf_counter() - t0,
                                    nbytes)
        return out_t, out_s, out_d, out_v, int(t.logical_row_count)

    return faults.run_with_retry(attempt, "wire.out")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

#: Every op key of the JAX package's dispatch chain.
DISPATCH_OPS = frozenset({
    "join", "concat", "groupby", "sort_by", "filter", "distinct", "cast",
    "explode", "rlike", "cross_join", "slice", "repeat", "sample",
    "partition", "to_rows", "from_rows",
})
#: The ops the port runs: all of them.
PORTED_OPS = DISPATCH_OPS
#: The join of each ``how``.
_JOINS = {"inner": "inner_join", "left": "left_join", "right": "right_join",
          "full": "full_join", "semi": "semi_join", "anti": "anti_join"}
#: Ops whose only route is a kernel: the row transpose has no second
#: implementation, so it runs K1a/K1b whatever the tier's gate, and a
#: decline means an input not ported yet.
_KERNEL_ONLY = {"to_rows": "row_pack", "from_rows": "row_unpack"}


def _dispatch(op: dict, table: Table, rest: Sequence[Table] = ()) -> Table:
    """Run one op as a fault boundary: the ``dispatch`` injection site is
    armed here, transient-classified failures retry with backoff (safe:
    nothing on this path consumes its inputs) and permanent-classified
    errors surface unchanged (``faults.run_with_retry``)."""
    name = op["op"]

    def attempt():
        faults.inject("dispatch")
        return _dispatch_once(op, table, rest, name)

    return faults.run_with_retry(attempt, "dispatch." + name)


def _dispatch_once(op: dict, table: Table, rest: Sequence[Table],
                   name: str) -> Table:
    """Run one op: the kernel tier first, then (with bucketing on) the
    bucketed runner, then the exact path on unpadded inputs; ``join``
    takes the probe side as ``table`` and the build side as ``rest[0]``.
    The op's row counters count logical rows."""
    from .kernels import registry as kernel_registry

    # a tracked lock held across a device launch serializes every other
    # dispatcher behind the card: the lockcheck shim reports it
    lockcheck.note_blocking("device_dispatch")
    with metrics.span("dispatch." + name):
        out = kernel_registry.dispatch_kernel(op, table, rest, name)
        if out is None and buckets.enabled():
            from . import bucketed

            out = bucketed.dispatch_bucketed(op, table, rest, name)
        if out is None:
            out = _dispatch_impl(op, buckets.unpad_table(table),
                                 [buckets.unpad_table(t) for t in rest],
                                 name)
    if metrics.enabled():
        rows_in = table.logical_row_count + sum(
            t.logical_row_count for t in rest)
        metrics.counter_add("op." + name + ".calls")
        metrics.counter_add("op." + name + ".rows_in", rows_in)
        metrics.counter_add("op." + name + ".rows_out", out.logical_row_count)
        metrics.hist_observe("dispatch.rows_in", rows_in)
    return out


def _dispatch_impl(op: dict, table: Table, rest: Sequence[Table],
                   name: str) -> Table:
    from . import ops
    from .kernels import registry as kernel_registry

    if name not in DISPATCH_OPS:
        raise ValueError(f"unknown table op {name!r}")
    if name == "from_rows" and table.columns[0].dtype.id != dt.TypeId.LIST:
        return _from_flat_rows(op, table)
    if name in _KERNEL_ONLY:
        kernel = _KERNEL_ONLY[name]
        reason = kernel_registry.decline_reason(kernel, op, table, rest)
        if reason is not None:
            raise UnsupportedOpError(f"{name}: {reason} (not ported yet)")
        return kernel_registry.run_kernel(kernel, op, table, rest)
    if name == "cast":
        from .ops.cast import cast

        target = dt.DType(dt.TypeId(op["type_id"]), op.get("scale", 0))
        out = list(table.columns)
        out[op["column"]] = cast(table.columns[op["column"]], target)
        return Table(out, table.names)
    if name == "explode":
        return ops.explode(table, op["column"])
    if name == "rlike":
        # the rows whose string column matches: Spark's WHERE col RLIKE p
        return ops.filter_table(
            table, ops.contains_re(table.columns[op["column"]], op["pattern"]))
    if name == "join":
        how = op.get("how", "inner")
        if how not in _JOINS:
            raise ValueError(f"unknown join how={how!r}")
        if not rest:
            raise ValueError("join needs two input tables")
        return getattr(ops, _JOINS[how])(table, rest[0], op["on"])
    if name == "concat":
        return ops.concatenate([table, *rest])
    if name == "groupby":
        aggs = [ops.GroupbyAgg(a["column"], a["agg"]) for a in op["aggs"]]
        return ops.groupby_aggregate(table, op["by"], aggs)
    if name == "distinct":
        return ops.distinct(table, op.get("keys"))
    if name == "cross_join":
        if not rest:
            raise ValueError("cross_join needs two input tables")
        return ops.cross_join(table, rest[0])
    if name == "slice":
        n = table.row_count
        start, stop = int(op.get("start", 0)), int(op.get("stop", n))
        if start < 0 or stop < 0:
            raise ValueError(
                f"slice: negative bounds not supported (start={start}, "
                f"stop={stop})")
        start = min(start, n)
        return ops.slice_rows(table, start, max(start, min(stop, n)))
    if name == "repeat":
        return ops.repeat(table, int(op["count"]))
    if name == "sample":
        return ops.sample(table, int(op["n"]), seed=int(op.get("seed", 0)),
                          replacement=bool(op.get("replacement", False)))
    if name == "sort_by":
        keys = [ops.SortKey(k["column"], ascending=k.get("ascending", True))
                for k in op["keys"]]
        return ops.sort_table(table, keys)
    if name == "partition":
        return _partition(op, table)
    # filter
    mask_idx = op["mask"]
    mask = table.columns[mask_idx]
    keep = [c for i, c in enumerate(table.columns) if i != mask_idx]
    return ops.filter_table(Table(keep), mask)


def _from_flat_rows(op: dict, table: Table) -> Table:
    """``from_rows`` of a legacy flat UINT8 buffer: one column of
    ``num_rows * row_size`` bytes, unpacked by K1b like a row column."""
    from . import rows as rows_mod

    schema = [dt.DType(dt.TypeId(t), s)
              for t, s in zip(op["type_ids"], op["scales"])]
    layout = rows_mod.compute_fixed_width_layout(schema)
    n = int(op["num_rows"])
    raw = table.columns[0].data
    if raw.numel() != n * layout.row_size:
        raise ValueError(
            f"flat row buffer of {raw.numel()} bytes is not {n} rows of "
            f"{layout.row_size} bytes")
    return rows_mod.from_rows(
        rows_mod.PackedRows(raw.reshape(n, layout.row_size).contiguous(),
                            layout), schema)


def _partition(op: dict, table: Table) -> Table:
    """Spark's ShuffleExchangeExec partitioning step as a table op: rows
    reordered partition-contiguously by Pmod(Murmur3, num) (hash) or by
    sampled key-range splitters (range); the counts are dropped."""
    from .ops import partition as partition_mod

    kind = op.get("kind", "hash")
    num = int(op["num"])
    if num < 1:
        raise ValueError(f"partition: num must be >= 1, got {num}")
    keys = list(op.get("keys", []))
    if kind == "hash":
        out, _ = partition_mod.hash_partition(table, keys or None, num)
    elif kind == "range":
        if not keys:
            raise ValueError("partition: range kind needs keys")
        out, _ = partition_mod.range_partition(table, keys, num)
    else:
        raise ValueError(f"unknown partition kind {kind!r}")
    return out


# ---------------------------------------------------------------------------
# device-resident table handles
#
# An id maps to a Table, a ``pipeline.Pending`` still computing one, or a
# ``spill.SpilledTable`` (its host or disk backing). One RLock orders
# every registry access, the pipelined readers' barrier, the spill tier's
# evictions and the reclaims.
# ---------------------------------------------------------------------------

_RESIDENT: dict = {}
# table id -> allocation provenance (span stack, rows, profile session,
# age anchor): what the leak report prints for every handle still live.
# Kept only while REFCOUNT_DEBUG or a telemetry plane is on.
_RESIDENT_META: dict = {}
_RESIDENT_LOCK = lockcheck.make_rlock("registry.resident")
_NEXT_TABLE_ID = itertools.count(1)
# id -> in-flight pipelined ops reading that id (pruned as they settle):
# a donate-consume or a reclaim of an id settles these first
_RESIDENT_READERS: dict = {}
# id -> count of table_download_wire serializers reading that id: a
# reclaim frees storage and waits for them; eviction skips the id
_RESIDENT_ACTIVE_READS: dict = {}
_RESIDENT_READS_CV = lockcheck.make_condition(_RESIDENT_LOCK)


def _provenance_on() -> bool:
    return (metrics.enabled() or flight.enabled()
            or bool(config.get_flag("REFCOUNT_DEBUG")))


def _note_live(live: int) -> None:
    metrics.gauge_set("resident.live", live)
    if flight.enabled():
        flight.record("C", "resident.live", live)


def _unknown_id_error(table_id, live: int) -> KeyError:
    return KeyError(
        f"unknown or already-freed device table id {int(table_id)} "
        f"({live} table(s) live)"
    )


def _device_of(t: Table) -> Optional[torch.device]:
    return t.columns[0].data.device if t.columns else None


def _resident_peek(table_id: int):
    """Registry entry of ``table_id`` without resolving a pending: a
    Table or a ``pipeline.Pending`` still computing. A spilled entry is
    repaged here: access promotes a cold table. Raises the labeled
    KeyError on a miss."""
    with _RESIDENT_LOCK:
        t = _RESIDENT.get(int(table_id))
        live = len(_RESIDENT)
        if isinstance(t, spill.SpilledTable):
            t = spill.repage_locked(int(table_id))
    if t is None:
        raise _unknown_id_error(table_id, live)
    spill.flush_events()
    spill.touch(int(table_id))
    return t


def _resident_get(table_id: int) -> Table:
    """The settled Table of ``table_id``: a blocking point of the
    pipelined plane. A pending entry is waited for here, and a worker
    error is replayed synchronously so the op's own exception surfaces
    (``pipeline.Pending.resolve``)."""
    t = _resident_peek(table_id)
    if isinstance(t, pipeline.Pending):
        t = t.resolve()
        with _RESIDENT_LOCK:
            # swap the settled Table in, unless the id was freed meanwhile
            if int(table_id) in _RESIDENT:
                _RESIDENT[int(table_id)] = t
        spill.note_put(int(table_id), t)
    metrics.counter_add("resident.get")
    return t


def _resident_put(t) -> int:
    """Register a Table (or a ``pipeline.Pending`` computing one) and
    return its id; a pending entry counts as live. Under
    ``REFCOUNT_DEBUG`` or a telemetry plane its allocation site (the
    open span stack, the profile session) is kept for the leak
    report."""
    tid = next(_NEXT_TABLE_ID)
    is_pending = isinstance(t, pipeline.Pending)
    meta = None
    if _provenance_on():
        meta = {
            "rows": None if is_pending else int(t.logical_row_count),
            "columns": None if is_pending else len(t.columns),
            "allocated_under": list(metrics.span_stack()),
            "age_anchor_ns": _time.perf_counter_ns(),
        }
        if is_pending:
            meta["pending"] = t.label
        sid = profiler.current_session_id()
        if sid is not None:
            meta["session"] = sid
    with _RESIDENT_LOCK:
        _RESIDENT[tid] = t
        if meta is not None:
            _RESIDENT_META[tid] = meta
        live = len(_RESIDENT)
    log.log("DEBUG", "handles", "resident_put", table_id=tid, live=live)
    metrics.counter_add("resident.put")
    _note_live(live)
    if not is_pending:
        # spill tracking, and the proactive pressure point
        spill.note_put(tid, t)
    return tid


def _live_storages(exclude: Sequence = ()) -> set:
    """Storage identities of every live registry table but ``exclude``:
    what a donation or a reclaim must not free."""
    with _RESIDENT_LOCK:
        others = [o for k, o in _RESIDENT.items() if k not in exclude]
    keys = set()
    for o in others:
        if isinstance(o, pipeline.Pending):
            o = o.value_nowait()
        if o is None or isinstance(o, spill.SpilledTable):
            continue
        keys.update(spill.storage_key(a) for a in table_tensors(o))
    return keys


def table_upload_wire(
    type_ids: Sequence[int],
    scales: Sequence[int],
    datas: Sequence[Optional[bytes]],
    valids: Sequence[Optional[bytes]],
    num_rows: int,
    device: Union[str, torch.device] = "cuda",
) -> int:
    """Host bytes -> device-resident table; returns its id. With
    bucketing on, the resident buffers are padded to the row-count
    bucket on the host, before the upload, and the table carries its
    logical row count: a chain of bucketed ops then runs at one length a
    bucket without padding again."""
    dev = resolve_device(device)
    pad_to = buckets.bucket_for(int(num_rows)) if buckets.enabled() else None
    return _resident_put(
        _table_from_wire(type_ids, scales, datas, valids, int(num_rows), dev,
                         pad_to)
    )


def _capture_inputs(table_ids: Sequence[int], donate: bool, reader=None,
                    pin: bool = False) -> tuple:
    """Atomically snapshot the input entries at call time (Tables or
    Pendings) -> ``(inputs, donate_barrier)``.

    The capture makes the async chain safe: a caller may ``table_free``
    an input right after enqueueing the op that reads it, and the op
    holds its own reference. Unknown ids raise the labeled KeyError
    before the donated input is consumed. One lock hold covers the
    validation, the donate-consume, the barrier snapshot and registering
    ``reader`` (the op's own Pending) against the ids it captured, so a
    concurrent donate-consume either sees this reader in its barrier or
    ordered itself first. Spilled inputs repage inside the same hold.
    ``pin=True`` pins the surviving ids against eviction (the synchronous
    paths, where no reader Pending exists); the caller unpins them."""
    ids = [int(t) for t in table_ids]
    with _RESIDENT_LOCK:
        live = len(_RESIDENT)
        for t in ids:
            if t not in _RESIDENT:
                raise _unknown_id_error(t, live)
        objs = []
        for t in ids:
            o = _RESIDENT[t]
            if isinstance(o, spill.SpilledTable):
                o = spill.repage_locked(t)
            objs.append(o)
        barrier = []
        if donate:
            _RESIDENT.pop(ids[0])
            _RESIDENT_META.pop(ids[0], None)
            spill.note_free(ids[0])
            barrier = [p for p in _RESIDENT_READERS.pop(ids[0], ())
                       if not p.done()]
            live = len(_RESIDENT)
        kept = ids[1:] if donate else ids
        if reader is not None:
            for t in kept:
                lst = _RESIDENT_READERS.setdefault(t, [])
                lst[:] = [p for p in lst if not p.done()]
                lst.append(reader)
        if pin:
            spill.pin_ids(kept)
        for t in kept:
            spill.touch(t)
    spill.flush_events()
    metrics.counter_add("resident.get", len(ids))
    if donate:
        log.log("DEBUG", "handles", "resident_take", table_id=ids[0],
                live=live)
        metrics.counter_add("resident.free")
        _note_live(live)
    return objs, barrier


def _static_check(ops, table_ids: Sequence[int]) -> tuple:
    """The plan check of a resident entry, before any capture, pin,
    donation or enqueue -> ``(report, head schema)``. Schemas come from
    the registry by a peek: an input still computing degrades the walk
    to its structural rules instead of blocking."""
    from . import plancheck

    def settled(tid):
        t = _resident_peek(int(tid))
        return None if isinstance(t, pipeline.Pending) else t

    head = settled(table_ids[0])
    rest = []
    for tid in table_ids[1:]:
        t = settled(tid)
        rest.append((plancheck.schema_of_table(t), t.logical_row_count)
                    if t is not None else (None, None))
    schema = None if head is None else plancheck.schema_of_table(head)
    report = plancheck.check_plan(
        ops, schema=schema,
        rows=None if head is None else head.logical_row_count,
        rest=rest, names=None if head is None else head.names)
    return report, schema


def _on_device(tables):
    """Set the device of the first CUDA table on this thread (a pipeline
    worker runs on the device of the tables it touches)."""
    for t in tables:
        dev = _device_of(t)
        if dev is not None and dev.type == "cuda":
            return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _run_resident(ops, inputs, donate: bool, barrier):
    """The shared (synchronous or worker-side) body of the resident
    entries: resolve pending inputs, settle the readers of a donated
    input, run the plan (``plan.run_plan``; one op is a plan of one). A
    donated input's storage that a live table shares is never freed."""
    from . import plan as plan_mod

    tables = pipeline.materialize_inputs(inputs)
    for p in barrier:
        p.settle_terminally()
    with _on_device(tables):
        protected = _live_storages() if donate else None
        return plan_mod.run_plan(
            ops, tables[0], tables[1:], donate_input=donate,
            protected=protected)


def _resident_entry(ops, table_ids: Sequence[int], donate: bool,
                    label: str) -> int:
    """Check, capture and run ``ops`` over resident tables; enqueued on
    the pipeline (the id returns at once) when it is on. Donated work is
    at-most-once once its own run starts (its input may be consumed),
    so a worker failure of it surfaces as-is; an input's failure stays
    replayable (``pipeline.DependencyFailed``). A plan's profile session
    (``plan_resident``) opens inside the work, so it scopes the run
    itself, on a pipeline worker when enqueued."""
    report, head_schema = _static_check(ops, table_ids)
    cell: dict = {}

    def work():
        if label != "plan":
            return _run_resident(ops, cell["inputs"], donate,
                                 cell["barrier"])
        with profiler.maybe_session(ops, label="plan_resident",
                                    schema=head_schema, static=report):
            return _run_resident(ops, cell["inputs"], donate,
                                 cell["barrier"])

    if pipeline.enabled():
        pending = pipeline.Pending(work, label, replayable=not donate)
        cell["inputs"], cell["barrier"] = _capture_inputs(
            table_ids, donate, reader=pending)
        return _resident_put(pipeline.enqueue(pending))
    cell["inputs"], cell["barrier"] = _capture_inputs(table_ids, donate,
                                                      pin=True)
    try:
        return _resident_put(work())
    finally:
        spill.unpin_ids(table_ids[1:] if donate else table_ids)


def table_plan_resident(
    plan_json: str, table_ids: Sequence[int], donate: bool = False
) -> int:
    """Run a plan (a JSON list of ops) over resident tables; the result
    stays resident. ``table_ids[0]`` is the chain input, the other ids
    feed multi-table ops (see ``plan._take_rest``). The plan is checked
    first (``plancheck.check_plan`` on the tables' schemas);
    ``donate=True`` then consumes ``table_ids[0]`` (freed at once; the
    plan may release its device memory after its first op), so a
    rejected plan leaves it live. With ``PIPELINE`` on this enqueues and
    returns the id; ``table_download_wire``/``table_num_rows`` are the
    blocking points."""
    if not table_ids:
        raise ValueError("table_plan_resident needs at least one input")
    ops = json.loads(plan_json)
    if not isinstance(ops, list):
        raise TypeError("table_plan_resident: plan must be a JSON list of ops")
    return _resident_entry(ops, table_ids, donate, "plan")


def table_op_resident(
    op_json: str, table_ids: Sequence[int], donate: bool = False
) -> int:
    """One op over resident tables; the result stays resident.
    ``table_ids[0]`` is the op's input, the others its extra tables (a
    join's build side, a concat's tail). The op is checked first
    (``plancheck.check_plan``); ``donate=True`` then consumes
    ``table_ids[0]``, so a rejected op leaves it live. Pipelined as
    :func:`table_plan_resident`."""
    if not table_ids:
        raise ValueError("table_op_resident needs at least one input")
    op = json.loads(op_json)
    name = str(op.get("op", "?")) if isinstance(op, dict) else "?"
    return _resident_entry([op], table_ids, donate, "op." + name)


def _check_wire_plan(ops, type_ids, scales, num_rows: int) -> tuple:
    """The plan check on a wire schema -> ``(report, schema)``."""
    from . import plancheck

    schema = plancheck.schema_from_wire(type_ids, scales)
    return plancheck.check_plan(ops, schema=schema,
                                rows=int(num_rows)), schema


def table_op_wire(
    op_json: str,
    type_ids: Sequence[int],
    scales: Sequence[int],
    datas: Sequence[Optional[bytes]],
    valids: Sequence[Optional[bytes]],
    num_rows: int,
    device: Union[str, torch.device] = "cuda",
):
    """One op over one wire table: bytes in, the wire 5-tuple out. The op
    is checked on the wire schema before the upload."""
    op = json.loads(op_json)
    _check_wire_plan([op], type_ids, scales, num_rows)
    pad_to = None
    if buckets.enabled():
        from . import bucketed

        # pad only an upload whose op can take the bucketed path: any
        # other op would unpad it at once
        if bucketed.is_bucketable(op):
            pad_to = buckets.bucket_for(int(num_rows))
    tbl = _table_from_wire(type_ids, scales, datas, valids, int(num_rows),
                           resolve_device(device), pad_to)
    return _table_to_wire(_dispatch(op, tbl))


def _plan_pad_to(ops, num_rows: int) -> Optional[int]:
    """The bucket a plan's wire upload is padded to: only when the JAX
    package's first segment reads the padding (a fused segment, or a
    one-op segment with a bucketed runner); a malformed plan falls
    through to ``plan.run_plan``'s own errors."""
    from . import bucketed
    from . import plan as plan_mod

    if not (buckets.enabled() and ops and isinstance(ops[0], dict)):
        return None
    segs = plan_mod.segment_plan(ops)
    if segs and (segs[0][0] == "fused"
                 or bucketed.is_bucketable(segs[0][1][0])):
        return buckets.bucket_for(int(num_rows))
    return None


def table_plan_wire(
    plan_json: str,
    type_ids: Sequence[int],
    scales: Sequence[int],
    datas: Sequence[Optional[bytes]],
    valids: Sequence[Optional[bytes]],
    num_rows: int,
    device: Union[str, torch.device] = "cuda",
):
    """A plan (a JSON list of ops) over one wire table: the plan is
    checked on the wire schema before the upload, runs over the uploaded
    table (``plan.run_plan``, which consumes it: nothing else holds a
    wire table) and comes back as the wire 5-tuple. A plan has one input
    table, so a ``join`` in it is refused. Under ``PROFILE`` a
    ``plan_wire`` profile session scopes the decode, the plan and the
    encode."""
    from . import plan as plan_mod

    ops = json.loads(plan_json)
    if not isinstance(ops, list):
        raise TypeError("table_plan_wire: plan must be a JSON list of ops")
    report, schema = _check_wire_plan(ops, type_ids, scales, num_rows)
    pad_to = _plan_pad_to(ops, num_rows)
    dev = resolve_device(device)
    with profiler.maybe_session(ops, label="plan_wire", schema=schema,
                                bucket=pad_to, static=report):
        tbl = _table_from_wire(type_ids, scales, datas, valids,
                               int(num_rows), dev, pad_to)
        return _table_to_wire(plan_mod.run_plan(ops, tbl,
                                                donate_input=True))


def table_stream_wire(plan_json: str, batches: Sequence,
                      device: Union[str, torch.device] = "cuda") -> list:
    """One plan over a stream of wire tables, from one call.

    ``batches`` is a sequence of ``(type_ids, scales, datas, valids,
    num_rows)`` wire tuples; each runs ``plan_json`` and the list that
    comes back holds one ``table_plan_wire`` 5-tuple a batch, in input
    order. The plan is checked on every batch's schema before any batch
    decodes. With ``PIPELINE`` on, batch N+1's decode and batch N-1's
    encode run on pool workers while batch N's plan runs on this thread
    (``pipeline.run_stream``); on CUDA each worker stage runs on its own
    stream, tied to the plan's stream by events (``pipeline.device_lane``,
    ``mark``, ``hand_over``). With the pipeline off this is a loop of
    ``table_plan_wire``: the same bytes and errors either way."""
    from . import plan as plan_mod
    from . import plancheck

    ops = json.loads(plan_json)
    if not isinstance(ops, list):
        raise TypeError("table_stream_wire: plan must be a JSON list of ops")
    batches = list(batches)
    dev = resolve_device(device)
    schema = bucket = None
    if not batches:
        report = plancheck.check_plan(ops)
    for i, b in enumerate(batches):
        got = _check_wire_plan(ops, b[0], b[1], b[4])
        if i == 0:
            report, schema = got
            bucket = _plan_pad_to(ops, int(b[4]))

    def decode(batch):
        type_ids, scales, datas, valids, num_rows = batch
        with pipeline.device_lane(dev, "decode"):
            tbl = _table_from_wire(type_ids, scales, datas, valids,
                                   int(num_rows), dev,
                                   _plan_pad_to(ops, num_rows))
            return tbl, pipeline.mark(dev)

    def compute(decoded):
        tbl, ready = decoded
        pipeline.hand_over(ready, table_tensors(tbl), dev)
        out = plan_mod.run_plan(ops, tbl, donate_input=True)
        return out, pipeline.mark(dev)

    def encode(computed):
        out, ready = computed
        with pipeline.device_lane(dev, "encode"):
            pipeline.hand_over(ready, table_tensors(out), dev)
            return _table_to_wire(out)

    with profiler.maybe_session(ops, label="stream", batches=len(batches),
                                schema=schema, bucket=bucket,
                                static=report):
        with metrics.span("stream", batches=len(batches),
                          depth=pipeline.depth()):
            return pipeline.run_stream(batches, decode, compute, encode)


def table_download_wire(table_id: int):
    """Resident table -> the wire 5-tuple: a blocking point of the
    pipelined plane (a pending chain is waited for here and a worker
    failure replayed, so the op's own error raises from this call).
    Raises the labeled KeyError on an unknown or already-freed id."""
    tid = int(table_id)
    with _RESIDENT_LOCK:
        t = _RESIDENT.get(tid)
        if isinstance(t, spill.SpilledTable):
            t = spill.repage_locked(tid)
        live = len(_RESIDENT)
        if t is not None:
            _RESIDENT_ACTIVE_READS[tid] = _RESIDENT_ACTIVE_READS.get(tid, 0) + 1
            spill.touch(tid)
    spill.flush_events()
    if t is None:
        raise _unknown_id_error(tid, live)
    try:
        if isinstance(t, pipeline.Pending):
            t = t.resolve()
            with _RESIDENT_LOCK:
                if tid in _RESIDENT:
                    _RESIDENT[tid] = t
        metrics.counter_add("resident.get")
        return _table_to_wire(t)
    finally:
        with _RESIDENT_READS_CV:
            n = _RESIDENT_ACTIVE_READS.get(tid, 1) - 1
            if n > 0:
                _RESIDENT_ACTIVE_READS[tid] = n
            else:
                _RESIDENT_ACTIVE_READS.pop(tid, None)
            _RESIDENT_READS_CV.notify_all()


def table_num_rows(table_id: int) -> int:
    """Logical row count: the other blocking point."""
    return int(_resident_get(table_id).logical_row_count)


def table_free(table_id: int) -> None:
    """Release a resident id. A pending entry is dropped without waiting
    (the enqueued op keeps its own references and completes unobserved);
    one that already failed logs the dropped error. Raises the labeled
    KeyError on an unknown or already-freed id."""
    with _RESIDENT_LOCK:
        t = _RESIDENT.pop(int(table_id), None)
        _RESIDENT_META.pop(int(table_id), None)
        readers = _RESIDENT_READERS.pop(int(table_id), ())
        live = len(_RESIDENT)
    if t is None:
        raise _unknown_id_error(table_id, live)
    # drops spill tracking; a spilled entry's host/disk backing goes too
    spill.note_free(int(table_id), t)
    if isinstance(t, pipeline.Pending):
        if not any(not p.done() for p in readers):
            # no consumer captured this handle: a failure must log itself
            t.orphan()
            if t.failed_nowait():
                log.log("WARN", "handles", "freed_failed_pending",
                        table_id=int(table_id), stage=t.label)
                if flight.enabled():
                    flight.record("I", "pipeline.freed_failed", t.label)
    log.log("DEBUG", "handles", "table_free", table_id=int(table_id),
            live=live)
    metrics.counter_add("resident.free")
    _note_live(live)


def table_reclaim(table_id: int) -> int:
    """Release a resident id and give its device memory back now; returns
    the table's bytes.

    ``table_free`` only drops the registry's reference. A reclaim settles
    the id's pipelined readers first (``Pending.settle_terminally``) and
    waits for its active wire downloads, then frees each storage of the
    table with ``untyped_storage().resize_(0)`` after an event on the
    device's current stream has passed, skipping any storage a live
    table shares (an op output may alias its input). A spilled entry
    releases its host or disk backing and is credited its device bytes.
    The caller owns the id: no other thread may still dispatch over it.
    Raises the labeled KeyError on an unknown or already-freed id."""
    tid = int(table_id)
    with _RESIDENT_LOCK:
        t = _RESIDENT.pop(tid, None)
        _RESIDENT_META.pop(tid, None)
        readers = _RESIDENT_READERS.pop(tid, ())
        live = len(_RESIDENT)
    if t is None:
        raise _unknown_id_error(table_id, live)
    for p in readers:
        p.settle_terminally()
    metrics.counter_add("resident.free")
    _note_live(live)
    if isinstance(t, spill.SpilledTable):
        nbytes = spill.note_free(tid, t)
        metrics.bytes_add("resident.reclaimed_bytes", nbytes)
        return nbytes
    spill.note_free(tid)
    if isinstance(t, pipeline.Pending):
        t.orphan()
        t.wait_settled()
        settled = t.value_nowait()
        if settled is None:  # the producing op failed: nothing to free
            if t.failed_nowait():
                log.log("WARN", "handles", "reclaimed_failed_pending",
                        table_id=tid, stage=t.label)
            return 0
        t = settled
    with _RESIDENT_READS_CV:
        while _RESIDENT_ACTIVE_READS.get(tid):
            _RESIDENT_READS_CV.wait()
    nbytes = int(hbm.table_bytes(t))
    shared = _live_storages()
    tensors = [a for a in table_tensors(t)
               if spill.storage_key(a) not in shared]
    dev = _device_of(t)
    if dev is not None and dev.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
    for a in tensors:
        spill.free_storage(a)
    log.log("DEBUG", "handles", "table_reclaim", table_id=tid, live=live,
            nbytes=nbytes)
    metrics.bytes_add("resident.reclaimed_bytes", nbytes)
    return nbytes


def resident_table_count() -> int:
    """Live resident tables (pending and spilled ones included)."""
    with _RESIDENT_LOCK:
        return len(_RESIDENT)


def platform(device: Union[str, torch.device] = "cuda") -> str:
    """The platform an entry point runs on: ``"gpu"`` for a CUDA device
    (raising without one, as every entry does), ``"cpu"`` when the
    caller asks for the CPU."""
    return "gpu" if resolve_device(device).type == "cuda" else "cpu"


def leak_report() -> list:
    """Tables still resident, each with the span stack that allocated it
    (the RMM leak report's role for device table handles): pending,
    spilled and resident tables alike. JSON-able; the ``resident_leaks``
    flight-dump section, and printed at exit when non-empty and a
    telemetry plane is on. A pending entry is never resolved here."""
    with _RESIDENT_LOCK:
        items = [(tid, _RESIDENT[tid], dict(_RESIDENT_META.get(tid) or {}))
                 for tid in sorted(_RESIDENT)]
    now = _time.perf_counter_ns()
    out = []
    for tid, t, meta in items:
        pending = isinstance(t, pipeline.Pending)
        if pending:
            settled = t.value_nowait()
            if settled is not None:
                t, pending = settled, False
        spilled = isinstance(t, spill.SpilledTable)
        if spilled:
            logical = int(t.rows)
        else:
            logical = None if pending else int(t.logical_row_count)
        rec = {
            "table_id": tid,
            "rows": logical,
            "logical_rows": logical,
            "columns": t.num_columns if spilled
            else (None if pending else len(t.columns)),
            "allocated_under": meta.get("allocated_under", []),
        }
        if pending:
            rec["pending"] = t.label
        if spilled:
            # a spilled leak holds host memory or a disk file, not device
            # memory: say which tier
            rec["residency"] = t.state
            rec["approx_bytes"] = int(t.nbytes)
        if meta.get("session"):
            rec["session"] = meta["session"]
        anchor = meta.get("age_anchor_ns")
        if anchor is not None:
            rec["age_s"] = round((now - anchor) / 1e9, 3)
        if not pending and not spilled:
            rec["approx_bytes"] = int(hbm.table_bytes(t))
        out.append(rec)
    return out


def _leak_report_at_exit() -> None:  # pragma: no cover - atexit path
    """WARN for every table a process left resident, when a telemetry
    plane is on."""
    if not _RESIDENT or not _provenance_on():
        return
    leaks = leak_report()
    print(f"[srt][leak][WARN] {len(leaks)} device table(s) still resident "
          "at exit:", file=sys.stderr, flush=True)
    for rec in leaks:
        under = "/".join(rec["allocated_under"]) or "<no span>"
        print(f"[srt][leak][WARN]   table_id={rec['table_id']} "
              f"logical_rows={rec['logical_rows']} cols={rec['columns']} "
              f"bytes~{rec.get('approx_bytes', '?')} "
              f"allocated_under={under}", file=sys.stderr, flush=True)


atexit.register(_leak_report_at_exit)
# the flight dump carries the same record, so a postmortem reads one file
flight.register_exit_section("resident_leaks", leak_report)


# the spill tier works under this registry's lock
spill.bind_registry(
    _RESIDENT_LOCK, _RESIDENT, _RESIDENT_READERS, _RESIDENT_ACTIVE_READS
)
