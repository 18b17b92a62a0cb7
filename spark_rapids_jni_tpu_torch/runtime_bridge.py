"""Wire-level entry points of the port (port of ``runtime_bridge.py``).

The same names, signatures and wire format as the JAX package, so a C
shim can call either package: parallel (type id, scale) int arrays,
little-endian fixed-width data buffers (FLOAT64 as IEEE-754 doubles,
BOOL8 as one 0/1 byte), per-column 0/1 validity byte vectors, and STRING
and LIST columns as int32 offsets[n+1] followed by the payload (UTF-8
bytes; LIST: the child values, with the child type id in the scale
slot).

``table_op_wire`` and ``table_plan_wire`` take one wire table and give
back the wire 5-tuple: bytes in, bytes out. Otherwise tables stay
resident on the device between calls: ``table_upload_wire`` returns an
id, ``table_plan_resident`` runs a plan over ids and returns a new id,
``table_download_wire`` serializes one, ``table_free`` drops it. Every
entry that runs ops checks them first (``plancheck.check_plan``), before
any upload or donation. Every op of ``DISPATCH_OPS`` runs;
``table_op_resident`` runs one op over resident tables. The JAX package pads wire tables to a shape
bucket; the port runs exact shapes, which gives the same logical rows.
Where the JAX entries raise on an input Spark can send (a join with a
0-row side, a ``concat`` of unnamed tables), the port returns Spark's
result.
"""

from __future__ import annotations

import itertools
import json
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import dtype as dt
from .column import (
    Column, Table, host_to_storage, resolve_device, storage_to_host,
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


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # a view of the caller's wire bytes
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _column_from_wire(type_id: int, scale: int, data: Optional[bytes],
                      valid: Optional[bytes], num_rows: int,
                      device: torch.device) -> Column:
    """Decode one wire column onto ``device``."""
    v = _wire_validity(valid, num_rows)
    vt = None if v is None else _to_device(v, device)
    tid = dt.TypeId(type_id)
    if tid in (dt.TypeId.LIST, dt.TypeId.STRING):
        child = (dt.UINT8 if tid == dt.TypeId.STRING
                 else dt.DType(dt.TypeId(scale)))
        mat, lens = _padded_from_offsets(data, num_rows, child.host_dtype,
                                         tid.name)
        return Column(_to_device(mat, device), dt.DType(tid), vt,
                      _to_device(lens, device))
    d = dt.DType(tid, scale)
    if d.id == dt.TypeId.DECIMAL128:
        arr = np.frombuffer(data, np.uint64, 2 * num_rows).reshape(num_rows, 2)
    else:
        arr = np.frombuffer(data, _wire_np(d), num_rows)
    return Column(host_to_storage(arr, d, device), d, vt)


def _column_to_wire(c: Column):
    """(type_id, scale, data bytes, valid bytes | None)."""
    valid = (None if c.validity is None
             else c.validity.cpu().numpy().astype(np.uint8).tobytes())
    if c.dtype.id in (dt.TypeId.LIST, dt.TypeId.STRING):
        scale = 0 if c.dtype.is_string else int(c.list_child_dtype.id)
        return (
            int(c.dtype.id), scale,
            _padded_to_offsets(c.data.cpu().numpy(),
                               c.lengths.cpu().numpy().astype(np.int32)),
            valid,
        )
    host = storage_to_host(c.data, c.dtype)
    return int(c.dtype.id), int(c.dtype.scale), host.tobytes(), valid


def _table_from_wire(type_ids, scales, datas, valids, num_rows: int,
                     device: torch.device) -> Table:
    return Table([
        _column_from_wire(t, s, d, v, num_rows, device)
        for t, s, d, v in zip(type_ids, scales, datas, valids)
    ])


def _table_to_wire(t: Table):
    """The 5-tuple every wire entry returns."""
    out_t, out_s, out_d, out_v = [], [], [], []
    for c in t.columns:
        ti, s, d, v = _column_to_wire(c)
        out_t.append(ti)
        out_s.append(s)
        out_d.append(d)
        out_v.append(v)
    return out_t, out_s, out_d, out_v, int(t.logical_row_count)


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


def _dispatch_once(op: dict, table: Table, rest: Sequence[Table],
                   name: str) -> Table:
    """Run one op, kernel tier first; ``join`` takes the probe side as
    ``table`` and the build side as ``rest[0]``."""
    from .kernels import registry as kernel_registry

    out = kernel_registry.dispatch_kernel(op, table, rest, name)
    if out is None:
        out = _dispatch_impl(op, table, rest, name)
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
        if how == "left":  # the JAX wire entries pad its build side
            return ops.left_join(table, rest[0], op["on"], padded=True)
        return getattr(ops, _JOINS[how])(table, rest[0], op["on"])
    if name == "concat":
        return ops.concatenate([table, *rest])
    if name == "groupby":
        aggs = [ops.GroupbyAgg(a["column"], a["agg"]) for a in op["aggs"]]
        # the JAX wire entries pad to a shape bucket and reduce as they
        # do, but for a collect, which runs on their exact path
        collect = any(a.op.startswith("collect") for a in aggs)
        return ops.groupby_aggregate(table, op["by"], aggs,
                                     padded=not collect)
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
# ---------------------------------------------------------------------------

_RESIDENT: dict = {}
_RESIDENT_LOCK = threading.Lock()
_NEXT_TABLE_ID = itertools.count(1)


def _unknown_id_error(table_id, live: int) -> KeyError:
    return KeyError(
        f"unknown or already-freed device table id {int(table_id)} "
        f"({live} table(s) live)"
    )


def _resident_get(table_id: int) -> Table:
    with _RESIDENT_LOCK:
        t = _RESIDENT.get(int(table_id))
        live = len(_RESIDENT)
    if t is None:
        raise _unknown_id_error(table_id, live)
    return t


def _resident_put(t: Table) -> int:
    tid = next(_NEXT_TABLE_ID)
    with _RESIDENT_LOCK:
        _RESIDENT[tid] = t
    return tid


def table_upload_wire(
    type_ids: Sequence[int],
    scales: Sequence[int],
    datas: Sequence[Optional[bytes]],
    valids: Sequence[Optional[bytes]],
    num_rows: int,
    device: Union[str, torch.device] = "cuda",
) -> int:
    """Host bytes -> device-resident table; returns its id."""
    dev = resolve_device(device)
    return _resident_put(
        _table_from_wire(type_ids, scales, datas, valids, int(num_rows), dev)
    )


def table_plan_resident(
    plan_json: str, table_ids: Sequence[int], donate: bool = False
) -> int:
    """Run a plan (a JSON list of ops) over resident tables; the result
    stays resident. ``table_ids[0]`` is the chain input, the other ids
    feed multi-table ops (see ``plan._take_rest``). The plan is checked
    first (``plancheck.check_plan`` on the tables' schemas);
    ``donate=True`` then frees ``table_ids[0]`` when the plan starts, so
    a rejected plan leaves it live."""
    from . import plan as plan_mod

    if not table_ids:
        raise ValueError("table_plan_resident needs at least one input")
    ops = json.loads(plan_json)
    if not isinstance(ops, list):
        raise TypeError("table_plan_resident: plan must be a JSON list of ops")
    tables = _checked_inputs(ops, table_ids)
    if donate:
        table_free(table_ids[0])
    return _resident_put(plan_mod.run_plan(ops, tables[0], tables[1:]))


def table_op_resident(
    op_json: str, table_ids: Sequence[int], donate: bool = False
) -> int:
    """One op over resident tables; the result stays resident.
    ``table_ids[0]`` is the op's input, the others its extra tables (a
    join's build side, a concat's tail). The op is checked first
    (``plancheck.check_plan``); ``donate=True`` then frees
    ``table_ids[0]``, so a rejected op leaves it live."""
    from . import plan as plan_mod

    if not table_ids:
        raise ValueError("table_op_resident needs at least one input")
    op = json.loads(op_json)
    tables = _checked_inputs([op], table_ids)
    if donate:
        table_free(table_ids[0])
    rest = plan_mod._take_rest(op, tuple(tables[1:]), list(tables[1:]))
    return _resident_put(_dispatch_once(op, tables[0], rest, op["op"]))


def _checked_inputs(ops, table_ids: Sequence[int]) -> list:
    """The resident tables of ``table_ids``, after the plan check on
    their schemas."""
    from . import plancheck

    tables = [_resident_get(t) for t in table_ids]
    plancheck.check_plan(
        ops, schema=plancheck.schema_of_table(tables[0]),
        rows=tables[0].logical_row_count,
        rest=[(plancheck.schema_of_table(t), t.logical_row_count)
              for t in tables[1:]],
        names=tables[0].names)
    return tables


def _check_wire_plan(ops, type_ids, scales, num_rows: int) -> None:
    from . import plancheck

    plancheck.check_plan(ops, schema=plancheck.schema_from_wire(
        type_ids, scales), rows=int(num_rows))


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
    tbl = _table_from_wire(type_ids, scales, datas, valids, int(num_rows),
                           resolve_device(device))
    return _table_to_wire(_dispatch_once(op, tbl, (), op["op"]))


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
    table (``plan.run_plan``) and comes back as the wire 5-tuple. A plan
    has one input table, so a ``join`` in it is refused."""
    from . import plan as plan_mod

    ops = json.loads(plan_json)
    if not isinstance(ops, list):
        raise TypeError("table_plan_wire: plan must be a JSON list of ops")
    _check_wire_plan(ops, type_ids, scales, num_rows)
    tbl = _table_from_wire(type_ids, scales, datas, valids, int(num_rows),
                           resolve_device(device))
    return _table_to_wire(plan_mod.run_plan(ops, tbl))


def table_download_wire(table_id: int):
    """Resident table -> the wire 5-tuple."""
    return _table_to_wire(_resident_get(table_id))


def table_num_rows(table_id: int) -> int:
    return int(_resident_get(table_id).logical_row_count)


def table_free(table_id: int) -> None:
    """Release a resident id; raises the labeled KeyError on an unknown
    or already-freed id."""
    with _RESIDENT_LOCK:
        t = _RESIDENT.pop(int(table_id), None)
        live = len(_RESIDENT)
    if t is None:
        raise _unknown_id_error(table_id, live)
