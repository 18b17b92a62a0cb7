"""Host storage buffers <-> port tables: the carry-across function.

A column travels as the tuple ``(data, validity, lengths, type_id,
scale)`` of numpy buffers in the JAX package's storage layout (FLOAT64 as
uint64 bits, BOOL8 as bool, LIST as an ``(n, pad)`` child matrix and
STRING as an ``(n, pad)`` uint8 byte matrix, each plus int32 lengths,
validity as a bool vector or None). Feeding
``np.asarray`` of every buffer of a JAX ``Column`` through
:func:`table_from_buffers` gives a port table over the same bytes, and
:func:`table_to_buffers` gives them back for a byte-for-byte comparison.

The Arrow half (the port of the JAX package's ``interop.py``): Arrow
arrays and tables become port columns and back. Validity is Arrow's
LSB-first bitmap on the host and a bool vector on the device. STRING
and LIST columns are built from Arrow's offsets and data buffers with
numpy (the same padded matrix and lengths the JAX package builds a row
at a time); pyarrow is imported when present and required at call time.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import dtype as dt
from .column import (
    Column, Table, host_to_storage, resolve_device, storage_to_host,
)

try:  # pyarrow is optional: required at call time, never at import
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None

Buffers = tuple  # (data, validity | None, lengths | None, type_id, scale)


def column_from_buffers(
    data: np.ndarray,
    validity: Optional[np.ndarray],
    lengths: Optional[np.ndarray],
    type_id: int,
    scale: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> Column:
    dev = resolve_device(device)
    tid = dt.TypeId(int(type_id))
    if tid in (dt.TypeId.LIST, dt.TypeId.STRING):
        mat = torch.from_numpy(np.array(data)).to(dev)
        dtype = dt.DType(tid)
        if lengths is None:
            raise ValueError(f"{tid.name} buffers need lengths")
        lens = torch.from_numpy(np.array(lengths, dtype=np.int32)).to(dev)
    else:
        dtype = dt.DType(tid, int(scale))
        _check_unit(data, dtype)
        mat = host_to_storage(data, dtype, dev)
        lens = None
    valid = None
    if validity is not None:
        valid = torch.from_numpy(np.array(validity, dtype=np.bool_)).to(dev)
    return Column(mat, dtype, valid, lens)


def _check_unit(data: np.ndarray, dtype: dt.DType) -> None:
    """A TIMESTAMP_* or DURATION_* buffer carries its unit in its type id
    and its width in its dtype: a buffer of another width (an int64 day
    count for TIMESTAMP_DAYS, a datetime64 of any unit) is refused
    rather than cast, so a tick never changes its meaning on the way."""
    if dtype.is_timestamp or dtype.is_duration:
        got = np.asarray(data).dtype
        if got != dtype.host_dtype:
            raise TypeError(
                f"{dtype.id.name} buffer must be {dtype.host_dtype}, "
                f"got {got}")


def column_to_buffers(col: Column) -> Buffers:
    if col.dtype.id in (dt.TypeId.LIST, dt.TypeId.STRING):
        data = col.data.cpu().numpy()
    else:
        data = storage_to_host(col.data, col.dtype)
    validity = None if col.validity is None else col.validity.cpu().numpy()
    lengths = None if col.lengths is None else col.lengths.cpu().numpy()
    return (data, validity, lengths, int(col.dtype.id), int(col.dtype.scale))


def table_from_buffers(
    columns: Sequence[Buffers],
    names: Optional[Sequence[str]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Table:
    return Table(
        [column_from_buffers(*c, device=device) for c in columns], names
    )


def table_to_buffers(table: Table) -> list:
    return [column_to_buffers(c) for c in table.columns]


def struct_from_buffers(
    children: Sequence[Buffers],
    names: Optional[Sequence[str]] = None,
    validity: Optional[np.ndarray] = None,
    device: Union[str, torch.device] = "cuda",
):
    """A port ``StructColumn`` from its children's buffers and the
    struct-level validity (the host arrays of a JAX ``StructColumn``)."""
    from .struct import StructColumn

    dev = resolve_device(device)
    cols = [column_from_buffers(*c, device=dev) for c in children]
    valid = None
    if validity is not None:
        valid = torch.from_numpy(np.array(validity, dtype=np.bool_)).to(dev)
    return StructColumn.from_children(cols, names, valid)


def struct_to_buffers(sc) -> tuple:
    """Inverse of :func:`struct_from_buffers`: ``(children buffers,
    names, validity)``."""
    validity = None if sc.validity is None else sc.validity.cpu().numpy()
    return ([column_to_buffers(c) for c in sc.children], list(sc.names),
            validity)


# ---------------------------------------------------------------------------
# Arrow
# ---------------------------------------------------------------------------


def _require_pyarrow():
    if pa is None:  # pragma: no cover
        raise ImportError("pyarrow is not available in this environment")


def unpack_validity(bitmap: Optional[bytes], n: int,
                    offset: int = 0) -> Optional[np.ndarray]:
    """Arrow LSB-first validity bitmap -> (n,) bool array, or None if
    absent."""
    if bitmap is None:
        return None
    bits = np.unpackbits(np.frombuffer(bitmap, dtype=np.uint8),
                         bitorder="little")
    return bits[offset:offset + n].astype(np.bool_)


def pack_validity(valid: np.ndarray) -> bytes:
    """(n,) bool array -> Arrow LSB-first validity bitmap bytes."""
    return np.packbits(valid.astype(np.uint8), bitorder="little").tobytes()


_ARROW_UNITS = {"s": "SECONDS", "ms": "MILLISECONDS", "us": "MICROSECONDS",
                "ns": "NANOSECONDS"}

# LIST children whose storage dtype maps back to one type id (the JAX
# package's from_list_of_lists restriction)
_LIST_CHILD_IDS = frozenset({
    dt.TypeId.INT8, dt.TypeId.INT16, dt.TypeId.INT32, dt.TypeId.INT64,
    dt.TypeId.UINT8, dt.TypeId.UINT16, dt.TypeId.UINT32, dt.TypeId.UINT64,
    dt.TypeId.FLOAT32, dt.TypeId.BOOL8,
})


def _arrow_type_to_dtype(t) -> dt.DType:
    _require_pyarrow()
    simple = (
        (pa.types.is_int8, dt.INT8), (pa.types.is_int16, dt.INT16),
        (pa.types.is_int32, dt.INT32), (pa.types.is_int64, dt.INT64),
        (pa.types.is_uint8, dt.UINT8), (pa.types.is_uint16, dt.UINT16),
        (pa.types.is_uint32, dt.UINT32), (pa.types.is_uint64, dt.UINT64),
        (pa.types.is_float32, dt.FLOAT32), (pa.types.is_float64, dt.FLOAT64),
        (pa.types.is_boolean, dt.BOOL8), (pa.types.is_date32, dt.TIMESTAMP_DAYS),
    )
    for test, dtype in simple:
        if test(t):
            return dtype
    if pa.types.is_timestamp(t):
        return dt.DType(dt.TypeId[f"TIMESTAMP_{_ARROW_UNITS[t.unit]}"])
    if pa.types.is_duration(t):
        return dt.DType(dt.TypeId[f"DURATION_{_ARROW_UNITS[t.unit]}"])
    if pa.types.is_decimal(t):
        # precision <= 9 -> DECIMAL32, <= 18 -> DECIMAL64, else DECIMAL128;
        # the device scale is Arrow's negated. decimal256 (32-byte
        # values) is refused: every buffer reader assumes 16 bytes.
        if not pa.types.is_decimal128(t):
            raise TypeError(f"unsupported arrow decimal width: {t}")
        if t.precision <= 9:
            return dt.decimal32(-t.scale)
        if t.precision <= 18:
            return dt.decimal64(-t.scale)
        return dt.DType(dt.TypeId.DECIMAL128, -t.scale)
    if (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_binary(t)):
        return dt.STRING
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        return dt.LIST
    raise TypeError(f"unsupported arrow type {t}")


def _arrow_valid(arr) -> Optional[np.ndarray]:
    """(n,) bool validity of an Arrow array, None when it has no nulls."""
    if not arr.null_count:
        return None
    return unpack_validity(arr.buffers()[0], len(arr), arr.offset)


def _offsets(arr, large: bool) -> np.ndarray:
    """An Arrow offsets buffer, sliced to the array's n + 1 entries."""
    offs = np.frombuffer(arr.buffers()[1], np.int64 if large else np.int32)
    return offs[arr.offset:arr.offset + len(arr) + 1].astype(np.int64)


def _padded(flat: np.ndarray, offs: np.ndarray, lens: np.ndarray,
            pad: int) -> np.ndarray:
    """(n, pad) matrix whose row i holds ``flat[offs[i]:offs[i] +
    lens[i]]`` and zeros after it."""
    n = lens.shape[0]
    mat = np.zeros((n, pad), flat.dtype)
    total = int(lens.sum())
    if total:
        starts = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        src = np.arange(total, dtype=np.int64) + np.repeat(
            offs[:-1] - starts, lens)
        mat[np.arange(pad)[None, :] < lens[:, None]] = flat[src]
    return mat


def _padded_from_arrow(arr, flat: np.ndarray, offs: np.ndarray,
                       pad_width, dtype: dt.DType, what: str, dev) -> Column:
    """A STRING or LIST column from an Arrow array's offsets ``offs`` into
    ``flat``: the (n, pad) matrix, int32 lengths (0 for a null row,
    whatever its offsets say) and the validity."""
    valid = _arrow_valid(arr)
    lens = np.diff(offs)
    if valid is not None:
        lens[~valid] = 0
    max_len = int(lens.max()) if len(arr) else 0
    pad = pad_width if pad_width is not None else max(max_len, 1)
    if max_len > pad:
        raise ValueError(f"{what} {max_len} exceeds pad width {pad}")
    return Column(
        torch.from_numpy(_padded(flat, offs, lens, pad)).to(dev), dtype,
        None if valid is None else torch.from_numpy(valid).to(dev),
        torch.from_numpy(lens.astype(np.int32)).to(dev))


def _strings_from_arrow(arr, pad_width, dev) -> Column:
    data = arr.buffers()[2]
    flat = (np.frombuffer(data, np.uint8) if data is not None
            else np.zeros(0, np.uint8))
    offs = _offsets(arr, pa.types.is_large_string(arr.type))
    return _padded_from_arrow(arr, flat, offs, pad_width, dt.STRING,
                              "string of length", dev)


def _list_from_arrow(arr, pad_width, dev) -> Column:
    child = _arrow_type_to_dtype(arr.type.value_type)
    if child.id not in _LIST_CHILD_IDS:
        # the child type is read back off the storage dtype, so only
        # types whose storage maps back to one type id are taken
        raise TypeError(
            f"LIST child {child} not supported (MVP children: "
            "int8..64, uint8..64, float32, bool)")
    offs = _offsets(arr, pa.types.is_large_list(arr.type))
    values = arr.values
    if values.null_count:
        # the padded layout has no child validity: refuse, don't coerce
        # (only the children of valid rows count)
        ends = offs[1:].copy()
        valid = _arrow_valid(arr)
        if valid is not None:
            ends[~valid] = offs[:-1][~valid]
        used = np.zeros(len(values) + 1, np.int64)
        np.add.at(used, offs[:-1], 1)
        np.add.at(used, ends, -1)
        inside = np.cumsum(used)[:-1] > 0
        bad = np.flatnonzero(inside & ~np.asarray(values.is_valid()))
        if bad.size:
            row = int(np.searchsorted(offs[:-1], bad[0], side="right") - 1)
            raise TypeError(
                f"null elements inside lists are not supported (row {row})")
    flat = np.asarray(values.fill_null(False if child.is_boolean else 0))
    return _padded_from_arrow(arr, flat.astype(child.host_dtype, copy=False),
                              offs, pad_width, dt.LIST, "list length", dev)


def column_from_arrow(arr, pad_width: Optional[int] = None,
                      device: Union[str, torch.device] = "cuda") -> Column:
    """pyarrow Array/ChunkedArray -> port Column on ``device``."""
    _require_pyarrow()
    dev = resolve_device(device)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    dtype = _arrow_type_to_dtype(arr.type)
    if dtype.is_string:
        return _strings_from_arrow(arr, pad_width, dev)
    if dtype.id == dt.TypeId.LIST:
        return _list_from_arrow(arr, pad_width, dev)
    n = len(arr)
    valid = None
    if arr.null_count:
        valid = np.asarray(arr.is_valid())
    if dtype.is_decimal:
        # Arrow decimal128's buffer is 16-byte little-endian two's
        # complement: DECIMAL128's (n, 2) limbs as they are; for the
        # narrower widths (precision <= 18) the low word is the value.
        words = np.frombuffer(arr.buffers()[1], np.uint64)
        limbs = words[arr.offset * 2:(arr.offset + n) * 2].reshape(n, 2)
        host = (limbs if dtype.id == dt.TypeId.DECIMAL128
                else limbs[:, 0].view(np.int64).astype(dtype.host_dtype))
    elif dtype.is_boolean:
        host = np.asarray(arr.fill_null(False))
    else:
        host = np.asarray(arr.fill_null(0))
        if host.dtype.kind in "Mm":
            host = host.view(np.dtype(f"i{host.dtype.itemsize}"))
    return Column(
        host_to_storage(np.ascontiguousarray(host), dtype, dev), dtype,
        None if valid is None else torch.from_numpy(valid).to(dev))


def table_from_arrow(tbl, pad_widths: Optional[dict] = None,
                     device: Union[str, torch.device] = "cuda") -> Table:
    """pyarrow Table -> port Table on ``device`` (names kept)."""
    _require_pyarrow()
    dev = resolve_device(device)
    cols = [column_from_arrow(tbl.column(name),
                              pad_width=(pad_widths or {}).get(name),
                              device=dev)
            for name in tbl.column_names]
    return Table(cols, tbl.column_names)


_NP_UNITS = {
    dt.TypeId.TIMESTAMP_DAYS: "M8[D]", dt.TypeId.TIMESTAMP_SECONDS: "M8[s]",
    dt.TypeId.TIMESTAMP_MILLISECONDS: "M8[ms]",
    dt.TypeId.TIMESTAMP_MICROSECONDS: "M8[us]",
    dt.TypeId.TIMESTAMP_NANOSECONDS: "M8[ns]",
    # Arrow has no duration[D]: days go out as duration[s]
    dt.TypeId.DURATION_SECONDS: "m8[s]",
    dt.TypeId.DURATION_MILLISECONDS: "m8[ms]",
    dt.TypeId.DURATION_MICROSECONDS: "m8[us]",
    dt.TypeId.DURATION_NANOSECONDS: "m8[ns]",
}


def _offsets_buffer(lens: np.ndarray) -> np.ndarray:
    offs = np.zeros(lens.shape[0] + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    return offs


def _decimal_to_arrow(col: Column, valid: np.ndarray):
    """DECIMAL32/64/128 -> Arrow decimal128 at cudf's precision for the
    width (9, 18, 38); a value past that precision raises."""
    precision = {4: 9, 8: 18, 16: 38}[col.dtype.itemsize]
    host = storage_to_host(col.data, col.dtype)
    if col.dtype.id == dt.TypeId.DECIMAL128:
        limbs = np.ascontiguousarray(host.view(np.uint64).reshape(-1, 2))
    else:
        v = host.astype(np.int64)
        limbs = np.stack([v.view(np.uint64),
                          (v >> 63).view(np.uint64)], axis=1)
    lo, hi = limbs[:, 0], limbs[:, 1].view(np.int64)
    limit = 10 ** precision
    pos_hi, pos_lo = limit >> 64, limit & ((1 << 64) - 1)
    neg = (-limit) & ((1 << 128) - 1)
    neg_hi, neg_lo = neg >> 64, neg & ((1 << 64) - 1)
    neg_hi -= 1 << 64  # as a signed high word
    too_big = ((hi > pos_hi) | ((hi == pos_hi) & (lo >= np.uint64(pos_lo)))
               | (hi < neg_hi) | ((hi == neg_hi) & (lo <= np.uint64(neg_lo))))
    bad = np.flatnonzero(too_big & valid)
    if bad.size:
        u = (int(limbs[bad[0], 1]) << 64) | int(limbs[bad[0], 0])
        v0 = u - (1 << 128) if u >= 1 << 127 else u
        raise ValueError(f"unscaled value {v0} exceeds Arrow "
                         f"decimal128({precision}) precision")
    n = len(valid)
    nulls = None if valid.all() else pa.py_buffer(pack_validity(valid))
    return pa.Array.from_buffers(
        pa.decimal128(precision, -col.dtype.scale), n,
        [nulls, pa.py_buffer(limbs.tobytes())],
        null_count=int(n - valid.sum()))


def column_to_arrow(col: Column):
    """Port Column -> pyarrow Array (null payloads masked out)."""
    _require_pyarrow()
    n = col.row_count
    valid = (np.ones(n, np.bool_) if col.validity is None
             else col.validity.cpu().numpy())
    nulls = None if valid.all() else pa.py_buffer(pack_validity(valid))
    null_count = int(n - valid.sum())
    if col.dtype.is_string or col.dtype.id == dt.TypeId.LIST:
        mat = col.data.cpu().numpy()
        lens = np.where(valid, col.lengths.cpu().numpy(), 0)
        offs = _offsets_buffer(lens)
        flat = mat[np.arange(mat.shape[1])[None, :] < lens[:, None]]
        if col.dtype.id == dt.TypeId.LIST:
            child = pa.from_numpy_dtype(flat.dtype)
            values = pa.array(flat, type=child)
            return pa.ListArray.from_arrays(
                pa.array(offs, pa.int32()), values,
                type=pa.list_(child),
                mask=None if nulls is None else pa.array(~valid))
        bufs = [nulls, pa.py_buffer(offs.tobytes()),
                pa.py_buffer(flat.tobytes())]
        out = pa.Array.from_buffers(pa.binary(), n, bufs,
                                    null_count=null_count)
        try:
            return out.cast(pa.string())
        except pa.ArrowInvalid:
            # a non-UTF-8 payload (ingested from an Arrow binary array)
            # goes back out as binary, byte for byte
            return out
    if col.dtype.is_decimal:
        return _decimal_to_arrow(col, valid)
    arr = col.to_numpy()
    unit = _NP_UNITS.get(col.dtype.id)
    if unit is not None:
        arr = arr.astype(np.int64).view(unit)
    elif col.dtype.id == dt.TypeId.DURATION_DAYS:
        arr = arr.astype(np.int64).view("m8[D]").astype("m8[s]")
    return pa.array(arr, mask=None if valid.all() else ~valid)


def table_to_arrow(tbl: Table):
    """Port Table -> pyarrow Table (unnamed columns become c0, c1, ...)."""
    _require_pyarrow()
    names = (list(tbl.names) if tbl.names is not None
             else [f"c{i}" for i in range(tbl.num_columns)])
    return pa.table({n: column_to_arrow(c)
                     for n, c in zip(names, tbl.columns)})
