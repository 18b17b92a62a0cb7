"""Row <-> columnar transpose (port of ``rows.py``).

The packed row format of spark-rapids-jni, byte for byte
(RowConversion.java:43-102; layout row_conversion.cu:432-456): each
fixed-width column at an offset aligned to its width, one LSB-first
validity bit per column in bytes after the last column, the row padded
to 8 bytes, and tables split into batches of
``(INT_MAX / row_size) / 32 * 32`` rows (row_conversion.cu:476-479).

Both directions run through the hand-written kernels of
``kernels/row_transpose.py`` (their plain versions on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import dtype as dt
from .column import Column, Table, resolve_device
from .kernels import row_transpose as rt

INT_MAX = 2**31 - 1


def align_offset(offset: int, alignment: int) -> int:
    """Round ``offset`` up to ``alignment`` (row_conversion.cu:417-419)."""
    return (offset + alignment - 1) & ~(alignment - 1)


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Byte layout of one packed row for a fixed-width schema."""

    dtypes: tuple
    column_offsets: tuple
    column_widths: tuple
    validity_offset: int
    validity_bytes: int
    row_size: int


def compute_fixed_width_layout(dtypes: Sequence[dt.DType]) -> RowLayout:
    dtypes = tuple(dtypes)
    if not dtypes:
        raise TypeError("row format requires at least one column")
    for d in dtypes:
        if not d.is_fixed_width:
            raise TypeError(
                f"only fixed-width types supported in row format, got {d!r}"
            )
    offsets, widths = [], []
    cursor = 0
    for d in dtypes:
        w = d.itemsize
        cursor = align_offset(cursor, w)
        offsets.append(cursor)
        widths.append(w)
        cursor += w
    validity_offset = cursor
    validity_bytes = (len(dtypes) + 7) // 8
    row_size = align_offset(cursor + validity_bytes, 8)
    return RowLayout(dtypes, tuple(offsets), tuple(widths),
                     validity_offset, validity_bytes, row_size)


def max_rows_per_batch(row_size: int) -> int:
    """2 GB split granularity (row_conversion.cu:476-479)."""
    if row_size * 32 > INT_MAX:
        raise ValueError("row size too large: 32 rows exceed INT_MAX bytes")
    return (INT_MAX // row_size) // 32 * 32


@dataclasses.dataclass(eq=False)
class PackedRows:
    """One batch of packed rows: an (n, row_size) uint8 tensor."""

    data: torch.Tensor
    layout: RowLayout

    @property
    def row_count(self) -> int:
        return int(self.data.shape[0])


def packed_rows_from_numpy(
    data: np.ndarray, dtypes: Sequence[dt.DType],
    device: Union[str, torch.device] = "cuda",
) -> PackedRows:
    """Host row bytes ``(n, row_size)`` (or flat) as a PackedRows batch on
    ``device`` (``rows.py:414``)."""
    layout = compute_fixed_width_layout(dtypes)
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        if data.size % layout.row_size:
            raise ValueError("flat row buffer not a multiple of row_size")
        data = data.reshape(-1, layout.row_size)
    if data.shape[1] != layout.row_size:
        raise ValueError(
            f"row width {data.shape[1]} != layout row_size {layout.row_size}")
    return PackedRows(torch.from_numpy(np.ascontiguousarray(data)).to(
        resolve_device(device)), layout)


def column_bytes(col: Column) -> torch.Tensor:
    """(n, width) uint8 little-endian view of a fixed-width column (no
    copy for contiguous data; BOOL8 is its 0/1 byte). A 0-row column
    gets a fresh (0, width) tensor: its storage may carry a stride of 0,
    which no dtype view takes."""
    n, w = col.row_count, col.dtype.itemsize
    if n == 0:
        return torch.empty((0, w), dtype=torch.uint8, device=col.data.device)
    return col.data.contiguous().view(torch.uint8).view(n, w)


def _pack(table: Table, layout: RowLayout, start: int, stop: int) -> PackedRows:
    """Rows ``start:stop`` of ``table`` packed by one kernel call, which
    reads each column's validity vector where it lies."""
    cols = [
        Column(c.data[start:stop], c.dtype,
               None if c.validity is None else c.validity[start:stop])
        for c in table.columns
    ]
    return PackedRows(rt.pack_rows_columns(
        [column_bytes(c) for c in cols], [c.validity for c in cols], layout),
        layout)


def to_rows(table: Table, batch_rows: Optional[int] = None) -> list:
    """Columnar -> packed rows, one ``PackedRows`` per 2 GB batch
    (``convert_to_rows``, row_conversion.cu:458-517). ``batch_rows``
    overrides the split size, clamped to a multiple of 32."""
    layout = compute_fixed_width_layout(table.dtypes())
    n = table.row_count
    if batch_rows is not None:
        batch = max(batch_rows // 32 * 32, 32)
    else:
        batch = max_rows_per_batch(layout.row_size)
    out = [_pack(table, layout, 0, min(batch, n))]
    for start in range(batch, n, batch):
        out.append(_pack(table, layout, start, min(start + batch, n)))
    return out


def column_bytes_to_storage(raw: torch.Tensor, d: dt.DType) -> torch.Tensor:
    """(n, width) little-endian bytes -> the storage tensor of ``d``."""
    if d.is_boolean:
        return raw[:, 0] != 0
    vals = raw.contiguous().view(d.storage_dtype)
    if d.id == dt.TypeId.DECIMAL128:
        return vals  # (n, 2) limbs
    return vals.reshape(raw.shape[0])


def from_rows(
    packed,
    dtypes: Optional[Sequence[dt.DType]] = None,
    names: Optional[Sequence[str]] = None,
) -> Table:
    """Packed rows -> columnar (``convert_from_rows``,
    row_conversion.cu:519-575). A column with no nulls gets validity
    None, as in the JAX package."""
    if isinstance(packed, PackedRows):
        packed = [packed]
    if not packed:
        raise ValueError("no row batches")
    layout = packed[0].layout
    if dtypes is not None:
        want = compute_fixed_width_layout(dtypes)
        if (want.row_size != layout.row_size
                or want.column_offsets != layout.column_offsets):
            raise ValueError(
                "schema layout does not match the packed row size "
                f"({want.row_size} != {layout.row_size})"
            )
        layout = want
    # each batch's kernel writes every column's validity vector and adds
    # up its nulls
    parts = [rt.unpack_rows_columns(p.data, layout) for p in packed]
    nulls = (parts[0][2] if len(parts) == 1
             else torch.stack([p[2] for p in parts]).sum(0))
    has_nulls = [k != 0 for k in nulls.tolist()]  # one host sync

    def joined(k: int, i: int) -> torch.Tensor:
        pieces = [p[k][i] for p in parts]
        return torch.cat(pieces) if len(pieces) > 1 else pieces[0]

    columns = [
        Column(column_bytes_to_storage(joined(0, i), d), d,
               joined(1, i) if has_nulls[i] else None)
        for i, d in enumerate(layout.dtypes)
    ]
    return Table(columns, names)


def to_rows_list(table: Table) -> Column:
    """Packed rows as a LIST<UINT8> column: every list is one row of
    ``row_size`` bytes (row_conversion.cu:389-406). Rows pack
    independently, so the one buffer equals the 2 GB batches of
    :func:`to_rows` joined, and is packed by one kernel call."""
    layout = compute_fixed_width_layout(table.dtypes())
    data = _pack(table, layout, 0, table.row_count).data
    lengths = torch.full((data.shape[0],), data.shape[1], dtype=torch.int32,
                         device=data.device)
    return Column(data, dt.LIST, None, lengths)


def from_rows_list(
    col: Column,
    dtypes: Sequence[dt.DType],
    names: Optional[Sequence[str]] = None,
) -> Table:
    """Inverse of :func:`to_rows_list`."""
    if col.dtype.id != dt.TypeId.LIST:
        raise TypeError("from_rows_list expects a LIST column")
    layout = compute_fixed_width_layout(dtypes)
    if col.data.ndim != 2 or col.data.shape[1] != layout.row_size:
        raise ValueError(
            f"packed list width {tuple(col.data.shape[1:])} != row size "
            f"{layout.row_size}"
        )
    # every list must be exactly one full, non-null row
    if col.validity is not None and not bool(col.validity.all()):
        raise ValueError("packed-rows list column must have no nulls")
    if not bool((col.lengths == layout.row_size).all()):
        raise ValueError(
            f"every packed row must be exactly {layout.row_size} bytes"
        )
    data = col.data
    if data.dtype != torch.uint8:
        data = data.view(torch.uint8) if data.element_size() == 1 else data.to(torch.uint8)
    return from_rows(PackedRows(data.contiguous(), layout), dtypes, names)
