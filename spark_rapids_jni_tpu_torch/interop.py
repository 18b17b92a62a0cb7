"""Host storage buffers <-> port tables: the carry-across function.

A column travels as the tuple ``(data, validity, lengths, type_id,
scale)`` of numpy buffers in the JAX package's storage layout (FLOAT64 as
uint64 bits, BOOL8 as bool, LIST as an ``(n, pad)`` child matrix and
STRING as an ``(n, pad)`` uint8 byte matrix, each plus int32 lengths,
validity as a bool vector or None). Feeding
``np.asarray`` of every buffer of a JAX ``Column`` through
:func:`table_from_buffers` gives a port table over the same bytes, and
:func:`table_to_buffers` gives them back for a byte-for-byte comparison.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import dtype as dt
from .column import (
    Column, Table, host_to_storage, resolve_device, storage_to_host,
)

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
