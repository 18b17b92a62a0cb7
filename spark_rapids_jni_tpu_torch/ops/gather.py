"""Gather / take (port of ``ops/gather.py``): row selection by index."""

from __future__ import annotations

from typing import Optional

import torch

from ..column import Column, Table


def take_rows(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``data[indices]`` along the rows. DECIMAL128's ``(n, 2)`` int64
    limbs gather as one complex128 (16-byte) element a row: torch's row
    gather of a two-column int64 matrix runs a kernel many times slower
    than its gather of a vector (``chip_smoke.py`` (l), PERF.md)."""
    if (data.dim() == 2 and data.shape[1] == 2 and data.dtype == torch.int64
            and data.is_contiguous()):
        pairs = data.view(torch.complex128).view(-1)
        return pairs[indices].view(torch.int64).view(-1, 2)
    return data[indices]


def gather_column(
    col: Column,
    indices: torch.Tensor,
    index_valid: Optional[torch.Tensor] = None,
) -> Column:
    """col[indices]; rows where ``index_valid`` is False become null.
    Indices must be in range (the port has no clamped padding rows)."""
    data = take_rows(col.data, indices)
    lengths = None if col.lengths is None else col.lengths[indices]
    valid = None if col.validity is None else col.validity[indices]
    if index_valid is not None:
        valid = index_valid if valid is None else valid & index_valid
    return Column(data, col.dtype, valid, lengths)


def gather_table(
    table: Table,
    indices: torch.Tensor,
    index_valid: Optional[torch.Tensor] = None,
) -> Table:
    return Table(
        [gather_column(c, indices, index_valid) for c in table.columns],
        table.names,
    )
