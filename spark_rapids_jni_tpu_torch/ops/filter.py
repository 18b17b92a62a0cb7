"""Filter (port of ``ops/filter.py``, cudf ``apply_boolean_mask``).

Kept rows are compacted in order: the exact filter takes the stable
indices from ``torch.nonzero`` (it sizes its output on the host anyway),
the capped one builds them with a cumsum and a scatter, as the JAX
package does, without a host read.
"""

from __future__ import annotations

import torch

from ..column import Column, Table
from .gather import gather_table


def _selection_mask(mask: Column) -> torch.Tensor:
    """Spark WHERE keeps rows where the predicate is TRUE (not null)."""
    if not mask.dtype.is_boolean:
        raise TypeError("filter mask must be BOOL8")
    keep = mask.data
    if mask.validity is not None:
        keep = keep & mask.validity
    return keep


def _compact_index(keep: torch.Tensor, capacity: int) -> torch.Tensor:
    """The kept rows' indices in order, then zeros, to ``capacity``
    entries without a host read: each kept row scatters its index to its
    rank (the JAX package's cumsum and scatter); the rest land in one
    dropped slot."""
    rank = torch.cumsum(keep, 0) - 1
    slot = torch.where(keep & (rank < capacity), rank, capacity)
    idx = torch.zeros(capacity + 1, dtype=torch.int64, device=keep.device)
    idx.scatter_(0, slot, torch.arange(keep.shape[0], device=keep.device))
    return idx[:capacity]


def filter_table_capped(
    table: Table, mask: Column, capacity: int
) -> tuple[Table, torch.Tensor]:
    """(table of ``capacity`` rows, device count). Rows past the count
    repeat row 0, as the JAX package's zero-initialised index vector
    does; consumers must respect the count."""
    keep = _selection_mask(mask)
    return (gather_table(table, _compact_index(keep, capacity)),
            keep.sum().to(torch.int32))


def filter_table(table: Table, mask: Column) -> Table:
    """Filter with an exact output size (one host sync for the count)."""
    keep = _selection_mask(mask)
    idx = torch.nonzero(keep).flatten()
    if idx.numel() == table.row_count:
        return table
    return gather_table(table, idx)
