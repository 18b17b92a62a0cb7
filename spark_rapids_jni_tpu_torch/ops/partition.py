"""Partitioning (port of ``ops/partition.py``): the device half of a
shuffle exchange. Each row gets a partition id, rows are reordered so
that partitions are contiguous, and per-partition counts are reported.

``hash_partition`` uses Spark's ``Pmod(Murmur3Hash(keys), n)``, so rows
land on the partition ids a Spark cluster computes. The reorder is a
stable sort of the int32 ids plus a ``bincount``, outside any kernel, as
in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..column import Table
from .gather import gather_table
from .hashing import murmur3_table
from .sort import SortKey, _key_words


def partition_ids_hash(
    table: Table,
    columns: Optional[Sequence[Union[int, str]]],
    num_partitions: int,
) -> torch.Tensor:
    """Spark HashPartitioning ids: pmod(murmur3(keys), n), int32."""
    h = murmur3_table(table, columns).data.to(torch.int64)
    return torch.remainder(h, num_partitions).to(torch.int32)


def _reorder_by_parts(
    table: Table, part: torch.Tensor, num_partitions: int
) -> tuple[Table, torch.Tensor]:
    order = torch.sort(part, stable=True).indices
    counts = torch.bincount(part, minlength=num_partitions).to(torch.int32)
    return gather_table(table, order), counts


def hash_partition(
    table: Table,
    columns: Optional[Sequence[Union[int, str]]],
    num_partitions: int,
) -> tuple[Table, torch.Tensor]:
    """(rows reordered partition-contiguously, per-partition counts)."""
    part = partition_ids_hash(table, columns, num_partitions)
    return _reorder_by_parts(table, part, num_partitions)


def round_robin_partition(
    table: Table, num_partitions: int, start_partition: int = 0
) -> tuple[Table, torch.Tensor]:
    n = table.row_count
    dev = table.columns[0].data.device
    part = torch.remainder(
        torch.arange(n, dtype=torch.int64, device=dev) + start_partition,
        num_partitions,
    ).to(torch.int32)
    return _reorder_by_parts(table, part, num_partitions)


def _table_words(table: Table, columns) -> list:
    words = []
    for c in columns:
        words.extend(_key_words(table.column(c), SortKey(c)))
    return words


def range_splitters(
    table: Table,
    columns: Sequence[Union[int, str]],
    num_partitions: int,
    sample_size: int = 8192,
) -> list:
    """P-1 range splitters from a deterministic host-side key sample.

    Spark's RangePartitioning boundaries: sample the sort-key order words
    at a fixed stride, lexsort the sample and cut it into
    ``num_partitions`` equal runs. The words are the port's int64
    carriers, whose signed order is the JAX package's u64 order, so
    ``np.lexsort`` picks the same cut rows."""
    words = _table_words(table, columns)
    n = table.row_count
    stride = max(n // max(sample_size, 1), 1)
    samp = [w[::stride].cpu().numpy() for w in words]
    order = np.lexsort(samp[::-1])
    m = order.shape[0]
    cut = [order[(i * m) // num_partitions] for i in range(1, num_partitions)]
    dev = words[0].device
    return [torch.from_numpy(np.array([s[c] for c in cut], np.int64)).to(dev)
            for s in samp]


def partition_ids_range(
    table: Table,
    columns: Sequence[Union[int, str]],
    splitters: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Range-partition ids from precomputed splitters: the number of
    splitters <= key, lexicographically over the key order words."""
    words = _table_words(table, columns)
    n = table.row_count
    dev = words[0].device
    nsplit = 0 if not splitters else int(splitters[0].shape[0])
    dest = torch.zeros((n,), dtype=torch.int32, device=dev)
    for i in range(nsplit):
        le = torch.zeros((n,), dtype=torch.bool, device=dev)
        eq = torch.ones((n,), dtype=torch.bool, device=dev)
        for w, sp in zip(words, splitters):
            sv = sp[i]
            le = le | (eq & (sv < w))
            eq = eq & (sv == w)
        dest = dest + (le | eq).to(torch.int32)
    return dest


def range_partition(
    table: Table,
    columns: Sequence[Union[int, str]],
    num_partitions: int,
    sample_size: int = 8192,
) -> tuple[Table, torch.Tensor]:
    """(rows reordered partition-contiguously, per-partition counts)."""
    splitters = range_splitters(table, columns, num_partitions, sample_size)
    part = partition_ids_range(table, columns, splitters)
    return _reorder_by_parts(table, part, num_partitions)
