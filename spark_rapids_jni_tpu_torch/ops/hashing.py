"""Spark-compatible Murmur3 hashing (port of ``ops/hashing.py``).

Bit for bit Spark's ``Murmur3Hash`` with seed 42 over fixed-width
columns: the hash ``HashPartitioning`` places rows by. The arithmetic
lives once, in ``kernels/hashing.py``: CUDA tensors go to kernel K5, CPU
tensors to its plain version. String keys wait for the strings slice.
"""

from __future__ import annotations

import torch

from .. import dtype as dt
from ..column import Column, Table
from ..kernels import hashing as khash

DEFAULT_SEED = khash.DEFAULT_SEED


def _check_keys(cols) -> None:
    from ..runtime_bridge import UnsupportedOpError

    for c in cols:
        if c.dtype.is_string:
            raise UnsupportedOpError("Murmur3 of STRING keys is not ported yet")
        if not c.dtype.is_fixed_width or c.dtype.id == dt.TypeId.DECIMAL128:
            raise UnsupportedOpError(
                f"Murmur3 of {c.dtype.id.name} keys is not ported yet")


def murmur3_column(col: Column, seed: int = DEFAULT_SEED) -> Column:
    """Per-row Spark Murmur3 of one column -> INT32 column (never null)."""
    return murmur3_table(Table([col]), None, seed)


def murmur3_table(table: Table, columns=None,
                  seed: int = DEFAULT_SEED) -> Column:
    """Spark multi-column hash: h chains through the key columns left to
    right (all columns when ``columns`` is None)."""
    cols = ([table.column(c) for c in columns] if columns is not None
            else list(table.columns))
    _check_keys(cols)
    if not cols:
        dev = table.columns[0].data.device if table.columns else "cpu"
        h = torch.full((table.row_count,), seed & 0xFFFFFFFF,
                       dtype=torch.int64, device=dev)
        return Column(((h ^ 2**31) - 2**31).to(torch.int32), dt.INT32, None)
    # the kernel reads each buffer as a dense vector
    dense = [Column(c.data.contiguous(), c.dtype,
                    None if c.validity is None else c.validity.contiguous())
             for c in cols]
    return Column(khash.murmur3_columns(dense, seed), dt.INT32, None)
