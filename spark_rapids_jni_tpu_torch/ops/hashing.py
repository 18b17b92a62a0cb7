"""Spark-compatible Murmur3 hashing (port of ``ops/hashing.py``).

Bit for bit Spark's ``Murmur3Hash`` with seed 42: the hash
``HashPartitioning`` places rows by. The fixed-width words live once, in
``kernels/hashing.py``: a leading run of fixed-width key columns goes to
kernel K5 on CUDA tensors (its plain version on CPU tensors). A STRING
key, and every key after it, chains on in plain PyTorch ops, as the JAX
package computes strings: one mix a 4-byte block while the block lies
inside the string, then Spark's tail of up to 3 single bytes, each
sign-extended, then ``fmix`` with the byte length: a few small ops for
every 4 bytes of pad.
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
            continue
        if not c.dtype.is_fixed_width or c.dtype.id == dt.TypeId.DECIMAL128:
            raise UnsupportedOpError(
                f"Murmur3 of {c.dtype.id.name} keys is not ported yet")


def _hash_string(col: Column, h: torch.Tensor) -> torch.Tensor:
    """The running hash ``h`` (int64 holding u32) updated by one STRING
    key (null rows keep ``h``)."""
    mat = col.data.to(torch.int64)
    lens = col.lengths.to(torch.int64)
    n, pad = mat.shape
    seed = h
    nblocks = (pad + 3) // 4
    if pad != 4 * nblocks:
        mat = torch.nn.functional.pad(mat, (0, 4 * nblocks - pad))
    words = (mat[:, 0::4] | (mat[:, 1::4] << 8) | (mat[:, 2::4] << 16)
             | (mat[:, 3::4] << 24))
    for w in range(nblocks):
        h = torch.where(lens >= 4 * (w + 1),
                        khash._mix_h1(h, khash._mix_k1(words[:, w])), h)
    # the tail: the last len % 4 bytes, each sign-extended (int8 -> u32)
    tail_from = (lens // 4) * 4
    for k in range(3):
        at = (tail_from + k).clamp(max=mat.shape[1] - 1)
        byte = torch.gather(mat, 1, at[:, None])[:, 0]
        signed = ((byte ^ 0x80) - 0x80) & khash._M32
        h = torch.where(tail_from + k < lens,
                        khash._mix_h1(h, khash._mix_k1(signed)), h)
    h = khash._fmix(h, lens)
    return h if col.validity is None else torch.where(col.validity, h, seed)


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
    lead = next((i for i, c in enumerate(cols) if c.dtype.is_string),
                len(cols))
    if lead:
        # the kernel reads each buffer as a dense vector
        dense = [Column(c.data.contiguous(), c.dtype,
                        None if c.validity is None else c.validity.contiguous())
                 for c in cols[:lead]]
        h = khash.murmur3_columns(dense, seed)
        if lead == len(cols):
            return Column(h, dt.INT32, None)
        h = h.to(torch.int64) & khash._M32
    else:
        h = torch.full((table.row_count,), seed & khash._M32,
                       dtype=torch.int64, device=cols[0].data.device)
    for c in cols[lead:]:
        h = (_hash_string(c, h) if c.dtype.is_string
             else khash.chain_plain(c, h))
    return Column(((h ^ 2**31) - 2**31).to(torch.int32), dt.INT32, None)
