"""Copy-family ops (port of ``ops/copying.py``, cudf ``concatenate`` /
``interleave_columns`` / ``copy_if_else`` / ``sequence`` /
``cross_join`` / ``scatter`` / ``slice`` / ``split`` / ``repeat`` /
``sample``), over fixed-width, STRING and LIST columns.

``sample`` draws the JAX package's rows bit for bit: its PRNG is JAX's
threefry2x32 (``jax.random.PRNGKey``, ``permutation`` and ``randint``
under ``jax_threefry_partitionable``, JAX 0.9.0's default), written here
on int64 tensors carrying u32 words. The rows depend on the seed only,
never on the device.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column, Table
from . import compute
from .gather import gather_table


def _names(table: Table, prefix: str) -> list:
    return (list(table.names) if table.names
            else [f"{prefix}{i}" for i in range(table.num_columns)])


def concatenate_columns(cols: Sequence[Column]) -> Column:
    """Vertical concatenation of same-dtype columns. A validity vector
    comes out when any input has one; STRING columns are repadded to the
    widest pad first; STRING and LIST columns keep their lengths."""
    if not cols:
        raise ValueError("concatenate needs at least one column")
    d = cols[0].dtype
    for c in cols[1:]:
        if c.dtype != d:
            raise TypeError(f"concatenate dtype mismatch: {d} vs {c.dtype}")
    if d.is_string:
        from .strings import common_pad

        cols = common_pad(cols)
    data = torch.cat([c.data for c in cols], 0)
    lengths = None
    if d.id == dt.TypeId.LIST or d.is_string:
        lengths = torch.cat([c.lengths for c in cols])
    valid = None
    if any(c.validity is not None for c in cols):
        valid = torch.cat([compute.valid_mask(c) for c in cols])
    return Column(data, d, valid, lengths)


def concatenate(tables: Sequence[Table]) -> Table:
    """Vertical concatenation of same-schema tables (the first table's
    names)."""
    if not tables:
        raise ValueError("concatenate needs at least one table")
    first = tables[0]
    for t in tables[1:]:
        if t.num_columns != first.num_columns:
            raise ValueError("concatenate: column counts differ")
    out = [concatenate_columns([t.columns[i] for t in tables])
           for i in range(first.num_columns)]
    return Table(out, first.names)


def interleave_columns(table: Table) -> Column:
    """Row-major interleave of same-dtype columns: output row i*ncols+j is
    column j's row i."""
    d = table.columns[0].dtype
    for c in table.columns[1:]:
        if c.dtype != d:
            raise TypeError("interleave_columns needs uniform dtype")
    if not d.is_fixed_width:
        raise TypeError("interleave_columns: fixed-width only")
    data = torch.stack([c.data for c in table.columns], 1).reshape(-1)
    valid = None
    if any(c.validity is not None for c in table.columns):
        valid = torch.stack([compute.valid_mask(c) for c in table.columns],
                            1).reshape(-1)
    return Column(data, d, valid)


def copy_if_else(mask: Column, lhs, rhs) -> Column:
    """Per row: lhs where the mask is TRUE, else rhs (a null mask row
    takes rhs, Spark's CASE WHEN). A Python scalar side is broadcast."""
    if not mask.dtype.is_boolean:
        raise TypeError("copy_if_else mask must be BOOL8")
    pred = mask.data
    if mask.validity is not None:
        pred = pred & mask.validity
    n = mask.row_count

    def as_column(x, like):
        if isinstance(x, Column):
            return x
        if like is None:
            raise TypeError("copy_if_else: both sides scalar is ambiguous")
        wide = torch.float64 if isinstance(x, float) else torch.int64
        return compute.from_values(
            torch.full((n,), x, dtype=wide, device=pred.device), like.dtype,
            None)

    lhs_col = as_column(lhs, rhs if isinstance(rhs, Column) else None)
    rhs_col = as_column(rhs, lhs_col)
    if lhs_col.dtype != rhs_col.dtype:
        raise TypeError(
            f"copy_if_else dtype mismatch: {lhs_col.dtype} vs {rhs_col.dtype}")
    lengths = None
    if lhs_col.dtype.is_string:
        from .strings import common_pad

        lhs_col, rhs_col = common_pad([lhs_col, rhs_col])
        data = torch.where(pred[:, None], lhs_col.data, rhs_col.data)
        lengths = torch.where(pred, lhs_col.lengths, rhs_col.lengths)
    else:
        data = torch.where(pred, lhs_col.data, rhs_col.data)
    valid = None
    if lhs_col.validity is not None or rhs_col.validity is not None:
        valid = torch.where(pred, compute.valid_mask(lhs_col),
                            compute.valid_mask(rhs_col))
    return Column(data, lhs_col.dtype, valid, lengths)


def sequence(n: int, start=0, step=1, dtype: dt.DType = dt.INT32,
             device="cuda") -> Column:
    """Arithmetic sequence column ``start + step * i``."""
    from ..column import resolve_device

    vals = start + step * torch.arange(n, dtype=torch.int64,
                                       device=resolve_device(device))
    return compute.from_values(vals, dtype, None)


def cross_join(left: Table, right: Table) -> Table:
    """Cartesian product, left-major: every left row with every right
    row."""
    nl, nr = left.row_count, right.row_count
    dev = (left.columns or right.columns)[0].data.device
    li = torch.arange(nl, device=dev).repeat_interleave(nr)
    ri = torch.arange(nr, device=dev).repeat(nl)
    return Table(list(gather_table(left, li).columns)
                 + list(gather_table(right, ri).columns),
                 _names(left, "l") + _names(right, "r"))


def scatter(source: Table, indices, target: Table) -> Table:
    """``target`` with ``source``'s rows written at ``indices``. Which of
    two duplicate indices wins is unspecified, as in cudf."""
    if source.num_columns != target.num_columns:
        raise ValueError("scatter: column counts differ")
    dev = target.columns[0].data.device
    idx = torch.as_tensor(np.asarray(indices), device=dev).to(torch.int64)
    out = []
    for s, t in zip(source.columns, target.columns):
        if s.dtype != t.dtype:
            raise TypeError(f"scatter dtype mismatch: {s.dtype} vs {t.dtype}")
        if s.dtype.is_string:
            from .strings import common_pad

            s, t = common_pad([s, t])
        data = t.data.clone()
        data[idx] = s.data
        valid = None
        if s.validity is not None or t.validity is not None:
            valid = compute.valid_mask(t).clone()
            valid[idx] = compute.valid_mask(s)
        lengths = t.lengths
        if lengths is not None:
            lengths = lengths.clone()
            lengths[idx] = s.lengths
        out.append(Column(data, t.dtype, valid, lengths))
    return Table(out, target.names)


def slice_rows(table: Table, start: int, stop: int) -> Table:
    """The rows [start, stop) of every column, without a copy."""
    return Table(
        [Column(c.data[start:stop], c.dtype,
                None if c.validity is None else c.validity[start:stop],
                None if c.lengths is None else c.lengths[start:stop])
         for c in table.columns],
        table.names,
    )


def split(table: Table, splits: Sequence[int]) -> list:
    """Rows cut at the given boundaries: ``[s1, s2]`` gives [0, s1),
    [s1, s2), [s2, n)."""
    n = table.row_count
    bounds = [0] + [int(s) for s in splits] + [n]
    for a, b in zip(bounds, bounds[1:]):
        if not 0 <= a <= b <= n:
            raise ValueError(f"split: bad boundaries {splits}")
    return [slice_rows(table, a, b) for a, b in zip(bounds, bounds[1:])]


def repeat(table: Table, counts) -> Table:
    """Each row i ``counts[i]`` times, in order; a scalar count repeats
    every row that many times."""
    n = table.row_count
    dev = table.columns[0].data.device
    if np.isscalar(counts):
        k = int(counts)
        if k < 0:
            raise ValueError("repeat: count must be non-negative")
        idx = torch.arange(n, device=dev).repeat_interleave(k)
        return gather_table(table, idx)
    c = np.asarray(counts)
    if c.shape != (n,):
        raise ValueError(f"repeat: counts shape {c.shape} != ({n},)")
    if (c < 0).any():
        raise ValueError("repeat: counts must be non-negative")
    idx = torch.from_numpy(np.repeat(np.arange(n, dtype=np.int64), c)).to(dev)
    return gather_table(table, idx)


# ---------------------------------------------------------------------------
# sample: JAX's threefry2x32 PRNG on int64 tensors carrying u32 words
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (JAX ``prng.threefry2x32``): the two
    u32 key words (Python ints) and two count tensors (u32 in int64) ->
    the two u32 output words."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` with 64-bit integers on: the seed's
    int64 bit pattern as (high word, low word)."""
    s = int(np.int64(seed)) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32, s & _M32)


def _counts(n: int, device):
    """``iota_2x32_shape((n,))``: the (high, low) u32 words of 0..n-1."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def _split(key) -> tuple:
    """``jax.random.split(key)`` under the partitionable layout: keys i =
    threefry(key, (0, i)) for i = 0, 1."""
    hi, lo = _counts(2, "cpu")
    b0, b1 = threefry2x32(key, hi, lo)
    return (int(b0[0]), int(b1[0])), (int(b0[1]), int(b1[1]))


def random_bits32(key, n: int, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: the two threefry words of
    each count, XORed (u32 in int64)."""
    hi, lo = _counts(n, device)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def permutation(key, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (JAX ``_shuffle``): ceil(3 ln n /
    ln(2^32 - 1)) rounds, each a split and a stable sort of the rows by 32
    fresh random bits."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_M32)))
    for _ in range(rounds):
        key, sub = _split(key)
        order = torch.sort(random_bits32(sub, n, device), stable=True).indices
        x = x[order]
    return x


def _random_bits64(key, n: int, device) -> tuple:
    """``random_bits(key, 64, (n,))`` as its (high, low) u32 words."""
    hi, lo = _counts(n, device)
    return threefry2x32(key, hi, lo)


def randint(key, n: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint(key, (n,), 0, maxval)`` with 64-bit integers
    (JAX ``_randint``): two 64-bit draws a row, ``(hi % span) * (2^64 %
    span) + lo % span``, mod the span. A 64-bit draw ``h * 2^32 + l`` is
    taken mod the span as ``((h % span) * (2^32 % span) + l) % span``;
    the span stays below 2^31, so every product fits int64."""
    span = max(int(maxval), 1)
    if span >= 1 << 31:
        raise ValueError(f"sample: {span} rows over the 2^31 span bound")
    m32 = (1 << 32) % span

    def draw(k):
        h, lo = _random_bits64(k, n, device)
        return ((h % span) * m32 + lo) % span

    k1, k2 = _split(key)
    return (draw(k1) * ((m32 * m32) % span) + draw(k2)) % span


def sample(table: Table, n: int, seed: int = 0,
           replacement: bool = False) -> Table:
    """``n`` random rows keyed by ``seed``: the JAX package's rows (a
    threefry permutation's first ``n``, or ``randint`` draws with
    replacement)."""
    rows = table.row_count
    dev = table.columns[0].data.device
    key = prng_key(seed)
    if replacement:
        if rows == 0 and n > 0:
            raise ValueError("sample with replacement from an empty table")
        idx = randint(key, n, max(rows, 1), dev)
    else:
        if n > rows:
            raise ValueError(f"sample of {n} from {rows} rows")
        idx = permutation(key, rows, dev)[:n]
    return gather_table(table, idx)
