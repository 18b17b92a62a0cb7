"""Column reductions (port of ``ops/reductions.py``: cudf ``reduce``),
null-skipping Spark aggregates returned as 1-row columns (so a null
result, e.g. SUM over an all-null column, is representable).

Float sums and products run in one fixed order of elementwise steps, so
the CPU and the card give the same bytes: a sum is the last element of
the running sum in XLA's scan order (``groupby._cumsum``: the scan16
kernel on CUDA, its plain version on the CPU), a product a pairwise
tree. The JAX package's ``jnp.sum``/``jnp.prod`` run XLA's reduce,
whose order is its own, so float sums, means, variances and products
agree with it within rounding (ROADMAP Queue 3); every other result is
the same bytes. Subnormals are read and written as zero wherever the JAX
package's CPU code reads or writes them so.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column
from . import compute

_REDUCTIONS = {
    "sum", "min", "max", "mean", "count", "any", "all", "product",
    "variance", "std",
}


def float_sum(v: torch.Tensor) -> torch.Tensor:
    """0-d sum of a float64 vector in XLA's scan order (the last running
    sum of ``groupby._cumsum``); 0 rows sum to +0.0, 1 row is itself."""
    from .groupby import _cumsum

    if v.shape[0] == 0:
        return v.new_zeros(())
    return _cumsum(v, None)[-1]


def float_product(v: torch.Tensor) -> torch.Tensor:
    """0-d product of a float64 vector as a pairwise tree (level by
    level, odd tails padded with 1.0), subnormals flushed as XLA's CPU
    code flushes them; 0 rows give 1.0, 1 row is itself."""
    flush = compute.flush_subnormal
    if v.shape[0] == 0:
        return v.new_ones(())
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = torch.cat([v, v.new_ones(1)])
        v = flush(flush(v[0::2]) * flush(v[1::2]))
    return v[0]


def _as_f64(vals: torch.Tensor) -> torch.Tensor:
    """``vals.astype(float64)`` as XLA's CPU code converts: FLOAT32
    subnormals read as zero; FLOAT64 is returned as it is."""
    if vals.dtype == torch.float32:
        vals = compute.flush_subnormal(vals)
    return compute.astype(vals, torch.float64)


def _extreme(masked: torch.Tensor, is_min: bool) -> torch.Tensor:
    """1-element min/max of ``masked`` (n >= 1) as XLA's reduce gives
    it: one row is itself; from two rows on subnormals read as zero,
    -0.0 orders below +0.0 and a NaN wins (the first one)."""
    if masked.shape[0] == 1:
        return masked.clone()
    if masked.is_floating_point():
        f = compute.flush_subnormal(masked)
        from .keys import _float_order

        bits = (f.view(torch.int64) if f.dtype == torch.float64
                else f.view(torch.int32))
        key = _float_order(bits, 64 if f.dtype == torch.float64 else 32)
        nan = torch.isnan(f)
        key = key.masked_fill(nan, 0)
        idx = (key.argmin() if is_min else key.argmax()).reshape(1)
        first_nan = nan.to(torch.int8).argmax().reshape(1)
        return torch.where(nan.any(), f[first_nan], f[idx])
    w = compute.int_order_word(masked)
    out = (w.amin() if is_min else w.amax()).reshape(1)
    return compute.from_int_order_word(out, masked.dtype)


def reduce(col: Column, op: str) -> Column:
    """Null-skipping reduction to a 1-row column."""
    if op not in _REDUCTIONS:
        raise ValueError(f"unknown reduction {op!r}")
    valid = compute.valid_mask(col)
    n_valid = valid.sum()

    if op == "count":
        return Column(n_valid.to(torch.int64).reshape(1), dt.INT64, None)

    if op in ("any", "all"):
        if not col.dtype.is_boolean:
            raise TypeError(f"{op} requires BOOL8")
        if op == "any":
            out = (col.data & valid).any()
        else:
            out = torch.where(valid, col.data, True).all()
        return Column(out.reshape(1), dt.BOOL8, (n_valid > 0).reshape(1))

    vals = compute.values(col)
    has_result = (n_valid > 0).reshape(1)
    floating = col.dtype.is_floating

    if op in ("sum", "mean"):
        if floating:
            acc = _as_f64(torch.where(valid, vals, 0))
            total = float_sum(acc)
        else:
            total = compute.as_int64(torch.where(valid, vals, 0)).sum()
        if op == "mean":
            mean = compute.flush_subnormal(compute.flush_subnormal(
                compute.astype(total, torch.float64)) / n_valid.clamp(min=1))
            if col.dtype.is_decimal:
                mean = compute.flush_subnormal(mean * (10.0 ** col.dtype.scale))
            return compute.from_values(mean.reshape(1), dt.FLOAT64, has_result)
        if floating:
            return compute.from_values(total.reshape(1), dt.FLOAT64,
                                       has_result)
        if col.dtype.is_decimal:
            # Spark widens decimal SUM; keep scale, widen storage to 64-bit.
            out_dt = dt.DType(dt.TypeId.DECIMAL64, col.dtype.scale)
            return compute.from_values(total.reshape(1), out_dt, has_result)
        return compute.from_values(total.reshape(1), dt.INT64, has_result)

    if op in ("variance", "std"):
        # sample variance (ddof=1), cudf/Spark default; null when fewer
        # than 2 valid rows
        flush = compute.flush_subnormal
        fvals = _as_f64(vals)
        if col.dtype.is_decimal:
            fvals = flush(fvals * (10.0 ** col.dtype.scale))
        m = flush(flush(float_sum(torch.where(valid, fvals, 0.0)))
                  / n_valid.clamp(min=1))
        dev = flush(flush(fvals) - m)
        sq = float_sum(torch.where(valid, flush(dev * dev), 0.0))
        var = flush(flush(sq) / (n_valid - 1).clamp(min=1)).reshape(1)
        out = compute.sqrt_rn(var) if op == "std" else var
        return compute.from_values(out, dt.FLOAT64,
                                   (n_valid > 1).reshape(1))

    if op == "product":
        acc = torch.where(valid, vals, 1)
        if floating:
            total = float_product(_as_f64(acc))
        else:
            total = compute.as_int64(acc).prod()
        out_dt = dt.FLOAT64 if floating else dt.INT64
        return compute.from_values(total.reshape(1), out_dt, has_result)

    # min / max with +-inf / int extremes as masked sentinels
    if floating:
        sentinel = np.inf if op == "min" else -np.inf
    elif col.dtype.is_boolean:
        sentinel = op == "min"
    else:
        info = np.iinfo(col.dtype.value_dtype)
        sentinel = info.max if op == "min" else info.min
    fill = compute.astype(compute.scalar_tensor(sentinel), vals.dtype)
    if vals.shape[0] == 0:
        # an empty reduction is simply null (has_result is already False)
        out = fill.reshape(1).to(vals.device)
    else:
        out = _extreme(torch.where(valid, vals, fill), op == "min")
    return compute.from_values(out, col.dtype, has_result)


def arg_extreme(col: Column, op: str) -> Column:
    """Row index of the min/max valid value (``argmin``/``argmax``; the
    index half of Spark's ``min_by``/``max_by``). 1-row INT64 column;
    null when every value is null. Ties resolve to the earliest row.

    Two passes over the order words, not a sentinel argmin: pass 1 takes
    the min masked word, pass 2 the earliest VALID row holding it."""
    from . import keys as keys_mod

    if op not in ("argmin", "argmax"):
        raise ValueError(f"arg_extreme: unknown op {op!r}")
    words = keys_mod.column_order_keys(col)
    if len(words) != 1:
        raise TypeError(
            f"arg_extreme: unsupported by-column type {col.dtype} "
            "(single-word order keys only)"
        )
    valid = compute.valid_mask(col)
    key = words[0] if op == "argmin" else ~words[0]
    masked = torch.where(valid, key, keys_mod.CARRIER_MAX)
    hit = valid & (masked == masked.min())
    idx = hit.to(torch.int8).argmax().to(torch.int64)
    return Column(idx.reshape(1), dt.INT64, valid.any().reshape(1))


def extreme_by(value_col: Column, by_col: Column, op: str) -> Column:
    """Spark ``min_by``/``max_by``: the value of ``value_col`` at the
    row where ``by_col`` is minimal/maximal. 1-row column of
    ``value_col``'s type."""
    from .gather import gather_column

    if op not in ("min_by", "max_by"):
        raise ValueError(f"extreme_by: unknown op {op!r}")
    which = "argmin" if op == "min_by" else "argmax"
    idx = arg_extreme(by_col, which)
    return gather_column(value_col, idx.data, index_valid=idx.validity)
