"""Quantiles (port of ``ops/quantiles.py``: cudf ``quantile``, LINEAR /
LOWER / HIGHER / MIDPOINT / NEAREST interpolation, null-excluding).

One device sort with nulls exiled past the end, then index arithmetic
against the device-resident valid count: no host sync. The sort is the
JAX package's ``jnp.sort``: stable, on order words
(``keys._float_order``) of the values with every zero, -0.0 and the
subnormals included, read as +0.0 (JAX canonicalizes -0.0 for the
compare, and its CPU code reads subnormals as zero), so a run of such
values keeps its row order.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import dtype as dt
from ..column import Column
from . import compute
from .keys import _float_order

LINEAR = "linear"
LOWER = "lower"
HIGHER = "higher"
MIDPOINT = "midpoint"
NEAREST = "nearest"



def _sorted_f64(vals: torch.Tensor) -> torch.Tensor:
    """float64 values sorted as ``jnp.sort`` sorts them (NaN excluded
    upstream)."""
    zero = compute.flush_subnormal(vals) == 0
    bits = torch.where(zero, 0, vals.view(torch.int64))
    perm = torch.sort(_float_order(bits, 64), stable=True).indices
    return vals[perm]


def quantile(
    col: Column, qs: Sequence[float], interpolation: str = LINEAR
) -> Column:
    """FLOAT64 column of one quantile per entry of ``qs`` (null when the
    input has no valid rows)."""
    if interpolation not in (LINEAR, LOWER, HIGHER, MIDPOINT, NEAREST):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if not (col.dtype.is_numeric or col.dtype.is_timestamp):
        raise TypeError(f"quantile: numeric input required, got {col.dtype}")
    qs = list(qs)
    if any(not (0.0 <= float(q) <= 1.0) for q in qs):
        raise ValueError(f"quantile fractions must be in [0, 1], got {qs}")
    flush = compute.flush_subnormal
    vals = compute.values(col)
    if vals.dtype == torch.float32:
        vals = flush(vals)  # XLA's convert reads subnormals as zero
    vals = compute.astype(vals, torch.float64)
    if col.dtype.is_decimal:
        vals = flush(vals * (10.0 ** col.dtype.scale))
    # NaNs are excluded like nulls (pandas/cudf null-excluding quantile)
    valid = compute.valid_mask(col) & ~torch.isnan(vals)
    # nulls sort past every real value; n_valid bounds the index range
    sorted_vals = _sorted_f64(torch.where(valid, vals, torch.inf))
    n_valid = valid.sum().to(torch.float64)

    q = torch.tensor(qs, dtype=torch.float64)
    if vals.is_cuda:  # staged pinned: an asynchronous copy, no host sync
        q = q.pin_memory().to(vals.device, non_blocking=True)
    top = (n_valid - 1).clamp(min=0)
    pos = q * top
    # clamp to the valid region: indices past n_valid-1 read the exiles
    max_i = top.to(torch.int32)
    lo = torch.minimum(torch.floor(pos).to(torch.int32).clamp(min=0), max_i)
    hi = torch.minimum(torch.ceil(pos).to(torch.int32).clamp(min=0), max_i)
    if sorted_vals.shape[0] == 0:
        # 0 rows: the JAX package's gather raises; the port returns nulls
        sorted_vals = sorted_vals.new_zeros(1)
    vlo = sorted_vals[lo.long()]
    vhi = sorted_vals[hi.long()]
    if interpolation == LINEAR:
        frac = pos - torch.floor(pos)
        a, b = flush(vlo), flush(vhi)  # XLA's CPU code reads them so
        out = flush(a + flush(flush(b - a) * frac))
    elif interpolation == LOWER:
        out = vlo
    elif interpolation == HIGHER:
        out = vhi
    elif interpolation == MIDPOINT:
        out = flush(flush(flush(vlo) + flush(vhi)) * 0.5)
    else:  # NEAREST
        out = torch.where(pos - torch.floor(pos) <= 0.5, vlo, vhi)
    has = (n_valid > 0).expand(out.shape)
    return compute.from_values(out, dt.FLOAT64, has.clone())
