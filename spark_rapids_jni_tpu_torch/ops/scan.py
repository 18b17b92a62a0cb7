"""Cumulative scans (port of ``ops/scan.py``: cudf ``scan``,
SUM/MIN/MAX/PRODUCT, inclusive or exclusive, null-excluding).

Null rows emit null and do not contribute: a masked identity
substitution before one associative scan. Floats run
:func:`associative_scan`, the JAX package's own odd/even recursion
(``lax.associative_scan``) written out elementwise: the same adds in the
same order, so the same bytes on the CPU and on the card. Integers are
exact in any order: sums and products by ``torch.cumsum``/``cumprod``
(wrapping to the width), min/max by the same recursion (torch's
``cummax`` on CUDA computes indices too and is far slower).
"""

from __future__ import annotations

import numpy as np
import torch

from ..column import Column
from . import compute

_AGGS = ("sum", "product", "min", "max")


def _float_op(agg: str):
    flush = compute.flush_subnormal
    if agg == "sum":
        return lambda a, b: flush(flush(a) + flush(b))
    if agg == "product":
        return lambda a, b: flush(flush(a) * flush(b))
    return compute.float_minimum if agg == "min" else compute.float_maximum


def associative_scan(x: torch.Tensor, op) -> torch.Tensor:
    """``lax.associative_scan(op, x)`` for a 1-D tensor: combine adjacent
    pairs, scan the pairs recursively, combine the odd results with the
    even inputs, and interleave. JAX interleaves floats by adding two
    zero-padded halves, so from 2 elements on every float result is
    ``flush(v) + 0.0`` (-0.0 comes out +0.0); a single element is
    returned as it is. log2(n) levels of a few elementwise launches."""
    n = x.shape[0]
    if n < 2:
        return x
    odd = associative_scan(op(x[0:-1:2], x[1::2]), op)
    if n % 2 == 0:
        even = op(odd[:-1], x[2::2])
    else:
        even = op(odd, x[2::2])
    out = torch.empty_like(x)
    out[0] = x[0]
    out[2::2] = even
    out[1::2] = odd
    if not out.is_floating_point():
        return out
    return compute.flush_subnormal(out) + 0.0


def _identity_for(agg: str, dtype: torch.dtype):
    if agg == "sum":
        return 0
    if agg == "product":
        return 1
    if dtype == torch.bool:
        return agg == "min"  # min identity True, max identity False
    info = (np.finfo if dtype.is_floating_point else np.iinfo)(
        compute.NP_OF[dtype])
    return info.max if agg == "min" else info.min


def _int_scan(vals: torch.Tensor, agg: str) -> torch.Tensor:
    """Integer (and bool) scans, exact: sums and products in int64 wrap
    to the width; min/max on order-preserving int64 words."""
    dtype = vals.dtype
    if dtype == torch.bool:
        # jnp.add / jnp.multiply on bools are OR / AND
        fn = torch.maximum if agg in ("sum", "max") else torch.minimum
        return associative_scan(vals.to(torch.int8), fn) != 0
    if agg in ("min", "max"):
        out = associative_scan(compute.int_order_word(vals),
                               torch.minimum if agg == "min" else torch.maximum)
        return compute.from_int_order_word(out, dtype)
    w = compute.as_int64(vals)
    out = torch.cumsum(w, 0) if agg == "sum" else torch.cumprod(w, 0)
    if dtype == torch.uint64:
        return out.view(torch.uint64)
    return compute.from_carrier(out, dtype)


def scan(col: Column, agg: str, inclusive: bool = True) -> Column:
    """Running aggregate down the column. Output dtype == input dtype
    (cudf scan contract); null rows are excluded and stay null."""
    if agg not in _AGGS:
        raise ValueError(f"unknown scan aggregation {agg!r}")
    vals = compute.values(col)
    ident = compute.astype(compute.scalar_tensor(
        _identity_for(agg, vals.dtype)), vals.dtype)
    if col.validity is not None:
        vals = torch.where(col.validity, vals, ident)
    if vals.shape[0] == 0:
        out = vals
    elif vals.is_floating_point():
        out = associative_scan(vals, _float_op(agg))
    else:
        out = _int_scan(vals, agg)
    if not inclusive:
        # exclusive scan: shift right, seed with identity
        out = torch.cat([ident.reshape(1).to(out.device), out[:-1]])
    return compute.from_values(out, col.dtype, col.validity)
