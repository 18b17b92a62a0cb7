"""Type casts (port of ``ops/cast.py``, cudf ``cast``) between the
fixed-width types, with the JAX package's results byte for byte.

Spark CAST, non-ANSI: integer narrowing wraps; floating -> integer
saturates to the target's range and maps NaN to 0 (the bounds are taken
in float64, never through torch's conversion of NaN, inf or
out-of-range values, which CUDA leaves undefined); anything -> BOOL8 is
``!= 0``; floating -> decimal rounds half to even; decimal rescaling
truncates toward zero. Casts to and from STRING are ``strings.cast``.
DECIMAL128 casts raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import torch

from .. import dtype as dt
from ..column import Column
from . import compute
from .binaryop import _rescale_decimal


def _rescale(vals: torch.Tensor, from_scale: int, to_scale: int):
    return _rescale_decimal(vals, from_scale, to_scale)


def cast(col: Column, to: dt.DType) -> Column:
    """Spark CAST semantics (non-ANSI: overflow wraps, no exceptions)."""
    if col.dtype == to:
        return col
    if col.dtype.is_string or to.is_string:
        from . import strings

        return strings.cast(col, to)
    if dt.TypeId.DECIMAL128 in (col.dtype.id, to.id):
        raise NotImplementedError(
            "DECIMAL128 casts are not ported yet (ROADMAP Queue 1 item 5, "
            "ops/int128.py)")
    if not (col.dtype.is_fixed_width and to.is_fixed_width):
        raise TypeError(f"cannot cast {col.dtype} to {to}")
    vals = compute.values(col)
    want = compute.TORCH_OF[to.value_dtype]

    def out(res):
        return compute.from_values(compute.astype(res, want), to,
                                   col.validity)

    def as_int64(v):
        return compute.astype(v, torch.int64)

    if col.dtype.is_decimal and to.is_decimal:
        return out(_rescale(as_int64(vals), col.dtype.scale, to.scale))
    if col.dtype.is_decimal:
        # decimal -> numeric: the real value is unscaled * 10^scale
        if to.is_floating:
            return out(vals.to(torch.float64) * (10.0 ** col.dtype.scale))
        return out(_rescale(as_int64(vals), col.dtype.scale, 0))
    if to.is_decimal:
        if col.dtype.is_floating:
            return out(as_int64(torch.round(vals * (10.0 ** -to.scale))))
        return out(_rescale(as_int64(vals), 0, to.scale))
    return out(vals)
