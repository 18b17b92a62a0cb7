"""Type casts (port of ``ops/cast.py``, cudf ``cast``) between the
fixed-width types, with the JAX package's results byte for byte.

Spark CAST, non-ANSI: integer narrowing wraps; floating -> integer
saturates to the target's range and maps NaN to 0 (the bounds are taken
in float64, never through torch's conversion of NaN, inf or
out-of-range values, which CUDA leaves undefined); anything -> BOOL8 is
``!= 0``; floating -> decimal rounds half to even; decimal rescaling
truncates toward zero. Casts to and from STRING are ``strings.cast``.
DECIMAL128 (``(n, 2)`` limbs, ops/int128.py) widens from any decimal or
integer, rescales within itself, narrows to DECIMAL32/64 and the
integers (wrapping) and to BOOL8, and approximates to the floats; a
float -> DECIMAL128 cast raises :class:`TypeError`, as in the JAX
package.
"""

from __future__ import annotations

import torch

from .. import dtype as dt
from ..column import Column
from . import compute
from .binaryop import _limbs_at_scale, _rescale_decimal


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
        return _cast_decimal128(col, to)
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


def _cast_decimal128(col: Column, to: dt.DType) -> Column:
    """Casts touching DECIMAL128 (JAX ``_cast_decimal128``)."""
    from . import int128

    if to.id == dt.TypeId.DECIMAL128:
        if not (col.dtype.is_decimal or col.dtype.is_integer):
            raise TypeError(f"cannot cast {col.dtype} to DECIMAL128")
        lo, hi = _limbs_at_scale(col, to.scale)
        return Column(torch.stack([lo, hi], 1), to, col.validity)
    lo, hi = col.data[:, 0], col.data[:, 1]
    if not to.is_fixed_width:
        raise TypeError(f"cannot cast DECIMAL128 to {to}")
    want = compute.TORCH_OF[to.value_dtype]
    if to.is_floating:
        scaled = compute.flush_subnormal(
            int128.to_float64(lo, hi) * (10.0 ** col.dtype.scale))
        return compute.from_values(compute.astype(scaled, want), to,
                                   col.validity)
    if to.is_boolean:
        lo, hi = int128.rescale(lo, hi, col.dtype.scale, 0)
        return Column((lo != 0) | (hi != 0), dt.BOOL8, col.validity)
    if to.is_decimal or to.is_integer:
        lo, _ = int128.rescale(lo, hi, col.dtype.scale,
                               to.scale if to.is_decimal else 0)
        return compute.from_values(compute.astype(lo, want), to,
                                   col.validity)
    raise TypeError(f"cannot cast DECIMAL128 to {to}")
