"""Null-aware binary operators (port of ``ops/binaryop.py``, the cudf
``binaryop`` family) over the fixed-width types.

Spark SQL's non-ANSI semantics, byte for byte the JAX package's:
* any null operand -> null result (``null_safe_eq`` is Spark's <=>);
* integer/decimal ``div``, ``floor_div``, ``mod``, ``pmod`` by zero ->
  null; the zero divisor is replaced by 1 before torch divides (integer
  division by zero raises on the CPU), and so is -1 under the type's
  minimum (undefined on CUDA; the JAX package gives the minimum, 0 and
  the minimum for div, mod and floor_div, which the 1 reproduces);
* ``div`` truncates toward zero, ``mod`` takes the dividend's sign,
  ``pmod`` is Spark's;
* shift counts are masked to the width, as Java does;
* integer ``pow`` is the JAX package's binary exponentiation over the
  exponent's low 6 bits;
* float division by zero -> IEEE inf/NaN;
* decimal add/sub rescale to the finer scale, mul adds the scales and
  rescales, div rescales the dividend first; narrowing truncates toward
  zero.

Arithmetic promotes with numpy's rules (``dtype.common_numeric_dtype``);
comparisons promote as ``jnp`` does (an integer against FLOAT32 compares
in FLOAT32). torch computes little with uint16/32/64, so those travel as
int64 carriers (``compute.to_carrier``): unsigned division, remainder,
order and right shifts of the 64-bit carrier are written out here.
STRING operands go to ``strings.binary_op`` (comparisons and ``add``,
Spark ``||``). DECIMAL128 operands (``(n, 2)`` limbs, ops/int128.py)
take add, sub and every comparison at the finer of the two scales (an
integer operand is scale 0); mul, div and the rest raise
:class:`TypeError`, as in the JAX package, which has no 128-bit product.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column
from . import compute

_CMP_OPS = {"eq", "ne", "lt", "le", "gt", "ge", "null_safe_eq"}
_LOGICAL_OPS = {"and", "or"}
_ARITH_OPS = {
    "add", "sub", "mul", "div", "true_div", "floor_div", "mod", "pmod",
    "pow", "bitand", "bitor", "bitxor", "shiftleft", "shiftright",
    "shiftright_unsigned",
}
_SIGN64 = -(2**63)
_LOW63 = 2**63 - 1


def _promote(a: Column, b: Column) -> dt.DType:
    if a.dtype.is_decimal or b.dtype.is_decimal:
        da, db = a.dtype, b.dtype
        # an integer operand is decimal(scale 0); a float needs a cast
        if not da.is_decimal:
            if not da.is_integer:
                raise TypeError(
                    "decimal/float binary ops require explicit cast")
            da = dt.DType(dt.TypeId.DECIMAL64 if da.itemsize >= 8
                          else dt.TypeId.DECIMAL32)
        if not db.is_decimal:
            if not db.is_integer:
                raise TypeError(
                    "decimal/float binary ops require explicit cast")
            db = dt.DType(dt.TypeId.DECIMAL64 if db.itemsize >= 8
                          else dt.TypeId.DECIMAL32)
        wid = max(da.itemsize, db.itemsize)
        scale = min(da.scale, db.scale)
        return dt.DType(
            dt.TypeId.DECIMAL64 if wid >= 8 else dt.TypeId.DECIMAL32, scale)
    return dt.common_numeric_dtype(a.dtype, b.dtype)


def _cmp_dtype(a: dt.DType, b: dt.DType) -> torch.dtype:
    """The dtype ``jnp`` compares two value dtypes in: numpy's promotion,
    except that any integer or bool meets FLOAT32 in FLOAT32."""
    va, vb = a.value_dtype, b.value_dtype
    f32 = np.dtype(np.float32)
    if (va == f32 and vb.kind in "iub") or (vb == f32 and va.kind in "iub"):
        return torch.float32
    return compute.TORCH_OF[np.promote_types(va, vb)]


def _rescale_decimal(vals: torch.Tensor, from_scale: int,
                     to_scale: int) -> torch.Tensor:
    """int64 unscaled values from one decimal scale to another; narrowing
    truncates toward zero (cudf fixed_point convention)."""
    if from_scale == to_scale:
        return vals
    if to_scale < from_scale:
        return vals * (10 ** (from_scale - to_scale))
    return torch.div(vals, 10 ** (to_scale - from_scale),
                     rounding_mode="trunc")


def _and_not(valid: Optional[torch.Tensor], zero: torch.Tensor):
    return ~zero if valid is None else valid & ~zero


def _int64_values(col: Column) -> torch.Tensor:
    return compute.astype(compute.values(col), torch.int64)


def binary_op(op: str, a: Column, b: Column) -> Column:
    """Elementwise ``a <op> b`` with Spark null semantics."""
    if a.dtype.is_string or b.dtype.is_string:
        from . import strings

        return strings.binary_op(op, a, b)
    if dt.TypeId.DECIMAL128 in (a.dtype.id, b.dtype.id):
        return _binary_op_decimal128(op, a, b)
    valid = compute.merge_validity(a, b)
    if op in _LOGICAL_OPS:
        return _logical(op, a, b)
    if op in _CMP_OPS:
        return _compare(op, a, b, valid)
    if op not in _ARITH_OPS:
        raise ValueError(f"unknown binary op {op!r}")
    out_dtype = _promote(a, b)
    if out_dtype.is_decimal:
        return _decimal_arith(op, a, b, out_dtype, valid)
    want = compute.TORCH_OF[out_dtype.value_dtype]
    av = compute.astype(compute.values(a), want)
    bv = compute.astype(compute.values(b), want)
    if want.is_floating_point:
        res = compute.flush_subnormal(_float_arith(
            op, compute.flush_subnormal(av), compute.flush_subnormal(bv)))
    elif want == torch.bool:
        res = _bool_arith(op, av, bv)
        if op == "floor_div":  # the integer branch: a False divisor is null
            valid = _and_not(valid, ~bv)
    else:
        res, zero = _int_arith(op, compute.to_carrier(av),
                               compute.to_carrier(bv), want)
        res = compute.from_carrier(res, want)
        if zero is not None:
            valid = _and_not(valid, zero)
    return compute.from_values(res, out_dtype, valid)


def _limbs_at_scale(col: Column, to_scale: int):
    """A column's values as (lo, hi) limbs rescaled to ``to_scale``;
    rescaling to the finer scale multiplies, so the alignment is exact."""
    from . import int128

    if col.dtype.id == dt.TypeId.DECIMAL128:
        lo, hi = col.data[:, 0], col.data[:, 1]
    elif col.dtype.is_decimal or col.dtype.is_integer:
        data = col.data
        if data.dtype == torch.uint64:  # the JAX convert wraps it
            data = data.view(torch.int64)
        lo, hi = int128.from_signed_int(data)
    else:
        raise TypeError(
            f"decimal128 binary ops require decimal/integer operands, "
            f"got {col.dtype}")
    return int128.rescale(lo, hi, col.dtype.scale, to_scale)


def _binary_op_decimal128(op: str, a: Column, b: Column) -> Column:
    """DECIMAL128 add, sub and comparisons over limb vectors; mul/div of
    two 128-bit operands raise, never truncate silently."""
    from . import int128

    valid = compute.merge_validity(a, b)
    scale = min(a.dtype.scale if a.dtype.is_decimal else 0,
                b.dtype.scale if b.dtype.is_decimal else 0)
    al, ah = _limbs_at_scale(a, scale)
    bl, bh = _limbs_at_scale(b, scale)
    if op in _CMP_OPS:
        is_eq = int128.eq(al, ah, bl, bh)
        is_lt = int128.lt_signed(al, ah, bl, bh)
        out = {
            "eq": lambda: is_eq, "ne": lambda: ~is_eq, "lt": lambda: is_lt,
            "le": lambda: is_lt | is_eq, "gt": lambda: ~(is_lt | is_eq),
            "ge": lambda: ~is_lt, "null_safe_eq": lambda: is_eq,
        }[op]()
        if op == "null_safe_eq":
            va, vb = compute.valid_mask(a), compute.valid_mask(b)
            return Column(torch.where(va & vb, out, ~va & ~vb), dt.BOOL8,
                          None)
        return Column(out, dt.BOOL8, valid)
    if op == "add":
        lo, hi = int128.add(al, ah, bl, bh)
    elif op == "sub":
        lo, hi = int128.sub(al, ah, bl, bh)
    else:
        raise TypeError(f"decimal128 op {op!r} not supported")
    return Column(torch.stack([lo, hi], 1),
                  dt.DType(dt.TypeId.DECIMAL128, scale), valid)


def _compare(op: str, a: Column, b: Column, valid) -> Column:
    if a.dtype.is_decimal or b.dtype.is_decimal:
        scale = min(a.dtype.scale, b.dtype.scale)
        av = _rescale_decimal(_int64_values(a), a.dtype.scale, scale)
        bv = _rescale_decimal(_int64_values(b), b.dtype.scale, scale)
    else:
        work = _cmp_dtype(a.dtype, b.dtype)
        av = compute.to_carrier(compute.flush_subnormal(
            compute.astype(compute.values(a), work)))
        bv = compute.to_carrier(compute.flush_subnormal(
            compute.astype(compute.values(b), work)))
        if work == torch.uint64:  # unsigned order of the bit patterns
            av, bv = av ^ _SIGN64, bv ^ _SIGN64
    out = {
        "eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge, "null_safe_eq": torch.eq,
    }[op](av, bv)
    if op == "null_safe_eq":
        # Spark's <=>: null <=> null is True, null <=> x is False
        va, vb = compute.valid_mask(a), compute.valid_mask(b)
        return Column(torch.where(va & vb, out, ~va & ~vb), dt.BOOL8, None)
    return Column(out, dt.BOOL8, valid)


def _decimal_arith(op: str, a: Column, b: Column, out_dtype: dt.DType,
                   valid) -> Column:
    sa, sb, so = a.dtype.scale, b.dtype.scale, out_dtype.scale
    ar, br = _int64_values(a), _int64_values(b)
    if op == "add":
        res = _rescale_decimal(ar, sa, so) + _rescale_decimal(br, sb, so)
    elif op == "sub":
        res = _rescale_decimal(ar, sa, so) - _rescale_decimal(br, sb, so)
    elif op == "mul":
        # the product of unscaled values carries scale(a) + scale(b)
        res = _rescale_decimal(ar * br, sa + sb, so)
    elif op in ("div", "true_div"):
        # the quotient at the output scale: rescale the dividend first
        e = sa - sb - so
        num = ar * (10 ** e) if e >= 0 else ar
        den = br if e >= 0 else br * (10 ** (-e))
        zero = br == 0
        res = _div_trunc(num, torch.where(zero, 1, den))
        valid = _and_not(valid, zero)
    else:
        raise TypeError(f"decimal op {op!r} not supported")
    return compute.from_values(res, out_dtype, valid)


def _float_arith(op: str, av, bv):
    if op == "add":
        return av + bv
    if op == "sub":
        return av - bv
    if op == "mul":
        return av * bv
    if op in ("div", "true_div"):
        return av / bv  # IEEE inf/NaN on a zero divisor
    if op == "floor_div":
        return torch.floor(av / bv)
    if op == "mod":
        return _fmod(av, bv)
    if op == "pmod":
        m = _fmod(av, bv)
        return torch.where(m < 0, _fmod(m + bv, bv), m)
    if op == "pow":
        return torch.pow(av, bv)
    raise TypeError(f"binary op {op!r} needs integer operands, got "
                    f"{av.dtype}")


def _fmod(a, b):
    """C ``fmod`` with the NaN bits of the JAX package's (the host libm's,
    x86 rules): a NaN operand propagates, the first one first, and an
    invalid remainder (inf % y, x % 0) is the default NaN, -nan; torch's
    vectorised CPU ``fmod`` returns other payloads there."""
    r = torch.fmod(a, b)
    nan = torch.full_like(r, float("nan")).neg()
    fix = torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, nan))
    return torch.where(torch.isnan(r), fix, r)


def _bool_arith(op: str, av, bv):
    """BOOL8 results: add is OR and mul is AND; floor_div, pow and the
    shifts compute in int32 (``jnp``'s promotion of two bools there) and
    convert back; the other dividing ops and sub raise, as ``jnp`` does."""
    if op == "add":
        return av | bv
    if op == "mul":
        return av & bv
    if op == "bitand":
        return av & bv
    if op == "bitor":
        return av | bv
    if op == "bitxor":
        return av ^ bv
    ai, bi = av.to(torch.int32), bv.to(torch.int32)
    if op == "floor_div":
        return (ai // torch.where(bv, bi, 1)) & bi != 0
    if op == "pow":
        return _pow_int(ai, bi) != 0
    if op == "shiftleft":
        return (ai << (bi & 7)) != 0
    if op in ("shiftright", "shiftright_unsigned"):
        return (ai >> (bi & 7)) != 0
    raise TypeError(f"binary op {op!r} is not defined on two BOOL8 columns")


def _type_min(t: torch.dtype) -> Optional[int]:
    if t in (torch.int8, torch.int16, torch.int32, torch.int64):
        return int(torch.iinfo(t).min)
    return None


def _div_trunc(a, b):
    return torch.div(a, b, rounding_mode="trunc")


def _udiv64(a, b):
    """Unsigned 64-bit quotient of int64 bit patterns (``b`` != 0):
    Hacker's Delight ``divlu`` from one signed division."""
    big = b < 0  # divisor >= 2^63: the quotient is 0 or 1
    ge = (a ^ _SIGN64) >= (b ^ _SIGN64)
    bs = torch.where(big, 1, b)
    q = _div_trunc((a >> 1) & _LOW63, bs) << 1
    r = a - q * bs
    q = q + ((r ^ _SIGN64) >= (bs ^ _SIGN64)).to(torch.int64)
    return torch.where(big, ge.to(torch.int64), q)


def _int_arith(op: str, av, bv, want: torch.dtype):
    """(result carrier, zero-divisor mask or None) of an integer op on
    carriers of the value dtype ``want``."""
    bits = compute.WIDE_UNSIGNED.get(want)
    unsigned = want == torch.uint8 or bits is not None
    if op == "add":
        return av + bv, None
    if op == "sub":
        return av - bv, None
    if op == "mul":
        return av * bv, None
    if op == "pow":
        return _pow_int(av, bv), None
    if op == "bitand":
        return av & bv, None
    if op == "bitor":
        return av | bv, None
    if op == "bitxor":
        return av ^ bv, None
    if op in ("shiftleft", "shiftright", "shiftright_unsigned"):
        width = bits or torch.iinfo(want).bits
        s = bv & (width - 1)
        if op == "shiftleft":
            return av << s, None
        if op == "shiftright" and not unsigned:
            return av >> s, None
        if want == torch.int64 or bits == 64:
            # logical: one bit first, then an arithmetic shift of a
            # non-negative value
            half = (av >> 1) & _LOW63
            return torch.where(s == 0, av, half >> (s - 1).clamp(min=0)), None
        if unsigned:
            return av >> s, None
        # a narrower signed type: shift its unsigned bit pattern
        w = torch.iinfo(want).bits
        u = av.to(torch.int64) & ((1 << w) - 1)
        return (u >> s.to(torch.int64)).to(want), None
    # the dividing ops: a zero divisor is null, and -1 under the minimum
    # divides as 1 (same quotient and remainder, never a trap)
    zero = bv == 0
    safe = torch.where(zero, 1, bv)
    lo = _type_min(want)
    if lo is not None:
        safe = torch.where((safe == -1) & (av == lo), 1, safe)
    if bits == 64:
        q = _udiv64(av, safe)
        r = av - q * safe
        res = {"div": q, "true_div": q, "floor_div": q, "mod": r,
               "pmod": r}[op]
    elif op in ("div", "true_div"):
        res = _div_trunc(av, safe)
    elif op == "floor_div":
        res = torch.div(av, safe, rounding_mode="floor")
    elif op == "mod":
        res = torch.fmod(av, safe)
    else:  # pmod: a negative remainder r becomes (r + n) % n
        m = torch.fmod(av, safe)
        if unsigned:
            res = m
        else:
            # m < 0 needs safe != -1, so this never divides lo by -1
            res = torch.where(m < 0, torch.fmod(m + safe, safe), m)
    return torch.where(zero, torch.zeros_like(res), res), zero


def _pow_int(x1, x2):
    """Integer power as the JAX package computes it: binary
    exponentiation over the low 6 bits of the exponent, wrapping; pow(0,
    e) is 0 for e != 0."""
    one = torch.ones_like(x1)
    acc = torch.where((x1 == 0) & (x2 != 0), torch.zeros_like(x1), one)
    for i in range(6):
        bit = ((x2 >> i) & 1) != 0
        acc = torch.where(bit, acc * x1, acc)
        x1 = x1 * x1
    return acc


def _logical(op: str, a: Column, b: Column) -> Column:
    """Spark three-valued logic for AND/OR."""
    if not (a.dtype.is_boolean and b.dtype.is_boolean):
        raise TypeError("logical ops require BOOL8 columns")
    av, bv = a.data, b.data
    va, vb = compute.valid_mask(a), compute.valid_mask(b)
    ta, tb = av & va, bv & vb  # definitely true
    fa, fb = ~av & va, ~bv & vb  # definitely false
    if op == "and":
        out = ta & tb
        known = (fa | fb) | (va & vb)  # false wins over null
    else:
        out = ta | tb
        known = (ta | tb) | (va & vb)  # true wins over null
    both_absent = a.validity is None and b.validity is None
    return Column(out, dt.BOOL8, None if both_absent else known)


def add(a, b):
    return binary_op("add", a, b)


def sub(a, b):
    return binary_op("sub", a, b)


def mul(a, b):
    return binary_op("mul", a, b)


def div(a, b):
    return binary_op("div", a, b)


def eq(a, b):
    return binary_op("eq", a, b)


def ne(a, b):
    return binary_op("ne", a, b)


def lt(a, b):
    return binary_op("lt", a, b)


def le(a, b):
    return binary_op("le", a, b)


def gt(a, b):
    return binary_op("gt", a, b)


def ge(a, b):
    return binary_op("ge", a, b)
