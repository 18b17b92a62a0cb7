"""Null-aware unary operators (port of ``ops/unaryop.py``, the cudf
``unary_op`` family, and the null predicates).

Results follow the JAX package's types: the float-only functions of a
non-float column compute in FLOAT64 and return FLOAT64; the other
functions of an integer column compute where ``jnp`` promotes it (FLOAT64
for 64-bit integers, FLOAT32 below) and convert back to the column's
type, saturating; ``floor``/``ceil``/``rint`` of a non-float column are a
no-op; ``abs`` and ``neg`` of a decimal keep the decimal type. ``rint``
rounds half to even (``torch.round``).
"""

from __future__ import annotations

import torch

from .. import dtype as dt
from ..column import Column
from . import compute

_FLOAT_ONLY = {
    "sqrt", "cbrt", "exp", "log", "sin", "cos", "tan", "arcsin", "arccos",
    "arctan", "sinh", "cosh", "tanh", "rint",
}


_LOG_HALF = -0.69314718055994529  # log(1/2), XLA's constant


def _sinh(v: torch.Tensor) -> torch.Tensor:
    """XLA's decomposition: (expm1 + expm1 / (expm1 + 1)) / 2 for |x| < 1
    (taken in float64, where XLA's own expm1 is no closer than libm's),
    else exp(x + log(1/2)) - exp(log(1/2) - x)."""
    em1 = torch.expm1(v.to(torch.float64))
    small = ((em1 + em1 / (em1 + 1)) * 0.5).to(v.dtype)
    large = torch.exp(v + _LOG_HALF) - torch.exp(_LOG_HALF - v)
    return torch.where(v.abs() < 1, small, large)


def _cosh(v: torch.Tensor) -> torch.Tensor:
    """XLA's decomposition: exp(x + log(1/2)) + exp(log(1/2) - x)."""
    return torch.exp(v + _LOG_HALF) + torch.exp(_LOG_HALF - v)


def _cbrt(v: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has none): the sign times |v| ** (1/3)."""
    return torch.sign(v) * torch.abs(v).pow(1.0 / 3.0)


def _neg(v: torch.Tensor) -> torch.Tensor:
    if v.dtype == torch.bool:
        raise TypeError("neg is not defined on BOOL8")
    return -v


def _bitnot(v: torch.Tensor) -> torch.Tensor:
    if v.is_floating_point():
        raise TypeError("bitnot requires an integer or BOOL8 column")
    return ~v


_FNS = {
    "abs": torch.abs,
    "neg": _neg,
    "sqrt": torch.sqrt,
    "cbrt": _cbrt,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log2": lambda v: torch.log(v) * 1.4426950408889634,  # XLA: log(x) / ln 2
    "log10": lambda v: torch.log(v) * 0.43429448190325176,
    "log1p": torch.log1p,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": _sinh,
    "cosh": _cosh,
    "tanh": torch.tanh,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "rint": torch.round,
    "bitnot": _bitnot,
}
_EXACT = {"abs", "neg", "bitnot", "floor", "ceil", "rint"}


def _inexact(v: torch.Tensor) -> torch.Tensor:
    """``jnp``'s promotion of an integer or bool argument of a float
    function: FLOAT64 for 64-bit integers, FLOAT32 below."""
    if v.is_floating_point():
        return v
    wide = v.dtype in (torch.int64, torch.uint64)
    return compute.astype(v, torch.float64 if wide else torch.float32)


def _integer_fn(op: str, v: torch.Tensor) -> torch.Tensor:
    """abs / neg / bitnot of integer values, wrapping, on the carrier."""
    c = compute.to_carrier(v)
    if v.dtype in (torch.uint8, *compute.WIDE_UNSIGNED):
        if op == "abs":
            return v
        return compute.from_carrier(-c if op == "neg" else ~c, v.dtype)
    return _FNS[op](v)


def unary_op(op: str, col: Column) -> Column:
    if op == "not":
        if not col.dtype.is_boolean:
            raise TypeError("'not' requires BOOL8")
        return Column(~col.data, dt.BOOL8, col.validity)
    fn = _FNS.get(op)
    if fn is None:
        raise ValueError(f"unknown unary op {op!r}")
    if col.dtype.id == dt.TypeId.DECIMAL128:
        # the JAX package applies every one of them to each 64-bit limb
        # on its own (abs of -5 stays -5, neg of -5 gives 2^64 + 5 and
        # of 2^64 + 7 gives -7, floor/ceil/rint keep the fraction, the
        # float functions return a value a limb): no Spark result to
        # hold the port to
        raise NotImplementedError(
            f"unary {op!r} on DECIMAL128: the JAX package's unary_op works "
            "limb by limb, not on the 128-bit value (ROADMAP Queue 3)")
    if col.dtype.is_string:
        raise NotImplementedError(
            f"unary ops on {col.dtype.id.name} are not ported yet")
    vals = compute.values(col)
    out_dtype = col.dtype
    if op in ("floor", "ceil", "rint") and not col.dtype.is_floating:
        return Column(col.data, col.dtype, col.validity)  # integral: no-op
    if op in _FLOAT_ONLY and not col.dtype.is_floating:
        vals = compute.astype(vals, torch.float64)
        out_dtype = dt.FLOAT64
    if op in _EXACT and vals.dtype == torch.bool:
        res = vals if op == "abs" else fn(vals)
    elif op in _EXACT and not vals.is_floating_point():
        res = _integer_fn(op, vals)
    else:
        res = compute.flush_subnormal(
            fn(compute.flush_subnormal(_inexact(vals))))
    return compute.from_values(
        compute.astype(res, compute.TORCH_OF[out_dtype.value_dtype]),
        out_dtype, col.validity)


def is_null(col: Column) -> Column:
    """Spark ``IS NULL``: never itself null."""
    if col.validity is None:
        return Column(torch.zeros(col.row_count, dtype=torch.bool,
                                  device=col.data.device), dt.BOOL8, None)
    return Column(~col.validity, dt.BOOL8, None)


def is_not_null(col: Column) -> Column:
    if col.validity is None:
        return Column(torch.ones(col.row_count, dtype=torch.bool,
                                 device=col.data.device), dt.BOOL8, None)
    return Column(col.validity, dt.BOOL8, None)


def is_nan(col: Column) -> Column:
    if not col.dtype.is_floating:
        raise TypeError("is_nan requires a float column")
    return Column(torch.isnan(compute.values(col)), dt.BOOL8, col.validity)
