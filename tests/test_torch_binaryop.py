"""The port's ``ops/binaryop.py`` and ``ops/unaryop.py`` against the JAX
package's, on every fixed-width type the ops take: the signed and
unsigned integers, FLOAT32/FLOAT64, BOOL8 and DECIMAL32/DECIMAL64.

The same numpy columns (made from a seed, with nulls, and with each
type's edge values: the minimum and maximum, 0, -1, NaN, +-inf, -0.0)
go through both packages, and the result columns must be equal byte for
byte, data of null rows included. The exceptions, each stated where it
applies:

* the transcendental unary functions and floating ``pow`` compare
  within 2 ulp (XLA's CPU code and torch's libm may round differently);
* the FLOAT results of ``expm1``, ``log1p``, ``sinh`` and ``tanh``
  compare within 2 ulp of numpy's (the host libm's) result on the same
  inputs, not of the JAX package's: XLA's CPU code computes these with
  its own approximations, up to 4 (expm1), 29 (log1p) and 7 (tanh) ulp
  from the correctly rounded value on these inputs, which torch's libm
  does not reproduce (``sinh`` of |x| < 1 goes through XLA's expm1, so
  its reference is numpy's sinh there and XLA's formula over numpy's
  exp above);
* an op that the JAX package refuses for a type must raise in the port
  too.
"""

import numpy as np
import pytest

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.ops import binaryop as jbin
from spark_rapids_jni_tpu.ops import unaryop as jun
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops import binaryop, unaryop

N = 257
ULP = 2  # transcendental functions and floating pow
TYPES = {
    "i8": (np.int8, None), "i16": (np.int16, None), "i32": (np.int32, None),
    "i64": (np.int64, None), "u8": (np.uint8, None),
    "u16": (np.uint16, None), "u32": (np.uint32, None),
    "u64": (np.uint64, None), "f32": (np.float32, None),
    "f64": (np.float64, None), "b": (np.bool_, None),
    "d32": (np.int32, jdt.decimal32(-2)), "d64": (np.int64, jdt.decimal64(-3)),
}
# every type with itself, and the promotions between them
PAIRS = [(t, t) for t in TYPES] + [
    ("i8", "u8"), ("u8", "i16"), ("i32", "u32"), ("u16", "i16"),
    ("i64", "u64"), ("u64", "u8"), ("u32", "u64"), ("i32", "i64"),
    ("i64", "f32"), ("u8", "f32"), ("i32", "f64"), ("u64", "f64"),
    ("f32", "f64"), ("b", "i8"), ("b", "u64"), ("f32", "b"),
    ("d32", "i32"), ("i64", "d32"), ("d64", "d32"), ("d32", "d64"),
    ("d64", "u16"), ("d64", "f64"), ("b", "d32"),
]
BINARY_OPS = sorted(jbin._CMP_OPS | jbin._LOGICAL_OPS | jbin._ARITH_OPS)


def _values(kind: str, rng) -> np.ndarray:
    np_t, _ = TYPES[kind]
    if np_t is np.bool_:
        return rng.random(N) > 0.5
    if np.dtype(np_t).kind == "f":
        v = (rng.standard_normal(N) * 10.0 ** rng.integers(-3, 4, N)).astype(np_t)
        v[:9] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1.0, 1e30, -2.5]
        return v
    info = np.iinfo(np_t)
    v = rng.integers(info.min, info.max, N, dtype=np_t, endpoint=True)
    small = rng.integers(max(info.min, -9), 10, N).astype(np_t)
    v[N // 2:] = small[N // 2:]  # small values for pow, shifts and division
    edges = [info.min, info.max, 0, 1, 2, 7, 63, 64, 65]
    if info.min < 0:
        edges += [-1, -7, info.min + 1]
    v[:len(edges)] = edges
    return v


def _column(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    np_t, d = TYPES[kind]
    vals = _values(kind, rng)
    valid = rng.random(N) > 0.15
    return JColumn.from_numpy(vals, validity=valid, dtype=d)


def _port(col: JColumn):
    return interop.table_from_buffers(
        [(np.asarray(col.data), np.asarray(col.validity)
          if col.validity is not None else None, None,
          int(col.dtype.id), int(col.dtype.scale))], device="cpu").columns[0]


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in units of the last place between two float
    arrays; NaN must meet NaN."""
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return 1 << 62
    ok = ~np.isnan(a)
    it = np.int64 if a.dtype == np.float64 else np.int32
    ia, ib = a[ok].view(it).astype(np.int64), b[ok].view(it).astype(np.int64)
    # map the sign-magnitude bit patterns onto a monotone integer line
    low = np.int64(2**63 - 1 if it is np.int64 else 2**31 - 1)
    ia = np.where(ia < 0, -(ia & low), ia)
    ib = np.where(ib < 0, -(ib & low), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _same(want: JColumn, got, ulp: int = 0, what: str = "") -> None:
    buf = interop.column_to_buffers(got)
    assert (int(want.dtype.id), int(want.dtype.scale)) == buf[3:], what
    wv = None if want.validity is None else np.asarray(want.validity)
    gv = buf[1]
    assert (wv is None) == (gv is None), f"{what}: validity presence"
    if wv is not None:
        np.testing.assert_array_equal(wv, gv, err_msg=f"{what}: validity")
    wd, gd = np.asarray(want.data), buf[0]
    assert wd.dtype == gd.dtype, what
    if ulp and want.dtype.is_floating:
        ft = np.float64 if want.dtype.id == jdt.TypeId.FLOAT64 else np.float32
        got_ulps = _ulps(wd.view(ft), gd.view(ft))
        assert got_ulps <= ulp, f"{what}: {got_ulps} ulp apart"
    else:
        np.testing.assert_array_equal(wd, gd, err_msg=f"{what}: data")


def _both(jfn, pfn, *cols):
    """(JAX result or its exception, the port's result or exception)."""
    try:
        want = jfn(*cols)
    except Exception as e:  # noqa: BLE001 - the port must refuse it too
        want = e
    try:
        got = pfn(*[_port(c) for c in cols])
    except Exception as e:  # noqa: BLE001
        got = e
    return want, got


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("op", BINARY_OPS)
def test_binary_op_matches_jax(op, pair):
    a, b = _column(pair[0], 1), _column(pair[1], 2)
    want, got = _both(lambda x, y: jbin.binary_op(op, x, y),
                      lambda x, y: binaryop.binary_op(op, x, y), a, b)
    if isinstance(want, Exception):
        assert isinstance(got, (TypeError, ValueError)), (
            f"JAX refuses {op} {pair} ({want!r}); the port gave {got!r}")
        return
    assert not isinstance(got, Exception), f"{op} {pair}: {got!r}"
    ulp = ULP if op == "pow" else 0
    _same(want, got, ulp, f"{op} {pair}")


UNARY_OPS = sorted(jun._FNS)
# XLA's own approximations on the CPU: the float results are held to libm
def _xla_sinh(x):
    """sinh as XLA composes it (the compiled HLO), with numpy's functions:
    libm's sinh for |x| < 1 (where XLA goes through its own expm1),
    exp(x + log(1/2)) - exp(log(1/2) - x) in x's dtype above."""
    half = float(np.log(0.5))  # a Python float keeps x's dtype
    return np.where(np.abs(x) < 1, np.sinh(x),
                    np.exp(x + half) - np.exp(half - x))


_XLA_APPROX = {"expm1": np.expm1, "log1p": np.log1p, "sinh": _xla_sinh,
               "tanh": np.tanh}
_TRANSCENDENTAL = {"sqrt", "cbrt", "exp", "expm1", "log", "log2", "log10",
                   "log1p", "sin", "cos", "tan", "arcsin", "arccos",
                   "arctan", "sinh", "cosh", "tanh"}


@pytest.mark.parametrize("kind", sorted(TYPES))
@pytest.mark.parametrize("op", UNARY_OPS)
def test_unary_op_matches_jax(op, kind):
    col = _column(kind, 3)
    want, got = _both(lambda c: jun.unary_op(op, c),
                      lambda c: unaryop.unary_op(op, c), col)
    if isinstance(want, Exception):
        assert isinstance(got, (TypeError, ValueError)), (
            f"JAX refuses {op} {kind} ({want!r}); the port gave {got!r}")
        return
    assert not isinstance(got, Exception), f"{op} {kind}: {got!r}"
    if op in _XLA_APPROX and want.dtype.is_floating:
        want = _libm_reference(op, col, want)
    _same(want, got, ULP if op in _TRANSCENDENTAL else 0, f"{op} {kind}")


def _flush(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) < np.finfo(x.dtype).tiny, x * 0, x)


def _libm_reference(op: str, col: JColumn, jax_out: JColumn) -> JColumn:
    """``jax_out`` with its data replaced by numpy's function of the same
    float inputs (denormals flushed, as both packages do)."""
    raw = np.asarray(col.data)
    if col.dtype.id == jdt.TypeId.FLOAT64:
        x = raw.view(np.float64)
    elif col.dtype.id == jdt.TypeId.FLOAT32:
        x = raw
    else:  # the float-only functions compute a non-float column in f64
        x = raw.astype(np.float64)
    with np.errstate(all="ignore"):
        y = _flush(_XLA_APPROX[op](_flush(x)))
    if jax_out.dtype.id == jdt.TypeId.FLOAT64:
        y = y.astype(np.float64).view(np.uint64)
    return JColumn(y, jax_out.dtype, jax_out.validity)


@pytest.mark.parametrize("fn", ["is_null", "is_not_null", "is_nan"])
@pytest.mark.parametrize("kind", ["i32", "f32", "f64", "d64"])
def test_null_predicates_match_jax(fn, kind):
    for valid in (True, False):
        col = _column(kind, 4)
        if not valid:
            col = JColumn(col.data, col.dtype, None)
        want, got = _both(getattr(jun, fn), getattr(unaryop, fn), col)
        if isinstance(want, Exception):
            assert isinstance(got, TypeError)
            continue
        _same(want, got, 0, f"{fn} {kind}")


# the INT64 probe: zero divisors, -2^63 / -1, shift counts of 64 and -1,
# negative integer exponents
PROBE_A = np.array([-2**63, 7, -7, 5, 1], np.int64)
PROBE_B = np.array([-1, 0, 2, 64, -1], np.int64)
PROBE_WANT = {
    "div": ([-2**63, 0, -3, 0, -1], [1, 0, 1, 1, 1]),
    "mod": ([0, 0, -1, 5, 0], [1, 0, 1, 1, 1]),
    "floor_div": ([-2**63, 0, -4, 0, -1], [1, 0, 1, 1, 1]),
    "shiftleft": ([0, 7, -28, 5, -2**63], None),
    "shiftright": ([-1, 7, -2, 5, 0], None),
}


@pytest.mark.parametrize("op", sorted(PROBE_WANT) + ["pmod", "pow",
                                                    "shiftright_unsigned"])
def test_int64_probe_matches_jax(op):
    a, b = JColumn.from_numpy(PROBE_A), JColumn.from_numpy(PROBE_B)
    want = jbin.binary_op(op, a, b)
    got = binaryop.binary_op(op, _port(a), _port(b))
    _same(want, got, 0, op)
    if op in PROBE_WANT:
        data, valid = PROBE_WANT[op]
        assert got.data.tolist() == data
        assert (None if got.validity is None
                else got.validity.to(int).tolist()) == valid


@pytest.mark.parametrize("kind", ["i8", "i16", "i32", "u16", "u32", "u64"])
@pytest.mark.parametrize("op", ["div", "mod", "floor_div", "pmod"])
def test_zero_divisor_and_minimum_over_minus_one(op, kind):
    """Every dividend against 0, -1 (where signed) and the minimum."""
    np_t = TYPES[kind][0]
    info = np.iinfo(np_t)
    vals = np.array([info.min, info.max, 0, 1, 5], np_t)
    divs = [0, 1, info.max] + ([-1, info.min] if info.min < 0 else [])
    a = JColumn.from_numpy(np.repeat(vals, len(divs)))
    b = JColumn.from_numpy(np.tile(np.array(divs, np_t), len(vals)))
    _same(jbin.binary_op(op, a, b),
          binaryop.binary_op(op, _port(a), _port(b)), 0, f"{op} {kind}")


def test_unported_operands_raise():
    from spark_rapids_jni_tpu_torch import dtype as dt
    from spark_rapids_jni_tpu_torch.column import Column
    import torch

    d128 = Column(torch.zeros((4, 2), dtype=torch.int64),
                  dt.DType(dt.TypeId.DECIMAL128, -2))
    i64 = Column(torch.zeros(4, dtype=torch.int64), dt.INT64)
    # DECIMAL128 add/sub/comparisons run now; a 128-bit product raises, as
    # in the JAX package (tests/test_torch_decimal128.py)
    assert binaryop.add(d128, i64).dtype == dt.DType(dt.TypeId.DECIMAL128, -2)
    with pytest.raises(TypeError, match="decimal128 op 'mul'"):
        binaryop.mul(d128, i64)
    # STRING comparisons run now; arithmetic on strings raises
    s = Column.from_strings(["a", "b", None, ""], device="cpu")
    with pytest.raises(TypeError, match="not supported for strings"):
        binaryop.mul(s, s)
    with pytest.raises(ValueError, match="unknown binary op"):
        binaryop.binary_op("nope", i64, i64)
    with pytest.raises(ValueError, match="unknown unary op"):
        unaryop.unary_op("nope", i64)
