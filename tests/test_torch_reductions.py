"""The port's reductions (``ops/reductions.py``), scans (``ops/scan.py``)
and quantiles (``ops/quantiles.py``) against the JAX package's, on the
CPU.

Both packages get the same numpy inputs from a seed; the JAX functions
run eagerly, as its own tests call them, but for the integer scans:
``lax.associative_scan``'s integer adds, products, minima and maxima
give the same bytes in any order, so these run jitted, at one XLA
compile a shape instead of one a level and shape. Tolerance 0 (data bytes,
validity, dtype) for every result but the FLOAT sums, means, variances,
standard deviations and products of ``reduce``: the JAX package runs
XLA's reduce, whose order of adds the port does not reproduce, so those
are held within ``4 * n * 2^-53 * sum|x|`` (sum, mean) and 1e-12 relative
(variance, std, product), with NaN and infinities exact (ROADMAP Queue
3, "Recorded"). A NaN equals a NaN whatever its sign bit (the scans'
sign bits match: see the first-NaN cases). Sizes 0, 1, 2, 1023, 1024,
1025, with nulls, NaN, +-0.0, +-inf, subnormals and integer extremes.
"""

import jax
import numpy as np
import pytest

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu_torch import interop, ops

SIZES = (0, 1, 2, 1023, 1024, 1025)
FLOAT_VIEW = {10: np.float64, 9: np.float32}
TS_DAYS = jdt.DType(jdt.TypeId.TIMESTAMP_DAYS)


def _bufs(c: JColumn):
    return (np.asarray(c.data),
            None if c.validity is None else np.asarray(c.validity),
            None, int(c.dtype.id), int(c.dtype.scale))


def _port(jc: JColumn):
    return interop.column_from_buffers(*_bufs(jc), device="cpu")


def _same(jc: JColumn, pc, what="") -> None:
    w, g = _bufs(jc), interop.column_to_buffers(pc)
    assert w[3:] == g[3:], f"{what} type"
    for part, a, b in zip(("data", "validity"), w[:2], g[:2]):
        assert (a is None) == (b is None), f"{what} {part} presence"
        if a is None:
            continue
        assert a.dtype == b.dtype, f"{what} {part} dtype"
        if part == "data" and w[3] in FLOAT_VIEW:
            fa, fb = a.view(FLOAT_VIEW[w[3]]), b.view(FLOAT_VIEW[w[3]])
            np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb),
                                          f"{what} NaN rows")
            a, b = a[~np.isnan(fa)], b[~np.isnan(fa)]
        np.testing.assert_array_equal(a, b, f"{what} {part}")


def _floats(rng, n, specials=True):
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
    if specials:
        for frac, v in ((0.03, np.nan), (0.04, -0.0), (0.04, 0.0),
                        (0.01, np.inf), (0.01, -np.inf), (0.03, 5e-324),
                        (0.03, -2.5e-310)):
            f[rng.random(n) < frac] = v
    return f


def _columns(n: int, seed: int) -> dict:
    """One JAX column per dtype under test, ~15 % null; 'fin' holds
    finite FLOAT64 values only (its sums are compared in a bound); 'p'
    and 'pg' hold 1 + 1e-3 x (no NaN, inf or 0: a product of 1025 stays
    finite), 'i3', 'odd' and 'uodd' odd integers (INT64 of -1, 1 and 3,
    INT32, UINT64 near 2^64: products that wrap and never reach 0)."""
    rng = np.random.default_rng(seed)

    def ok():
        return rng.random(n) > 0.15

    i = rng.integers(-1000, 1000, n)
    i[rng.random(n) < 0.05] = np.iinfo(np.int64).max
    i[rng.random(n) < 0.05] = np.iinfo(np.int64).min
    u = rng.integers(0, 1000, n).astype(np.uint64)
    u[rng.random(n) < 0.05] = np.uint64(2**64 - 1)
    f = _floats(rng, n)
    near1 = 1.0 + 1e-3 * rng.standard_normal(n)
    return {
        "f": JColumn.from_numpy(f, validity=ok()),
        "fin": JColumn.from_numpy(_floats(rng, n, False), validity=ok()),
        "g": JColumn.from_numpy(f.astype(np.float32), validity=ok()),
        "i": JColumn.from_numpy(i, validity=ok()),
        "i32": JColumn.from_numpy(rng.integers(-9, 9, n).astype(np.int32)),
        "u": JColumn.from_numpy(u, validity=ok()),
        "u16": JColumn.from_numpy(rng.integers(0, 2**16, n).astype(
            np.uint16), validity=ok()),
        "d": JColumn.from_numpy(rng.integers(-10**6, 10**6, n),
                                validity=ok(), dtype=jdt.decimal64(-2)),
        "b": JColumn.from_numpy(rng.random(n) > 0.3, validity=ok()),
        "allnull": JColumn.from_numpy(np.ones(n), validity=np.zeros(n, bool)),
        "p": JColumn.from_numpy(near1, validity=ok()),
        "pg": JColumn.from_numpy(near1.astype(np.float32), validity=ok()),
        "i3": JColumn.from_numpy(rng.choice(np.array([-1, 1, 3]), n),
                                 validity=ok()),
        "odd": JColumn.from_numpy(
            (2 * rng.integers(-50, 50, n) + 1).astype(np.int32)),
        "uodd": JColumn.from_numpy(
            np.uint64(2**64 - 1) - 2 * rng.integers(0, 1000, n).astype(
                np.uint64), validity=ok()),
    }


@pytest.fixture(scope="module")
def columns():
    return {n: _columns(n, 100 + n) for n in SIZES}


#: the JAX scan for integer columns, jitted (see the header)
INT_SCAN = jax.jit(jops.scan, static_argnums=(1, 2))


def _is_float(jc: JColumn) -> bool:
    return int(jc.dtype.id) in FLOAT_VIEW


EXACT = {
    "count": ("f", "i", "b", "allnull"),
    "min": ("f", "g", "i", "u", "u16", "d", "b", "allnull"),
    "max": ("f", "g", "i", "u", "u16", "d", "b", "allnull"),
    "sum": ("i", "i32", "u", "u16", "d", "b", "allnull"),
    "mean": ("i", "i32", "u16", "d"),
    "product": ("i32", "u16", "b", "i3", "odd", "uodd"),
    "any": ("b",),
    "all": ("b",),
}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", sorted(EXACT))
def test_reduce_exact(columns, n, op):
    for name in EXACT[op]:
        jc = columns[n][name]
        _same(jops.reduce_column(jc, op), ops.reduce_column(_port(jc), op),
              f"{op} {name}")


def _close(jc: JColumn, pc, rel, absolute=0.0, what=""):
    w, g = _bufs(jc), interop.column_to_buffers(pc)
    assert w[3:] == g[3:]
    np.testing.assert_array_equal(w[1], g[1], what)
    a, b = w[0].view(np.float64), g[0].view(np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), what)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b), what)
    fin = np.isfinite(a)
    np.testing.assert_array_equal(np.isinf(a) & (a > 0), np.isinf(b) & (b > 0))
    err = np.abs(a[fin] - b[fin])
    assert np.all(err <= absolute + rel * np.abs(a[fin])), (what, a, b)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["sum", "mean", "variance", "std", "product"])
def test_reduce_float_bound(columns, n, op):
    """FLOAT reductions: the port's fixed order against XLA's reduce."""
    for name in ("f", "fin", "g", "allnull") if op != "product" else (
            "f", "g", "allnull", "p", "pg"):
        jc = columns[n][name]
        vals = np.asarray(jc.data).view(
            FLOAT_VIEW[int(jc.dtype.id)]).astype(np.float64)
        valid = np.asarray(jc.validity)
        s = np.abs(vals[valid & np.isfinite(vals)]).sum()
        bound = 4 * max(n, 1) * 2.0**-53 * s
        if op in ("sum",):
            _close(jops.reduce_column(jc, op), ops.reduce_column(_port(jc), op),
                   0.0, bound, f"{op} {name}")
        elif op == "mean":
            cnt = max(int(valid.sum()), 1)
            _close(jops.reduce_column(jc, op), ops.reduce_column(_port(jc), op),
                   0.0, bound / cnt, f"{op} {name}")
        else:
            _close(jops.reduce_column(jc, op), ops.reduce_column(_port(jc), op),
                   1e-12, 0.0, f"{op} {name}")
    # the exact ones: decimals and integers through the float paths
    for name in ("d", "i32"):
        if op in ("variance", "std"):
            jc = columns[n][name]
            _close(jops.reduce_column(jc, op), ops.reduce_column(_port(jc), op),
                   1e-12, 0.0, f"{op} {name}")


def test_reduce_float_sum_small_exact():
    """Below 16 rows XLA's reduce and the port's scan-order sum add left
    to right from +0.0: the same bytes."""
    rng = np.random.default_rng(3)
    for n in range(2, 16):
        jc = JColumn.from_numpy(_floats(rng, n, False))
        _same(jops.reduce_column(jc, "sum"),
              ops.reduce_column(_port(jc), "sum"), f"{n}")


@pytest.mark.parametrize("n", SIZES)
def test_arg_extreme_and_extreme_by(columns, n):
    if n == 0:
        return  # the JAX package's min over 0 rows raises
    c = columns[n]
    for by in ("f", "g", "i", "u", "d", "b", "allnull"):
        for op in ("argmin", "argmax"):
            _same(jops.arg_extreme(c[by], op),
                  ops.arg_extreme(_port(c[by]), op), f"{op} {by}")
        for op in ("min_by", "max_by"):
            _same(jops.extreme_by(c["i32"], c[by], op),
                  ops.extreme_by(_port(c["i32"]), _port(c[by]), op),
                  f"{op} {by}")


def test_reduce_errors():
    jc = JColumn.from_numpy(np.arange(3))
    pc = _port(jc)
    for fn, args, err in ((ops.reduce_column, (pc, "median"), ValueError),
                          (ops.reduce_column, (pc, "any"), TypeError),
                          (ops.arg_extreme, (pc, "argfoo"), ValueError),
                          (ops.extreme_by, (pc, pc, "mid_by"), ValueError)):
        with pytest.raises(err):
            fn(*args)


#: (size, aggregation, value types): FLOAT64 at every size (the
#: associative scan's odd/even edges), FLOAT32 where the JAX side's
#: eager scan (an XLA compile per level, shape, dtype and operator)
#: stays affordable, the integer types jitted
SCAN_CASES = [
    *((n, agg, ("f", "b", "u16")) for n in (0, 1)
      for agg in ("sum", "product", "min", "max")),
    *((2, agg, ("f", "g", "i", "u", "u16", "d", "b"))
      for agg in ("sum", "product", "min", "max")),
    (1023, "sum", ("f",)), (1024, "sum", ("f",)), (1024, "max", ("f",)),
    *((1025, agg, ("f", "i")) for agg in ("sum", "min", "max")),
    (1025, "product", ("f", "p", "i", "i3", "odd", "uodd")),
]


@pytest.mark.parametrize("n,agg,names", SCAN_CASES)
def test_scan(columns, n, agg, names):
    for name in names:
        jc = columns[n][name]
        ref = jops.scan if _is_float(jc) else INT_SCAN
        for inclusive in (True, False):
            _same(ref(jc, agg, inclusive),
                  ops.scan(_port(jc), agg, inclusive),
                  f"{agg} {name} {inclusive}")


def test_scan_first_nan_rule():
    """The associative scan's float adds keep x86's NaN rule: +inf and
    -inf meeting give the same NaN rows as the JAX package."""
    rng = np.random.default_rng(9)
    f = _floats(rng, 1025)
    jc = JColumn.from_numpy(f)
    _same(jops.scan(jc, "sum"), ops.scan(_port(jc), "sum"))


QS = (0.0, 0.25, 0.5, 0.75, 0.95, 1.0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("how", ["linear", "lower", "higher", "midpoint",
                                 "nearest"])
def test_quantile(columns, n, how):
    for name in ("f", "g", "i", "u16", "d", "allnull"):
        jc = columns[n][name]
        got = ops.quantile(_port(jc), QS, how)
        if n == 0:
            # the JAX package's gather raises on 0 rows; the port gives
            # one null a fraction
            assert got.validity.tolist() == [False] * len(QS)
            continue
        _same(jops.quantile(jc, QS, how), got, f"{how} {name}")


def test_quantile_signed_zeros_and_timestamps():
    """-0.0 sorts before +0.0 (jnp.sort's total order), and TIMESTAMP
    columns take quantiles of their ticks."""
    vals = np.array([0.0, -0.0, 0.0, -0.0, 1.0, -1.0, 0.0])
    jc = JColumn.from_numpy(vals)
    for how in ("lower", "higher", "nearest"):
        _same(jops.quantile(jc, [0.3, 0.5, 0.6], how),
              ops.quantile(_port(jc), [0.3, 0.5, 0.6], how), how)
    jt = JColumn.from_numpy(np.array([5, -3, 9, 0], np.int32), dtype=TS_DAYS)
    _same(jops.quantile(jt, QS), ops.quantile(_port(jt), QS))
    with pytest.raises(ValueError, match="quantile fractions"):
        ops.quantile(_port(jc), [1.5])
    with pytest.raises(ValueError, match="unknown interpolation"):
        ops.quantile(_port(jc), [0.5], "cubic")
