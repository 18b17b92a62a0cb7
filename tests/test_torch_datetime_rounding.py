"""The port's datetime fields and arithmetic (``ops/datetime.py``),
rounding (``ops/rounding.py``) and the replace family
(``ops/replace.py``) against the JAX package's, on the CPU, and the
TIMESTAMP/DURATION carry-across of ``interop``.

Both packages get the same numpy inputs from a seed; the JAX functions
run eagerly, as its own tests call them. The functions under test work
row by row (all but ``replace_nulls_policy``), so the JAX side takes
every size's rows in one call and each size's result is its slice of
that call: the bytes of one call a size, at one XLA compile instead of
six. The port runs once a size. Tolerance 0: data bytes,
validity, dtype (a NaN equals a NaN whatever its sign bit). Sizes 0, 1,
2, 1023, 1024, 1025; dates before 1970 and before year 1, TIMESTAMP_DAYS
as int32, nanosecond ticks near +-2^63; floats with NaN, +-0.0, +-inf
and subnormals; decimals and integers at every rounding shift up to and
past the width (a power of ten that wraps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.ops import datetime as jdtm
from spark_rapids_jni_tpu_torch import dtype as pdt
from spark_rapids_jni_tpu_torch import interop, ops
from spark_rapids_jni_tpu_torch.ops import datetime as pdtm

SIZES = (0, 1, 2, 1023, 1024, 1025)
#: each size's first row in the concatenation of every size's rows
OFFSETS = dict(zip(SIZES, np.cumsum((0, *SIZES[:-1])).tolist()))
FLOAT_VIEW = {10: np.float64, 9: np.float32}
T = jdt.TypeId
TS_UNITS = (T.TIMESTAMP_DAYS, T.TIMESTAMP_SECONDS, T.TIMESTAMP_MILLISECONDS,
            T.TIMESTAMP_MICROSECONDS, T.TIMESTAMP_NANOSECONDS)
FIELDS = ("year", "month", "day", "hour", "minute", "second", "weekday",
          "day_of_year", "quarter", "last_day_of_month",
          "millisecond_fraction", "microsecond_fraction",
          "nanosecond_fraction", "day_of_week_sunday")
UNITS = ("year", "quarter", "month", "week", "day", "hour", "minute",
         "second")


def _bufs(c: JColumn):
    return (np.asarray(c.data),
            None if c.validity is None else np.asarray(c.validity),
            None if c.lengths is None else np.asarray(c.lengths),
            int(c.dtype.id), int(c.dtype.scale))


def _port(jc: JColumn):
    return interop.column_from_buffers(*_bufs(jc), device="cpu")


def _same(jc, pc, what="") -> None:
    """``jc`` (a JAX column or its buffers) against the port's column."""
    w = jc if isinstance(jc, tuple) else _bufs(jc)
    g = interop.column_to_buffers(pc)
    assert w[3:] == g[3:], f"{what} type"
    for part, a, b in zip(("data", "validity", "lengths"), w[:3], g[:3]):
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


def _concat(cols) -> JColumn:
    """One JAX column holding every size's rows, in ``SIZES`` order."""
    c0 = cols[0]
    data = np.concatenate([np.asarray(c.data) for c in cols])
    valid = (None if c0.validity is None else
             jnp.asarray(np.concatenate([np.asarray(c.validity)
                                         for c in cols])))
    return JColumn(jnp.asarray(data), c0.dtype, valid)


_ROWS: dict = {}


def _jax_rows(n: int, key, fn, *args):
    """The buffers of ``fn(*args)`` at size ``n``: the slice of one call
    over every size's rows (``args`` hold the concatenated columns), kept
    under ``key`` for the other sizes."""
    if key not in _ROWS:
        _ROWS[key] = _bufs(fn(*args))
    data, valid, _, tid, scale = _ROWS[key]
    rows = slice(OFFSETS[n], OFFSETS[n] + n)
    return data[rows], None if valid is None else valid[rows], None, tid, scale


def _ticks(rng, n: int, unit) -> JColumn:
    """Ticks of ``unit`` spread over +-400,000 years (dates before year 1
    and before 1970), with the int64 extremes for sub-day units and the
    int32 extremes for TIMESTAMP_DAYS; ~10 % null."""
    if unit == T.TIMESTAMP_DAYS:
        v = rng.integers(-146_000_000, 146_000_000, n).astype(np.int32)
        ext = np.array([np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                        -719_163, -719_162, 0, -1], np.int32)
    else:
        per_day = {T.TIMESTAMP_SECONDS: 86_400,
                   T.TIMESTAMP_MILLISECONDS: 86_400_000,
                   T.TIMESTAMP_MICROSECONDS: 86_400_000_000,
                   T.TIMESTAMP_NANOSECONDS: 86_400_000_000_000}[unit]
        span = min(146_000_000 * per_day, 2**63 - 1)
        v = rng.integers(-span, span, n)
        big = np.iinfo(np.int64)
        ext = np.array([big.min, big.max, big.min + 1, big.max - 1, -1, 0])
    k = min(n, len(ext))
    v[:k] = ext[:k]
    return JColumn.from_numpy(v, validity=rng.random(n) > 0.1,
                              dtype=jdt.DType(unit))


@pytest.fixture(scope="module")
def ticks():
    """Per (size, unit) the column; per unit alone every size's rows."""
    rng = np.random.default_rng(1)
    out = {(n, u): _ticks(rng, n, u) for n in SIZES for u in TS_UNITS}
    for u in TS_UNITS:
        out[u] = _concat([out[n, u] for n in SIZES])
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("unit", TS_UNITS, ids=lambda u: u.name)
def test_fields(ticks, n, unit):
    pc = _port(ticks[n, unit])
    for f in FIELDS:
        _same(_jax_rows(n, (f, unit), getattr(jdtm, f), ticks[unit]),
              getattr(pdtm, f)(pc), f)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("unit", TS_UNITS, ids=lambda u: u.name)
def test_truncate(ticks, n, unit):
    pc = _port(ticks[n, unit])
    for u in UNITS:
        _same(_jax_rows(n, ("truncate", unit, u), jdtm.truncate,
                        ticks[unit], u),
              pdtm.truncate(pc, u), u)
    with pytest.raises(ValueError, match="unknown unit"):
        pdtm.truncate(pc, "fortnight")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("unit", (T.TIMESTAMP_DAYS, T.TIMESTAMP_MICROSECONDS),
                         ids=lambda u: u.name)
def test_add_calendrical_months(ticks, n, unit):
    pc = _port(ticks[n, unit])
    for delta in (1, -13, 0, 1200):
        _same(_jax_rows(n, ("add_months", unit, delta),
                        jdtm.add_calendrical_months, ticks[unit], delta),
              pdtm.add_calendrical_months(pc, delta), f"{delta}")
    months = {}
    for m in SIZES:
        rng = np.random.default_rng(m)
        months[m] = JColumn.from_numpy(
            rng.integers(-30, 30, m).astype(np.int32),
            validity=rng.random(m) > 0.2)
    _same(_jax_rows(n, ("add_months", unit, "column"),
                    jdtm.add_calendrical_months, ticks[unit],
                    _concat([months[m] for m in SIZES])),
          pdtm.add_calendrical_months(pc, _port(months[n])), "column")


def test_field_errors_and_dtypes():
    pc = _port(JColumn.from_numpy(np.arange(3)))
    with pytest.raises(TypeError, match="expected a timestamp column"):
        pdtm.year(pc)
    days = _port(JColumn.from_numpy(np.array([0, 59], np.int32),
                                    dtype=jdt.DType(T.TIMESTAMP_DAYS)))
    assert pdtm.year(days).data.dtype.itemsize == 2  # INT16 out
    assert pdtm.last_day_of_month(days).dtype == pdt.TIMESTAMP_DAYS


@pytest.mark.parametrize("tid", [*TS_UNITS, T.DURATION_DAYS,
                                 T.DURATION_SECONDS, T.DURATION_MILLISECONDS,
                                 T.DURATION_MICROSECONDS,
                                 T.DURATION_NANOSECONDS], ids=lambda t: t.name)
def test_time_units_carry_across(tid):
    """TIMESTAMP_* and DURATION_* buffers carry across with their unit:
    the type id and the storage width both survive, and a buffer of
    another width is refused."""
    rng = np.random.default_rng(int(tid))
    dtype = jdt.DType(tid)
    width = np.int32 if tid in (T.TIMESTAMP_DAYS, T.DURATION_DAYS) \
        else np.int64
    jc = JColumn.from_numpy(rng.integers(-10**6, 10**6, 17).astype(width),
                            validity=rng.random(17) > 0.3, dtype=dtype)
    pc = _port(jc)
    assert pc.dtype.id == tid and pc.data.dtype.itemsize == dtype.itemsize
    _same(jc, pc)
    wrong = np.int64 if width == np.int32 else np.int32
    bad = (np.asarray(jc.data).astype(wrong), None, None, int(tid), 0)
    with pytest.raises(TypeError, match="buffer must be"):
        interop.column_from_buffers(*bad, device="cpu")


def _floats(rng, n):
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-4, 6, n)
    f[rng.random(n) < 0.1] = np.round(f[rng.random(n) < 0.1][:1] * 2, 0) / 2 \
        if n else f[:0]
    for frac, v in ((0.03, np.nan), (0.03, -0.0), (0.03, 0.0), (0.02, np.inf),
                    (0.02, -np.inf), (0.03, 5e-324), (0.03, -2.5e-310),
                    (0.05, 2.5), (0.05, -2.5), (0.05, 0.125), (0.05, -0.35)):
        f[rng.random(n) < frac] = v
    return f


def _numeric(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def ok():
        return rng.random(n) > 0.15

    f = _floats(rng, n)
    i = rng.integers(-10**6, 10**6, n)
    big = np.iinfo(np.int64)
    i[rng.random(n) < 0.05] = big.max
    i[rng.random(n) < 0.05] = big.min
    i[rng.random(n) < 0.05] = -250
    u = rng.integers(0, 2**64, n, dtype=np.uint64)
    u[rng.random(n) < 0.1] = 250
    return {
        "f": JColumn.from_numpy(f, validity=ok()),
        "g": JColumn.from_numpy(f.astype(np.float32), validity=ok()),
        "i": JColumn.from_numpy(i, validity=ok()),
        "i8": JColumn.from_numpy(rng.integers(-128, 128, n).astype(np.int8)),
        "u": JColumn.from_numpy(u, validity=ok()),
        "u8": JColumn.from_numpy(rng.integers(0, 256, n).astype(np.uint8)),
        "u32": JColumn.from_numpy(rng.integers(0, 2**32, n).astype(
            np.uint32), validity=ok()),
        "d32": JColumn.from_numpy(rng.integers(-10**9, 10**9, n).astype(
            np.int32), validity=ok(), dtype=jdt.decimal32(-4)),
        "d64": JColumn.from_numpy(i, validity=ok(), dtype=jdt.decimal64(-3)),
        "b": JColumn.from_numpy(rng.random(n) > 0.5, validity=ok()),
    }


@pytest.fixture(scope="module")
def numeric():
    """Per size the columns; under ``"all"`` every size's rows."""
    out = {n: _numeric(n, 300 + n) for n in SIZES}
    out["all"] = {k: _concat([out[n][k] for n in SIZES]) for k in out[0]}
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("how", ["half_up", "half_even"])
def test_round_floats(numeric, n, how):
    for name in ("f", "g"):
        for places in (0, 1, 2, -1, -3, 5):
            _same(_jax_rows(n, ("round", name, places, how),
                            jops.round_column, numeric["all"][name],
                            places, how),
                  ops.round_column(_port(numeric[n][name]), places, how),
                  f"{name} {places}")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("how", ["half_up", "half_even"])
def test_round_integers_and_decimals(numeric, n, how):
    """Every shift up to and past the width: 10**shift wraps in the
    column's own dtype, and a power that wraps to 0 gives 0."""
    cases = [("i", (0, -1, -2, -5, -18, -19, -20, -22)), ("i8", (-1, -2, -3, -8, -9)),
             ("u", (-1, -2, -19, -20, -21, -64)), ("u8", (-1, -2, -3, -8)),
             ("u32", (-1, -5, -9, -10, -11, -32)),
             ("d32", (2, 0, -1, -5, -6, -9)),
             ("d64", (3, 1, 0, -2, -15, -16, -17, -40))]
    for name, places_list in cases:
        pc = _port(numeric[n][name])
        for places in places_list:
            _same(_jax_rows(n, ("round", name, places, how),
                            jops.round_column, numeric["all"][name],
                            places, how),
                  ops.round_column(pc, places, how), f"{name} {places}")


def test_round_errors():
    pc = _port(JColumn.from_numpy(np.arange(3)))
    with pytest.raises(ValueError, match="unknown rounding mode"):
        ops.round_column(pc, 0, "ceiling")
    with pytest.raises(TypeError, match="round: unsupported dtype"):
        ops.round_column(_port(JColumn.from_numpy(np.ones(3, bool))), 0)


@pytest.fixture(scope="module")
def fill_policy():
    """The JAX ``replace_nulls_policy`` jitted: it fills from the row
    before or after (so it takes one size at a time), by moving values
    only, so jitted it gives the eager bytes at one compile a shape."""
    return jax.jit(jops.replace_nulls_policy, static_argnums=1)


@pytest.mark.parametrize("n", SIZES)
def test_replace_nulls(numeric, fill_policy, n):
    c, a = numeric[n], numeric["all"]
    for name, fill in (("f", 1.5), ("f", 7), ("g", -2.25), ("i", 42),
                       ("i", 3.9), ("u32", 7), ("d64", 12345), ("b", True),
                       ("u", 5)):
        _same(_jax_rows(n, ("fill", name, fill), jops.replace_nulls,
                        a[name], fill),
              ops.replace_nulls(_port(c[name]), fill), f"{name} {fill}")
    for name in ("f", "i", "u"):
        _same(_jax_rows(n, ("fill_self", name), jops.replace_nulls,
                        a[name], a[name]),
              ops.replace_nulls(_port(c[name]), _port(c[name])), name)
        other = jops.replace_nulls(c[name], 0)
        _same(_jax_rows(n, ("fill_other", name), lambda x: jops.replace_nulls(
                  x, jops.replace_nulls(x, 0)), a[name]),
              ops.replace_nulls(_port(c[name]), _port(other)), name)
        for policy in ("preceding", "following"):
            _same(fill_policy(c[name], policy),
                  ops.replace_nulls_policy(_port(c[name]), policy),
                  f"{name} {policy}")


def test_replace_nulls_strings_and_errors():
    vals = ["ab", None, "", "xyz", None]
    jc = JColumn.from_strings(vals)
    pc = _port(jc)
    _same(jops.replace_nulls(jc, "fill"), ops.replace_nulls(pc, "fill"))
    with pytest.raises(TypeError, match="replacement dtype mismatch"):
        ops.replace_nulls(_port(_numeric(4, 1)["i"]), _port(_numeric(4, 1)["f"]))
    with pytest.raises(ValueError, match="unknown fill policy"):
        ops.replace_nulls_policy(_port(_numeric(4, 1)["i"]), "sideways")
    with pytest.raises(ValueError, match="length mismatch"):
        ops.find_and_replace(pc, [1], [1, 2])


@pytest.mark.parametrize("n", SIZES)
def test_nans_clamp_find_replace(numeric, n):
    c, a = numeric[n], numeric["all"]
    for name in ("f", "g", "i"):
        _same(_jax_rows(n, ("nans", name), jops.nans_to_nulls, a[name]),
              ops.nans_to_nulls(_port(c[name])), name)
    for name, lo, hi in (("f", -1.0, 2.0), ("f", None, 0.0), ("g", 0.5, None),
                         ("i", -250, 10**5), ("u", 250, 2**63), ("u8", 3, 200),
                         ("d64", -5000, 5000), ("i8", None, 0)):
        _same(_jax_rows(n, ("clamp", name, lo, hi), jops.clamp, a[name], lo,
                        hi),
              ops.clamp(_port(c[name]), lo, hi), f"{name} {lo} {hi}")
    for name, old, new in (("f", [0.0, 2.5, np.inf], [9.0, -1.0, 0.0]),
                           ("g", [-2.5, 0.125], [1.0, 2.0]),
                           ("i", [-250, 2**63 - 1], [0, 1]),
                           ("i", [2.5, -250.0], [7, 8.9]),
                           ("u", [250], [2**64 - 1]),
                           ("u8", [3, 250], [250, 3])):
        _same(_jax_rows(n, ("find", name, *old), jops.find_and_replace,
                        a[name], old, new),
              ops.find_and_replace(_port(c[name]), old, new),
              f"{name} {old}")
