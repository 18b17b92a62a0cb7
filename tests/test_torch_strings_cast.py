"""CAST to and from STRING and STRING comparisons: the port against the
JAX package on the CPU (``ops/strings.py`` and ``ops/ryu.py`` of both).

Inputs are made with numpy from fixed seeds. Tolerance 0: the result's
data bytes, validity, lengths and pad width equal. The edges: Java's
``Double.toString`` switches notation at 1e-3 and 1e7 (values either
side), signed zeros, NaN, the infinities, subnormal FLOAT64 and FLOAT32
values as values and as strings, exact-halfway Ryu mantissas, 19- and
20-digit integers, INT64_MIN, unparseable and non-ASCII strings (null).
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.ops import binaryop as jbinaryop
from spark_rapids_jni_tpu.ops import strings as jstrings
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch.column import Column, storage_to_host
from spark_rapids_jni_tpu_torch.ops import binaryop, ryu
from spark_rapids_jni_tpu_torch.ops.cast import cast

EDGE64 = [
    0.0, -0.0, 1.0, -1.0, 0.5, 0.1, 0.3, 1e-3, 9.999e-4, 0.0009999999999999998,
    0.0010000000000000002, 1e7, 9999999.999999998, 10000000.000000002,
    9999999.5, 123456.789, 5e-324, -5e-324, 4.9e-324, 1e-320,
    2.2250738585072014e-308, 2.225073858507201e-308,
    1.7976931348623157e308, 1 / 3, 2 / 3, 1e22, 1e23, 8e9, 3.14159, 100.0,
    4.0, 2.0 ** -24, -(2.0 ** -24), 2.0 ** -96, 5.986310706507379e51,
    2.0 ** 122, 2.0 ** -120, 199.99, 0.01, 123.45,
    float("nan"), float("inf"), float("-inf"),
]
EDGE32 = [0.0, -0.0, 1.0, 0.1, 1e-3, 9.999e-4, 1e7, 9999999.0, 1.0e8,
          1.4e-45, 1e-40, 1.1754944e-38, 3.4028235e38, 2.0 ** -24,
          16777216.0, 0.3, float("nan"), float("-inf")]

STRINGS = [
    "0", "-0", "+5", "42", " 42 ", "\t-7\n", "3.7", "-3.7", ".5", "5.",
    "1e3", "1E-3", "-2.5e+2", "1e", "e5", "1.2.3", "1e2e3", "abc", "",
    "-", "+", "0x10", "9223372036854775807", "9223372036854775808",
    "-9223372036854775808", "-9223372036854775809", "12345678901234567890",
    "0000000000000000000001", "128", "-129", "255", "256", "65535", "65536",
    "4294967295", "4294967296", "NaN", "nan", "-Infinity", "inf", "+inf",
    "INFINITY", "4.9E-324", "2.2250738585072014E-308", "1.4E-45", "1e-46",
    "1e-400", "1e400", "1.7976931348623157E308", "0.000000000000000000001234",
    "123456789012345678901234567890", "3.4028235E38", "3.5e38",
    "true", "FALSE", " yes ", "No", "t", "f", "y", "n", "1", "2", "tru",
    "1.239", "-0.005", "12345678.9", "99999999.99", "é1", "１", "1 2", None,
]

INT_TYPES = [(jdt.INT8, dt.INT8, np.int8), (jdt.INT16, dt.INT16, np.int16),
             (jdt.INT32, dt.INT32, np.int32), (jdt.INT64, dt.INT64, np.int64),
             (jdt.UINT8, dt.UINT8, np.uint8),
             (jdt.UINT16, dt.UINT16, np.uint16),
             (jdt.UINT32, dt.UINT32, np.uint32)]


def _same(j: JColumn, p: Column) -> None:
    """Equal data bytes (and shape), validity, lengths and dtype."""
    assert (j.dtype.id.value, j.dtype.scale) == (p.dtype.id.value,
                                                 p.dtype.scale)
    jd = np.asarray(j.data)
    pd = storage_to_host(p.data, p.dtype)
    assert jd.shape == pd.shape
    np.testing.assert_array_equal(jd.view(np.uint8), pd.view(np.uint8))
    jv = None if j.validity is None else np.asarray(j.validity)
    pv = None if p.validity is None else p.validity.numpy()
    if jv is None or pv is None:
        assert jv is None and pv is None
    else:
        np.testing.assert_array_equal(jv, pv)
    if j.lengths is None:
        assert p.lengths is None
    else:
        np.testing.assert_array_equal(np.asarray(j.lengths), p.lengths.numpy())


def _pair(arr, valid, jd, pd):
    return (JColumn.from_numpy(arr, valid, jd),
            Column.from_numpy(arr, valid, pd, device="cpu"))


def _strings(vals):
    return JColumn.from_strings(vals), Column.from_strings(vals, device="cpu")


def _random_f64(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    return np.concatenate([np.array(EDGE64), bits.view(np.float64),
                           np.round(rng.random(n) * 200, 2)])


@pytest.mark.parametrize("kind", ["edges_and_random", "prices"])
def test_float64_to_string_and_back(kind):
    rng = np.random.default_rng(3)
    vals = (_random_f64(700, 5) if kind == "edges_and_random"
            else np.round(rng.random(1025) * 200, 2))
    valid = rng.random(vals.shape[0]) > 0.05
    j, p = _pair(vals, valid, jdt.FLOAT64, dt.FLOAT64)
    js, ps = jstrings.cast(j, jdt.STRING), cast(p, dt.STRING)
    _same(js, ps)
    _same(jstrings.cast(js, jdt.FLOAT64), cast(ps, dt.FLOAT64))
    # the round trip gives back the same bits (NaN as NaN)
    back = cast(ps, dt.FLOAT64).to_numpy()
    ok = valid & ~np.isnan(vals)
    np.testing.assert_array_equal(back[ok].view(np.uint64),
                                  vals[ok].view(np.uint64))


def test_float32_to_string_and_back():
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 1 << 32, 800, dtype=np.uint64).astype(np.uint32)
    sub = rng.integers(1, 1 << 23, 100, dtype=np.uint64).astype(np.uint32)
    vals = np.concatenate([np.array(EDGE32, np.float32), bits.view(np.float32),
                           sub.view(np.float32)])
    j, p = _pair(vals, None, jdt.FLOAT32, dt.FLOAT32)
    js, ps = jstrings.cast(j, jdt.STRING), cast(p, dt.STRING)
    _same(js, ps)
    _same(jstrings.cast(js, jdt.FLOAT32), cast(ps, dt.FLOAT32))


@pytest.mark.parametrize("to", ["FLOAT64", "FLOAT32", "BOOL8"])
def test_string_to_float_and_bool(to):
    j, p = _strings(STRINGS)
    _same(jstrings.cast(j, getattr(jdt, to)), cast(p, getattr(dt, to)))


@pytest.mark.parametrize("jd,pd,np_t", INT_TYPES,
                         ids=[t[2].__name__ for t in INT_TYPES])
def test_integers_to_string_and_back(jd, pd, np_t):
    info = np.iinfo(np_t)
    rng = np.random.default_rng(2)
    vals = np.concatenate([
        np.array([0, 1, 9, 10, 99, 100, info.min, info.max], np_t),
        rng.integers(info.min, info.max, 1017, dtype=np_t, endpoint=True)])
    valid = rng.random(vals.shape[0]) > 0.1
    j, p = _pair(vals, valid, jd, pd)
    js, ps = jstrings.cast(j, jdt.STRING), cast(p, dt.STRING)
    _same(js, ps)
    _same(jstrings.cast(js, jd), cast(ps, pd))
    sj, sp = _strings(STRINGS)
    _same(jstrings.cast(sj, jd), cast(sp, pd))


def test_bool_to_string():
    j, p = _pair(np.array([True, False, True, False]),
                 np.array([True, True, False, True]), jdt.BOOL8, dt.BOOL8)
    _same(jstrings.cast(j, jdt.STRING), cast(p, dt.STRING))


@pytest.mark.parametrize("scale", [-3, -2, 0, 2])
@pytest.mark.parametrize("tid", ["DECIMAL32", "DECIMAL64"])
def test_decimals_to_string_and_back(tid, scale):
    np_t = np.int32 if tid == "DECIMAL32" else np.int64
    info = np.iinfo(np_t)
    rng = np.random.default_rng(scale + 10)
    vals = np.concatenate([np.array([0, 1, -1, 5, -5, 123, -1000, info.min,
                                     info.max], np_t),
                           rng.integers(-10**6, 10**6, 300).astype(np_t)])
    jd = jdt.DType(getattr(jdt.TypeId, tid), scale)
    pd = dt.DType(getattr(dt.TypeId, tid), scale)
    j, p = _pair(vals, None, jd, pd)
    js, ps = jstrings.cast(j, jdt.STRING), cast(p, dt.STRING)
    _same(js, ps)
    _same(jstrings.cast(js, jd), cast(ps, pd))
    sj, sp = _strings(STRINGS)
    _same(jstrings.cast(sj, jd), cast(sp, pd))


def test_decimal128_string_casts_raise():
    """They ran into NotImplementedError before ops/int128.py; now they
    give Spark's strings and values, and an unparseable string is null
    (tests/test_torch_decimal128.py holds them to the JAX package)."""
    limbs = Column(torch.zeros((3, 2), dtype=torch.int64),
                   dt.DType(dt.TypeId.DECIMAL128, -2))
    assert cast(limbs, dt.STRING).to_pylist() == ["0.00"] * 3
    s = Column.from_strings(["1.5", None, "x"], device="cpu")
    assert cast(s, dt.DType(dt.TypeId.DECIMAL128, -2)).to_pylist() == [
        150, None, None]


def test_digits_and_eisel_lemire_cores():
    """Ryu's digits and exponents and Eisel-Lemire's bits over random bit
    patterns, core to core."""
    from spark_rapids_jni_tpu.ops import ryu as jryu

    vals = _random_f64(3000, 9)
    bits = vals.view(np.uint64)
    want = jryu.shortest_decimal64(bits)
    got = ryu.shortest_decimal64(torch.from_numpy(bits.view(np.int64)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy().astype(np.int64))
    rng = np.random.default_rng(4)
    w64 = rng.integers(0, 1 << 64, 3000, dtype=np.uint64)
    w64[:100] = 10 ** rng.integers(0, 20, 100).astype(np.uint64)
    q = rng.integers(-360, 330, 3000).astype(np.int32)
    for bits64 in (True, False):
        want = np.asarray(jryu.decimal_to_bits(w64, q, bits64=bits64))
        got = ryu.decimal_to_bits(torch.from_numpy(w64.view(np.int64)),
                                  torch.from_numpy(q), bits64=bits64)
        np.testing.assert_array_equal(want.view(np.int64), got.numpy())


PAIRS = [("apple", "apple"), ("apple", "apples"), ("b", "a"), ("", ""),
         ("", "a"), ("a\x00", "a"), ("\xff", "a"), ("é", "e"), (None, "x"),
         ("same long string 123", "same long string 124"), ("z", None)]


@pytest.mark.parametrize("op", ["eq", "ne", "lt", "le", "gt", "ge", "add"])
def test_string_comparisons_and_concat(op):
    left = [a for a, _ in PAIRS]
    right = [b for _, b in PAIRS]
    ja, pa = _strings(left)
    jb, pb = _strings(right)  # a different pad width
    _same(jbinaryop.binary_op(op, ja, jb), binaryop.binary_op(op, pa, pb))
    with pytest.raises(TypeError, match="not supported for strings"):
        binaryop.binary_op("mul", pa, pb)
