"""The port's ``ops/cast.py`` against the JAX package's, byte for byte,
for every pair of the fixed-width types the cast takes: the signed and
unsigned integers, FLOAT32/FLOAT64, BOOL8, DECIMAL32/DECIMAL64 at two
scales each, and TIMESTAMP_DAYS.

Inputs carry nulls and each type's edge values; floating inputs carry
NaN, +-inf, -0.0, halves (rounding) and values past every integer
range, where the JAX package saturates and maps NaN to 0. Tolerance 0:
every byte of data (null rows included) and validity must be equal.
"""

import numpy as np
import pytest

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.ops.cast import cast as jax_cast
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops.cast import cast as port_cast

N = 300
TYPES = {
    "i8": jdt.INT8, "i16": jdt.INT16, "i32": jdt.INT32, "i64": jdt.INT64,
    "u8": jdt.UINT8, "u16": jdt.UINT16, "u32": jdt.UINT32, "u64": jdt.UINT64,
    "f32": jdt.FLOAT32, "f64": jdt.FLOAT64, "b": jdt.BOOL8,
    "d32": jdt.decimal32(-2), "d32p": jdt.decimal32(1),
    "d64": jdt.decimal64(-4), "d64z": jdt.decimal64(0),
    "ts_days": jdt.TIMESTAMP_DAYS,
}
FLOAT_EDGES = [np.nan, np.inf, -np.inf, 1e20, -1e20, 300.7, -300.7, 2.5,
               -2.5, 0.5, -0.5, 1.5, -0.0, 0.0, 2.0**63, -2.0**63, 2.0**64,
               1.8e19, 65535.5, 4294967296.0, 0.125, 0.005, -0.015]


def _values(d, rng) -> np.ndarray:
    np_t = np.dtype(d.storage_dtype) if d.id != jdt.TypeId.FLOAT64 else np.dtype(np.float64)
    if np_t == np.bool_:
        return rng.random(N) > 0.5
    if np_t.kind == "f":
        v = (rng.standard_normal(N) * 10.0 ** rng.integers(-3, 12, N)).astype(np_t)
        with np.errstate(over="ignore"):
            v[:len(FLOAT_EDGES)] = np.array(FLOAT_EDGES).astype(np_t)
        return v
    info = np.iinfo(np_t)
    v = rng.integers(info.min, info.max, N, dtype=np_t, endpoint=True)
    v[N // 2:] = rng.integers(max(info.min, -999), 1000, N - N // 2)
    edges = [info.min, info.max, 0, 1, 127, 128, 255, 256, 65535, 65536]
    v[:len(edges)] = [np.array(e).astype(np_t) for e in edges]  # wrapping
    return v


def _column(kind: str, seed: int) -> JColumn:
    rng = np.random.default_rng(seed)
    d = TYPES[kind]
    return JColumn.from_numpy(_values(d, rng), validity=rng.random(N) > 0.1,
                              dtype=d if d.is_decimal or d.is_timestamp else None)


def _port(col: JColumn):
    return interop.table_from_buffers(
        [(np.asarray(col.data),
          None if col.validity is None else np.asarray(col.validity), None,
          int(col.dtype.id), int(col.dtype.scale))], device="cpu").columns[0]


def _same(want: JColumn, got, what: str) -> None:
    buf = interop.column_to_buffers(got)
    assert (int(want.dtype.id), int(want.dtype.scale)) == buf[3:], what
    if want.validity is None:
        assert buf[1] is None, f"{what}: validity"
    else:
        np.testing.assert_array_equal(np.asarray(want.validity), buf[1],
                                      err_msg=f"{what}: validity")
    wd = np.asarray(want.data)
    assert wd.dtype == buf[0].dtype, what
    np.testing.assert_array_equal(wd, buf[0], err_msg=f"{what}: data")


@pytest.mark.parametrize("dst", sorted(TYPES))
@pytest.mark.parametrize("src", sorted(TYPES))
def test_cast_matches_jax(src, dst):
    col = _column(src, 7)
    to = TYPES[dst]
    want = jax_cast(col, to)
    got = port_cast(_port(col), dt.DType.from_wire(*to.to_wire()))
    _same(want, got, f"{src} -> {dst}")


PROBE = np.array([np.nan, np.inf, -np.inf, 1e20, -1e20, 300.7, -300.7, 2.5])


@pytest.mark.parametrize("to,expect", [
    ("i8", [0, 127, -128, 127, -128, 127, -128, 2]),
    ("u8", [0, 255, 0, 255, 0, 255, 0, 2]),
    ("i64", [0, 2**63 - 1, -2**63, 2**63 - 1, -2**63, 300, -300, 2]),
    ("b", [True] * 8),
])
def test_float_to_integer_probe(to, expect):
    """FLOAT64 -> integer saturates and maps NaN to 0 (-> BOOL8 is != 0)."""
    col = JColumn.from_numpy(PROBE)
    got = port_cast(_port(col), dt.DType.from_wire(*TYPES[to].to_wire()))
    assert got.data.tolist() == expect
    _same(jax_cast(col, TYPES[to]), got, f"probe -> {to}")


def test_unported_casts_raise():
    import torch
    from spark_rapids_jni_tpu_torch.column import Column

    i64 = Column(torch.zeros(3, dtype=torch.int64), dt.INT64)
    # DECIMAL128 casts run now (tests/test_torch_decimal128.py); a float
    # to DECIMAL128 raises, as in the JAX package
    d128 = port_cast(i64, dt.DType(dt.TypeId.DECIMAL128, -2))
    assert d128.to_pylist() == [0, 0, 0]
    assert port_cast(d128, dt.DType(dt.TypeId.STRING)).to_pylist() == [
        "0.00"] * 3
    f64 = Column(torch.zeros(3, dtype=torch.int64), dt.FLOAT64)
    with pytest.raises(TypeError, match="cannot cast"):
        port_cast(f64, dt.DType(dt.TypeId.DECIMAL128, -2))
