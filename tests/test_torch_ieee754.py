"""The port's float64 <-> bits codec (``utils/ieee754.py``) against the
JAX package's, bit for bit on the CPU: normals, signed zeros, infinities,
subnormals (flushed by the arithmetic codec, kept by the bitcast) and
NaN payloads of both signs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.utils import ieee754 as jieee
from spark_rapids_jni_tpu_torch.utils import ieee754

_CLASSES = {
    "normals": [1.0, -1.5, 3.141592653589793, 1e300, -1e-300,
                2.2250738585072014e-308, 1.7976931348623157e308],
    "zeros": [0.0, -0.0],
    "infinities": [np.inf, -np.inf],
    "subnormals": [5e-324, -5e-324, 2.225073858507201e-308,
                   -1.1125369292536007e-308],
}
_NAN_BITS = [0x7FF8000000000000, 0xFFF8000000000000, 0x7FF0000000000001,
             0xFFF0000000000001, 0x7FF8000000000123, 0xFFFFFFFFFFFFFFFF,
             0x7FFFFFFFFFFFFFFF]


def _values(cls: str) -> np.ndarray:
    if cls == "nans":
        return np.array(_NAN_BITS, np.uint64).view(np.float64)
    if cls == "random":
        bits = np.random.default_rng(5).integers(
            0, np.iinfo(np.uint64).max, 4096, dtype=np.uint64,
            endpoint=True)
        return bits.view(np.float64)
    return np.array(_CLASSES[cls], np.float64)


def _np_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int64).numpy().view(np.uint64)


CLASSES = sorted(_CLASSES) + ["nans", "random"]


@pytest.mark.parametrize("cls", CLASSES)
def test_f64_to_bits_matches_jax(cls):
    x = _values(cls)
    want = np.asarray(jieee.f64_to_bits(jnp.asarray(x)))
    got = _np_bits(ieee754.f64_to_bits(torch.from_numpy(x.copy())))
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("cls", CLASSES)
def test_bits_to_f64_matches_jax(cls):
    bits = _values(cls).view(np.uint64)
    want = np.asarray(jieee.bits_to_f64(jnp.asarray(bits))).view(np.uint64)
    for t in (torch.from_numpy(bits.view(np.int64).copy()),
              torch.from_numpy(bits.view(np.int64).copy()).view(torch.uint64)):
        got = ieee754.bits_to_f64(t).view(torch.int64).numpy().view(np.uint64)
        assert got.tolist() == want.tolist()


@pytest.mark.parametrize("cls", CLASSES)
def test_bitcasts_match_jax(cls):
    x = _values(cls)
    want = np.asarray(jieee.float_to_bits(jnp.asarray(x)))
    got = _np_bits(ieee754.float_to_bits(torch.from_numpy(x.copy())))
    assert got.tolist() == want.tolist() == x.view(np.uint64).tolist()
    back = np.asarray(jieee.bits_to_float(jnp.asarray(want))).view(np.uint64)
    got_back = ieee754.bits_to_float(torch.from_numpy(
        want.view(np.int64).copy())).view(torch.int64).numpy()
    assert got_back.view(np.uint64).tolist() == back.tolist()
