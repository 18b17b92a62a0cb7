"""The port's ``sample`` and its PRNG against ``jax.random``, on the CPU.

The port writes JAX's threefry2x32 on int64 tensors carrying u32 words:
``PRNGKey`` (the seed's int64 bit pattern as two words), ``split`` and
32-bit ``random_bits`` under ``jax_threefry_partitionable`` (JAX 0.9.0's
default), ``permutation`` (``_shuffle``: a stable sort of the rows by 32
fresh bits, ceil(3 ln n / ln(2^32 - 1)) rounds) and ``randint`` with
64-bit integers. Tolerance 0: the same rows for every seed and size,
including 0 and 1 rows, the 1023-1025 edges, 1,626 rows (the second
shuffle round's start) and 2^20 + 1.
"""

import jax
import numpy as np
import pytest

from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import copying as jcp
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops import copying as pcp

SEEDS = [0, 1, 42, 2**31 - 1, 2**32 + 5, -7, 123456789012]
SIZES = [0, 1, 2, 1023, 1024, 1025, 1626, (1 << 20) + 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(x) for x in np.asarray(key)) == pcp.prng_key(seed)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_matches_jax(seed, n):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = pcp.permutation(pcp.prng_key(seed), n, "cpu").numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("n", SIZES[1:])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed, n):
    span = max(n // 3, 1)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0,
                                         span))
    got = pcp.randint(pcp.prng_key(seed), n, span, "cpu").numpy()
    np.testing.assert_array_equal(want, got)


def _table(n: int) -> JTable:
    rng = np.random.default_rng(n)
    return JTable([JColumn.from_numpy(rng.integers(0, 99, n),
                                      validity=rng.random(n) > 0.2),
                   JColumn.from_numpy(rng.standard_normal(n))], ["a", "b"])


def _port(jt: JTable):
    return interop.table_from_buffers(
        [(np.asarray(c.data),
          None if c.validity is None else np.asarray(c.validity), None,
          int(c.dtype.id), 0) for c in jt.columns], jt.names, device="cpu")


@pytest.mark.parametrize("replacement", [False, True])
@pytest.mark.parametrize("rows,n", [(1, 1), (1025, 0), (1025, 1024),
                                    (1023, 5000)])
def test_sample_matches_jax(rows, n, replacement):
    jt = _table(rows)
    if n > rows and not replacement:
        with pytest.raises(ValueError, match="sample of"):
            pcp.sample(_port(jt), n, seed=3)
        return
    for seed in (0, 3):
        want = jcp.sample(jt, n, seed=seed, replacement=replacement)
        got = interop.table_to_buffers(
            pcp.sample(_port(jt), n, seed=seed, replacement=replacement))
        for c, (data, valid, *_rest) in zip(want.columns, got):
            np.testing.assert_array_equal(np.asarray(c.data), data)
            np.testing.assert_array_equal(np.asarray(c.validity)
                                          if c.validity is not None else None,
                                          valid)


def test_sample_with_replacement_from_no_rows_raises():
    with pytest.raises(ValueError, match="empty table"):
        pcp.sample(_port(_table(0)), 3, replacement=True)
