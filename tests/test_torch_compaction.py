"""The port's ``ops/compaction.py`` (distinct, distinct_capped,
distinct_count, drop_nulls) against the JAX package's, on the CPU.

Both packages get the same numpy inputs (the port's through
``interop.table_from_buffers``). Tolerance 0: every buffer equal byte for
byte, validity presence and names. Nulls are one value; NaN payloads,
-0.0 and +0.0 are each their own value in both packages.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import compaction as jc
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops import compaction as pc


def _buffers(t: JTable) -> list:
    return [(np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity),
             None, int(c.dtype.id), int(c.dtype.scale)) for c in t.columns]


def _port(jt: JTable):
    return interop.table_from_buffers(_buffers(jt), jt.names, device="cpu")


def _same(jt: JTable, pt) -> None:
    want, got = _buffers(jt), interop.table_to_buffers(pt)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w[3:] == g[3:], f"column {i} type"
        for part, a, b in zip(("data", "validity"), w[:2], g[:2]):
            assert (a is None) == (b is None), f"column {i} {part} presence"
            if a is not None:
                np.testing.assert_array_equal(a, b, f"column {i} {part}")
    assert tuple(jt.names) == tuple(pt.names)


def _table(n: int, seed: int) -> JTable:
    """(a INT32 ~25 % null, b INT64, f FLOAT64 with NaN/-0.0/+0.0 and
    nulls, c BOOL8): few distinct values, so rows repeat."""
    rng = np.random.default_rng(seed)
    f = rng.choice(np.array([1.5, -0.0, 0.0, np.nan, 2.0]), n)
    return JTable([
        JColumn.from_numpy(rng.integers(0, 4, n).astype(np.int32),
                           validity=rng.random(n) > 0.25),
        JColumn.from_numpy(rng.integers(0, 3, n)),
        JColumn.from_numpy(f, validity=rng.random(n) > 0.1),
        JColumn.from_numpy(rng.random(n) > 0.5),
    ], ["a", "b", "f", "c"])


KEYS = {"all": None, "a_b": [0, 1], "f": ["f"], "c": [3]}


@pytest.mark.parametrize("keys", sorted(KEYS))
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025])
def test_distinct_matches_jax(n, keys):
    jt = _table(n, n)
    _same(jc.distinct(jt, KEYS[keys]), pc.distinct(_port(jt), KEYS[keys]))
    assert int(jc.distinct_count(jt, KEYS[keys])) == int(
        pc.distinct_count(_port(jt), KEYS[keys]))


@pytest.mark.parametrize("n", [2, 1025])
def test_distinct_capped_matches_jax(n):
    jt = _table(n, 3 * n)
    rv = np.random.default_rng(n).random(n) > 0.3
    # no occupancy, a random one, and a prefix (a padded table's)
    for row_valid in (None, rv, np.arange(n) < 3 * n // 4):
        want, wc = jc.distinct_capped(jt, [0, 2], capacity=n,
                                      row_valid=row_valid)
        got, gc = pc.distinct_capped(
            _port(jt), [0, 2], capacity=n,
            row_valid=(None if row_valid is None
                       else torch.from_numpy(row_valid)))
        assert int(wc) == int(gc)
        _same(want, got)


def test_distinct_count_of_a_column():
    jt = _table(300, 5)
    pt = _port(jt)
    for i in range(4):
        assert int(jc.distinct_count(jt.columns[i])) == int(
            pc.distinct_count(pt.columns[i]))


@pytest.mark.parametrize("threshold", [None, 1, 2])
@pytest.mark.parametrize("keys", [None, [0, 2], [1]])
def test_drop_nulls_matches_jax(keys, threshold):
    jt = _table(1025, 9)
    _same(jc.drop_nulls(jt, keys, threshold),
          pc.drop_nulls(_port(jt), keys, threshold))
