"""The port's joins of every kind against the JAX package's, on the CPU:
inner, left, right, full, semi and anti, their capped and count forms,
the membership mask, the chunked inner join, and semi/anti through the
kernel tier's K2a + K2b route.

Both packages get the same numpy inputs (the port's through
``interop.table_from_buffers``). Tolerance 0: every buffer equal byte for
byte (data under nulls included), validity presence and names. Cases:
the bucket edges 1023/1024/1025, 1-row sides, nulls in keys and values,
duplicate build keys, all matched and none matched.

The JAX joins raise ``TypeError`` when the build side has 0 rows and the
probe side has rows (right and full joins also with a 0-row left side;
ROADMAP Queue 3). Those cases are left out of the byte comparison: the
tests check that JAX raises and that the port returns Spark's result.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.kernels import registry
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from spark_rapids_jni_tpu_torch.utils import buckets
from spark_rapids_jni_tpu_torch.utils import config as pconfig
from spark_rapids_jni_tpu_torch.utils import metrics as pmetrics

HOWS = ("inner_join", "left_join", "right_join", "full_join", "semi_join",
        "anti_join")


def _buffers(t: JTable) -> list:
    return [(np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths),
             int(c.dtype.id), int(c.dtype.scale)) for c in t.columns]


def _port(jt: JTable):
    return interop.table_from_buffers(_buffers(jt), jt.names, device="cpu")


def _same(jt: JTable, pt) -> None:
    want, got = _buffers(jt), interop.table_to_buffers(pt)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w[3:] == g[3:], f"column {i} type"
        for part, a, b in zip(("data", "validity", "lengths"), w[:3], g[:3]):
            assert (a is None) == (b is None), f"column {i} {part} presence"
            if a is not None:
                assert a.dtype == b.dtype, f"column {i} {part} dtype"
                np.testing.assert_array_equal(a, b, f"column {i} {part}")
    assert tuple(jt.names) == tuple(pt.names)


def _side(rng, n: int, prefix: str, keys, key_nulls: bool) -> JTable:
    """(key INT64, value INT32 ~30 % null, value FLOAT64)."""
    return JTable([
        JColumn.from_numpy(rng.choice(keys, n),
                           validity=rng.random(n) > 0.2 if key_nulls else None),
        JColumn.from_numpy(rng.integers(-100, 100, n).astype(np.int32),
                           validity=rng.random(n) > 0.3),
        JColumn.from_numpy(rng.standard_normal(n)),
    ], [prefix + "k", prefix + "a", prefix + "b"])


# (left rows, right rows, left keys, right keys): duplicates on both
# sides, all matched (right holds every left key), none matched
SHAPES = {
    "edges_1023": (1023, 300, range(40), range(30)),
    "edges_1024": (1024, 1024, range(40), range(60)),
    "edges_1025": (1025, 41, range(25), range(25)),
    "one_row": (1, 1, range(2), range(2)),
    "all_matched": (300, 50, range(10), range(10)),
    "none_matched": (200, 70, range(10), range(100, 120)),
    "unique_build": (500, 200, range(400), range(200)),
}


@pytest.mark.parametrize("key_nulls", [False, True], ids=["keys", "null_keys"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("how", HOWS)
def test_join_matches_jax(how, shape, key_nulls):
    n, m, lk, rk = SHAPES[shape]
    rng = np.random.default_rng(n + m + key_nulls)
    left = _side(rng, n, "l", np.array(lk), key_nulls)
    right = _side(rng, m, "r", np.array(rk), key_nulls)
    want = getattr(jjoin, how)(left, right, [0])
    got = getattr(pjoin, how)(_port(left), _port(right), [0])
    _same(want, got)


@pytest.mark.parametrize("how", HOWS)
def test_empty_sides(how):
    """A 0-row side: where JAX raises, the port returns Spark's rows (a
    left/full row with a null right side, an anti row kept, a right/full
    right row with a null left side); elsewhere the bytes match."""
    rng = np.random.default_rng(1)
    full = _side(rng, 5, "l", np.arange(3), True)
    empty = _side(rng, 0, "r", np.arange(3), True)
    for left, right in ((full, empty), (empty, full), (empty, empty)):
        raises = left.row_count and not right.row_count or (
            how in ("right_join", "full_join") and right.row_count
            and not left.row_count)
        got = getattr(pjoin, how)(_port(left), _port(right), [0])
        if not raises:
            _same(getattr(jjoin, how)(left, right, [0]), got)
            continue
        with pytest.raises(TypeError, match="out of range"):
            getattr(jjoin, how)(left, right, [0])
        left_rows = left.row_count > 0
        keeps = ({"anti_join", "left_join", "full_join"} if left_rows
                 else {"right_join", "full_join"})
        assert got.row_count == (5 if how in keeps else 0)
        if got.row_count and how != "anti_join":
            # the missing side's non-key columns are null
            null_cols = (3, 4) if left_rows else (1, 2)
            for i in null_cols:
                assert not got.columns[i].validity.any()


@pytest.mark.parametrize("n", [1023, 1025])
def test_capped_and_counts_match_jax(n):
    rng = np.random.default_rng(n)
    left = _side(rng, n, "l", np.arange(30), True)
    right = _side(rng, 200, "r", np.arange(20), True)
    lv, rv = rng.random(n) > 0.2, rng.random(200) > 0.1
    lvt, rvt = torch.from_numpy(lv), torch.from_numpy(rv)
    for fn in ("inner_join_count", "left_join_count"):
        want = getattr(jjoin, fn)(left, right, [0], left_valid=lv,
                                  right_valid=rv)
        assert int(want) == int(getattr(pjoin, fn)(
            _port(left), _port(right), [0], left_valid=lvt, right_valid=rvt))
    want = jjoin.membership_mask(left, right, [0], left_valid=lv,
                                 right_valid=rv)
    got = pjoin.membership_mask(_port(left), _port(right), [0],
                                left_valid=lvt, right_valid=rvt)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    cap = int(want.sum()) * 20 + 64
    w, wc = jjoin.left_join_capped(left, right, [0], cap, left_valid=lv,
                                   right_valid=rv)
    g, gc = pjoin.left_join_capped(_port(left), _port(right), [0], cap,
                                   left_valid=lvt, right_valid=rvt)
    assert int(wc) == int(gc)
    _same(w, g)


@pytest.mark.parametrize("probe_rows", [1, 100, 1000])
def test_batched_inner_join_matches_jax(probe_rows, monkeypatch):
    """The chunked inner join, with the output budget floor lowered in both
    packages so that skewed chunks split in two: the same pieces, and the
    same rows as the single join."""
    monkeypatch.setattr(jjoin, "MIN_CHUNK_OUT_BYTES", 1 << 10)
    monkeypatch.setattr(pjoin, "MIN_CHUNK_OUT_BYTES", 1 << 10)
    rng = np.random.default_rng(probe_rows)
    left = _side(rng, 3000, "l", np.concatenate([np.zeros(50, np.int64),
                                                 np.arange(200)]), True)
    right = _side(rng, 400, "r", np.arange(100), False)
    want = list(jjoin.inner_join_batches(left, right, [0],
                                         probe_rows=probe_rows))
    got = list(pjoin.inner_join_batches(_port(left), _port(right), [0],
                                        probe_rows=probe_rows))
    assert [t.row_count for t in got] == [t.row_count for t in want]
    _same(jjoin.inner_join_batched(left, right, [0], probe_rows=probe_rows),
          pjoin.inner_join_batched(_port(left), _port(right), [0],
                                   probe_rows=probe_rows))
    with pytest.raises(ValueError, match="positive"):
        pjoin.inner_join_batches(_port(left), _port(right), [0], probe_rows=0)


@pytest.fixture
def _tier_on():
    pconfig.set_flag("KERNELS", "on")  # CPU tensors: the tier's plain route
    pconfig.set_flag("METRICS", True)
    pmetrics.reset()
    yield
    pconfig.clear_flag("KERNELS")
    pconfig.clear_flag("METRICS")
    pmetrics.reset()


@pytest.mark.parametrize("how", ["semi", "anti"])
@pytest.mark.parametrize("shape", ["edges_1023", "edges_1025", "all_matched",
                                   "none_matched", "unique_build"])
def test_semi_anti_through_the_kernel_tier(how, shape, _tier_on):
    """Semi and anti joins run K2a + K2b in the tier (duplicate build keys
    do not decline them) and give the exact path's bytes and the JAX
    package's over the logical rows (the tier pads its input to the
    shape bucket and returns a padded result, as the JAX tier does)."""
    n, m, lk, rk = SHAPES[shape]
    rng = np.random.default_rng(n * m)
    left = _side(rng, n, "l", np.array(lk), False)
    right = _side(rng, m, "r", np.array(rk), False)
    op = {"op": "join", "how": how, "on": [0]}
    assert registry.decline_reason("hash_build_probe", op, _port(left),
                                   [_port(right)]) is None
    got = registry.dispatch_kernel(op, _port(left), [_port(right)], "join")
    assert got is not None
    assert pmetrics.counter_values(["kernel.launches"])["kernel.launches"] == 1
    _same(getattr(jjoin, how + "_join")(left, right, [0]),
          buckets.unpad_table(got))


def test_semi_anti_declines_as_jax(_tier_on):
    rng = np.random.default_rng(3)
    left = _port(_side(rng, 50, "l", np.arange(9), True))
    right = _port(_side(rng, 20, "r", np.arange(9), False))
    empty = _port(_side(rng, 0, "r", np.arange(9), False))
    semi = {"op": "join", "how": "semi", "on": [0]}
    assert "nullable key" in registry.decline_reason(
        "hash_build_probe", semi, left, [right])
    assert "empty join side" in registry.decline_reason(
        "hash_build_probe", semi, right, [empty])
    left_how = dict(semi, how="left")
    assert "left/outer" in registry.decline_reason(
        "hash_build_probe", left_how, right, [right])
