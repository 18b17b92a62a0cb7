"""The port's exchange-and-sort path against the JAX package: the wire
plan ops ``partition`` (hash and range) and ``sort_by``, module by module
and through ``table_plan_resident``. Tables are made with numpy from a
seed, in the JAX package, and carried into the port over the same wire
bytes; every comparison is byte-exact.

``sort_by`` is held against the JAX package with its kernel tier on and
off, and the JAX tier is also called directly: the JAX plan runner may
fuse ``sort_by`` into a segment that never consults the tier, so only
the direct call proves that the JAX kernel ran.
"""

import json

import numpy as np
import pytest

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.kernels import registry as jregistry
from spark_rapids_jni_tpu.ops import partition as jpartition
from spark_rapids_jni_tpu.utils import config, metrics
from spark_rapids_jni_tpu_torch import interop, ops
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.kernels import bitonic_sort as bs
from spark_rapids_jni_tpu_torch.kernels import registry
from spark_rapids_jni_tpu_torch.ops import partition
from spark_rapids_jni_tpu_torch.utils import config as pconfig


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves the resident registries of both bridges as it found
    them: a table left behind would show in a later test's count."""
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


EDGES = (1023, 1024, 1025)


def _jtable(rng, n, *, key_range=40):
    """(k INT64 nullable, g INT32 nullable, f FLOAT64 with -0.0/NaN,
    u UINT16, b BOOL8 nullable, d DECIMAL64, s INT64 no nulls)."""
    f = rng.standard_normal(n) * 100
    f[:3] = [-0.0, 0.0, np.nan]
    s = rng.integers(-key_range, key_range, n)
    s[:4] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min,
             np.iinfo(np.int64).max, np.iinfo(np.int64).min]
    return JTable(
        [
            JColumn.from_numpy(rng.integers(-key_range, key_range, n),
                               validity=rng.random(n) > 0.2),
            JColumn.from_numpy(rng.integers(-9, 9, n).astype(np.int32),
                               validity=rng.random(n) > 0.3),
            JColumn.from_numpy(f),
            JColumn.from_numpy(rng.integers(0, 60000, n).astype(np.uint16)),
            JColumn.from_numpy(rng.random(n) > 0.5,
                               validity=rng.random(n) > 0.1),
            JColumn.from_numpy(rng.integers(-10**6, 10**6, n),
                               validity=rng.random(n) > 0.1,
                               dtype=jdt.decimal64(-2)),
            JColumn.from_numpy(s),
        ],
        ["k", "g", "f", "u", "b", "d", "s"],
    )


def _wire(jt):
    return jrb._table_to_wire(jt)


def _port(jt):
    return interop.table_from_buffers(
        [(np.asarray(c.data),
          None if c.validity is None else np.asarray(c.validity), None,
          int(c.dtype.id), int(c.dtype.scale)) for c in jt.columns],
        jt.names, device="cpu")


def _run_port(wire, plan):
    tid = rb.table_upload_wire(*wire, device="cpu")
    out = rb.table_plan_resident(json.dumps(plan), [tid])
    try:
        return tuple(rb.table_download_wire(out))
    finally:
        rb.table_free(tid)
        rb.table_free(out)


def _run_jax(wire, plan):
    tid = jrb.table_upload_wire(*wire)
    out = jrb.table_plan_resident(json.dumps(plan), [tid])
    try:
        return tuple(jrb.table_download_wire(out))
    finally:
        jrb.table_free(tid)
        jrb.table_free(out)


@pytest.fixture
def _flags():
    yield
    config.clear_flag("KERNELS")
    config.clear_flag("METRICS")
    metrics.reset()
    pconfig.clear_flag("KERNELS")


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", EDGES)
def test_partition_ids_match_jax(n):
    rng = np.random.default_rng(n)
    jt = _jtable(rng, n)
    pt = _port(jt)
    for cols, num in (([0, 1], 7), (None, 200), ([2, 3, 4, 5], 1)):
        want = np.asarray(jpartition.partition_ids_hash(jt, cols, num))
        got = partition.partition_ids_hash(pt, cols, num)
        np.testing.assert_array_equal(got.numpy(), want)
        _, wcounts = jpartition.hash_partition(jt, cols, num)
        _, gcounts = partition.hash_partition(pt, cols, num)
        np.testing.assert_array_equal(gcounts.numpy(), np.asarray(wcounts))
    for cols in ([0], [2, 6], [1, 0]):
        wsp = jpartition.range_splitters(jt, cols, 5, sample_size=64)
        gsp = partition.range_splitters(pt, cols, 5, sample_size=64)
        assert len(gsp) == len(wsp)
        if cols == [2, 6]:  # no nulls: every word is a carrier of the u64
            for w, g in zip(wsp, gsp):
                np.testing.assert_array_equal(
                    (g.numpy() ^ np.int64(-2**63)).view(np.uint64),
                    np.asarray(w))
        np.testing.assert_array_equal(
            partition.partition_ids_range(pt, cols, gsp).numpy(),
            np.asarray(jpartition.partition_ids_range(jt, cols, wsp)))
    _, wrr = jpartition.round_robin_partition(jt, 6, start_partition=2)
    _, grr = partition.round_robin_partition(pt, 6, start_partition=2)
    np.testing.assert_array_equal(grr.numpy(), np.asarray(wrr))


PARTITION_PLANS = {
    "hash_nullable_keys": {"op": "partition", "kind": "hash", "keys": [0, 1],
                           "num": 7},
    "hash_all_columns": {"op": "partition", "kind": "hash", "keys": [],
                         "num": 200},
    "hash_float_keys": {"op": "partition", "kind": "hash", "keys": [2, 3, 5],
                        "num": 16},
    "range": {"op": "partition", "kind": "range", "keys": [1, 0], "num": 5},
    "range_float": {"op": "partition", "kind": "range", "keys": [2],
                    "num": 3},
}


@pytest.mark.parametrize("case", sorted(PARTITION_PLANS))
@pytest.mark.parametrize("n", EDGES)
def test_partition_plan_matches_jax(n, case):
    wire = _wire(_jtable(np.random.default_rng(n + len(case)), n))
    plan = [PARTITION_PLANS[case]]
    got = _run_port(wire, plan)
    assert got == _run_jax(wire, plan)
    assert got != tuple(wire)  # rows really moved


def test_partition_rejects_bad_ops():
    wire = _wire(_jtable(np.random.default_rng(0), 32))
    tid = rb.table_upload_wire(*wire, device="cpu")
    for op, err in (({"kind": "hash", "num": 0}, "num must be >= 1"),
                    ({"kind": "range", "num": 2},
                     "needs a non-empty 'keys' list"),
                    ({"kind": "spread", "num": 2}, "unknown partition kind")):
        with pytest.raises(ValueError, match=err):
            rb.table_plan_resident(json.dumps([dict(op, op="partition")]),
                                   [tid])
    rb.table_free(tid)


# ---------------------------------------------------------------------------
# sort_by
# ---------------------------------------------------------------------------

SORT_PLANS = {
    "asc": [{"column": 6}],
    "desc": [{"column": 6, "ascending": False}],
    "float_desc": [{"column": 2, "ascending": False}],
    "unsigned": [{"column": 3}],
    "nullable_key": [{"column": 0}],  # the port's tier declines: exact path
    "multi_key": [{"column": 1, "ascending": False}, {"column": 3}],
}


@pytest.mark.parametrize("case", sorted(SORT_PLANS))
@pytest.mark.parametrize("n", EDGES)
def test_sort_plan_matches_jax(n, case, _flags):
    wire = _wire(_jtable(np.random.default_rng(n + 11), n))
    plan = [{"op": "sort_by", "keys": SORT_PLANS[case]}]
    got = _run_port(wire, plan)
    config.set_flag("KERNELS", "on")
    on = _run_jax(wire, plan)
    config.set_flag("KERNELS", "off")
    off = _run_jax(wire, plan)
    assert on == off
    assert got == on


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("n", EDGES)
def test_sort_kernel_tiers_match(n, asc, _flags):
    """The JAX tier reached directly (its launch counter must move), the
    port's tier, and the port's exact path: the same bytes."""
    jt = _jtable(np.random.default_rng(n + asc), n)
    op = {"op": "sort_by", "keys": [{"column": 6, "ascending": asc}]}
    config.set_flag("METRICS", "1")
    config.set_flag("KERNELS", "on")
    jout = jregistry.dispatch_kernel(op, jt, (), "sort_by")
    assert jout is not None
    launched = metrics.snapshot()["counters"].get("kernel.launches", 0)
    assert int(launched) == 1, "the JAX packed_sort kernel must launch"
    want = tuple(_wire(jout))
    pt = _port(jt)
    assert registry.decline_reason("packed_sort", op, pt, ()) is None
    pconfig.set_flag("KERNELS", "on")  # CPU tensors: the tier's plain route
    before = bs.SORT.launches
    tier = registry.dispatch_kernel(op, pt, (), "sort_by")
    assert bs.SORT.launches == before  # CPU tensors: the plain version ran
    exact = ops.sort_table(pt, [ops.SortKey(6, ascending=asc)])
    for t in (tier, exact):
        assert tuple(rb._table_to_wire(t)) == want
        assert t.names == jt.names


def test_packed_sort_declines():
    pt = _port(_jtable(np.random.default_rng(3), 64))
    reason = registry._a_packed_sort
    assert "multi-key" in reason(
        {"op": "sort_by", "keys": [{"column": 6}, {"column": 3}]}, pt, ())
    assert "nullable key" in reason(
        {"op": "sort_by", "keys": [{"column": 0}]}, pt, ())
    assert "unresolvable" in reason(
        {"op": "sort_by", "keys": [{"column": 99}]}, pt, ())
    empty = ops.filter_table(pt, interop.column_from_buffers(
        np.zeros(64, np.bool_), None, None, 11, device="cpu"))
    assert "empty input" in reason(
        {"op": "sort_by", "keys": [{"column": 6}]}, empty, ())
