"""The PyTorch port's slice against the JAX package, module by module and
as a whole. Tables are built once with numpy from a seed, in the JAX
package, and carried into the port over the same bytes by
``interop.table_from_buffers``; every comparison is byte-exact.

The whole plan — packed rows in, filter, inner join with a dimension
table, groupby, packed rows out — runs through the port's
``table_plan_resident`` on the CPU and through the JAX package's, with
its kernel tier on (interpret-mode kernels) and off.
"""

import json

import jax
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu import rows as jrows
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import keys as jkeys
from spark_rapids_jni_tpu.ops.groupby import groupby_aggregate_capped
from spark_rapids_jni_tpu.utils import config, metrics
from spark_rapids_jni_tpu_torch import interop, ops, plancheck, rows
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.kernels import registry
from spark_rapids_jni_tpu_torch.ops import keys
from spark_rapids_jni_tpu_torch.utils import config as pconfig


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves the resident registries of both bridges as it found
    them: a table left behind would show in a later test's count."""
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


def _jax_buffers(t: JTable) -> list:
    return [
        (np.asarray(c.data),
         None if c.validity is None else np.asarray(c.validity),
         None if c.lengths is None else np.asarray(c.lengths),
         int(c.dtype.id), int(c.dtype.scale))
        for c in t.columns
    ]


def _port(t: JTable):
    return interop.table_from_buffers(_jax_buffers(t), t.names, device="cpu")


def _assert_same(jt: JTable, pt) -> None:
    """Every buffer of every column equal, byte for byte."""
    want, got = _jax_buffers(jt), interop.table_to_buffers(pt)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w[3:] == g[3:], f"column {i} type"
        for part, a, b in zip(("data", "validity", "lengths"), w[:3], g[:3]):
            if a is None or b is None:
                assert a is None and b is None, f"column {i} {part}"
                continue
            assert a.dtype == b.dtype, f"column {i} {part} dtype"
            np.testing.assert_array_equal(a, b, err_msg=f"column {i} {part}")
    assert tuple(jt.names or ()) == tuple(pt.names or ())


def _jtable(rng, n, *, key_range=50, key_nulls=False, val_nulls=0.2):
    """(k INT64, v INT32, w INT64, b BOOL8, d DECIMAL64) with nulls."""
    kv = rng.random(n) > 0.2 if key_nulls else None
    return JTable(
        [
            JColumn.from_numpy(rng.integers(-key_range, key_range, n),
                               validity=kv),
            JColumn.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32),
                               validity=rng.random(n) > val_nulls),
            JColumn.from_numpy(rng.integers(-2**62, 2**62, n)),
            JColumn.from_numpy(rng.random(n) > 0.5,
                               validity=rng.random(n) > val_nulls),
            JColumn.from_numpy(rng.integers(-10**6, 10**6, n),
                               validity=rng.random(n) > val_nulls,
                               dtype=jdt.decimal64(-2)),
        ],
        ["k", "v", "w", "b", "d"],
    )


_KEY_CASES = {
    "int8": (np.int8, None), "int16": (np.int16, None),
    "int32": (np.int32, None), "int64": (np.int64, None),
    "uint8": (np.uint8, None), "uint16": (np.uint16, None),
    "uint32": (np.uint32, None), "uint64": (np.uint64, None),
    "float32": (np.float32, None), "float64": (np.float64, None),
    "bool": (np.bool_, None), "decimal32": (np.int32, jdt.decimal32(-2)),
    "timestamp_days": (np.int32, jdt.TIMESTAMP_DAYS),
}


@pytest.mark.parametrize("case", sorted(_KEY_CASES))
def test_order_keys_match_jax(case):
    np_t, want_dt = _KEY_CASES[case]
    rng = np.random.default_rng(3)
    if np.dtype(np_t).kind == "f":
        vals = rng.standard_normal(257).astype(np_t) * 1e3
        vals[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, -1.5]
    elif np_t is np.bool_:
        vals = rng.random(257) > 0.5
    else:
        info = np.iinfo(np_t)
        vals = rng.integers(info.min, info.max, 257, dtype=np_t,
                            endpoint=True)
        vals[:2] = [info.min, info.max]
    jt = JTable([JColumn.from_numpy(vals, dtype=want_dt)])
    want = np.asarray(jkeys.column_order_keys(jt.columns[0])[0])
    got = keys.column_order_keys(_port(jt).columns[0])[0]
    np.testing.assert_array_equal(
        keys.to_unsigned_bits(got).numpy().view(np.uint64), want
    )


@pytest.mark.parametrize("n", [1023, 1025])
def test_filter_matches_jax(n):
    rng = np.random.default_rng(n)
    jt = _jtable(rng, n)
    mask = JColumn.from_numpy(rng.random(n) > 0.6,
                              validity=rng.random(n) > 0.1)
    pmask = _port(JTable([mask])).columns[0]
    _assert_same(jops.filter_table(jt, mask), ops.filter_table(_port(jt), pmask))
    capped, count = jops.filter_table_capped(jt, mask, capacity=n // 2)
    pcapped, pcount = ops.filter_table_capped(_port(jt), pmask, capacity=n // 2)
    _assert_same(capped, pcapped)
    assert int(count) == int(pcount)
    all_true = JColumn.from_numpy(np.ones(n, np.bool_))
    _assert_same(jops.filter_table(jt, all_true),
                 ops.filter_table(_port(jt), _port(JTable([all_true])).columns[0]))


@pytest.mark.parametrize("n", [1023, 1025])
def test_sort_table_matches_jax(n):
    rng = np.random.default_rng(n)
    jt = _jtable(rng, n, key_range=20, key_nulls=True)
    spec = [(0, False, None), (1, True, False), (3, True, None)]
    want = jops.sort_table(jt, [jops.SortKey(c, a, nf) for c, a, nf in spec])
    got = ops.sort_table(_port(jt), [ops.SortKey(c, a, nf) for c, a, nf in spec])
    _assert_same(want, got)


@pytest.mark.parametrize("n,key_nulls", [(1023, False), (1025, True)])
def test_inner_join_matches_jax(n, key_nulls):
    rng = np.random.default_rng(n + key_nulls)
    left = _jtable(rng, n, key_range=40, key_nulls=key_nulls)
    right = _jtable(rng, 97, key_range=60, key_nulls=key_nulls)
    _assert_same(jops.inner_join(left, right, [0]),
                 ops.inner_join(_port(left), _port(right), [0]))
    # no match at all: the empty result's schema
    far = _jtable(rng, 20, key_range=5)
    far = JTable([JColumn.from_numpy(np.full(20, 10**9))] + list(far.columns[1:]),
                 far.names)
    _assert_same(jops.inner_join(left, far, [0]),
                 ops.inner_join(_port(left), _port(far), [0]))


@pytest.mark.parametrize("by", [[0], [1, 3]])
@pytest.mark.parametrize("n", [1023, 1025])
def test_groupby_matches_jax(n, by):
    rng = np.random.default_rng(n + len(by))
    jt = _jtable(rng, n, key_range=30)
    aggs = [(1, "sum"), (1, "count"), (1, "min"), (1, "max"), (3, "min"),
            (3, "max"), (4, "sum"), (2, "max")]
    got = ops.groupby_aggregate(_port(jt), by,
                                [ops.GroupbyAgg(c, a) for c, a in aggs])
    _assert_same(_jax_groupby(jt, by, aggs), got)


def _jax_groupby(jt, by, aggs):
    """The JAX ``groupby_aggregate``: its capped form (jitted — one
    compile instead of one per eager primitive) sliced to the group
    count, exactly as the eager API does."""
    jaggs = [jops.GroupbyAgg(c, a) for c, a in aggs]
    fn = jax.jit(lambda t: groupby_aggregate_capped(
        t, by, jaggs, num_segments=t.row_count))
    padded, g = fn(jt)
    g = int(g)
    return JTable(
        [JColumn(c.data[:g], c.dtype,
                 None if c.validity is None else c.validity[:g])
         for c in padded.columns],
        padded.names,
    )


def test_groupby_unported_agg_raises():
    """Every aggregation runs now, DECIMAL128 values too; nunique and the
    collects of a DECIMAL128 raise, as in the JAX package."""
    t = interop.table_from_buffers(
        [(np.arange(10), None, None, 4, 0),
         (np.zeros((10, 2), np.uint64), None, None, 27, -2)], device="cpu")
    assert ops.groupby_aggregate(t, [0], [ops.GroupbyAgg(1, "mean")]
                                 ).columns[1].to_pylist() == [0.0] * 10
    with pytest.raises(TypeError, match="not supported"):
        ops.groupby_aggregate(t, [0], [ops.GroupbyAgg(1, "collect_set",
                                                      list_capacity=2)])


@pytest.mark.parametrize("n", [1023, 1024, 1025])
def test_rows_lists_match_jax(n):
    rng = np.random.default_rng(n)
    schema = [jdt.INT64, jdt.FLOAT64, jdt.INT32, jdt.BOOL8, jdt.FLOAT32,
              jdt.INT8, jdt.decimal32(-3), jdt.decimal64(-8)]
    cols = []
    for d in schema:
        np_t = {jdt.TypeId.FLOAT64: np.float64, jdt.TypeId.FLOAT32: np.float32,
                jdt.TypeId.BOOL8: np.bool_}.get(d.id)
        if np_t is np.bool_:
            vals = rng.random(n) > 0.5
        elif np_t is not None:
            vals = rng.standard_normal(n).astype(np_t)
        else:
            vals = rng.integers(-100, 100, n).astype(
                np.dtype(jdt.DType(d.id).storage_dtype))
        valid = rng.random(n) > 0.2
        valid[-5:] = False  # trailing nulls in every column
        cols.append(JColumn.from_numpy(vals, validity=valid, dtype=d))
    jt = JTable(cols)
    pt = _port(jt)
    jrowcol = jrows.to_rows_list(jt)
    prowcol = rows.to_rows_list(pt)
    _assert_same(JTable([jrowcol]), type(pt)([prowcol]))
    back = rows.from_rows_list(prowcol, [c.dtype for c in pt.columns])
    _assert_same(jrows.from_rows_list(jrowcol, schema), back)
    # the kernels take dense buffers: every validity is contiguous
    assert all(c.validity.is_contiguous() for c in back.columns)
    # the split loop and the multi-batch unpack, at a small batch size
    jbatches = jrows.to_rows(jt, batch_rows=300)
    pbatches = rows.to_rows(pt, batch_rows=300)
    assert [b.row_count for b in pbatches] == [b.row_count for b in jbatches]
    assert len(pbatches) == 4
    for jb, pb in zip(jbatches, pbatches):
        np.testing.assert_array_equal(np.asarray(jb.data), pb.data.numpy())
    _assert_same(jrows.from_rows(jbatches), rows.from_rows(pbatches))


# ---------------------------------------------------------------------------
# the whole slice: one Spark task's batch, as packed rows, through the plan
# ---------------------------------------------------------------------------

FACT_TYPES = [4, 4, 4, 3, 11]  # item_sk, customer_sk, sold_date_sk, quantity, keep
PLAN = [
    {"op": "from_rows", "type_ids": FACT_TYPES, "scales": [0] * 5},
    {"op": "filter", "mask": 4},
    {"op": "join", "how": "inner", "on": [0]},
    {"op": "groupby", "by": [4],
     "aggs": [{"column": 3, "agg": a} for a in ("sum", "count", "min", "max")]},
    {"op": "to_rows"},
]


def _slice_wire(n=3000, n_items=300, seed=0):
    """(fact wire tuple, item wire tuple): the fact batch as packed rows in
    a LIST<UINT8> column, the item table columnar."""
    rng = np.random.default_rng(seed)
    item_sk = (rng.zipf(1.3, n) % n_items).astype(np.int64)
    cust = rng.integers(0, 10_000, n).astype(np.int64)
    cust_ok = rng.random(n) > 0.03
    date = rng.integers(2_450_000, 2_452_000, n).astype(np.int64)
    qty = rng.integers(1, 101, n).astype(np.int32)
    qty_ok = rng.random(n) > 0.03
    keep = rng.random(n) < 1 / 3
    row = np.zeros((n, 32), np.uint8)
    for off, a in ((0, item_sk), (8, cust), (16, date), (24, qty)):
        row[:, off:off + a.itemsize] = a.view(np.uint8).reshape(n, a.itemsize)
    row[:, 28] = keep
    row[:, 29] = 1 | (cust_ok << 1) | 4 | (qty_ok << 3) | 16
    offs = (np.arange(n + 1) * 32).astype(np.int32)
    fact = ([24], [5], [offs.tobytes() + row.tobytes()], [None], n)
    sk = np.arange(n_items, dtype=np.int64)
    brand = rng.integers(1_001_001, 1_001_001 + 40, n_items).astype(np.int32)
    cat = rng.integers(1, 11, n_items).astype(np.int32)
    item = ([4, 3, 3], [0, 0, 0], [sk.tobytes(), brand.tobytes(), cat.tobytes()],
            [None] * 3, n_items)
    return fact, item


def _run_jax(fact, item):
    fid = jrb.table_upload_wire(*fact)
    iid = jrb.table_upload_wire(*item)
    out = jrb.table_plan_resident(json.dumps(PLAN), [fid, iid])
    try:
        return jrb.table_download_wire(out)
    finally:
        for t in (fid, iid, out):
            jrb.table_free(t)


@pytest.fixture
def _kernel_flags():
    yield
    config.clear_flag("KERNELS")
    config.clear_flag("METRICS")
    metrics.reset()
    pconfig.clear_flag("KERNELS")


def test_slice_plan_matches_jax(_kernel_flags, monkeypatch):
    fact, item = _slice_wire()
    fid = rb.table_upload_wire(*fact, device="cpu")
    iid = rb.table_upload_wire(*item, device="cpu")
    out = rb.table_plan_resident(json.dumps(PLAN), [fid, iid])
    got = rb.table_download_wire(out)
    assert got[0] == [24] and got[1] == [5] and 0 < got[4] <= 40

    config.set_flag("METRICS", "1")
    config.set_flag("KERNELS", "on")
    on = _run_jax(fact, item)
    launched = int(metrics.snapshot()["counters"].get("kernel.launches", 0))
    assert launched >= 4, "the JAX kernel tier must run every kernel op"
    config.set_flag("KERNELS", "off")
    off = _run_jax(fact, item)
    assert on == off
    assert tuple(got) == on

    # the port's exact join and groupby give the same bytes as its kernel
    # tier (the row transpose has no second route)
    tier = registry.dispatch_kernel
    monkeypatch.setattr(
        registry, "dispatch_kernel",
        lambda op, t, r, name: (tier(op, t, r, name)
                                if name in ("to_rows", "from_rows") else None))
    out2 = rb.table_plan_resident(json.dumps(PLAN), [fid, iid])
    assert tuple(rb.table_download_wire(out2)) == on
    for t in (fid, iid, out, out2):
        rb.table_free(t)


def test_kernel_tier_declines_semantically(_kernel_flags):
    """The JAX tier's semantic declines send the op to the exact path."""
    pconfig.set_flag("KERNELS", "on")  # CPU tensors: the tier's plain route
    rng = np.random.default_rng(5)
    left = _port(_jtable(rng, 200, key_range=20))
    dup_right = _port(_jtable(rng, 50, key_range=10))  # repeated keys
    op = {"op": "join", "how": "inner", "on": [0]}
    assert registry.dispatch_kernel(op, left, [dup_right], "join") is None
    nullable = _port(_jtable(rng, 50, key_nulls=True))
    assert registry._a_hash_join(op, left, [nullable]).startswith("build side")
    gb = {"op": "groupby", "by": [0], "aggs": [{"column": 1, "agg": "mean"}]}
    assert "non-decomposable" in registry._a_hash_groupby(gb, left, [])
    gbf = {"op": "groupby", "by": [0], "aggs": [{"column": 4, "agg": "sum"}]}
    assert "DECIMAL64" in registry._a_hash_groupby(gbf, left, [])
    multi = {"op": "sort_by", "keys": [{"column": 0}, {"column": 2}]}
    assert "multi-key" in registry._a_packed_sort(multi, left, [])
    by_null = {"op": "sort_by", "keys": [{"column": 0}]}
    assert "nullable key" in registry._a_packed_sort(by_null, nullable, [])


def test_unported_ops_raise_typed():
    fact, item = _slice_wire(n=64)
    fid = rb.table_upload_wire(*fact, device="cpu")
    # rlike runs now: on a non-STRING column the plan check refuses it
    with pytest.raises(plancheck.PlanCheckError, match="STRING column"):
        rb.table_plan_resident(json.dumps(
            [PLAN[0], {"op": "rlike", "column": 0, "pattern": "a"}]), [fid])
    with pytest.raises(ValueError, match="unknown table op"):
        rb.table_plan_resident(json.dumps([{"op": "nope"}]), [fid])
    # from_rows of a table that is neither a row column nor a flat UINT8
    # buffer is refused by the plan check, before it runs
    cols = rb.table_plan_resident(json.dumps([PLAN[0]]), [fid])
    with pytest.raises(plancheck.PlanCheckError, match="flat UINT8"):
        rb.table_plan_resident(json.dumps([PLAN[0]]), [cols])
    # an explicit "rest" names the extra table a join takes
    iid = rb.table_upload_wire(*item, device="cpu")
    by_rest = rb.table_plan_resident(json.dumps([dict(PLAN[2], rest=[1])]),
                                     [cols, fid, iid])
    in_order = rb.table_plan_resident(json.dumps([PLAN[2]]), [cols, iid])
    assert (rb.table_download_wire(by_rest)
            == rb.table_download_wire(in_order))
    for t in (by_rest, in_order, iid, cols, fid):
        rb.table_free(t)
    with pytest.raises(KeyError, match="already-freed"):
        rb.table_free(fid)
    assert torch.is_tensor(interop.table_from_buffers(
        [(np.zeros(3, np.int64), None, None, 4, 0)], device="cpu").columns[0].data)
