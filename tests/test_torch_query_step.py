"""The port's main path against the JAX package's, byte for byte on the
CPU: ``graft_entry.query_step`` against ``jax.jit(__graft_entry__.
query_step)``, and its two capped modules, ``inner_join_capped`` and
``groupby_aggregate_capped``, against theirs.

Every comparison covers every buffer of every output row: data (padding
rows included), validity, names and the device count. Inputs are the
256-row ``_example_tables`` and tables made with numpy from a seed at
the bucket edges 1023, 1024 and 1025 rows, with nulls in ``item``,
``qty`` and ``price``. Tolerance 0: the FLOAT64 sum depends on the
join's pair order, the groupby's stable sort behind its occupancy word
and the XLA-order scan over all rows, and must come out in the same
bytes.
"""

import jax
import numpy as np
import pytest

import __graft_entry__ as jentry
from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops.groupby import GroupbyAgg as JAgg
from spark_rapids_jni_tpu.ops.groupby import groupby_aggregate_capped as jgb
from spark_rapids_jni_tpu.ops.join import inner_join_capped as jjoin
from spark_rapids_jni_tpu_torch import graft_entry, interop
from spark_rapids_jni_tpu_torch.ops.groupby import GroupbyAgg
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate_capped
from spark_rapids_jni_tpu_torch.ops.join import inner_join_capped

EDGES = [1023, 1024, 1025]


def _buffers(t: JTable) -> list:
    return [(np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity),
             None, int(c.dtype.id), int(c.dtype.scale)) for c in t.columns]


def _port(t: JTable):
    return interop.table_from_buffers(_buffers(t), t.names, device="cpu")


def _same(want: JTable, got) -> None:
    """Every buffer of every row equal, and the names."""
    w, g = _buffers(want), interop.table_to_buffers(got)
    assert len(w) == len(g)
    for i, (a, b) in enumerate(zip(w, g)):
        assert a[3:] == b[3:], f"column {i} type"
        for part, x, y in (("data", a[0], b[0]), ("validity", a[1], b[1])):
            assert (x is None) == (y is None), f"column {i} {part}"
            if x is not None:
                assert x.dtype == y.dtype, f"column {i} {part} dtype"
                np.testing.assert_array_equal(
                    x, y, err_msg=f"column {i} ({want.names[i]}) {part}")
    assert tuple(want.names) == tuple(got.names)


def _tables(n: int, seed: int, n_items: int = 40, nulls: bool = True):
    """(sales, items) as JAX tables: ``item`` keys past the item table
    (no match), ``qty`` around the WHERE bound, ``price`` with -0.0, and
    nulls in all three sales columns."""
    rng = np.random.default_rng(seed)

    def valid():
        return (rng.random(n) > 0.1) if nulls else None

    sales = JTable(
        [JColumn.from_numpy(rng.integers(0, n_items + 5, n).astype(np.int64),
                            validity=valid()),
         JColumn.from_numpy(rng.integers(1, 10, n).astype(np.int64),
                            validity=valid()),
         JColumn.from_numpy(np.where(rng.random(n) < 0.05, -0.0,
                                     rng.standard_normal(n) * 10 + 50),
                            validity=valid())],
        ["item", "qty", "price"])
    items = JTable(
        [JColumn.from_numpy(rng.permutation(n_items).astype(np.int64)),
         JColumn.from_numpy(rng.integers(0, 8, n_items).astype(np.int64))],
        ["item", "cat"])
    return sales, items


_JIT_STEP = jax.jit(jentry.query_step)


def _check_query_step(sales: JTable, items: JTable) -> None:
    want, wg = _JIT_STEP(sales, items)
    got, gg = graft_entry.query_step(_port(sales), _port(items))
    assert int(wg) == int(gg)
    _same(want, got)


def test_query_step_example_tables_match_jax():
    sales, items = jentry._example_tables()
    _check_query_step(sales, items)
    # the port's own example tables are the same bytes
    psales, pitems = graft_entry._example_tables(device="cpu")
    for jt, pt in ((sales, psales), (items, pitems)):
        for a, b in zip(_buffers(jt), interop.table_to_buffers(pt)):
            np.testing.assert_array_equal(a[0], b[0])
    fn, (s2, i2) = graft_entry.entry(device="cpu")
    assert fn is graft_entry.query_step and s2.row_count == 256


@pytest.mark.parametrize("nulls", [True, False])
@pytest.mark.parametrize("n", EDGES)
def test_query_step_matches_jax(n, nulls):
    _check_query_step(*_tables(n, n + nulls, nulls=nulls))


def test_query_step_more_groups_than_segments():
    """96 categories over 64 segments: the count passes the capacity."""
    sales, items = _tables(1025, 9, n_items=200)
    rng = np.random.default_rng(9)
    items = JTable([items.columns[0],
                    JColumn.from_numpy(rng.integers(0, 96, 200).astype(np.int64))],
                   items.names)
    _check_query_step(sales, items)


def _join_tables(n: int, seed: int, nr: int = 97):
    rng = np.random.default_rng(seed)
    left = JTable(
        [JColumn.from_numpy(rng.integers(-5, 40, n).astype(np.int64),
                            validity=rng.random(n) > 0.1),
         JColumn.from_numpy(rng.standard_normal(n).astype(np.float32),
                            validity=rng.random(n) > 0.2),
         JColumn.from_numpy(rng.integers(0, 3, n).astype(np.int32))],
        ["k", "f", "g"])
    right = JTable(
        [JColumn.from_numpy(rng.integers(0, 50, nr).astype(np.int64),
                            validity=rng.random(nr) > 0.1),
         JColumn.from_numpy(rng.integers(-9, 9, nr).astype(np.int16)),
         JColumn.from_numpy(rng.random(nr) > 0.5,
                            validity=rng.random(nr) > 0.3)],
        ["k", "s", "b"])
    lv = rng.random(n) > 0.15
    rv = rng.random(nr) > 0.15
    return left, right, lv, rv


@pytest.mark.parametrize("masks", ["none", "left", "both"])
@pytest.mark.parametrize("capacity", [300, 1024, 4000])
@pytest.mark.parametrize("n", EDGES)
def test_inner_join_capped_matches_jax(n, capacity, masks):
    """Pairs past the count (and the capacity's cut) are padding, with
    every column null; duplicate right keys give several pairs a row."""
    left, right, lv, rv = _join_tables(n, n + capacity)
    kw = {}
    if masks in ("left", "both"):
        kw["left_valid"] = lv
    if masks == "both":
        kw["right_valid"] = rv
    want, wc = jjoin(left, right, ["k"], capacity=capacity,
                     **{k: jax.numpy.asarray(v) for k, v in kw.items()})
    got, gc = inner_join_capped(
        _port(left), _port(right), ["k"], capacity=capacity,
        **{k: __import__("torch").from_numpy(v) for k, v in kw.items()})
    assert int(wc) == int(gc)
    _same(want, got)


def _gb_table(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return JTable(
        [JColumn.from_numpy(rng.integers(0, 12, n).astype(np.int64),
                            validity=rng.random(n) > 0.1),
         JColumn.from_numpy(rng.integers(0, 3, n).astype(np.int32)),
         JColumn.from_numpy(np.where(rng.random(n) < 0.05, -0.0,
                                     rng.standard_normal(n) * 100),
                            validity=rng.random(n) > 0.2),
         JColumn.from_numpy(rng.standard_normal(n).astype(np.float32)),
         JColumn.from_numpy(rng.integers(-10**6, 10**6, n).astype(np.int64),
                            validity=rng.random(n) > 0.2,
                            dtype=jdt.decimal64(-2)),
         JColumn.from_numpy(rng.integers(0, 2**63, n, dtype=np.uint64)),
         JColumn.from_numpy(rng.random(n) > 0.5, validity=rng.random(n) > 0.3)],
        ["k", "g", "x", "y", "d", "u", "b"])


_GB_AGGS = [("x", "sum"), ("x", "count"), ("x", "min"), ("x", "max"),
            ("y", "sum"), ("y", "max"), ("d", "sum"), ("d", "min"),
            ("u", "min"), ("u", "sum"), ("b", "max"), ("g", "count")]


@pytest.mark.parametrize("by", [["k"], ["g", "k"]])
@pytest.mark.parametrize("num_segments", [8, 64])
@pytest.mark.parametrize("row_valid", [False, True])
@pytest.mark.parametrize("n", EDGES)
def test_groupby_capped_matches_jax(n, row_valid, num_segments, by):
    """sum/count/min/max over float, decimal, unsigned and bool values;
    with padding rows (``row_valid``); with fewer segments than groups."""
    import jax.numpy as jnp
    import torch

    jt = _gb_table(n, n + num_segments + row_valid)
    rv = np.random.default_rng(n).random(n) > 0.2 if row_valid else None
    want, wg = jax.jit(lambda t, r: jgb(
        t, by, [JAgg(c, a) for c, a in _GB_AGGS], num_segments=num_segments,
        row_valid=r))(jt, None if rv is None else jnp.asarray(rv))
    got, gg = groupby_aggregate_capped(
        _port(jt), by, [GroupbyAgg(c, a) for c, a in _GB_AGGS],
        num_segments=num_segments,
        row_valid=None if rv is None else torch.from_numpy(rv))
    assert int(wg) == int(gg)
    _same(want, got)


def test_groupby_capped_unported_agg_raises():
    """Every aggregation runs now, DECIMAL128 values too; nunique and the
    collects of a DECIMAL128 raise, as in the JAX package."""
    t = interop.table_from_buffers(
        [(np.arange(16), None, None, 4, 0),
         (np.zeros((16, 2), np.uint64), None, None, 27, -2)], ["k", "x"],
        device="cpu")
    out, _ = groupby_aggregate_capped(t, ["k"], [GroupbyAgg("x", "mean")],
                                      num_segments=8)
    assert out.columns[1].dtype.id == 10
    with pytest.raises(TypeError, match="not supported"):
        groupby_aggregate_capped(t, ["k"], [GroupbyAgg("x", "nunique")],
                                 num_segments=8)
