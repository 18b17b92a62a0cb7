"""The port's groupby aggregations beyond sum/count/min/max (mean,
variance, std, first, last, nunique, collect_list, collect_set) against
the JAX package's, on the CPU, exact and capped, and the subnormal-flush
fault F5 of the float sums.

Both packages get the same numpy inputs (the port's through
``interop.table_from_buffers``). The JAX reference is its jitted capped
groupby sliced to the group count, as its wire entries run it (the
jitted graph contracts a decimal's scaling into its deviation with one
fma; the port does the same, ``compute.fma``). Tolerance 0: every buffer
equal byte for byte, validity presence, LIST lengths and names
included. Sizes sit on the bucket edges 1023/1024/1025, with 1 and 2
rows, nulls in keys and values, NaN, -0.0 and +0.0.
"""

import json

import jax
import numpy as np
import pytest

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops.groupby import groupby_aggregate_capped as jcapped
from spark_rapids_jni_tpu_torch import interop, ops
from spark_rapids_jni_tpu_torch import runtime_bridge as rb

NEW_AGGS = ("mean", "variance", "std", "first", "last", "nunique")
COLLECT = ("collect_list", "collect_set")


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


def _jax_capped(jt, by, aggs, num_segments, row_valid=None):
    fn = jax.jit(lambda t, rv: jcapped(t, by, aggs, num_segments=num_segments,
                                       row_valid=rv))
    return fn(jt, row_valid)


def _jax_exact(jt, by, aggs):
    """The JAX eager ``groupby_aggregate``'s result: collect capacities
    from the largest group's valid rows, the capped form jitted over all
    rows, sliced to the group count."""
    sized = []
    for a in aggs:
        if a.op in COLLECT:
            counts = jops.groupby_aggregate(jt, by, [jops.GroupbyAgg(
                a.column, "count")]).columns[-1].to_numpy()
            a = jops.GroupbyAgg(a.column, a.op, list_capacity=max(
                1, int(counts.max()) if counts.size else 1))
        sized.append(a)
    padded, g = _jax_capped(jt, by, sized, max(jt.row_count, 1))
    g = int(g)
    return JTable([JColumn(c.data[:g], c.dtype,
                           None if c.validity is None else c.validity[:g],
                           None if c.lengths is None else c.lengths[:g])
                   for c in padded.columns], padded.names)


def _values(rng, n: int) -> np.ndarray:
    """FLOAT64 values with NaN, -0.0, +0.0, repeats and a wide range."""
    f = np.round(rng.standard_normal(n) * 100, 1) * 10.0 ** rng.integers(-3, 4, n)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.05] = 0.0
    return f


def _table(n: int, seed: int, key_nulls: bool) -> JTable:
    """(k INT64 with nulls, f FLOAT64, g FLOAT32, i INT32, d DECIMAL64,
    b BOOL8, u UINT32, s INT8), values ~20 % null."""
    rng = np.random.default_rng(seed)
    f = _values(rng, n)

    def ok():
        return rng.random(n) > 0.2

    return JTable([
        JColumn.from_numpy(rng.integers(0, 9, n),
                           validity=ok() if key_nulls else None),
        JColumn.from_numpy(f, validity=ok()),
        JColumn.from_numpy(f.astype(np.float32), validity=ok()),
        JColumn.from_numpy(rng.integers(-50, 50, n).astype(np.int32),
                           validity=ok()),
        JColumn.from_numpy(rng.integers(-10**9, 10**9, n), validity=ok(),
                           dtype=jdt.decimal64(-3)),
        JColumn.from_numpy(rng.random(n) > 0.5, validity=ok()),
        JColumn.from_numpy(rng.integers(0, 2**32, n).astype(np.uint32) % 7,
                           validity=ok()),
        JColumn.from_numpy(rng.integers(-128, 128, n).astype(np.int8)),
    ], ["k", "f", "g", "i", "d", "b", "u", "s"])


def _aggs(columns, ops_):
    return [(c, a) for c in columns for a in ops_]


# every column takes the new aggregations; collect takes LIST children
CASES = {
    "float64": _aggs([1], NEW_AGGS + ("sum",)),
    "float32": _aggs([2], NEW_AGGS + COLLECT + ("sum",)),
    "int32": _aggs([3], NEW_AGGS + COLLECT),
    "decimal64": _aggs([4], NEW_AGGS + ("sum",)),
    "bool_uint32_int8": _aggs([5, 6, 7], NEW_AGGS + COLLECT),
}


@pytest.mark.parametrize("key_nulls", [False, True], ids=["keys", "null_keys"])
@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025])
@pytest.mark.parametrize("case", sorted(CASES))
def test_groupby_aggs_match_jax(case, n, key_nulls):
    jt = _table(n, n + 31 * key_nulls, key_nulls)
    aggs = CASES[case]
    want = _jax_exact(jt, ["k"], [jops.GroupbyAgg(c, a) for c, a in aggs])
    got = ops.groupby_aggregate(_port(jt), ["k"],
                                [ops.GroupbyAgg(c, a) for c, a in aggs])
    _same(want, got)


def _clone_tail(jt: JTable, k: int) -> JTable:
    """``jt`` with every row from ``k`` on a clone of row 0 (the tail a
    capped filter leaves in a padded table)."""
    idx = np.where(np.arange(jt.row_count) < k, np.arange(jt.row_count), 0)
    return JTable([JColumn(c.data[idx], c.dtype,
                           None if c.validity is None else c.validity[idx])
                   for c in jt.columns], jt.names)


@pytest.mark.parametrize("with_row_valid", [
    "all_rows", "row_valid", "prefix", "prefix_clones"])
@pytest.mark.parametrize("n", [2, 1023, 1025])
def test_capped_aggs_match_jax(n, with_row_valid):
    """The capped groupby, every output row (padding rows included), with
    a static LIST capacity that truncates the largest groups. The
    occupancy is random, or a prefix of 3/4 of the rows (a padded
    table) over random rows or over clones of row 0, which the port
    leaves unsorted."""
    jt = _table(n, 7 * n, True)
    k = 3 * n // 4
    if with_row_valid == "prefix_clones":
        jt = _clone_tail(jt, k)
    rv = {"all_rows": None,
          "row_valid": np.random.default_rng(n).random(n) > 0.25,
          "prefix": np.arange(n) < k,
          "prefix_clones": np.arange(n) < k}[with_row_valid]
    aggs = (_aggs([1, 4], NEW_AGGS) + _aggs([3], NEW_AGGS + COLLECT)
            + _aggs([2], COLLECT))
    seg = n + 3
    want, wg = _jax_capped(jt, ["k"], [jops.GroupbyAgg(c, a, list_capacity=5)
                                       for c, a in aggs], seg, rv)
    import torch

    got, gg = ops.groupby_aggregate_capped(
        _port(jt), ["k"], [ops.GroupbyAgg(c, a, list_capacity=5)
                           for c, a in aggs], seg,
        None if rv is None else torch.from_numpy(rv))
    assert int(wg) == int(gg)
    _same(want, got)


def test_empty_table_schema_matches_jax():
    jt = _table(0, 0, True)
    aggs = _aggs([3], NEW_AGGS + COLLECT)
    want = jops.groupby_aggregate(jt, ["k"],
                                  [jops.GroupbyAgg(c, a) for c, a in aggs])
    got = ops.groupby_aggregate(_port(jt), ["k"],
                                [ops.GroupbyAgg(c, a) for c, a in aggs])
    _same(want, got)


@pytest.mark.parametrize("payloads", [(0x7FC00000, 0x7FC00001),
                                      (0x7FC00000, 0xFFC00000)],
                         ids=["two_nan_payloads", "nan_and_negative_nan"])
def test_float_value_identity_matches_jax(payloads):
    """nunique and collect_set of FLOAT32 NaNs of two payloads and of
    -0.0 and +0.0: each bit pattern is its own value in both packages
    (the order words keep NaN payloads and the sign of zero), and a set
    keeps the first row of each in row order."""
    bits = np.array([payloads[0], 0x80000000, payloads[1], 0, payloads[0],
                     0x3F800000, 0x80000000, payloads[1]], np.uint32)
    jt = JTable([JColumn.from_numpy(np.array([0, 0, 0, 0, 1, 1, 1, 1])),
                 JColumn.from_numpy(bits.view(np.float32))], ["k", "v"])
    aggs = [(1, "nunique"), (1, "collect_set"), (1, "collect_list"),
            (1, "first"), (1, "last")]
    want = _jax_exact(jt, ["k"], [jops.GroupbyAgg(c, a) for c, a in aggs])
    got = ops.groupby_aggregate(_port(jt), ["k"],
                                [ops.GroupbyAgg(c, a) for c, a in aggs])
    _same(want, got)


def test_collect_capacity_is_required_in_the_capped_api():
    jt = _table(16, 0, False)
    with pytest.raises(ValueError, match="list_capacity"):
        ops.groupby_aggregate_capped(_port(jt), ["k"],
                                     [ops.GroupbyAgg(3, "collect_list")], 16)
    with pytest.raises(TypeError, match="LIST children"):
        ops.groupby_aggregate(_port(jt), ["k"],
                              [ops.GroupbyAgg(1, "collect_set")])


# ---------------------------------------------------------------------------
# F5: XLA's CPU code flushes subnormal floats to zero, in what an
# operation reads and what it returns
# ---------------------------------------------------------------------------

TINY = np.finfo(np.float64).tiny


def _subnormal_values(n: int, seed: int) -> tuple:
    """(keys, FLOAT64 values) whose groups hold subnormals, normal values
    whose differences are subnormal (3 tiny - 2.5 tiny), values whose
    squared deviations underflow (1e-160 apart), and ordinary ones."""
    rng = np.random.default_rng(seed)
    pool = np.array([5e-324, 1e-310, -1e-310, 2.5e-308, 3 * TINY,
                     -2.5 * TINY, 1e-160, -1e-160, 2e-160, 1.0, -1.0, 0.5,
                     1e-300, -0.0])
    return rng.integers(0, 4, n), pool[rng.integers(0, pool.shape[0], n)]


F5_AGGS = ("sum", "mean", "variance", "std")


@pytest.mark.parametrize("n", [2, 3, 17, 1023, 1025])
def test_f5_subnormal_sums_match_jax(n):
    keys, vals = _subnormal_values(n, n)
    jt = JTable([JColumn.from_numpy(keys), JColumn.from_numpy(vals),
                 JColumn.from_numpy(vals.astype(np.float32) * 1e-20)],
                ["k", "v", "w"])
    aggs = _aggs([1, 2], F5_AGGS)
    want = _jax_exact(jt, ["k"], [jops.GroupbyAgg(c, a) for c, a in aggs])
    got = ops.groupby_aggregate(_port(jt), ["k"],
                                [ops.GroupbyAgg(c, a) for c, a in aggs])
    _same(want, got)
    wc, wg = _jax_capped(jt, ["k"], [jops.GroupbyAgg(c, a) for c, a in aggs],
                         n + 1)
    gc, gg = ops.groupby_aggregate_capped(
        _port(jt), ["k"], [ops.GroupbyAgg(c, a) for c, a in aggs], n + 1)
    assert int(wg) == int(gg)
    _same(wc, gc)


def test_f5_smallest_input():
    """The smallest input that differed on the parent: one group of two
    rows, 5e-324 and 0.0; XLA's sum is +0.0, an unflushed one 5e-324."""
    jt = JTable([JColumn.from_numpy(np.array([0, 0])),
                 JColumn.from_numpy(np.array([5e-324, 0.0]))], ["k", "v"])
    got = ops.groupby_aggregate(_port(jt), ["k"], [ops.GroupbyAgg(1, "sum")])
    assert got.columns[1].to_numpy().view(np.uint64)[0] == 0
    _same(_jax_exact(jt, ["k"], [jops.GroupbyAgg(1, "sum")]), got)


@pytest.mark.parametrize("n", [1, 1023, 1025])
def test_f5_subnormal_wire_groupby_matches_jax(n):
    keys, vals = _subnormal_values(n, 3 * n)
    wire = ([4, 10], [0, 0], [keys.astype(np.int64).tobytes(), vals.tobytes()],
            [None, None], n)
    plan = json.dumps([{"op": "groupby", "by": [0], "aggs": [
        {"column": 1, "agg": a} for a in F5_AGGS + ("first", "last")]}])
    want = jrb.table_plan_wire(plan, *wire)
    assert tuple(rb.table_plan_wire(plan, *wire, device="cpu")) == tuple(want)
