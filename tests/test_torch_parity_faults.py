"""Four faults of the PyTorch port against the JAX package, each held to
the JAX package's bytes on the CPU (the same numpy inputs, made from a
seed, through both packages):

* F1 — FLOAT64 groupby sums add in XLA's CPU scan order (blocks of 16,
  recursively), not in ``torch.cumsum``'s;
* F2 — FLOAT64/FLOAT32 groupby min/max give +0.0 where the JAX package's
  associative scan turns a -0.0 extreme into +0.0 (any input of 2 or
  more rows) and keep -0.0 for a single row;
* F3 — ``table_plan_resident(donate=True)`` checks the plan before it
  frees its input, so a rejected plan leaves the input live;
* F4 — ``to_rows`` of a 0-row table from the wire gives the JAX
  package's 0-row LIST<UINT8> column.

The groupby cases run through the ops (``groupby_aggregate``) and through
the wire ``groupby`` op of ``table_plan_resident``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import groupby_packed as jgp
from spark_rapids_jni_tpu.ops.groupby import groupby_aggregate_capped
from spark_rapids_jni_tpu_torch import interop, ops, plancheck
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.ops import groupby as pgb
from spark_rapids_jni_tpu_torch.ops import groupby_packed as pgp


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves the resident registries of both bridges as it found
    them: a table left behind would show in a later test's count."""
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


# ROADMAP Queue 3 F1's smallest input: one group, 18 FLOAT64 values
F1_ROWS = [
    59.63198219465419, 45.74272252693389, 56.12098844525571,
    34.20261247180689, 35.982419628235824, 50.43377073016518,
    46.69028133288621, 63.24105197899112, 47.04639965020695,
    32.05416904543981, 50.4039802369896, 46.83751887868299,
    51.69847399455005, 38.121552257154136, 42.02478881412041,
    50.43059145863465, 57.234759796412106, 53.94155534565769,
]
F1_SUM_BITS = 0x408AEEB78A0DF287  # the JAX package's sum of F1_ROWS
WIRE_TYPE = {np.float64: 10, np.float32: 9}


def _buffers(t: JTable) -> list:
    return [(np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity),
             None, int(c.dtype.id), int(c.dtype.scale)) for c in t.columns]


def _jax_groupby(jt: JTable, aggs) -> JTable:
    """The JAX ``groupby_aggregate`` by column 0: its capped form, jitted,
    sliced to the group count as the eager API does."""
    jaggs = [jops.GroupbyAgg(1, a) for a in aggs]
    padded, g = jax.jit(lambda t: groupby_aggregate_capped(
        t, [0], jaggs, num_segments=t.row_count))(jt)
    g = int(g)
    return JTable([JColumn(c.data[:g], c.dtype,
                           None if c.validity is None else c.validity[:g])
                   for c in padded.columns], padded.names)


def _same_bytes(jt: JTable, pt) -> None:
    want, got = _buffers(jt), interop.table_to_buffers(pt)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w[3:] == g[3:], f"column {i} type"
        assert w[0].dtype == g[0].dtype, f"column {i} dtype"
        assert w[0].tobytes() == g[0].tobytes(), f"column {i} data"
        if w[1] is not None:
            np.testing.assert_array_equal(g[1], w[1])


def _groupby_both(keys: np.ndarray, vals: np.ndarray, aggs):
    """(JAX result, port result) of GROUP BY keys over FLOAT values."""
    d = jdt.FLOAT64 if vals.dtype == np.float64 else jdt.FLOAT32
    jt = JTable([JColumn.from_numpy(keys.astype(np.int64)),
                 JColumn.from_numpy(vals, dtype=d)], ["k", "v"])
    pt = interop.table_from_buffers(_buffers(jt), ["k", "v"], device="cpu")
    got = ops.groupby_aggregate(pt, [0], [ops.GroupbyAgg(1, a) for a in aggs])
    return _jax_groupby(jt, aggs), got


def _wire_groupby_both(keys: np.ndarray, vals: np.ndarray, aggs):
    """The wire 5-tuples of the ``groupby`` op in both packages."""
    wire = ([4, WIRE_TYPE[vals.dtype.type]], [0, 0],
            [keys.astype(np.int64).tobytes(), vals.tobytes()], [None, None],
            keys.shape[0])
    plan = json.dumps([{"op": "groupby", "by": [0],
                        "aggs": [{"column": 1, "agg": a} for a in aggs]}])
    out = []
    for mod, kw in ((jrb, {}), (rb, {"device": "cpu"})):
        tid = mod.table_upload_wire(*wire, **kw)
        res = mod.table_plan_resident(plan, [tid])
        out.append(tuple(mod.table_download_wire(res)))
        mod.table_free(res)
        mod.table_free(tid)
    return out


def _normal_keys(n: int, n_keys: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_keys, n), rng.normal(50, 10, n)


# ---------------------------------------------------------------------------
# F1: FLOAT64 sums in XLA's scan order
# ---------------------------------------------------------------------------


def test_f1_smallest_input_sum_bytes():
    vals = np.array(F1_ROWS)
    want, got = _groupby_both(np.zeros(18), vals, ["sum"])
    _same_bytes(want, got)
    assert int(interop.table_to_buffers(got)[1][0].view(np.uint64)[0]) == \
        F1_SUM_BITS
    wj, wp = _wire_groupby_both(np.zeros(18), vals, ["sum"])
    assert wj == wp


@pytest.mark.parametrize("n", [1023, 1024, 1025])
def test_f1_eight_keys_sum_bytes(n):
    keys, vals = _normal_keys(n, 8, n)
    want, got = _groupby_both(keys, vals, ["sum", "count"])
    _same_bytes(want, got)
    wj, wp = _wire_groupby_both(keys, vals, ["sum"])
    assert wj == wp


@pytest.mark.parametrize("n", [16, 17, 256, 257, 4096, 4097])
def test_f1_scan_block_edges(n):
    """Lengths on either side of one block, one level and two levels of
    the base-16 scan: the scan alone against ``jnp.cumsum``, and a
    3-key groupby sum."""
    keys, vals = _normal_keys(n, 3, n + 7)
    want = np.asarray(jnp.cumsum(jnp.asarray(vals)))
    got = pgb._scan_sum16(torch.from_numpy(vals)).numpy()
    assert got.tobytes() == want.tobytes()
    _same_bytes(*_groupby_both(keys, vals, ["sum"]))


@pytest.mark.parametrize("n", [1, 2, 17, 1025])
def test_f1_negative_zero_sums(n):
    """A run of -0.0 values, alone and inside normal values: for n >= 2
    the scan starts each block from +0.0; a single row keeps -0.0."""
    rng = np.random.default_rng(n)
    vals = np.full(n, -0.0)
    keys = np.zeros(n)
    _same_bytes(*_groupby_both(keys, vals, ["sum"]))
    mixed = rng.normal(50, 10, n)
    mixed[: n // 2] = -0.0
    keys = rng.integers(0, 4, n)
    _same_bytes(*_groupby_both(keys, mixed, ["sum"]))
    wj, wp = _wire_groupby_both(keys, mixed, ["sum"])
    assert wj == wp


# ---------------------------------------------------------------------------
# F2: FLOAT min/max whose extreme is -0.0
# ---------------------------------------------------------------------------

F2_CASES = {
    # name: (keys, values)
    "two_groups": ([0, 1], [-0.0, 2.0]),
    "one_row": ([0], [-0.0]),
    "neg_then_pos": ([0, 0], [-0.0, 0.0]),
    "pos_then_neg": ([0, 0], [0.0, -0.0]),
    "all_negative_zero": ([0, 0, 1], [-0.0, -0.0, -0.0]),
}


@pytest.mark.parametrize("np_type", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("case", sorted(F2_CASES))
def test_f2_negative_zero_extremes(case, np_type):
    keys, vals = (np.array(x) for x in F2_CASES[case])
    vals = vals.astype(np_type)
    want, got = _groupby_both(keys, vals, ["min", "max"])
    _same_bytes(want, got)
    wj, wp = _wire_groupby_both(keys, vals, ["min", "max"])
    assert wj == wp


@pytest.mark.parametrize("np_type", [np.float64, np.float32],
                         ids=["float64", "float32"])
def test_f2_packed_segment_extreme_matches_jax(np_type):
    """The packed groupby's segment extreme (shared with the exact path)
    over -0.0 rows against the JAX function it ports."""
    from spark_rapids_jni_tpu.ops.groupby import (
        _sorted_segment_extreme as jext,
    )

    vals = np.array([-0.0, 0.0, -0.0, 3.0, 0.0, -0.0, -1.5], np_type)
    seg = np.array([0, 0, 1, 1, 2, 2, 3], np.int32)
    ends = np.array([2, 4, 6, 7], np.int32)
    for is_min in (True, False):
        want = np.asarray(jext(jnp.asarray(vals), jnp.asarray(seg),
                               jnp.asarray(ends), is_min))
        got = pgb._sorted_segment_extreme(
            torch.from_numpy(vals), torch.from_numpy(seg),
            torch.from_numpy(ends), is_min).numpy()
        assert got.tobytes() == want.tobytes()


def test_f1_f2_packed_groupby_float_bytes():
    """The packed two-level groupby over FLOAT64 values with -0.0 rows:
    its sums, min and max equal the JAX function's bytes."""
    n = 1025
    rng = np.random.default_rng(11)
    vals = rng.normal(50, 10, n)
    vals[rng.random(n) < 0.3] = -0.0
    keys = rng.integers(0, 40, n)
    jt = JTable([JColumn.from_numpy(keys), JColumn.from_numpy(vals)],
                ["k", "f"])
    pt = interop.table_from_buffers(_buffers(jt), ["k", "f"], device="cpu")
    ops_ = ["sum", "min", "max"]
    kw = dict(num_segments=64, chunk_rows=256, chunk_segments=64)
    want = jax.jit(lambda t: jgp.groupby_aggregate_packed_chunked(
        t, ["k"], [jops.GroupbyAgg("f", a) for a in ops_], **kw))(jt)
    got = pgp.groupby_aggregate_packed_chunked(
        pt, ["k"], [ops.GroupbyAgg("f", a) for a in ops_], **kw)
    g = int(want[1])
    assert (int(got[1]), bool(got[3])) == (g, bool(want[3]))
    for wc, gc in zip(want[0].columns, got[0].columns):
        w = np.asarray(wc.data)[:g]
        x = interop.column_to_buffers(gc)[0][:g]
        assert x.tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# F3: a rejected plan leaves a donated input live; F4: 0-row to_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", [[{"op": "bogus"}],
                                  [{"op": "filter", "mask": 5}]],
                         ids=["unknown_op", "mask_out_of_range"])
def test_f3_rejected_plan_keeps_donated_input(plan):
    wire = ([4], [0], [np.arange(8, dtype=np.int64).tobytes()], [None], 8)
    for mod, kw in ((jrb, {}), (rb, {"device": "cpu"})):
        tid = mod.table_upload_wire(*wire, **kw)
        with pytest.raises(ValueError, match="plancheck"):
            mod.table_plan_resident(json.dumps(plan), [tid], donate=True)
        assert mod.table_num_rows(tid) == 8
        mod.table_free(tid)


def test_f3_check_follows_the_column_count():
    """Indexes are checked against the columns that flow into each op:
    after a filter, a join and a groupby; a good plan passes."""
    i64, b8 = plancheck.ColType(4), plancheck.ColType(11)
    three = [i64, b8, i64]
    plancheck.check_plan([{"op": "filter", "mask": 1},
                          {"op": "join", "on": [0]},
                          {"op": "groupby", "by": [2],
                           "aggs": [{"column": 0, "agg": "sum"}]},
                          {"op": "sort_by", "keys": [{"column": 1}]}],
                         schema=three, rest=[([i64, i64, i64], None)])
    with pytest.raises(plancheck.PlanCheckError, match=r"op\[1\] 'sort_by'"):
        plancheck.check_plan([{"op": "filter", "mask": 1},
                              {"op": "sort_by", "keys": [{"column": 2}]}],
                             schema=three)
    with pytest.raises(plancheck.PlanCheckError, match="right table"):
        plancheck.check_plan([{"op": "join", "on": [2]}], schema=three,
                             rest=[([i64, i64], None)])
    with pytest.raises(plancheck.PlanCheckError, match="agg column"):
        plancheck.check_plan([{"op": "to_rows"},
                              {"op": "from_rows", "type_ids": [4, 4],
                               "scales": [0, 0]},
                              {"op": "groupby", "by": [0],
                               "aggs": [{"column": 2, "agg": "sum"}]}],
                             schema=three)
    with pytest.raises(plancheck.PlanCheckError, match="'column'"):
        plancheck.check_plan([{"op": "cast"}], schema=[i64])
    with pytest.raises(plancheck.PlanCheckError, match="rlike pattern"):
        plancheck.check_plan([{"op": "rlike", "column": 0}], schema=[i64])


def test_f4_zero_row_to_rows_matches_jax():
    wire = ([3], [0], [b""], [None], 0)
    plan = json.dumps([{"op": "to_rows"}])
    out = []
    for mod, kw in ((jrb, {}), (rb, {"device": "cpu"})):
        tid = mod.table_upload_wire(*wire, **kw)
        res = mod.table_plan_resident(plan, [tid])
        out.append(tuple(mod.table_download_wire(res)))
        mod.table_free(res)
        mod.table_free(tid)
    assert out[0] == out[1] == ([24], [5], [b"\x00\x00\x00\x00"], [None], 0)
