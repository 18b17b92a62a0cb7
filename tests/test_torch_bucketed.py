"""The port's bucketed runners (``bucketed.py``) and the wire entries'
padding against the JAX package's, on the CPU.

Every runner (cast, filter, sort_by, groupby, distinct, rlike, and the
inner/left/semi/anti joins) runs through ``table_op_wire``,
``table_plan_wire`` and resident plans at 15/16/17 and 1,023/1,024/1,025
rows under the ladder ``16:2:1024`` (so 1,025 rows have no bucket and
run exact), with nulls and STRING keys, in both packages; the 5-tuples
must be equal, padding reads included: a ``first`` with no later valid
value and a LEFT join whose build keys are all null read the padding
tail. F7 (the port ignored ``SPARK_RAPIDS_TPU_BUCKETS``) is held at the
F2 inputs under ``off``, ``16:2:64``, ``8,64,512`` and the default, and
past a ladder's cap. The kernel tier runs on the padded inputs too
(``KERNELS=on`` in both). Tolerance 0.
"""

import json

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.utils import config as pconfig
from spark_rapids_jni_tpu_torch.utils import metrics as pmetrics

LADDER = "16:2:1024"
EDGES = (15, 16, 17, 1023, 1024, 1025)
I64, F64, F32, STR, I32, B8 = 4, 10, 9, 23, 3, 11


@pytest.fixture(autouse=True)
def _clean():
    """Both registries unchanged; both packages' flags cleared."""
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    for c in (jconfig, pconfig):
        for f in ("BUCKETS", "KERNELS", "METRICS"):
            c.clear_flag(f)
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


def _set(name, value):
    for c in (jconfig, pconfig):
        c.set_flag(name, value)


WORDS = ["apple", "ab", "", "banana", "a", "cherry pie", "abc", "zz"]


def _strings(vals, valid):
    lens = np.array([len(v) for v in vals], np.int32)
    offs = np.zeros(len(vals) + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    data = offs.tobytes() + "".join(vals).encode()
    return data, valid.astype(np.uint8).tobytes()


def _wire(n: int, seed: int, key_range: int = 12):
    """(k INT64 ~10 % null, v FLOAT64 ~20 % null, s STRING ~10 % null,
    i INT32 no nulls, m BOOL8 mask)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, key_range, n).astype(np.int64)
    v = rng.normal(50, 10, n)
    s_vals = [WORDS[j] for j in rng.integers(0, len(WORDS), n)]
    s_data, s_valid = _strings(s_vals, rng.random(n) > 0.1)
    i = rng.integers(0, key_range, n).astype(np.int32)
    m = (rng.random(n) > 0.4).astype(np.uint8)
    return ([I64, F64, STR, I32, B8], [0] * 5,
            [k.tobytes(), v.tobytes(), s_data, i.tobytes(), m.tobytes()],
            [(rng.random(n) > 0.1).astype(np.uint8).tobytes(),
             (rng.random(n) > 0.2).astype(np.uint8).tobytes(),
             s_valid, None, None], n)


def _op_wire(op, wire):
    want = tuple(jrb.table_op_wire(json.dumps(op), *wire))
    got = tuple(rb.table_op_wire(json.dumps(op), *wire, device="cpu"))
    return want, got


def _plan_wire(plan, wire):
    want = tuple(jrb.table_plan_wire(json.dumps(plan), *wire))
    got = tuple(rb.table_plan_wire(json.dumps(plan), *wire, device="cpu"))
    return want, got


def _resident(mod, plan, wires, **kw):
    ids = [mod.table_upload_wire(*w, **kw) for w in wires]
    try:
        out = mod.table_plan_resident(json.dumps(plan), ids)
        ids.append(out)
        return (tuple(mod.table_download_wire(out)),
                [mod.table_num_rows(t) for t in ids])
    finally:
        for t in ids:
            mod.table_free(t)


def _resident_both(plan, wires):
    return (_resident(jrb, plan, wires),
            _resident(rb, plan, wires, device="cpu"))


AGGS = [{"column": 1, "agg": a}
        for a in ("sum", "count", "min", "max", "first", "last")]
OPS = {
    "cast": {"op": "cast", "column": 3, "type_id": F64},
    "filter": {"op": "filter", "mask": 4},
    "sort_nullable": {"op": "sort_by", "keys": [{"column": 0}]},
    "sort_string_desc": {"op": "sort_by",
                         "keys": [{"column": 2, "ascending": False}]},
    "groupby": {"op": "groupby", "by": [0], "aggs": AGGS},
    "groupby_string_key": {"op": "groupby", "by": [2],
                           "aggs": [{"column": 3, "agg": "sum"},
                                    {"column": 1, "agg": "first"}]},
    "distinct": {"op": "distinct", "keys": [0, 2]},
    "rlike": {"op": "rlike", "column": 2, "pattern": "a.*b"},
}


#: past the ladder's cap both packages run the exact path, which the JAX
#: package compiles op by op: a few ops keep the test short there
EXACT_OPS = ("cast", "filter")


@pytest.mark.parametrize("n", EDGES)
def test_op_wire_runners_match_jax(n):
    _set("BUCKETS", LADDER)
    wire = _wire(n, n)
    for name, op in OPS.items():
        if n > 1024 and name not in EXACT_OPS:
            continue
        want, got = _op_wire(op, wire)
        assert got == want, name


PLANS = {
    # filter -> first/last: the groupby reads the capped filter's clone
    # tail where a group has no later valid value
    "filter_groupby_first": [
        {"op": "filter", "mask": 4},
        {"op": "groupby", "by": [0], "aggs": AGGS}],
    "filter_sort_distinct": [
        {"op": "filter", "mask": 4},
        {"op": "sort_by", "keys": [{"column": 2}]},
        {"op": "distinct", "keys": [2]}],
    "rlike_cast_groupby_string": [
        {"op": "rlike", "column": 2, "pattern": "^a"},
        {"op": "cast", "column": 3, "type_id": I64},
        {"op": "groupby", "by": [2], "aggs": [{"column": 3, "agg": "sum"}]}],
    "slice_then_sort": [
        {"op": "slice", "start": 3, "stop": 900},
        {"op": "sort_by", "keys": [{"column": 3}]}],
}


@pytest.mark.parametrize("n", EDGES)
def test_plan_wire_chains_match_jax(n):
    _set("BUCKETS", LADDER)
    wire = _wire(n, n + 1)
    for name, plan in PLANS.items():
        if n > 1024 and name not in ("filter_groupby_first", "slice_then_sort"):
            continue
        want, got = _plan_wire(plan, wire)
        assert got == want, name


JOIN_PLANS = {
    **{f"join_{h}": [{"op": "join", "how": h, "on": [0]}]
       for h in ("inner", "left", "semi", "anti")},
    "join_string_key_inner": [{"op": "join", "how": "inner", "on": [2]}],
    # filter -> left join: the build side of the second join is a
    # padded result; a LEFT join reads a padding row where no build key
    # matches
    "filter_left_join": [{"op": "filter", "mask": 4},
                         {"op": "join", "how": "left", "on": [0]}],
    "filter_semi_then_groupby": [
        {"op": "filter", "mask": 4},
        {"op": "join", "how": "semi", "on": [0]},
        {"op": "groupby", "by": [0], "aggs": AGGS[:2] + AGGS[4:5]}],
}


@pytest.mark.parametrize("n", (15, 17, 1025))
def test_resident_join_plans_match_jax(n):
    """Every join plan at 17 rows (bucket 32); at 15 (one pad row) and
    1,025 (no bucket) the filter -> LEFT join chain, which reads the
    padded build side."""
    _set("BUCKETS", LADDER)
    wires = [_wire(n, n + 2), _wire(40, 3, key_range=8)]
    for name, plan in JOIN_PLANS.items():
        if n != 17 and name != "filter_left_join":
            continue
        want, got = _resident_both(plan, wires)
        assert got == want, name


TIER_PLANS = {
    "sort": [{"op": "sort_by", "keys": [{"column": 3, "ascending": False}]}],
    "groupby": [{"op": "groupby", "by": [3],
                 "aggs": [{"column": 3, "agg": a}
                          for a in ("sum", "count", "min", "max")]}],
    "filter_groupby": [{"op": "filter", "mask": 4},
                       {"op": "groupby", "by": [3],
                        "aggs": [{"column": 3, "agg": "sum"}]}],
    "semi": [{"op": "join", "how": "semi", "on": [3]}],
    "anti": [{"op": "join", "how": "anti", "on": [3]}],
}


@pytest.mark.parametrize("n", (17,))
def test_kernel_tier_on_padded_inputs_matches_jax(n):
    """The tier's runners on padded resident tables (the JAX tier runs in
    interpret mode here): equal 5-tuples, and the port's tier launches,
    but inside a fused segment ([filter, groupby] in both packages),
    where the tier is not consulted."""
    from spark_rapids_jni_tpu_torch import plan as plan_mod

    _set("BUCKETS", LADDER)
    _set("KERNELS", "on")
    _set("METRICS", "1")
    wires = [_wire(n, n + 4), _wire(40, 5, key_range=8)]
    for name in ("sort", "groupby", "filter_groupby", "semi"):
        plan = TIER_PLANS[name]
        pmetrics.reset()
        want, got = _resident_both(plan, wires)
        assert got == want, name
        launches = pmetrics.counter_values(["kernel.launches"])[
            "kernel.launches"]
        if plan_mod.segment_plan(plan)[0][0] == "fused":
            assert launches == 0, name
        else:
            assert launches >= 1, name


def test_tier_keeps_launching_without_a_bucket():
    """Under ``BUCKETS=off`` the JAX tier declines ("no shape bucket")
    and runs its exact path; the port's kernels need no bucket and keep
    launching, with the bytes of the port's exact path (held against the
    JAX package's by the files of the dispatch plane)."""
    _set("BUCKETS", "off")
    _set("METRICS", "1")
    wires = [_wire(100, 7), _wire(40, 8, key_range=8)]
    for name, plan in TIER_PLANS.items():
        got = {}
        for tier in ("off", "on"):
            pconfig.set_flag("KERNELS", tier)
            pmetrics.reset()
            got[tier] = _resident(rb, plan, wires, device="cpu")
            c = pmetrics.counter_values(["kernel.launches",
                                         "kernel.declines"])
        assert got["on"] == got["off"], name
        assert c["kernel.launches"] >= 1 and c["kernel.declines"] == 0, name


# ---------------------------------------------------------------------------
# F7: the port ignored SPARK_RAPIDS_TPU_BUCKETS
# ---------------------------------------------------------------------------

F7_SPECS = ["off", "16:2:64", "8,64,512", ""]
F2_CASES = {
    # name: (keys, values): test_torch_parity_faults.py's F2 inputs
    "two_groups": ([0, 1], [-0.0, 2.0]),
    "one_row": ([0], [-0.0]),
    "neg_then_pos": ([0, 0], [-0.0, 0.0]),
    "pos_then_neg": ([0, 0], [0.0, -0.0]),
    "all_negative_zero": ([0, 0, 1], [-0.0, -0.0, -0.0]),
}


def _groupby_wire(keys, vals):
    t = F64 if vals.dtype == np.float64 else F32
    return ([I64, t], [0, 0], [keys.astype(np.int64).tobytes(),
                               vals.tobytes()], [None, None], keys.shape[0])


@pytest.mark.parametrize("spec,np_type", [
    (spec, np.float64) for spec in F7_SPECS] + [
    ("off", np.float32), ("", np.float32)],
    ids=lambda v: (v or "default") if isinstance(v, str) else v.__name__)
def test_f7_wire_groupby_follows_the_ladder(spec, np_type):
    """The smallest input of F7: a 1-row FLOAT64 -0.0 min/max/sum gives
    -0.0 under ``off`` (no padding) and +0.0 when a bucket pads it."""
    _set("BUCKETS", spec)
    plan = [{"op": "groupby", "by": [0], "aggs": [
        {"column": 1, "agg": a} for a in ("min", "max", "sum")]}]
    for name, (keys, vals) in sorted(F2_CASES.items()):
        wire = _groupby_wire(np.array(keys), np.array(vals, np_type))
        want, got = _resident_both(plan, [wire])
        assert got == want, name


@pytest.mark.parametrize("spec", F7_SPECS, ids=lambda s: s or "default")
def test_f7_wire_left_join_follows_the_ladder(spec):
    """A LEFT join whose build keys are all null reads a zero padding row
    for its unmatched rows when the build side is padded, the last build
    row when it is not; one with valid build keys reads its matches."""
    _set("BUCKETS", spec)
    rng = np.random.default_rng(7)
    left = ([I64, I64], [0, 0], [np.arange(6, dtype=np.int64).tobytes(),
                                 rng.integers(0, 9, 6).tobytes()],
            [None, None], 6)
    for n_build, null_keys in ((3, True), (5, False)):
        rk = rng.integers(0, 6, n_build).astype(np.int64)
        rv = rng.integers(100, 200, n_build).astype(np.int64)
        kv = np.zeros(n_build, np.uint8) if null_keys else None
        right = ([I64, I64], [0, 0], [rk.tobytes(), rv.tobytes()],
                 [None if kv is None else kv.tobytes(), None], n_build)
        want, got = _resident_both(
            [{"op": "join", "how": "left", "on": [0]}], [left, right])
        assert got == want, (n_build, null_keys)


def test_f7_ladder_cap_leaves_a_table_unpadded():
    """Under ``1024:2:2048`` a 3,000-row table has no bucket in the JAX
    package and runs exact; the port pads it no more (FLOAT64 sums scan
    3,000 rows, not 4,096)."""
    _set("BUCKETS", "1024:2:2048")
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 8, 3000)
    vals = rng.normal(50, 10, 3000)
    plan = [{"op": "groupby", "by": [0],
             "aggs": [{"column": 1, "agg": "sum"}]}]
    want, got = _resident_both(plan, [_groupby_wire(keys, vals)])
    assert got == want


def test_resident_counts_are_logical_and_streams_pad():
    """Resident tables count logical rows, and ``table_stream_wire``
    decodes each batch to its own bucket as ``table_plan_wire`` does."""
    _set("BUCKETS", LADDER)
    batches = [_wire(n, n + 9) for n in (17, 1024, 3, 1025)]
    plan = PLANS["filter_groupby_first"]
    want = jrb.table_stream_wire(json.dumps(plan), batches)
    got = rb.table_stream_wire(json.dumps(plan), batches, device="cpu")
    assert [tuple(g) for g in got] == [tuple(w) for w in want]
    tid = rb.table_upload_wire(*batches[0], device="cpu")
    try:
        assert rb.table_num_rows(tid) == 17
        assert rb._resident_get(tid).row_count == 32
    finally:
        rb.table_free(tid)


@pytest.mark.parametrize("op", [
    {"op": "filter", "mask": 4},
    {"op": "slice", "start": 2, "stop": 11},
    {"op": "sort_by", "keys": [{"column": 3}]},
], ids=lambda o: o["op"])
def test_donated_op_resident_matches_jax(op):
    """``table_op_resident(donate=True)``: the port runs a donated op as
    a plan of one, and gives the bytes and logical rows of the JAX
    package's donated one-op segment."""
    _set("BUCKETS", LADDER)
    wire = _wire(17, 21)
    got = []
    for mod, kw in ((jrb, {}), (rb, {"device": "cpu"})):
        tid = mod.table_upload_wire(*wire, **kw)
        out = mod.table_op_resident(json.dumps(op), [tid], donate=True)
        try:
            got.append((tuple(mod.table_download_wire(out)),
                        mod.table_num_rows(out)))
        finally:
            mod.table_free(out)
    assert got[1] == got[0]


@pytest.mark.parametrize("k,tail", [
    (0, "random"), (5, "random"), (5, "clones"), (5, "zeros"), (20, "none"),
    (None, "random")])
def test_occupied_sort_is_the_occupancy_words_sort(k, tail):
    """``sort.lexsort_occupied`` gives the permutation of a stable sort by
    the occupancy word and the keys: over a prefix occupancy it sorts the
    two parts apart and leaves a constant tail unsorted; any other
    occupancy (``k=None``: random) takes the one sort."""
    from spark_rapids_jni_tpu_torch.ops.sort import lexsort, lexsort_occupied

    rng = np.random.default_rng(11)
    n = 20
    words = [torch.from_numpy(rng.integers(0, 3, n)),
             torch.from_numpy(rng.integers(-5, 5, n)),
             torch.from_numpy(rng.integers(0, 2, n).astype(np.uint8))]
    if k is None:
        rv = torch.from_numpy(rng.random(n) > 0.4)
    else:
        rv = torch.arange(n) < k
        if tail == "clones":
            words = [torch.where(rv, w, w[0]) for w in words]
        elif tail == "zeros":
            words = [torch.where(rv, w, torch.zeros_like(w)) for w in words]
    want = lexsort([(~rv).to(torch.uint8)] + words)
    assert torch.equal(lexsort_occupied(words, rv), want)
    assert torch.equal(lexsort_occupied([], rv),
                       lexsort([(~rv).to(torch.uint8)]))
