"""The port's dispatch plane against the JAX package's, on the CPU: every
ported op through ``table_plan_resident``, ``table_plan_wire`` and
``table_op_resident``, with the kernel tier on and off, the explicit
``rest`` field, and the plan check of the new ops.

Both packages get the same wire bytes. Tolerance 0: the wire 5-tuples
(type ids, scales, data bytes, validity bytes, rows) equal. The JAX
entries pad tables to a shape bucket; the port runs exact shapes and
gives the same logical rows. Inputs sit on the bucket edges 1023/1025
with 1-row tables, nulls in keys and values.

Where the JAX entries raise on an input Spark can send (``concat`` of the
unnamed wire tables; ROADMAP Queue 3), the test checks that JAX raises
and compares the port with the JAX ops on named tables instead.
"""

import json

import numpy as np
import pytest

from spark_rapids_jni_tpu import plancheck as jplancheck
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import copying as jcp
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import plancheck
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.utils import config as pconfig


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves the resident registries of both bridges as it found
    them: a table left behind would show in a later test's count."""
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


def _wire(n: int, seed: int, key_nulls: bool = True):
    """(k INT64 ~10 % null, f FLOAT64, i INT32, d DECIMAL64), values ~20 %
    null."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 30, n).astype(np.int64)
    f = rng.standard_normal(n) * 100
    i = rng.integers(-1000, 1000, n).astype(np.int32)
    d = rng.integers(-10**9, 10**9, n).astype(np.int64)
    kv = (rng.random(n) > 0.1).astype(np.uint8).tobytes() if key_nulls else None
    v = (rng.random(n) > 0.2).astype(np.uint8).tobytes()
    return ([4, 10, 3, 26], [0, 0, 0, -3],
            [k.tobytes(), f.tobytes(), i.tobytes(), d.tobytes()],
            [kv, v, v, None], n)


GROUPBY_AGGS = [{"column": c, "agg": a} for c in (1, 2, 3)
                for a in ("mean", "variance", "std", "first", "last",
                          "nunique")]
PLANS = {
    **{f"join_{h}": [{"op": "join", "how": h, "on": [0]}]
       for h in ("inner", "left", "right", "full", "semi", "anti")},
    "distinct_keys": [{"op": "distinct", "keys": [0, 2]}],
    "distinct_all": [{"op": "distinct"}],
    "cross_join": [{"op": "slice", "start": 2, "stop": 9},
                   {"op": "cross_join"}],
    "slice_clamped": [{"op": "slice", "start": 3, "stop": 100000}],
    "slice_past_the_end": [{"op": "slice", "start": 5000}],
    "repeat": [{"op": "repeat", "count": 3}],
    "sample": [{"op": "sample", "n": 1, "seed": 5}],
    "sample_replacement": [{"op": "sample", "n": 2000, "seed": 5,
                            "replacement": True}],
    "groupby_new_aggs": [{"op": "groupby", "by": [0], "aggs": GROUPBY_AGGS}],
    "groupby_collect": [{"op": "groupby", "by": [0], "aggs": [
        {"column": 2, "agg": a} for a in ("collect_list", "collect_set",
                                          "count", "sum")]}],
    "rest_field": [{"op": "join", "how": "left", "on": [0], "rest": [0]},
                   {"op": "join", "how": "semi", "on": [0], "rest": [0]}],
}


def _resident(mod, plan, wires, **kw):
    ids = [mod.table_upload_wire(*w, **kw) for w in wires]
    try:
        out = mod.table_plan_resident(json.dumps(plan), ids)
        ids.append(out)
        return tuple(mod.table_download_wire(out))
    finally:
        for t in ids:
            mod.table_free(t)


#: the plans the kernel tier takes a route of (joins, groupbys) run with
#: the tier on too
TIER_PLANS = ("join_inner", "join_semi", "join_anti", "groupby_new_aggs",
              "groupby_collect", "rest_field")
CASES = [(name, n, tier) for name in sorted(PLANS) for n in (1, 1023, 1025)
         for tier in (("off", "on") if name in TIER_PLANS else ("off",))]


@pytest.mark.parametrize("name,n,tier", CASES)
def test_resident_plans_match_jax(name, n, tier):
    wires = [_wire(n, n), _wire(max(n // 3, 1), n + 1)]
    try:
        for c in (jconfig, pconfig):
            c.set_flag("KERNELS", tier)
        want = _resident(jrb, PLANS[name], wires)
        assert _resident(rb, PLANS[name], wires, device="cpu") == want
    finally:
        for c in (jconfig, pconfig):
            c.clear_flag("KERNELS")


@pytest.mark.parametrize("name", ["distinct_keys", "groupby_new_aggs",
                                  "groupby_collect", "repeat",
                                  "slice_clamped", "sample"])
def test_wire_plans_match_jax(name):
    wire = _wire(1025, 11)
    plan = json.dumps(PLANS[name])
    want = jrb.table_plan_wire(plan, *wire)
    assert tuple(rb.table_plan_wire(plan, *wire, device="cpu")) == tuple(want)


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("op", [{"op": "join", "how": "anti", "on": [0]},
                                {"op": "join", "how": "full", "on": [0]},
                                {"op": "cross_join"},
                                {"op": "distinct", "keys": [2]}],
                         ids=lambda o: o.get("how", o["op"]))
def test_op_resident_matches_jax(op, donate):
    wires = [_wire(40, 1), _wire(30, 2)]
    got = []
    for mod, kw in ((jrb, {}), (rb, {"device": "cpu"})):
        ids = [mod.table_upload_wire(*w, **kw) for w in wires]
        out = mod.table_op_resident(json.dumps(op), ids, donate=donate)
        got.append(tuple(mod.table_download_wire(out)))
        live = ids[1:] + [out] if donate else ids + [out]
        if donate:
            with pytest.raises(KeyError, match="already-freed"):
                mod.table_num_rows(ids[0])
        for t in live:
            mod.table_free(t)
    assert got[0] == got[1]


def test_op_resident_refuses_before_a_donation():
    tid = rb.table_upload_wire(*_wire(10, 3), device="cpu")
    with pytest.raises(plancheck.PlanCheckError, match="negative bounds"):
        rb.table_op_resident(json.dumps({"op": "slice", "start": -1}), [tid],
                             donate=True)
    assert rb.table_num_rows(tid) == 10  # still live
    rb.table_free(tid)


def test_concat_of_wire_tables():
    """``concat`` of unnamed wire tables: the JAX entry raises (its
    ``concatenate`` reads the first table's names); the port gives the
    rows of the JAX ops on named tables, the nullable column's validity
    merged."""
    wires = [_wire(5, 1, key_nulls=False), _wire(7, 2), _wire(3, 3)]
    ids = [jrb.table_upload_wire(*w) for w in wires]
    with pytest.raises(TypeError, match="NoneType"):
        jrb.table_plan_resident(json.dumps([{"op": "concat"}]), ids)
    for t in ids:
        jrb.table_free(t)
    for plan, order in (([{"op": "concat"}], [0, 1, 2]),
                        ([{"op": "concat", "rest": [1]}], [0, 2])):
        tables = [jrb._table_from_wire(*wires[i][:5], None) for i in order]
        named = [JTable(t.columns, ["k", "f", "i", "d"]) for t in tables]
        want = jrb._table_to_wire(jcp.concatenate(named))
        assert _resident(rb, plan, wires, device="cpu") == tuple(want)


def test_ported_ops_and_their_rules():
    assert rb.PORTED_OPS == jrb.DISPATCH_OPS
    assert set(plancheck._RULES) == set(rb.PORTED_OPS)
    with pytest.raises(plancheck.PlanCheckError, match="LIST column"):
        plancheck.check_plan([{"op": "explode", "column": 0}],
                             schema=plancheck.schema_from_wire([4], [0]))


# plans the JAX package's check refuses: the port refuses them too, with
# the same error class and op index
REFUSED = {
    "slice_negative": [{"op": "slice", "start": -2}],
    "slice_not_int": [{"op": "slice", "stop": "x"}],
    "repeat_negative": [{"op": "repeat", "count": -1}],
    "repeat_not_int": [{"op": "repeat", "count": 1.5}],
    "sample_negative": [{"op": "sample", "n": -3}],
    "sample_bool": [{"op": "sample", "n": True}],
    "cross_join_alone": [{"op": "cross_join"}],
    "join_alone": [{"op": "join", "how": "semi", "on": [0]}],
    "rest_out_of_range": [{"op": "join", "on": [0], "rest": [4]}],
    "concat_mismatch": [{"op": "concat", "rest": [0]}],
    "distinct_keys_not_list": [{"op": "distinct", "keys": 0}],
    "distinct_key_out_of_range": [{"op": "distinct", "keys": [9]}],
    "full_join_key_types": [{"op": "join", "how": "full", "on": [2]}],
    "collect_of_float64": [{"op": "groupby", "by": [0], "aggs": [
        {"column": 1, "agg": "collect_list"}]}],
    "unknown_how": [{"op": "join", "how": "outer", "on": [0]}],
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_plan_check_refuses_as_jax(name):
    ops = REFUSED[name]
    schema = jplancheck.schema_from_wire([4, 10, 3, 26], [0, 0, 0, -3])
    extra = name not in ("cross_join_alone", "join_alone")
    rest = [(jplancheck.schema_from_wire([4, 4], [0, 0]), 10)][:extra]
    with pytest.raises(jplancheck.PlanCheckError) as want:
        jplancheck.check_plan(ops, schema=schema, rows=100, rest=rest)
    pschema = plancheck.schema_from_wire([4, 10, 3, 26], [0, 0, 0, -3])
    prest = [(plancheck.schema_from_wire([4, 4], [0, 0]), 10)][:extra]
    with pytest.raises(plancheck.PlanCheckError) as got:
        plancheck.check_plan(ops, schema=pschema, rows=100, rest=prest)
    assert got.value.index == want.value.index
    assert got.value.reason == want.value.reason


def test_plan_check_row_bounds_match_jax():
    ops = [{"op": "slice", "start": 10, "stop": 70},
           {"op": "repeat", "count": 3}, {"op": "concat"},
           {"op": "cross_join", "rest": [0]}, {"op": "sample", "n": 4},
           {"op": "distinct"}]
    schema = [4, 10, 3, 26]
    for rest_rows in (None, 7):
        want = jplancheck.check_plan(
            ops, schema=jplancheck.schema_from_wire(schema, [0, 0, 0, -3]),
            rows=100, rest=[(jplancheck.schema_from_wire(schema,
                                                         [0, 0, 0, -3]),
                             rest_rows)])
        got = plancheck.check_plan(
            ops, schema=plancheck.schema_from_wire(schema, [0, 0, 0, -3]),
            rows=100, rest=[(plancheck.schema_from_wire(schema,
                                                        [0, 0, 0, -3]),
                             rest_rows)])
        assert ([o["rows_bound"] for o in got["ops"]]
                == [o["rows_bound"] for o in want["ops"]])
        assert len(got["out_schema"]) == len(want["out_schema"])
