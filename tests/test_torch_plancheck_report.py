"""The rest of the port's ``plancheck.py`` against the JAX package's, on
the CPU: support tiers, kernel tags, the per-segment memory estimate and
``render_report``.

* For plans where the two kernel tiers agree, ``analyze`` gives the same
  segments, ``est_hbm_bytes``, ``est_hbm_peak_bytes``, tiers, reasons and
  kernel tags, and ``render_report`` the same text, rejected plans
  included (the walk goes on past a refusal with the schema unknown).
* ``_kernel_tag`` predicts the PORT's tier: an op of a one-op plan with
  ``KERNELS=on`` is launched by the registry exactly when it is tagged
  (inputs without nulls: a nullable key is a runtime decline).
* Where the tiers differ, each recorded divergence is a case of its own:
  the port's tier declines an empty input and a row count past its int32
  bounds statically, where the JAX tag only looks at the op and schema.
"""

import json

import numpy as np
import pytest

from spark_rapids_jni_tpu import plancheck as jplancheck
from spark_rapids_jni_tpu_torch import plancheck
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.kernels import bitonic_sort, registry
from spark_rapids_jni_tpu_torch.utils import config, metrics

from test_torch_wire_plan import QTY_BY_DATE

# [INT64 key, FLOAT64, INT32, DECIMAL64(-3), BOOL8 mask, STRING]
TYPES, SCALES = [4, 10, 3, 26, 11, 23], [0, 0, 0, -3, 0, 0]
REST = [([4, 4], [0, 0], 40)]

PLANS = {
    "cells_plan": (QTY_BY_DATE, ([24], [5]), 256, []),
    "fused_chain": ([{"op": "filter", "mask": 4}, {"op": "cast", "column": 2,
                     "type_id": 4}, {"op": "sort_by", "keys": [{"column": 0}]},
                     {"op": "groupby", "by": [0], "aggs": [
                         {"column": 2, "agg": "sum"},
                         {"column": 2, "agg": "max"}]},
                     {"op": "to_rows"}], None, 256, []),
    "joins": ([{"op": "join", "how": "inner", "on": [0]},
               {"op": "join", "how": "left", "on": [0], "rest": [0]},
               {"op": "join", "how": "semi", "on": [0], "rest": [0]},
               {"op": "join", "how": "full", "on": [0], "rest": [0]}],
              None, 256, REST),
    "exact_ops": ([{"op": "distinct"}, {"op": "slice", "start": 3, "stop": 90},
                   {"op": "repeat", "count": 2}, {"op": "sample", "n": 7},
                   {"op": "concat", "rest": [0, 0]}], None, 256,
                  [(TYPES, SCALES, 100)]),
    "strings_and_floats": ([{"op": "rlike", "column": 5, "pattern": "a.*"},
                            {"op": "sort_by", "keys": [{"column": 5}]},
                            {"op": "groupby", "by": [5], "aggs": [
                                {"column": 1, "agg": "sum"}]},
                            {"op": "cast", "column": 0, "type_id": 23}],
                           None, 256, []),
    "collect_and_mean": ([{"op": "groupby", "by": [0], "aggs": [
                              {"column": 2, "agg": "collect_list"}]},
                          {"op": "explode", "column": 1}], None, 256, []),
    "multi_key_sort_partition": ([
        {"op": "sort_by", "keys": [{"column": 0}, {"column": 2}]},
        {"op": "partition", "kind": "hash", "keys": [0], "num": 8},
        {"op": "groupby", "by": [0, 2], "aggs": [{"column": 1,
                                                  "agg": "mean"}]}],
        None, 256, []),
    "rejected_then_walked": ([{"op": "filter", "mask": 9},
                              {"op": "sort_by", "keys": [{"column": 0}]},
                              {"op": "nope"}, "not an op"], None, 256, []),
    "unknown_schema": ([{"op": "sort_by", "keys": [{"column": 0}]},
                        {"op": "groupby", "by": [0], "aggs": [
                            {"column": 1, "agg": "sum"}]}], "none", None, []),
    "not_a_list": ({"op": "filter"}, None, 256, []),
}


def _args(pc, schema, rows, rest):
    if schema == "none":
        sch = None
    else:
        t, s = schema or (TYPES, SCALES)
        sch = pc.schema_from_wire(t, s)
    return dict(schema=sch, rows=rows,
                rest=[(pc.schema_from_wire(t, s), r) for t, s, r in rest])


def _proj(report: dict) -> dict:
    out = {k: v for k, v in report.items() if k not in ("ops", "out_schema")}
    out["ops"] = [{k: v for k, v in e.items() if k != "out_schema"}
                  for e in report["ops"]]
    out["schemas"] = [None if e.get("out_schema") is None else
                      [c["pretty"] if isinstance(c, dict) else c.pretty()
                       for c in e["out_schema"]] for e in report["ops"]]
    return out


@pytest.mark.parametrize("name", sorted(PLANS))
def test_analyze_and_render_match_jax(name):
    ops, schema, rows, rest = PLANS[name]
    got = plancheck.analyze(ops, **_args(plancheck, schema, rows, rest))
    want = jplancheck.analyze(ops, **_args(jplancheck, schema, rows, rest))
    assert _proj(got) == _proj(want)
    assert plancheck.render_report(got) == jplancheck.render_report(want)
    if isinstance(ops, list):
        assert plancheck.predict_segments(ops) == jplancheck.predict_segments(
            ops)


def test_rule_tables_mirror_the_runtime():
    from spark_rapids_jni_tpu_torch import bucketed

    assert set(plancheck._KERNEL_RULES) == registry.KERNEL_NAMES
    for name, (op, _) in plancheck._KERNEL_RULES.items():
        assert registry._REGISTRY[name].ops == (op,)
    assert plancheck._BUCKETED_OPS == frozenset(bucketed._RUNNERS)
    assert set(plancheck._KERNEL_RULES) == set(jplancheck._KERNEL_RULES)
    assert (plancheck._JOIN_BUILD_MAX_ROWS, plancheck._JOIN_PROBE_MAX_ROWS,
            plancheck._GROUPBY_MAX_ROWS, plancheck._SORT_MAX_ROWS) == (
        registry.JOIN_BUILD_MAX_ROWS, registry.JOIN_PROBE_MAX_ROWS,
        registry.GROUPBY_MAX_ROWS, bitonic_sort.MAX_T)


# divergences: the port's tier declines statically where the JAX tag
# still names its kernel
DIVERGENT = {
    "sort_empty_input": ([{"op": "sort_by", "keys": [{"column": 0}]}], 0, []),
    "groupby_empty_input": ([{"op": "groupby", "by": [0], "aggs": [
        {"column": 2, "agg": "sum"}]}], 0, []),
    "join_empty_build": ([{"op": "join", "how": "inner", "on": [0]}], 50,
                         [([4, 4], [0, 0], 0)]),
    "sort_past_the_int32_bound": ([{"op": "sort_by",
                                    "keys": [{"column": 0}]}], 1 << 31, []),
    "groupby_past_the_slot_bound": ([{"op": "groupby", "by": [0], "aggs": [
        {"column": 2, "agg": "count"}]}], (1 << 30) + 1, []),
}


@pytest.mark.parametrize("name", sorted(DIVERGENT))
def test_recorded_divergences(name):
    ops, rows, rest = DIVERGENT[name]
    got = plancheck.analyze(ops, **_args(plancheck, None, rows, rest))
    want = jplancheck.analyze(ops, **_args(jplancheck, None, rows, rest))
    assert got["ops"][0]["kernel"] is None
    assert want["ops"][0]["kernel"] == registry._BY_OP[ops[0]["op"]][0].name
    assert got["segments"] == want["segments"]
    assert got["est_hbm_peak_bytes"] == want["est_hbm_peak_bytes"]


def _wire(n: int, seed: int):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 20, n).astype(np.int64),
            rng.standard_normal(n),
            rng.integers(-50, 50, n).astype(np.int32),
            rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64),
            (rng.random(n) > 0.5).astype(np.uint8)]
    strs = [f"s{int(v)}" for v in rng.integers(0, 9, n)]
    offs = np.zeros(n + 1, np.int32)
    offs[1:] = np.cumsum([len(s) for s in strs])
    datas = [c.tobytes() for c in cols] + [
        offs.tobytes() + "".join(strs).encode()]
    return (TYPES, SCALES, datas, [None] * 6, n)


TAGGED = {
    "sort_one_key": {"op": "sort_by", "keys": [{"column": 0}]},
    "sort_two_keys": {"op": "sort_by", "keys": [{"column": 0}, {"column": 2}]},
    "sort_string_key": {"op": "sort_by", "keys": [{"column": 5}]},
    "groupby_int": {"op": "groupby", "by": [0], "aggs": [
        {"column": 2, "agg": a} for a in ("sum", "count", "min", "max")]},
    "groupby_mean": {"op": "groupby", "by": [0], "aggs": [
        {"column": 2, "agg": "mean"}]},
    "groupby_float_value": {"op": "groupby", "by": [0], "aggs": [
        {"column": 1, "agg": "sum"}]},
    "groupby_two_keys": {"op": "groupby", "by": [0, 2], "aggs": [
        {"column": 3, "agg": "sum"}]},
    "to_rows_fixed": {"op": "to_rows"},
    "join_inner": {"op": "join", "how": "inner", "on": [0]},
    "join_semi": {"op": "join", "how": "semi", "on": [0]},
    "join_left": {"op": "join", "how": "left", "on": [0]},
}


@pytest.fixture
def tier_on():
    config.set_flag("KERNELS", "on")
    config.set_flag("METRICS", "on")
    metrics.reset()
    yield
    config.clear_flag("KERNELS")
    config.clear_flag("METRICS")
    metrics.reset()


def _launched(op, wire) -> int:
    metrics.reset()
    if op["op"] == "join":
        build = (TYPES[:1], SCALES[:1], [np.arange(15, dtype=np.int64).tobytes()],
                 [None], 15)
        a = rb.table_upload_wire(*wire, device="cpu")
        b = rb.table_upload_wire(*build, device="cpu")
        try:
            rb.table_free(rb.table_op_resident(json.dumps(op), [a, b]))
        finally:
            rb.table_free(a)
            rb.table_free(b)
    else:
        if op["op"] == "to_rows":
            wire = (wire[0][:5], wire[1][:5], wire[2][:5], wire[3][:5],
                    wire[4])
        rb.table_op_wire(json.dumps(op), *wire, device="cpu")
    return metrics.snapshot()["counters"].get("kernel.launches", 0)


@pytest.mark.parametrize("name", sorted(TAGGED))
def test_kernel_tag_predicts_the_ports_registry(name, tier_on):
    op = TAGGED[name]
    wire = _wire(300, 1)
    types, scales = ((wire[0][:5], wire[1][:5]) if op["op"] == "to_rows"
                     else (wire[0], wire[1]))
    rest = [(TYPES[:1], SCALES[:1], 15)] if op["op"] == "join" else []
    report = plancheck.analyze([op], **_args(plancheck, (types, scales), 300,
                                             rest))
    tag = report["ops"][0]["kernel"]
    assert (tag is not None) == (_launched(op, wire) == 1), (tag, name)


def test_an_empty_input_is_declined_by_the_ports_tier(tier_on):
    op = TAGGED["sort_one_key"]
    report = plancheck.analyze([op], **_args(plancheck, None, 0, []))
    assert report["ops"][0]["kernel"] is None
    assert _launched(op, _wire(0, 1)) == 0
    assert metrics.snapshot()["counters"].get("kernel.declines", 0) == 1
