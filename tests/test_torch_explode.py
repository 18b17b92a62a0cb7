"""LIST explode and the list accessors, the ``explode`` and ``rlike``
dispatch ops through the wire entries, and their plan-check rules: the
port against the JAX package on the CPU.

Inputs are numpy-seeded LIST<INT32> columns with null and empty lists
beside STRING and INT64 siblings. Tolerance 0: data bytes, validity,
lengths, names and row counts equal; the plan check accepts and refuses
the same plans with the same reason.
"""

import json

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import plancheck as jplancheck
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import lists as jlists
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import plancheck
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.ops import lists

from test_torch_strings_cast import _same
from test_torch_strings_keys import make_wire


def _lists(n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        out.append(None if r < 0.1 else
                   [] if r < 0.2 else
                   rng.integers(-9, 9, int(rng.integers(1, 5))).tolist())
    return out


def _tables(n: int, seed: int, names):
    """(JAX table, port table) of (s STRING, l LIST<INT32>, v INT64)."""
    rng = np.random.default_rng(seed + 1)
    words = ["", "x", "brand #7", "東京", None]
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    vals = rng.integers(0, 100, n).astype(np.int64)
    lst = _lists(n, seed)
    jl = JColumn.from_list_of_lists(lst, jdt.INT32)
    pl = Column(_torch(jl.data), dt.LIST,
                None if jl.validity is None else _torch(jl.validity),
                _torch(jl.lengths))
    jt = JTable([JColumn.from_strings(strs), jl, JColumn.from_numpy(vals)],
                names)
    pt = Table([Column.from_strings(strs, device="cpu"), pl,
                Column.from_numpy(vals, device="cpu")], names)
    return jt, pt


def _torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _same_table(j: JTable, p: Table):
    assert (None if j.names is None else tuple(j.names)) == p.names
    assert j.num_columns == p.num_columns
    for jc, pc in zip(j.columns, p.columns):
        _same(jc, pc)


@pytest.mark.parametrize("fn", ["explode", "explode_outer",
                                "explode_position", "explode_position_outer"])
@pytest.mark.parametrize("names", [None, ("s", "l", "v")],
                         ids=["unnamed", "named"])
@pytest.mark.parametrize("n", [1, 1023, 1025])
def test_explode_family_matches_jax(fn, names, n):
    jt, pt = _tables(n, n, names)
    if fn == "explode_position_outer":
        want = jlists.explode_position(jt, 1, outer=True)
        got = lists.explode_position(pt, 1, outer=True)
    else:
        want, got = getattr(jlists, fn)(jt, 1), getattr(lists, fn)(pt, 1)
    _same_table(want, got)


@pytest.mark.parametrize("index", [0, 2, -1, -3, 7])
def test_list_accessors_match_jax(index):
    jt, pt = _tables(300, 5, None)
    jl, pl = jt.columns[1], pt.columns[1]
    _same(jlists.extract_list_element(jl, index),
          lists.extract_list_element(pl, index))
    _same(jlists.list_contains(jl, index), lists.list_contains(pl, index))
    _same(jlists.count_elements(jl), lists.count_elements(pl))


@pytest.mark.parametrize("n", [1023, 1024, 1025])
def test_explode_plans_match_jax(n):
    """``[groupby collect_list, explode]`` and an explode of a wire LIST
    column, through ``table_plan_wire``."""
    wire = make_wire(n, n)
    plan = json.dumps([
        {"op": "groupby", "by": [0], "aggs": [{"column": 2,
                                               "agg": "collect_list"}]},
        {"op": "explode", "column": 1},
        {"op": "sort_by", "keys": [{"column": 0}, {"column": 1}]}])
    want = jrb.table_plan_wire(plan, *wire)
    assert tuple(rb.table_plan_wire(plan, *wire, device="cpu")) == tuple(want)
    jt, _ = _tables(n, n + 3, None)
    wt = jrb._table_to_wire(jt)
    plan = json.dumps([{"op": "explode", "column": 1}])
    want = jrb.table_plan_wire(plan, *wt)
    assert tuple(rb.table_plan_wire(plan, *wt, device="cpu")) == tuple(want)


STRING_LIST = [(23, 0), (24, 3), (4, 0)]
CHECKED = {
    "rlike_ok": [{"op": "rlike", "column": 0, "pattern": "^a+$"}],
    "rlike_not_string": [{"op": "rlike", "column": 2, "pattern": "a"}],
    "rlike_no_pattern": [{"op": "rlike", "column": 0}],
    "rlike_bad_pattern_type": [{"op": "rlike", "column": 0, "pattern": 3}],
    "rlike_out_of_range": [{"op": "rlike", "column": 5, "pattern": "a"}],
    "explode_ok": [{"op": "explode", "column": 1},
                   {"op": "cast", "column": 1, "type_id": 23}],
    "explode_not_list": [{"op": "explode", "column": 0}],
    "explode_no_column": [{"op": "explode"}],
    "explode_then_to_rows": [{"op": "explode", "column": 1},
                             {"op": "to_rows"}],
    "string_to_rows": [{"op": "to_rows"}],
    "groupby_string_value": [{"op": "groupby", "by": [2], "aggs": [
        {"column": 0, "agg": "max"}]}],
    "groupby_string_count": [{"op": "groupby", "by": [0], "aggs": [
        {"column": 0, "agg": "count"}]}],
    "cast_string_to_timestamp": [{"op": "cast", "column": 0, "type_id": 15}],
}


@pytest.mark.parametrize("name", sorted(CHECKED))
def test_plancheck_matches_jax(name):
    tids, scales = zip(*STRING_LIST)
    kw = {"rows": 100}
    js = jplancheck.schema_from_wire(tids, scales)
    ps = plancheck.schema_from_wire(tids, scales)
    try:
        want = jplancheck.check_plan(CHECKED[name], schema=js, **kw)
    except jplancheck.PlanCheckError as e:
        with pytest.raises(plancheck.PlanCheckError) as got:
            plancheck.check_plan(CHECKED[name], schema=ps, **kw)
        assert (got.value.index, got.value.op_name, got.value.reason) == (
            e.index, e.op_name, e.reason)
        return
    got = plancheck.check_plan(CHECKED[name], schema=ps, **kw)
    assert [[(c.id.value, c.scale, c.child) for c in e["out_schema"]]
            for e in got["ops"]] == [
        [(c["type_id"], c["scale"], c["child"]) for c in e["out_schema"]]
        for e in want["ops"]]
    assert got["rows_out_bound"] == want["rows_out_bound"]


# ---------------------------------------------------------------------------
# split_explode (Spark explode(split(col, d))) against the JAX package
# ---------------------------------------------------------------------------

SPLIT_EDGES = ["a,b,c", "", None, "x,,y", ",", ",lead", "trail,", ",,",
               "one", "é,日本,", "\udcff,\udcfe", "a" * 17]


def _split_tables(names):
    from test_torch_strings_lib import VALUES

    vals = SPLIT_EDGES + VALUES
    keys = np.arange(len(vals), dtype=np.int64)
    valid = np.arange(len(vals)) % 5 != 3
    j = JTable([JColumn.from_numpy(keys, validity=valid),
                JColumn.from_strings(vals, pad_width=17)], names)
    p = Table([Column.from_numpy(keys, valid, device="cpu"),
               Column.from_strings(vals, pad_width=17, device="cpu")], names)
    return j, p


@pytest.mark.parametrize("delim", [",", "a", "\x00"])
@pytest.mark.parametrize("names", [None, ("k", "s")], ids=["unnamed", "named"])
def test_split_explode_matches_jax(delim, names):
    from spark_rapids_jni_tpu.ops import split_explode as jsplit_explode
    from spark_rapids_jni_tpu_torch.ops import split_explode

    j, p = _split_tables(names)
    _same_table(jsplit_explode(j, 1, delim), split_explode(p, 1, delim))


def test_split_explode_raises_as_jax():
    from spark_rapids_jni_tpu.ops import split_explode as jsplit_explode
    from spark_rapids_jni_tpu_torch.ops import split_explode

    j, p = _split_tables(("k", "s"))
    for fn, t in ((jsplit_explode, j), (split_explode, p)):
        with pytest.raises(ValueError, match="single-byte"):
            fn(t, "s", "--")
        with pytest.raises(TypeError):
            fn(t, "k", ",")
