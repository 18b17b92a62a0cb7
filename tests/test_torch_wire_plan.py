"""The port's wire entries ``table_plan_wire`` and ``table_op_wire``
against the JAX package's, on the CPU: the same wire bytes in, the same
5-tuple out (type ids, scales, data bytes, validity bytes, rows).

The JAX entries pad a table to its shape bucket and the port runs exact
shapes; both give back the logical rows, so the tuples compare whole.
Inputs are made with numpy from a seed at the bucket edges 1023, 1024
and 1025 rows, with nulls. A plan the JAX package's ``check_plan``
refuses must raise ``PlanCheckError`` in the port with the same op index,
before any upload. Tolerance 0 throughout.
"""

import json

import numpy as np
import pytest

from spark_rapids_jni_tpu import plancheck as jplancheck
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu_torch import plancheck
from spark_rapids_jni_tpu_torch import runtime_bridge as rb

EDGES = [1023, 1024, 1025]
FACT_TYPES = [4, 4, 4, 3, 11]  # item_sk, customer_sk, sold_date_sk, quantity, keep
FROM_ROWS = {"op": "from_rows", "type_ids": FACT_TYPES, "scales": [0] * 5}
# "quantity sold a day": Spark widens SUM's INT32 input to LONG first
QTY_BY_DATE = [
    FROM_ROWS,
    {"op": "filter", "mask": 4},
    {"op": "cast", "column": 3, "type_id": 4},
    {"op": "groupby", "by": [2],
     "aggs": [{"column": 3, "agg": a} for a in ("sum", "count", "min", "max")]},
    {"op": "sort_by", "keys": [{"column": 0}]},
    {"op": "to_rows"},
]


def _fact_rows(n: int, seed: int) -> np.ndarray:
    """(n, 32) packed fact rows: ~3 % null customer_sk and quantity."""
    rng = np.random.default_rng(seed)
    item = (rng.zipf(1.3, n) % 500).astype(np.int64)
    cust = rng.integers(0, 10_000, n).astype(np.int64)
    date = rng.integers(2_450_816, 2_450_816 + 60, n).astype(np.int64)
    qty = rng.integers(1, 101, n).astype(np.int32)
    rows = np.zeros((n, 32), np.uint8)
    for off, a in ((0, item), (8, cust), (16, date), (24, qty)):
        rows[:, off:off + a.itemsize] = a.view(np.uint8).reshape(n, a.itemsize)
    rows[:, 28] = rng.random(n) < 0.5
    rows[:, 29] = (1 | ((rng.random(n) > 0.03) << 1) | 4
                   | ((rng.random(n) > 0.03) << 3) | 16)
    return rows


def _list_wire(rows: np.ndarray):
    n = rows.shape[0]
    offs = (np.arange(n + 1) * rows.shape[1]).astype(np.int32)
    return ([24], [5], [offs.tobytes() + rows.tobytes()], [None], n)


def _flat_wire(rows: np.ndarray):
    return ([5], [0], [rows.tobytes()], [None], rows.size)


def _columns_wire(n: int, seed: int):
    """A columnar table: INT64 with nulls, FLOAT64, INT32, BOOL8 mask,
    DECIMAL64."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 40, n).astype(np.int64)
    f = rng.standard_normal(n) * 100
    i = rng.integers(-1000, 1000, n).astype(np.int32)
    b = (rng.random(n) > 0.4).astype(np.uint8)
    d = rng.integers(-10**9, 10**9, n).astype(np.int64)
    valid = (rng.random(n) > 0.1).astype(np.uint8).tobytes()
    return ([4, 10, 3, 11, 26], [0, 0, 0, 0, -3],
            [k.tobytes(), f.tobytes(), i.tobytes(), b.tobytes(), d.tobytes()],
            [valid, None, valid, None, None], n)


def _both_plan(plan, wire):
    want = jrb.table_plan_wire(json.dumps(plan), *wire)
    got = rb.table_plan_wire(json.dumps(plan), *wire, device="cpu")
    return tuple(want), tuple(got)


@pytest.mark.parametrize("n", EDGES)
def test_plan_wire_matches_jax(n):
    want, got = _both_plan(QTY_BY_DATE, _list_wire(_fact_rows(n, n)))
    assert got == want
    assert got[0] == [24] and got[4] == 60


@pytest.mark.parametrize("layout", ["list", "flat"])
@pytest.mark.parametrize("n", EDGES)
def test_from_rows_wire_matches_jax(n, layout):
    """from_rows of a LIST<UINT8> row column and of a legacy flat UINT8
    buffer, alone and at the head of the plan."""
    rows = _fact_rows(n, n + 7)
    if layout == "list":
        wire, head = _list_wire(rows), FROM_ROWS
    else:
        wire, head = _flat_wire(rows), dict(FROM_ROWS, num_rows=n)
    for plan in ([head], [head] + QTY_BY_DATE[1:]):
        want, got = _both_plan(plan, wire)
        assert got == want
    op_want = jrb.table_op_wire(json.dumps(head), *wire)
    assert tuple(rb.table_op_wire(json.dumps(head), *wire,
                                  device="cpu")) == tuple(op_want)


OPS = {
    "cast_to_int64": {"op": "cast", "column": 2, "type_id": 4},
    "cast_float_to_int8": {"op": "cast", "column": 1, "type_id": 1},
    "cast_decimal_rescale": {"op": "cast", "column": 4, "type_id": 25,
                             "scale": -1},
    "filter": {"op": "filter", "mask": 3},
    "sort_by": {"op": "sort_by", "keys": [{"column": 2, "ascending": False}]},
    "groupby": {"op": "groupby", "by": [0],
                "aggs": [{"column": 2, "agg": "sum"},
                         {"column": 1, "agg": "max"}]},
    "to_rows": {"op": "to_rows"},
}


@pytest.mark.parametrize("name", sorted(OPS))
@pytest.mark.parametrize("n", EDGES)
def test_op_wire_matches_jax(n, name):
    wire = _columns_wire(n, n)
    op = json.dumps(OPS[name])
    want = jrb.table_op_wire(op, *wire)
    assert tuple(rb.table_op_wire(op, *wire, device="cpu")) == tuple(want)


REJECTED = {
    "unknown_op": [{"op": "nope"}],
    "mask_out_of_range": [FROM_ROWS, {"op": "filter", "mask": 7}],
    "mask_not_bool": [FROM_ROWS, {"op": "filter", "mask": 0}],
    "cast_scale_on_int": [FROM_ROWS, {"op": "cast", "column": 3,
                                      "type_id": 4, "scale": 2}],
    "cast_missing_type": [FROM_ROWS, {"op": "cast", "column": 3}],
    "unknown_agg": [FROM_ROWS, {"op": "groupby", "by": [0],
                                "aggs": [{"column": 3, "agg": "median"}]}],
    "join_one_table": [FROM_ROWS, {"op": "join", "on": [0]}],
    "from_rows_twice": [FROM_ROWS, FROM_ROWS],
    "from_rows_bad_type": [{"op": "from_rows", "type_ids": [23],
                            "scales": [0]}],
    "sort_key_range": QTY_BY_DATE[:5] + [{"op": "sort_by",
                                          "keys": [{"column": 5}]}],
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rejected_plan_raises_before_upload(case, monkeypatch):
    plan = REJECTED[case]
    wire = _list_wire(_fact_rows(64, 1))
    with pytest.raises(jplancheck.PlanCheckError) as jerr:
        jrb.table_plan_wire(json.dumps(plan), *wire)

    def no_upload(*a, **k):
        raise AssertionError("the plan was uploaded before its check")

    monkeypatch.setattr(rb, "_table_from_wire", no_upload)
    with pytest.raises(plancheck.PlanCheckError) as perr:
        rb.table_plan_wire(json.dumps(plan), *wire, device="cpu")
    assert (perr.value.index, perr.value.op_name) == (
        jerr.value.index, jerr.value.op_name)
    assert perr.value.reason == jerr.value.reason


def test_flat_rows_need_num_rows_and_match_the_buffer():
    rows = _fact_rows(10, 2)
    with pytest.raises(plancheck.PlanCheckError, match="num_rows"):
        rb.table_plan_wire(json.dumps([FROM_ROWS]), *_flat_wire(rows),
                           device="cpu")
    with pytest.raises(ValueError, match="not 11 rows"):
        rb.table_plan_wire(json.dumps([dict(FROM_ROWS, num_rows=11)]),
                           *_flat_wire(rows), device="cpu")


def test_unported_op_in_a_wire_plan_raises_typed():
    wire = _list_wire(_fact_rows(16, 3))
    # explode runs now: of a non-LIST column the plan check refuses it
    with pytest.raises(plancheck.PlanCheckError, match="LIST column"):
        rb.table_plan_wire(json.dumps([FROM_ROWS,
                                       {"op": "explode", "column": 0}]),
                           *wire, device="cpu")
    with pytest.raises(TypeError, match="JSON list"):
        rb.table_plan_wire(json.dumps(FROM_ROWS), *wire, device="cpu")
