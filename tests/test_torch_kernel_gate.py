"""The kernel tier's gate and counters in the port against the JAX
package's: ``SPARK_RAPIDS_TPU_KERNELS=on|off|auto`` (any other value
raises ``ValueError``), ``kernel.launches`` and ``kernel.declines``
counted as the JAX package counts them, and equal bytes from the port's
plans whatever the gate. On the CPU ``on`` runs the tier's plain
versions; ``auto`` keeps the tier for tables on a CUDA device, so here it
acts as ``off``, as the JAX package's ``auto`` does off a TPU.

The counters are compared op for op: where the JAX package fuses a run
of ops into one traced segment (filter, cast and a closing groupby), the
segment bypasses its tier, and the port, which has no plan fusion yet,
sends each op to the tier; that plan's expected counts are written out.
"""

import json

import numpy as np
import pytest

from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import metrics as jmetrics
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.kernels import registry
from spark_rapids_jni_tpu_torch.utils import config, metrics


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves the resident registries of both bridges as it found
    them: a table left behind would show in a later test's count."""
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


EDGES = [1023, 1024, 1025]
FACT_TYPES = [4, 4, 4, 3, 11]
FROM_ROWS = {"op": "from_rows", "type_ids": FACT_TYPES, "scales": [0] * 5}
PLANS = {
    # the join's build side has unique keys: hash_build_probe launches
    "query": [FROM_ROWS, {"op": "filter", "mask": 4},
              {"op": "join", "how": "inner", "on": [0]},
              {"op": "groupby", "by": [4],
               "aggs": [{"column": 3, "agg": a}
                        for a in ("sum", "count", "min", "max")]},
              {"op": "to_rows"}],
    # the sort's key leaves the groupby with a validity vector: declined
    "qty_by_date": [FROM_ROWS, {"op": "filter", "mask": 4},
                    {"op": "cast", "column": 3, "type_id": 4},
                    {"op": "groupby", "by": [2],
                     "aggs": [{"column": 3, "agg": "sum"}]},
                    {"op": "sort_by", "keys": [{"column": 0}]},
                    {"op": "to_rows"}],
    # a single non-null key: packed_sort launches
    "sort": [FROM_ROWS, {"op": "sort_by", "keys": [{"column": 2}]},
             {"op": "to_rows"}],
}


def _wires(n: int, seed: int):
    rng = np.random.default_rng(seed)
    item = (rng.zipf(1.3, n) % 300).astype(np.int64)
    rows = np.zeros((n, 32), np.uint8)
    for off, a in ((0, item), (8, rng.integers(0, 9999, n)),
                   (16, rng.integers(2_450_000, 2_450_090, n)),
                   (24, rng.integers(1, 101, n).astype(np.int32))):
        a = np.asarray(a)
        rows[:, off:off + a.itemsize] = a.view(np.uint8).reshape(n, a.itemsize)
    rows[:, 28] = rng.random(n) < 0.4
    rows[:, 29] = (1 | ((rng.random(n) > 0.03) << 1) | 4
                   | ((rng.random(n) > 0.03) << 3) | 16)
    offs = (np.arange(n + 1) * 32).astype(np.int32)
    fact = ([24], [5], [offs.tobytes() + rows.tobytes()], [None], n)
    sk = np.arange(300, dtype=np.int64)
    brand = rng.integers(1, 40, 300).astype(np.int32)
    item_t = ([4, 3], [0, 0], [sk.tobytes(), brand.tobytes()], [None] * 2, 300)
    return fact, item_t


def _run(mod, plan, fact, item, **kw):
    ids = [mod.table_upload_wire(*fact, **kw)]
    if any(op["op"] == "join" for op in plan):
        ids.append(mod.table_upload_wire(*item, **kw))
    out = mod.table_plan_resident(json.dumps(plan), ids)
    try:
        return tuple(mod.table_download_wire(out))
    finally:
        for t in ids + [out]:
            mod.table_free(t)


@pytest.fixture
def _flags():
    yield
    for c in (config, jconfig):
        c.clear_flag("KERNELS")
        c.clear_flag("METRICS")
    metrics.reset()
    jmetrics.reset()


# both packages fuse [filter, cast, groupby] past their tiers: from_rows
# and to_rows launched, packed_sort declined
FUSED_IN_JAX = {"qty_by_date": ({"kernel.launches": 2, "kernel.declines": 1},
                                {"kernel.launches": 2, "kernel.declines": 1})}


def _counters(m) -> dict:
    return {k: int(v) for k, v in m.counter_values(
        ["kernel.launches", "kernel.declines"]).items()}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("n", EDGES)
def test_gate_modes_give_equal_bytes_and_count_as_jax(n, plan, _flags):
    fact, item = _wires(n, n)
    ops = PLANS[plan]
    got, counts = {}, {}
    for mode in ("on", "off", "auto"):
        for c in (config, jconfig):
            c.set_flag("METRICS", "1")
            c.set_flag("KERNELS", mode)
        metrics.reset()
        jmetrics.reset()
        got[mode] = _run(rb, ops, fact, item, device="cpu")
        want = _run(jrb, ops, fact, item)
        assert got[mode] == want, mode
        counts[mode] = _counters(metrics)
        if mode == "on" and plan in FUSED_IN_JAX:
            assert (_counters(jmetrics), counts[mode]) == FUSED_IN_JAX[plan]
        else:
            assert counts[mode] == _counters(jmetrics), mode
    assert got["on"] == got["off"] == got["auto"]
    assert counts["off"] == counts["auto"] == {"kernel.launches": 0,
                                               "kernel.declines": 0}
    # from_rows, ..., to_rows (a fused groupby launches nothing)
    assert counts["on"]["kernel.launches"] >= (2 if plan in FUSED_IN_JAX
                                               else 3)


def test_on_runs_the_tier_and_off_does_not(_flags):
    """The gate reaches ``dispatch_kernel``: the same sort op through the
    tier with the gate on, and not at all with it off or on auto for CPU
    tensors; the row transpose runs either way."""
    fact, _ = _wires(64, 1)
    tid = rb.table_upload_wire(*fact, device="cpu")
    cols = rb.table_plan_resident(json.dumps([FROM_ROWS]), [tid])
    table = rb._resident_get(cols)
    op = {"op": "sort_by", "keys": [{"column": 2}]}
    config.set_flag("KERNELS", "on")
    assert registry.dispatch_kernel(op, table, (), "sort_by") is not None
    for mode in ("off", "auto"):
        config.set_flag("KERNELS", mode)
        assert registry.dispatch_kernel(op, table, (), "sort_by") is None
    rows_id = rb.table_plan_resident(json.dumps([{"op": "to_rows"}]), [cols])
    assert rows_id
    for t in (tid, cols, rows_id):
        rb.table_free(t)


@pytest.mark.parametrize("value", ["On", " off ", "AUTO"])
def test_flag_values_parse_like_jax(value, monkeypatch, _flags):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_KERNELS", value)
    config.clear_flag("KERNELS")
    jconfig.clear_flag("KERNELS")
    assert config.get_flag("KERNELS") == jconfig.get_flag("KERNELS")
    assert registry.tier_mode() == value.strip().lower()


@pytest.mark.parametrize("value", ["yes", "", "1", "pallas"])
def test_other_flag_values_raise(value, monkeypatch, _flags):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_KERNELS", value)
    config.clear_flag("KERNELS")
    jconfig.clear_flag("KERNELS")
    with pytest.raises(ValueError, match="on\\|off\\|auto"):
        jconfig.get_flag("KERNELS")
    with pytest.raises(ValueError, match="on\\|off\\|auto"):
        registry.tier_mode()
    with pytest.raises(ValueError, match="on\\|off\\|auto"):
        config.set_flag("KERNELS", value)


def test_counters_tick_only_with_metrics_on(_flags):
    metrics.counter_add("kernel.launches")
    assert metrics.snapshot()["counters"] == {}
    config.set_flag("METRICS", "1")
    metrics.counter_add("kernel.launches", 2)
    metrics.counter_add("kernel.declines")
    assert metrics.counter_values(["kernel.launches", "kernel.declines",
                                   "never"]) == {
        "kernel.launches": 2, "kernel.declines": 1, "never": 0}
    metrics.reset()
    snap = metrics.snapshot()
    assert set(snap) == {"counters", "bytes", "timers", "gauges",
                         "histograms", "span_self"}
    assert all(table == {} for table in snap.values())
    with pytest.raises(KeyError):
        config.set_flag("NOPE", 1)
