"""Fused plan segments (``plan.run_plan`` by ``segment_plan``): the port
against the JAX package on the CPU.

The chains are the JAX package's ``tests/test_plan.py`` ``CHAINS`` over
its shared table (int64 key, nullable int64 value, BOOL8 mask, STRING)
at 1,023/1,024/1,025 rows, through both packages' ``table_plan_wire``:
the same 5-tuples and the same ``plan.*`` counters, with the ladder at
its default and off (every op an exact segment). Also: the JAX
package's fused-count pin, a fused body that raises (replayed op by op),
the negative ``slice`` that stays exact and the huge ``stop`` that stays
fused, an op error from the exact path, a resident plan against its
wire plan, an injected out-of-memory on ``[cast, filter]`` (chunked,
same bytes), a donated fused segment (frees its input and nothing in
``rest``), ``predict_segments`` against ``segment_plan``, and the host
reads of a fused segment (one, its count). Tolerance 0.
"""

import json

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import plan as jplan
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import faults as jfaults
from spark_rapids_jni_tpu.utils import metrics as jmetrics
from spark_rapids_jni_tpu_torch import bucketed
from spark_rapids_jni_tpu_torch import plan as plan_mod
from spark_rapids_jni_tpu_torch import plancheck
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.utils import buckets, config, faults, hbm
from spark_rapids_jni_tpu_torch.utils import metrics, spill

I64, F64, I32, B8, STR = 4, 10, 3, 11, 23
EDGES = (1023, 1024, 1025)
# the JAX package's tests/test_plan.py CHAINS
CHAINS = {
    "filter_cast_sort_groupby": [
        {"op": "filter", "mask": 2},
        {"op": "cast", "column": 1, "type_id": F64},
        {"op": "sort_by", "keys": [{"column": 0}]},
        {"op": "groupby", "by": [0],
         "aggs": [{"column": 1, "agg": "sum"},
                  {"column": 1, "agg": "count"}]},
    ],
    "rlike_cast_sort": [
        {"op": "rlike", "column": 3, "pattern": "w[0-2]o"},
        {"op": "cast", "column": 1, "type_id": F64},
        {"op": "sort_by", "keys": [{"column": 0}]},
    ],
    "distinct_sort_slice": [
        {"op": "distinct", "keys": [0, 1]},
        {"op": "sort_by",
         "keys": [{"column": 0}, {"column": 1, "ascending": False}]},
        {"op": "slice", "start": 3, "stop": 77},
    ],
    "cast_cast_sort_distinct_groupby": [
        {"op": "cast", "column": 1, "type_id": F64},
        {"op": "cast", "column": 0, "type_id": I32},
        {"op": "sort_by", "keys": [{"column": 1}]},
        {"op": "distinct", "keys": [0]},
        {"op": "groupby", "by": [0],
         "aggs": [{"column": 1, "agg": "max"}]},
    ],
    "slice_filter_sort": [
        {"op": "slice", "start": 0, "stop": 999_999},
        {"op": "filter", "mask": 2},
        {"op": "sort_by", "keys": [{"column": 1}, {"column": 0}]},
    ],
}
# the wire plans of the chip cells with a fused segment, and boundaries
OTHER_PLANS = [
    [{"op": "from_rows", "type_ids": [4, 4, 4, 3, 11], "scales": [0] * 5},
     {"op": "filter", "mask": 4}, {"op": "cast", "column": 3, "type_id": 4},
     {"op": "groupby", "by": [2], "aggs": [{"column": 3, "agg": "sum"}]},
     {"op": "sort_by", "keys": [{"column": 0}]}, {"op": "to_rows"}],
    [{"op": "rlike", "column": 3, "pattern": "x"},
     {"op": "groupby", "by": [0], "aggs": [{"column": 1,
                                             "agg": "collect_list"}]},
     {"op": "slice", "start": -1}, {"op": "cast", "column": 0,
                                     "type_id": F64}],
    [{"op": "groupby", "by": [0], "aggs": [{"column": 1, "agg": "sum"}]},
     {"op": "groupby", "by": [0], "aggs": [{"column": 1, "agg": "sum"}]}],
    [], [{"op": "join", "on": [0]}], [{"op": "cast", "column": 0,
                                       "type_id": F64}] * 4,
]
COUNTERS = ["plan.calls", "plan.segments", "plan.fused_segments",
            "plan.fused_ops", "plan.exact_ops", "plan.fallbacks",
            "plan.declined", "plan.chunked_segments"]


@pytest.fixture(autouse=True)
def _clean():
    """Both registries unchanged; both packages' flags cleared."""
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    for c in (jconfig, config):
        for f in ("BUCKETS", "METRICS", "FAULTS", "RETRY_BASE_MS", "KERNELS"):
            c.clear_flag(f)
    metrics.reset()
    jmetrics.reset()
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


def _both(name, value):
    for c in (jconfig, config):
        c.set_flag(name, value)


def _string_wire(strings):
    payload = b"".join(s.encode() for s in strings)
    offs = np.zeros(len(strings) + 1, np.int32)
    np.cumsum([len(s.encode()) for s in strings], out=offs[1:])
    return offs.tobytes() + payload


def _wire(n: int):
    """The JAX test's shared table as a wire tuple."""
    rng = np.random.default_rng(n)
    k = rng.integers(0, 9, n, dtype=np.int64)
    v = rng.integers(-100, 100, n, dtype=np.int64)
    valid = (np.arange(n) % 7 != 0).astype(np.uint8)
    mask = (v > 0).astype(np.uint8)
    strs = [f"w{int(x) % 5}ord" for x in k]
    return ([I64, I64, B8, STR], [0] * 4,
            [k.tobytes(), v.tobytes(), mask.tobytes(), _string_wire(strs)],
            [None, valid.tobytes(), None, None], n)


def _jax(ops, wire):
    return tuple(jrb.table_plan_wire(json.dumps(ops), *wire))


def _port(ops, wire):
    return tuple(rb.table_plan_wire(json.dumps(ops), *wire, device="cpu"))


def _counts(m) -> dict:
    return m.counter_values(COUNTERS)


_JAX_RUNS: dict = {}


def _jax_default(chain: str, n: int):
    """The JAX package's 5-tuple and ``plan.*`` counters of a chain under
    the default ladder (one run a chain and size: bucketing changes
    shapes, never results, so it is the reference under ``off`` too)."""
    if (chain, n) not in _JAX_RUNS:
        jconfig.set_flag("METRICS", "1")
        jconfig.clear_flag("BUCKETS")
        jmetrics.reset()
        got = _jax(CHAINS[chain], _wire(n))
        _JAX_RUNS[chain, n] = got, _counts(jmetrics)
    return _JAX_RUNS[chain, n]


@pytest.mark.parametrize("ladder", ["", "off"], ids=["default", "off"])
@pytest.mark.parametrize("n", EDGES)
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chain_matches_jax(chain, n, ladder):
    """The JAX bytes under both ladders; under the default the JAX
    package's ``plan.*`` counters, under ``off`` one exact segment an
    op (as the JAX package's ``run_plan`` runs it)."""
    want, jcounts = _jax_default(chain, n)
    ops = CHAINS[chain]
    config.set_flag("METRICS", "1")
    config.set_flag("BUCKETS", ladder)
    metrics.reset()
    assert _port(ops, _wire(n)) == want
    got = _counts(metrics)
    if ladder == "off":
        assert got == dict(jcounts, **{
            "plan.segments": len(ops), "plan.fused_segments": 0,
            "plan.fused_ops": 0, "plan.exact_ops": len(ops)})
    else:
        assert got == jcounts
        assert got["plan.fused_segments"] == 1
        assert got["plan.fallbacks"] == got["plan.declined"] == 0


def test_fused_actually_fused():
    """The JAX package's pin: the 4-op chain is one fused segment."""
    config.set_flag("METRICS", "1")
    metrics.reset()
    _port(CHAINS["filter_cast_sort_groupby"], _wire(1024))
    c = _counts(metrics)
    assert (c["plan.segments"], c["plan.fused_segments"],
            c["plan.fused_ops"], c["plan.fallbacks"],
            c["plan.exact_ops"]) == (1, 1, 4, 0, 0)


def test_fused_failure_replays_per_op(monkeypatch):
    def boom(op, t, n, rv):
        raise RuntimeError("injected fused failure")

    ops, wire = CHAINS["filter_cast_sort_groupby"], _wire(1024)
    want = _jax(ops, wire)
    config.set_flag("METRICS", "1")
    monkeypatch.setattr(plan_mod, "_FUSED", dict(plan_mod._FUSED, cast=boom))
    metrics.reset()
    assert _port(ops, wire) == want
    c = _counts(metrics)
    assert (c["plan.fallbacks"], c["plan.exact_ops"],
            c["plan.fused_segments"]) == (1, 4, 0)


@pytest.mark.parametrize("stop", [2 ** 31, 2 ** 40],
                         ids=["huge_stop", "past_the_count"])
def test_huge_slice_bound_stays_fused(stop):
    """A valid stop past int32 is clamped, not overflowed: the segment
    stays fused and gives the JAX bytes."""
    ops = [{"op": "cast", "column": 1, "type_id": F64},
           {"op": "slice", "start": 1 if stop == 2 ** 31 else 1000,
            "stop": stop}]
    _both("METRICS", "1")
    metrics.reset()
    jmetrics.reset()
    wire = _wire(1024)
    got = _port(ops, wire)
    assert got == _jax(ops, wire)
    assert got[4] == (1023 if stop == 2 ** 31 else 24)
    c = _counts(metrics)
    assert c == _counts(jmetrics)
    assert (c["plan.fused_segments"], c["plan.fallbacks"]) == (1, 0)


def test_negative_slice_stays_exact():
    """A negative bound is not fusable: its error comes from the exact
    path (and the port's plan check refuses it first)."""
    ops = [{"op": "sort_by", "keys": [{"column": 0}]},
           {"op": "slice", "start": -5}]
    assert plan_mod.segment_plan(ops) == [("exact", ops[:1]),
                                          ("exact", ops[1:])]
    t = rb._table_from_wire(*_wire(1024), torch.device("cpu"), 1024)
    with pytest.raises(ValueError, match="negative"):
        plan_mod.run_plan(ops, t)
    with pytest.raises(ValueError, match="negative bounds"):
        _port(ops, _wire(1024))


def test_op_error_surfaces_from_the_exact_path():
    bad = [{"op": "cast", "column": 1, "type_id": F64},
           {"op": "sort_by", "keys": [{"column": 0}]},
           {"op": "unknown_op"}]
    t = rb._table_from_wire(*_wire(1024), torch.device("cpu"), 1024)
    with pytest.raises(ValueError, match="unknown table op"):
        plan_mod.run_plan(bad, t)
    with pytest.raises(ValueError, match="plancheck"):
        _port(bad, _wire(1024))


def test_resident_plan_matches_wire_plan():
    ops, wire = CHAINS["filter_cast_sort_groupby"], _wire(1025)
    tid = rb.table_upload_wire(*wire, device="cpu")
    try:
        out = rb.table_plan_resident(json.dumps(ops), [tid])
        try:
            assert tuple(rb.table_download_wire(out)) == _port(ops, wire)
        finally:
            rb.table_free(out)
    finally:
        rb.table_free(tid)


@pytest.mark.parametrize("n", EDGES)
def test_oom_on_a_fused_segment_runs_chunked(n):
    ops = [{"op": "cast", "column": 1, "type_id": F64},
           {"op": "filter", "mask": 2}]
    wire = _wire(n)
    _both("METRICS", "1")
    _both("RETRY_BASE_MS", "1")
    want = _jax(ops, wire)
    metrics.reset()
    jmetrics.reset()
    _both("FAULTS", "seed=3,dispatch:oom:1:1")
    assert _jax(ops, wire) == want
    assert _port(ops, wire) == want
    assert faults.injection_stats() == {
        "dispatch:oom": {"calls": 1, "injected": 1}}
    c, j = _counts(metrics), _counts(jmetrics)
    assert (c["plan.chunked_segments"], c["plan.fused_segments"],
            c["plan.fallbacks"], c["plan.exact_ops"]) == (1, 1, 0, 0)
    # the JAX package's concatenate raises on the halves, which the
    # filter left unnamed, and it replays the segment op by op (ROADMAP
    # Queue 3, "its concatenate raises on unnamed tables"), two more
    # dispatch calls
    assert jfaults.injection_stats()["dispatch:oom"]["calls"] == 3
    assert (j["plan.chunked_segments"], j["plan.fused_segments"],
            j["plan.fallbacks"], j["plan.exact_ops"]) == (1, 0, 1, 2)


def _table(n, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 9, n).astype(np.int64)
    v = rng.integers(-50, 50, n).astype(np.int64)
    return Table([Column.from_numpy(k, device="cpu"),
                  Column.from_numpy(v, device="cpu"),
                  Column.from_numpy(v > 0, device="cpu")], ["k", "v", "m"])


@pytest.mark.parametrize("donate", [True, False])
def test_donated_fused_segment_frees_its_input_only(donate, monkeypatch):
    """The donated input of a fused first segment is released once the
    segment returns (counted as a donation); a ``rest`` table and an
    undonated input never are."""
    freed, donations = [], []
    monkeypatch.setattr(spill, "free_storage",
                        lambda t: freed.append(spill.storage_key(t)))
    hbm.register_donation_listener(donations.append)
    try:
        t, extra = _table(1024, 1), _table(1000, 2)
        extra = Table(extra.columns[:2])  # the filter drops the mask
        ops = [{"op": "filter", "mask": 2},
               {"op": "sort_by", "keys": [{"column": 0}]},
               {"op": "concat"}]
        out = plan_mod.run_plan(ops, t, [extra], donate_input=donate)
    finally:
        hbm._DONATION_LISTENERS.remove(donations.append)
    assert int(out.logical_row_count) == int((t.columns[2].data).sum()) + 1000
    mine = plan_mod._storages([t])
    assert not set(freed) & plan_mod._storages([extra, out])
    if donate:
        assert mine <= set(freed) and donations[0] == sum(
            x.untyped_storage().nbytes() for x in (c.data for c in t.columns))
    else:
        assert not set(freed) & mine


def test_predict_segments_equals_segment_plan():
    for ops in list(CHAINS.values()) + OTHER_PLANS:
        want = plan_mod.segment_plan(ops)
        got = plancheck.predict_segments(ops)
        assert [(k, [ops[i] for i in idx]) for k, idx in got] == want
        assert want == jplan.segment_plan(ops)


@pytest.mark.parametrize("chain", ["filter_cast_sort_groupby",
                                   "distinct_sort_slice"])
def test_fused_segment_reads_the_host_once(chain, monkeypatch):
    """Every host read a torch op can make on a CPU tensor (``item``,
    ``tolist``, ``int``/``bool``/``float`` of a tensor, ``nonzero``) is
    counted while a fused segment runs: one, its count."""
    t = bucketed._padded_input(rb._table_from_wire(
        *_wire(1000), torch.device("cpu"), 1024))
    reads = []

    def counting(name, fn):
        def wrapped(*a, **k):
            reads.append(name)
            return fn(*a, **k)
        return wrapped

    for name in ("item", "tolist", "__int__", "__bool__", "__float__",
                 "__index__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", counting("nonzero", torch.nonzero))
    out = plan_mod._run_fused(CHAINS[chain], t)
    monkeypatch.undo()
    assert reads == ["__int__"]
    assert out.logical_rows is not None
