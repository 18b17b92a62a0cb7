"""The port's shape-bucket plane (``utils/buckets.py``) against the JAX
package's, on the CPU: the policy and its parse errors, pad and unpad
(every buffer, padding included), the factories' entry points, the
``is_bucketable`` gate, and the ``bucket.*`` / ``compile_cache.*``
counters over one sequence of wire calls in both packages (the cases of
``tests/test_buckets.py`` ``TestPolicy``, ``TestPadUnpad`` and
``TestBucketMetrics``). Tolerance 0.
"""

import json

import numpy as np
import pytest

from spark_rapids_jni_tpu import bucketed as jbucketed
from spark_rapids_jni_tpu import factories as jfactories
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.utils import buckets as jbuckets
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import metrics as jmetrics
from spark_rapids_jni_tpu_torch import bucketed, factories, interop
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.utils import buckets
from spark_rapids_jni_tpu_torch.utils import config
from spark_rapids_jni_tpu_torch.utils import metrics

I64, B8 = 4, 11


@pytest.fixture(autouse=True)
def _clean():
    """Both registries unchanged; both packages' flags cleared."""
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    for c in (jconfig, config):
        c.clear_flag("BUCKETS")
        c.clear_flag("METRICS")
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


def _set(name, value):
    for c in (jconfig, config):
        c.set_flag(name, value)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

SPECS = ["", "16:4", "16:2:64", "8,64,512", "1024:2:2048", "3:3:100",
         "off", "0", "none", "false", "disabled"]
SIZES = [-5, 0, 1, 3, 5, 8, 9, 10, 16, 17, 64, 65, 100, 256, 513, 1023,
         1024, 1025, 2048, 2049, 3000, (1 << 23), (1 << 23) + 1]


@pytest.mark.parametrize("spec", SPECS)
def test_policy_matches_jax(spec):
    _set("BUCKETS", spec)
    assert buckets.enabled() == jbuckets.enabled()
    assert [buckets.bucket_for(n) for n in SIZES] == \
        [jbuckets.bucket_for(n) for n in SIZES]
    p, jp = buckets.policy(), jbuckets.policy()
    assert (p.enabled, p.floor, p.growth, p.cap, p.explicit) == \
        (jp.enabled, jp.floor, jp.growth, jp.cap, jp.explicit)
    assert p.buckets_upto(5000) == jp.buckets_upto(5000)


def test_default_ladder():
    assert buckets.enabled()
    assert [buckets.bucket_for(n) for n in (1, 1023, 1024, 1025)] == \
        [1024, 1024, 1024, 2048]
    assert buckets.bucket_for(0) is None and buckets.bucket_for(-5) is None
    assert buckets.bucket_for((1 << 23) + 1) is None


@pytest.mark.parametrize("spec", ["banana", "16:1", "0:2", "4:2:2",
                                  "1:2:3:4", ",", "-3,4"])
def test_invalid_spec_raises_loudly(spec):
    for mod, c in ((buckets, config), (jbuckets, jconfig)):
        c.set_flag("BUCKETS", spec)
        with pytest.raises(ValueError, match="SPARK_RAPIDS_TPU_BUCKETS"):
            mod.policy()


# ---------------------------------------------------------------------------
# pad / unpad / logical_rows
# ---------------------------------------------------------------------------


def _mixed_table(n: int):
    """(JAX table, port table): INT64 keys, INT64 values with nulls,
    STRING with nulls (the JAX test's table)."""
    rng = np.random.default_rng(n)
    k = rng.integers(0, 7, n, dtype=np.int64)
    v = rng.integers(-50, 50, n, dtype=np.int64)
    valid = rng.random(n) > 0.2
    strs = [f"s{int(x) % 5}" if valid[i] else None for i, x in enumerate(k)]
    jt = JTable([JColumn.from_numpy(k), JColumn.from_numpy(v, validity=valid),
                 JColumn.from_strings(strs)], ["k", "v", "s"])
    pt = Table([Column.from_numpy(k, device="cpu"),
                Column.from_numpy(v, validity=valid, device="cpu"),
                Column.from_strings(strs, device="cpu")], ["k", "v", "s"])
    return jt, pt


def _jbuffers(t) -> list:
    return [(np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths))
            for c in t.columns]


def _same_physical(jt, pt) -> None:
    """Every buffer of every column, padding rows included, and the
    logical count."""
    assert jt.logical_rows == pt.logical_rows
    assert jt.row_count == pt.row_count
    for (jd, jv, jl), (pd_, pv, pl, _, _) in zip(
            _jbuffers(jt), interop.table_to_buffers(pt)):
        assert jd.tobytes() == pd_.tobytes()
        for a, b in ((jv, pv), (jl, pl)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,target", [(10, 16), (10, 10), (1, 1024),
                                      (1023, 1024)])
def test_pad_round_trip_matches_jax(n, target):
    jt, pt = _mixed_table(n)
    jp, p = jbuckets.pad_table(jt, target), buckets.pad_table(pt, target)
    _same_physical(jp, p)
    assert p.row_count == target and p.logical_rows == n
    assert p.logical_row_count == n and p.is_padded
    # the tail: zero data, False validity, zero lengths
    assert not p.columns[1].validity[n:].any()
    assert not p.columns[2].lengths[n:].any()
    back = buckets.unpad_table(p)
    assert back.row_count == n and not back.is_padded
    _same_physical(jbuckets.unpad_table(jp), back)
    assert buckets.unpad_table(pt) is pt


def test_logical_rows_validation():
    c = Column.from_numpy(np.arange(4, dtype=np.int64), device="cpu")
    for bad in (5, -1):
        with pytest.raises(ValueError):
            Table([c], logical_rows=bad)
    assert Table([c], logical_rows=4).logical_row_count == 4


def test_pad_down_rejected():
    _, pt = _mixed_table(10)
    with pytest.raises(ValueError):
        buckets.pad_table(pt, 4)


def test_factories_entry_points():
    _set("BUCKETS", "16:2")
    jt, pt = _mixed_table(10)
    p = factories.pad_to_bucket(pt)
    _same_physical(jfactories.pad_to_bucket(jt), p)
    assert p.row_count == 16 and p.logical_rows == 10
    _same_physical(jfactories.unpad_table(jfactories.pad_to_bucket(jt)),
                   factories.unpad_table(p))
    _set("BUCKETS", "off")
    assert factories.pad_to_bucket(pt) is pt


def test_pad_to_bucket_passes_through_larger_padded():
    _set("BUCKETS", "16:2")
    _, pt = _mixed_table(10)
    big = buckets.pad_table(pt, 64)
    assert factories.pad_to_bucket(big) is big
    again = factories.pad_to_bucket(factories.pad_to_bucket(pt))
    assert again.row_count == 16 and again.logical_rows == 10


GATE_OPS = [
    {"op": "sort_by", "keys": []}, {"op": "join", "how": "semi"},
    {"op": "join"}, {"op": "join", "how": "full"}, {"op": "join", "how": "left"},
    {"op": "explode"}, {"op": "concat"}, {"op": "slice"}, {"op": "cast"},
    {"op": "filter"}, {"op": "rlike"}, {"op": "distinct"}, {"op": "to_rows"},
    {"op": "groupby", "by": [0], "aggs": [{"column": 1, "agg": "sum"}]},
    {"op": "groupby", "by": [0],
     "aggs": [{"column": 1, "agg": "collect_list"}]},
]


def test_is_bucketable_gate_matches_jax():
    assert [bucketed.is_bucketable(o) for o in GATE_OPS] == \
        [jbucketed.is_bucketable(o) for o in GATE_OPS]


def test_cache_key_matches_jax():
    jt, pt = _mixed_table(10)
    op = {"op": "sort_by", "keys": [{"column": 0}]}
    jp, p = jbuckets.pad_table(jt, 16), buckets.pad_table(pt, 16)
    assert buckets.cache_key("sort_by", op, (p,)) == \
        jbuckets.cache_key("sort_by", op, (jp,))
    assert buckets.cache_key("join.mat.left", {"on": [0]}, (p, pt),
                             extra=(32,)) == \
        jbuckets.cache_key("join.mat.left", {"on": [0]}, (jp, jt),
                           extra=(32,))


# ---------------------------------------------------------------------------
# metrics: the same call sequence counts the same in both packages
# ---------------------------------------------------------------------------


def _int_cols(n: int):
    rng = np.random.default_rng(n)
    k = rng.integers(0, 9, n, dtype=np.int64)
    v = rng.integers(-100, 100, n, dtype=np.int64)
    return k, v


def _sequence(mod, kw):
    """Wire ops at three sizes of two buckets and a resident join chain;
    returns the 5-tuples."""
    out = []
    for n in (1000, 1000, 1025):
        k, v = _int_cols(n)
        mask = (v > 0).astype(np.uint8)
        cols = ([I64, I64, B8], [0, 0, 0],
                [k.tobytes(), v.tobytes(), mask.tobytes()], [None] * 3, n)
        for op in ({"op": "sort_by", "keys": [{"column": 0}]},
                   {"op": "filter", "mask": 2},
                   {"op": "slice", "start": 2, "stop": 9},
                   {"op": "groupby", "by": [0],
                    "aggs": [{"column": 1, "agg": "sum"}]}):
            out.append(tuple(mod.table_op_wire(json.dumps(op), *cols, **kw)))
        ids = [mod.table_upload_wire(*cols, **kw) for _ in range(2)]
        try:
            for how in ("left", "semi"):
                r = mod.table_op_resident(
                    json.dumps({"op": "join", "how": how, "on": [0]}), ids)
                ids.append(r)
                out.append(tuple(mod.table_download_wire(r)))
        finally:
            for t in ids:
                mod.table_free(t)
    return out


COUNTED = ("compile_cache.hit", "compile_cache.miss", "bucket.pad_tables",
           "bucket.dispatched", "bucket.declined")


def test_pad_waste_and_cache_counters_match_jax():
    _set("METRICS", "1")
    _set("BUCKETS", "")
    snaps, outs = [], []
    for mod, met, bk, kw in ((jrb, jmetrics, jbuckets, {}),
                             (rb, metrics, buckets, {"device": "cpu"})):
        met.reset()
        bk.cache_clear()
        outs.append(_sequence(mod, kw))
        snaps.append(met.snapshot())
    assert outs[0] == outs[1]
    jc, pc = snaps[0]["counters"], snaps[1]["counters"]
    assert {k: pc.get(k) for k in COUNTED} == {k: jc.get(k) for k in COUNTED}
    assert pc["compile_cache.hit"] > 0 and pc["compile_cache.miss"] > 0
    assert snaps[1]["bytes"]["bucket.pad_waste_bytes"] == \
        snaps[0]["bytes"]["bucket.pad_waste_bytes"]
    for h in ("bucket.size", "bucket.pad_rows"):
        assert snaps[1]["histograms"][h]["count"] == \
            snaps[0]["histograms"][h]["count"]
        assert snaps[1]["histograms"][h]["sum"] == \
            snaps[0]["histograms"][h]["sum"]
    assert snaps[1]["gauges"]["compile_cache.size"]["value"] == \
        snaps[0]["gauges"]["compile_cache.size"]["value"]


def test_cache_stats_and_clear():
    _set("BUCKETS", "")
    buckets.cache_clear()
    k, v = _int_cols(1000)
    rb.table_op_wire(json.dumps({"op": "cast", "column": 0, "type_id": 3}),
                     [I64, I64], [0, 0], [k.tobytes(), v.tobytes()],
                     [None, None], 1000, device="cpu")
    assert buckets.cache_stats() == {"size": 1, "capacity": 256}
    buckets.cache_clear()
    assert buckets.cache_stats()["size"] == 0


def test_cache_is_an_lru_of_256():
    buckets.cache_clear()
    built = []
    for i in range(buckets.CACHE_CAPACITY + 3):
        buckets.cached_jit(("k", i), lambda: (lambda: built.append(1)), "f")
    assert buckets.cache_stats()["size"] == buckets.CACHE_CAPACITY
    # the three oldest keys went: key 1 is built again, key 5 is kept
    fn = buckets.cached_jit(("k", 1), lambda: (lambda: None), "srt_x")
    assert fn.__name__ == "srt_x"
    kept = buckets.cached_jit(("k", 5), lambda: None, "unused")
    assert kept.__name__ == "f"
    buckets.cache_clear()
