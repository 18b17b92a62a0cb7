"""The port's spill tier (``utils/spill.py``) and the registry's
``table_reclaim``/``resident_table_count``, against the JAX package's,
on the CPU.

Round trips through the host and the disk tier are exact at
1023/1024/1025 rows with nulls, STRING, DECIMAL128 and LIST columns, and
equal the JAX package's downloads; the same uploads, touches and
headroom requests evict the same tables in the same order in both
packages; pins, pipelined readers and active downloads beat eviction;
freeing or reclaiming a spilled table releases its backing; the plan's
first out-of-memory rung spills and retries; chaos at the ``spill`` site
is survived. The card's round trip is in
``tests/test_torch_services_cuda.py``.
"""

import glob
import json
import threading
import time

import numpy as np
import pytest

from spark_rapids_jni_tpu import pipeline as jpipeline
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import spill as jspill
from spark_rapids_jni_tpu_torch import pipeline
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.utils import config, hbm, metrics, spill

EDGES = (1023, 1024, 1025)
# ~20 KiB usable budget: a handful of KiB-scale tables overflows it
TINY_BUDGET_GB = 3e-5
FLAGS = ("SPILL", "SPILL_DIR", "HOST_SPILL_BUDGET_GB", "HBM_BUDGET_GB",
         "METRICS", "FAULTS", "RETRY_MAX", "RETRY_BASE_MS", "BUCKETS",
         "PIPELINE")
WAIT_S = 120


def _bounded(fn, timeout=WAIT_S):
    """Run ``fn`` on a helper thread and wait at most ``timeout``."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # handed to the caller below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} did not finish in {timeout} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


@pytest.fixture(autouse=True)
def _isolation():
    """Both packages' service flags cleared, both pools drained and torn
    down, no spill file left and both registries as they were (F6)."""
    before = (jrb.resident_table_count(), rb.resident_table_count())
    yield
    try:
        for cfg, pipe in ((jconfig, jpipeline), (config, pipeline)):
            _bounded(pipe.drain)
            for name in FLAGS:
                if name in cfg._FLAGS:
                    cfg.clear_flag(name)
            pipe.depth()  # the flag is off: the pool goes
            _bounded(pipe.drain_io)
        assert (spill.spill_file_count(), jspill.spill_file_count()) == (0, 0)
        assert (jrb.resident_table_count(),
                rb.resident_table_count()) == before
    finally:
        spill.reset()
        jspill.reset()


def _both(name, value):
    jconfig.set_flag(name, value)
    config.set_flag(name, value)


def _wire(n: int, seed: int = 0):
    rng = np.random.default_rng(n + seed)
    k = rng.integers(-1000, 1000, n, dtype=np.int64)
    mask = (k % 2 == 0).astype(np.uint8)
    return ([4, 11], [0, 0], [k.tobytes(), mask.tobytes()], [None, None], n)


def _mixed_wire(n: int, seed: int):
    """INT64 (nulls), STRING (nulls), DECIMAL128 (nulls), LIST<INT32>,
    FLOAT64."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-9, 9, n).astype(np.int64)
    kv = (rng.random(n) > 0.2).astype(np.uint8).tobytes()
    strs = [("x" * int(i % 5) + str(i)).encode()
            for i in rng.integers(0, 99, n)]
    offs = np.zeros(n + 1, np.int32)
    np.cumsum([len(s) for s in strs], out=offs[1:])
    sv = (rng.random(n) > 0.1).astype(np.uint8).tobytes()
    d = rng.integers(-2**62, 2**62, (n, 2)).astype(np.int64)
    lens = rng.integers(0, 5, n).astype(np.int32)
    loffs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=loffs[1:])
    child = rng.integers(-99, 99, int(loffs[-1])).astype(np.int32)
    f = rng.standard_normal(n)
    return ([4, 23, 27, 24, 10], [0, 0, -4, 3, 0],
            [k.tobytes(), offs.tobytes() + b"".join(strs), d.tobytes(),
             loffs.tobytes() + child.tobytes(), f.tobytes()],
            [kv, sv, kv, None, None], n)


def _norm(w):
    t, s, d, v, n = w
    return (list(t), list(s), [None if x is None else bytes(x) for x in d],
            [None if x is None else bytes(x) for x in v], int(n))


def _up(w):
    return rb.table_upload_wire(*w, device="cpu")


def _down(tid):
    return _norm(rb.table_download_wire(tid))


def _free_all(ids):
    for t in ids:
        rb.table_free(t)


def _jax_downloads(wires):
    ids = [jrb.table_upload_wire(*w) for w in wires]
    try:
        return [_norm(jrb.table_download_wire(t)) for t in ids]
    finally:
        for t in ids:
            jrb.table_free(t)


def _spilled(tid) -> bool:
    with rb._RESIDENT_LOCK:
        return isinstance(rb._RESIDENT[tid], spill.SpilledTable)


# ---------------------------------------------------------------------------
# round trips through both tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", EDGES)
def test_host_tier_round_trip_equals_jax(n):
    """A working set past a tiny budget: uploads spill, downloads
    repage, and the bytes equal the JAX package's downloads."""
    wires = [_mixed_wire(n, s) for s in range(4)]
    want = _jax_downloads(wires)
    config.set_flag("METRICS", "1")
    metrics.reset()
    config.set_flag("SPILL", "on")
    config.set_flag("HBM_BUDGET_GB", TINY_BUDGET_GB)
    ids = [_up(w) for w in wires]
    assert spill.stats_doc()["host_bytes"] > 0, "nothing spilled"
    assert [_down(t) for t in ids] == want
    snap = metrics.snapshot()
    assert snap["counters"]["spill.evictions"] > 0
    assert snap["counters"]["spill.repages"] > 0
    assert snap["bytes"]["spill.bytes_out"] > 0
    assert snap["bytes"]["spill.bytes_in"] > 0
    _free_all(ids)
    doc = spill.stats_doc()
    assert doc["host_bytes"] == 0 and doc["disk_bytes"] == 0


@pytest.mark.parametrize("n", EDGES)
def test_disk_tier_round_trip_equals_jax(n, tmp_path):
    """HOST_SPILL_BUDGET_GB=0 sends every eviction to disk: the files
    exist while spilled, go on repage, and the bytes equal JAX's."""
    wires = [_mixed_wire(n, 10 + s) for s in range(4)]
    want = _jax_downloads(wires)
    config.set_flag("SPILL", "on")
    config.set_flag("HBM_BUDGET_GB", TINY_BUDGET_GB)
    config.set_flag("HOST_SPILL_BUDGET_GB", 0)
    config.set_flag("SPILL_DIR", str(tmp_path))
    ids = [_up(w) for w in wires]
    doc = spill.stats_doc()
    assert doc["disk_bytes"] > 0 and doc["files"] > 0
    _bounded(pipeline.drain_io)
    assert glob.glob(str(tmp_path / "*.npz"))
    assert [_down(t) for t in ids] == want
    _free_all(ids)
    assert glob.glob(str(tmp_path / "*.npz")) == []


def test_plan_over_spilled_input_repages():
    chain = [{"op": "filter", "mask": 1},
             {"op": "sort_by", "keys": [{"column": 0}]}]
    tid = _up(_wire(1023))
    res = rb.table_plan_resident(json.dumps(chain), [tid])
    ref = _down(res)
    rb.table_free(res)
    config.set_flag("SPILL", "on")
    assert spill.request_headroom(1 << 40) > 0
    assert _spilled(tid)
    res = rb.table_plan_resident(json.dumps(chain), [tid])
    assert _down(res) == ref
    _free_all([tid, res])


@pytest.mark.parametrize("n", EDGES)
def test_save_and_load_npz(n, tmp_path):
    w = _mixed_wire(n, 77)
    tid = _up(w)
    try:
        t = rb._resident_get(tid)
        path = str(tmp_path / "t.npz")
        nbytes = spill.save_table_npz(path, t)
        assert nbytes == hbm.table_bytes(t)
        back = spill.load_table_npz(path, device="cpu")
        assert _norm(rb._table_to_wire(back)) == _down(tid)
    finally:
        rb.table_free(tid)


# ---------------------------------------------------------------------------
# eviction policy
# ---------------------------------------------------------------------------


def test_eviction_order_equals_jax():
    """The same uploads, touches and headroom requests, at the same
    table bytes, evict the same tables in the same order."""
    wires = [_wire(1024, s) for s in range(6)]
    _both("SPILL", "on")
    jconfig.set_flag("BUCKETS", "off")  # JAX tables at their exact bytes
    jids = [jrb.table_upload_wire(*w) for w in wires]
    pids = [_up(w) for w in wires]
    try:
        assert [jspill._TRACK[t] for t in jids] == [spill._TRACK[t]
                                                    for t in pids]
        nbytes = spill._TRACK[pids[0]]
        order = []
        for touch, need in ((3, nbytes), (0, 2 * nbytes), (5, nbytes - 1),
                            (1, nbytes)):
            jrb.table_num_rows(jids[touch])
            rb.table_num_rows(pids[touch])
            jspill.request_headroom(need)
            spill.request_headroom(need)
            with jrb._RESIDENT_LOCK, rb._RESIDENT_LOCK:
                j = [isinstance(jrb._RESIDENT[t], jspill.SpilledTable)
                     for t in jids]
                p = [isinstance(rb._RESIDENT[t], spill.SpilledTable)
                     for t in pids]
            assert p == j
            order.append(p)
        assert len({tuple(o) for o in order}) == len(order)  # each moved
    finally:
        for t in jids:
            jrb.table_free(t)
        _free_all(pids)


def test_pin_wins():
    config.set_flag("SPILL", "on")
    a, b = _up(_wire(1024, 1)), _up(_wire(1024, 2))
    spill.pin_ids([a])
    spill.request_headroom(1 << 40)
    assert not _spilled(a) and _spilled(b)
    spill.unpin_ids([a])
    spill.request_headroom(1 << 40)
    assert _spilled(a)
    _free_all([a, b])


def test_live_pipelined_reader_blocks_eviction():
    config.set_flag("SPILL", "on")
    a = _up(_wire(1024, 3))
    reader = pipeline.Pending(lambda: None, "test_reader")
    with rb._RESIDENT_LOCK:
        rb._RESIDENT_READERS.setdefault(a, []).append(reader)
    spill.request_headroom(1 << 40)
    assert not _spilled(a)
    reader._run()  # what a pool worker would do; done() flips
    spill.request_headroom(1 << 40)
    assert _spilled(a)
    rb.table_free(a)


def test_active_wire_download_blocks_eviction():
    config.set_flag("SPILL", "on")
    a = _up(_wire(1024, 4))
    with rb._RESIDENT_LOCK:
        rb._RESIDENT_ACTIVE_READS[a] = 1
    try:
        spill.request_headroom(1 << 40)
        assert not _spilled(a)
    finally:
        with rb._RESIDENT_LOCK:
            rb._RESIDENT_ACTIVE_READS.pop(a, None)
    rb.table_free(a)


def test_lru_order():
    config.set_flag("SPILL", "on")
    a, b = _up(_wire(1024, 5)), _up(_wire(1024, 6))
    rb.table_num_rows(a)  # touch a: b is the coldest
    spill.request_headroom(max(hbm.table_bytes(rb._RESIDENT[b]) - 1, 1))
    assert _spilled(b) and not _spilled(a)
    _free_all([a, b])


def test_sync_dispatch_pins_inputs():
    config.set_flag("SPILL", "on")
    a = _up(_wire(1024, 7))
    rb.table_free(rb.table_op_resident(
        json.dumps({"op": "sort_by", "keys": [{"column": 0}]}), [a]))
    with rb._RESIDENT_LOCK:
        assert not spill._PINS.get(a)
    rb.table_free(a)


# a cast of column 1 keeps column 0's tensor: its output aliases its input
ALIASING_OP = {"op": "cast", "column": 1, "type_id": 3}


def test_aliased_storage_is_never_evicted():
    """Two live tables sharing a storage: neither may be evicted while
    the other is live."""
    config.set_flag("SPILL", "on")
    a = _up(_wire(1024, 8))
    b = rb.table_op_resident(json.dumps(ALIASING_OP), [a])
    try:
        spill.request_headroom(1 << 40)
        assert not _spilled(a) and not _spilled(b)
    finally:
        rb.table_free(b)
    spill.request_headroom(1 << 40)
    assert _spilled(a)
    rb.table_free(a)


# ---------------------------------------------------------------------------
# lifecycle: free, reclaim, donate, counts
# ---------------------------------------------------------------------------


def test_free_spilled_releases_backing(tmp_path):
    config.set_flag("SPILL", "on")
    config.set_flag("HOST_SPILL_BUDGET_GB", 0)
    config.set_flag("SPILL_DIR", str(tmp_path))
    tid = _up(_wire(1024))
    spill.request_headroom(1 << 40)
    _bounded(pipeline.drain_io)
    assert glob.glob(str(tmp_path / "*.npz"))
    rb.table_free(tid)
    assert glob.glob(str(tmp_path / "*.npz")) == []
    assert spill.spill_file_count() == 0


@pytest.mark.parametrize("spilled", (False, True))
def test_reclaim_returns_the_tables_bytes(spilled):
    """``table_reclaim`` returns the table's bytes, spilled or not, as
    the JAX package's does for the same wire table (both padded to its
    shape bucket)."""
    w = _mixed_wire(1025, 5)
    jt = jrb.table_upload_wire(*w)
    want = jrb.table_reclaim(jt)
    config.set_flag("SPILL", "on")
    start = rb.resident_table_count()
    tid = _up(w)
    assert rb.resident_table_count() == start + 1
    if spilled:
        spill.request_headroom(1 << 40)
        assert _spilled(tid)
    assert rb.table_reclaim(tid) == want
    assert rb.resident_table_count() == start
    doc = spill.stats_doc()
    assert doc["host_bytes"] == 0 and doc["disk_bytes"] == 0


def test_reclaim_skips_storage_a_live_table_shares():
    a = _up(_wire(1024, 9))
    b = rb.table_op_resident(json.dumps(ALIASING_OP), [a])
    try:
        want = _down(a)
        nbytes = hbm.table_bytes(rb._resident_get(b))
        assert rb.table_reclaim(b) == nbytes
        assert _down(a) == want  # the shared storage is untouched
    finally:
        rb.table_free(a)


def test_reclaim_waits_for_pipelined_readers(monkeypatch):
    config.set_flag("PIPELINE", "2")
    a = _up(_wire(1024, 10))
    real = rb._dispatch_once

    def slow(op, table, rest, name):
        time.sleep(0.2)
        return real(op, table, rest, name)

    monkeypatch.setattr(rb, "_dispatch_once", slow)
    r = rb.table_op_resident(json.dumps(
        {"op": "sort_by", "keys": [{"column": 0}]}), [a])
    assert _bounded(lambda: rb.table_reclaim(a)) > 0
    assert _bounded(lambda: rb.table_num_rows(r)) == 1024
    rb.table_free(r)


def test_donate_consume_of_spilled_input():
    config.set_flag("SPILL", "on")
    tid = _up(_wire(1024))
    spill.request_headroom(1 << 40)
    res = rb.table_op_resident(
        json.dumps({"op": "sort_by", "keys": [{"column": 0}]}),
        [tid], donate=True)
    assert _down(res)[4] == 1024
    rb.table_free(res)
    assert spill.stats_doc()["host_bytes"] == 0


# ---------------------------------------------------------------------------
# the plan's out-of-memory rung
# ---------------------------------------------------------------------------

CHAIN = [{"op": "filter", "mask": 1}, {"op": "cast", "column": 0,
                                       "type_id": 10}]


def test_oom_rung_spills_and_retries_same_shape():
    n = 1024
    ref = _norm(rb.table_plan_wire(json.dumps(CHAIN), *_wire(n),
                                   device="cpu"))
    cold = _up(_wire(n, seed=9))
    config.set_flag("SPILL", "on")
    config.set_flag("METRICS", "1")
    config.set_flag("RETRY_BASE_MS", "1")
    metrics.reset()
    config.set_flag("FAULTS", "seed=3,dispatch:oom:1:1")
    got = _norm(rb.table_plan_wire(json.dumps(CHAIN), *_wire(n),
                                   device="cpu"))
    config.set_flag("FAULTS", "")
    assert got == ref
    c = metrics.snapshot()["counters"]
    assert c["plan.oom_spill_retries"] == 1
    assert c["spill.evictions"] >= 1
    assert c.get("plan.chunked_segments", 0) == 0
    assert _spilled(cold)
    rb.table_free(cold)


def test_oom_rung_falls_through_when_nothing_spillable():
    n = 1024
    ref = _norm(rb.table_plan_wire(json.dumps(CHAIN), *_wire(n),
                                   device="cpu"))
    config.set_flag("SPILL", "on")
    config.set_flag("METRICS", "1")
    config.set_flag("RETRY_BASE_MS", "1")
    metrics.reset()
    config.set_flag("FAULTS", "seed=3,dispatch:oom:1:1")
    got = _norm(rb.table_plan_wire(json.dumps(CHAIN), *_wire(n),
                                   device="cpu"))
    assert got == ref
    c = metrics.snapshot()["counters"]
    assert c.get("plan.oom_spill_retries", 0) == 0
    assert c["plan.chunked_segments"] == 1


def test_hbm_plan_pressure_spills():
    """A footprint plan that does not fit frees its deficit first."""
    from spark_rapids_jni_tpu_torch.column import Column, Table

    config.set_flag("SPILL", "on")
    a = _up(_wire(1024, 11))
    config.set_flag("HBM_BUDGET_GB", TINY_BUDGET_GB)
    t = Table([Column.from_numpy(np.zeros(4096, np.int64), device="cpu")])
    assert not hbm.sort_plan(t, n_key_words=2)["fits"]
    assert _spilled(a)
    rb.table_free(a)


# ---------------------------------------------------------------------------
# chaos at the spill site
# ---------------------------------------------------------------------------


def test_eviction_fault_skips_victim():
    config.set_flag("SPILL", "on")
    config.set_flag("METRICS", "1")
    metrics.reset()
    a = _up(_wire(1024, 1))
    b = _up(_wire(1024, 2))
    config.set_flag("FAULTS", "seed=5,spill:transient:1:1")
    freed = spill.request_headroom(1)
    config.set_flag("FAULTS", "")
    assert freed > 0
    c = metrics.snapshot()["counters"]
    assert c["spill.errors"] == 1 and c["spill.evictions"] == 1
    _free_all([a, b])


def test_repage_fault_retries():
    config.set_flag("SPILL", "on")
    config.set_flag("METRICS", "1")
    metrics.reset()
    w = _mixed_wire(1023, 3)
    tid = _up(w)
    ref = _down(tid)
    spill.request_headroom(1 << 40)
    config.set_flag("RETRY_BASE_MS", "0.1")
    config.set_flag("FAULTS", "seed=5,spill:transient:1:1")
    got = _down(tid)
    config.set_flag("FAULTS", "")
    assert got == ref
    assert metrics.snapshot()["counters"]["retry.attempts"] == 1
    rb.table_free(tid)


def test_spill_injection_stats_equal_jax():
    """The same eviction and repage sequence under one spec makes the
    same calls at the spill site in both packages."""
    _both("SPILL", "on")
    jconfig.set_flag("BUCKETS", "off")
    _both("RETRY_BASE_MS", "0.1")
    wires = [_wire(1024, s) for s in range(4)]
    jids = [jrb.table_upload_wire(*w) for w in wires]
    pids = [_up(w) for w in wires]
    _both("FAULTS", "seed=8,spill:transient:0.5:3")
    try:
        for i in range(4):
            jspill.request_headroom(1)
            spill.request_headroom(1)
            jrb.table_num_rows(jids[i])
            rb.table_num_rows(pids[i])
        from spark_rapids_jni_tpu.utils import faults as jfaults
        from spark_rapids_jni_tpu_torch.utils import faults

        assert faults.injection_stats() == jfaults.injection_stats()
        assert faults.injection_stats()["spill:transient"]["injected"] >= 1
    finally:
        _both("FAULTS", "")
        for t in jids:
            jrb.table_free(t)
        _free_all(pids)


# ---------------------------------------------------------------------------
# flags and the disabled path
# ---------------------------------------------------------------------------


def test_disabled_path_overhead():
    config.set_flag("SPILL", False)
    spill.touch(1)
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        spill.touch(1)
        spill.enabled()
    per_op = (time.perf_counter() - t0) / (2 * n)
    assert per_op < 5e-6, f"disabled spill path costs {per_op * 1e6:.2f} us"


def test_stats_doc_shape_equals_jax():
    assert set(spill.stats_doc()) == set(jspill.stats_doc())
