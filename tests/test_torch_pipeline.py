"""The port's pipelined dispatch plane (``pipeline.py``) and
``table_stream_wire`` against the JAX package's, on the CPU.

``table_stream_wire`` with ``PIPELINE`` off, 1, 2 and 4 gives the JAX
package's 5-tuples byte for byte, in input order, over batches of
1023/1024/1025 rows with nulls, STRING, DECIMAL128 and LIST columns, and
over the slice's wire plan on packed fact rows. Then the cases of the
JAX package's ``tests/test_pipeline.py``, on the port: asynchronous
resident chains equal the synchronous path, worker failures replay
synchronously, donation consumes ids and never frees what a reader
still uses, unknown ids raise the labeled KeyError, and concurrent
producers keep byte parity. Every wait has a timeout. The ``cuda`` tests
run the stream and the donation barrier on the card.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest

from spark_rapids_jni_tpu import pipeline as jpipeline
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import spill as jspill
from spark_rapids_jni_tpu_torch import pipeline
from spark_rapids_jni_tpu_torch import plan as plan_mod
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.utils import config, metrics, spill

EDGES = (1023, 1024, 1025)
DEPTHS = ("off", "1", "2", "4")
CHAIN = [
    {"op": "filter", "mask": 2},
    {"op": "cast", "column": 1, "type_id": 10},
    {"op": "sort_by", "keys": [{"column": 0}]},
]
FACT_TYPES = [4, 4, 4, 3, 11]
QTY_BY_DATE = [
    {"op": "from_rows", "type_ids": FACT_TYPES, "scales": [0] * 5},
    {"op": "filter", "mask": 4},
    {"op": "cast", "column": 3, "type_id": 4},
    {"op": "groupby", "by": [2],
     "aggs": [{"column": 3, "agg": a} for a in ("sum", "count", "min", "max")]},
    {"op": "sort_by", "keys": [{"column": 0}]},
    {"op": "to_rows"},
]
FLAGS = ("PIPELINE", "SPILL", "FAULTS", "METRICS", "KERNELS", "RETRY_BASE_MS",
         "HBM_BUDGET_GB", "HOST_SPILL_BUDGET_GB", "SPILL_DIR", "BUCKETS")
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
    for cfg, pipe in ((jconfig, jpipeline), (config, pipeline)):
        _bounded(pipe.drain)
        for name in FLAGS:
            if name in cfg._FLAGS:
                cfg.clear_flag(name)
        pipe.depth()  # the flag is off: the pool goes
        _bounded(pipe.drain_io)
    assert (spill.spill_file_count(), jspill.spill_file_count()) == (0, 0)
    assert (jrb.resident_table_count(), rb.resident_table_count()) == before


def _strings_wire(strs):
    b = [s.encode() for s in strs]
    offs = np.zeros(len(b) + 1, np.int32)
    np.cumsum([len(x) for x in b], out=offs[1:])
    return offs.tobytes() + b"".join(b)


def _mixed_wire(n: int, seed: int):
    """INT64 key, INT64 value (nulls), BOOL8 mask, STRING (nulls),
    DECIMAL128 (nulls), LIST<INT32>."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 9, n).astype(np.int64)
    v = rng.integers(-100, 100, n).astype(np.int64)
    vv = (rng.random(n) > 0.2).astype(np.uint8).tobytes()
    m = (rng.random(n) > 0.4).astype(np.uint8)
    strs = ["s" * int(x % 4) + str(x) for x in rng.integers(0, 50, n)]
    sv = (rng.random(n) > 0.1).astype(np.uint8).tobytes()
    d = rng.integers(-2**62, 2**62, (n, 2)).astype(np.int64)
    lens = rng.integers(0, 4, n).astype(np.int32)
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    child = rng.integers(-9, 9, int(offs[-1])).astype(np.int32)
    return ([4, 4, 11, 23, 27, 24], [0, 0, 0, 0, -3, 3],
            [k.tobytes(), v.tobytes(), m.tobytes(), _strings_wire(strs),
             d.tobytes(), offs.tobytes() + child.tobytes()],
            [None, vv, None, sv, vv, None], n)


def _fact_wire(n: int, seed: int):
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 32), np.uint8)
    cols = ((0, (rng.zipf(1.3, n) % 500).astype(np.int64)),
            (8, rng.integers(0, 10_000, n).astype(np.int64)),
            (16, rng.integers(2_450_816, 2_450_876, n).astype(np.int64) + seed),
            (24, rng.integers(1, 101, n).astype(np.int32)))
    for off, a in cols:
        rows[:, off:off + a.itemsize] = a.view(np.uint8).reshape(n, a.itemsize)
    rows[:, 28] = rng.random(n) < 0.5
    rows[:, 29] = (1 | ((rng.random(n) > 0.03) << 1) | 4
                   | ((rng.random(n) > 0.03) << 3) | 16)
    offs = (np.arange(n + 1) * 32).astype(np.int32)
    return ([24], [5], [offs.tobytes() + rows.tobytes()], [None], n)


def _sync_want(n):
    """A batch and the synchronous port's answer over CHAIN."""
    b = _mixed_wire(n, n)
    return b, tuple(rb.table_plan_wire(json.dumps(CHAIN), *b, device="cpu"))


def _resident_chain(b, donate=False):
    cur = rb.table_upload_wire(*b, device="cpu")
    for op in CHAIN:
        nxt = rb.table_op_resident(json.dumps(op), [cur], donate=donate)
        if not donate:
            rb.table_free(cur)
        cur = nxt
    try:
        return tuple(rb.table_download_wire(cur))
    finally:
        rb.table_free(cur)


# ---------------------------------------------------------------------------
# table_stream_wire against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
def test_stream_equals_jax_mixed_types(depth):
    batches = [_mixed_wire(n, 10 + i) for i, n in enumerate(EDGES * 2)]
    want = [tuple(w) for w in jrb.table_stream_wire(json.dumps(CHAIN),
                                                    batches)]
    config.set_flag("PIPELINE", depth)
    got = _bounded(lambda: rb.table_stream_wire(json.dumps(CHAIN), batches,
                                                device="cpu"))
    assert [tuple(g) for g in got] == want


@pytest.mark.parametrize("depth", DEPTHS)
def test_stream_equals_jax_on_the_cells_plan(depth):
    """The slice's plan over packed fact rows whose dates differ by
    batch, so an out-of-order result cannot pass; the JAX stream runs
    pipelined too (its own PIPELINE, depth 2)."""
    batches = [_fact_wire(n, k) for k, n in enumerate(EDGES * 2)]
    jconfig.set_flag("PIPELINE", "2")
    want = _bounded(lambda: [tuple(w) for w in jrb.table_stream_wire(
        json.dumps(QTY_BY_DATE), batches)])
    assert len({w[2][0] for w in want}) == len(want)
    config.set_flag("PIPELINE", depth)
    config.set_flag("KERNELS", "on")
    got = _bounded(lambda: rb.table_stream_wire(json.dumps(QTY_BY_DATE),
                                                batches, device="cpu"))
    assert [tuple(g) for g in got] == want


def test_stream_off_is_a_loop_of_table_plan_wire():
    batches = [_mixed_wire(n, 3) for n in EDGES]
    want = [tuple(rb.table_plan_wire(json.dumps(CHAIN), *b, device="cpu"))
            for b in batches]
    config.set_flag("PIPELINE", "off")
    assert [tuple(g) for g in rb.table_stream_wire(
        json.dumps(CHAIN), batches, device="cpu")] == want


def test_stream_checks_every_batch_before_any_decode(monkeypatch):
    good = _mixed_wire(1024, 1)
    bad = ([4], [0], [np.zeros(8, np.int64).tobytes()], [None], 8)
    decoded = []
    real = rb._table_from_wire
    monkeypatch.setattr(rb, "_table_from_wire",
                        lambda *a: decoded.append(1) or real(*a))
    config.set_flag("PIPELINE", "2")
    with pytest.raises(ValueError, match="plancheck"):
        rb.table_stream_wire(json.dumps(CHAIN), [good, bad], device="cpu")
    assert decoded == []
    assert rb.table_stream_wire(json.dumps(CHAIN), [], device="cpu") == []


def test_stream_stages_run_on_workers(monkeypatch):
    """Decode and encode run on pool workers, the plan on the caller."""
    b, want = _sync_want(1024)
    seen = {"decode": set(), "plan": set(), "encode": set()}
    real_in, real_out, real_plan = (rb._table_from_wire, rb._table_to_wire,
                                    plan_mod.run_plan)

    def tag(stage, fn):
        def wrapped(*a, **k):
            seen[stage].add(threading.current_thread().name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(rb, "_table_from_wire", tag("decode", real_in))
    monkeypatch.setattr(rb, "_table_to_wire", tag("encode", real_out))
    monkeypatch.setattr(plan_mod, "run_plan", tag("plan", real_plan))
    config.set_flag("PIPELINE", "2")
    config.set_flag("METRICS", "1")
    metrics.reset()
    me = threading.current_thread().name
    got = rb.table_stream_wire(json.dumps(CHAIN), [b] * 4, device="cpu")
    assert [tuple(g) for g in got] == [want] * 4
    assert all(n.startswith("srt-pipeline") for n in seen["decode"])
    assert all(n.startswith("srt-pipeline") for n in seen["encode"])
    assert seen["plan"] == {me}
    snap = metrics.snapshot()
    assert snap["counters"]["pipeline.enqueued"] == 8
    assert snap["histograms"]["pipeline.overlap_ms"]["count"] == 8
    assert snap["timers"]["pipeline.decode"]["count"] == 4


# ---------------------------------------------------------------------------
# the cases of the JAX package's tests/test_pipeline.py, on the port
# ---------------------------------------------------------------------------


def test_off_values_and_depths():
    for v in ("", "off", "none", "0", "false"):
        config.set_flag("PIPELINE", v)
        assert not pipeline.enabled(), v
    config.set_flag("PIPELINE", "3")
    assert pipeline.depth() == 3
    config.set_flag("PIPELINE", "on")
    assert pipeline.depth() == pipeline.DEFAULT_DEPTH == 2


@pytest.mark.parametrize("value,match", [
    ("fast", "PIPELINE"), ("-2", "0..64"), ("65", "0..64")])
def test_invalid_depth_fails_loudly_as_jax(value, match):
    for cfg, pipe in ((jconfig, jpipeline), (config, pipeline)):
        cfg.set_flag("PIPELINE", value)
        with pytest.raises(ValueError, match=match):
            pipe.depth()
        cfg.clear_flag("PIPELINE")


def test_pool_tears_down_when_flag_goes_off():
    before = sys.getswitchinterval()
    b, want = _sync_want(1023)
    config.set_flag("PIPELINE", "2")
    got = _bounded(lambda: rb.table_stream_wire(json.dumps(CHAIN), [b],
                                                device="cpu"))
    assert [tuple(g) for g in got] == [want]
    assert any(t.name.startswith("srt-pipeline")
               for t in threading.enumerate())
    _bounded(pipeline.drain)
    config.set_flag("PIPELINE", "off")
    pipeline.depth()
    assert sys.getswitchinterval() == before
    deadline = time.time() + 10
    while time.time() < deadline and any(
            t.name.startswith("srt-pipeline") for t in threading.enumerate()):
        time.sleep(0.02)
    assert not any(t.name.startswith("srt-pipeline")
                   for t in threading.enumerate())


@pytest.mark.parametrize("n", EDGES)
def test_async_resident_chain_matches_sync(n):
    b, want = _sync_want(n)
    config.set_flag("PIPELINE", "off")
    assert _resident_chain(b) == want
    config.set_flag("PIPELINE", "2")
    assert _bounded(lambda: _resident_chain(b)) == want


def test_blocking_points_resolve_pending():
    b, want = _sync_want(1024)
    config.set_flag("PIPELINE", "1")
    tid = rb.table_upload_wire(*b, device="cpu")
    out = rb.table_plan_resident(json.dumps(CHAIN), [tid])
    try:
        assert _bounded(lambda: rb.table_num_rows(out)) == want[4]
        assert tuple(rb.table_download_wire(out)) == want
    finally:
        rb.table_free(tid)
        rb.table_free(out)


@pytest.mark.parametrize("depth", (1, 2, 8))
def test_threaded_chains_byte_parity(depth):
    oracle = {n: _sync_want(n) for n in EDGES}
    config.set_flag("PIPELINE", str(depth))
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more thread switches than cores

    def producer(i):
        try:
            for rep in range(2):
                n = EDGES[(i + rep) % len(EDGES)]
                b, want = oracle[n]
                if _resident_chain(b) != want:
                    errors.append((i, n))
        except Exception as e:  # reported below
            errors.append((i, repr(e)))

    try:
        threads = [threading.Thread(target=producer, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads), "producer hung"
    assert errors == []


def test_launch_counts_are_exact_under_threads():
    """KernelInfo.count from many threads at once loses no launch."""
    from spark_rapids_jni_tpu_torch.kernels import row_transpose

    info = row_transpose.PACK
    start = info.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [info.count() for _ in range(20_000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert info.launches - start == 8 * 20_000
    info.launches = start


def test_transient_worker_failure_replays_sync(monkeypatch):
    b, want = _sync_want(1024)
    real = rb._dispatch_once

    def flaky(op, table, rest, name):
        if threading.current_thread().name.startswith("srt-pipeline"):
            raise RuntimeError("injected worker failure")
        return real(op, table, rest, name)

    monkeypatch.setattr(rb, "_dispatch_once", flaky)
    config.set_flag("METRICS", "1")
    config.set_flag("PIPELINE", "2")
    metrics.reset()
    assert _bounded(lambda: _resident_chain(b)) == want
    assert metrics.snapshot()["counters"]["pipeline.replays"] >= 1


def test_genuine_op_error_surfaces_at_blocking_point(monkeypatch):
    """An op error on the worker surfaces at the blocking point as the
    synchronous path's own error, and stays: a second blocking point
    raises it again without a second replay."""
    b, _ = _sync_want(1024)

    def broken(op, table, rest, name):
        raise ValueError(f"unknown table op {name!r} (injected)")

    config.set_flag("PIPELINE", "2")
    config.set_flag("METRICS", "1")
    metrics.reset()
    tid = rb.table_upload_wire(*b, device="cpu")
    monkeypatch.setattr(rb, "_dispatch_once", broken)
    out = rb.table_op_resident(json.dumps(CHAIN[0]), [tid])
    try:
        with pytest.raises(ValueError, match="unknown table op"):
            _bounded(lambda: rb.table_download_wire(out))
        with pytest.raises(ValueError, match="unknown table op"):
            rb.table_num_rows(out)
        assert metrics.snapshot()["counters"]["pipeline.replays"] == 1
    finally:
        rb.table_free(tid)
        rb.table_free(out)


def test_plan_check_and_unknown_ids_raise_at_the_call():
    b, _ = _sync_want(1024)
    config.set_flag("PIPELINE", "2")
    with pytest.raises(KeyError, match="999999"):
        rb.table_op_resident(json.dumps(CHAIN[0]), [999999])
    tid = rb.table_upload_wire(*b, device="cpu")
    try:
        # the port checks the op before it enqueues (the JAX package's
        # resident op raises this at the blocking point)
        with pytest.raises(ValueError, match="plancheck"):
            rb.table_op_resident(json.dumps({"op": "explode_wrong"}), [tid])
    finally:
        rb.table_free(tid)


def test_donated_plan_wire_reports_donation():
    b, want = _sync_want(1025)
    config.set_flag("METRICS", "1")
    metrics.reset()
    assert tuple(rb.table_plan_wire(json.dumps(CHAIN), *b,
                                     device="cpu")) == want
    snap = metrics.snapshot()
    assert snap["bytes"]["hbm.donated_bytes"] > 0
    assert snap["counters"]["hbm.donations"] == 1


@pytest.mark.parametrize("depth", ("off", "2"))
def test_donate_consumes_resident_input_id(depth):
    b, want = _sync_want(1024)
    config.set_flag("PIPELINE", depth)
    tid = rb.table_upload_wire(*b, device="cpu")
    out = rb.table_op_resident(json.dumps(CHAIN[0]), [tid], donate=True)
    with pytest.raises(KeyError, match=rf"{tid}.*\d+ table\(s\) live"):
        rb.table_download_wire(tid)
    got = _bounded(lambda: tuple(rb.table_download_wire(out)))
    rb.table_free(out)
    ref = rb.table_upload_wire(*b, device="cpu")
    want0 = rb.table_op_resident(json.dumps(CHAIN[0]), [ref])
    try:
        assert got == _bounded(lambda: tuple(rb.table_download_wire(want0)))
    finally:
        rb.table_free(ref)
        rb.table_free(want0)


def test_aliasing_op_never_frees_caller_buffers():
    """A single-table concat returns its input's tensors: a donated plan
    that starts with one frees nothing the output still holds, and an
    undonated plan never touches the caller's table."""
    from spark_rapids_jni_tpu_torch.column import Column, Table

    rng = np.random.default_rng(3)
    k = rng.integers(0, 9, 1024, dtype=np.int64)
    v = rng.integers(-50, 50, 1024, dtype=np.int64)
    plan = [{"op": "concat"},
            {"op": "cast", "column": 1, "type_id": 10},
            {"op": "cast", "column": 0, "type_id": 3}]
    for donate in (False, True):
        t = Table([Column.from_numpy(k.copy(), device="cpu"),
                   Column.from_numpy(v.copy(), device="cpu")], ["k", "v"])
        out = plan_mod.run_plan(plan, t, donate_input=donate)
        assert int(out.logical_row_count) == 1024
        assert not spill.storage_freed(t.columns[0].data)
        assert t.columns[0].data.numpy().tobytes() == k.tobytes()
        assert t.columns[1].data.numpy().tobytes() == v.tobytes()


def test_bad_rest_id_leaves_donated_input_intact():
    b, _ = _sync_want(1024)
    tid = rb.table_upload_wire(*b, device="cpu")
    try:
        with pytest.raises(KeyError, match="31337"):
            rb.table_op_resident(json.dumps({"op": "join", "on": [0]}),
                                 [tid, 31337], donate=True)
        assert rb.table_num_rows(tid) == 1024
    finally:
        rb.table_free(tid)


def test_donate_waits_for_inflight_readers(monkeypatch):
    """op1 reads A slowly on a worker; op2 donate-consumes A right
    after: the donate barrier keeps A alive until op1 is done."""
    sort_op = {"op": "sort_by", "keys": [{"column": 0}]}
    b, _ = _sync_want(1024)
    a0 = rb.table_upload_wire(*b, device="cpu")
    w1 = rb.table_op_resident(json.dumps(sort_op), [a0])
    want1 = tuple(rb.table_download_wire(w1))
    w2 = rb.table_op_resident(json.dumps(CHAIN[0]), [a0], donate=True)
    want2 = tuple(rb.table_download_wire(w2))
    for t in (w1, w2):
        rb.table_free(t)
    real = rb._dispatch_once

    def slow(op, table, rest, name):
        if (threading.current_thread().name.startswith("srt-pipeline")
                and name == "sort_by"):
            time.sleep(0.3)
        return real(op, table, rest, name)

    monkeypatch.setattr(rb, "_dispatch_once", slow)
    config.set_flag("PIPELINE", "2")
    A = rb.table_upload_wire(*b, device="cpu")
    r1 = rb.table_op_resident(json.dumps(sort_op), [A])
    r2 = rb.table_op_resident(json.dumps(CHAIN[0]), [A], donate=True)
    try:
        assert _bounded(lambda: tuple(rb.table_download_wire(r1))) == want1
        assert _bounded(lambda: tuple(rb.table_download_wire(r2))) == want2
    finally:
        rb.table_free(r1)
        rb.table_free(r2)


def test_donated_async_failure_surfaces_op_error(monkeypatch):
    b, _ = _sync_want(1024)
    config.set_flag("PIPELINE", "2")
    tid = rb.table_upload_wire(*b, device="cpu")
    plan = CHAIN[:2]
    with pytest.raises(ValueError, match=r"plancheck: op\[2\]"):
        rb.table_plan_resident(json.dumps(plan + [{"op": "nope_not_an_op"}]),
                               [tid], donate=True)
    assert rb.table_num_rows(tid) == 1024  # the static reject kept it
    real = plan_mod.run_plan

    def boom(ops, table, rest=(), **kw):
        if threading.current_thread().name.startswith("srt-pipeline"):
            raise ValueError("unknown table op (injected mid-flight)")
        return real(ops, table, rest, **kw)

    monkeypatch.setattr(plan_mod, "run_plan", boom)
    out = rb.table_plan_resident(json.dumps(plan), [tid], donate=True)
    try:
        with pytest.raises(ValueError, match="injected mid-flight"):
            _bounded(lambda: rb.table_download_wire(out))
    finally:
        rb.table_free(out)


def test_unknown_and_double_free():
    b, _ = _sync_want(1023)
    tid = rb.table_upload_wire(*b, device="cpu")
    live = rb.resident_table_count()
    with pytest.raises(KeyError, match=rf"424242.*{live} table\(s\) live"):
        rb.table_download_wire(424242)
    rb.table_free(tid)
    with pytest.raises(KeyError, match=str(tid)):
        rb.table_free(tid)
    with pytest.raises(KeyError, match="unknown or already-freed"):
        rb.table_num_rows(tid)
    with pytest.raises(KeyError, match=str(tid)):
        rb.table_reclaim(tid)


def test_stage_ahead_and_submit_io():
    config.set_flag("PIPELINE", "2")
    got = _bounded(lambda: pipeline.stage_ahead(
        range(6), lambda i: i * 10, lambda x: x + 1, lookahead=2))
    assert got == [1, 11, 21, 31, 41, 51]
    p = pipeline.submit_io(lambda: "written", "io.test")
    assert _bounded(p.resolve) == "written"
    config.set_flag("PIPELINE", "off")
    assert pipeline.stage_ahead(range(3), lambda i: i, lambda x: -x) == [
        0, -1, -2]
