"""The port's fault plane (``utils/faults.py``) against the JAX
package's, on the CPU.

The same specs, strings and call sequences go to both packages:
``parse_spec``'s errors, the seeded per-site decision stream over 1,000
calls, ``classify_text`` over every string of the JAX package's
``tests/test_faults.py`` plus CUDA's own error texts, the backoff, the
deadlines, and the circuit breaker on a fake clock. Fault-injected wire
plans at 1023/1024/1025 rows give the fault-free bytes in both packages,
and where the two packages make the same calls (both run a plan by its
fusion segments) the same ``injection_stats()`` and retry counters. Tolerance 0 throughout.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import pipeline as jpipeline
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import faults as jfaults
from spark_rapids_jni_tpu.utils import metrics as jmetrics
from spark_rapids_jni_tpu.utils import spill as jspill
from spark_rapids_jni_tpu_torch import pipeline
from spark_rapids_jni_tpu_torch import plan as plan_mod
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.kernels import registry
from spark_rapids_jni_tpu_torch.utils import config, faults, metrics, spill

EDGES = (1023, 1024, 1025)
FACT_TYPES = [4, 4, 4, 3, 11]  # item_sk, customer_sk, sold_date_sk, quantity, keep
FROM_ROWS = {"op": "from_rows", "type_ids": FACT_TYPES, "scales": [0] * 5}
# the wire plan of the slice's cell: quantity sold a day
QTY_BY_DATE = [
    FROM_ROWS,
    {"op": "filter", "mask": 4},
    {"op": "cast", "column": 3, "type_id": 4},
    {"op": "groupby", "by": [2],
     "aggs": [{"column": 3, "agg": a} for a in ("sum", "count", "min", "max")]},
    {"op": "sort_by", "keys": [{"column": 0}]},
    {"op": "to_rows"},
]
# the part of it whose kernel-tier routes are the same in both packages:
# K1b, the fused [filter, cast] segment and K1a
ROWS_CHAIN = [FROM_ROWS, {"op": "filter", "mask": 4},
              {"op": "cast", "column": 3, "type_id": 4}, {"op": "to_rows"}]
ROW_LOCAL_CHAIN = [{"op": "filter", "mask": 1},
                   {"op": "cast", "column": 0, "type_id": 10}]
GLOBAL_CHAIN = [{"op": "cast", "column": 0, "type_id": 10},
                {"op": "sort_by", "keys": [{"column": 0}]}]
FLAGS = ("FAULTS", "RETRY_MAX", "RETRY_BASE_MS", "DEADLINE_DEFAULT_S",
         "BREAKER_THRESHOLD", "BREAKER_PROBE_S", "PIPELINE", "SPILL",
         "SPILL_DIR", "HOST_SPILL_BUDGET_GB", "HBM_BUDGET_GB", "METRICS",
         "KERNELS", "BUCKETS")
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


def _both(name, value):
    jconfig.set_flag(name, value)
    config.set_flag(name, value)


def _fact_wire(n: int, seed: int):
    """(n, 32) packed fact rows as a LIST<UINT8> wire table: ~3 % null
    customer_sk and quantity, half the rows kept."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 32), np.uint8)
    cols = ((0, (rng.zipf(1.3, n) % 500).astype(np.int64)),
            (8, rng.integers(0, 10_000, n).astype(np.int64)),
            (16, rng.integers(2_450_816, 2_450_876, n).astype(np.int64)),
            (24, rng.integers(1, 101, n).astype(np.int32)))
    for off, a in cols:
        rows[:, off:off + a.itemsize] = a.view(np.uint8).reshape(n, a.itemsize)
    rows[:, 28] = rng.random(n) < 0.5
    rows[:, 29] = (1 | ((rng.random(n) > 0.03) << 1) | 4
                   | ((rng.random(n) > 0.03) << 3) | 16)
    offs = (np.arange(n + 1) * 32).astype(np.int32)
    return ([24], [5], [offs.tobytes() + rows.tobytes()], [None], n)


def _cols_wire(n: int, seed: int = 0):
    rng = np.random.default_rng(n + seed)
    k = rng.integers(-50, 50, n, dtype=np.int64)
    mask = (k > 0).astype(np.uint8)
    valid = (rng.random(n) > 0.1).astype(np.uint8).tobytes()
    return ([4, 11], [0, 0], [k.tobytes(), mask.tobytes()], [valid, None], n)


def _norm(wire):
    t, s, d, v, n = wire
    return ([int(x) for x in t], [int(x) for x in s],
            [None if x is None else bytes(x) for x in d],
            [None if x is None else bytes(x) for x in v], int(n))


def _port(plan, wire):
    return _norm(rb.table_plan_wire(json.dumps(plan), *wire, device="cpu"))


def _jax(plan, wire):
    return _norm(jrb.table_plan_wire(json.dumps(plan), *wire))


# ---------------------------------------------------------------------------
# spec parsing and the flags
# ---------------------------------------------------------------------------

BAD_SPECS = [
    "bogus:transient:1", "dispatch:meteor:1", "dispatch:transient:nope",
    "dispatch:transient:1.5", "dispatch:transient:1:x",
    "dispatch:transient:1:-2", "seed=pi,dispatch:transient:1",
    "dispatch:transient",
]


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_bad_spec_raises_the_jax_message(bad):
    with pytest.raises(ValueError) as want:
        jfaults.parse_spec(bad)
    with pytest.raises(ValueError) as got:
        faults.parse_spec(bad)
    assert str(got.value) == str(want.value)
    assert "SPARK_RAPIDS_TPU_FAULTS" in str(got.value)


def test_bad_env_spec_fails_loudly(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FAULTS", "junk")
    with pytest.raises(ValueError, match="SPARK_RAPIDS_TPU_FAULTS"):
        config.get_flag("FAULTS")


@pytest.mark.parametrize("name,bad", [
    ("RETRY_MAX", "-1"), ("RETRY_MAX", "x"), ("RETRY_BASE_MS", "0"),
    ("DEADLINE_DEFAULT_S", "-3"), ("BREAKER_THRESHOLD", "0"),
    ("BREAKER_PROBE_S", "-1"), ("HOST_SPILL_BUDGET_GB", "banana"),
    ("HOST_SPILL_BUDGET_GB", "-1"),
])
def test_knob_env_fails_loudly_as_jax(monkeypatch, name, bad):
    monkeypatch.setenv(f"SPARK_RAPIDS_TPU_{name}", bad)
    with pytest.raises(ValueError) as want:
        jconfig.get_flag(name)
    with pytest.raises(ValueError) as got:
        config.get_flag(name)
    assert str(got.value) == str(want.value)
    assert name in str(got.value)


@pytest.mark.parametrize("name", [
    "PIPELINE", "FAULTS", "RETRY_MAX", "RETRY_BASE_MS", "DEADLINE_DEFAULT_S",
    "BREAKER_THRESHOLD", "BREAKER_PROBE_S", "SPILL", "SPILL_DIR",
    "HOST_SPILL_BUDGET_GB", "HBM_BUDGET_GB", "LOG_LEVEL", "ALLOC_LOG_LEVEL",
])
def test_flag_defaults_equal_jax(name):
    assert config.get_flag(name) == jconfig.get_flag(name)
    assert config.flag_default(name) == jconfig.flag_default(name)


def test_good_spec_round_trips():
    for mod in (jfaults, faults):
        p = mod.parse_spec("seed=9,dispatch:transient:0.5:3,serde:oom:1")
        assert p.seed == 9
        assert set(p.stats()) == {"dispatch:transient", "serde:oom"}


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------

# every (type, message) of the JAX package's tests/test_faults.py
JAX_STRINGS = [
    ("XlaRuntimeError", "UNAVAILABLE: socket closed"),
    ("RuntimeError", "failed to connect to coordination service"),
    ("DeviceUnreachable", "anything"),
    ("TimeoutExpired", "probe"),
    ("XlaRuntimeError", "RESOURCE_EXHAUSTED: out of memory allocating 1GB"),
    ("MemoryError", "failed to allocate"),
    ("RuntimeError", "operation was cancelled"),
    ("ValueError", "unknown op 'zorp'"),
    ("KeyError", "table id 7"),
    ("RuntimeError", "UNAVAILABLE: connection reset"),
    ("RuntimeError", "UNAVAILABLE: device lost after launch"),
]

# CUDA's texts: torch's allocator failure and cudaGetErrorString's, as
# torch and the port's kernels (kernels.check_status) raise them
CUDA_STRINGS = [
    ("OutOfMemoryError", "CUDA out of memory. Tried to allocate 1024.00 GiB. "
     "GPU 0 has a total capacity of 79.10 GiB", faults.ResourceExhausted),
    ("RuntimeError", "CUDA error: out of memory", faults.ResourceExhausted),
    ("RuntimeError", "build_table: CUDA error 2: out of memory",
     faults.ResourceExhausted),
    ("AcceleratorError", "CUDA error: an illegal memory access was "
     "encountered\nCUDA kernel errors might be asynchronously reported at "
     "some other API call", faults.PermanentError),
    ("RuntimeError", "pack_rows: CUDA error 716: misaligned address",
     faults.PermanentError),
    ("RuntimeError", "CUDA error: device-side assert triggered",
     faults.PermanentError),
    ("RuntimeError", "CUDA error: unspecified launch failure",
     faults.PermanentError),
    ("RuntimeError", "CUDA error: an illegal instruction was encountered",
     faults.PermanentError),
    # a sticky error stays permanent even beside an OOM or transient text
    ("RuntimeError", "CUDA error: an illegal memory access was encountered "
     "(after: failed to allocate)", faults.PermanentError),
    ("RuntimeError", "CUDA error: unspecified launch failure; device "
     "unavailable", faults.PermanentError),
]


@pytest.mark.parametrize("type_name,msg", JAX_STRINGS)
def test_classify_text_equals_jax(type_name, msg):
    got = faults.classify_text(type_name, msg)
    want = jfaults.classify_text(type_name, msg)
    assert got.__name__ == want.__name__


@pytest.mark.parametrize("type_name,msg,want", CUDA_STRINGS)
def test_classify_cuda_text(type_name, msg, want):
    assert faults.classify_text(type_name, msg) is want
    assert faults.retryable_class(want) == (want is faults.ResourceExhausted)


def test_torch_oom_classifies_resource_exhausted():
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert faults.classify(err) is faults.ResourceExhausted


def test_typed_errors_classify_as_themselves():
    for cls in (faults.TransientDeviceError, faults.PermanentError,
                faults.ResourceExhausted, faults.Cancelled,
                faults.DeadlineExceeded, faults.Degraded):
        assert faults.classify(cls("x")) is cls


def test_retryable_classes_equal_jax():
    for name in ("TransientDeviceError", "PermanentError",
                 "ResourceExhausted", "Cancelled", "DeadlineExceeded",
                 "Degraded"):
        assert (faults.retryable_class(getattr(faults, name))
                == jfaults.retryable_class(getattr(jfaults, name)))


def test_sticky_cuda_error_is_never_retried():
    config.set_flag("RETRY_BASE_MS", "0.1")
    calls = {"n": 0}

    def sticky():
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        faults.run_with_retry(sticky, "t")
    assert calls["n"] == 1


# ---------------------------------------------------------------------------
# the seeded decision stream
# ---------------------------------------------------------------------------


def _decisions(mod, spec, site, calls):
    plan = mod.parse_spec(spec)
    out = []
    for _ in range(calls):
        try:
            plan.fire(site)
            out.append(False)
        except mod.FaultError as e:
            out.append(type(e).__name__)
    return out, plan.stats()


@pytest.mark.parametrize("site", faults.SITES)
@pytest.mark.parametrize("kind", faults.KINDS)
def test_decision_stream_equals_jax(site, kind):
    spec = f"seed=11,{site}:{kind}:0.3"
    got = _decisions(faults, spec, site, 1000)
    want = _decisions(jfaults, spec, site, 1000)
    assert got == want
    assert 200 < sum(bool(x) for x in got[0]) < 400  # 0.3 mixes


@pytest.mark.parametrize("spec", [
    "dispatch:oom:1:2", "seed=3,dispatch:transient:0.5:7,dispatch:oom:0.5",
    "seed=2,dispatch:permanent:0.01", "seed=1,serde:transient:0",
])
def test_limited_and_stacked_rules_equal_jax(spec):
    assert (_decisions(faults, spec, "dispatch", 1000)
            == _decisions(jfaults, spec, "dispatch", 1000))


def test_sites_and_kinds_equal_jax():
    assert faults.SITES == jfaults.SITES
    assert faults.KINDS == jfaults.KINDS


# ---------------------------------------------------------------------------
# retry, backoff, deadlines
# ---------------------------------------------------------------------------


def test_transient_recovers_within_budget():
    config.set_flag("METRICS", "1")
    config.set_flag("RETRY_BASE_MS", "1")
    metrics.reset()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("UNAVAILABLE: connection reset")
        return "ok"

    assert faults.run_with_retry(flaky, "t") == "ok"
    assert calls["n"] == 3
    assert metrics.snapshot()["counters"]["retry.attempts"] == 2
    assert metrics.snapshot()["histograms"]["retry.backoff_ms"]["count"] == 2


def test_permanent_raw_error_surfaces_unchanged():
    err = ValueError("unknown op 'zorp'")

    def bad():
        raise err

    with pytest.raises(ValueError) as ei:
        faults.run_with_retry(bad, "t")
    assert ei.value is err


def test_exhaustion_raises_typed_chained():
    config.set_flag("METRICS", "1")
    config.set_flag("RETRY_MAX", "2")
    config.set_flag("RETRY_BASE_MS", "0.1")
    metrics.reset()

    def always():
        raise RuntimeError("CUDA error: out of memory")

    with pytest.raises(faults.ResourceExhausted) as ei:
        faults.run_with_retry(always, "t")
    assert "retries exhausted after 2" in str(ei.value)
    assert isinstance(ei.value.__cause__, RuntimeError)
    c = metrics.snapshot()["counters"]
    assert (c["retry.attempts"], c["retry.giveups"]) == (2, 1)


@pytest.mark.parametrize("attempt", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("label", ["site", "dispatch.filter", "wire.in"])
def test_backoff_equals_jax(attempt, label):
    _both("RETRY_BASE_MS", "7")
    assert faults.backoff_ms(attempt, label) == jfaults.backoff_ms(
        attempt, label)
    # jitter is [0.5x, 1.0x): attempt 3's floor beats attempt 1's ceiling
    assert faults.backoff_ms(3, label) > faults.backoff_ms(1, label)


def test_cancelled_token_aborts_a_plan():
    tok = faults.CancelToken()
    tok.cancel("test says stop")
    with faults.scoped_token(tok):
        with pytest.raises(faults.Cancelled, match="test says stop"):
            _port(ROW_LOCAL_CHAIN, _cols_wire(1024))


def test_expired_deadline_aborts_a_stream():
    tok = faults.CancelToken(deadline_s=1e-6)
    time.sleep(0.005)
    with faults.scoped_token(tok):
        with pytest.raises(faults.DeadlineExceeded):
            rb.table_stream_wire(json.dumps(ROW_LOCAL_CHAIN),
                                 [_cols_wire(1024)], device="cpu")


def test_expired_token_never_sleeps_in_backoff():
    config.set_flag("RETRY_BASE_MS", "10000")
    tok = faults.CancelToken(deadline_s=1e-6)
    time.sleep(0.005)
    with faults.scoped_token(tok):
        t0 = time.perf_counter()
        with pytest.raises(faults.DeadlineExceeded):
            faults.sleep_backoff(1, "t")
        assert time.perf_counter() - t0 < 1.0


def test_token_scope_restores_previous():
    outer = faults.CancelToken()
    with faults.scoped_token(outer):
        with faults.scoped_token(faults.CancelToken()):
            assert faults.current_token() is not outer
        assert faults.current_token() is outer
    assert faults.current_token() is None
    faults.check_cancel()  # no token: a no-op


def test_deadline_on_a_fake_clock():
    clock = {"t": 100.0}
    tok = faults.CancelToken(deadline_s=2.0, clock=lambda: clock["t"])
    assert tok.remaining() == 2.0 and not tok.expired()
    clock["t"] = 102.5
    with pytest.raises(faults.DeadlineExceeded, match="0.500s past"):
        tok.check()


# ---------------------------------------------------------------------------
# circuit breaker on a fake clock
# ---------------------------------------------------------------------------


def _breaker(threshold=3, interval=10.0):
    clock = {"t": 0.0}
    b = faults.CircuitBreaker(threshold=threshold, probe_interval_s=interval,
                              clock=lambda: clock["t"], name="test")
    return b, clock


def test_breaker_opens_after_threshold():
    b, _ = _breaker(threshold=3)
    err = faults.TransientDeviceError("x")
    assert not b.note_failure(err)
    assert not b.note_failure(err)
    assert b.note_failure(err)
    assert b.state == faults.OPEN
    with pytest.raises(faults.Degraded, match="next probe"):
        b.allow()


def test_breaker_success_resets_and_others_do_not_count():
    b, _ = _breaker(threshold=2)
    b.note_failure(faults.TransientDeviceError("x"))
    b.note_success()
    assert not b.note_failure(faults.TransientDeviceError("x"))
    b.note_failure(ValueError("bad request"))
    b.note_failure(faults.ResourceExhausted("oom"))
    assert b.state == faults.CLOSED
    assert b.note_failure(faults.TransientDeviceError("x"))


def test_breaker_half_open_probe_then_close_or_reopen():
    b, clock = _breaker(threshold=1, interval=5.0)
    b.note_failure(faults.TransientDeviceError("x"))
    clock["t"] = 6.0
    assert b.allow() is True
    assert b.state == faults.HALF_OPEN
    with pytest.raises(faults.Degraded):
        b.allow()
    assert b.note_failure(faults.TransientDeviceError("y"))
    clock["t"] = 10.0  # re-armed at t=6
    with pytest.raises(faults.Degraded):
        b.allow()
    clock["t"] = 11.5
    assert b.allow() is True
    b.note_success()
    assert b.state == faults.CLOSED and b.allow() is False
    doc = b.to_doc()
    assert (doc["state"], doc["opens"], doc["threshold"]) == (
        faults.CLOSED, 2, 1)


def test_breaker_defaults_from_flags():
    config.set_flag("BREAKER_THRESHOLD", "4")
    config.set_flag("BREAKER_PROBE_S", "0.25")
    b = faults.CircuitBreaker()
    assert (b.threshold, b.probe_interval_s) == (4, 0.25)


def test_default_probe_fires_serve_accept():
    config.set_flag("FAULTS", "serve_accept:transient:1:1")
    with pytest.raises(faults.TransientDeviceError):
        faults.default_probe("cpu")


# ---------------------------------------------------------------------------
# fault-injected wire plans in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", EDGES)
@pytest.mark.parametrize("site", ("dispatch", "serde", "kernel"))
def test_transient_faults_same_bytes_stats_and_counters(site, n):
    wire = _fact_wire(n, seed=n)
    for name, value in (("KERNELS", "on"), ("METRICS", "1"),
                        ("RETRY_BASE_MS", "1")):
        _both(name, value)
    clean = _jax(ROWS_CHAIN, wire)
    assert _port(ROWS_CHAIN, wire) == clean
    jmetrics.reset()
    metrics.reset()
    # a certain first injection, then a seeded stream
    _both("FAULTS", f"seed={n},{site}:transient:1:1,{site}:transient:0.5:2")
    got_j = _jax(ROWS_CHAIN, wire)
    got_p = _port(ROWS_CHAIN, wire)
    assert got_j == clean and got_p == clean
    stats = faults.injection_stats()
    assert stats == jfaults.injection_stats()
    keys = ["retry.attempts", "retry.giveups", "faults.injected"]
    assert metrics.counter_values(keys) == jmetrics.counter_values(keys)
    # an injected kernel fault: the JAX tier replays the op on its exact
    # path, the port retries the same runner
    j = jmetrics.counter_values(["kernel.fallbacks", "kernel.launches"])
    c = metrics.counter_values(keys + ["kernel.retries", "kernel.fallbacks",
                                       "kernel.launches"])
    assert c["kernel.retries"] == j["kernel.fallbacks"]
    assert c["kernel.launches"] == j["kernel.launches"] + j["kernel.fallbacks"]
    assert c["kernel.fallbacks"] == 0
    assert c["faults.injected"] >= 1
    assert (c["retry.attempts"] + c["kernel.retries"]
            == c["faults.injected"])


@pytest.mark.parametrize("n", EDGES)
def test_all_sites_armed_on_the_cells_plan(n):
    """Transient faults at dispatch, serde and kernel together over the
    slice's whole plan (the kernel tier on): both packages give the
    fault-free bytes, and the port's retries account for every
    injection."""
    wire = _fact_wire(n, seed=7 * n)
    for name, value in (("KERNELS", "on"), ("METRICS", "1"),
                        ("RETRY_BASE_MS", "1")):
        _both(name, value)
    clean = _jax(QTY_BY_DATE, wire)
    assert _port(QTY_BY_DATE, wire) == clean
    metrics.reset()
    _both("FAULTS", f"seed={n},dispatch:transient:0.4:3,serde:transient:0.5:2"
          ",kernel:transient:0.6:2")
    assert _jax(QTY_BY_DATE, wire) == clean
    assert _port(QTY_BY_DATE, wire) == clean
    c = metrics.counter_values(["retry.attempts", "kernel.retries",
                                "faults.injected", "retry.giveups",
                                "kernel.fallbacks"])
    injected = sum(r["injected"] for r in faults.injection_stats().values())
    assert c["faults.injected"] == injected > 0
    assert c["retry.attempts"] + c["kernel.retries"] == injected
    assert c["retry.giveups"] == 0 and c["kernel.fallbacks"] == 0


@pytest.mark.parametrize("kind", ("transient", "oom"))
@pytest.mark.parametrize("site", ("dispatch", "serde"))
def test_recoverable_kinds_byte_parity(site, kind):
    config.set_flag("RETRY_BASE_MS", "1")
    wire = _cols_wire(1024)
    want = _jax(ROW_LOCAL_CHAIN, wire)
    config.set_flag("FAULTS", f"seed=5,{site}:{kind}:1:1")
    assert _port(ROW_LOCAL_CHAIN, wire) == want
    assert faults.injection_stats()[f"{site}:{kind}"]["injected"] == 1


@pytest.mark.parametrize("n", EDGES)
def test_oom_chunks_a_row_local_op_in_both(n):
    wire = _cols_wire(n, seed=1)
    _both("METRICS", "1")
    _both("RETRY_BASE_MS", "1")
    want = _jax(ROW_LOCAL_CHAIN, wire)
    jmetrics.reset()
    metrics.reset()
    _both("FAULTS", "seed=3,dispatch:oom:1:1")
    assert _jax(ROW_LOCAL_CHAIN, wire) == want
    assert _port(ROW_LOCAL_CHAIN, wire) == want
    for m in (metrics, jmetrics):
        assert m.counter_values(["plan.chunked_segments"]) == {
            "plan.chunked_segments": 1}


def test_oom_on_a_global_op_never_chunks():
    """The first injection hits the sort, which is not row-local: it
    retries whole (a chunked sort would be locally sorted garbage)."""
    wire = _cols_wire(1024)
    config.set_flag("METRICS", "1")
    config.set_flag("RETRY_BASE_MS", "1")
    sort_first = GLOBAL_CHAIN[::-1]
    want = _jax(sort_first, wire)
    metrics.reset()
    config.set_flag("FAULTS", "seed=3,dispatch:oom:1:1")
    assert _port(sort_first, wire) == want
    c = metrics.counter_values(["plan.chunked_segments", "retry.attempts"])
    assert c == {"plan.chunked_segments": 0, "retry.attempts": 1}


def test_transient_exhaustion_gives_up_typed():
    config.set_flag("RETRY_BASE_MS", "0.1")
    config.set_flag("RETRY_MAX", "2")
    config.set_flag("METRICS", "1")
    metrics.reset()
    config.set_flag("FAULTS", "dispatch:transient:1")
    with pytest.raises(faults.TransientDeviceError, match="injected"):
        _port(ROW_LOCAL_CHAIN, _cols_wire(256))
    # the fused [filter, cast] segment retries twice, then its replay's
    # first op twice more and gives up
    assert metrics.counter_values(["retry.attempts", "retry.giveups"]) == {
        "retry.attempts": 4, "retry.giveups": 1}


def test_permanent_fault_surfaces_typed_in_both():
    _both("FAULTS", "dispatch:permanent:1")
    with pytest.raises(jfaults.PermanentError):
        _jax(ROW_LOCAL_CHAIN, _cols_wire(256))
    with pytest.raises(faults.PermanentError, match="injected permanent"):
        _port(ROW_LOCAL_CHAIN, _cols_wire(256))


def test_injection_is_metered():
    config.set_flag("METRICS", "1")
    config.set_flag("RETRY_BASE_MS", "1")
    metrics.reset()
    config.set_flag("FAULTS", "seed=5,serde:transient:1:1")
    _port(ROW_LOCAL_CHAIN, _cols_wire(512))
    c = metrics.snapshot()["counters"]
    assert c["faults.injected"] == 1
    assert c["faults.injected.serde.transient"] == 1
    assert c["retry.attempts"] == 1


def test_consumed_input_is_never_retried(monkeypatch):
    """At-most-once: a failure after the input's storage was consumed
    surfaces as-is, one attempt, no retry."""
    config.set_flag("METRICS", "1")
    metrics.reset()
    calls = {"n": 0}

    def launch_then_die(op, table, rest, name):
        calls["n"] += 1
        raise RuntimeError("UNAVAILABLE: device lost after launch")

    monkeypatch.setattr(rb, "_dispatch_once", launch_then_die)
    # the chain is one fused segment: its run dies the same way
    monkeypatch.setattr(plan_mod, "_run_fused",
                        lambda ops, t: launch_then_die(ops, t, (), "plan"))
    monkeypatch.setattr(plan_mod, "_input_consumed", lambda t: True)
    with pytest.raises(RuntimeError, match="device lost after launch"):
        _port(ROW_LOCAL_CHAIN, _cols_wire(1024))
    assert calls["n"] == 1
    assert metrics.counter_values(["retry.attempts"])["retry.attempts"] == 0


def test_kernel_runner_failure_still_raises(monkeypatch):
    """A failure of the runner itself raises, armed plan or not: it is
    neither retried nor replayed on the exact path."""
    config.set_flag("KERNELS", "on")
    config.set_flag("METRICS", "1")
    # op by op: in a fused segment the groupby meets no tier
    config.set_flag("BUCKETS", "off")
    config.set_flag("FAULTS", "seed=1,dispatch:transient:0")
    metrics.reset()
    def boom(op, table, rest):
        raise RuntimeError("runner failed")

    specs = [dataclasses.replace(s, runner=boom)
             for s in registry._BY_OP["groupby"]]
    monkeypatch.setitem(registry._BY_OP, "groupby", specs)
    with pytest.raises(RuntimeError, match="runner failed"):
        _port(QTY_BY_DATE, _fact_wire(1024, 3))
    assert metrics.counter_values(["kernel.fallbacks", "kernel.retries"]) == {
        "kernel.fallbacks": 0, "kernel.retries": 0}


def test_injected_kernel_fault_falls_back_exactly(monkeypatch):
    """An injected ``kernel`` fault retries the same runner: the same
    bytes, every route still launched, and no op taken over by the exact
    path (the ops that reach it are those of the fault-free run)."""
    wire = _fact_wire(1025, 5)
    config.set_flag("KERNELS", "on")
    config.set_flag("METRICS", "1")
    exact = []
    impl = rb._dispatch_impl

    def recording(op, table, rest, name):
        exact.append(name)
        return impl(op, table, rest, name)

    monkeypatch.setattr(rb, "_dispatch_impl", recording)
    want = _port(QTY_BY_DATE, wire)
    exact_clean, exact[:] = list(exact), []
    metrics.reset()
    config.set_flag("FAULTS", "kernel:oom:1")
    assert _port(QTY_BY_DATE, wire) == want
    assert exact == exact_clean
    assert "groupby" not in exact
    # from_rows and to_rows: the groupby closes the fused [filter, cast,
    # groupby] segment, where the tier is not consulted
    c = metrics.counter_values(["kernel.fallbacks", "kernel.launches",
                                "kernel.retries"])
    assert c == {"kernel.fallbacks": 0, "kernel.launches": 2,
                 "kernel.retries": 2}


# ---------------------------------------------------------------------------
# the disabled path's cost
# ---------------------------------------------------------------------------


def test_disabled_inject_and_check_cancel_cost():
    assert not faults.active()
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        faults.inject("dispatch")
        faults.check_cancel()
    per = (time.perf_counter() - t0) / (2 * n)
    assert per < 5e-6, f"disabled fault plane costs {per * 1e6:.2f} us"
