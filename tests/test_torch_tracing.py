"""The port's trace plane (``utils/tracing.py``) against the JAX
package's, on the CPU.

* The traceparent wire form parses and formats the same in both.
* ``assign_trace_ids``, ``trace_span_records``, ``to_chrome_trace`` and
  ``merge_chrome_traces`` over one seeded event list give equal JSON.
* The JAX package's ``tools/tracequery.py`` reads a dump the port wrote.
* ``trace_range`` opens no ``record_function`` and no NVTX range while
  ``TRACE`` is off, counted under ``torch.profiler`` over a plan run;
  with it on the plan's spans open ranges under the JAX package's
  qualified names, and ``capture_trace`` leaves a Chrome trace.
* A disabled ``span_begin``/``span_end`` pair stays within 2x of a
  disabled ``flight.record()`` (the JAX tests' bound).
* The slow-request log keeps the same records, and the pipeline carries
  a trace context onto its workers and into a replay.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import flight as jflight
from spark_rapids_jni_tpu.utils import tracing as jtracing
from spark_rapids_jni_tpu_torch import pipeline
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.utils import config, flight, metrics, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("FLIGHT", "TRACE", "METRICS", "TRACE_SLO_MS", "TRACE_TOPK")
TRACE = "00-" + "4bf92f3577b34da6a3ce929d0e0e4736" + "-" + "00f067aa0ba902b7" + "-01"
PLAN = [{"op": "filter", "mask": 2}, {"op": "sort_by", "keys": [{"column": 0}]},
        {"op": "groupby", "by": [0], "aggs": [{"column": 1, "agg": "sum"}]}]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for f in FLAGS:
        monkeypatch.delenv("SPARK_RAPIDS_TPU_" + f, raising=False)
    for mod in (flight, jflight):
        mod.reset()
    tracing.reset_requests()
    jtracing.reset_requests()
    before = len(rb._RESIDENT)
    yield
    for f in FLAGS:
        config.clear_flag(f)
        jconfig.clear_flag(f)
    for mod in (flight, jflight):
        mod.reset()
    metrics.reset()
    assert len(rb._RESIDENT) == before


def _both(flag, value):
    config.set_flag(flag, value)
    jconfig.set_flag(flag, value)


def _wire(n: int = 1025, seed: int = 0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 30, n).astype(np.int64)
    v = rng.integers(-100, 100, n).astype(np.int64)
    m = (rng.random(n) > 0.3).astype(np.uint8)
    return ([4, 4, 11], [0, 0, 0], [k.tobytes(), v.tobytes(), m.tobytes()],
            [None, None, None], n)


@pytest.mark.parametrize("value", [
    TRACE, "  " + TRACE.upper() + " ", "01" + TRACE[2:], None, 42, "",
    "garbage", "00-abc-def-01", "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "ff-" + "1" * 32 + "-" + "2" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "2" * 16])
def test_traceparent_parse_matches_jax(value):
    got, want = tracing.parse_traceparent(value), jtracing.parse_traceparent(value)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id, got.header) == (
            want.trace_id, want.span_id, want.header)
        ctx = tracing.TraceContext(got.trace_id, got.span_id)
        assert tracing.format_traceparent(ctx) == jtracing.format_traceparent(
            jtracing.TraceContext(got.trace_id, got.span_id))


def _events(seed: int) -> list:
    """A seeded flight tail over three threads: nested span pairs, some
    tagged with a traceparent, errors on E, instants, numeric and string
    counter samples, an E whose B fell off the ring and a B never
    closed."""
    rng = np.random.default_rng(seed)
    traces = [f"00-{rng.bytes(16).hex()}-{rng.bytes(8).hex()}-01"
              for _ in range(2)]
    out, seq, t = [], 0, 1_000
    stacks = {11: [], 22: [], 33: []}
    out.append({"seq": seq, "t_ns": t, "tid": 22, "ph": "E",
                "name": "wire.deserialize"})
    for _ in range(60):
        seq += 1
        t += int(rng.integers(1, 5_000))
        tid = int(rng.choice([11, 22, 33]))
        st = stacks[tid]
        r = rng.random()
        if r < 0.35 or not st:
            name = ("dispatch.sort_by" if not st
                    else st[-1] + "/" + str(rng.choice(["bucketed.x", "kernel.y"])))
            ev = {"seq": seq, "t_ns": t, "tid": tid, "ph": "B", "name": name}
            if not st and rng.random() < 0.7:
                ev["arg"] = traces[int(rng.integers(0, 2))]
            st.append(name)
        elif r < 0.65:
            ev = {"seq": seq, "t_ns": t, "tid": tid, "ph": "E",
                  "name": st.pop()}
            if rng.random() < 0.2:
                ev["arg"] = "ValueError"
        elif r < 0.85:
            ev = {"seq": seq, "t_ns": t, "tid": tid, "ph": "I",
                  "name": "compile_cache.miss", "arg": int(rng.integers(0, 9))}
        else:
            ev = {"seq": seq, "t_ns": t, "tid": tid, "ph": "C",
                  "name": "resident.live",
                  "arg": int(rng.integers(0, 5)) if rng.random() < 0.8 else "x"}
        out.append(ev)
    return out, [tracing.parse_traceparent(h).trace_id for h in traces]


def _js(x):
    return json.dumps(x, sort_keys=True)


@pytest.mark.parametrize("seed", range(4))
def test_event_tools_match_jax(seed):
    evs, trace_ids = _events(seed)
    assert _js(tracing.assign_trace_ids(evs)) == _js(jtracing.assign_trace_ids(evs))
    for tid in trace_ids:
        assert _js(tracing.trace_span_records(evs, tid)) == _js(
            jtracing.trace_span_records(evs, tid))
    for kw in ({}, {"pid": 7, "process_name": "h:7", "process_sort_index": 2,
                    "t0_ns": 500}):
        assert _js(tracing.to_chrome_trace(evs, **kw)) == _js(
            jtracing.to_chrome_trace(evs, **kw))
    dumps = [{"pid": 5, "host": "a", "epoch_ns": 10 ** 18, "anchor_perf_ns": 0,
              "events": evs, "session_id": "s" * 16},
             {"pid": 5, "host": "b", "epoch_ns": 10 ** 18 + 99,
              "anchor_perf_ns": 3, "events": _events(seed + 10)[0]}]
    assert _js(tracing.merge_chrome_traces(dumps)) == _js(
        jtracing.merge_chrome_traces(dumps))


def test_tracequery_reads_the_ports_dump(tmp_path, capsys):
    """A plan run under one context: the JAX package's ``tracequery``
    lists its trace and renders the plan's span tree from the port's
    dump."""
    config.set_flag("FLIGHT", "on")
    ctx = tracing.new_context()
    with tracing.activate(ctx):
        out = rb.table_plan_wire(json.dumps(PLAN), *_wire(), device="cpu")
    assert out[4] > 0
    path = str(tmp_path / "flight.json")
    assert flight.dump(path) == path
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import tracequery
    finally:
        sys.path.pop(0)
    capsys.readouterr()
    assert tracequery.main([path, "--list", "--json"]) == 0
    listed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [t["trace_id"] for t in listed] == [ctx.trace_id]
    assert tracequery.main([path, "--trace", ctx.trace_id[:10], "--json"]) == 0
    names = {json.loads(line)["name"]
             for line in capsys.readouterr().out.splitlines()}
    assert {"plan", "plan/plan.segment", "wire.deserialize",
            "wire.serialize"} <= names


def _range_names(fn) -> list:
    """Names of every ``record_function`` range ``fn`` opened, from a CPU
    ``torch.profiler`` capture."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()
            if e.name.startswith(("plan", "wire.", "dispatch.", "bucketed.",
                                  "pipeline.", "stream", "kernel."))]


@pytest.mark.parametrize("planes", [(), ("METRICS",), ("FLIGHT", "METRICS")])
def test_no_range_opens_while_trace_is_off(planes):
    for f in planes:
        config.set_flag(f, "on")
    assert _range_names(lambda: rb.table_plan_wire(
        json.dumps(PLAN), *_wire(), device="cpu")) == []


def test_ranges_open_under_the_jax_names_with_trace_on():
    config.set_flag("TRACE", "on")
    got = set(_range_names(lambda: rb.table_plan_wire(
        json.dumps(PLAN), *_wire(), device="cpu")))
    assert {"plan", "plan/plan.segment", "wire.deserialize",
            "wire.serialize"} <= got


@pytest.mark.parametrize("on", [False, True])
def test_nvtx_ranges_follow_the_flag(on, monkeypatch):
    """On a CUDA device every range also pushes an NVTX range; with the
    flag off none is pushed (counted with the NVTX calls replaced)."""
    pushed = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: pushed.append(name))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: pushed.append(None))
    if on:
        config.set_flag("TRACE", "on")
    else:
        config.set_flag("METRICS", "on")
    with metrics.span("outer"):
        with tracing.trace_range("inner"):
            pass
    tracing.annotate("deco")(lambda: None)()
    assert pushed == (["outer", "inner", None, None, "deco", None] if on else [])


def test_capture_trace_writes_a_chrome_trace(tmp_path, capsys):
    config.set_flag("TRACE", "on")
    with tracing.capture_trace(str(tmp_path / "cap")):
        rb.table_plan_wire(json.dumps(PLAN), *_wire(), device="cpu")
    files = os.listdir(tmp_path / "cap")
    assert len(files) == 1
    doc = json.loads((tmp_path / "cap" / files[0]).read_text())
    assert {"plan", "plan/plan.segment"} <= {
        e.get("name") for e in doc["traceEvents"]}
    assert "capture is empty" not in capsys.readouterr().err


def test_empty_capture_warns(tmp_path, capsys, monkeypatch):
    from torch.profiler import profile

    monkeypatch.setattr(profile, "export_chrome_trace", lambda self, p: None)
    with tracing.capture_trace(str(tmp_path / "empty")):
        pass
    assert "capture is empty" in capsys.readouterr().err


def test_disabled_span_pair_within_2x_of_disabled_record():
    assert not flight.enabled()
    iters = 100_000

    def best_of(fn, reps=5):
        fn()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, time.perf_counter() - t0)
        return best / iters

    record_s = best_of(lambda: flight.record("I", "overhead.probe"))
    pair_s = best_of(lambda: tracing.span_end(tracing.span_begin("p")))
    assert pair_s <= 2.0 * record_s + 200e-9, (pair_s, record_s)


def test_disabled_trace_range_is_a_shared_no_op():
    assert tracing.trace_range("a") is tracing.trace_range("b")


def test_slow_request_log_matches_jax():
    _both("TRACE", True)
    _both("TRACE_SLO_MS", 50.0)
    _both("TRACE_TOPK", 3)
    for mod in (tracing, jtracing):
        for i, (ms, err) in enumerate([(10, None), (80, None), (5, "Boom"),
                                       (60, None), (200, None), (1, None)]):
            mod.note_request(f"req{i}", ms, trace_id=f"t{i}", session="s",
                             error=err, spans=lambda i=i: [{"name": f"sp{i}"}])

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "t_s"} for r in recs]

    assert strip(tracing.slow_requests()) == strip(jtracing.slow_requests())
    assert [r["label"] for r in tracing.slow_requests()] == ["req4", "req1",
                                                             "req3"]


def test_pipeline_workers_and_replays_keep_the_trace():
    ctx = tracing.new_context()
    calls = []

    def work():
        calls.append(tracing.current_trace_id())
        if len(calls) == 1:
            raise RuntimeError("transient worker failure")
        return tracing.current_trace_id()

    with tracing.activate(ctx):
        p = pipeline.Pending(work, "probe")
    worker = threading.Thread(target=p._run)
    worker.start()
    worker.join(60)
    assert tracing.current() is None
    assert p.resolve() == ctx.trace_id  # the replay, on this thread
    assert calls == [ctx.trace_id, ctx.trace_id]
