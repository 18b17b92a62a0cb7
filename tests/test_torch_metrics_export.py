"""The rest of the port's ``utils/metrics.py`` against the JAX package's,
on the CPU, and the public names of every module of the observability
tier.

* The same mutations give equal snapshots and equal ``prometheus_text``.
* ``dump`` writes the JAX package's schema; ``METRICS_DUMP`` writes it at
  exit (with ``PROFILE_DUMP`` in the same child process).
* Spans stamp their flight ``B``/``E`` events with the active
  traceparent, under qualified names; ``traced``, ``span_depth`` and
  ``span_stack`` behave as the JAX package's.
"""

import importlib
import inspect
import json
import os
import subprocess
import sys

import pytest

from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import metrics as jmetrics
from spark_rapids_jni_tpu_torch.utils import config, flight, metrics, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("METRICS", "METRICS_DUMP", "FLIGHT", "PLANSTATS", "TRACE")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for f in FLAGS:
        monkeypatch.delenv("SPARK_RAPIDS_TPU_" + f, raising=False)
    metrics.reset()
    jmetrics.reset()
    flight.reset()
    yield
    for f in FLAGS:
        config.clear_flag(f)
        jconfig.clear_flag(f)
    metrics.reset()
    jmetrics.reset()
    flight.reset()


def _public(mod) -> set:
    """A module's public names: what it defines, not what it imports."""
    out = set()
    for name, v in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(v):
            continue
        owner = getattr(v, "__module__", None)
        plain = isinstance(v, (int, float, str, tuple, frozenset, dict, list))
        if owner is not None and not plain and owner != mod.__name__:
            continue
        out.add(name)
    return out


@pytest.mark.parametrize("name", [
    "utils.flight", "utils.tracing", "utils.lockcheck", "utils.metrics",
    "utils.profiler", "utils.planstats", "plancheck"])
def test_public_names_equal_the_jax_modules(name):
    port = importlib.import_module("spark_rapids_jni_tpu_torch." + name)
    jax_mod = importlib.import_module("spark_rapids_jni_tpu." + name)
    assert _public(port) == _public(jax_mod)
    assert (sorted(getattr(port, "__all__", ()))
            == sorted(getattr(jax_mod, "__all__", ())))


def test_runtime_bridge_has_the_jax_leak_report_and_platform():
    from spark_rapids_jni_tpu import runtime_bridge as jrb
    from spark_rapids_jni_tpu_torch import runtime_bridge as rb

    for name in ("leak_report", "platform", "resident_table_count"):
        assert callable(getattr(rb, name)) and callable(getattr(jrb, name))
    assert rb.platform("cpu") == "cpu"


def _mutate(mod):
    mod.counter_add("op.sort_by.calls", 3)
    mod.counter_add("resident.put")
    mod.bytes_add("wire.in_bytes", 1 << 20)
    mod.gauge_set("resident.live", 4)
    mod.gauge_set("resident.live", 2)
    mod.timer_record("dispatch.sort_by", 0.25)
    mod.timer_record("dispatch.sort_by", 0.5)
    mod.self_time_record("dispatch.sort_by", 0.125)
    mod.self_time_record("plan", -1.0)
    for v in (0, 1, 3, 17, 70_000, 10 ** 12):
        mod.hist_observe("dispatch.rows_in", v)
    mod.hist_observe("span_ms.x", 0.02, bounds=mod.SPAN_MS_BOUNDS)


@pytest.mark.parametrize("flag", ["METRICS", "METRICS_DUMP", "PLANSTATS"])
def test_snapshot_and_prometheus_text_match_jax(flag, tmp_path):
    value = str(tmp_path / "m.json") if flag == "METRICS_DUMP" else "on"
    config.set_flag(flag, value)
    jconfig.set_flag(flag, value if flag == "METRICS_DUMP" else True)
    _mutate(metrics)
    _mutate(jmetrics)
    snap = metrics.snapshot()
    assert snap == jmetrics.snapshot()
    text = metrics.prometheus_text()
    assert text == jmetrics.prometheus_text() == jmetrics.prometheus_text(snap)
    assert "srt_op_sort_by_calls_total 3" in text
    assert 'srt_dispatch_rows_in_bucket{le="+Inf"} 6' in text
    assert metrics.prometheus_text({}) == jmetrics.prometheus_text({}) == ""


def test_disabled_plane_records_nothing():
    _mutate(metrics)
    assert metrics.snapshot() == jmetrics.snapshot()
    assert all(not v for v in metrics.snapshot().values())


def test_dump_has_the_jax_schema(tmp_path, capsys):
    config.set_flag("METRICS", "on")
    jconfig.set_flag("METRICS", True)
    _mutate(metrics)
    _mutate(jmetrics)
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    assert metrics.dump(str(a)) == str(a)
    assert jmetrics.dump(str(b)) == str(b)
    assert a.read_text() == b.read_text()
    assert metrics.dump("/nonexistent-dir/x/m.json") is None
    assert "metrics dump" in capsys.readouterr().err


def test_spans_stamp_the_active_traceparent():
    config.set_flag("FLIGHT", "on")
    ctx = tracing.new_context()
    with tracing.activate(ctx):
        with metrics.span("outer"):
            assert metrics.span_depth() == 1
            with metrics.span("inner"):
                assert metrics.span_stack() == ("outer", "outer/inner")
    with pytest.raises(ValueError):
        with metrics.span("failing"):
            raise ValueError("x")
    evs = [(e["ph"], e["name"], e.get("arg")) for e in flight.tail_records()]
    assert evs == [("B", "outer", ctx.header), ("B", "outer/inner", ctx.header),
                   ("E", "outer/inner", None), ("E", "outer", None),
                   ("B", "failing", None), ("E", "failing", "ValueError")]
    assert metrics.span_depth() == 0 and metrics.span_stack() == ()
    # FLIGHT alone opens spans, but the registry stays off
    assert metrics.snapshot()["timers"] == {}


def test_traced_names_and_self_time():
    config.set_flag("METRICS", "on")
    jconfig.set_flag("METRICS", True)

    def body(mod):
        @mod.traced()
        def leaf():
            return mod.span_stack()

        @mod.traced("named.outer")
        def outer():
            return leaf()

        return outer()

    got, want = body(metrics), body(jmetrics)
    assert got[0] == want[0] == "named.outer"
    assert got[1].endswith("body.<locals>.leaf")
    assert set(metrics.snapshot()["span_self"]) == set(
        jmetrics.snapshot()["span_self"])


def test_dumps_at_exit_in_a_child(tmp_path):
    """``METRICS_DUMP`` and ``PROFILE_DUMP`` alone turn their planes on
    and write at exit; the profile dump reads back in the JAX package's
    ``merge_sessions``."""
    from spark_rapids_jni_tpu.utils import profiler as jprofiler

    mpath, ppath = tmp_path / "metrics.json", tmp_path / "profile.json"
    code = (
        "import json\n"
        "import numpy as np\n"
        "from spark_rapids_jni_tpu_torch import runtime_bridge as rb\n"
        "k = np.arange(2000, dtype=np.int64) % 7\n"
        "plan = [{'op': 'sort_by', 'keys': [{'column': 0}]}]\n"
        "rb.table_plan_wire(json.dumps(plan), [4], [0], [k.tobytes()],\n"
        "                   [None], 2000, device='cpu')\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_TPU_METRICS_DUMP=str(mpath),
               SPARK_RAPIDS_TPU_PROFILE_DUMP=str(ppath))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == ""
    snap = json.loads(mpath.read_text())
    assert set(snap) == set(jmetrics.snapshot())
    assert snap["counters"]["plan.calls"] == 1
    merged = jprofiler.merge_sessions([json.loads(ppath.read_text())])
    (sess,) = merged["sessions"]
    assert sess["label"] == "plan_wire"
    assert [s["ops"] for s in sess["segments"]] == [["sort_by"]]
