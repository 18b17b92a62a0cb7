"""The port's plan-statistics store (``utils/planstats.py``) against the
JAX package's, on the CPU.

* ``plan_fingerprint`` is equal for the same plan.
* Equal session docs give equal records, the drift findings included,
  over one seeded history; ``drift_report``, ``render_drift`` and
  ``summary`` over the two stores are equal.
* Each package's ``read_stats_file``/``load`` reads the other's file byte
  for byte, a torn tail at every cut included; rotation keeps one old
  generation in both.
* A profile session of a port plan appends its record, with the static
  prediction, and shows no segmentation drift.
"""

import json
import os

import numpy as np
import pytest

from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import metrics as jmetrics
from spark_rapids_jni_tpu.utils import planstats as jplanstats
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.utils import config, metrics, planstats, profiler

from test_torch_wire_plan import QTY_BY_DATE, _fact_rows, _list_wire

FLAGS = ("PLANSTATS", "PLANSTATS_DIR", "PLANSTATS_ROTATE_MB",
         "DRIFT_ROWS_FACTOR", "DRIFT_HBM_FACTOR", "PROFILE", "METRICS")


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    for f in FLAGS:
        monkeypatch.delenv("SPARK_RAPIDS_TPU_" + f, raising=False)
    # A session record diffs the metrics registry against its base, so
    # counters left by an earlier test file on the worker must not reach it.
    metrics.reset()
    jmetrics.reset()
    planstats.reset()
    jplanstats.reset()
    profiler.reset()
    config.set_flag("PLANSTATS_DIR", str(tmp_path / "port"))
    jconfig.set_flag("PLANSTATS_DIR", str(tmp_path / "jax"))
    yield
    for f in FLAGS:
        config.clear_flag(f)
        jconfig.clear_flag(f)
    metrics.reset()
    jmetrics.reset()
    planstats.reset()
    jplanstats.reset()
    profiler.reset()


@pytest.mark.parametrize("plan", [
    QTY_BY_DATE, [], [{"op": "filter", "mask": 1}],
    [{"b": 2, "a": [1, {"y": None, "x": 1.5}]}], "not a list", None])
def test_fingerprint_matches_jax(plan):
    assert planstats.plan_fingerprint(plan) == jplanstats.plan_fingerprint(plan)


def _docs(seed: int, n: int = 14) -> list:
    """A seeded history of finished-session docs of two plans: steady
    row counts, a skewed run, a static-bound overrun, a working set past
    its estimate, a segmentation change and a mesh run."""
    rng = np.random.default_rng(seed)
    pred = {"segments": [
        {"kind": "exact", "ops": [0], "rows_bound": 1000, "est_hbm_bytes": 9000},
        {"kind": "fused", "ops": [1, 2], "rows_bound": 1000,
         "est_hbm_bytes": 40000}],
        "rows_out_bound": 1000, "est_hbm_peak_bytes": 40000,
        "kernel_ops": [0]}
    out = []
    for i in range(n):
        rows = int(rng.integers(90, 110))
        if i == 9:
            rows *= 40  # skewed against the history; past the bound too
        width = 64 if i != 11 else 4000  # a working set past its estimate
        kinds = ["exact", "fused"] if i != 12 else ["exact", "exact"]
        if i == 13:
            kinds = ["mesh"]
        segs = [{"index": j, "kind": k, "ops": ["from_rows"] if j == 0
                 else ["filter", "groupby"], "calls": 1,
                 "wall_s": float(rng.random()) / 100, "compile_s": 0.0,
                 "execute_s": 0.001, "rows_in": 1000, "rows_out": rows,
                 "out_bytes": rows * width}
                for j, k in enumerate(kinds)]
        out.append({
            "version": 1, "session_id": f"s{seed}-{i}",
            "label": "plan_wire" if i % 3 else "stream", "pid": 100 + i,
            "host": "h", "epoch_ns": 10 ** 18 + i, "wall_s": 0.02,
            "plan": QTY_BY_DATE if i % 5 else [{"op": "filter", "mask": 1}],
            "segments": segs,
            "boundary": {"serde_bytes_in": 1000 * i, "serde_bytes_out": 10},
            "schema": "LIST<UINT8>", "bucket": 1024 if i % 2 else None,
            "pred": pred, "batches": 2 if i % 3 == 0 else None})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_records_and_reports_match_jax(seed):
    _records_and_reports_match_jax(seed)


@pytest.mark.parametrize("step", ["leave", "parity"])
def test_parity_after_counters_left_behind(step):
    """An earlier test on the worker that ran with ``METRICS`` on leaves
    counters in both registries (``leave``); the parity body that runs
    after it (``parity``, the next case in file order) must not see them."""
    if step == "leave":
        config.set_flag("METRICS", True)
        jconfig.set_flag("METRICS", True)
        # Different counters in each: the two records would differ.
        jmetrics.counter_add("mesh.degraded", 11)
        jmetrics.counter_add("shuffle.exchanges", 6)
        metrics.counter_add("retry.attempts", 2)
        assert jmetrics.counter_values(["mesh.degraded"]) == {
            "mesh.degraded": 11}
        assert metrics.counter_values(["retry.attempts"]) == {
            "retry.attempts": 2}
        return
    _records_and_reports_match_jax(0)


def _records_and_reports_match_jax(seed):
    config.set_flag("PLANSTATS", True)
    jconfig.set_flag("PLANSTATS", True)
    planstats.note_skew({"site": "distributed.groupby", "action": "split",
                         "factor": 2.0, "k": 4, "hot_destinations": [1],
                         "max_recv": 900, "mean_recv": 100.0, "ratio": 9.0,
                         "post_max_recv": 200, "post_mean_recv": 100.0,
                         "post_ratio": 2.0, "devices": 4})
    jplanstats.note_skew(dict(planstats._PENDING_SKEW[0]["event"]))
    for doc in _docs(seed):
        base = {"spill.evictions": 1, "retry.attempts": 0}
        got = planstats.record_session(doc, base)
        want = jplanstats.record_session(doc, base)
        assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                             sort_keys=True)
    types = {f["type"] for r in planstats.load() for f in r.get("drift", ())}
    assert {"cardinality", "hbm", "segmentation", "skew"} <= types
    report = planstats.drift_report()
    assert report == jplanstats.drift_report()
    assert planstats.render_drift(report) == jplanstats.render_drift(report)
    assert planstats.summary() == jplanstats.summary()
    stats = planstats.stats_doc()
    jstats = jplanstats.stats_doc()
    assert stats == jstats


def _one_file(tmp_path, mod, conf, name):
    conf.set_flag("PLANSTATS", True)
    for doc in _docs(3, 6):
        mod.record_session(doc)
    (path,) = [os.path.join(str(tmp_path / name), f)
               for f in os.listdir(tmp_path / name)]
    return path


def test_each_package_reads_the_others_file(tmp_path):
    mine = _one_file(tmp_path, planstats, config, "port")
    theirs = _one_file(tmp_path, jplanstats, jconfig, "jax")
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (mine, theirs):
        assert planstats.read_stats_file(path) == jplanstats.read_stats_file(
            path)
    assert planstats.load(str(tmp_path / "jax")) == jplanstats.load(
        str(tmp_path / "port"))


def test_torn_tails_read_the_same(tmp_path):
    path = _one_file(tmp_path, planstats, config, "port")
    blob = open(path, "rb").read()
    cut_dir = tmp_path / "cuts"
    cut_dir.mkdir()
    for cut in sorted({0, 3, 6, 7, 14, len(blob) // 2, len(blob) - 1}):
        p = str(cut_dir / f"planstats-cut-{cut}.wal")
        with open(p, "wb") as f:
            f.write(blob[:cut])
        assert planstats.read_stats_file(p) == jplanstats.read_stats_file(p)
    mid = bytearray(blob)
    mid[20] ^= 0xFF  # corrupt the first record's payload
    p = str(cut_dir / "planstats-mid.wal")
    with open(p, "wb") as f:
        f.write(bytes(mid))
    assert planstats.read_stats_file(p) == jplanstats.read_stats_file(p)


def test_rotation_keeps_one_old_generation(tmp_path):
    for mod, conf, name in ((planstats, config, "port"),
                            (jplanstats, jconfig, "jax")):
        conf.set_flag("PLANSTATS", True)
        conf.set_flag("PLANSTATS_ROTATE_MB", 0.002)
        for doc in _docs(4, 14):
            mod.record_session(doc)
    names = {n: sorted(os.listdir(tmp_path / n)) for n in ("port", "jax")}
    assert [n.rsplit(".", 1)[-1] for n in names["port"]] == [
        n.rsplit(".", 1)[-1] for n in names["jax"]] == ["wal", "1"]
    assert planstats.load() == jplanstats.load()
    assert (planstats.stats_doc()["planstats.rotations"]
            == jplanstats.stats_doc()["planstats.rotations"] > 0)


def test_a_port_plan_appends_its_record_without_segmentation_drift():
    config.set_flag("PLANSTATS", True)
    wire = _list_wire(_fact_rows(300, 5))
    for _ in range(3):
        rb.table_plan_wire(json.dumps(QTY_BY_DATE), *wire, device="cpu")
    recs = planstats.load()
    assert len(recs) == 3
    assert recs[0]["pred"]["segments"][1]["kind"] == "fused"
    assert [s["kind"] for s in recs[0]["segments"]] == [
        s["kind"] for s in recs[0]["pred"]["segments"]]
    report = planstats.drift_report()
    assert not [f for g in report["groups"] for f in g["findings"]
                if f["type"] == "segmentation"]
    assert report["groups"][0]["runs"] == 3
