"""The port's query profiler (``utils/profiler.py``) against the JAX
package's, on the CPU.

(h)'s plan (``[from_rows, filter, cast, groupby date, sort_by,
to_rows]``) runs through both packages' ``table_plan_wire`` at 256 rows
with ``PROFILE`` on. The session docs are equal in every segment's
index, kind, ops, calls, rows in and out, output bytes, fallbacks, pad
rows and waste, and in the boundary's wire bytes; times are not
compared, nor the runner-cache counts (the port's fused segment runs no
cached executable; ROADMAP Queue 3, "Recorded"), nor donated bytes: the
JAX package's fused executable donates its input buffers, the port
releases a consumed segment input's storages as the segment returns
(its own segment's ``donated_bytes``, every segment the plan owns), so
the two count different buffers. Each package's
``merge_sessions``/``summarize`` reads the other's dump, the segments
equal ``plancheck.predict_segments``, and every segment's splits sum to
its wall. A stream and a resident plan open their sessions, and an
explicit outer session owns nested plan runs.
"""

import json

import pytest

from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import profiler as jprofiler
from spark_rapids_jni_tpu_torch import plancheck
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.utils import config, profiler

from test_torch_wire_plan import QTY_BY_DATE, _fact_rows, _list_wire

FLAGS = ("PROFILE", "PROFILE_DUMP", "PIPELINE")
SEG_KEYS = ("index", "kind", "ops", "calls", "rows_in", "rows_out",
            "out_bytes", "fallbacks", "pad_rows", "pad_waste_bytes")
BOUNDARY_KEYS = ("serde_bytes_in", "serde_bytes_out", "fallbacks",
                 "pad_rows", "pad_waste_bytes", "shuffles", "shuffle_rows")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for f in FLAGS:
        monkeypatch.delenv("SPARK_RAPIDS_TPU_" + f, raising=False)
    profiler.reset()
    jprofiler.reset()
    before = (len(rb._RESIDENT), jrb.resident_table_count())
    yield
    for f in FLAGS:
        config.clear_flag(f)
        jconfig.clear_flag(f)
    profiler.reset()
    jprofiler.reset()
    assert (len(rb._RESIDENT), jrb.resident_table_count()) == before


@pytest.fixture(scope="module")
def sessions():
    """One (h)-plan run of each package with PROFILE on: their docs."""
    wire = _list_wire(_fact_rows(256, 7))
    plan = json.dumps(QTY_BY_DATE)
    profiler.reset()
    jprofiler.reset()  # sessions an earlier test file left
    config.set_flag("PROFILE", "on")
    jconfig.set_flag("PROFILE", "on")
    try:
        got_out = rb.table_plan_wire(plan, *wire, device="cpu")
        want_out = jrb.table_plan_wire(plan, *wire)
        got, want = profiler.sessions(reset=True), jprofiler.sessions(
            reset=True)
    finally:
        config.clear_flag("PROFILE")
        jconfig.clear_flag("PROFILE")
    assert tuple(got_out) == tuple(want_out)
    assert len(got) == len(want) == 1
    return got[0], want[0]


def _proj(doc):
    return ([{k: s[k] for k in SEG_KEYS} for s in doc["segments"]],
            {k: doc["boundary"][k] for k in BOUNDARY_KEYS})


def test_session_docs_match_jax(sessions):
    got, want = sessions
    assert _proj(got) == _proj(want)
    for key in ("label", "plan", "schema", "bucket", "pred", "version"):
        assert got.get(key) == want.get(key), key


def test_segments_are_the_predicted_ones_and_splits_sum(sessions):
    got, _ = sessions
    pred = plancheck.predict_segments(QTY_BY_DATE)
    assert [(s["index"], s["kind"], s["ops"]) for s in got["segments"]] == [
        (i, kind, [QTY_BY_DATE[j]["op"] for j in idx])
        for i, (kind, idx) in enumerate(pred)]
    for s in got["segments"]:
        parts = s["execute_s"] + s["compile_s"] + s["serde_s"] + s["stall_s"]
        assert abs(parts - s["wall_s"]) <= 1e-9 * max(1.0, s["wall_s"])


def test_each_package_reads_the_others_dump(sessions, tmp_path):
    got, want = sessions
    mine = {"version": 1, "pid": got["pid"], "host": got["host"],
            "sessions": [got]}
    theirs = {"version": 1, "pid": want["pid"], "host": want["host"],
              "sessions": [want]}
    for mod in (profiler, jprofiler):
        merged = mod.merge_sessions([mine, theirs])
        assert sorted(s["session_id"] for s in merged["sessions"]) == sorted(
            [got["session_id"], want["session_id"]])
        summary = mod.summarize(merged["sessions"])
        assert summary["sessions"] == 2
        assert [s["calls"] for s in summary["segments"]] == [2] * len(
            got["segments"])
    assert profiler.summarize([got, want])["segments"] == [
        {k: v for k, v in s.items()}
        for s in jprofiler.summarize([got, want])["segments"]]
    # a profile dump written by the port, read by the JAX package
    config.set_flag("PROFILE_DUMP", str(tmp_path / "p.json"))
    profiler._SESSIONS.append(got)
    assert profiler.dump() == str(tmp_path / "p.json")
    doc = json.loads((tmp_path / "p.json").read_text())
    assert jprofiler.extract_sessions(doc) == [got]


def test_stream_and_resident_plans_open_sessions():
    config.set_flag("PROFILE", "on")
    wire = _list_wire(_fact_rows(300, 9))
    plan = json.dumps(QTY_BY_DATE[1:])
    rows = rb.table_plan_wire(json.dumps(QTY_BY_DATE[:1]), *wire,
                              device="cpu")
    tid = rb.table_upload_wire(*rows, device="cpu")
    try:
        out = rb.table_plan_resident(plan, [tid])
        rb.table_free(out)
    finally:
        rb.table_free(tid)
    rb.table_stream_wire(plan, [rows, rows], device="cpu")
    labels = [s["label"] for s in profiler.sessions()]
    assert labels == ["plan_wire", "plan_resident", "stream"]
    stream = profiler.sessions()[-1]
    assert stream["batches"] == 2
    assert [s["calls"] for s in stream["segments"]] == [2] * len(
        stream["segments"])


def test_an_explicit_session_owns_nested_runs():
    config.set_flag("PROFILE", "on")
    wire = _list_wire(_fact_rows(300, 9))
    with profiler.profile_session(QTY_BY_DATE, label="outer") as sess:
        for _ in range(2):
            rb.table_plan_wire(json.dumps(QTY_BY_DATE), *wire, device="cpu")
    assert [s["label"] for s in profiler.sessions()] == ["outer"]
    assert all(s["calls"] == 2 for s in sess.to_doc()["segments"])


def test_no_session_means_no_segment_token():
    assert not profiler.session_active()
    assert profiler.segment_begin(0, "fused", [{"op": "filter"}]) is None
    assert profiler.maybe_session(QTY_BY_DATE) is profiler._NULL_SCOPE


def test_time_first_call_reports_compile_on_the_segment():
    with profiler.profile_session(None, label="t") as sess:
        tok = profiler.segment_begin(0, "exact", [{"op": "sort_by"}])
        fn = profiler.time_first_call(lambda x: x + 1, "probe")
        assert fn(1) == 2 and fn(2) == 3
        profiler.segment_end(tok, rows_out=1)
    (seg,) = sess.to_doc()["segments"]
    assert seg["compile_s"] > 0 and seg["rows_out"] == 1
