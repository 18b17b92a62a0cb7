"""The port's flight recorder (``utils/flight.py``) against the JAX
package's, on the CPU.

The same sequence of ``record`` calls gives equal snapshots in both
packages, times, thread ids, pids and hosts aside: the ring's wrap and
drop count at several capacities, the capacity parsing, exit sections
(a broken provider embeds its error), the disabled path's cost, and the
dump at interpreter exit, in a child process, which the JAX package's
readers then load. Tolerance 0 throughout.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import flight as jflight
from spark_rapids_jni_tpu_torch.utils import config, flight

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("FLIGHT", "FLIGHT_DUMP", "METRICS", "TRACE")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for f in FLAGS:
        monkeypatch.delenv("SPARK_RAPIDS_TPU_" + f, raising=False)
    for mod in (flight, jflight):
        mod.reset()
        mod._WARNED_SPEC = False
    yield
    for f in FLAGS:
        config.clear_flag(f)
        jconfig.clear_flag(f)
    for mod in (flight, jflight):
        mod.reset()


def _both(flag, value):
    config.set_flag(flag, value)
    jconfig.set_flag(flag, value)


def _stable(doc: dict, sections: bool = True) -> dict:
    """A snapshot without what differs between two processes' runs: the
    times, thread ids, pid, host and clock anchors (and, unless
    ``sections``, the exit sections, which hold the other modules'
    state)."""
    drop = {"pid", "host", "epoch_ns", "anchor_perf_ns"}
    if not sections:
        drop.add("sections")
    out = {k: v for k, v in doc.items() if k not in drop}
    out["events"] = [{k: v for k, v in e.items() if k not in ("t_ns", "tid")}
                     for e in doc["events"]]
    return out


def _script(n: int):
    """A seeded mix of every event kind: span pairs, instants with
    payloads, counter samples."""
    out = []
    for i in range(n):
        k = i % 4
        if k == 0:
            out.append(("B", f"span.{i % 3}", None))
        elif k == 1:
            out.append(("I", "wire.in", i * 7))
        elif k == 2:
            out.append(("C", "resident.live", i))
        else:
            out.append(("E", f"span.{(i - 3) % 3}", None))
    return out


@pytest.mark.parametrize("capacity,n", [
    (4, 3), (4, 4), (4, 13), (8, 8), (8, 31), (16, 40), ("on", 50)])
def test_ring_wrap_and_drop_count_match_jax(capacity, n):
    _both("FLIGHT", capacity)
    for ph, name, arg in _script(n):
        flight.record(ph, name, arg)
        jflight.record(ph, name, arg)
    got, want = flight.snapshot(), jflight.snapshot()
    assert _stable(got, sections=False) == _stable(want, sections=False)
    cap = flight.capacity()
    assert got["dropped"] == max(0, n - cap)
    assert [e["seq"] for e in got["events"]] == list(range(max(0, n - cap), n))
    for limit in (0, 1, 3, 100):
        assert ([e["seq"] for e in flight.tail_records(limit)]
                == [e["seq"] for e in jflight.tail_records(limit)])


@pytest.mark.parametrize("value", [
    None, True, False, 0, -3, 1, 5, 100, 1 << 30, "on", "TRUE", "off", "0",
    "none", "", "17", " 64 ", "bogus"])
def test_capacity_parsing_matches_jax(value, capsys):
    assert flight._capacity_of(value) == jflight._capacity_of(value)
    err = capsys.readouterr().err
    assert ("not on|off|<capacity>" in err) == (value == "bogus")


def test_dump_path_implies_the_recorder(tmp_path):
    _both("FLIGHT_DUMP", str(tmp_path / "f.json"))
    assert flight.enabled() and jflight.enabled()
    assert flight.capacity() == jflight.capacity() == flight.DEFAULT_CAPACITY


@pytest.mark.parametrize("case", ["value", "raises", "none"])
def test_exit_sections_match_jax(case):
    def provider():
        if case == "raises":
            raise ValueError("broken provider")
        return None if case == "none" else {"rows": 3, "ids": [1, 2]}

    _both("FLIGHT", 8)
    saved = (dict(flight._EXIT_SECTIONS), dict(jflight._EXIT_SECTIONS))
    try:
        flight._EXIT_SECTIONS.clear()
        jflight._EXIT_SECTIONS.clear()
        flight.register_exit_section("probe", provider)
        jflight.register_exit_section("probe", provider)
        flight.set_process_meta(session_id="abc")
        jflight.set_process_meta(session_id="abc")
        got, want = _stable(flight.snapshot()), _stable(jflight.snapshot())
    finally:
        for mod, keep in zip((flight, jflight), saved):
            mod._EXIT_SECTIONS.clear()
            mod._EXIT_SECTIONS.update(keep)
    assert got == want
    assert got["session_id"] == "abc"


def test_sections_the_port_registers():
    """Every subsystem of the port that the JAX package puts in a dump
    registers its section on import (serving's come with serving)."""
    import spark_rapids_jni_tpu_torch.runtime_bridge  # noqa: F401
    from spark_rapids_jni_tpu_torch.utils import planstats, profiler  # noqa: F401

    assert {"resident_leaks", "lockcheck", "spill", "profile_sessions",
            "planstats"} <= set(flight._EXIT_SECTIONS)


def test_disabled_record_costs_one_compare():
    """The JAX tests' bound: a disabled record under 5 us."""
    assert not flight.enabled()
    flight.record("I", "warm")
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        flight.record("I", "x")
    per = (time.perf_counter() - t0) / n
    assert per < 5e-6, f"disabled flight.record costs {per * 1e6:.2f} us"


def test_dump_bad_path_warns_not_raises(capsys):
    _both("FLIGHT", 8)
    assert flight.dump("/nonexistent-dir/x/f.json") is None
    assert "flight dump" in capsys.readouterr().err
    assert flight.dump() is None  # no path configured


def test_dump_at_exit_in_a_child_reads_in_the_jax_tools(tmp_path):
    """``FLIGHT_DUMP`` alone turns the recorder on, the dump is written
    at interpreter exit with nothing on stdout, and the JAX package's
    ``tools/trace2chrome.py`` loads it."""
    dump = tmp_path / "flight.json"
    code = (
        "from spark_rapids_jni_tpu_torch import runtime_bridge\n"
        "from spark_rapids_jni_tpu_torch.utils import flight, metrics\n"
        "assert flight.enabled()\n"
        "with metrics.span('outer'):\n"
        "    flight.record('I', 'atexit-evt', 42)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_TPU_FLIGHT_DUMP=str(dump))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == ""
    doc = json.loads(dump.read_text())
    assert [(e["ph"], e["name"]) for e in doc["events"]] == [
        ("B", "outer"), ("I", "atexit-evt"), ("E", "outer")]
    assert doc["events"][1]["arg"] == 42
    assert {"resident_leaks", "lockcheck", "spill"} <= set(doc["sections"])
    assert doc["sections"]["resident_leaks"] == []
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import trace2chrome
    finally:
        sys.path.pop(0)
    out = tmp_path / "trace.json"
    assert trace2chrome.main([str(dump), "-o", str(out)]) == 0
    trace = json.loads(out.read_text())
    assert [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"] == [
        "outer"]
