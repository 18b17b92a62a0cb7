"""The port's device-memory planner (``utils/hbm.py``) against the JAX
package's, on the CPU.

The same tables, made with numpy from a seed (1023/1024/1025 rows with
nulls, STRING, DECIMAL128 and LIST columns), carried into both packages:
the byte counts, the key word counts, the budget and the
``join_plan``/``sort_plan``/``groupby_plan`` dicts are equal (on the CPU
both plan against 16 GiB), and ``inner_join_batches`` cuts the same
probe chunks, re-split the same way under skew, with the same rows.
Tolerance 0 throughout.
"""

import threading
import unittest.mock as mock
import warnings

import numpy as np
import pytest

from spark_rapids_jni_tpu import pipeline as jpipeline
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import hbm as jhbm
from spark_rapids_jni_tpu.utils import spill as jspill
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch import pipeline
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.ops import join
from spark_rapids_jni_tpu_torch.utils import config, hbm, metrics, spill

EDGES = (1023, 1024, 1025)
FLAGS = ("HBM_BUDGET_GB", "METRICS", "SPILL", "PIPELINE")
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
    """Both packages' flags cleared, both pools drained and torn down, no
    spill file left and both registries as they were (F6)."""
    before = (jrb.resident_table_count(), rb.resident_table_count())
    yield
    for cfg, pipe in ((jconfig, jpipeline), (config, pipeline)):
        _bounded(pipe.drain)
        for name in FLAGS:
            cfg.clear_flag(name)
        pipe.depth()
        _bounded(pipe.drain_io)
    assert (spill.spill_file_count(), jspill.spill_file_count()) == (0, 0)
    assert (jrb.resident_table_count(), rb.resident_table_count()) == before


def _both(name, value):
    jconfig.set_flag(name, value)
    config.set_flag(name, value)


def _to_port(jt: JTable):
    """The same buffers as a port table on the CPU."""
    cols = []
    for c in jt.columns:
        cols.append((np.asarray(c.data),
                     None if c.validity is None else np.asarray(c.validity),
                     None if c.lengths is None else np.asarray(c.lengths),
                     int(c.dtype.id), int(c.dtype.scale)))
    return interop.table_from_buffers(cols, jt.names, device="cpu")


def _mixed(n: int, seed: int):
    """The same table in both packages, decoded from one wire table:
    INT64 (nulls), INT32, STRING (nulls), DECIMAL128 and LIST<INT32>."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-9, 9, n).astype(np.int64)
    kv = (rng.random(n) > 0.2).astype(np.uint8).tobytes()
    i = rng.integers(0, 1000, n).astype(np.int32)
    strs = [("x" * int(j % 5) + str(j)).encode()
            for j in rng.integers(0, 99, n)]
    offs = np.zeros(n + 1, np.int32)
    np.cumsum([len(s) for s in strs], out=offs[1:])
    d = rng.integers(-2**62, 2**62, (n, 2)).astype(np.int64)
    lens = rng.integers(0, 5, n).astype(np.int32)
    loffs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=loffs[1:])
    child = rng.integers(-99, 99, int(loffs[-1])).astype(np.int32)
    wire = ([4, 3, 23, 27, 24], [0, 0, 0, -4, 3],
            [k.tobytes(), i.tobytes(), offs.tobytes() + b"".join(strs),
             d.tobytes(), loffs.tobytes() + child.tobytes()],
            [kv, None, kv, None, None], n)
    names = ["k", "i", "s", "d", "l"]
    jt = jrb._table_from_wire(*wire, None)
    pt = rb._table_from_wire(*wire, device="cpu")
    return JTable(jt.columns, names), type(pt)(pt.columns, names)


def _join_tables(n=6000, seed=0, hot=None):
    rng = np.random.default_rng(seed)
    kl = rng.integers(0, 500, n).astype(np.int64)
    kr = rng.integers(0, 500, n).astype(np.int64)
    if hot is not None:
        kl[: n // 3] = hot
        kr[: n // 3] = hot
    left = JTable([JColumn.from_numpy(kl),
                   JColumn.from_numpy(np.arange(n, dtype=np.int64))],
                  ["k", "lv"])
    right = JTable([JColumn.from_numpy(kr),
                    JColumn.from_numpy(np.arange(n, dtype=np.int64) * 3)],
                   ["k", "rv"])
    return left, right


@pytest.mark.parametrize("n", EDGES)
def test_bytes_and_key_words_equal_jax(n):
    jt, pt = _mixed(n, n)
    for jc, pc in zip(jt.columns, pt.columns):
        assert hbm.column_bytes(pc) == jhbm.column_bytes(jc)
    assert hbm.table_bytes(pt) == jhbm.table_bytes(jt)
    assert hbm.row_bytes(pt) == jhbm.row_bytes(jt)
    for cols in ([0], [2], [3], [0, 2, 3], [1, 3]):
        assert (hbm.key_word_count([pt.columns[c] for c in cols])
                == jhbm.key_word_count([jt.columns[c] for c in cols]))


def test_budget_equals_jax_on_the_cpu():
    assert hbm.budget_bytes("cpu") == jhbm.budget_bytes("cpu")
    assert hbm.budget_bytes() == int(16 * hbm.GIB * (1 - hbm.RESERVE_FRACTION))
    for gb in (2.0, 4.0, 3e-5):
        _both("HBM_BUDGET_GB", gb)
        assert hbm.budget_bytes() == jhbm.budget_bytes()
    assert hbm.RESERVE_FRACTION == jhbm.RESERVE_FRACTION


@pytest.mark.parametrize("gb", (None, 1.0, 8.0, 1e-6))
@pytest.mark.parametrize("n", EDGES)
def test_plans_equal_jax(n, gb):
    if gb is not None:
        _both("HBM_BUDGET_GB", gb)
    jt, pt = _mixed(n, 2 * n)
    jl, jr = _join_tables(n, seed=n)
    pl, pr = _to_port(jl), _to_port(jr)
    assert hbm.join_plan(pl, pr, ["k"], ["k"]) == jhbm.join_plan(
        jl, jr, ["k"], ["k"])
    assert hbm.join_plan(pt, pt, [0, 2], [0, 2]) == jhbm.join_plan(
        jt, jt, [0, 2], [0, 2])
    for words in (1, 2, 5):
        assert hbm.sort_plan(pt, words) == jhbm.sort_plan(jt, words)
    for by, segs in (([0], 64), (["s", "d"], 1000)):
        assert hbm.groupby_plan(pt, by, segs) == jhbm.groupby_plan(
            jt, by, segs)


def test_plan_metrics_and_pressure_listener():
    config.set_flag("METRICS", "1")
    metrics.reset()
    seen = []
    hbm.register_pressure_listener(seen.append)
    try:
        jl, jr = _join_tables(2000)
        pl, pr = _to_port(jl), _to_port(jr)
        hbm.join_plan(pl, pr, ["k"], ["k"])
        assert seen == []
        config.set_flag("HBM_BUDGET_GB", 1e-6)
        plan = hbm.join_plan(pl, pr, ["k"], ["k"])
        assert not plan["fits"]
        assert seen == [plan["fixed_bytes"] - plan["budget_bytes"]]
    finally:
        hbm._PRESSURE_LISTENERS.remove(seen.append)
    c = metrics.snapshot()["counters"]
    assert c["hbm.plan.join"] == 2 and c["hbm.plan_over_budget"] == 1


def test_sort_plan_refuses_a_monster():
    config.set_flag("HBM_BUDGET_GB", 1.0)
    pl, _ = (_to_port(t) for t in _join_tables(100))

    class Fake:
        row_count = 100_000_000
        columns = pl.columns

        def column(self, c):
            return pl.columns[0]

    with mock.patch.object(hbm, "table_bytes", return_value=100_000_000 * 24):
        assert not hbm.sort_plan(Fake(), n_key_words=2)["fits"]


def test_donation_counters():
    config.set_flag("METRICS", "1")
    metrics.reset()
    got = []
    hbm.register_donation_listener(got.append)
    try:
        hbm.note_donation(4096)
    finally:
        hbm._DONATION_LISTENERS.remove(got.append)
    assert got == [4096]
    snap = metrics.snapshot()
    assert snap["counters"]["hbm.donations"] == 1
    assert snap["bytes"]["hbm.donated_bytes"] == 4096


def _chunks(mod, left, right, **kw):
    return [int(t.row_count) for t in mod.inner_join_batches(
        left, right, ["k"], **kw)]


@pytest.mark.parametrize("probe_rows", (None, 1024, 1500, 4096))
@pytest.mark.parametrize("n", EDGES)
def test_join_chunk_sequence_equals_jax(n, probe_rows):
    jl, jr = _join_tables(n * 3, seed=n)
    pl, pr = _to_port(jl), _to_port(jr)
    kw = {} if probe_rows is None else {"probe_rows": probe_rows}
    assert _chunks(join, pl, pr, **kw) == _chunks(jjoin, jl, jr, **kw)


def test_join_resplits_skewed_chunks_as_jax(monkeypatch):
    """A hot key whose fan-out passes the chunk budget re-splits the
    chunk in both packages, into the same pieces."""
    jl, jr = _join_tables(n=6000, seed=2, hot=7)
    pl, pr = _to_port(jl), _to_port(jr)
    base = _chunks(join, pl, pr, probe_rows=4096)
    assert base == _chunks(jjoin, jl, jr, probe_rows=4096)
    monkeypatch.setattr(join, "MIN_CHUNK_OUT_BYTES", 1 << 15)
    monkeypatch.setattr(jjoin, "MIN_CHUNK_OUT_BYTES", 1 << 15)
    split = _chunks(join, pl, pr, probe_rows=4096)
    assert split == _chunks(jjoin, jl, jr, probe_rows=4096)
    assert len(split) > len(base) and sum(split) == sum(base)
    out = join.inner_join_batched(pl, pr, ["k"], probe_rows=4096)
    kl = np.asarray(jl.columns[0].data)
    kr = np.asarray(jr.columns[0].data)
    assert out.row_count == int(sum(
        (kr == k).sum() for k in kl))


def test_join_over_budget_warns_at_the_call():
    config.set_flag("HBM_BUDGET_GB", 1e-9)
    pl, pr = (_to_port(t) for t in _join_tables(2000))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        gen = join.inner_join_batches(pl, pr, ["k"])
    assert any("device memory budget" in str(x.message) for x in w)
    assert sum(int(t.row_count) for t in gen) > 0
    config.clear_flag("HBM_BUDGET_GB")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        join.inner_join_batches(pl, pr, ["k"])
    assert not w
