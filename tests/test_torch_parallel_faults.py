"""Fault tolerance of the port's distributed tier, and plans over the
mesh, on the CPU (the JAX package's ``tests/test_parallel_faults.py``
contract).

Seeded ``shuffle``/``collective``/``mesh``-site faults provoke transient
and permanent failures inside the exchange launches; lineage replay
gives the bytes of a faults-off run, a donated input is at-most-once
(zero retries, one ``shuffle.giveups``), and persistent failure walks the
``MeshRunner`` ladder 8 -> 4 -> 2 -> 1 with the bytes of the
single-device ``run_plan`` at every rung, down to ``faults.Degraded`` at
the floor and the single-device path behind it. ``run_collective``'s
counters are held against the JAX package's under the same seeded plan;
the ladder and the plans against the port's own single-device path and
the outcomes the JAX tests state. The port's mesh is
``devices=[cpu] * n``; the JAX side's shard_map runs under ``jax.jit``
as in ``test_torch_parallel.py``.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from spark_rapids_jni_tpu import parallel as jpar
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.parallel import distributed as jdist
from spark_rapids_jni_tpu.parallel import mesh as jmesh
from spark_rapids_jni_tpu.parallel import planmesh as jplanmesh
from spark_rapids_jni_tpu.parallel import shuffle as jshuffle
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu.utils import faults as jfaults
from spark_rapids_jni_tpu.utils import metrics as jmetrics
from spark_rapids_jni_tpu_torch import graft_entry
from spark_rapids_jni_tpu_torch import parallel
from spark_rapids_jni_tpu_torch import plan as plan_mod
from spark_rapids_jni_tpu_torch.column import Table
from spark_rapids_jni_tpu_torch.ops.groupby import GroupbyAgg
from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
from spark_rapids_jni_tpu_torch.utils import config, faults, metrics

F64 = 10
CPU = torch.device("cpu")
BOUNDARY_SIZES = (1023, 1024, 1025)
ROW_LOCAL_CHAIN = [
    {"op": "filter", "mask": 1},
    {"op": "cast", "column": 0, "type_id": F64},
]
GLOBAL_CHAIN = [
    {"op": "cast", "column": 0, "type_id": F64},
    {"op": "sort_by", "keys": [{"column": 0}]},
]
PARTITION_CHAIN = [
    {"op": "filter", "mask": 1},
    {"op": "partition", "kind": "hash", "keys": [0], "num": 16},
    {"op": "cast", "column": 0, "type_id": F64},
]
CHAINS = {"row_local": ROW_LOCAL_CHAIN, "partition": PARTITION_CHAIN}
CHAOS_FLAGS = ("FAULTS", "RETRY_MAX", "RETRY_BASE_MS", "MESH_PROBE_S",
               "SKEW_SPLIT", "SKEW_SPLIT_FACTOR", "BUCKETS", "METRICS",
               "PIPELINE")


@pytest.fixture(scope="module", autouse=True)
def _jit_jax_shard_map():
    """The JAX tier's shard_map programs under jax.jit (eager shard_map
    compiles one primitive at a time)."""
    orig = jmesh.shard_map
    mods = (jmesh, jshuffle, jdist, jplanmesh)
    saved = [m.shard_map for m in mods]
    for m in mods:
        m.shard_map = lambda f, **kw: jax.jit(orig(f, **kw))
    yield
    for m, f in zip(mods, saved):
        m.shard_map = f


@pytest.fixture(autouse=True)
def _clean_flags():
    yield
    for name in CHAOS_FLAGS:
        config.clear_flag(name)
        jconfig.clear_flag(name)


def _cpus(n: int) -> list:
    return [CPU] * n


def _mesh(n: int = 8):
    return parallel.make_mesh(n, devices=_cpus(n))


def _runner(n: int = 8, **kw):
    return parallel.MeshRunner(n, devices=_cpus(8), **kw)


def _counter(name: str) -> int:
    return int(metrics.snapshot()["counters"].get(name, 0))


def _jcounter(name: str) -> int:
    return int(jmetrics.snapshot()["counters"].get(name, 0))


def _plan_table(n: int, seed: int = 0) -> Table:
    rng = np.random.default_rng(n + seed)
    return Table.from_pydict({
        "x": rng.integers(-50, 50, n, dtype=np.int64),
        "m": rng.integers(0, 3, n, dtype=np.int64) > 0,
    }, device="cpu")


def _tbl(t: Table):
    """Byte-comparable logical view (the single-device path may return
    a padded table carrying ``logical_rows``)."""
    n = int(t.logical_row_count)
    return (n, [(str(c.data.dtype), c.data[:n].tolist(),
                 None if c.validity is None else c.validity[:n].tolist())
                for c in t.columns])


def _kv(n: int, seed: int, keys: int = 60):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, keys, n, dtype=np.int64),
            "v": rng.integers(-100, 100, n, dtype=np.int64)}


def _multiset(out, occ):
    o = out.concat()
    m = occ.concat()
    return sorted(zip(o["k"].data[m].tolist(), o["v"].data[m].tolist()))


def _agg_dict(agg, ngroups):
    got = {}
    for part, g in zip(agg, ngroups.tolist()):
        for i in range(int(g)):
            got[int(part["k"].data[i])] = (int(part["sum_v"].data[i]),
                                           int(part["count_v"].data[i]))
    return got


# ---------------------------------------------------------------------------
# the three flags and the injection sites
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,raw", [
    ("SKEW_SPLIT", None), ("SKEW_SPLIT", "0"), ("SKEW_SPLIT", "true"),
    ("SKEW_SPLIT", "off"), ("SKEW_SPLIT_FACTOR", None),
    ("SKEW_SPLIT_FACTOR", "2.5"), ("SKEW_SPLIT_FACTOR", "0"),
    ("SKEW_SPLIT_FACTOR", "x"), ("MESH_PROBE_S", None),
    ("MESH_PROBE_S", "0.25"), ("MESH_PROBE_S", "-1"),
])
def test_flag_parses_as_in_jax(monkeypatch, name, raw):
    env = "SPARK_RAPIDS_TPU_" + name
    if raw is None:
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, raw)
    try:
        want = jconfig.get_flag(name)
    except ValueError as e:
        with pytest.raises(ValueError):
            config.get_flag(name)
        assert name in str(e)
        return
    got = config.get_flag(name)
    assert got == want and type(got) is type(want)


def test_distributed_sites_registered():
    assert {"shuffle", "collective", "mesh"} <= set(faults.SITES)


@pytest.mark.parametrize("exc", ["ShuffleOverflowError", "JoinOverflowError",
                                 "GroupOverflowError"])
def test_overflow_is_typed_permanent(exc):
    e = getattr(parallel, exc)("capacity 16 overflowed")
    assert isinstance(e, RuntimeError) and isinstance(e, faults.PermanentError)
    assert not faults.retryable_class(faults.classify(e))


def test_make_mesh_is_an_injection_site():
    config.set_flag("FAULTS", "mesh:permanent:1:1")
    with pytest.raises(faults.PermanentError):
        _mesh()


# ---------------------------------------------------------------------------
# run_collective: replay, typed permanents, at-most-once
# ---------------------------------------------------------------------------


def test_undersized_shuffle_not_retried():
    config.set_flag("METRICS", "1")
    before = _counter("shuffle.retries")
    t = Table.from_pydict({"k": np.full(128, 7, dtype=np.int64),
                           "v": np.arange(128, dtype=np.int64)}, device="cpu")
    with pytest.raises(parallel.ShuffleOverflowError):
        parallel.shuffle_table(t, ["k"], _mesh(), capacity=8)
    assert _counter("shuffle.retries") == before


def test_transient_replays_with_the_jax_counters():
    """The same seeded plan in both packages: the same injections, the
    same retries, and the faults-off bytes."""
    n = 1024
    d = _kv(n, 7)
    t = Table.from_pydict(d, device="cpu")
    jt = JTable.from_pydict(d)
    want = _multiset(
        *parallel.shuffle_table(t, ["k"], _mesh(), capacity=n)[:2])
    stats = {}
    for cfg, pkg, table, mesh, counter in (
            (config, parallel, t, _mesh(), _counter),
            (jconfig, jpar, jt, jpar.make_mesh(8), _jcounter)):
        cfg.set_flag("METRICS", "1")
        cfg.set_flag("RETRY_BASE_MS", "1")
        before = counter("shuffle.retries")
        cfg.set_flag("FAULTS", "seed=11,shuffle:transient:1:2")
        out, occ, _ = pkg.shuffle_table(table, ["k"], mesh, capacity=n)
        inj = (faults if pkg is parallel else jfaults).injection_stats()
        stats[pkg.__name__] = (inj, counter("shuffle.retries") - before)
        if pkg is parallel:
            assert _multiset(out, occ) == want
        cfg.clear_flag("FAULTS")
    port, jax_side = stats.values()
    assert port == jax_side
    assert port[0]["shuffle:transient"]["injected"] == 2 and port[1] == 2


def test_permanent_surfaces_typed_without_retry():
    config.set_flag("METRICS", "1")
    before = _counter("shuffle.retries")
    config.set_flag("FAULTS", "shuffle:permanent:1:1")
    t = Table.from_pydict({"k": np.arange(256, dtype=np.int64),
                           "v": np.arange(256, dtype=np.int64)}, device="cpu")
    with pytest.raises(faults.PermanentError):
        parallel.shuffle_table(t, ["k"], _mesh(), capacity=256)
    assert _counter("shuffle.retries") == before


def test_donated_input_is_at_most_once():
    config.set_flag("METRICS", "1")
    config.set_flag("RETRY_BASE_MS", "1")
    n = 512
    t = Table.from_pydict({"k": np.arange(n, dtype=np.int64),
                           "v": np.arange(n, dtype=np.int64)}, device="cpu")
    retries = _counter("shuffle.retries")
    giveups = _counter("shuffle.giveups")
    config.set_flag("FAULTS", "seed=1,shuffle:transient:1:1")
    with pytest.raises(faults.TransientDeviceError):
        parallel.shuffle_table(t, ["k"], _mesh(), capacity=n,
                               donate_input=True)
    # the first transient surfaced: zero replays
    assert _counter("shuffle.retries") == retries
    assert _counter("shuffle.giveups") - giveups == 1
    config.set_flag("FAULTS", "")
    out, occ, overflow = parallel.shuffle_table(t, ["k"], _mesh(), capacity=n,
                                                donate_input=True)
    assert int(overflow.max()) <= 0 and int(occ.concat().sum()) == n


def test_collective_faults_inside_groupby_recover():
    config.set_flag("RETRY_BASE_MS", "1")
    n = 1024
    d = _kv(n, 13, keys=40)
    t = Table.from_pydict(d, device="cpu")
    aggs = [GroupbyAgg("v", "sum"), GroupbyAgg("v", "count")]
    want = _agg_dict(*parallel.distributed_groupby(t, ["k"], aggs,
                                                   _mesh())[:2])
    config.set_flag("FAULTS", "seed=13,collective:transient:1:2")
    agg, ng, ov = parallel.distributed_groupby(t, ["k"], aggs, _mesh())
    assert int(ov.max()) <= 0 and _agg_dict(agg, ng) == want
    assert faults.injection_stats()["collective:transient"]["injected"] == 2
    k, v = d["k"], d["v"]
    assert want == {int(u): (int(v[k == u].sum()), int((k == u).sum()))
                    for u in np.unique(k)}


def _skewed(seed: int = 7):
    """~80 % of the rows carry one key: the splitter engages."""
    rng = np.random.default_rng(seed)
    n = 4096
    k = rng.integers(0, 1000, n, dtype=np.int64)
    k[rng.random(n) < 0.8] = 1
    v = rng.integers(-100, 100, n, dtype=np.int64)
    return Table.from_pydict({"k": k, "v": v}, device="cpu"), k, v


def test_shuffle_faults_in_skew_split_replay_lossless():
    config.set_flag("METRICS", "1")
    config.set_flag("RETRY_BASE_MS", "1")
    t, k, v = _skewed()
    aggs = [GroupbyAgg("v", "sum"), GroupbyAgg("v", "count")]
    splits = _counter("shuffle.skew_splits")
    agg, ng, ov = parallel.distributed_groupby(t, ["k"], aggs, _mesh())
    want = _agg_dict(agg, ng)
    assert _counter("shuffle.skew_splits") > splits
    assert want == {int(u): (int(v[k == u].sum()), int((k == u).sum()))
                    for u in np.unique(k)}
    retries = _counter("shuffle.retries")
    config.set_flag("FAULTS", "seed=11,shuffle:transient:1:2")
    agg, ng, ov = parallel.distributed_groupby(t, ["k"], aggs, _mesh())
    assert int(ov.max()) <= 0 and _agg_dict(agg, ng) == want
    assert faults.injection_stats()["shuffle:transient"]["injected"] == 2
    assert _counter("shuffle.retries") - retries >= 2


def test_salted_exchange_mid_degradation_parity():
    """A persistent shuffle fault in the salted exchange walks the
    ladder 8 -> 4; the replay re-plans the split at 4 devices and the
    groups are the same."""
    config.set_flag("METRICS", "1")
    config.set_flag("RETRY_MAX", "0")
    t, k, v = _skewed(seed=3)
    aggs = [GroupbyAgg("v", "sum"), GroupbyAgg("v", "count")]
    want = _agg_dict(*parallel.distributed_groupby(t, ["k"], aggs,
                                                   _mesh())[:2])
    config.set_flag("FAULTS", "seed=2,shuffle:transient:1:1")
    runner = _runner()
    agg, ng, ov = runner.run_stage(
        "chaos.skew_groupby",
        lambda mesh: parallel.distributed_groupby(t, ["k"], aggs, mesh))
    doc = runner.to_doc()
    assert doc["degraded"] is True and doc["devices"] == 4
    assert int(ov.max()) <= 0 and _agg_dict(agg, ng) == want


# ---------------------------------------------------------------------------
# the ladder and the heartbeat
# ---------------------------------------------------------------------------


def test_ladder_halves_probes_and_replays():
    config.set_flag("RETRY_MAX", "0")
    config.set_flag("METRICS", "1")
    degraded = _counter("mesh.degraded")
    runner = _runner()
    sizes = []

    def stage(mesh):
        size = int(mesh.shape["shuffle"])
        sizes.append(size)
        if size > 2:
            raise faults.TransientDeviceError(f"UNAVAILABLE: lost at {size}")
        return "ok"

    assert runner.run_stage("chaos.stage", stage) == "ok"
    assert sizes == [8, 4, 2]
    doc = runner.to_doc()
    assert doc["degraded"] is True
    assert doc["devices"] == 2 and doc["requested_devices"] == 8
    assert doc["replays"] == 2 and doc["degradations"] == 2
    assert _counter("mesh.degraded") - degraded == 2
    assert runner.mesh.devices == tuple(runner.pool[:2])


def test_floor_raises_typed_degraded():
    config.set_flag("RETRY_MAX", "0")
    config.set_flag("METRICS", "1")
    runner = parallel.MeshRunner(2, min_devices=2, devices=_cpus(2))

    def stage(mesh):
        raise faults.TransientDeviceError("UNAVAILABLE: dead slice")

    with pytest.raises(faults.Degraded) as ei:
        runner.run_stage("chaos.floor", stage)
    assert "2-device floor" in str(ei.value)
    assert _counter("mesh.exhausted") >= 1


def test_probe_answers_on_a_live_mesh():
    assert parallel.MeshHealth().probe(_mesh()) is True


def test_probe_fails_on_an_injected_mesh_fault():
    config.set_flag("METRICS", "1")
    before = _counter("mesh.probe_failures")
    mesh = _mesh()
    config.set_flag("FAULTS", "mesh:transient:1:1")
    assert parallel.MeshHealth().probe(mesh) is False
    assert _counter("mesh.probe_failures") - before == 1


def test_probe_past_its_deadline(monkeypatch):
    """A wedged collective costs the probe its deadline, not the caller
    its thread: the verdict is False and the timeout is counted."""
    config.set_flag("METRICS", "1")
    config.set_flag("MESH_PROBE_S", "0.2")
    release = threading.Event()

    def wedged(values, mesh):
        release.wait(5)
        return list(values)

    monkeypatch.setattr(pmesh, "psum", wedged)
    before = _counter("mesh.probe_timeouts")
    t0 = time.perf_counter()
    try:
        assert parallel.MeshHealth().probe(_mesh()) is False
    finally:
        release.set()
    assert time.perf_counter() - t0 < 2
    assert _counter("mesh.probe_timeouts") - before == 1


# ---------------------------------------------------------------------------
# plans over the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("n", BOUNDARY_SIZES)
def test_plan_parity_at_bucket_edges(n, chain):
    t = _plan_table(n)
    want = _tbl(plan_mod.run_plan(CHAINS[chain], t))
    runner = _runner()
    assert _tbl(parallel.run_plan_mesh(CHAINS[chain], t, runner)) == want
    assert _tbl(plan_mod.run_plan(CHAINS[chain], t,
                                  mesh_runner=runner)) == want
    assert runner.to_doc()["degraded"] is False


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_plan_parity_through_full_ladder(chain):
    """Three dead-slice events walk the mesh 8 -> 4 -> 2 -> 1; every
    replay gives the single-device bytes."""
    config.set_flag("RETRY_MAX", "0")
    config.set_flag("METRICS", "1")
    t = _plan_table(1024)
    want = _tbl(plan_mod.run_plan(CHAINS[chain], t))
    config.set_flag("FAULTS", "seed=2,collective:transient:1:3")
    runner = _runner()
    got = _tbl(plan_mod.run_plan(CHAINS[chain], t, mesh_runner=runner))
    assert got == want
    doc = runner.to_doc()
    assert doc["degraded"] is True and doc["devices"] == 1
    assert doc["replays"] == 3


def test_run_plan_mesh_outcomes():
    """run_plan(mesh_runner=)'s three outcomes: the mesh ran, the plan
    was declined, and the ladder's floor fell back to one device."""
    config.set_flag("METRICS", "1")
    config.set_flag("RETRY_MAX", "0")
    t = _plan_table(1023)
    want = _tbl(plan_mod.run_plan(ROW_LOCAL_CHAIN, t))
    names = ("plan.mesh_segments", "plan.mesh_declined", "plan.mesh_fallbacks")
    before = [_counter(n) for n in names]
    assert _tbl(plan_mod.run_plan(ROW_LOCAL_CHAIN, t,
                                  mesh_runner=_runner())) == want
    assert _tbl(plan_mod.run_plan(GLOBAL_CHAIN, t, mesh_runner=_runner())) == (
        _tbl(plan_mod.run_plan(GLOBAL_CHAIN, t)))
    runner = _runner()
    config.set_flag("FAULTS", "collective:transient:1")
    got = _tbl(plan_mod.run_plan(ROW_LOCAL_CHAIN, t, mesh_runner=runner))
    config.set_flag("FAULTS", "")
    assert got == want
    assert [_counter(n) - b for n, b in zip(names, before)] == [1, 1, 1]
    assert _counter("mesh.exhausted") >= 1


@pytest.mark.parametrize("ops,why", [
    (GLOBAL_CHAIN, "row-local"),
    (PARTITION_CHAIN * 2, "one partition boundary"),
    ([{"op": "partition", "kind": "range", "keys": [0], "num": 4}] + [
        {"op": "cast", "column": 0, "type_id": F64}], None),
    ([{"op": "filter", "mask": 1},
      {"op": "partition", "kind": "range", "keys": [0], "num": 4}],
     "empty scan-side chain"),
])
def test_mesh_unsupported(ops, why):
    t = _plan_table(512)
    if why is None:  # a range partition with no scan-side chain runs
        assert _tbl(parallel.run_plan_mesh(ops, t, _runner())) == (
            _tbl(plan_mod.run_plan(ops, t)))
        return
    with pytest.raises(parallel.MeshUnsupported, match=why):
        parallel.run_plan_mesh(ops, t, _runner())


@pytest.mark.parametrize("depth", ["off", "2"])
def test_run_plan_mesh_stream(depth):
    config.set_flag("PIPELINE", depth)
    batches = [_plan_table(n, seed=1) for n in BOUNDARY_SIZES]
    runner = _runner(4)
    got = parallel.run_plan_mesh_stream(PARTITION_CHAIN, batches, runner)
    assert [_tbl(g) for g in got] == [
        _tbl(plan_mod.run_plan(PARTITION_CHAIN, b)) for b in batches]


def test_prepare_exchange():
    t = _plan_table(1024)
    runner = _runner(4)
    assert parallel.prepare_exchange(ROW_LOCAL_CHAIN, t, runner) is None
    prep = parallel.prepare_exchange(PARTITION_CHAIN, t, runner)
    assert prep["mesh"] is runner.mesh and prep["size"] == 4
    assert tuple(prep["counts"].shape) == (4, 4)


def test_dryrun_multichip_on_cpu(capsys):
    graft_entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(4) on 0 GPU(s)" in out
    assert "tpcds q5 cats=4 ok" in out
