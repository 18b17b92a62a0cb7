"""The port's distributed tier (``spark_rapids_jni_tpu_torch.parallel``)
against the JAX package's on the CPU.

Both sides take the same seeded numpy inputs over a mesh of 4: the JAX
side the first 4 of conftest's 8 virtual CPU devices, the port
``devices=[cpu] * 4``. Every result is compared byte for byte: each
shard's data, validity and string lengths, the padding rows (the dense
exchange's clipped-gather clones, the ragged exchange's zeroed tail),
the occupancy, the counts and the overflows. Tolerance 0.

The JAX side runs once per function and input, in module-scoped
fixtures, with its ``shard_map`` chokepoint (``parallel/mesh.py``
``shard_map``) under ``jax.jit``: eager ``shard_map`` dispatches and
compiles its body one primitive at a time, where the jitted program
compiles once and computes the same thing. The patch lives in this
module's fixture; no JAX file changes.

The skew split and DECIMAL128 are also held against the port's unsplit
path and its single-device groupby.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

from spark_rapids_jni_tpu import parallel as jpar
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops.groupby import GroupbyAgg as JAgg
from spark_rapids_jni_tpu.ops.sort import SortKey as JSortKey
from spark_rapids_jni_tpu.parallel import distributed as jdist
from spark_rapids_jni_tpu.parallel import mesh as jmesh
from spark_rapids_jni_tpu.parallel import planmesh as jplanmesh
from spark_rapids_jni_tpu.parallel import shuffle as jshuffle
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import parallel
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.ops.groupby import (
    GroupbyAgg, groupby_aggregate,
)
from spark_rapids_jni_tpu_torch.ops.sort import SortKey
from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
from spark_rapids_jni_tpu_torch.parallel import shuffle as pshuffle
from spark_rapids_jni_tpu_torch.utils import config, metrics

P = 4
ROWS = 1024  # 256 a shard
CPU4 = [torch.device("cpu")] * P
INT_AGGS = (("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"))


@pytest.fixture(scope="module", autouse=True)
def _jit_jax_shard_map():
    """The JAX tier's shard_map programs under jax.jit (see the module
    docstring)."""
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
    for name in ("SKEW_SPLIT", "SKEW_SPLIT_FACTOR", "METRICS"):
        config.clear_flag(name)
        jconfig.clear_flag(name)


# ---------------------------------------------------------------------------
# inputs and comparison
# ---------------------------------------------------------------------------


def _data(seed: int = 5, n: int = ROWS, keys: int = 60) -> dict:
    rng = np.random.default_rng(seed)
    words = [f"w{i:02d}" * (1 + i % 3) for i in range(40)]
    return {
        "k": rng.integers(0, keys, n).astype(np.int64),
        "k_ok": rng.random(n) > 0.05,
        "v": rng.integers(-100, 100, n).astype(np.int64),
        "f": rng.standard_normal(n),
        "s": [None if rng.random() < 0.05 else words[i]
              for i in rng.integers(0, 40, n)],
    }


def _tables(d: dict):
    """(JAX table, port table) of one input: k (nullable INT64), v, f
    (FLOAT64), s (nullable STRING)."""
    j = JTable([JColumn.from_numpy(d["k"], d["k_ok"]),
                JColumn.from_numpy(d["v"]), JColumn.from_numpy(d["f"]),
                JColumn.from_strings(d["s"])], ["k", "v", "f", "s"])
    t = Table([Column.from_numpy(d["k"], d["k_ok"], device="cpu"),
               Column.from_numpy(d["v"], device="cpu"),
               Column.from_numpy(d["f"], device="cpu"),
               Column.from_strings(d["s"], device="cpu")],
              ["k", "v", "f", "s"])
    return j, t


def _right_tables(seed: int = 9, n: int = 256):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 80, n).astype(np.int64)
    ok = rng.random(n) > 0.05
    w = rng.integers(0, 9, n).astype(np.int64)
    j = JTable([JColumn.from_numpy(k, ok), JColumn.from_numpy(w)], ["k", "w"])
    t = Table([Column.from_numpy(k, ok, device="cpu"),
               Column.from_numpy(w, device="cpu")], ["k", "w"])
    return j, t


def _bytes(x) -> tuple:
    """(shape, bytes) of a JAX array or a tensor (None stays None)."""
    if x is None:
        return None
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.shape, a.tobytes()


def _cols(t) -> list:
    return [(_bytes(c.data), _bytes(c.validity), _bytes(c.lengths))
            for c in t.columns]


def same_table(jt, sharded) -> None:
    """A JAX global table and a port sharded one: the same names, and
    the same bytes in every buffer of every shard, padding included."""
    got = sharded.concat() if isinstance(sharded, pmesh.Sharded) else sharded
    assert got.names == jt.names
    for i, (a, b) in enumerate(zip(_cols(jt), _cols(got))):
        assert a == b, f"column {jt.names[i] if jt.names else i} differs"


def same_array(ja, got) -> None:
    got = got.concat() if isinstance(got, pmesh.Sharded) else got
    a = np.asarray(ja)
    b = got.cpu().numpy()
    assert a.dtype.itemsize == b.dtype.itemsize and _bytes(a) == _bytes(b), (
        f"{a.dtype}{a.shape} {a.ravel()[:8]} != {b.dtype}{b.shape} "
        f"{b.ravel()[:8]}")


def same_result(jres, tres) -> None:
    """A tuple result of both packages, element by element."""
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        if isinstance(a, JTable):
            same_table(a, b)
        else:
            same_array(a, b)


@pytest.fixture(scope="module")
def meshes():
    return jpar.make_mesh(P), parallel.make_mesh(P, devices=CPU4)


@pytest.fixture(scope="module")
def inputs():
    return _tables(_data())


@pytest.fixture(scope="module")
def right():
    return _right_tables()


# ---------------------------------------------------------------------------
# the surface, the mesh and sharding
# ---------------------------------------------------------------------------


def test_all_names_match_the_jax_package():
    assert parallel.__all__ == jpar.__all__
    assert len(parallel.__all__) == 31
    for name in parallel.__all__:
        assert getattr(parallel, name) is not None


def test_mesh_shape_and_axis(meshes):
    jm, tm = meshes
    assert pmesh.SHUFFLE_AXIS == jmesh.SHUFFLE_AXIS == "shuffle"
    assert tm.shape["shuffle"] == jm.shape["shuffle"] == P
    assert tm.devices == tuple(CPU4)


@pytest.mark.parametrize("n", [1024, 0, -3])
def test_make_mesh_names_shape_and_remedy(n):
    with pytest.raises(ValueError) as ei:
        parallel.make_mesh(n, devices=CPU4)
    assert str(n) in str(ei.value)
    if n > 0:
        assert "devices=" in str(ei.value)


def test_shard_table_matches_jax_shards(meshes, inputs):
    jm, tm = meshes
    jt, tt = inputs
    js = jpar.shard_table(jt, jm)
    ts = parallel.shard_table(tt, tm)
    assert parallel.local_shards(ts) == jpar.local_shards(js) == P
    for c in range(jt.num_columns):
        shards = sorted(js.columns[c].data.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        for s, part in zip(shards, ts):
            assert _bytes(s.data) == _bytes(part.columns[c].data)
    same_table(jt, ts)


def test_shard_table_names_axis_and_remedy(meshes):
    t = Table.from_pydict({"k": np.arange(13, dtype=np.int64)}, device="cpu")
    with pytest.raises(ValueError) as ei:
        parallel.shard_table(t, meshes[1])
    msg = str(ei.value)
    assert "shuffle" in msg and "divisible" in msg and "13" in msg


def test_replicate_table(meshes, inputs):
    rep = parallel.replicate_table(inputs[1], meshes[1])
    assert parallel.local_shards(rep) == P
    for part in rep:
        assert _cols(part) == _cols(inputs[1])


@pytest.mark.parametrize("exact", [0, 1, 15, 16, 17, 255, 256, 257, 5000])
def test_round_capacity(exact):
    assert pshuffle._round_capacity(exact) == jshuffle._round_capacity(exact)


def test_collectives(meshes):
    tm = meshes[1]
    vals = [torch.full((2,), i, dtype=torch.int64) for i in range(P)]
    six = torch.full((2,), 6)
    assert all(torch.equal(s, six) for s in pmesh.psum(vals, tm))
    g = pmesh.all_gather(vals, tm)
    assert all(torch.equal(x, torch.cat(vals)) for x in g)
    blocks = [[torch.tensor([10 * s + d]) for d in range(P)] for s in range(P)]
    got = pmesh.all_to_all(blocks, tm)
    for d in range(P):
        assert got[d].tolist() == [10 * s + d for s in range(P)]


# ---------------------------------------------------------------------------
# the shuffle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_shuffles(meshes, inputs):
    jm, _ = meshes
    jt, _ = inputs
    sh = jpar.shard_table(jt, jm)
    counts = jpar.partition_counts(sh, ["k"], jm)
    return {
        "counts": counts,
        "capacity": jpar.plan_capacity(sh, ["k"], jm),
        "recv": jpar.total_recv_capacity(counts),
        "dense": jpar.shuffle_table(jt, ["k"], jm),
        "compact": jpar.shuffle_table_compact(jt, ["k"], jm,
                                              impl="dense_compact"),
        "string_key": jpar.shuffle_table_compact(jt, ["s", "k"], jm,
                                                 impl="dense_compact"),
    }


def test_partition_counts_and_capacities(meshes, inputs, jax_shuffles):
    _, tm = meshes
    sh = parallel.shard_table(inputs[1], tm)
    counts = parallel.partition_counts(sh, ["k"], tm)
    same_array(jax_shuffles["counts"], counts)
    assert parallel.plan_capacity(sh, ["k"], tm) == jax_shuffles["capacity"]
    assert parallel.total_recv_capacity(counts) == jax_shuffles["recv"]


def test_shuffle_table_dense(meshes, inputs, jax_shuffles):
    """The dense exchange's padding slots hold clipped-gather clones."""
    same_result(jax_shuffles["dense"],
                parallel.shuffle_table(inputs[1], ["k"], meshes[1]))


@pytest.mark.parametrize("impl", ["dense_compact", "ragged"])
def test_shuffle_table_compact(meshes, inputs, jax_shuffles, impl):
    """Both port forms give the JAX dense_compact bytes (zeroed tail)."""
    same_result(jax_shuffles["compact"], parallel.shuffle_table_compact(
        inputs[1], ["k"], meshes[1], impl=impl))


@pytest.mark.parametrize("impl", ["dense_compact", "ragged"])
def test_shuffle_string_keys(meshes, inputs, jax_shuffles, impl):
    same_result(jax_shuffles["string_key"], parallel.shuffle_table_compact(
        inputs[1], ["s", "k"], meshes[1], impl=impl))


def test_default_impl_is_dense_compact_on_the_cpu(meshes):
    assert pshuffle._ragged_impl(None, meshes[1]) == "dense_compact"
    assert pshuffle._ragged_impl("ragged", meshes[1]) == "ragged"
    with pytest.raises(ValueError):
        pshuffle._ragged_impl("nccl", meshes[1])


def _dest_and_valid(n: int):
    rng = np.random.default_rng(21)
    # skewed on purpose: destination 0 gets about half the rows
    dest = np.where(rng.random(n) < 0.5, 0,
                    rng.integers(0, P, n)).astype(np.int32)
    return dest, rng.random(n) > 0.2


def _parts(a: np.ndarray) -> list:
    return [torch.from_numpy(x.copy()) for x in np.split(a, P)]


@pytest.fixture(scope="module")
def jax_exchanges(meshes, inputs):
    """The JAX in-shard_map exchanges over explicit destinations and a
    row mask: dense at a capacity below the hottest pair (overflow),
    ragged at the planned (tight) pair capacity, and ragged at an
    out_size below the hottest destination (overflow)."""
    jm, _ = meshes
    jt, _ = inputs
    dest, rv = _dest_and_valid(jt.row_count)
    sh = jpar.shard_table(jt, jm)
    spec = JP("shuffle")

    def dense(local, d, v):
        out, occ, ov = jshuffle.exchange(local, d, P, 48, row_valid=v)
        return out, occ, ov[None]

    counts = np.zeros((P, P), np.int32)
    for s, (ds, vs) in enumerate(zip(np.split(dest, P), np.split(rv, P))):
        counts[s] = np.bincount(ds[vs], minlength=P)
    out = {"dense": jmesh.shard_map(
        dense, mesh=jm, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)(sh, jax.numpy.asarray(dest), jax.numpy.asarray(rv)),
        "counts": counts}
    pair_cap = jshuffle._round_capacity(int(counts.max()))
    out["pair_cap"] = pair_cap
    for name, size, pair in (("ragged", 512, pair_cap),
                             ("ragged_over", 256, None)):
        def ragged(local, d, v, C, size=size, pair=pair):
            o, occ, ov = jshuffle.exchange_ragged(
                local, d, C, size, impl="dense_compact", row_valid=v,
                pair_capacity=pair)
            return o, occ, ov[None]

        out[name] = jmesh.shard_map(
            ragged, mesh=jm, in_specs=(spec, spec, spec, JP()),
            out_specs=spec, check_vma=False)(
                sh, jax.numpy.asarray(dest), jax.numpy.asarray(rv),
                jax.numpy.asarray(counts))
    return out


def test_exchange_with_row_valid_and_overflow(meshes, inputs, jax_exchanges):
    dest, rv = _dest_and_valid(ROWS)
    got = parallel.exchange(parallel.shard_table(inputs[1], meshes[1]),
                            _parts(dest), P, 48, row_valid=_parts(rv))
    assert int(got[2].max()) > 0  # the capacity is below the hottest pair
    same_result(jax_exchanges["dense"], got)


@pytest.mark.parametrize("impl", ["dense_compact", "ragged"])
@pytest.mark.parametrize("case,size", [("ragged", 512), ("ragged_over", 256)])
def test_exchange_ragged(meshes, inputs, jax_exchanges, impl, case, size):
    dest, rv = _dest_and_valid(ROWS)
    pair = jax_exchanges["pair_cap"] if case == "ragged" else None
    got = parallel.exchange_ragged(
        parallel.shard_table(inputs[1], meshes[1]), _parts(dest),
        torch.from_numpy(jax_exchanges["counts"]), size, impl=impl,
        row_valid=_parts(rv), pair_capacity=pair)
    if case == "ragged_over":
        assert int(got[2].max()) > 0
    same_result(jax_exchanges[case], got)


@pytest.mark.parametrize("kind", ["dense", "compact"])
def test_undersized_shuffle_raises(meshes, kind):
    """The same undersized input raises in both packages."""
    jm, tm = meshes
    k = np.full(128, 7, dtype=np.int64)
    jt = JTable([JColumn.from_numpy(k)], ["k"])
    tt = Table([Column.from_numpy(k, device="cpu")], ["k"])
    for pkg, mesh, t in ((jpar, jm, jt), (parallel, tm, tt)):
        with pytest.raises(pkg.ShuffleOverflowError):
            if kind == "dense":
                pkg.shuffle_table(t, ["k"], mesh, capacity=8)
            else:
                pkg.shuffle_table_compact(t, ["k"], mesh, out_size=16)


@pytest.mark.parametrize("kind,impl", [("dense", None),
                                       ("compact", "dense_compact"),
                                       ("compact", "ragged")])
def test_undersized_allowed_gives_the_jax_bytes(meshes, inputs, kind, impl):
    """``on_overflow="allow"``: the truncated exchange and its overflow
    counts, byte for byte."""
    jm, tm = meshes
    if kind == "dense":
        want = jpar.shuffle_table(inputs[0], ["k"], jm, capacity=8,
                                  on_overflow="allow")
        got = parallel.shuffle_table(inputs[1], ["k"], tm, capacity=8,
                                     on_overflow="allow")
    else:
        want = jpar.shuffle_table_compact(inputs[0], ["k"], jm, out_size=64,
                                          impl="dense_compact",
                                          on_overflow="allow")
        got = parallel.shuffle_table_compact(inputs[1], ["k"], tm,
                                             out_size=64, impl=impl,
                                             on_overflow="allow")
    assert int(got[2].max()) > 0
    same_result(want, got)


def test_bad_on_overflow_rejected(meshes, inputs):
    with pytest.raises(ValueError):
        parallel.shuffle_table(inputs[1], ["k"], meshes[1], on_overflow="drop")


def _zipf_counts(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.5, (P, P)) % 500).astype(np.int32)


@pytest.mark.parametrize("case", ["zipf", "uniform", "factor", "off",
                                  "empty"])
def test_plan_skew(case):
    counts = (np.full((P, P), 7, np.int32) if case == "uniform"
              else np.zeros((P, P), np.int32) if case == "empty"
              else _zipf_counts())
    factor = 1.2 if case == "factor" else None
    if case == "off":
        config.set_flag("SKEW_SPLIT", "0")
        jconfig.set_flag("SKEW_SPLIT", "0")
    want = jpar.plan_skew(jax.numpy.asarray(counts), factor)
    got = parallel.plan_skew(torch.from_numpy(counts), factor)
    assert got.to_doc() == want.to_doc()
    assert isinstance(got, parallel.SkewPlan)


# ---------------------------------------------------------------------------
# distributed operators
# ---------------------------------------------------------------------------


def _aggs(pkg_agg, specs):
    return [pkg_agg(c, op) for c, op in specs]


def _dec_tables():
    """A nullable DECIMAL128 column with values near +-2^64 and +-10^37
    (ties included) beside a small INT64 key."""
    rng = np.random.default_rng(12)
    base = [0, 1, -1, 2**64 - 1, -(2**64), 10**37, -(10**37), 2**63]
    vals = [None if rng.random() < 0.05 else
            base[i] * int(m) for i, m in zip(rng.integers(0, 8, ROWS),
                                            rng.integers(-3, 4, ROWS))]
    v = rng.integers(0, 50, ROWS).astype(np.int64)
    j = JTable([JColumn.from_decimal128(vals, scale=-2),
                JColumn.from_numpy(v)], ["d", "v"])
    t = Table([Column.from_decimal128(vals, scale=-2, device="cpu"),
               Column.from_numpy(v, device="cpu")], ["d", "v"])
    return j, t


@pytest.fixture(scope="module")
def jax_ops(meshes, inputs, right):
    jm, _ = meshes
    jt, _ = inputs
    jr, _ = right
    out = {
        "groupby": jpar.distributed_groupby(jt, ["k"], _aggs(JAgg, INT_AGGS),
                                            jm),
        "groupby_string": jpar.distributed_groupby(
            jt, ["s"], [JAgg("v", "sum"), JAgg("v", "count")], jm),
        "distinct": jpar.distributed_distinct(jt, ["k", "s"], jm),
        "sort": jpar.distributed_sort(jt, ["k", "v"], jm),
        "sort_desc": jpar.distributed_sort(
            jt, [JSortKey("s", ascending=False), JSortKey("v")], jm),
        "broadcast": jpar.broadcast_inner_join(jt, jr, ["k"], jm),
        "broadcast_capped": jpar.broadcast_inner_join(jt, jr, ["k"], jm,
                                                      out_capacity=1024),
    }
    out["sort_dec128"] = jpar.distributed_sort(_dec_tables()[0], ["d", "v"],
                                               jm)
    out["groupby_dec128"] = jpar.distributed_groupby(
        _dec_tables()[0], ["v"], [JAgg("d", "sum"), JAgg("d", "min")], jm)
    for name in ("distributed_inner_join", "distributed_left_join",
                 "distributed_semi_join", "distributed_anti_join"):
        out[name] = getattr(jpar, name)(jt, jr, ["k"], jm)
    return out


def test_distributed_groupby(meshes, inputs, jax_ops):
    same_result(jax_ops["groupby"], parallel.distributed_groupby(
        inputs[1], ["k"], _aggs(GroupbyAgg, INT_AGGS), meshes[1]))


def test_distributed_groupby_string_keys(meshes, inputs, jax_ops):
    same_result(jax_ops["groupby_string"], parallel.distributed_groupby(
        inputs[1], ["s"], [GroupbyAgg("v", "sum"), GroupbyAgg("v", "count")],
        meshes[1]))


def test_distributed_distinct(meshes, inputs, jax_ops):
    same_result(jax_ops["distinct"], parallel.distributed_distinct(
        inputs[1], ["k", "s"], meshes[1]))


def test_distinct_needs_a_mesh(inputs):
    with pytest.raises(TypeError):
        parallel.distributed_distinct(inputs[1], ["k"])


@pytest.mark.parametrize("name", ["distributed_inner_join",
                                  "distributed_left_join",
                                  "distributed_semi_join",
                                  "distributed_anti_join"])
def test_shuffle_joins(meshes, inputs, right, jax_ops, name):
    same_result(jax_ops[name], getattr(parallel, name)(
        inputs[1], right[1], ["k"], meshes[1]))


@pytest.mark.parametrize("case", ["broadcast", "broadcast_capped"])
def test_broadcast_inner_join(meshes, inputs, right, jax_ops, case):
    kw = {"out_capacity": 1024} if case == "broadcast_capped" else {}
    same_result(jax_ops[case], parallel.broadcast_inner_join(
        inputs[1], right[1], ["k"], meshes[1], **kw))


def test_distributed_sort(meshes, inputs, jax_ops):
    same_result(jax_ops["sort"], parallel.distributed_sort(
        inputs[1], ["k", "v"], meshes[1]))


def test_distributed_sort_string_descending(meshes, inputs, jax_ops):
    same_result(jax_ops["sort_desc"], parallel.distributed_sort(
        inputs[1], [SortKey("s", ascending=False), SortKey("v")], meshes[1]))


@pytest.mark.parametrize("case", ["sort_dec128", "groupby_dec128"])
def test_decimal128_keys_and_values(meshes, jax_ops, case):
    """A DECIMAL128 sort key (two limb order words through the range
    partition) and DECIMAL128 sums and minima through the hash exchange."""
    t = _dec_tables()[1]
    if case == "sort_dec128":
        got = parallel.distributed_sort(t, ["d", "v"], meshes[1])
    else:
        got = parallel.distributed_groupby(
            t, ["v"], [GroupbyAgg("d", "sum"), GroupbyAgg("d", "min")],
            meshes[1])
    same_result(jax_ops[case], got)


def test_distributed_sort_one_device(inputs):
    mesh1 = parallel.make_mesh(1, devices=CPU4)
    out, occ, ov = parallel.distributed_sort(inputs[1], ["v"], mesh1)
    assert bool(occ.concat().all()) and int(ov.max()) == 0
    v = out.concat()["v"].data
    assert bool((v[1:] >= v[:-1]).all())


@pytest.mark.parametrize("case", ["join_output", "groups"])
def test_overflow_errors_raise_in_both_packages(meshes, inputs, right, case):
    jm, tm = meshes
    for pkg, mesh, (t, r), agg in ((jpar, jm, (inputs[0], right[0]), JAgg),
                                   (parallel, tm, (inputs[1], right[1]),
                                    GroupbyAgg)):
        if case == "join_output":
            with pytest.raises(pkg.JoinOverflowError):
                pkg.broadcast_inner_join(t, r, ["k"], mesh, out_capacity=4)
        else:
            with pytest.raises(pkg.GroupOverflowError):
                pkg.distributed_groupby(t, ["k"], [agg("v", "sum")], mesh,
                                        groups_per_device=2)


# ---------------------------------------------------------------------------
# the skew split and DECIMAL128 against the port's own paths
# ---------------------------------------------------------------------------


def _skewed(n: int = ROWS, seed: int = 7):
    """About 60 % of the rows carry one key: its destination passes 2x
    the mean on 4 shards."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 300, n).astype(np.int64)
    k[rng.random(n) < 0.6] = 1
    v = rng.integers(-100, 100, n).astype(np.int64)
    f = rng.standard_normal(n)
    return Table([Column.from_numpy(k, device="cpu"),
                  Column.from_numpy(v, device="cpu"),
                  Column.from_numpy(f, device="cpu")], ["k", "v", "f"])


def _occupied(agg, ngroups) -> list:
    """Each shard's occupied prefix: its (shape, bytes) per buffer."""
    out = []
    for part, g in zip(agg, ngroups.tolist()):
        out.append([(_bytes(c.data[:g]), _bytes(c.validity[:g]))
                    for c in part.columns])
    return out


def _counter(name: str) -> int:
    return int(metrics.snapshot()["counters"].get(name, 0))


def test_skew_split_engages_with_unsplit_bytes(meshes):
    config.set_flag("METRICS", "1")
    t = _skewed()
    aggs = _aggs(GroupbyAgg, INT_AGGS)
    before = _counter("shuffle.skew_splits")
    agg, ng, ov = parallel.distributed_groupby(t, ["k"], aggs, meshes[1])
    assert _counter("shuffle.skew_splits") > before
    assert int(ov.max()) <= 0
    config.set_flag("SKEW_SPLIT", "0")
    agg0, ng0, _ = parallel.distributed_groupby(t, ["k"], aggs, meshes[1])
    assert _counter("shuffle.skew_splits") == before + 1
    assert torch.equal(ng, ng0)
    assert _occupied(agg, ng) == _occupied(agg0, ng0)
    # the single-device groupby: the same groups, each key on its
    # hash owner
    whole = groupby_aggregate(t, ["k"], aggs)
    rows = {}
    for part, g in zip(agg, ng.tolist()):
        for i in range(g):
            rows[int(part["k"].data[i])] = tuple(
                int(part[c].data[i]) for c in whole.names[1:])
    want = {int(whole["k"].data[i]): tuple(int(whole[c].data[i])
                                           for c in whole.names[1:])
            for i in range(whole.row_count)}
    assert rows == want


def test_skew_split_matches_jax(meshes):
    """The JAX package's split on the same input: the same occupied
    bytes on every shard and the same counts (the padded capacity may
    differ between the packages' own rounding of the post-split
    counts, so the padding is not held)."""
    jm, tm = meshes
    t = _skewed()
    jt = JTable([JColumn.from_numpy(c.data.numpy()) for c in t.columns[:2]],
                ["k", "v"])
    jagg, jng, jov = jpar.distributed_groupby(jt, ["k"], _aggs(JAgg, INT_AGGS),
                                              jm)
    agg, ng, ov = parallel.distributed_groupby(
        Table(t.columns[:2], ["k", "v"]), ["k"], _aggs(GroupbyAgg, INT_AGGS),
        tm)
    same_array(jng, ng)
    same_array(jov, ov)
    same_table(jagg, agg)


def test_float_sum_declines_the_split(meshes):
    """A FLOAT sum is never split: the bytes equal SKEW_SPLIT=0's,
    padding included."""
    config.set_flag("METRICS", "1")
    t = _skewed()
    aggs = [GroupbyAgg("f", "sum"), GroupbyAgg("v", "count")]
    before = _counter("shuffle.skew_splits")
    got = parallel.distributed_groupby(t, ["k"], aggs, meshes[1])
    assert _counter("shuffle.skew_splits") == before
    config.set_flag("SKEW_SPLIT", "0")
    want = parallel.distributed_groupby(t, ["k"], aggs, meshes[1])
    for a, b in zip(got, want):
        if isinstance(a, pmesh.Sharded):
            assert _cols(a.concat()) == _cols(b.concat())
        else:
            assert torch.equal(a, b)


def test_distributed_groupby_decimal128(meshes):
    """(n, 2) limb columns ride the exchange; the sums equal the port's
    single-device groupby and Python ints."""
    from spark_rapids_jni_tpu_torch.ops.int128 import from_py_ints, to_py_ints

    rng = np.random.default_rng(4)
    k = rng.integers(0, 20, ROWS).astype(np.int64)
    vals = [int(v) * 10**25 for v in rng.integers(-50, 50, ROWS)]
    t = Table([Column.from_numpy(k, device="cpu"),
               Column.from_numpy(from_py_ints(vals),
                                 dtype=dt.DType(dt.TypeId.DECIMAL128, -30),
                                 device="cpu")], ["k", "d"])
    agg, ng, ov = parallel.distributed_groupby(t, ["k"],
                                               [GroupbyAgg("d", "sum")],
                                               meshes[1])
    assert int(ov.max()) <= 0
    got = {}
    for part, g in zip(agg, ng.tolist()):
        sums = to_py_ints(part["sum_d"].data[:g])
        for i in range(g):
            got[int(part["k"].data[i])] = sums[i]
    want = {}
    for key, v in zip(k.tolist(), vals):
        want[key] = want.get(key, 0) + v
    assert got == want
    whole = groupby_aggregate(t, ["k"], [GroupbyAgg("d", "sum")])
    assert {int(a): b for a, b in zip(whole["k"].data.tolist(),
                                      to_py_ints(whole["sum_d"].data))} == want
