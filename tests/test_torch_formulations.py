"""The port's packed and chunked formulations and the eager groupby's
router against the JAX package's, on the CPU:

* F8 — ``SPARK_RAPIDS_TPU_GROUPBY_FORMULATION`` routes an eager groupby
  of more than ``CHUNKED_MIN_ROWS`` rows to the packed or chunked design,
  whose FLOAT64 sums add in another order than the single pass. The
  threshold is lowered in both packages' modules and the chunks shrunk
  (keyword arguments), so that several chunks run at a few thousand
  rows; no file changes;
* ``groupby_aggregate_chunked`` / ``groupby_aggregate_capped_chunked``
  and the ``None`` returns of the capacity protocol;
* ``sort_table_packed`` and ``inner_join_batched_packed`` and their
  ``None`` returns.

Inputs are made with numpy from a seed and carried into the port over the
same bytes. Tolerance 0: FLOAT64 sums are the JAX package's bytes.
"""

import functools
import json

import jax
import numpy as np
import pytest

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import groupby as jgb
from spark_rapids_jni_tpu.ops import groupby_chunked as jgc
from spark_rapids_jni_tpu.ops import groupby_packed as jgp
from spark_rapids_jni_tpu.ops import join_packed as jjp
from spark_rapids_jni_tpu.ops import sort_packed as jsp
from spark_rapids_jni_tpu.ops.sort import SortKey as JSortKey
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import interop, ops
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.ops import groupby as pgb
from spark_rapids_jni_tpu_torch.ops import groupby_chunked as pgc
from spark_rapids_jni_tpu_torch.ops import groupby_packed as pgp
from spark_rapids_jni_tpu_torch.ops import join_packed as pjp
from spark_rapids_jni_tpu_torch.ops import sort_packed as psp
from spark_rapids_jni_tpu_torch.ops.sort import SortKey
from spark_rapids_jni_tpu_torch.utils import config as pconfig

CHUNK = 512


@pytest.fixture(autouse=True)
def _clean():
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    for c in (jconfig, pconfig):
        c.clear_flag("GROUPBY_FORMULATION")
        c.clear_flag("BUCKETS")
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


def _buffers(t: JTable) -> list:
    return [(np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths),
             int(c.dtype.id), int(c.dtype.scale)) for c in t.columns]


def _port(jt: JTable):
    return interop.table_from_buffers(_buffers(jt), jt.names, device="cpu")


def _same(jt: JTable, pt) -> None:
    want, got = _buffers(jt), interop.table_to_buffers(pt)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w[3:] == g[3:], f"column {i} type"
        assert w[0].dtype == g[0].dtype, f"column {i} dtype"
        assert w[0].tobytes() == g[0].tobytes(), f"column {i} data"
        for part, a, b in (("validity", w[1], g[1]), ("lengths", w[2], g[2])):
            assert (a is None) == (b is None), f"column {i} {part}"
            if a is not None:
                np.testing.assert_array_equal(a, b, f"column {i} {part}")
    assert tuple(jt.names or ()) == tuple(pt.names or ())


def _fact(n: int, n_keys: int, seed: int, value_nulls: bool = False):
    """(k INT64, f FLOAT64 normal(50, 10), v INT64, d DECIMAL64)."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2 if value_nulls else None
    return JTable([
        JColumn.from_numpy(rng.integers(0, n_keys, n).astype(np.int64)),
        JColumn.from_numpy(rng.normal(50, 10, n), validity=valid),
        JColumn.from_numpy(rng.integers(-1000, 1000, n).astype(np.int64),
                           validity=valid),
        JColumn.from_numpy(rng.integers(-10**6, 10**6, n).astype(np.int64),
                           dtype=jdt.DType(jdt.TypeId.DECIMAL64, -2)),
    ], ["k", "f", "v", "d"])


# ---------------------------------------------------------------------------
# F8: the GROUPBY_FORMULATION router
# ---------------------------------------------------------------------------


@pytest.fixture
def small_router(monkeypatch):
    """The router's threshold at 16 rows and chunks of 512 rows, in both
    packages."""
    for gb in (jgb, pgb):
        monkeypatch.setattr(gb, "CHUNKED_MIN_ROWS", 16)
    for mod in (jgc, pgc):
        monkeypatch.setattr(mod, "groupby_aggregate_chunked", functools.partial(
            mod.groupby_aggregate_chunked, chunk_rows=CHUNK))
    for mod in (jgp, pgp):
        monkeypatch.setattr(mod, "groupby_aggregate_packed", functools.partial(
            mod.groupby_aggregate_packed, chunk_rows=CHUNK))


F8_AGGS = ("sum", "count", "min", "max")


def _jax_groupby(jt: JTable, formulation: str, aggs) -> JTable:
    """The JAX ``groupby_aggregate`` under ``formulation``; the single
    pass as its capped form jitted, sliced to the group count as the
    eager API does (the same bytes, compiled once)."""
    if formulation != "single":
        jconfig.set_flag("GROUPBY_FORMULATION", formulation)
        return jops.groupby_aggregate(jt, [0], aggs)
    padded, g = jax.jit(lambda t: jgb.groupby_aggregate_capped(
        t, [0], aggs, num_segments=t.row_count))(jt)
    g = int(g)
    return JTable([JColumn(c.data[:g], c.dtype,
                           None if c.validity is None else c.validity[:g])
                   for c in padded.columns], padded.names)


F8_COLS = [(1, a) for a in F8_AGGS] + [(2, "sum")]
_F8_WANT: dict = {}


def _f8_want(formulation: str) -> JTable:
    """The JAX package's bytes of F8's probe under ``formulation``, made
    once a process (the router tests and the float-sum test read the
    same run; ``small_router`` is on for all of them)."""
    if formulation not in _F8_WANT:
        _F8_WANT[formulation] = _jax_groupby(
            _fact(3000, 50, 3), formulation,
            [jops.GroupbyAgg(c, a) for c, a in F8_COLS])
    return _F8_WANT[formulation]


@pytest.mark.parametrize("formulation", ["single", "packed", "chunked"])
def test_f8_router_matches_jax(formulation, small_router):
    """F8's probe at a smaller size (3,000 rows, 50 keys, chunks of 512
    rows): each formulation's bytes in both packages."""
    pconfig.set_flag("GROUPBY_FORMULATION", formulation)
    got = ops.groupby_aggregate(_port(_fact(3000, 50, 3)), [0], [
        ops.GroupbyAgg(c, a) for c, a in F8_COLS])
    _same(_f8_want(formulation), got)


def test_f8_formulations_differ_in_float_sums(small_router):
    """The reason F8 shows: the FLOAT64 sums of the chunked and packed
    designs differ in bytes from the single pass (keys, counts and the
    INT64 sums do not), so a port that ignores the flag gives other
    bytes."""
    got = {f: [np.asarray(c.data) for c in _f8_want(f).columns]
           for f in ("single", "packed", "chunked")}
    for f in ("packed", "chunked"):
        for i in (0, 2, 5):  # key, count, INT64 sum
            np.testing.assert_array_equal(got[f][i], got["single"][i])
        assert (got[f][1] != got["single"][1]).any(), f


def test_f8_wire_groupby_without_a_bucket(small_router):
    """A wire groupby with no bucket (``BUCKETS=off``) reaches the router
    on the exact path in both packages."""
    rng = np.random.default_rng(5)
    n = 2000
    wire = ([4, 10], [0, 0], [rng.integers(0, 300, n).astype(np.int64)
                              .tobytes(), rng.normal(50, 10, n).tobytes()],
            [None, None], n)
    op = json.dumps({"op": "groupby", "by": [0],
                     "aggs": [{"column": 1, "agg": "sum"}]})
    for c in (jconfig, pconfig):
        c.set_flag("BUCKETS", "off")
        c.set_flag("GROUPBY_FORMULATION", "chunked")
    want = tuple(jrb.table_op_wire(op, *wire))
    assert tuple(rb.table_op_wire(op, *wire, device="cpu")) == want


def test_f8_flag_parse():
    for bad in ("fast", "", "single "):
        if bad.strip() in ("single", "packed", "chunked"):
            pconfig.set_flag("GROUPBY_FORMULATION", bad)
            assert pconfig.get_flag("GROUPBY_FORMULATION") == bad.strip()
            continue
        with pytest.raises(ValueError, match="GROUPBY_FORMULATION"):
            pconfig.set_flag("GROUPBY_FORMULATION", bad)
    assert pconfig.flag_default("GROUPBY_FORMULATION") == "single"


# ---------------------------------------------------------------------------
# the chunked groupby
# ---------------------------------------------------------------------------

CHUNKED_AGGS = ("sum", "count", "min", "max", "mean", "first", "last")


def test_capped_chunked_matches_jax():
    jt = _fact(1300, 40, 11, value_nulls=True)
    aggs = [(1, a) for a in CHUNKED_AGGS] + [(3, "mean"), (3, "max")]
    jaggs = tuple(jops.GroupbyAgg(c, a) for c, a in aggs)
    want, wg, wmax = jgc._jit_capped_chunked(jt, (0,), jaggs, 256, 256, 64)
    got, g, gmax = ops.groupby_aggregate_capped_chunked(
        _port(jt), [0], [ops.GroupbyAgg(c, a) for c, a in aggs],
        num_segments=256, chunk_rows=256, chunk_segments=64)
    assert (int(g), int(gmax)) == (int(wg), int(wmax))
    g = int(g)
    cut = JTable([JColumn(c.data[:g], c.dtype,
                          None if c.validity is None else c.validity[:g])
                  for c in want.columns], want.names)
    _same(cut, ops.slice_rows(got, 0, g))


@pytest.mark.parametrize("later_keys", [200])
def test_chunked_eager_matches_jax(later_keys):
    """The capacity protocol: chunk 0 (10 keys) sizes the capacity at 128
    segments; 200 keys in the later chunks overflow it once, and the run
    doubles to 256."""
    jt = _fact(2100, 10, later_keys)
    rng = np.random.default_rng(later_keys)
    keys = np.asarray(jt.columns[0].data).copy()
    keys[CHUNK:] = rng.integers(0, later_keys, 2100 - CHUNK)
    jt = JTable([JColumn.from_numpy(keys), *jt.columns[1:]], jt.names)
    aggs = [(1, "sum"), (2, "min"), (3, "mean"), (2, "first")]
    want = jgc.groupby_aggregate_chunked(
        jt, [0], [jops.GroupbyAgg(c, a) for c, a in aggs], chunk_rows=CHUNK)
    got = ops.groupby_aggregate_chunked(
        _port(jt), [0], [ops.GroupbyAgg(c, a) for c, a in aggs],
        chunk_rows=CHUNK)
    assert want is not None and got is not None
    _same(want, got)


def test_chunked_none_returns():
    jt = _fact(2100, 30, 1)
    pt = _port(jt)
    agg = [ops.GroupbyAgg(1, "sum")]
    # no more rows than one chunk
    assert ops.groupby_aggregate_chunked(pt, [0], agg, chunk_rows=4096) is None
    # a non-decomposable aggregation
    assert ops.groupby_aggregate_chunked(
        pt, [0], [ops.GroupbyAgg(1, "variance")], chunk_rows=CHUNK) is None
    assert not pgc.chunked_groupby_supported(
        pt, [ops.GroupbyAgg(1, "nunique")])
    # near-distinct keys: chunk 0 holds more than a quarter of its rows
    # as groups, in both packages
    distinct = _fact(2100, 1 << 40, 2)
    assert jgc.groupby_aggregate_chunked(
        distinct, [0], [jops.GroupbyAgg(1, "sum")], chunk_rows=CHUNK) is None
    assert ops.groupby_aggregate_chunked(
        _port(distinct), [0], agg, chunk_rows=CHUNK) is None


# ---------------------------------------------------------------------------
# the packed sort
# ---------------------------------------------------------------------------


def _sort_table(n: int, seed: int):
    rng = np.random.default_rng(seed)
    strs = [f"s{int(x)}" if x % 7 else None for x in rng.integers(0, 99, n)]
    return JTable([
        JColumn.from_numpy(rng.integers(-40, 40, n).astype(np.int64)),
        JColumn.from_numpy(rng.integers(0, 365, n).astype(np.int32)),
        JColumn.from_numpy(rng.normal(0, 1, n),
                           validity=rng.random(n) > 0.3),
        JColumn.from_strings(strs),
        JColumn.from_numpy(rng.integers(0, 200, n).astype(np.uint16)),
    ], ["a", "b", "f", "s", "u"])


SORT_CASES = {
    "one_key": [0],
    "desc": [JSortKey(1, ascending=False)],
    "mixed_two_keys": [JSortKey(1, ascending=True),
                       JSortKey(0, ascending=False)],
    "unsigned_then_int": ["u", "a"],
}


@pytest.mark.parametrize("n", [1, 1025])
@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_sort_table_packed_matches_jax(case, n):
    jt = _sort_table(n, n)
    jkeys = SORT_CASES[case]
    pkeys = [SortKey(k.column, ascending=k.ascending)
             if isinstance(k, JSortKey) else k for k in jkeys]
    want = jsp.sort_table_packed(jt, jkeys)
    got = psp.sort_table_packed(_port(jt), pkeys)
    _same(want, got)
    _same(want, ops.sort_table(_port(jt), [
        k if isinstance(k, SortKey) else SortKey(k) for k in pkeys]))


def test_sort_table_packed_none_returns():
    pt = _port(_sort_table(50, 4))
    assert psp.sort_table_packed(pt, [2]) is None  # float key
    assert psp.sort_table_packed(pt, [3]) is None  # string key
    assert psp.sort_table_packed(pt, [0, 0]) is None  # duplicate column
    assert psp.sort_table_packed(pt, []) is None
    assert psp.sort_table_packed(ops.slice_rows(pt, 0, 0), [0]) is None
    wide = JTable([JColumn.from_numpy(
        np.array([-(1 << 62), 1 << 62, 0], np.int64))])
    assert jsp.sort_table_packed(wide, [0]) is None
    assert psp.sort_table_packed(_port(wide), [0]) is None
    nullable = JTable([JColumn.from_numpy(np.arange(4, dtype=np.int64),
                                          validity=np.array([1, 0, 1, 1],
                                                            bool))])
    assert psp.sort_table_packed(_port(nullable), [0]) is None


# ---------------------------------------------------------------------------
# the packed join
# ---------------------------------------------------------------------------


def _join_sides(n: int, m: int, seed: int, unique: bool):
    rng = np.random.default_rng(seed)
    rk = (rng.permutation(m) if unique else rng.integers(0, m // 2, m))
    left = JTable([
        JColumn.from_numpy(rng.integers(-5, m + 5, n).astype(np.int64)),
        JColumn.from_numpy(rng.integers(0, 4, n).astype(np.int32)),
        JColumn.from_numpy(rng.normal(0, 1, n), validity=rng.random(n) > 0.2),
    ], ["k", "k2", "x"])
    right = JTable([
        JColumn.from_numpy(rk.astype(np.int64)),
        JColumn.from_numpy(rng.integers(0, 4, m).astype(np.int32)),
        JColumn.from_strings([f"r{i}" for i in range(m)]),
    ], ["k", "k2", "name"])
    return left, right


@pytest.mark.parametrize("on,unique", [(["k"], False), (["k", "k2"], True)],
                         ids=["one_key_dups", "two_keys_unique"])
def test_inner_join_batched_packed_matches_jax(on, unique):
    left, right = _join_sides(3000, 400, 7, unique)
    want = jjp.inner_join_batched_packed(left, right, on, probe_rows=1100)
    got = pjp.inner_join_batched_packed(_port(left), _port(right), on,
                                        probe_rows=1100)
    _same(want, got)
    # the same rows as the general batched join
    _same(want, ops.inner_join_batched(_port(left), _port(right), on,
                                       probe_rows=1100))


def test_inner_join_batched_packed_no_match_and_none_returns():
    left, right = _join_sides(50, 20, 9, True)
    far = JTable([JColumn.from_numpy(np.full(50, 10_000, np.int64)),
                  left.columns[1], left.columns[2]], ["k", "k2", "x"])
    _same(jjp.inner_join_batched_packed(far, right, ["k"]),
          pjp.inner_join_batched_packed(_port(far), _port(right), ["k"]))
    pl, pr = _port(left), _port(right)
    assert pjp.inner_join_batched_packed(pl, pr, ["x"], ["k"]) is None
    assert pjp.inner_join_batched_packed(
        ops.slice_rows(pl, 0, 0), pr, ["k"]) is None
    wide = JTable([JColumn.from_numpy(np.array([-(1 << 62), 1 << 62],
                                               np.int64))], ["k"])
    assert jjp.inner_join_batched_packed(wide, wide, ["k"]) is None
    assert pjp.inner_join_batched_packed(_port(wide), _port(wide),
                                         ["k"]) is None
    with pytest.raises(ValueError, match="probe_rows"):
        pjp.inner_join_batched_packed(pl, pr, ["k"], probe_rows=0)


def test_packed_groupby_engine_choice():
    """On the CPU the eager packed groupby keeps the JAX package's stable
    sort; on a CUDA table it takes K4b where the u32 word fits, else
    K4a."""
    jt = _fact(3000, 500, 3)
    assert pgp._engine(_port(jt), 499, 1 << 18) == "lax"

    class _Cuda:
        is_cuda = True

    class _Col:
        data = _Cuda()

    class _T:
        columns = [_Col()]

    assert pgp._engine(_T(), 10_000, 1 << 17) == "pallas32"
    assert pgp._engine(_T(), 1 << 15, 1 << 17) == "pallas"
    assert pgp._engine(_T(), 10, 1000) == "lax"  # chunk not a power of two
