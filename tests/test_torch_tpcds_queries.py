"""The port's TPC-DS query tier (``spark_rapids_jni_tpu_torch.tpcds``:
``datagen`` and ``queries``) against the JAX repository's ``benchmarks/``
on the CPU.

The same seeds give both packages their tables; every result is compared
byte for byte (tolerance 0): names, row count, and each column's data,
validity and string lengths. The mesh queries run on a mesh of 4: the
JAX side on 4 of conftest's virtual CPU devices with its ``shard_map``
under ``jax.jit`` (as in ``test_torch_parallel.py``: eager ``shard_map``
compiles its body a primitive at a time), the port on ``[cpu] * 4``.
``q5_distributed``'s padded shards, counts and overflow equal the JAX
function's; q23's and q64's mesh results, unpadded, equal the
single-device results of both packages row for row.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from benchmarks import datagen as jdatagen
from benchmarks import queries as jq
from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu import parallel as jpar
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.parallel import distributed as jdist
from spark_rapids_jni_tpu.parallel import mesh as jmesh
from spark_rapids_jni_tpu.parallel import planmesh as jplanmesh
from spark_rapids_jni_tpu.parallel import shuffle as jshuffle
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import parallel
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
from spark_rapids_jni_tpu_torch.tpcds import datagen, queries

P = 4
CPU4 = [torch.device("cpu")] * P
ROWS, SEED = 400, 3


@pytest.fixture(scope="module", autouse=True)
def _jit_jax_shard_map():
    """The JAX tier's shard_map programs under jax.jit (module
    docstring); restored after the module."""
    orig = jmesh.shard_map
    mods = (jmesh, jshuffle, jdist, jplanmesh)
    saved = [m.shard_map for m in mods]
    for m in mods:
        m.shard_map = lambda f, **kw: jax.jit(orig(f, **kw))
    yield
    for m, f in zip(mods, saved):
        m.shard_map = f


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def _host(x):
    if x is None:
        return None
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.shape, a.dtype.itemsize, a.tobytes()


def _columns(t) -> list:
    return [(_host(c.data), _host(c.validity), _host(c.lengths))
            for c in t.columns]


def same_table(jt, tt) -> None:
    """A JAX table and a port table (a sharded one in mesh order): the
    same names, row count, dtypes and bytes in every buffer."""
    if isinstance(tt, pmesh.Sharded):
        tt = tt.concat()
    assert tuple(tt.names) == tuple(jt.names)
    assert tt.row_count == jt.row_count
    assert [(d.id.value, d.scale) for d in tt.dtypes()] == [
        (c.dtype.id.value, c.dtype.scale) for c in jt.columns]
    for name, a, b in zip(jt.names, _columns(jt), _columns(tt)):
        assert a == b, f"column {name} differs"


def same_array(ja, t) -> None:
    if isinstance(t, pmesh.Sharded):
        t = t.concat()
    assert _host(ja) == _host(t), f"{np.asarray(ja)} != {t}"


def _rows(t, key: str) -> list:
    """A table's rows as tuples of each buffer's bytes, sorted by the
    bytes of ``key`` (a mesh result's order is its shards')."""
    cols = []
    for c in t.columns:
        data = (c.data.cpu().numpy() if isinstance(c.data, torch.Tensor)
                else np.asarray(c.data))
        n = data.shape[0]
        val = (np.ones(n, bool) if c.validity is None
               else (c.validity.cpu().numpy()
                     if isinstance(c.validity, torch.Tensor)
                     else np.asarray(c.validity)))
        cols.append([(data[i].tobytes(), bool(val[i])) for i in range(n)])
    k = list(t.names).index(key)
    rows = list(zip(*cols))
    return sorted(rows, key=lambda r: r[k])


# ---------------------------------------------------------------------------
# fixtures: one generation and one JAX run per input
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tables():
    return (jdatagen.generate(ROWS, seed=SEED),
            datagen.generate(ROWS, seed=SEED, device="cpu"))


@pytest.fixture(scope="module")
def meshes():
    return jpar.make_mesh(P), parallel.make_mesh(P, devices=CPU4)


# item prices in cents on q64's cutoff edges, cycled over the items:
# at $150.00, one cent above and below; past 2^24 cents, where a float32
# comparison would keep 16777217 <= 16777216.0
EDGE_PRICES = {150.0: [15000, 15001, 14999, 50],
               167772.16: [16777216, 16777217, 16777215, 16777218]}


def with_prices(tabs: dict, prices, j: bool) -> dict:
    """``tabs`` with the item prices ``prices`` (cycled)."""
    item = tabs["item"]
    cents = np.resize(np.asarray(prices, np.int64), item.row_count)
    cols = list(item.columns)
    cols[3] = (JColumn.from_numpy(cents, dtype=jdt.decimal64(-2)) if j
               else Column.from_numpy(cents, dtype=dt.decimal64(-2),
                                      device="cpu"))
    out = dict(tabs)
    out["item"] = (JTable if j else Table)(cols, list(item.names))
    return out


@pytest.fixture(scope="module")
def single(tables):
    """Each query on one device, (JAX, port); q64 over items priced on
    its $150.00 cutoff's edges. The JAX queries run at once on threads
    (their time is XLA's per-shape compiles, which release the
    interpreter lock); the port's run on this thread meanwhile."""
    jt, tt = tables
    inputs = {"q5": (jt, tt), "q23": (jt, tt),
              "q64": (with_prices(jt, EDGE_PRICES[150.0], True),
                      with_prices(tt, EDGE_PRICES[150.0], False))}
    with ThreadPoolExecutor(len(inputs)) as pool:
        jax_runs = {q: pool.submit(getattr(jq, q), j)
                    for q, (j, _) in inputs.items()}
        port = {q: getattr(queries, q)(t) for q, (_, t) in inputs.items()}
        return {q: (jax_runs[q].result(), port[q]) for q in inputs}


# ---------------------------------------------------------------------------
# datagen
# ---------------------------------------------------------------------------


TABLE_NAMES = ["store_sales", "web_sales", "item", "customer", "date_dim"]


@pytest.mark.parametrize("rows,seed", [(ROWS, SEED), (2000, 11)])
def test_datagen_matches_jax(tables, rows, seed):
    if (rows, seed) == (ROWS, SEED):
        jt, tt = tables
    else:
        jt = jdatagen.generate(rows, seed=seed)
        tt = datagen.generate(rows, seed=seed, device="cpu")
    assert list(tt) == list(jt) == TABLE_NAMES
    for name in TABLE_NAMES:
        same_table(jt[name], tt[name])
    assert tt["store_sales"]["sales_price"].dtype == dt.decimal64(-2)
    assert tt["item"]["brand"].dtype == dt.STRING


def test_datagen_builds_on_the_asked_device():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            datagen.generate(16, seed=0)


# ---------------------------------------------------------------------------
# the single-device queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["q5", "q23", "q64"])
def test_single_device_query_matches_jax(single, name):
    jres, tres = single[name]
    assert tres.row_count > 0
    same_table(jres, tres)


def test_date_filter_matches_jax(tables):
    jt, tt = tables
    for lo, hi in ((100, 200), (0, 1), (729, 730), (5, 5)):
        same_table(jq._date_filter(jt["web_sales"], lo, hi),
                   queries._date_filter(tt["web_sales"], lo, hi))


# ---------------------------------------------------------------------------
# the mesh queries
# ---------------------------------------------------------------------------


def test_q5_distributed_padded_matches_jax(tables, meshes):
    jt, tt = tables
    jm, tm = meshes
    jres = jq.q5_distributed(jt, jm)
    tres = queries.q5_distributed(tt, tm)
    assert len(jres) == len(tres) == 3
    same_table(jres[0], tres[0])
    same_array(jres[1], tres[1])
    same_array(jres[2], tres[2])
    assert int(tres[2].max()) <= 0
    # unpadded, the JAX function's rows and the single-device q5's
    same_table(jq.unpad_groupby(jres[0], jres[1]),
               queries.unpad_groupby(tres[0], tres[1]))
    got = queries.unpad_groupby(tres[0], tres[1])
    assert (_rows(got, "category_id")
            == _rows(queries.q5(tt), "category_id"))


def test_q23_distributed_equals_single_device(tables, meshes, single):
    _, tt = tables
    _, tm = meshes
    padded, counts, overflow = queries.q23_distributed(tt, tm)
    assert int(overflow.max()) <= 0
    got = queries.unpad_groupby(padded, counts)
    jres, tres = single["q23"]
    want = _rows(tres, "customer_sk")
    assert _rows(got, "customer_sk") == want == _rows(jres, "customer_sk")
    assert tuple(got.names) == tuple(jres.names)


def test_q64_distributed_equals_single_device(tables, meshes, single):
    _, tt = tables
    _, tm = meshes
    got = queries.q64_distributed(
        with_prices(tt, EDGE_PRICES[150.0], False), tm)
    jres, _ = single["q64"]
    same_table(jres, got)


# ---------------------------------------------------------------------------
# padding: _pad_to_mesh, _real_mask, unpad_groupby
# ---------------------------------------------------------------------------


def _pad_inputs(n: int, first: str = "int64"):
    """(JAX table, port table) of ``n`` rows: a key column of ``first``'s
    type, then INT32, FLOAT64, DECIMAL128, a nullable INT64 and a
    nullable STRING."""
    rng = np.random.default_rng(n)
    key = rng.integers(-5, 50, n)
    key = key.astype(np.int32 if first == "int32" else np.int64)
    i32 = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    f64 = rng.standard_normal(n) * 1e3
    f64[::5] = -0.0
    d128 = [int(v) * 10**20 + 7 for v in rng.integers(-10**6, 10**6, n)]
    nv = rng.integers(0, 9, n).astype(np.int64)
    ok = rng.random(n) > 0.3
    words = ["", "a", "bc", "def", "ghij"]
    s = [None if rng.random() < 0.2 else words[i]
         for i in rng.integers(0, 5, n)]
    names = ["k", "i32", "f64", "d128", "nv", "s"]
    j = JTable([JColumn.from_numpy(key), JColumn.from_numpy(i32),
                JColumn.from_numpy(f64), JColumn.from_decimal128(d128, -3),
                JColumn.from_numpy(nv, ok), JColumn.from_strings(s)], names)
    t = Table([Column.from_numpy(key, device="cpu"),
               Column.from_numpy(i32, device="cpu"),
               Column.from_numpy(f64, device="cpu"),
               Column.from_decimal128(d128, -3, device="cpu"),
               Column.from_numpy(nv, ok, device="cpu"),
               Column.from_strings(s, device="cpu")], names)
    return j, t


@pytest.mark.parametrize("n", [9, 10, 11, 12])
def test_pad_to_mesh_matches_jax(meshes, n):
    jm, tm = meshes
    j, t = _pad_inputs(n)
    jp, tp = jq._pad_to_mesh(j, jm), queries._pad_to_mesh(t, tm)
    same_table(jp, tp)
    assert tp.row_count % P == 0
    if n % P == 0:
        assert tp is t  # a row count the mesh divides stays as it is


def test_pad_fill_bytes():
    """The sentinel as the JAX package's astype gives it: 0 in INT32,
    -2^62 in both DECIMAL128 limbs, and in a FLOAT64 the pattern -2^62
    (the JAX storage is the uint64 bit pattern, which the cast wraps)."""
    _, t = _pad_inputs(10)
    tp = queries._pad_to_mesh(t, parallel.make_mesh(P, devices=CPU4))
    tail = {name: c.data[10:].cpu().numpy() for name, c in
            zip(tp.names, tp.columns)}
    assert (tail["k"] == -(2**62)).all() and (tail["i32"] == 0).all()
    assert (tail["f64"] == -(2**62)).all()
    assert (tail["d128"] == -(2**62)).all() and tail["d128"].shape == (2, 2)
    assert (tp["s"].lengths[10:] == 0).all() and not tp["s"].data[10:].any()
    assert tp["nv"].validity[10:].all()


@pytest.mark.parametrize("n,counts,first", [
    (10, [3, 1, 2, 0], "int64"),
    (12, [3, 3, 3, 3], "int64"),
    (11, [2, 3, 0, 3], "int32"),
])
def test_unpad_groupby_matches_jax(meshes, n, counts, first):
    jm, tm = meshes
    j, t = _pad_inputs(n, first)
    jp, tp = jq._pad_to_mesh(j, jm), queries._pad_to_mesh(t, tm)
    cnt = np.asarray(counts, np.int32)
    same_table(jq.unpad_groupby(jp, cnt),
               queries.unpad_groupby(tp, torch.from_numpy(cnt)))
    # a sharded value unpads as its concatenation does
    sharded = pmesh.shard_table(tp, tm)
    on_mesh = pmesh.on_mesh([torch.tensor(c) for c in counts], tm)
    same_table(jq.unpad_groupby(jp, cnt),
               queries.unpad_groupby(sharded, on_mesh))
    assert queries._unpad_groupby is queries.unpad_groupby


def test_unpad_occupancy_matches_jax(meshes):
    jm, tm = meshes
    j, t = _pad_inputs(10)
    jp, tp = jq._pad_to_mesh(j, jm), queries._pad_to_mesh(t, tm)
    occ = np.random.default_rng(0).random(tp.row_count) > 0.4
    same_table(jq._unpad_occupancy(jp, occ),
               queries._unpad_occupancy(tp, torch.from_numpy(occ)))


# ---------------------------------------------------------------------------
# q64's price cutoff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_price", sorted(EDGE_PRICES))
def test_price_cutoff_matches_jax(tables, single, max_price):
    """q64's cheap items on the cutoff's edges (EDGE_PRICES): at $150.00
    through the whole of q64, past 2^24 cents through its item filter."""
    jt, tt = tables
    prices = EDGE_PRICES[max_price]
    item = with_prices(tt, prices, False)["item"]
    cheap = queries._cheap_items(item, max_price)
    if max_price == 150.0:  # q64's default, run whole in ``single``
        jres, tres = single["q64"]
        same_table(jres, tres)
    else:
        # JAX q64's item filter as its source writes it
        # (benchmarks/queries.py:172-180): the int64 cents against the
        # float cutoff under x64
        jitem = with_prices(jt, prices, True)["item"]
        price = jitem["current_price"]
        keep = jops.compute.values(price) <= jq._price_cutoff(price,
                                                             max_price)
        same_table(jops.filter_table(jitem, JColumn(keep, jdt.BOOL8, None)),
                   cheap)
    kept = set(cheap["current_price"].to_numpy().tolist())
    cutoff = queries._price_cutoff(tt["item"]["current_price"], max_price)
    assert cutoff == jq._price_cutoff(jt["item"]["current_price"], max_price)
    assert kept == {p for p in prices if p <= cutoff}
