"""The port's window functions (``ops/window.py``) against the JAX
package's, on the CPU: ROW frames (rolling and grouped), RANGE frames
(ascending and descending, bounded and unbounded, saturating at the
INT64/UINT64 extremes), lead/lag and the rank family.

Both packages get the same numpy inputs from a seed (the port's through
``interop.column_from_buffers``); the JAX functions run eagerly, as its
own tests call them. Tolerance 0: data bytes (nulls' payloads
included), validity, dtype. A NaN equals a NaN whatever its sign and
payload: where +inf and -inf meet in a running sum, the NaN's sign bit
follows the operand order inside XLA's scan, which the port does not
reproduce (ROADMAP Queue 3, "Recorded"). Sizes 0, 1, 2, 1023, 1024, 1025; inputs
with nulls, NaN, +-0.0, +-inf, subnormals, integer extremes, one-row and
all-null partitions and ties in the order keys.
"""

import numpy as np
import pytest

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu.ops import window as jw
from spark_rapids_jni_tpu.ops.sort import SortKey as JSortKey
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.column import Table
from spark_rapids_jni_tpu_torch.ops import window as pw
from spark_rapids_jni_tpu_torch.ops.sort import SortKey

SIZES = (0, 1, 2, 1023, 1024, 1025)
VALUES = ("f", "g", "i", "u", "d")
#: sizes that run every value type and frame; the others run FLOAT64
#: (the scan16 order's block edges) and INT64 (the JAX side compiles
#: its ops once per shape and dtype, a few seconds each)
FULL_SIZES = (2, 1025)


def _bufs(c: JColumn):
    return (np.asarray(c.data),
            None if c.validity is None else np.asarray(c.validity),
            None if c.lengths is None else np.asarray(c.lengths),
            int(c.dtype.id), int(c.dtype.scale))


def _port_table(jt: JTable) -> Table:
    return interop.table_from_buffers([_bufs(c) for c in jt.columns],
                                      jt.names, device="cpu")


FLOAT_VIEW = {10: np.float64, 9: np.float32}


def _same(jc: JColumn, pc, what="") -> None:
    w, g = _bufs(jc), interop.column_to_buffers(pc)
    assert w[3:] == g[3:], f"{what} type"
    for part, a, b in zip(("data", "validity", "lengths"), w[:3], g[:3]):
        assert (a is None) == (b is None), f"{what} {part} presence"
        if a is None:
            continue
        assert a.dtype == b.dtype, f"{what} {part} dtype"
        if part == "data" and w[3] in FLOAT_VIEW:
            fa, fb = a.view(FLOAT_VIEW[w[3]]), b.view(FLOAT_VIEW[w[3]])
            np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb),
                                          f"{what} NaN rows")
            a, b = a[~np.isnan(fa)], b[~np.isnan(fa)]
        np.testing.assert_array_equal(a, b, f"{what} {part}")


def _floats(rng, n):
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
    for frac, v in ((0.04, np.nan), (0.04, -0.0), (0.04, 0.0),
                    (0.02, np.inf), (0.02, -np.inf), (0.03, 5e-324),
                    (0.03, -2.5e-310)):
        f[rng.random(n) < frac] = v
    return f


def _table(n: int, seed: int) -> JTable:
    """p INT32 partitions (nulls; a one-row and an all-null-value
    partition), o INT64 order with ties and nulls, f FLOAT64, g FLOAT32,
    i INT64 near the extremes, u UINT64 near the extremes, d DECIMAL64,
    t TIMESTAMP_DAYS with ties, all ~15 % null."""
    rng = np.random.default_rng(seed)

    def ok():
        return rng.random(n) > 0.15

    p = rng.integers(0, 6, n).astype(np.int32)
    if n > 3:
        p[0] = 99  # a one-row partition
        p[1:3] = 77  # a partition whose values are all null
    vmask = ok()
    if n > 3:
        vmask[1:3] = False
    big = np.iinfo(np.int64)
    i = rng.integers(-1000, 1000, n)
    i[rng.random(n) < 0.05] = big.max
    i[rng.random(n) < 0.05] = big.min
    i[rng.random(n) < 0.05] = big.max - 3
    u = rng.integers(0, 1000, n).astype(np.uint64)
    u[rng.random(n) < 0.05] = np.uint64(2**64 - 1)
    u[rng.random(n) < 0.05] = np.uint64(2**64 - 5)
    f = _floats(rng, n)
    return JTable([
        JColumn.from_numpy(p, validity=ok()),
        JColumn.from_numpy(rng.integers(0, 40, n), validity=ok()),
        JColumn.from_numpy(f, validity=vmask),
        JColumn.from_numpy(f.astype(np.float32), validity=ok()),
        JColumn.from_numpy(i, validity=ok()),
        JColumn.from_numpy(u, validity=ok()),
        JColumn.from_numpy(rng.integers(-10**6, 10**6, n), validity=ok(),
                           dtype=jdt.decimal64(-2)),
        JColumn.from_numpy(rng.integers(-800, 800, n).astype(np.int32),
                           validity=ok(),
                           dtype=jdt.DType(jdt.TypeId.TIMESTAMP_DAYS)),
    ], ["p", "o", "f", "g", "i", "u", "d", "t"])


@pytest.fixture(scope="module", autouse=True)
def _jit_integer_steps():
    """The JAX package's integer steps jitted: the sparse table of
    positions and the multi-word binary search of the RANGE frames.
    Integer compares and selects give the eager bytes; jitted they cost
    one XLA compile a shape instead of one a step, level and shape. The
    sort scaffold (an argsort of order words, gathers and run
    boundaries) runs eagerly once for each table and key list, as every
    test asks it again of the same table. The float steps (the prefix
    sums, means, the frame level's log2) run eagerly."""
    import jax

    saved = (jw._sparse_table_pos, jjoin._lex_searchsorted,
             jw._window_scaffold)
    scaffolds = {}

    def scaffold(table, partition_by, order_by):
        key = (id(table), repr(partition_by), repr(order_by))
        if key not in scaffolds:
            scaffolds[key] = (table, saved[2](table, partition_by,
                                              order_by))
        return scaffolds[key][1]

    jw._sparse_table_pos = jax.jit(saved[0], static_argnums=2)
    jjoin._lex_searchsorted = jax.jit(saved[1], static_argnums=2)
    jw._window_scaffold = scaffold
    yield
    jw._sparse_table_pos, jjoin._lex_searchsorted, jw._window_scaffold = saved


@pytest.fixture(scope="module")
def tables():
    """One table per size, shared by every test of the file (the JAX
    side compiles its ops once per shape)."""
    out = {}
    for n in SIZES:
        jt = _table(n, 11 + n)
        out[n] = (jt, _port_table(jt))
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("agg", ["sum", "count", "mean", "min", "max"])
def test_grouped_rolling(tables, n, agg):
    jt, pt = tables[n]
    for value in VALUES if n in FULL_SIZES else ("f", "i"):
        frames = [(2, 1, 1)]
        if value in ("f", "i"):
            frames += [(0, 0, 1), (6, 3, 3), (-1, 2, 1)]
        for pre, fol, minp in frames:
            args = (["p"], ["o"], value, pre, fol, agg, minp)
            _same(jw.grouped_rolling_aggregate(jt, *args),
                  pw.grouped_rolling_aggregate(pt, *args),
                  f"{value} {pre} {fol}")


@pytest.mark.parametrize("n", SIZES)
def test_rolling_unpartitioned(tables, n):
    jt, pt = tables[n]
    for value in ("f", "g", "d"):
        for agg in ("sum", "mean", "min", "max"):
            _same(jw.rolling_aggregate(jt.column(value), 3, 2, agg),
                  pw.rolling_aggregate(pt.column(value), 3, 2, agg),
                  f"{value} {agg}")


@pytest.mark.parametrize("length", [3, 4, 5, 7, 8, 9, 63, 64, 65])
def test_minmax_block_level(tables, length):
    """Frames of 2^k - 1, 2^k and 2^k + 1 rows: the port's block level
    is bit_length - 1, the JAX package's a float log2 (one lower at some
    powers of two); both give the same bytes, null payloads included."""
    jt, pt = tables[1025]
    for value in ("f", "u"):
        for agg in ("min", "max"):
            _same(jw.rolling_aggregate(jt.column(value), length - 1, 0, agg),
                  pw.rolling_aggregate(pt.column(value), length - 1, 0, agg),
                  f"{value} {agg} {length}")


RANGE_CASES = [
    ("o", 3, 2, True), ("o", None, 0, True), ("o", 0, None, False),
    ("t", 30, 0, True), ("t", 5, 7, False), ("i", 10, 10, True),
    ("i", 2**62, 2**63, False), ("u", 3, 0, True), ("u", None, 2**63, False),
    ("f", 1.5, 0.5, True), ("d", 500, 0, True),
]


#: every case at the sizes of FULL_SIZES and the empty table; the
#: INT64 and FLOAT64 order columns at every size
RANGE_PARAMS = [(n, *case) for n in SIZES for case in RANGE_CASES
                if n in (0, *FULL_SIZES) or case[0] in ("o", "f")]


@pytest.mark.parametrize("n,order,pre,fol,asc", RANGE_PARAMS)
def test_range_frames(tables, n, order, pre, fol, asc):
    jt, pt = tables[n]
    value, agg = {"o": ("f", "sum"), "t": ("i", "count"), "i": ("g", "max"),
                  "u": ("d", "mean"), "f": ("u", "min"),
                  "d": ("f", "mean")}[order]
    args = (["p"], order, value, pre, fol, agg, 1, asc)
    _same(jw.grouped_range_rolling_aggregate(jt, *args),
          pw.grouped_range_rolling_aggregate(pt, *args), f"{value} {agg}")


def test_range_uint64_saturates():
    """UINT64 RANGE frames reaching past 2^64 - 1 saturate on the bit
    patterns (the JAX package raises OverflowError on a positive UINT64
    offset); counts against a Python-int oracle."""
    top = 2**64 - 1
    vals = np.array([top, top - 2, top - 7, 5, 0, 2**63, 2**63 - 1],
                    np.uint64)
    pt = Table.from_pydict({"p": np.zeros(7, np.int32), "u": vals,
                            "x": np.ones(7, np.int64)}, device="cpu")
    for pre, fol in ((3, 10), (0, 2**64), (2**63, 0), (None, 1)):
        got = pw.grouped_range_rolling_aggregate(
            pt, ["p"], "u", "x", pre, fol, "count").to_numpy()
        v = [int(x) for x in vals]
        want = [sum(1 for y in v
                    if (pre is None or y >= x - pre) and y <= x + fol)
                for x in v]
        np.testing.assert_array_equal(got, want, f"{pre} {fol}")


@pytest.mark.parametrize("n", SIZES)
def test_saturating_offset(n):
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(n)
    for np_dt, torch_dt in ((np.int64, torch.int64), (np.uint64, torch.uint64),
                            (np.int8, torch.int8), (np.uint32, torch.uint32)):
        info = np.iinfo(np_dt)
        v = rng.integers(int(info.min), int(info.max), n, dtype=np_dt,
                         endpoint=True)
        if n > 2:
            v[0], v[1] = info.min, info.max
        for delta in (1, -1, 2**62, -(2**62), 2**63, -(2**64), 2**65):
            got = pw._saturating_offset(torch.from_numpy(v), delta).numpy()
            oracle = [min(max(int(x) + delta, int(info.min)), int(info.max))
                      for x in v]
            np.testing.assert_array_equal(got, np.array(oracle, np_dt))
            if np_dt == np.uint64 and delta > 0:
                continue  # the JAX package raises OverflowError here
            want = np.asarray(jw._saturating_offset(jnp.asarray(v), delta))
            np.testing.assert_array_equal(want, got, f"{np_dt} {delta}")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fn", ["lead", "lag"])
def test_lead_lag(tables, n, fn):
    import jax.numpy as jnp

    jt, pt = tables[n]
    pids = np.random.default_rng(n).integers(0, 3, n).astype(np.int32)
    pids.sort()
    import torch

    for value in ("f", "u", "t"):
        for k in (1, 2, 0):
            _same(getattr(jw, fn)(jt.column(value), k, jnp.asarray(pids)),
                  getattr(pw, fn)(pt.column(value), k, torch.from_numpy(pids)),
                  f"{value} {k}")
        _same(getattr(jw, fn)(jt.column(value), 1),
              getattr(pw, fn)(pt.column(value), 1), value)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fn", ["row_number", "rank", "dense_rank",
                                "percent_rank"])
def test_ranks(tables, n, fn):
    jt, pt = tables[n]
    for part, order in ((["p"], ["o"]), (["p"], ["t", "f"]), ([], ["o"]),
                        (["p", "t"], ["u"])):
        _same(getattr(jw, fn)(jt, part, order),
              getattr(pw, fn)(pt, part, order), f"{part} {order}")


@pytest.mark.parametrize("n", SIZES)
def test_ntile(tables, n):
    jt, pt = tables[n]
    for tiles in (1, 3, 4, 2000):
        _same(jw.ntile(jt, ["p"], ["o"], tiles),
              pw.ntile(pt, ["p"], ["o"], tiles), f"{tiles}")
    with pytest.raises(ValueError, match="n_tiles must be positive"):
        pw.ntile(pt, ["p"], ["o"], 0)


def test_row_number_descending_key(tables):
    """A descending SortKey order term: row_number/ntile go through the
    same scaffold as the JAX package's."""
    jt, pt = tables[1025]
    _same(jw.row_number(jt, ["p"], [JSortKey("f", ascending=False)]),
          pw.row_number(pt, ["p"], [SortKey("f", ascending=False)]))
    _same(jw.ntile(jt, ["p"], [JSortKey("o", ascending=False)], 4),
          pw.ntile(pt, ["p"], [SortKey("o", ascending=False)], 4))


def test_rank_descending_key_against_numpy():
    """The port's rank family also takes SortKey order terms (the JAX
    package's raise on them): rank, dense_rank and percent_rank by
    price descending within each item, against a numpy oracle."""
    rng = np.random.default_rng(7)
    n = 1025
    item = rng.integers(0, 20, n)
    price = rng.integers(0, 30, n).astype(np.float64) / 4
    pt = Table.from_pydict({"item": item, "price": price}, device="cpu")
    key = [SortKey("price", ascending=False)]
    r = pw.rank(pt, ["item"], key).to_numpy()
    d = pw.dense_rank(pt, ["item"], key).to_numpy()
    pr = pw.percent_rank(pt, ["item"], key).to_numpy()
    for it in np.unique(item):
        rows = np.nonzero(item == it)[0]
        p = price[rows]
        want_r = np.array([1 + np.sum(p > x) for x in p])
        want_d = np.array([1 + len(np.unique(p[p > x])) for x in p])
        np.testing.assert_array_equal(r[rows], want_r)
        np.testing.assert_array_equal(d[rows], want_d)
        size = len(rows)
        want_pr = (want_r - 1) / (size - 1) if size > 1 else np.zeros(1)
        np.testing.assert_array_equal(pr[rows], want_pr)
