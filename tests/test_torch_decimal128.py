"""DECIMAL128 in the port (``ops/int128.py`` and the dispatch plane)
against the JAX package on the CPU, and against Python ints.

Mirrors ``tests/test_decimal128.py`` case by case (not its Arrow round
trip: the port's Arrow half comes with IO): the limb arithmetic, columns,
the packed-row round trip, sort, binary ops, casts, groupby and joins,
and the wire. Beyond it: every ``int128`` function on seeded limbs at
both edges of every carry and borrow; ``table_plan_wire`` plans with
DECIMAL128 sort, distinct, groupby, joins and casts at the bucket edges
1023/1024/1025 with nulls, the kernel tier on and off, compared by the
wire 5-tuple (data, validity, type ids and scales, row count; tolerance
0); DECIMAL128 <-> STRING; and each DECIMAL128 op that keeps raising,
with the JAX package's reason. Inputs are made with numpy from fixed
seeds and hold values near +-10^37 and +-2^64.
"""

import json

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu import rows as jrows
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import int128 as jint128
from spark_rapids_jni_tpu.ops import unaryop as junaryop
from spark_rapids_jni_tpu.ops.groupby import GroupbyAgg as JAgg
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import ops, rows
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.ops import int128
from spark_rapids_jni_tpu_torch.ops.groupby import GroupbyAgg
from spark_rapids_jni_tpu_torch.utils import config as pconfig

MOD = 1 << 128
EDGE_INTS = [0, 1, -1, 2**63 - 1, 2**63, -(2**63), 2**64 - 1, 2**64,
             -(2**64), 2**64 + 1, -(2**64) - 1, 10**37, -(10**37),
             10**37 + 1, 10**38 - 1, -(10**38) + 1, 2**127 - 1, -(2**127)]


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves the resident registries of both bridges as it found
    them: a table left behind would show in a later test's count."""
    before = (jrb.resident_table_count(), len(rb._RESIDENT))
    yield
    assert (jrb.resident_table_count(), len(rb._RESIDENT)) == before


def _wrap(v: int) -> int:
    return ((v + (MOD >> 1)) % MOD) - (MOD >> 1)


def _rand_ints(rng, n, bits=100):
    """Random signed ints spanning well past 64 bits."""
    lo = rng.integers(0, 2**63, n, dtype=np.uint64).astype(object)
    hi = rng.integers(0, 2 ** (bits - 63), n).astype(object)
    sign = rng.choice([-1, 1], n).astype(object)
    return [int(s * ((h << 63) | l)) for s, h, l in zip(sign, hi, lo)]


def _edge_limbs(rng, n):
    """(n, 2) uint64 limbs: random words, half of each limb replaced by a
    word at a carry or borrow edge."""
    edges = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1,
                      2**64 - 2], dtype=np.uint64)
    out = rng.integers(0, 2**64, (n, 2), dtype=np.uint64)
    pick = rng.random((n, 2)) < 0.5
    out[pick] = edges[rng.integers(0, edges.shape[0], int(pick.sum()))]
    return out


def _t(limbs: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(limbs).view(np.int64))


def _ints(lo, hi) -> list:
    """Signed Python ints of a (lo, hi) pair of JAX or port limbs."""
    if torch.is_tensor(lo):
        lo, hi = lo.numpy(), hi.numpy()
    return jint128.to_py_ints(np.stack([np.asarray(lo), np.asarray(hi)], 1)
                              .view(np.uint64))


# ---------------------------------------------------------------------------
# limbs
# ---------------------------------------------------------------------------


class TestLimbs:
    def test_py_round_trip(self, rng):
        vals = _rand_ints(rng, 50) + [0, 1, -1, 2**127 - 1, -(2**127)]
        limbs = int128.from_py_ints(vals)
        assert np.array_equal(limbs, jint128.from_py_ints(vals))
        assert int128.to_py_ints(limbs) == vals
        assert int128.to_py_ints(_t(limbs)) == vals

    def test_add_sub_oracle(self, rng):
        a = _rand_ints(rng, 64, bits=120) + EDGE_INTS
        b = _rand_ints(rng, 64, bits=120) + EDGE_INTS[::-1]
        la, lb = _t(int128.from_py_ints(a)), _t(int128.from_py_ints(b))
        got = _ints(*int128.add(la[:, 0], la[:, 1], lb[:, 0], lb[:, 1]))
        assert got == [_wrap(x + y) for x, y in zip(a, b)]
        got = _ints(*int128.sub(la[:, 0], la[:, 1], lb[:, 0], lb[:, 1]))
        assert got == [_wrap(x - y) for x, y in zip(a, b)]

    def test_rescale_divide_truncates(self):
        vals = [12345, -12345, 10**30 + 7, -(10**30 + 7)]
        limbs = _t(int128.from_py_ints(vals))
        got = _ints(*int128.rescale(limbs[:, 0], limbs[:, 1], -3, 0))
        assert got == [12, -12, (10**30 + 7) // 1000,
                       -((10**30 + 7) // 1000)]

    def test_rescale_multiply_exact(self):
        vals = [7, -7, 10**10]
        limbs = _t(int128.from_py_ints(vals))
        got = _ints(*int128.rescale(limbs[:, 0], limbs[:, 1], 0, -25))
        assert got == [v * 10**25 for v in vals]


def _jax_pair(limbs: np.ndarray):
    import jax.numpy as jnp

    return jnp.asarray(limbs[:, 0]), jnp.asarray(limbs[:, 1])


def _same(jax_out, port_out) -> None:
    """The JAX and port results, word for word."""
    if not isinstance(jax_out, tuple):
        jax_out, port_out = (jax_out,), (port_out,)
    assert len(jax_out) == len(port_out)
    for j, p in zip(jax_out, port_out):
        j = np.asarray(j)
        p = p.numpy()
        if j.dtype == np.uint64:
            p = p.view(np.uint64)
        elif j.dtype == np.float64:
            j, p = j.view(np.int64), p.view(np.int64)
        np.testing.assert_array_equal(p, j)


LIMB_FNS = {
    "add": lambda m, a, b: m.add(*a, *b),
    "sub": lambda m, a, b: m.sub(*a, *b),
    "negate": lambda m, a, b: m.negate(*a),
    "mul_u64_vector": lambda m, a, b: m._mul_u64(a[0], b[0]),
    "lt_signed": lambda m, a, b: m.lt_signed(*a, *b),
    "lt_signed_self": lambda m, a, b: m.lt_signed(*a, *a),
    "eq": lambda m, a, b: m.eq(*a, *b),
    "eq_self": lambda m, a, b: m.eq(*a, *a),
    "to_float64": lambda m, a, b: m.to_float64(*a),
    **{f"mul_u64_{k}": (lambda k: lambda m, a, b: m.mul_u64(
        *a, np.uint64(k) if m is jint128 else k))(k)
       for k in (10, 10**9, 10**18, 10**19, 2**64 - 1)},
    **{f"divmod_u32_{d}": (lambda d: lambda m, a, b: m.divmod_u32_rem(
        *a, d))(d) for d in (1, 7, 10, 10**9, 2**32 - 1)},
    **{f"rescale_{f}_{t}": (lambda f, t: lambda m, a, b: m.rescale(
        *a, f, t))(f, t)
       for f, t in ((0, 2), (2, 0), (0, 38), (38, 0), (3, 25), (25, 3),
                    (-2, 5), (5, -2), (-38, 0), (0, -19), (0, -20))},
}


@pytest.mark.parametrize("fn", sorted(LIMB_FNS))
def test_int128_matches_jax_at_carry_edges(fn):
    """Every vector function of ``int128`` on seeded limbs at both edges
    of every carry and borrow: the JAX module's words (float64: bits)."""
    rng = np.random.default_rng(11)
    a, b = _edge_limbs(rng, 4000), _edge_limbs(rng, 4000)
    want = LIMB_FNS[fn](jint128, _jax_pair(a), _jax_pair(b))
    got = LIMB_FNS[fn](int128, (_t(a)[:, 0], _t(a)[:, 1]),
                       (_t(b)[:, 0], _t(b)[:, 1]))
    _same(want, got)


def test_int128_against_python_ints():
    """The limb arithmetic against Python's exact ints on the edges."""
    vals = EDGE_INTS
    pairs = [(x, y) for x in vals for y in vals]
    a = _t(int128.from_py_ints([x for x, _ in pairs]))
    b = _t(int128.from_py_ints([y for _, y in pairs]))
    al, ah, bl, bh = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    assert _ints(*int128.add(al, ah, bl, bh)) == [_wrap(x + y)
                                                  for x, y in pairs]
    assert _ints(*int128.sub(al, ah, bl, bh)) == [_wrap(x - y)
                                                  for x, y in pairs]
    assert _ints(*int128.negate(al, ah)) == [_wrap(-x) for x, _ in pairs]
    assert int128.lt_signed(al, ah, bl, bh).tolist() == [x < y
                                                         for x, y in pairs]
    assert int128.eq(al, ah, bl, bh).tolist() == [x == y for x, y in pairs]
    assert _ints(*int128.mul_u64(al, ah, 10**19)) == [
        _wrap(x * 10**19) for x, _ in pairs]
    u = [x % MOD for x, _ in pairs]
    ql, qh, r = int128.divmod_u32_rem(al, ah, 10**9)
    assert [q % MOD for q in _ints(ql, qh)] == [v // 10**9 for v in u]
    assert r.tolist() == [v % 10**9 for v in u]
    assert int128.to_float64(al, ah).tolist() == [
        float(np.float64(np.uint64(abs(x) >> 64 if x != -(2**127)
                                   else 2**63)) * 2.0**64
              + np.float64(np.uint64(abs(x) & (2**64 - 1))))
        * (-1 if x < 0 else 1) for x, _ in pairs]
    for k in range(39):
        assert int128.pow10_limbs(k) == jint128.pow10_limbs(k)


# ---------------------------------------------------------------------------
# columns and rows
# ---------------------------------------------------------------------------


class TestColumn:
    def test_from_to_pylist(self, rng):
        vals = _rand_ints(rng, 40) + [None, 0, None]
        col = Column.from_decimal128(vals, scale=-10, device="cpu")
        assert col.dtype == dt.DType(dt.TypeId.DECIMAL128, -10)
        assert col.to_pylist() == vals
        jcol = JColumn.from_decimal128(vals, scale=-10)
        assert np.array_equal(col.data.numpy().view(np.uint64),
                              np.asarray(jcol.data))
        assert np.array_equal(col.validity.numpy(), np.asarray(jcol.validity))

    def test_rows_round_trip_mixed_schema(self, rng):
        """The packed rows of a DECIMAL128 column beside narrower types
        equal the JAX package's bytes and convert back."""
        n = 96
        d128 = _rand_ints(rng, n)
        a = rng.integers(-100, 100, n, dtype=np.int64)
        b = rng.integers(0, 2, n).astype(np.bool_)
        t = Table([Column.from_numpy(a, device="cpu"),
                   Column.from_decimal128(d128, scale=-38, device="cpu"),
                   Column.from_numpy(b, device="cpu")], ["a", "d", "b"])
        jt = JTable([JColumn.from_numpy(a),
                     JColumn.from_decimal128(d128, scale=-38),
                     JColumn.from_numpy(b)], ["a", "d", "b"])
        packed = rows.to_rows(t)
        jpacked = jrows.to_rows(jt, split=False)
        assert np.array_equal(packed[0].data.numpy(),
                              np.asarray(jpacked[0].data))
        back = rows.from_rows(packed, t.dtypes())
        assert back.columns[1].to_pylist() == d128
        assert torch.equal(back.columns[0].data, t.columns[0].data)


# ---------------------------------------------------------------------------
# ops: the cases of tests/test_decimal128.py, held to the JAX ops too
# ---------------------------------------------------------------------------


def _both(vals, scale):
    return (Column.from_decimal128(vals, scale=scale, device="cpu"),
            JColumn.from_decimal128(vals, scale=scale))


class TestOps:
    def test_sort_oracle(self, rng):
        vals = _rand_ints(rng, 200) + EDGE_INTS
        col, jcol = _both(vals, -5)
        out = ops.sort_table(Table([col], ["d"]), ["d"])
        assert out["d"].to_pylist() == sorted(vals)
        jout = jops.sort_table(JTable([jcol], ["d"]), ["d"])
        assert out["d"].to_pylist() == jout["d"].to_pylist()

    def test_binaryop_add_sub_cmp(self, rng):
        a = _rand_ints(rng, 100, bits=110) + EDGE_INTS
        b = _rand_ints(rng, 100, bits=110) + EDGE_INTS[::-1]
        (ca, ja), (cb, jb) = _both(a, -2), _both(b, -2)
        want = {"add": [_wrap(x + y) for x, y in zip(a, b)],
                "sub": [_wrap(x - y) for x, y in zip(a, b)],
                "lt": [x < y for x, y in zip(a, b)]}
        for op, w in want.items():
            got = ops.binary_op(op, ca, cb).to_pylist()
            assert got == w
            assert got == jops.binary_op(op, ja, jb).to_pylist()
        assert all(ops.binary_op("eq", ca, ca).to_pylist())

    def test_binaryop_mixed_scale_rescales(self):
        ca = Column.from_decimal128([5], scale=-1, device="cpu")   # 0.5
        cb = Column.from_decimal128([25], scale=-2, device="cpu")  # 0.25
        out = ops.binary_op("add", ca, cb)
        assert out.dtype.scale == -2
        assert out.to_pylist() == [75]  # 0.75 at scale -2

    def test_cast_widen_and_narrow(self):
        c64 = Column.from_numpy(np.asarray([123, -456], dtype=np.int64),
                                dtype=dt.DType(dt.TypeId.DECIMAL64, -3),
                                device="cpu")
        wide = ops.cast(c64, dt.DType(dt.TypeId.DECIMAL128, -3))
        assert wide.to_pylist() == [123, -456]
        back = ops.cast(wide, dt.DType(dt.TypeId.DECIMAL64, -3))
        assert back.to_pylist() == [123, -456]
        f = ops.cast(wide, dt.FLOAT64)
        assert f.to_pylist() == pytest.approx([0.123, -0.456])

    @pytest.mark.parametrize("scale", [-38, -20, -5, 0])
    def test_groupby_sum_min_max_count(self, rng, scale):
        n = 400
        keys = rng.integers(0, 12, n, dtype=np.int64)
        vals = _rand_ints(rng, n, bits=90)
        t = Table([Column.from_numpy(keys, device="cpu"),
                   Column.from_decimal128(vals, scale=scale, device="cpu")],
                  ["k", "d"])
        out = ops.groupby_aggregate(
            t, ["k"], [GroupbyAgg("d", a)
                       for a in ("sum", "min", "max", "count")])
        got = {k: (s, mn, mx, c) for k, s, mn, mx, c in zip(
            out["k"].to_pylist(), out["sum_d"].to_pylist(),
            out["min_d"].to_pylist(), out["max_d"].to_pylist(),
            out["count_d"].to_pylist())}
        varr = np.array(vals, dtype=object)
        for u in np.unique(keys):
            vs = [int(x) for x in varr[keys == u]]
            assert got[int(u)] == (sum(vs), min(vs), max(vs), len(vs))

    def test_join_on_decimal128_keys(self):
        kvals = [10**25 + i for i in range(8)]
        lk = [kvals[i % 8] for i in range(24)]
        rk = [kvals[i % 4] for i in range(12)]
        left = Table([Column.from_decimal128(lk, scale=-9, device="cpu"),
                      Column.from_numpy(np.arange(24, dtype=np.int64),
                                        device="cpu")], ["k", "lv"])
        right = Table([Column.from_decimal128(rk, scale=-9, device="cpu"),
                       Column.from_numpy(np.arange(12, dtype=np.int64),
                                         device="cpu")], ["k", "rv"])
        out = ops.inner_join(left, right, ["k"])
        want = sorted((k1, i, j) for i, k1 in enumerate(lk)
                      for j, k2 in enumerate(rk) if k1 == k2)
        got = sorted(zip(out["k"].to_pylist(), out["lv"].to_pylist(),
                         out["rv"].to_pylist()))
        assert got == want


BINARY_OPS = ["add", "sub", "eq", "ne", "lt", "le", "gt", "ge",
              "null_safe_eq"]
# (scale of a, b's type): DECIMAL128 at another scale, DECIMAL64, INT64,
# INT32 (an integer operand is scale 0)
OTHER_SIDES = {"d128_s-5": ("d128", -5), "d128_s-2": ("d128", -2),
               "d64_s-3": ("d64", -3), "i64": ("i64", 0), "i32": ("i32", 0)}


def _operand(kind: str, scale: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.15
    if kind == "d128":
        pool = EDGE_INTS + _rand_ints(rng, 20, bits=110)
        vals = [pool[i] if ok else None
                for i, ok in zip(rng.integers(0, len(pool), n), valid)]
        return _both(vals, scale)
    np_t = {"d64": np.int64, "i64": np.int64, "i32": np.int32}[kind]
    info = np.iinfo(np_t)
    v = rng.integers(info.min, info.max, n, dtype=np_t, endpoint=True)
    v[: n // 2] = rng.integers(-1000, 1000, n // 2)
    d = {"d64": dt.DType(dt.TypeId.DECIMAL64, scale), "i64": dt.INT64,
         "i32": dt.INT32}[kind]
    jd = {"d64": jdt.decimal64(scale), "i64": jdt.INT64,
          "i32": jdt.INT32}[kind]
    return (Column.from_numpy(v, valid, d, device="cpu"),
            JColumn.from_numpy(v, validity=valid, dtype=jd))


def _column_bytes(col) -> tuple:
    data = (col.data.numpy() if torch.is_tensor(col.data)
            else np.asarray(col.data))
    if data.dtype == np.uint64:
        data = data.view(np.int64)
    valid = None if col.validity is None else (
        col.validity.numpy() if torch.is_tensor(col.validity)
        else np.asarray(col.validity))
    return (data.astype(np.int64).tobytes() if data.dtype == np.bool_
            else data.tobytes(), None if valid is None else valid.tobytes(),
            int(col.dtype.id), int(col.dtype.scale))


@pytest.mark.parametrize("other", sorted(OTHER_SIDES))
@pytest.mark.parametrize("op", BINARY_OPS)
def test_binary_op_matches_jax(op, other):
    """add, sub and every comparison of a DECIMAL128 column (scale -2,
    nulls, the edge values) with each other operand type, both ways
    round: the JAX package's bytes."""
    n = 300
    pa, ja = _operand("d128", -2, n, 1)
    pb, jb = _operand(*OTHER_SIDES[other], n, 2)
    for (x, jx), (y, jy) in (((pa, ja), (pb, jb)), ((pb, jb), (pa, ja))):
        assert (_column_bytes(ops.binary_op(op, x, y))
                == _column_bytes(jops.binary_op(op, jx, jy)))


CAST_TARGETS = {
    "d128_s-4": jdt.decimal128(-4), "d128_s0": jdt.decimal128(0),
    "d128_s3": jdt.decimal128(3), "d64_s-2": jdt.decimal64(-2),
    "d32_s-1": jdt.decimal32(-1), "i64": jdt.INT64, "i32": jdt.INT32,
    "i8": jdt.INT8, "u64": jdt.UINT64, "f64": jdt.FLOAT64,
    "f32": jdt.FLOAT32, "b": jdt.BOOL8,
}


@pytest.mark.parametrize("to", sorted(CAST_TARGETS))
def test_cast_from_decimal128_matches_jax(to):
    pa, ja = _operand("d128", -2, 300, 3)
    jto = CAST_TARGETS[to]
    pto = dt.DType(dt.TypeId(int(jto.id)), jto.scale)
    assert (_column_bytes(ops.cast(pa, pto))
            == _column_bytes(jops.cast(ja, jto)))


@pytest.mark.parametrize("src", ["d64_s-3", "i64", "i32"])
@pytest.mark.parametrize("scale", [-20, -3, 0, 2])
def test_cast_to_decimal128_matches_jax(src, scale):
    pa, ja = _operand(*OTHER_SIDES[src], 300, 4)
    assert (_column_bytes(ops.cast(pa, dt.DType(dt.TypeId.DECIMAL128, scale)))
            == _column_bytes(jops.cast(ja, jdt.decimal128(scale))))


@pytest.mark.parametrize("op", ["sum", "mean", "min", "max", "count",
                                "variance", "std", "first", "last"])
def test_capped_groupby_matches_jax(op):
    """The capped groupby (static output size) over DECIMAL128 values,
    against the JAX one jitted, as its wire entries run it (XLA then
    contracts the variance's scaling into its deviation)."""
    import jax

    from spark_rapids_jni_tpu.ops.groupby import groupby_aggregate_capped

    rng = np.random.default_rng(7)
    n = 257
    keys = rng.integers(0, 9, n).astype(np.int64)
    pv, jv = _operand("d128", -3, n, 8)
    pt = Table([Column.from_numpy(keys, device="cpu"), pv], ["k", "d"])
    jt = JTable([JColumn.from_numpy(keys), jv], ["k", "d"])
    got, g = ops.groupby_aggregate_capped(pt, ["k"], [GroupbyAgg("d", op)],
                                          16)
    want, jg = jax.jit(lambda t: groupby_aggregate_capped(
        t, ["k"], [JAgg("d", op)], num_segments=16))(jt)
    assert int(g) == int(jg)
    for c, jc in zip(got.columns, want.columns):
        assert _column_bytes(c) == _column_bytes(jc)


# ---------------------------------------------------------------------------
# the wire: table_plan_wire, byte for byte
# ---------------------------------------------------------------------------


def _limb_bytes(vals) -> bytes:
    return int128.from_py_ints(vals).tobytes()


def make_wire(n: int, seed: int):
    """(k INT64 ~10 % null, d DECIMAL128(-2) ~15 % null from a pool of the
    edge values (repeats: keys), e DECIMAL128(-5), i INT64, s
    DECIMAL64(-3) ~10 % null)."""
    rng = np.random.default_rng(seed)
    pool = EDGE_INTS + _rand_ints(rng, 30, bits=110)
    d = [pool[i] for i in rng.integers(0, len(pool), n)]
    e = _rand_ints(rng, n, bits=115)
    k = rng.integers(0, 30, n).astype(np.int64)
    i = rng.integers(-10**6, 10**6, n).astype(np.int64)
    s = rng.integers(-10**12, 10**12, n).astype(np.int64)
    kv = (rng.random(n) > 0.1).astype(np.uint8).tobytes()
    dv = (rng.random(n) > 0.15).astype(np.uint8).tobytes()
    sv = (rng.random(n) > 0.1).astype(np.uint8).tobytes()
    return ([4, 27, 27, 4, 26], [0, -2, -5, 0, -3],
            [k.tobytes(), _limb_bytes(d), _limb_bytes(e), i.tobytes(),
             s.tobytes()], [kv, dv, None, None, sv], n)


GROUPBY_AGGS = [{"column": 1, "agg": a}
                for a in ("sum", "mean", "min", "max", "count", "variance",
                          "std", "first", "last")]
PLANS = {
    "sort_asc": [{"op": "sort_by", "keys": [{"column": 1}, {"column": 0}]}],
    "sort_desc": [{"op": "sort_by", "keys": [{"column": 1,
                                               "ascending": False}]}],
    "distinct_key": [{"op": "distinct", "keys": [1]}],
    "distinct_pair": [{"op": "distinct", "keys": [1, 0]}],
    "groupby_values": [{"op": "groupby", "by": [0], "aggs": GROUPBY_AGGS}],
    "groupby_e": [{"op": "groupby", "by": [0], "aggs": [
        {"column": 2, "agg": a} for a in ("sum", "mean", "variance")]}],
    "groupby_key": [{"op": "groupby", "by": [1], "aggs": [
        {"column": 3, "agg": "sum"}, {"column": 2, "agg": "max"}]}],
    **{f"join_{h}": [{"op": "join", "how": h, "on": [1]}]
       for h in ("inner", "left", "right", "full", "semi", "anti")},
    **{f"cast_{name}": [{"op": "cast", "column": c, "type_id": t,
                         "scale": s}]
       for name, c, t, s in (("widen", 1, 27, -6), ("narrow", 1, 27, 0),
                             ("to_int64", 1, 4, 0), ("to_float64", 1, 10, 0),
                             ("to_decimal64", 2, 26, -2),
                             ("to_decimal32", 1, 25, 1),
                             ("to_string", 1, 23, 0),
                             ("int64_to", 3, 27, -3),
                             ("decimal64_to", 4, 27, -7))},
    "cast_sort_groupby": [
        {"op": "cast", "column": 4, "type_id": 27, "scale": -3},
        {"op": "groupby", "by": [0], "aggs": [
            {"column": 4, "agg": "sum"}, {"column": 4, "agg": "mean"}]},
        {"op": "sort_by", "keys": [{"column": 1, "ascending": False},
                                   {"column": 0}]}],
}
TIER = {"sort_asc", "groupby_values", "groupby_key", "join_inner",
        "join_semi", "join_anti"}
CASES = [(name, n, tier) for name in sorted(PLANS) for n in (1023, 1024, 1025)
         for tier in (("off", "on") if name in TIER else ("off",))]


@pytest.mark.parametrize("name,n,tier", CASES)
def test_decimal128_plans_match_jax(name, n, tier):
    plan = json.dumps(PLANS[name])
    wires = [make_wire(n, n)]
    if name.startswith("join_"):
        wires.append(make_wire(97, n + 1))
    try:
        for c in (jconfig, pconfig):
            c.set_flag("KERNELS", tier)
        if len(wires) == 1:
            want = jrb.table_plan_wire(plan, *wires[0])
            got = rb.table_plan_wire(plan, *wires[0], device="cpu")
        else:
            want, got = (_resident(mod, plan, wires, **kw) for mod, kw in
                         ((jrb, {}), (rb, {"device": "cpu"})))
    finally:
        for c in (jconfig, pconfig):
            c.clear_flag("KERNELS")
    assert tuple(got) == tuple(want)


def _resident(mod, plan, wires, **kw):
    ids = [mod.table_upload_wire(*w, **kw) for w in wires]
    try:
        out = mod.table_plan_resident(plan, ids)
        ids.append(out)
        return tuple(mod.table_download_wire(out))
    finally:
        for t in ids:
            mod.table_free(t)


def test_op_wire_sort_round_trips():
    """The JAX test's wire case: ``table_op_wire`` sorts by a DECIMAL128
    column and gives back its limbs in order."""
    rng = np.random.default_rng(42)
    n = 60
    vals = _rand_ints(rng, n)
    keys = rng.integers(0, 5, n, dtype=np.int64)
    op = json.dumps({"op": "sort_by", "keys": [{"column": 0}]})
    args = ([27, 4], [-7, 0], [_limb_bytes(vals), keys.tobytes()],
            [None, None], n)
    out = rb.table_op_wire(op, *args, device="cpu")
    assert tuple(out) == tuple(jrb.table_op_wire(op, *args))
    assert out[0][0] == 27 and out[1][0] == -7 and out[4] == n
    got = int128.to_py_ints(np.frombuffer(out[2][0], np.uint64).reshape(n, 2))
    assert got == sorted(vals)


# ---------------------------------------------------------------------------
# DECIMAL128 <-> STRING
# ---------------------------------------------------------------------------

STRINGS = [
    "0", "-0", "1", "-1", "12.5", "-12.5", "  42  ", "+7", "3.14159",
    ".5", "-.5", "5.", "1e5", "abc", "", "1.2.3", "--1", "0.000001",
    "99999999999999999999999999999999999999",
    "-99999999999999999999999999999999999999",
    "999999999999999999999999999999999999999",
    "170141183460469231731687303715884105727",
    "18446744073709551616", "-18446744073709551616",
    "18446744073709551615.99", "0000000000000000000000000000000000000001",
    "12345678901234567890.123456789", "-0.00", "1" * 20 + "." + "9" * 20,
]


@pytest.mark.parametrize("scale", [-20, -4, -2, 0, 3])
def test_string_to_decimal128_matches_jax(scale):
    vals = STRINGS + [None]
    pcol = Column.from_strings(vals, device="cpu")
    jcol = JColumn.from_strings(vals)
    got = ops.cast(pcol, dt.DType(dt.TypeId.DECIMAL128, scale))
    want = jops.cast(jcol, jdt.decimal128(scale))
    assert _column_bytes(got) == _column_bytes(want)
    assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("scale", [-38, -20, -2, 0, 2])
def test_decimal128_to_string_matches_jax(scale):
    rng = np.random.default_rng(5)
    vals = EDGE_INTS + _rand_ints(rng, 60, bits=126) + [None, 5, -5, 50]
    pcol, jcol = _both(vals, scale)
    got = ops.cast(pcol, dt.STRING)
    want = jops.cast(jcol, jdt.STRING)
    assert got.to_pylist() == want.to_pylist()
    for v, s in zip(vals, got.to_pylist()):
        if v is None:
            assert s is None
            continue
        mag = str(abs(v))
        if scale > 0:
            text = mag + "0" * scale
        elif scale < 0:
            mag = mag.rjust(-scale + 1, "0")
            text = mag[:scale] + "." + mag[scale:]
        else:
            text = mag
        assert s == ("-" if v < 0 else "") + text


def test_string_round_trip_through_the_wire():
    """STRING -> DECIMAL128 -> STRING in one wire plan."""
    vals = [s.encode() for s in STRINGS] * 40
    lens = [len(v) for v in vals]
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    wire = ([23], [0], [offs.tobytes() + b"".join(vals)], [None], len(vals))
    plan = json.dumps([{"op": "cast", "column": 0, "type_id": 27,
                        "scale": -4},
                       {"op": "cast", "column": 0, "type_id": 23}])
    got = rb.table_plan_wire(plan, *wire, device="cpu")
    assert tuple(got) == tuple(jrb.table_plan_wire(plan, *wire))


# ---------------------------------------------------------------------------
# what keeps raising, and the JAX package's reason
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["mul", "div", "mod", "bitand", "and"])
def test_mul_div_raise_as_in_jax(op):
    """The JAX package has no 128-bit product or quotient: it raises
    TypeError rather than truncate, and so does the port."""
    pa, ja = _operand("d128", -2, 8, 1)
    pb, jb = _operand("d128", -2, 8, 2)
    with pytest.raises(TypeError, match="decimal128 op"):
        jops.binary_op(op, ja, jb)
    with pytest.raises(TypeError, match="decimal128 op"):
        ops.binary_op(op, pa, pb)


@pytest.mark.parametrize("op", sorted(set(junaryop._FNS) - {"not"}))
def test_unary_ops_raise_where_jax_works_limb_by_limb(op):
    """The JAX ``unary_op`` runs each function on the two 64-bit limbs
    apart (abs of -5 stays -5; neg of -5 gives 2^64 + 5; the float
    functions return a (3, 2) float matrix): not Spark's value, so the
    port raises."""
    vals = [-5, 2**64 + 7, None]
    jcol = JColumn.from_decimal128(vals, scale=-2)
    out = junaryop.unary_op(op, jcol)
    spark = {"abs": [5, 2**64 + 7, None], "neg": [5, -(2**64) - 7, None]}
    if out.dtype.id == jdt.TypeId.DECIMAL128:
        assert out.to_pylist() != spark.get(op, [-5, 2**64 + 7, None]) or (
            op in ("floor", "ceil", "rint"))
    else:
        assert np.asarray(out.data).shape == (3, 2)  # one value a limb
    pcol = Column.from_decimal128(vals, scale=-2, device="cpu")
    with pytest.raises(NotImplementedError, match="limb by limb"):
        ops.unary_op(op, pcol)


def test_unary_not_and_null_tests():
    pcol, jcol = _both([-5, None, 7], -2)
    for mod, col in ((junaryop, jcol), (ops, pcol)):
        with pytest.raises(TypeError, match="BOOL8"):
            mod.unary_op("not", col)
        with pytest.raises(TypeError, match="float"):
            mod.is_nan(col)
    assert (ops.is_null(pcol).to_pylist()
            == junaryop.is_null(jcol).to_pylist())
    assert (ops.is_not_null(pcol).to_pylist()
            == junaryop.is_not_null(jcol).to_pylist())


@pytest.mark.parametrize("op", ["nunique", "collect_list", "collect_set"])
def test_groupby_refusals_match_jax(op):
    keys = np.array([1, 1, 2], np.int64)
    pv, jv = _both([1, 2, 3], -2)
    pt = Table([Column.from_numpy(keys, device="cpu"), pv], ["k", "d"])
    jt = JTable([JColumn.from_numpy(keys), jv], ["k", "d"])
    with pytest.raises(TypeError, match="not supported"):
        jops.groupby_aggregate(jt, ["k"], [JAgg("d", op, list_capacity=4)])
    with pytest.raises(TypeError, match="not supported"):
        ops.groupby_aggregate(pt, ["k"], [GroupbyAgg("d", op,
                                                     list_capacity=4)])


def test_float_to_decimal128_raises_as_in_jax():
    pf = Column.from_numpy(np.array([1.5]), device="cpu")
    jf = JColumn.from_numpy(np.array([1.5]))
    with pytest.raises(TypeError, match="cannot cast"):
        jops.cast(jf, jdt.decimal128(-2))
    with pytest.raises(TypeError, match="cannot cast"):
        ops.cast(pf, dt.DType(dt.TypeId.DECIMAL128, -2))


def test_murmur3_of_decimal128_raises():
    """The JAX ``_column_hash`` has no DECIMAL128 arm (it hashes the limb
    matrix elementwise, not Spark's hash of a decimal of precision > 18),
    so the port's hash partition refuses the key."""
    wire = make_wire(64, 3)
    plan = json.dumps([{"op": "partition", "kind": "hash", "keys": [1],
                        "num": 4}])
    with pytest.raises(NotImplementedError, match="DECIMAL128"):
        rb.table_plan_wire(plan, *wire, device="cpu")
