"""The port's search ops (``ops/search.py`` with ``join._lex_searchsorted``)
and STRUCT columns (``struct.py``) against the JAX package's, on the CPU.

Both packages get the same numpy inputs from a seed (the port's through
``interop``); the JAX functions run eagerly, as its own tests call them,
but for the multi-word binary search under ``lower_bound``,
``upper_bound`` and ``contains_column``, which runs jitted (integer
compares and selects: the eager bytes at one XLA compile a shape).
Tolerance 0: data bytes, validity, dtype, names. Sizes 0, 1, 2, 1023,
1024, 1025; keys with nulls, NaN, +-0.0, +-inf, integer extremes,
strings, and ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu import struct as jst
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu.ops import keys as jkeys
from spark_rapids_jni_tpu.ops import search as jsearch
from spark_rapids_jni_tpu_torch import interop, ops
from spark_rapids_jni_tpu_torch import struct as pst
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from spark_rapids_jni_tpu_torch.ops import keys as pkeys

SIZES = (0, 1, 2, 1023, 1024, 1025)
SIGN = np.uint64(2**63)


@pytest.fixture(scope="module", autouse=True)
def _jit_search():
    """``ops/search.py``'s binary search jitted (see the header)."""
    import jax

    eager = jsearch._lex_searchsorted
    jsearch._lex_searchsorted = jax.jit(eager, static_argnums=2)
    yield
    jsearch._lex_searchsorted = eager


def _bufs(c: JColumn):
    return (np.asarray(c.data),
            None if c.validity is None else np.asarray(c.validity),
            None if c.lengths is None else np.asarray(c.lengths),
            int(c.dtype.id), int(c.dtype.scale))


def _port_col(jc: JColumn):
    return interop.column_from_buffers(*_bufs(jc), device="cpu")


def _port(jt: JTable):
    return interop.table_from_buffers([_bufs(c) for c in jt.columns],
                                      jt.names, device="cpu")


def _same(jc: JColumn, pc, what="") -> None:
    w, g = _bufs(jc), interop.column_to_buffers(pc)
    assert w[3:] == g[3:], f"{what} type"
    for part, a, b in zip(("data", "validity", "lengths"), w[:3], g[:3]):
        assert (a is None) == (b is None), f"{what} {part} presence"
        if a is not None:
            assert a.dtype == b.dtype, f"{what} {part} dtype"
            np.testing.assert_array_equal(a, b, f"{what} {part}")


def _keys(rng, n: int) -> JTable:
    """k1 INT32 with ties, k2 FLOAT64 with NaN/+-0.0/+-inf, k3 UINT64
    extremes, s STRING, all non-null (bounds run on sorted haystacks)."""
    f = rng.integers(-5, 5, n).astype(np.float64) / 2
    for frac, v in ((0.05, np.nan), (0.05, -0.0), (0.05, np.inf),
                    (0.05, -np.inf)):
        f[rng.random(n) < frac] = v
    u = rng.integers(0, 4, n).astype(np.uint64)
    u[rng.random(n) < 0.2] = np.uint64(2**64 - 1)
    words = ["", "a", "ab", "b", "zz\x00", "zz"]
    return JTable([
        JColumn.from_numpy(rng.integers(-3, 3, n).astype(np.int32)),
        JColumn.from_numpy(f),
        JColumn.from_numpy(u),
        JColumn.from_strings([words[i] for i in rng.integers(0, 6, n)]),
    ], ["k1", "k2", "k3", "s"])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("m", [0, 7, 1025])
def test_lex_searchsorted(n, m):
    """The multi-word binary search on carrier words against the JAX
    package's on u64 words (carrier = u64 ^ 2^63)."""
    rng = np.random.default_rng(n * 7 + m)
    words = [np.sort(rng.integers(0, 2**64, m, dtype=np.uint64) % 9)]
    words.append(rng.integers(0, 3, m, dtype=np.uint64) | (SIGN * (
        rng.random(m) < 0.5)))
    order = np.lexsort(words[::-1])
    hay = [w[order] for w in words]
    q = [rng.integers(0, 10, n, dtype=np.uint64),
         rng.integers(0, 3, n, dtype=np.uint64) | (SIGN * (rng.random(n) < 0.5))]
    for side in ("left", "right"):
        got = pjoin._lex_searchsorted(
            [torch.from_numpy((w ^ SIGN).view(np.int64)) for w in hay],
            [torch.from_numpy((w ^ SIGN).view(np.int64)) for w in q], side)
        assert got.dtype == torch.int32
        if m == 0 and n > 0:
            # the JAX package's gather raises on an empty haystack; every
            # insertion point is 0
            np.testing.assert_array_equal(got.numpy(), np.zeros(n))
            continue
        want = np.asarray(jjoin._lex_searchsorted(
            [jnp.asarray(w) for w in hay], [jnp.asarray(w) for w in q], side))
        np.testing.assert_array_equal(want, got.numpy(), side)


@pytest.mark.parametrize("n", SIZES)
def test_bounds(n):
    rng = np.random.default_rng(n)
    hay = _keys(rng, max(n, 1) if n else 0)
    needles = _keys(rng, n)
    key_sets = (["k1"], ["k1", "k2"], ["k3", "s"], None)
    if n in (1023, 1024):
        key_sets = (["k1", "k2"],)  # a JAX compile a shape and key set
    for keys in key_sets:
        cols = keys if keys is not None else ["k1", "k2", "k3", "s"]
        jsorted = jops.sort_table(hay, cols)
        psorted = _port(jsorted)
        pneed = _port(needles)
        for fn in ("lower_bound", "upper_bound"):
            _same(getattr(jops, fn)(jsorted, needles, keys),
                  getattr(ops, fn)(psorted, pneed, keys), f"{fn} {keys}")


@pytest.mark.parametrize("n", SIZES)
def test_contains(n):
    rng = np.random.default_rng(50 + n)
    for make in (lambda k: JColumn.from_numpy(
                     rng.integers(-20, 20, k), validity=rng.random(k) > 0.2),
                 lambda k: JColumn.from_numpy(
                     np.where(rng.random(k) < 0.1, np.nan,
                              rng.integers(-4, 4, k) / 2),
                     validity=rng.random(k) > 0.2),
                 lambda k: JColumn.from_numpy(
                     np.full(k, 2**64 - 1, np.uint64),
                     validity=rng.random(k) > 0.5)):
        hay, needles = make(max(n // 2, 1)), make(n)
        _same(jops.contains_column(hay, needles),
              ops.contains_column(_port_col(hay), _port_col(needles)))
    with pytest.raises(TypeError, match="dtype mismatch"):
        ops.contains_column(_port_col(JColumn.from_numpy(np.arange(2))),
                            _port_col(JColumn.from_numpy(np.ones(2))))


def test_order_keys_are_carriers():
    """Every port order word is the JAX u64 word with the top bit
    flipped (the search compares them signed)."""
    jt = _keys(np.random.default_rng(3), 1025)
    pt = _port(jt)
    for jc, pc in zip(jt.columns, pt.columns):
        for jw, pw in zip(jkeys.column_order_keys(jc),
                          pkeys.column_order_keys(pc)):
            np.testing.assert_array_equal(
                np.asarray(jw) ^ SIGN, pw.numpy().view(np.uint64))


def _struct(n: int, seed: int):
    rng = np.random.default_rng(seed)
    children = [
        JColumn.from_numpy(rng.integers(-3, 3, n), validity=rng.random(n) > .2),
        JColumn.from_numpy(np.where(rng.random(n) < 0.1, -0.0,
                                    rng.integers(-2, 2, n) / 2.0)),
        JColumn.from_strings([["a", "bb", None, ""][i]
                              for i in rng.integers(0, 4, n)]),
        JColumn.from_numpy(rng.integers(-99, 99, n), validity=rng.random(n) > .1,
                           dtype=jdt.decimal64(-2)),
    ]
    valid = rng.random(n) > 0.15
    js = jst.StructColumn.from_children(children, ["i", "f", "s", "d"], valid)
    bufs = [_bufs(c) for c in children]
    ps = interop.struct_from_buffers(bufs, ["i", "f", "s", "d"], valid,
                                     device="cpu")
    return js, ps


def _same_struct(js, ps, what=""):
    assert tuple(js.names) == tuple(ps.names)
    for jc, pc in zip(js.children, ps.children):
        _same(jc, pc, what)
    _, _, pv = interop.struct_to_buffers(ps)
    if js.validity is None:
        assert pv is None, what
    else:
        np.testing.assert_array_equal(np.asarray(js.validity), pv, what)


@pytest.mark.parametrize("n", SIZES)
def test_struct_ops(n):
    js, ps = _struct(n, n)
    _same_struct(js, ps)
    assert ps.dtype.id == jdt.TypeId.STRUCT and ps.row_count == n
    assert ps.null_count() == js.null_count()
    assert ps.to_pylist() == js.to_pylist()
    for k in ("i", 1, "s", "d"):
        _same(js.field(k), ps.field(k), f"field {k}")
    for asc in (True, False):
        want = np.array(js.argsort(asc))
        got = ps.argsort(asc).numpy()
        np.testing.assert_array_equal(want, got, f"argsort {asc}")
        _same_struct(js.gather(jnp.asarray(want.astype(np.int32))),
                     ps.gather(torch.from_numpy(want)), "gather")
    rng = np.random.default_rng(n + 1)
    mask = JColumn.from_numpy(rng.random(n) > 0.5, validity=rng.random(n) > .1)
    _same_struct(js.filter(mask), ps.filter(_port_col(mask)), "filter")
    idx = rng.integers(0, max(n, 1), n).astype(np.int32)
    iv = rng.random(n) > 0.3
    _same_struct(js.gather(jnp.asarray(idx), jnp.asarray(iv)),
                 ps.gather(torch.from_numpy(idx), torch.from_numpy(iv)),
                 "gather with index validity")
    jt = jst.unpack(js)
    pt = pst.unpack(ps)
    assert tuple(jt.names) == tuple(pt.names)
    for jc, pc in zip(jt.columns, pt.columns):
        _same(jc, pc, "unpack")


@pytest.mark.parametrize("n", SIZES)
def test_pack(n):
    rng = np.random.default_rng(70 + n)
    jt = JTable([JColumn.from_numpy(rng.integers(0, 5, n)),
                 JColumn.from_numpy(rng.integers(0, 3, n).astype(np.int32),
                                    dtype=jdt.DType(jdt.TypeId.TIMESTAMP_DAYS)),
                 JColumn.from_numpy(rng.random(n))], ["item", "date", "price"])
    pt = _port(jt)
    for cols in (["item", "date", "price"], [2, 0]):
        js, ps = jst.pack(jt, cols), pst.pack(pt, cols)
        _same_struct(js, ps)
        np.testing.assert_array_equal(np.asarray(js.argsort()),
                                      ps.argsort().numpy())
    unnamed = JTable(list(jt.columns))
    _same_struct(jst.pack(unnamed, [1, 0]),
                 pst.pack(_port(unnamed), [1, 0]))


def test_struct_from_pylist():
    rows = [{"a": 1, "s": "x"}, None, {"a": 3, "s": None},
            {"a": None, "s": "w"}, {"a": 5, "s": "v"}]
    ps = pst.StructColumn.from_pylist(rows, device="cpu")
    assert ps.to_pylist() == jst.StructColumn.from_pylist(rows).to_pylist()
    typed = pst.StructColumn.from_pylist(
        rows, {"a": pst.dt.INT32}, device="cpu")
    assert typed.children[0].dtype == pst.dt.INT32
    assert typed.to_pylist() == rows
    with pytest.raises(ValueError, match="all-null struct"):
        pst.StructColumn.from_pylist([None], device="cpu")
    with pytest.raises(ValueError, match="share row count"):
        pst.StructColumn.from_children([ps.children[0],
                                        ps.children[1].__class__(
                                            ps.children[0].data[:2],
                                            ps.children[0].dtype)])
