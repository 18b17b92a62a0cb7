"""The port's ``ops/copying.py`` against the JAX package's, on the CPU:
concatenate, interleave_columns, copy_if_else, sequence, cross_join,
scatter, slice_rows, split and repeat (``sample``:
tests/test_torch_sample.py).

Both packages get the same numpy inputs (the port's through
``interop.table_from_buffers``). Tolerance 0: every buffer equal byte for
byte, validity presence and names. One recorded difference: the JAX
``concatenate_columns`` drops a non-string LIST column's lengths (ROADMAP
Queue 3); the port keeps them, so that case compares data and validity
and checks the port's lengths against the inputs'.
"""

import numpy as np
import pytest

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import copying as jcp
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops import copying as pcp


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
        for part, a, b in zip(("data", "validity", "lengths"), w[:3], g[:3]):
            assert (a is None) == (b is None), f"column {i} {part} presence"
            if a is not None:
                assert a.dtype == b.dtype, f"column {i} {part} dtype"
                np.testing.assert_array_equal(a, b, f"column {i} {part}")
    assert tuple(jt.names or ()) == tuple(pt.names or ())


def _table(n: int, seed: int, nullable: bool = True) -> JTable:
    rng = np.random.default_rng(seed)

    def ok():
        return rng.random(n) > 0.3 if nullable else None

    return JTable([
        JColumn.from_numpy(rng.integers(-9, 9, n), validity=ok()),
        JColumn.from_numpy(rng.standard_normal(n)),
        JColumn.from_numpy(rng.integers(0, 99, n).astype(np.int32),
                           validity=ok(), dtype=jdt.decimal32(-1)),
        JColumn.from_numpy(rng.random(n) > 0.5, validity=ok()),
    ], ["a", "b", "d", "c"])


@pytest.mark.parametrize("n", [0, 1, 1023, 1025])
def test_concatenate_matches_jax(n):
    """A nullable table after a non-null one: the output carries the
    merged validity, as in the JAX package."""
    parts = [_table(n, n, nullable=False), _table(7, n + 1), _table(n, n + 2)]
    _same(jcp.concatenate(parts), pcp.concatenate([_port(t) for t in parts]))
    with pytest.raises(ValueError, match="column counts"):
        pcp.concatenate([_port(parts[0]), _port(JTable(parts[0].columns[:2],
                                                       ["a", "b"]))])


def test_concatenate_list_columns_keeps_lengths():
    rng = np.random.default_rng(0)
    cols = []
    for n in (3, 5):
        lens = rng.integers(0, 5, n).astype(np.int32)
        mat = rng.integers(0, 255, (n, 4)).astype(np.uint8)
        cols.append(JColumn(mat, jdt.DType(jdt.TypeId.LIST), None, lens))
    tables = [JTable([c], ["r"]) for c in cols]
    want = jcp.concatenate(tables)
    got = pcp.concatenate([_port(t) for t in tables])
    assert want.columns[0].lengths is None  # the JAX package drops them
    data, valid, lengths = interop.table_to_buffers(got)[0][:3]
    np.testing.assert_array_equal(data, np.asarray(want.columns[0].data))
    assert valid is None
    np.testing.assert_array_equal(
        lengths, np.concatenate([np.asarray(c.lengths) for c in cols]))


def test_interleave_copy_if_else_sequence_match_jax():
    jt = _table(1025, 4)
    same = JTable([jt.columns[0], JColumn.from_numpy(np.arange(1025))],
                  ["x", "y"])
    want = jcp.interleave_columns(same)
    got = pcp.interleave_columns(_port(same))
    _same(JTable([want], ["i"]), type(_port(jt))([got], ["i"]))
    mask = jt.columns[3]
    pt = _port(jt)
    for lhs, rhs in ((0, 0), (0, 5), (-3, 0)):
        jl = jt.columns[0] if lhs == 0 else lhs
        jr = jt.columns[0] if rhs == 0 else rhs
        pl = pt.columns[0] if lhs == 0 else lhs
        pr = pt.columns[0] if rhs == 0 else rhs
        w = jcp.copy_if_else(mask, jl, jr)
        g = pcp.copy_if_else(pt.columns[3], pl, pr)
        _same(JTable([w], ["v"]), type(pt)([g], ["v"]))
    fl = jt.columns[1]
    for scalar in (0.1, 2):
        w = jcp.copy_if_else(mask, fl, scalar)
        g = pcp.copy_if_else(pt.columns[3], pt.columns[1], scalar)
        _same(JTable([w], ["v"]), type(pt)([g], ["v"]))
    for d, pd in ((jdt.INT32, dt.INT32), (jdt.INT64, dt.INT64),
                  (jdt.FLOAT64, dt.FLOAT64), (jdt.INT8, dt.INT8)):
        w = jcp.sequence(100, start=-7, step=3, dtype=d)
        g = pcp.sequence(100, start=-7, step=3, dtype=pd, device="cpu")
        _same(JTable([w], ["s"]), type(pt)([g], ["s"]))


@pytest.mark.parametrize("nl,nr", [(0, 3), (1, 1), (31, 33)])
def test_cross_join_matches_jax(nl, nr):
    left, right = _table(nl, nl), _table(nr, nr + 9)
    _same(jcp.cross_join(left, right), pcp.cross_join(_port(left),
                                                      _port(right)))
    unnamed = JTable(list(left.columns))
    _same(jcp.cross_join(unnamed, right),
          pcp.cross_join(_port(unnamed), _port(right)))


def test_scatter_slice_split_match_jax():
    target, source = _table(1025, 1), _table(40, 2)
    idx = np.random.default_rng(3).permutation(1025)[:40]
    _same(jcp.scatter(source, idx, target),
          pcp.scatter(_port(source), idx, _port(target)))
    pt = _port(target)
    for a, b in ((0, 0), (3, 1000), (1000, 1025)):
        _same(jcp.slice_rows(target, a, b), pcp.slice_rows(pt, a, b))
    for w, g in zip(jcp.split(target, [0, 100, 1023]),
                    pcp.split(pt, [0, 100, 1023])):
        _same(w, g)
    with pytest.raises(ValueError, match="bad boundaries"):
        pcp.split(pt, [200, 100])


@pytest.mark.parametrize("counts", [0, 1, 3, "per_row"])
@pytest.mark.parametrize("n", [1, 1023])
def test_repeat_matches_jax(n, counts):
    jt = _table(n, n)
    if counts == "per_row":
        counts = np.random.default_rng(n).integers(0, 4, n)
    _same(jcp.repeat(jt, counts), pcp.repeat(_port(jt), counts))
    with pytest.raises(ValueError, match="non-negative"):
        pcp.repeat(_port(jt), -1)
