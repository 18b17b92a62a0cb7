"""The port's ``factories.py`` against the JAX package's, on the CPU: the
constructors, the copy and reshape family, the shape-bucket entry points
with ``run_plan`` over a padded table, and the validity bitmask.
Tolerance 0 (data, validity and lengths bytes, types, names).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import factories as jf
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import factories as pf
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.utils import config as pconfig


@pytest.fixture(autouse=True)
def _clean():
    yield
    for c in (jconfig, pconfig):
        c.clear_flag("BUCKETS")


def _jcol_buffers(c):
    return (np.asarray(c.data),
            None if c.validity is None else np.asarray(c.validity),
            None if c.lengths is None else np.asarray(c.lengths),
            int(c.dtype.id), int(c.dtype.scale))


def _port_col(c):
    return interop.column_from_buffers(*_jcol_buffers(c), device="cpu")


def _same_col(jc, pc) -> None:
    w, g = _jcol_buffers(jc), interop.column_to_buffers(pc)
    assert w[3:] == g[3:]
    assert w[0].dtype == g[0].dtype and w[0].shape == g[0].shape
    assert w[0].tobytes() == g[0].tobytes()
    for a, b in ((w[1], g[1]), (w[2], g[2])):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def _same_table(jt, pt) -> None:
    assert jt.num_columns == pt.num_columns
    for jc, pc in zip(jt.columns, pt.columns):
        _same_col(jc, pc)
    assert tuple(jt.names or ()) == tuple(pt.names or ())
    assert jt.logical_rows == pt.logical_rows


def _cols(n: int, seed: int):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.3
    return [
        JColumn.from_numpy(rng.integers(-99, 99, n).astype(np.int64)),
        JColumn.from_numpy(rng.integers(-99, 99, n).astype(np.int64),
                           validity=valid),
        JColumn.from_numpy(rng.normal(0, 1, n)),
        JColumn.from_strings([f"v{int(x)}" * int(x % 3) if x % 5 else None
                              for x in rng.integers(0, 40, n)]),
    ]


@pytest.mark.parametrize("d", [dt.INT32, dt.INT64, dt.FLOAT64, dt.INT8],
                         ids=str)
def test_sequence(d):
    jd = jdt.DType(jdt.TypeId(int(d.id)))
    _same_col(jf.sequence(9, 5, -3, jd),
              pf.sequence(9, 5, -3, d, device="cpu"))


@pytest.mark.parametrize("value,tid", [(7, dt.TypeId.INT32),
                                       (-2.5, dt.TypeId.FLOAT64),
                                       (True, dt.TypeId.BOOL8),
                                       ("hé", dt.TypeId.STRING)])
def test_full_and_full_null(value, tid):
    d, jd = dt.DType(tid), jdt.DType(jdt.TypeId(int(tid)))
    _same_col(jf.full(5, value, jd), pf.full(5, value, d, device="cpu"))
    _same_col(jf.full_null(5, jd), pf.full_null(5, d, device="cpu"))


def test_empty_like():
    for jc in _cols(6, 1):
        pc = _port_col(jc)
        _same_col(jf.empty_like(jc), pf.empty_like(pc))
        _same_col(jf.empty_like(jc, 3), pf.empty_like(pc, 3))


def test_concatenate_and_slices():
    a, b = _cols(7, 2), _cols(4, 3)
    for ja, jb in zip(a, b):
        _same_col(jf.concatenate([ja, jb]),
                  pf.concatenate([_port_col(ja), _port_col(jb)]))
    ja, jb = JTable(a, list("wxyz")), JTable(b, list("wxyz"))
    pa = interop.table_from_buffers([_jcol_buffers(c) for c in a],
                                    list("wxyz"), device="cpu")
    pb = interop.table_from_buffers([_jcol_buffers(c) for c in b],
                                    list("wxyz"), device="cpu")
    _same_table(jf.concatenate_tables([ja, jb]),
                pf.concatenate_tables([pa, pb]))
    _same_col(jf.slice_column(a[3], 2, 5), pf.slice_column(pa.columns[3], 2, 5))
    _same_table(jf.slice_table(ja, 1, 6), pf.slice_table(pa, 1, 6))
    for jt, pt in zip(jf.split_table(ja, [2, 2, 5]),
                      pf.split_table(pa, [2, 2, 5])):
        _same_table(jt, pt)
    with pytest.raises(ValueError):
        pf.concatenate([])
    with pytest.raises(ValueError):
        pf.concatenate_tables([])


def test_interleave_and_copy_if_else():
    a, b = _cols(6, 4), _cols(6, 5)
    _same_col(jf.interleave_columns([a[0], a[1], b[1]]),
              pf.interleave_columns([_port_col(c) for c in (a[0], a[1], b[1])]))
    mask = JColumn.from_numpy(np.array([1, 0, 1, 1, 0, 1], bool),
                              validity=np.array([1, 1, 0, 1, 1, 1], bool))
    for lhs, rhs in zip(a, b):
        _same_col(jf.copy_if_else(lhs, rhs, mask),
                  pf.copy_if_else(_port_col(lhs), _port_col(rhs),
                                  _port_col(mask)))
    with pytest.raises(TypeError):
        pf.interleave_columns([_port_col(a[3])])
    with pytest.raises(TypeError):
        pf.copy_if_else(_port_col(a[0]), _port_col(a[2]), _port_col(mask))


def test_pad_to_bucket_and_run_plan():
    """A caller of the op library pads once, runs a plan over the padded
    table and unpads at the end (or keeps the padded result)."""
    for c in (jconfig, pconfig):
        c.set_flag("BUCKETS", "16:2:64")
    rng = np.random.default_rng(6)
    n = 21
    jt = JTable([JColumn.from_numpy(rng.integers(0, 5, n).astype(np.int64)),
                 JColumn.from_numpy(rng.integers(-9, 9, n).astype(np.int64)),
                 JColumn.from_numpy(rng.random(n) > 0.3)], ["k", "v", "m"])
    pt = interop.table_from_buffers([_jcol_buffers(c) for c in jt.columns],
                                    jt.names, device="cpu")
    jp, pp = jf.pad_to_bucket(jt), pf.pad_to_bucket(pt)
    _same_table(jp, pp)
    assert pp.row_count == 32 and pp.logical_rows == n
    plan = [{"op": "filter", "mask": 2},
            {"op": "groupby", "by": [0], "aggs": [
                {"column": 1, "agg": "sum"}, {"column": 1, "agg": "max"}]},
            {"op": "sort_by", "keys": [{"column": 0}]}]
    _same_table(jf.run_plan(plan, jp), pf.run_plan(plan, pp))
    kept, jkept = pf.run_plan(plan, pp, unpad=False), \
        jf.run_plan(plan, jp, unpad=False)
    assert kept.is_padded
    assert (kept.row_count, kept.logical_rows) == \
        (jkept.row_count, jkept.logical_rows)
    _same_table(jf.unpad_table(jkept), pf.unpad_table(kept))
    assert pf.pad_to_bucket(pt, 64).row_count == 64


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 17, 64])
def test_bitmask_round_trip(n):
    rng = np.random.default_rng(n)
    v = rng.random(n) > 0.5
    want = np.asarray(jf.pack_bitmask(jnp.asarray(v)))
    got = pf.pack_bitmask(torch.from_numpy(v))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pf.unpack_bitmask(got, n).numpy(), v)
    np.testing.assert_array_equal(
        np.asarray(jf.unpack_bitmask(jnp.asarray(want), n)), v)
