"""The PyTorch port's kernels (plain versions) against the JAX package's
Pallas kernels run in interpret mode, as the JAX tests run them off a
TPU. Inputs come from a numpy seed and go through both packages; every
comparison is exact (integers and bytes, tolerance 0).

The CUDA kernels themselves run only on a GPU: ``chip_smoke.py`` holds
each of them against the plain versions tested here.
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import rows as jrows
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.kernels import bitonic_sort as jbs
from spark_rapids_jni_tpu.kernels import hash_table as jht
from spark_rapids_jni_tpu.kernels import hashing as jkh
from spark_rapids_jni_tpu.kernels import row_transpose as jrt
from spark_rapids_jni_tpu.ops import hashing as jhashing
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import interop, rows
from spark_rapids_jni_tpu_torch.kernels import bitonic_sort as bs
from spark_rapids_jni_tpu_torch.kernels import hash_table as ht
from spark_rapids_jni_tpu_torch.kernels import hashing as kh
from spark_rapids_jni_tpu_torch.kernels import row_transpose as rt
from spark_rapids_jni_tpu_torch.ops import hashing as hashing_ops
from spark_rapids_jni_tpu_torch.runtime_bridge import UnsupportedOpError

_M32 = np.uint64(0xFFFFFFFF)


def _halves(words: np.ndarray):
    """u64 words -> (lo, hi) u32 numpy arrays."""
    return ((words & _M32).astype(np.uint32),
            (words >> np.uint64(32)).astype(np.uint32))


def _t32(a: np.ndarray) -> torch.Tensor:
    """u32 numpy -> the port's int32 bit-pattern tensor on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _keys(rng, c, t, distinct):
    """(C, T) u64 words drawn from ``distinct`` random keys (so keys
    repeat and collide), with both 32-bit halves populated."""
    pool = rng.integers(0, 2**63, distinct, dtype=np.int64).astype(np.uint64)
    pool[0] = np.uint64(0xFFFFFFFF00000001)  # top bit set
    return pool[rng.integers(0, distinct, (c, t))]


def test_hash_word_matches_jax():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**63, 4096, dtype=np.int64).astype(np.uint64)
    words[:3] = [0, np.uint64(2**64 - 1), np.uint64(2**63)]
    want = np.asarray(jht.hash_word(jnp.asarray(words)))
    lo, hi = _halves(words)
    got = ht.hash_word(_t32(lo).to(torch.int64) & 0xFFFFFFFF,
                       _t32(hi).to(torch.int64) & 0xFFFFFFFF)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


BUILD_CASES = [
    # (C, T, distinct keys or a hard chunk's name, null fraction,
    # max_probes[, queries]): the probe's queries are "mixed" unless the
    # case says "half" (half the build's keys in a new order, half new
    # ones), "views" (half, one row into their buffers) or "absent" (none
    # of the build's keys)
    (1, 1024, 300, 0.1, jht.MAX_PROBES),
    (1, 2048, 2048 * 4, 0.0, jht.MAX_PROBES),
    (4, 1024, 50, 0.2, jht.MAX_PROBES),
    (4, 2048, 5000, 0.05, jht.MAX_PROBES),
    (4, 1024, 3000, 0.0, 2),  # forces overflow / unresolved
    # the chunks the CUDA build's regimes are hardest on: most rows claim
    # one slot in round 0, or every key walks one probe chain
    (2, 512, "one_key_most_rows", 0.1, jht.MAX_PROBES),
    (2, 128, "one_home_slot", 0.0, jht.MAX_PROBES),
    (2, 1024, 700, 0.1, jht.MAX_PROBES, "absent"),
    (3, 512, 400, 0.0, jht.MAX_PROBES, "views"),
    (1, 1001, 800, 0.2, jht.MAX_PROBES, "views"),
    (4, 1024, 3000, 0.0, 1, "half"),
    (2, 2048, 1500, 0.05, 1, "views"),
]


def _build_case(c, t, distinct, nulls, probes, queries="mixed"):
    """One BUILD_CASES entry as a pytest param; a "mixed" case keeps the
    id of the five fields alone."""
    fields = (c, t, distinct, nulls, probes)
    tag = "" if queries == "mixed" else f"-{queries}"
    return pytest.param(*fields, queries,
                        id="-".join(map(str, fields)) + tag)


def _build_words(rng, c, t, distinct):
    """(C, T) u64 build keys: drawn from ``distinct`` random keys, or a
    hard chunk — "one_key_most_rows" (80 % of the rows one key, the rest
    from T random keys) or "one_home_slot" (C * T distinct keys that all
    hash to slot 0 of the 2T-slot table)."""
    if distinct == "one_key_most_rows":
        words = _keys(rng, c, t, t)
        words[rng.random((c, t)) < 0.8] = words[0, 0]
        return words
    if distinct == "one_home_slot":
        lo, hi = chip_smoke.one_home_keys(rng, c * t, 2 * t)
        word = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        return word.reshape(c, t)
    return _keys(rng, c, t, distinct)


@pytest.mark.parametrize("c,t,distinct,nulls,probes,queries",
                         [_build_case(*case) for case in BUILD_CASES])
def test_build_and_probe_match_jax(c, t, distinct, nulls, probes, queries):
    seed = c * 7919 + t + (distinct if isinstance(distinct, int) else 0)
    rng = np.random.default_rng(seed)
    words = _build_words(rng, c, t, distinct)
    lo, hi = _halves(words)
    valid = (rng.random((c, t)) >= nulls).astype(np.int32)
    s = 2 << (t - 1).bit_length()  # the registry's 2 * next power of two
    want = jht.build_table(jnp.asarray(lo), jnp.asarray(hi),
                           jnp.asarray(valid), table_slots=s,
                           max_probes=probes, interpret=True)
    got = ht.build_table(_t32(lo), _t32(hi), torch.from_numpy(valid),
                         table_slots=s, max_probes=probes)
    slot, tlo, thi, trow, ovf, dup = got
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(_u32(tlo), np.asarray(want[1]))
    np.testing.assert_array_equal(_u32(thi), np.asarray(want[2]))
    np.testing.assert_array_equal(trow.numpy(), np.asarray(want[3]))
    assert int(ovf) == int(want[4])
    assert int(dup) == int(want[5])
    if distinct == "one_home_slot":
        # one key placed a round, the rest overflow at the bound
        homes = ht.hash_word(_t32(lo).to(torch.int64) & 0xFFFFFFFF,
                             _t32(hi).to(torch.int64) & 0xFFFFFFFF) & (s - 1)
        assert not homes.any()
        assert int(ovf) == c * (t - probes)
    elif probes < jht.MAX_PROBES:
        assert int(ovf) > 0, "the small probe bound must overflow"
    else:
        assert int(ovf) == 0
    if distinct == "one_key_most_rows" or (
            isinstance(distinct, int) and distinct < c * t):
        assert int(dup) > 0, "repeated keys must count as dup"

    # probe: "mixed" keys from a new pool (a hard chunk's: as "half")
    if queries == "absent":
        # the build's keys are below 2^63 but for 0xFFFFFFFF00000001
        qwords = (rng.integers(0, 2**63, (c, t), dtype=np.int64)
                  .astype(np.uint64) | np.uint64(2**63))
        assert not np.isin(qwords, words).any()
    elif isinstance(distinct, int) and queries == "mixed":
        qwords = _keys(rng, c, t, distinct * 2)
    else:
        qwords = np.where(rng.random((c, t)) < 0.5,
                          words[:, rng.permutation(t)], _keys(rng, c, t, t))
    qlo, qhi = _halves(qwords)
    qvalid = (rng.random((c, t)) >= nulls).astype(np.int32)
    pwant = jht.probe_table(
        jnp.asarray(qlo), jnp.asarray(qhi), jnp.asarray(qvalid),
        want[1], want[2], want[3], max_probes=probes, interpret=True,
    )
    q = [_t32(qlo), _t32(qhi), torch.from_numpy(qvalid)]
    if queries == "views":
        q = [chip_smoke.shifted(x, 1) for x in q]
        assert all(x.storage_offset() == 1 and x.is_contiguous() for x in q)
    found, row, unres = ht.probe_table(*q, tlo, thi, trow, max_probes=probes)
    np.testing.assert_array_equal(found.numpy(), np.asarray(pwant[0]))
    np.testing.assert_array_equal(row.numpy(), np.asarray(pwant[1]))
    assert int(unres) == int(pwant[2])
    if queries == "absent":
        assert not found.any() and int(unres) == 0
    elif queries != "mixed":
        assert found.any()
    if probes == 1:
        assert int(unres) > 0, "one probe step must leave collisions"


# chip_smoke.TRANSPOSE_SCHEMAS: the slice's fact schema, RowConversionTest
# (SURVEY.md §4), a DECIMAL128 column, narrow columns at odd offsets, 9,
# 17 and 128 columns; at chip_smoke.TRANSPOSE_ROWS, the tile edges of the
# CUDA kernels and the bucket edges
@pytest.mark.parametrize("n", chip_smoke.TRANSPOSE_ROWS)
@pytest.mark.parametrize("schema", sorted(chip_smoke.TRANSPOSE_SCHEMAS))
def test_pack_unpack_match_jax(schema, n):
    rng = np.random.default_rng(n)
    types = chip_smoke.TRANSPOSE_SCHEMAS[schema]
    jl = jrows.compute_fixed_width_layout(
        [jdt.DType(jdt.TypeId(t), s) for t, s in types])
    pl = rows.compute_fixed_width_layout(
        [dt.DType(dt.TypeId(t), s) for t, s in types])
    assert (pl.column_offsets, pl.column_widths, pl.validity_offset,
            pl.validity_bytes, pl.row_size) == (
        jl.column_offsets, jl.column_widths, jl.validity_offset,
        jl.validity_bytes, jl.row_size)
    col_bytes, valid = chip_smoke.transpose_inputs(rng, jl.column_widths, n)
    want = np.array(jrt.pack_rows_pallas(
        tuple(jnp.asarray(b) for b in col_bytes), jnp.asarray(valid), jl,
        interpret=True,
    ))
    got = rt.pack_rows([torch.from_numpy(b) for b in col_bytes],
                       torch.from_numpy(valid), pl)
    np.testing.assert_array_equal(got.numpy(), want)

    wcols, wvalid = jrt.unpack_rows_pallas(jnp.asarray(want), jl,
                                           interpret=True)
    gcols, gvalid = rt.unpack_rows(torch.from_numpy(want), pl)
    for g, w in zip(gcols, wcols):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
    np.testing.assert_array_equal(gvalid.numpy(), valid)

    # the per-column entries rows.py calls give the same bytes
    vecs = [torch.from_numpy(valid[:, i] != 0) for i in range(valid.shape[1])]
    got = rt.pack_rows_columns([torch.from_numpy(b) for b in col_bytes],
                               vecs, pl)
    np.testing.assert_array_equal(got.numpy(), want)
    ccols, cvalid, nulls = rt.unpack_rows_columns(torch.from_numpy(want), pl)
    for g, w in zip(ccols, wcols):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i, v in enumerate(cvalid):
        assert v.dtype == torch.bool and v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), valid[:, i] != 0)
    np.testing.assert_array_equal(nulls.numpy(), (valid == 0).sum(0))


@pytest.mark.parametrize("schema", ["decimal128", "narrow_odd", "cols17"])
def test_pack_rows_columns_without_validity_is_all_valid(schema):
    """A column without a validity vector packs as all valid."""
    types = chip_smoke.TRANSPOSE_SCHEMAS[schema]
    pl = rows.compute_fixed_width_layout(
        [dt.DType(dt.TypeId(t), s) for t, s in types])
    col_bytes, valid = chip_smoke.transpose_inputs(
        np.random.default_rng(3), pl.column_widths, 257)
    cols = [torch.from_numpy(b) for b in col_bytes]
    vecs = [None if i % 2 else torch.from_numpy(valid[:, i] != 0)
            for i in range(len(cols))]
    ones = valid.copy()
    ones[:, 1::2] = 1
    want = rt.pack_rows(cols, torch.from_numpy(ones), pl)
    assert torch.equal(rt.pack_rows_columns(cols, vecs, pl), want)
    _, cvalid, nulls = rt.unpack_rows_columns(want, pl)
    assert all(bool(v.all()) for v in cvalid[1::2])
    assert nulls[1::2].eq(0).all() and nulls[0::2].gt(0).all()


# ---------------------------------------------------------------------------
# K3: the batched stable sort of u64 keys
# ---------------------------------------------------------------------------


def _sort_payloads(rng, c, t):
    """int64, float64 (NaN bits included), int32, float32, bool and int8
    payloads, as numpy arrays both packages take."""
    f64 = rng.standard_normal((c, t))
    f64.flat[:2] = [np.nan, -0.0]
    f32 = rng.standard_normal((c, t)).astype(np.float32)
    f32.flat[:2] = [np.nan, -0.0]
    return [
        rng.integers(-2**62, 2**62, (c, t)),
        f64,
        rng.integers(-2**31, 2**31, (c, t)).astype(np.int32),
        f32,
        rng.random((c, t)) > 0.5,
        rng.integers(-128, 128, (c, t)).astype(np.int8),
    ]


# hard key classes of the u64 sorts (chip_smoke.py holds the CUDA kernels
# against the plain version on the same classes); "mixed" is this test's
# own: small repeated keys among all-ones and top-bit keys
KEY_CLASSES = ("all_equal", "byte0", "byte3", "byte7", "top_bit",
               "random_repeats", "mixed_rows_padded")
SORT_CASES = [pytest.param("mixed", c, t, id=f"{c}-{t}")
              for c, t in ((1, 2), (1, 1024), (3, 256))] + [
    pytest.param(kind, c, t, id=f"{kind}-{c}-{t}")
    for kind in KEY_CLASSES for c, t in ((1, 1024), (3, 256))]


def _sort_keys(kind, rng, c, t):
    if kind != "mixed":
        return chip_smoke.sort_key_classes(rng, c, t)[kind]
    key = rng.integers(0, max(t // 8, 2), (c, t)).astype(np.uint64)  # repeats
    key[:, ::7] = np.uint64(2**64 - 1)  # all-ones keys among the rest
    key[:, 1::11] = np.uint64(2**63)  # top bit set
    return key


@pytest.mark.parametrize("kind,c,t", SORT_CASES)
def test_batched_sort_matches_jax(kind, c, t):
    rng = np.random.default_rng(c * 100 + t)
    key = _sort_keys(kind, rng, c, t)
    pays = _sort_payloads(rng, c, t)
    want = jbs.batched_sort_u64_looped(
        jnp.asarray(key), *[jnp.asarray(p) for p in pays], interpret=True)
    got = bs.batched_sort_u64_looped(
        torch.from_numpy(key.view(np.int64)),
        *[torch.from_numpy(p) for p in pays])
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32
    for g, w, p in zip(got[2:], want[2:], pays):
        assert g.numpy().dtype == p.dtype
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      np.asarray(w).view(np.uint8))
    # K4a, keys only: K3's contract
    k4a = bs.batched_sort_u64(torch.from_numpy(key.view(np.int64)))
    np.testing.assert_array_equal(k4a[0].numpy(), got[0].numpy())
    np.testing.assert_array_equal(k4a[1].numpy(), got[1].numpy())


# the bytes each class varies in, row by row (at 3 rows of 256 keys)
CLASS_DIGITS = {
    "all_equal": [[0]] * 3,  # none varies: the radix sort's one pass
    "byte0": [[0]] * 3, "byte3": [[3]] * 3, "byte7": [[7]] * 3,
    "top_bit": [[7]] * 3,
    "random_repeats": [list(range(8))] * 3,
    "mixed_rows_padded": [[1], [0, 6], list(range(8))],
}


@pytest.mark.parametrize("kind", KEY_CLASSES)
def test_sort_key_classes_vary_in_their_digits(kind):
    """Each hard key class makes the radix sort run the digits it names."""
    key = chip_smoke.sort_key_classes(np.random.default_rng(5), 3, 256)[kind]
    assert key.dtype == np.uint64 and key.shape == (3, 256)
    act = chip_smoke.active_digits(torch.from_numpy(key.view(np.int64)))
    assert [np.flatnonzero(a).tolist() for a in act.numpy()] == \
        CLASS_DIGITS[kind]
    assert np.unique(key).shape[0] < key.size, "keys must repeat"


@pytest.mark.parametrize("sort", [bs.batched_sort_u64_looped,
                                  bs.batched_sort_u64],
                         ids=["K3", "K4a"])
def test_batched_sort_rejects_what_jax_rejects(sort):
    """K3 and K4a share one contract and one set of checks."""
    key = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(TypeError, match="narrow float payload"):
        sort(key, torch.zeros((1, 8), dtype=torch.float16))
    with pytest.raises(ValueError, match="power of two"):
        sort(torch.zeros((1, 12), dtype=torch.int64))
    with pytest.raises(ValueError, match="payload"):
        sort(key, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(TypeError, match="u64 bits in int64"):
        sort(key.to(torch.int32))


# ---------------------------------------------------------------------------
# K5: the chained Spark Murmur3 over fixed-width keys
# ---------------------------------------------------------------------------

# DECIMAL128 is left out: the JAX chain cannot hash its (n, 2) limbs (it
# raises on the shapes), and the port raises UnsupportedOpError (below)
_HASH_IDS = sorted(t for t in jdt._WIDTHS if t != jdt.TypeId.DECIMAL128)


def _hash_column(rng, tid, n):
    """A JAX column of type ``tid`` with nulls; floats carry -0.0, +0.0
    and NaN."""
    scale = -2 if tid in (jdt.TypeId.DECIMAL32, jdt.TypeId.DECIMAL64) else 0
    d = jdt.DType(tid, scale)
    if tid == jdt.TypeId.BOOL8:
        vals = rng.random(n) > 0.5
    elif tid in (jdt.TypeId.FLOAT32, jdt.TypeId.FLOAT64):
        np_t = np.float32 if tid == jdt.TypeId.FLOAT32 else np.float64
        vals = (rng.standard_normal(n) * 1e3).astype(np_t)
        vals[:4] = [-0.0, 0.0, np.nan, -np.nan]
    else:
        np_t = np.dtype(d.storage_dtype)
        info = np.iinfo(np_t)
        vals = rng.integers(info.min, info.max, n, dtype=np_t, endpoint=True)
        vals[:2] = [info.min, info.max]
    return JColumn.from_numpy(vals, validity=rng.random(n) > 0.2, dtype=d)


def _port_table(jt):
    return interop.table_from_buffers(
        [(np.asarray(c.data),
          None if c.validity is None else np.asarray(c.validity), None,
          int(c.dtype.id), int(c.dtype.scale)) for c in jt.columns],
        device="cpu")


@pytest.mark.parametrize("tid", _HASH_IDS, ids=lambda t: t.name)
def test_murmur3_matches_jax(tid):
    n = 1025
    rng = np.random.default_rng(int(tid))
    chain = [_hash_column(rng, tid, n),
             JColumn.from_numpy(rng.integers(-2**40, 2**40, n),
                                validity=rng.random(n) > 0.1),
             _hash_column(rng, jdt.TypeId.FLOAT32, n)]
    jt = JTable(chain)
    pt = _port_table(jt)
    for cols in ([0], [0, 1], [0, 1, 2]):
        want = np.asarray(jkh.murmur3_table_fused(jt, cols,
                                                  interpret=True).data)
        np.testing.assert_array_equal(
            np.asarray(jhashing.murmur3_table(jt, cols).data), want)
        np.testing.assert_array_equal(
            kh.murmur3_columns([pt.columns[i] for i in cols]).numpy(), want)
        got = hashing_ops.murmur3_table(pt, cols)
        assert got.validity is None and got.dtype == dt.INT32
        np.testing.assert_array_equal(got.data.numpy(), want)
    np.testing.assert_array_equal(
        hashing_ops.murmur3_column(pt.columns[0], seed=7).data.numpy(),
        np.asarray(jhashing.murmur3_column(jt.columns[0], seed=7).data))


def test_murmur3_spark_golden_values():
    """Spark's Murmur3Hash(long) at seed 42 (the JAX package pins the
    same literals from an independent oracle)."""
    t = interop.table_from_buffers(
        [(np.array([0, 1, -1], np.int64), None, None, 4, 0)], device="cpu")
    np.testing.assert_array_equal(
        kh.murmur3_columns(t.columns).numpy(),
        np.array([-1670924195, -1712319331, -939490007], np.int32))


def test_murmur3_unported_keys_raise():
    limbs = np.zeros((4, 2), np.uint64)
    t = interop.table_from_buffers([(limbs, None, None, 27, 0)], device="cpu")
    with pytest.raises(UnsupportedOpError, match="DECIMAL128"):
        hashing_ops.murmur3_table(t)
    with pytest.raises(TypeError, match="no Murmur3 word rule"):
        kh.murmur3_columns(t.columns)
