"""The PyTorch port's packed-key groupby and its two batched sort kernels
against the JAX package, on the CPU.

* K4a ``batched_sort_u64`` and K4b ``batched_sort_u32``: the port's plain
  versions against the JAX Pallas kernels in interpret mode, exact.
* ``groupby_aggregate_packed_chunked`` under the engines ``"lax"``,
  ``"pallas"`` (K4a) and ``"pallas32"`` (K4b) against the JAX function with
  the same engine; ``groupby_aggregate_packed`` (the eager router, with
  its flat arm and its declines) and ``groupby_aggregate_packed_flat``.

Inputs are made with numpy from a seed and carried into the port over the
same bytes. Rows at and beyond ``num_groups`` hold garbage in both
packages, so only the first ``num_groups`` rows are compared, together
with ``num_groups``, ``max_chunk`` and ``overflow``. Integer results,
keys, counts, min, max, first and last compare exactly, and so do float
sums and means: the port's float cumsum adds in the order of XLA's CPU
scan, so they are the JAX package's bytes.

Most cases share one shape (1025 rows, chunk_rows 256, chunk_segments
256, num_segments 1024, an INT64 value column), so the JAX reference
runs eagerly and compiles its ops once; the cases of another shape run
it under ``jax.jit``.
"""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.kernels import bitonic_sort as jbs
from spark_rapids_jni_tpu.ops import groupby_packed as jgp
from spark_rapids_jni_tpu.ops.groupby import GroupbyAgg as JAgg
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.kernels import bitonic_sort as bs
from spark_rapids_jni_tpu_torch.ops import groupby_packed as gp
from spark_rapids_jni_tpu_torch.ops.groupby import GroupbyAgg

ENGINES = ["lax", "pallas", "pallas32"]
OPS7 = ["sum", "count", "min", "max", "first", "last", "mean"]


# ---------------------------------------------------------------------------
# (i) K4a and K4b: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [8, 128, 256])
@pytest.mark.parametrize("c", [3, 11])
def test_batched_sort_u64_matches_jax(c, t):
    """Duplicate keys (the perm shows stability) and extreme u64 keys,
    with a float64 payload (split into u32 halves by the JAX wrapper)."""
    rng = np.random.default_rng(c * 1000 + t)
    key = rng.integers(0, max(t // 8, 2), (c, t)).astype(np.uint64)
    key[:, ::7] = np.uint64(2**64 - 1)
    key[:, 1::5] = np.uint64(2**63)
    key[:, 2::9] = np.uint64(2**63 - 1)
    pay = rng.standard_normal((c, t))
    pay.flat[:2] = [np.nan, -0.0]
    want = jbs.batched_sort_u64(jnp.asarray(key), jnp.asarray(pay),
                                interpret=True)
    got = bs.batched_sort_u64(torch.from_numpy(key.view(np.int64)),
                              torch.from_numpy(pay))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64),
                                  np.asarray(want[0]))
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy().view(np.uint64),
                                  np.asarray(want[2]).view(np.uint64))


@pytest.mark.parametrize("t", [8, 128, 256])
@pytest.mark.parametrize("c", [3, 11])
def test_batched_sort_u32_matches_jax(c, t):
    """Distinct keys per row (random high bits over an embedded iota, as
    the packed groupby's word), the top bit and the all-ones word among
    them, with float32 (NaN, -0.0) and int16 payloads."""
    rng = np.random.default_rng(c * 1000 + t + 1)
    ib = t.bit_length() - 1
    high = rng.integers(0, 2 ** (32 - ib), (c, t), dtype=np.uint64)
    high[:, -1] = 2 ** (32 - ib) - 1  # the all-ones word
    high[:, 0] = 2 ** (31 - ib)  # the top bit alone
    key = ((high << np.uint64(ib)) | np.arange(t, dtype=np.uint64)).astype(
        np.uint32)
    f32 = rng.standard_normal((c, t)).astype(np.float32)
    f32.flat[:2] = [np.nan, -0.0]
    i16 = rng.integers(-2**15, 2**15, (c, t)).astype(np.int16)
    want = jbs.batched_sort_u32(jnp.asarray(key), jnp.asarray(f32),
                                jnp.asarray(i16), interpret=True)
    got = bs.batched_sort_u32(torch.from_numpy(key.view(np.int32)),
                              torch.from_numpy(f32), torch.from_numpy(i16))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32),
                                  np.asarray(want[1]).view(np.uint32))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("t", [8, 256, 8192])
def test_batched_sort_u32_plain_is_a_stable_sort(t):
    """The property the CUDA K4b (a radix sort) is held to on the card: on
    rows of distinct keys, plain K4b equals a stable torch.sort of the
    int32 carrier (top bit flipped), payloads included; keys only, it
    equals that sort also where all-ones words tie (the packed groupby's
    padding)."""
    rng = np.random.default_rng(t + 2)
    c = 3
    key = torch.from_numpy(chip_smoke.distinct_u32_rows(rng, c, t).view(
        np.int32))
    p32 = torch.from_numpy(rng.integers(-2**31, 2**31, (c, t)).astype(
        np.int32))
    p16 = torch.from_numpy(rng.integers(-2**15, 2**15, (c, t)).astype(
        np.int16))
    carrier, order = torch.sort(key ^ -2**31, dim=1, stable=True)
    got = bs.batched_sort_u32(key, p32, p16)
    assert torch.equal(got[0], carrier ^ -2**31)
    assert torch.equal(got[1], torch.gather(p32, 1, order))
    assert torch.equal(got[2], torch.gather(p16, 1, order))
    tied = key.clone()
    tied[:, t - t // 3:] = -1
    want = torch.sort(tied ^ -2**31, dim=1, stable=True)[0] ^ -2**31
    assert torch.equal(bs.batched_sort_u32(tied)[0], want)


def _zeros(dtype, shape=(1, 8)):
    return (torch.zeros(shape, dtype=getattr(torch, dtype)),
            jnp.zeros(shape, getattr(jnp, dtype)))


# (port call, JAX call) on the same bad input -> the same error
REJECTS = {
    "u64_narrow_float_payload": (
        lambda: bs.batched_sort_u64(_zeros("int64")[0], _zeros("float16")[0]),
        lambda: jbs.batched_sort_u64(_zeros("uint64")[1], _zeros("float16")[1],
                                     interpret=True),
        TypeError, "narrow float payload"),
    "u64_not_pow2": (
        lambda: bs.batched_sort_u64(_zeros("int64", (2, 12))[0]),
        lambda: jbs.batched_sort_u64(_zeros("uint64", (2, 12))[1],
                                     interpret=True),
        ValueError, "power of two"),
    "u32_not_pow2": (
        lambda: bs.batched_sort_u32(_zeros("int32", (2, 12))[0]),
        lambda: jbs.batched_sort_u32(_zeros("uint32", (2, 12))[1],
                                     interpret=True),
        ValueError, "power of two"),
    "u32_key_dtype": (
        lambda: bs.batched_sort_u32(_zeros("int64")[0]),
        lambda: jbs.batched_sort_u32(_zeros("uint64")[1], interpret=True),
        TypeError, "key must be uint32"),
    "u32_wide_payload": (
        lambda: bs.batched_sort_u32(_zeros("int32")[0], _zeros("int64")[0]),
        lambda: jbs.batched_sort_u32(_zeros("uint32")[1], _zeros("int64")[1],
                                     interpret=True),
        TypeError, "u32 network payload"),
    "u32_narrow_float_payload": (
        lambda: bs.batched_sort_u32(_zeros("int32")[0], _zeros("float16")[0]),
        lambda: jbs.batched_sort_u32(_zeros("uint32")[1],
                                     _zeros("float16")[1], interpret=True),
        TypeError, "u32 network payload"),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_batched_sorts_reject_what_jax_rejects(case):
    port, jax_call, exc, match = REJECTS[case]
    with pytest.raises(exc, match=match):
        jax_call()
    with pytest.raises(exc, match=match):
        port()


@pytest.mark.parametrize("sort", [bs.batched_sort_u64, bs.batched_sort_u32])
def test_batched_sorts_reject_a_payload_of_another_shape(sort):
    key = torch.zeros((2, 8), dtype=torch.int64 if sort is bs.batched_sort_u64
                      else torch.int32)
    with pytest.raises(ValueError, match="payload"):
        sort(key, torch.zeros((2, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# tables in both packages, and the comparison
# ---------------------------------------------------------------------------


def _buffers(jt: JTable) -> list:
    return [(np.asarray(c.data), None, None, int(c.dtype.id),
             int(c.dtype.scale)) for c in jt.columns]


def _tables(cols: dict):
    """``{name: (numpy values, JAX dtype)}`` -> (JAX table, port table)."""
    jt = JTable([JColumn.from_numpy(v, dtype=d) for v, d in cols.values()],
                list(cols))
    return jt, interop.table_from_buffers(_buffers(jt), list(cols),
                                          device="cpu")


def _aggs(ops, col="v"):
    return ([JAgg(col, op) for op in ops], [GroupbyAgg(col, op) for op in ops])


def _same_rows(want: JTable, got, g: int):
    """The first ``g`` rows of every column equal byte for byte (float
    sums and means too: the port's float cumsum adds in the order of XLA's
    CPU scan)."""
    assert tuple(got.names) == tuple(want.names)
    for name, wc, gc in zip(want.names, want.columns, got.columns):
        assert gc.dtype.id == wc.dtype.id and gc.dtype.scale == wc.dtype.scale
        w = np.asarray(wc.data)[:g]
        x = interop.column_to_buffers(gc)[0][:g]
        assert x.dtype == w.dtype, name
        np.testing.assert_array_equal(x, w, err_msg=name)
        assert x.tobytes() == w.tobytes(), name
        assert (gc.validity is None) == (wc.validity is None), name
        if wc.validity is not None:
            np.testing.assert_array_equal(gc.validity.numpy()[:g],
                                          np.asarray(wc.validity)[:g])


def _same_chunked(want, got):
    """The counts and flags equal; the rows too where the result is exact
    (no overflow: an overflowing key can share the sentinel's segment, so
    its rows mix with garbage partials)."""
    g = int(want[1])
    assert (int(got[1]), int(got[2]), bool(got[3])) == (
        g, int(want[2]), bool(want[3]))
    if not bool(want[3]):
        _same_rows(want[0], got[0], g)


SHARED = dict(num_segments=1024, chunk_rows=256, chunk_segments=256)


def _run_chunked(jt, pt, by, ops, engine, col="v", jit=False, **kw):
    """The JAX function and the port's, each with ``engine``."""
    jaggs, paggs = _aggs(ops, col)
    kw = {**SHARED, **kw}

    def jax_fn(t):
        return jgp.groupby_aggregate_packed_chunked(t, by, jaggs,
                                                    engine=engine, **kw)

    want = (jax.jit(jax_fn) if jit else jax_fn)(jt)
    got = gp.groupby_aggregate_packed_chunked(pt, by, paggs, engine=engine,
                                              **kw)
    return want, got


def _values(rng, n):
    return rng.integers(-1000, 1000, n), jdt.INT64


# ---------------------------------------------------------------------------
# (ii) the chunked packed groupby under each engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1023, 1024, 1025, 2000])
@pytest.mark.parametrize("engine", ENGINES)
def test_packed_chunked_matches_jax(engine, n):
    rng = np.random.default_rng(n)
    jt, pt = _tables({"k": (rng.integers(-300, 300, n), jdt.INT64),
                      "v": _values(rng, n)})
    # 1025 rows is the shared eager shape; the other counts run the JAX
    # reference under jax.jit, one compile each instead of one per op
    want, got = _run_chunked(jt, pt, ["k"], OPS7, engine, jit=n != 1025)
    assert not bool(want[3])
    _same_chunked(want, got)


def _pool_keys(rng, n, lo, hi, dtype, size=60):
    """``n`` keys drawn from ``size`` values of [lo, hi], both ends in."""
    pool = rng.integers(lo, hi, size, dtype=dtype, endpoint=True)
    pool[:2] = [lo, hi]
    return pool[rng.integers(0, size, n)]


# key kind -> (numpy keys, JAX dtype). The 64-bit pools keep their span
# inside the 53 bits the shared shape leaves for the key; the *_top_bit
# ones reach past 2^52, which sets the top bit of the phase-2 word and of
# the flat word (the logical-shift hazard of the port's int64 words).
KEYS = {
    "int8": lambda r, n: (_pool_keys(r, n, -128, 127, np.int8), jdt.INT8),
    "int32": lambda r, n: (_pool_keys(r, n, -2**31, 2**31 - 1, np.int32),
                           jdt.INT32),
    "int64": lambda r, n: (_pool_keys(r, n, -2**49, 2**49, np.int64),
                           jdt.INT64),
    "uint32": lambda r, n: (_pool_keys(r, n, 0, 2**32 - 1, np.uint32),
                            jdt.UINT32),
    "uint64": lambda r, n: (_pool_keys(r, n, 2**63 - 2**49, 2**63 + 2**49,
                                       np.uint64), jdt.UINT64),
    "bool8": lambda r, n: (r.random(n) > 0.5, jdt.BOOL8),
    "timestamp_days": lambda r, n: (
        _pool_keys(r, n, -2**31, 2**31 - 1, np.int32),
        jdt.DType(jdt.TypeId.TIMESTAMP_DAYS)),
    "decimal64": lambda r, n: (_pool_keys(r, n, -10**15, 10**12, np.int64),
                               jdt.decimal64(-2)),
    "int64_top_bit": lambda r, n: (
        _pool_keys(r, n, -2**51, 2**51 + 2**50, np.int64), jdt.INT64),
    "uint64_top_bit": lambda r, n: (
        _pool_keys(r, n, 2**63 - 2**52, 2**63 + 2**50, np.uint64),
        jdt.UINT64),
}


@pytest.mark.parametrize("kind", sorted(KEYS))
@pytest.mark.parametrize("engine", ENGINES)
def test_packed_chunked_key_types_match_jax(engine, kind):
    n = 1025
    rng = np.random.default_rng(sorted(KEYS).index(kind))
    jt, pt = _tables({"k": KEYS[kind](rng, n), "v": _values(rng, n)})
    want, got = _run_chunked(jt, pt, ["k"], OPS7, engine)
    # the u32 word of pallas32 cannot hold these spans: flagged, never
    # silently wrong, and still the same bytes as the JAX engine
    wide = kind.startswith(("int32", "uint32", "int64", "uint64",
                            "timestamp", "decimal"))
    assert bool(want[3]) == (engine == "pallas32" and wide)
    _same_chunked(want, got)


TOP_BIT_PHASE1 = {
    "int64": (-2**54, 2**55 - 2**53, np.int64, jdt.INT64),
    "uint64": (2**63 - 2**55, 2**63 + 2**55 - 2**10, np.uint64, jdt.UINT64),
}


@pytest.mark.parametrize("kind", sorted(TOP_BIT_PHASE1))
@pytest.mark.parametrize("engine", ENGINES)
def test_packed_chunked_top_bit_of_the_phase1_word(engine, kind):
    """Two chunks with at most 63 groups each: the phase-2 word has 7
    iota bits, one fewer than phase 1's 8, so a key span past 2^55 sets
    the phase-1 word's top bit with no overflow, and an arithmetic shift
    would leak into the phase-2 word."""
    n = 512
    lo, hi, dtype, d = TOP_BIT_PHASE1[kind]
    rng = np.random.default_rng(len(kind))
    keys = _pool_keys(rng, n, lo, hi, dtype, size=40)
    jt, pt = _tables({"k": (keys, d), "v": _values(rng, n)})
    want, got = _run_chunked(jt, pt, ["k"], OPS7, engine, jit=True,
                             num_segments=128, chunk_segments=63)
    assert bool(want[3]) == (engine == "pallas32")
    _same_chunked(want, got)


def _two_keys(rng, n, a_hi):
    return {"a": (rng.integers(-4, a_hi, n), jdt.INT64),
            "b": (rng.integers(0, 6, n).astype(np.int32), jdt.INT32),
            "v": _values(rng, n)}


@pytest.mark.parametrize("field_bits,a_hi,overflow",
                         [((3, 3), 4, False), ((4, 2), 300, True)],
                         ids=["fits", "field_overflow"])
@pytest.mark.parametrize("engine", ENGINES)
def test_packed_chunked_two_keys_match_jax(engine, field_bits, a_hi,
                                           overflow):
    n = 1025
    rng = np.random.default_rng(a_hi)
    jt, pt = _tables(_two_keys(rng, n, a_hi))
    want, got = _run_chunked(jt, pt, ["a", "b"], OPS7, engine,
                             field_bits=field_bits)
    assert bool(want[3]) == overflow
    _same_chunked(want, got)


def _wide_span(n):
    # a key span of about 2^32: past the u32 word's fit at 8 iota bits
    return (np.arange(n, dtype=np.int64) % 1000) * (1 << 22)


def _all_ones_word(n):
    # the row at iota 255 packs to exactly 0xFFFFFFFF (rel << 8 | 255)
    k = np.zeros(n, np.int64)
    k[255] = (1 << 24) - 1
    return k


@pytest.mark.parametrize("keys", [_wide_span, _all_ones_word],
                         ids=["wide_span", "all_ones_word"])
@pytest.mark.parametrize("engine", ENGINES)
def test_packed_chunked_u32_fit_is_flagged(engine, keys):
    """The two overflow cases of the JAX package's own tests: the u32
    narrowing of pallas32 would corrupt words, so ``overflow`` fires;
    the other engines hold these keys exactly."""
    n = 1025
    rng = np.random.default_rng(7)
    jt, pt = _tables({"k": (keys(n), jdt.INT64), "v": _values(rng, n)})
    want, got = _run_chunked(jt, pt, ["k"], OPS7, engine)
    assert bool(want[3]) == (engine == "pallas32")
    _same_chunked(want, got)


@pytest.mark.parametrize("engine", ENGINES)
def test_packed_chunked_float_values_match_jax(engine):
    n = 2000
    rng = np.random.default_rng(3)
    f = rng.standard_normal(n)
    f[0] = -0.0
    jt, pt = _tables({"k": (rng.integers(0, 50, n), jdt.INT64),
                      "f": (f, jdt.FLOAT64)})
    want, got = _run_chunked(jt, pt, ["k"], OPS7, engine, col="f", jit=True)
    _same_chunked(want, got)


def test_packed_chunked_rejects_an_unknown_engine():
    jt, pt = _tables({"k": (np.zeros(8, np.int64), jdt.INT64),
                      "v": (np.zeros(8, np.int64), jdt.INT64)})
    kw = dict(num_segments=8, chunk_rows=8, chunk_segments=8, engine="cuda")
    with pytest.raises(ValueError, match="engine"):
        jgp.groupby_aggregate_packed_chunked(jt, ["k"], _aggs(["sum"])[0],
                                             **kw)
    with pytest.raises(ValueError, match="engine"):
        gp.groupby_aggregate_packed_chunked(pt, ["k"], _aggs(["sum"])[1],
                                            **kw)


# ---------------------------------------------------------------------------
# (iii) the eager router and the flat arm
# ---------------------------------------------------------------------------


def _router_case(name):
    rng = np.random.default_rng(len(name))
    if name == "two_level":
        n = 4096
        cols = {"k": (rng.integers(0, 64, n), jdt.INT64),
                "v": _values(rng, n)}
        return cols, ["k"], OPS7, "v"
    if name == "flat_arm":  # 5000 key values over 2000 rows: too spread
        n = 2000
        cols = {"k": (rng.integers(0, 5000, n), jdt.INT64),
                "v": _values(rng, n)}
        return cols, ["k"], OPS7, "v"
    if name == "two_keys":
        return _two_keys(rng, 4000, 4), ["a", "b"], ["sum", "count", "min"], "v"
    if name == "float_values":
        n = 4000
        cols = {"k": (rng.integers(0, 50, n), jdt.INT64),
                "f": (rng.standard_normal(n), jdt.FLOAT64)}
        return cols, ["k"], ["sum", "min", "max", "mean"], "f"
    if name == "declines_small":  # n <= chunk_rows
        cols = {"k": (rng.integers(0, 9, 200), jdt.INT64),
                "v": _values(rng, 200)}
        return cols, ["k"], ["sum"], "v"
    assert name == "declines_wide"  # span past what packing leaves
    cols = {"k": (rng.integers(0, 1 << 62, 1000), jdt.INT64),
            "v": _values(rng, 1000)}
    return cols, ["k"], ["sum"], "v"


@pytest.mark.parametrize("name", ["two_level", "flat_arm", "two_keys",
                                  "float_values", "declines_small",
                                  "declines_wide"])
def test_packed_router_matches_jax(name):
    cols, by, ops, col = _router_case(name)
    jt, pt = _tables(cols)
    jaggs, paggs = _aggs(ops, col)
    want = jgp.groupby_aggregate_packed(jt, by, jaggs, chunk_rows=256)
    got = gp.groupby_aggregate_packed(pt, by, paggs, chunk_rows=256)
    if name.startswith("declines"):
        assert want is None and got is None
        return
    assert want is not None and got is not None
    assert got.row_count == want.row_count
    _same_rows(want, got, want.row_count)


@pytest.mark.parametrize("values_via", ["sort", "gather"])
def test_packed_flat_matches_jax(values_via):
    """One word over all 1025 rows (11 iota bits): a key span past 2^52
    sets its top bit."""
    n = 1025
    rng = np.random.default_rng(11)
    jt, pt = _tables({"k": KEYS["int64_top_bit"](rng, n),
                      "v": _values(rng, n)})
    jaggs, paggs = _aggs(OPS7)
    want = jax.jit(lambda t: jgp.groupby_aggregate_packed_flat(
        t, ["k"], jaggs, 64, values_via=values_via))(jt)
    got = gp.groupby_aggregate_packed_flat(pt, ["k"], paggs, 64,
                                           values_via=values_via)
    assert not bool(want[2])
    assert (int(got[1]), bool(got[2])) == (int(want[1]), bool(want[2]))
    _same_rows(want[0], got[0], int(want[1]))


def test_packed_flat_flags_capacity_and_rejects_values_via():
    k = np.arange(100, dtype=np.int64)
    jt, pt = _tables({"k": (k, jdt.INT64), "v": (k, jdt.INT64)})
    jaggs, paggs = _aggs(["sum"])
    want = jgp.groupby_aggregate_packed_flat(jt, ["k"], jaggs, 10)
    got = gp.groupby_aggregate_packed_flat(pt, ["k"], paggs, 10)
    assert bool(want[2]) and bool(got[2])
    assert int(got[1]) == int(want[1]) == 100
    with pytest.raises(ValueError, match="values_via"):
        gp.groupby_aggregate_packed_flat(pt, ["k"], paggs, 10,
                                         values_via="scatter")
