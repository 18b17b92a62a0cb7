"""The port's device page decode (``io/parquet_device.py``) against the
JAX package's, on the CPU.

pyarrow writes the files under a module-scoped temporary directory at
1023, 1024 and 1025 rows in row groups of 400: PLAIN and dictionary
pages, the dictionary -> PLAIN switch inside one chunk (a small
``dictionary_pagesize_limit``), many pages a chunk (a small
``data_page_size``), v2 data pages; snappy, zstd and uncompressed; 0,
some and all nulls, a non-nullable field, a one-value dictionary (bit
width 0); INT32/INT64/FLOAT/DOUBLE with NaN payloads, -0.0 and
subnormals, DATE32, decimals stored as integers, the narrowed integer
types, and BYTE_ARRAY and BOOLEAN columns. For every row group both
packages' ``decode_row_group`` give the same fallback list and the same
bytes (data, validity), and ``scan_parquet(device_decode=True)`` the
same tables, whose values equal the Arrow path's. The RLE/bit-packed
hybrid parser and expansion run on hand-made streams of bit widths 1-24
(25 declines). The narrowed fallback: a truncated chunk and an
unsupported encoding still go to Arrow with the JAX package's bytes; a
``RuntimeError`` inside the device decode propagates.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu.io import parquet as jparquet
from spark_rapids_jni_tpu.io import parquet_device as jpdev
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.io import parquet as pparquet
from spark_rapids_jni_tpu_torch.io import parquet_device as ppdev

SIZES = (1023, 1024, 1025)
ROW_GROUP = 400


def _live_tables() -> tuple:
    from spark_rapids_jni_tpu import runtime_bridge as jrb

    return len(rb._RESIDENT), jrb.resident_table_count()


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves both resident registries as it found them (F6)."""
    before = _live_tables()
    yield
    assert _live_tables() == before


def _f64_edges() -> np.ndarray:
    bits = np.array([0x7FF8000000000001, 0xFFF8000000000000,
                     0x7FF0000000000001, 0x8000000000000000, 0x1,
                     0x800FFFFFFFFFFFFF, 0x7FF0000000000000], np.uint64)
    return bits.view(np.float64)


def _f32_edges() -> np.ndarray:
    bits = np.array([0x7FC00001, 0xFFC00000, 0x80000000, 0x1, 0x807FFFFF,
                     0xFF800000], np.uint32)
    return bits.view(np.float32)


def _table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls(p):
        return rng.random(n) < p

    f64 = rng.standard_normal(n)
    f64[:7] = _f64_edges()
    f64[7:20] = rng.standard_normal(13) * 1e-310  # subnormals
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[:6] = _f32_edges()
    f32[6:20] = (rng.standard_normal(14) * 1e-40).astype(np.float32)
    dec9 = rng.integers(-10**8, 10**8, n)
    dec18 = rng.integers(-10**17, 10**17, n)
    m = nulls(0.1)
    fields = [
        ("i32", pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                         mask=m), True),
        ("i32_nn", pa.array(rng.integers(-2**31, 2**31, n, np.int64)
                            .astype(np.int32)), False),
        ("i64", pa.array(rng.integers(-2**62, 2**62, n), mask=nulls(0.3)), True),
        ("f32", pa.array(f32, mask=nulls(0.05)), True),
        ("f64", pa.array(f64), True),
        ("f64_nn", pa.array(f64[::-1].copy()), False),
        ("date", pa.array(rng.integers(-30000, 30000, n).astype(np.int32),
                          mask=m).cast(pa.date32()), True),
        ("dec9", pa.array([None if m[i] else
                           __import__("decimal").Decimal(int(v)).scaleb(-2)
                           for i, v in enumerate(dec9)],
                          pa.decimal128(9, 2)), True),
        ("dec18", pa.array([__import__("decimal").Decimal(int(v)).scaleb(-3)
                            for v in dec18], pa.decimal128(18, 3)), True),
        ("i8", pa.array(rng.integers(-128, 128, n).astype(np.int8)), True),
        ("u8", pa.array(rng.integers(0, 256, n).astype(np.uint8)), True),
        ("u16", pa.array(rng.integers(0, 2**16, n).astype(np.uint16)), True),
        ("u32", pa.array(rng.integers(0, 2**32, n).astype(np.uint32),
                         mask=m), True),
        ("u64", pa.array(rng.integers(0, 2**63, n).astype(np.uint64)
                         * np.uint64(2)), True),
        ("ts_us", pa.array(rng.integers(-2**50, 2**50, n),
                           mask=m).cast(pa.timestamp("us")), True),
        ("const", pa.array(np.full(n, 7, np.int32)), True),
        ("allnull", pa.nulls(n, pa.int32()), True),
        ("str", pa.array([None if m[i] else f"s{i % 11}" for i in range(n)]),
         True),
        ("b", pa.array(rng.random(n) > 0.5, mask=m), True),
    ]
    schema = pa.schema([pa.field(name, arr.type, nullable=nullable)
                        for name, arr, nullable in fields])
    return pa.table([arr for _, arr, _ in fields], schema=schema)


VARIANTS = {
    "dict_snappy": dict(compression="snappy"),
    "plain_zstd": dict(compression="zstd", use_dictionary=False),
    "pages_none": dict(compression="none", data_page_size=256),
    "dict_to_plain": dict(compression="snappy",
                          dictionary_pagesize_limit=128),
    "v2": dict(compression="snappy", data_page_version="2.0"),
}
# every column the device path can't take, in the JAX package's order
ARROW_ONLY = {"allnull", "str", "b"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pdev")
    out = {}
    for n in SIZES:
        tbl = _table(n, seed=n)
        for name, kw in VARIANTS.items():
            p = str(d / f"{name}_{n}.parquet")
            pq.write_table(tbl, p, row_group_size=ROW_GROUP,
                           store_decimal_as_integer=True, **kw)
            out[(name, n)] = p
    return out


def _same_column(jc, pc, what=""):
    assert int(jc.dtype.id) == int(pc.dtype.id), what
    assert int(jc.dtype.scale) == int(pc.dtype.scale), what
    a, b = np.asarray(jc.data), pc.data.numpy()
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, what
    assert a.tobytes() == b.tobytes(), what
    for x, y in ((jc.validity, pc.validity), (jc.lengths, pc.lengths)):
        assert (x is None) == (y is None), what
        if x is not None:
            assert np.array_equal(np.asarray(x), y.numpy()), what


def _same_table(jt, pt, what=""):
    assert list(jt.names) == list(pt.names), what
    assert jt.row_count == pt.row_count, what
    for name in jt.names:
        _same_column(jt[name], pt[name], f"{what} {name}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_row_group_matches_jax(files, variant):
    for n in SIZES:
        p = files[(variant, n)]
        pf = pq.ParquetFile(p)
        names = pf.schema_arrow.names
        for rg in range(pf.metadata.num_row_groups):
            jd, jf = jpdev.decode_row_group(p, pf, rg, names)
            pd_, pfb = ppdev.decode_row_group(p, pf, rg, names, "cpu")
            assert pfb == jf, (variant, n, rg)
            if variant == "v2":
                assert pfb == names
            else:
                assert set(pfb) == ARROW_ONLY, (variant, n, rg, pfb)
            assert sorted(pd_) == sorted(jd)
            for name in jd:
                _same_column(jd[name], pd_[name], f"{variant} {n} {rg} {name}")


def _valid_values(c) -> np.ndarray:
    v = (np.ones(c.row_count, bool) if c.validity is None
         else c.validity.numpy())
    return c.data.numpy()[v], v


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_scan_device_decode_matches_jax_and_arrow(files, variant):
    p = files[(variant, 1025)]
    jt = list(jparquet.scan_parquet(p, device_decode=True))
    dev = list(pparquet.scan_parquet(p, device_decode=True, device="cpu"))
    host = list(pparquet.scan_parquet(p, device="cpu"))
    assert len(jt) == len(dev) == len(host) == 3
    for a, b, h in zip(jt, dev, host):
        _same_table(a, b, variant)
        for name in b.names:
            (x, vx), (y, vy) = _valid_values(b[name]), _valid_values(h[name])
            assert np.array_equal(vx, vy), name
            assert x.tobytes() == y.tobytes(), name


def test_nan_payloads_and_subnormals_pass_through(files):
    p = files[("plain_zstd", 1024)]
    t = next(iter(pparquet.scan_parquet(p, device_decode=True, device="cpu",
                                        columns=["f64", "f32"])))
    f64 = t["f64"].data.numpy().view(np.uint64)
    assert np.array_equal(f64[:7], _f64_edges().view(np.uint64))
    assert (np.abs(t["f64"].to_numpy()[7:20]) < 2.3e-308).all()
    assert (t["f64"].to_numpy()[7:20] != 0).all()
    f32 = t["f32"].data.numpy()
    ok = t["f32"].validity.numpy()
    want = _f32_edges().view(np.uint32)
    assert np.array_equal(f32[:6].view(np.uint32)[ok[:6]], want[ok[:6]])


def test_scan_row_groups_per_batch_and_filter(files):
    p = files[("dict_snappy", 1023)]
    kw = dict(columns=["i32", "f64", "dec9"], filters=[("i32", ">", 0)],
              row_groups_per_batch=2, device_decode=True)
    jt = list(jparquet.scan_parquet(p, **kw))
    pt = list(pparquet.scan_parquet(p, device="cpu", **kw))
    assert [t.row_count for t in jt] == [t.row_count for t in pt]
    assert len(pt) == 2
    for a, b in zip(jt, pt):
        _same_table(a, b)


# ---------------------------------------------------------------------------
# the RLE / bit-packed hybrid
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _hybrid(rng, bw: int, n: int):
    """An RLE/bit-packed hybrid stream of about n values (parquet-format
    Encodings.md) and its values, decoded by construction."""
    vals, out = [], bytearray()
    while len(vals) < n:
        if rng.random() < 0.5:
            count = int(rng.integers(1, 40))
            v = int(rng.integers(0, 1 << bw))
            out += _varint(count << 1)
            out += v.to_bytes((bw + 7) // 8, "little")
            vals += [v] * count
        else:
            groups = int(rng.integers(1, 6))
            vs = rng.integers(0, 1 << bw, groups * 8, dtype=np.int64)
            bits = ((vs[:, None] >> np.arange(bw)) & 1).astype(np.uint8)
            out += _varint((groups << 1) | 1)
            out += np.packbits(bits.ravel(), bitorder="little").tobytes()
            vals += vs.tolist()
    return bytes(out), np.asarray(vals, np.int64)


@pytest.mark.parametrize("bw", list(range(1, 26)))
def test_rle_runs_and_expansion(bw):
    rng = np.random.default_rng(bw)
    for n in (1, 7, 257):
        buf, want = _hybrid(rng, bw, n)
        jr = jpdev.parse_rle_runs(buf, bw, n)
        pr = ppdev.parse_rle_runs(buf, bw, n)
        for f in ("out_start", "is_packed", "value", "bit_base"):
            assert np.array_equal(getattr(jr, f), getattr(pr, f)), f
        assert jr.consumed == pr.consumed
        payload = buf[:pr.consumed]
        m = len(want)  # the last packed group ends the payload
        if bw > 24:
            with pytest.raises(jpdev._Unsupported):
                jpdev._device_expand_runs(
                    jr, jnp.asarray(np.frombuffer(payload, np.uint8)), bw, m)
            with pytest.raises(ppdev._Unsupported):
                ppdev._device_expand_runs(
                    pr, torch.frombuffer(bytearray(payload), dtype=torch.uint8),
                    bw, m)
            continue
        got = ppdev._device_expand_runs(
            pr, torch.frombuffer(bytearray(payload), dtype=torch.uint8), bw, m)
        ref = jpdev._device_expand_runs(
            jr, jnp.asarray(np.frombuffer(payload, np.uint8)), bw, m)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(ref))
        assert np.array_equal(got.numpy(), want)


def test_rle_truncated_and_zero_runs_decline():
    for buf in (b"", _varint(8 << 1)[:0], _varint(0) + b"\x01"):
        with pytest.raises(ppdev._Unsupported):
            ppdev.parse_rle_runs(buf, 3, 5)
        with pytest.raises(jpdev._Unsupported):
            jpdev.parse_rle_runs(buf, 3, 5)


def test_defined_count_matches():
    rng = np.random.default_rng(5)
    for n in (1, 9, 1000):
        buf, levels = _hybrid(rng, 1, n)
        runs = ppdev.parse_rle_runs(buf, 1, n)
        got = ppdev._defined_count(runs, buf, n)
        assert got == jpdev._defined_count(jpdev.parse_rle_runs(buf, 1, n),
                                           buf, n)
        assert got == int(levels[:n].sum())


# ---------------------------------------------------------------------------
# the narrowed fallback
# ---------------------------------------------------------------------------


class _Truncated:
    """A file whose reads return half the bytes asked for."""

    def __init__(self, path, mode="rb"):
        self._f = open(path, mode)

    def seek(self, pos):
        return self._f.seek(pos)

    def read(self, size=-1):
        data = self._f.read(size)
        return data[: len(data) // 2]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False


@pytest.mark.parametrize("variant", ["dict_snappy", "pages_none"])
def test_truncated_chunk_falls_back(files, variant, monkeypatch):
    p = files[(variant, 1024)]
    monkeypatch.setattr(jpdev, "open", _Truncated, raising=False)
    monkeypatch.setattr(ppdev, "open", _Truncated, raising=False)
    pf = pq.ParquetFile(p)
    names = pf.schema_arrow.names
    jd, jf = jpdev.decode_row_group(p, pf, 0, names)
    pd_, pfb = ppdev.decode_row_group(p, pf, 0, names, "cpu")
    assert pfb == jf and sorted(pd_) == sorted(jd)
    assert len(pfb) > len(ARROW_ONLY)
    for name in jd:
        _same_column(jd[name], pd_[name], name)
    jt = list(jparquet.scan_parquet(p, device_decode=True))
    pt = list(pparquet.scan_parquet(p, device_decode=True, device="cpu"))
    for a, b in zip(jt, pt):
        _same_table(a, b, variant)


@pytest.mark.parametrize("encoding,column", [
    ("DELTA_BINARY_PACKED", "i64"), ("BYTE_STREAM_SPLIT", "f32"),
])
def test_unsupported_encoding_falls_back(tmp_path, encoding, column):
    tbl = _table(1025, seed=9).select(["i32", column])
    p = str(tmp_path / "enc.parquet")
    pq.write_table(tbl, p, use_dictionary=False,
                   column_encoding={column: encoding},
                   row_group_size=ROW_GROUP)
    pf = pq.ParquetFile(p)
    for rg in range(pf.metadata.num_row_groups):
        jd, jf = jpdev.decode_row_group(p, pf, rg, tbl.column_names)
        pd_, pfb = ppdev.decode_row_group(p, pf, rg, tbl.column_names, "cpu")
        assert pfb == jf == [column]
        _same_column(jd["i32"], pd_["i32"])
    jt = list(jparquet.scan_parquet(p, device_decode=True))
    pt = list(pparquet.scan_parquet(p, device_decode=True, device="cpu"))
    for a, b in zip(jt, pt):
        _same_table(a, b, encoding)


def test_device_error_is_not_swallowed(files, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(ppdev, "_device_expand_runs", boom)
    p = files[("dict_snappy", 1023)]
    pf = pq.ParquetFile(p)
    with pytest.raises(RuntimeError, match="device fault"):
        ppdev.decode_row_group(p, pf, 0, ["i32"], "cpu")
    with pytest.raises(RuntimeError, match="device fault"):
        list(pparquet.scan_parquet(p, device_decode=True, device="cpu"))
    # a short payload is a struct.error, which still falls back
    monkeypatch.undo()
    monkeypatch.setattr(ppdev, "_defined_count", lambda *a: struct.unpack(
        "<i", b"\x00"))
    assert ppdev.decode_row_group(p, pf, 0, ["i32"], "cpu")[1] == ["i32"]
