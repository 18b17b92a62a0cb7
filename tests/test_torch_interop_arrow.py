"""The Arrow half of the port's ``interop.py`` and ``struct.py`` against
the JAX package's, on the CPU.

Both packages take the same pyarrow arrays, made with numpy from a seed:
every type ``_arrow_type_to_dtype`` maps, with nulls, at 0, 1, 1023,
1024 and 1025 rows, sliced (an offset into the buffers) and chunked;
non-UTF-8 binary, DECIMAL32/64/128, LIST<int> and STRUCT. Arrow -> device:
data bytes, validity, lengths and type compared byte for byte (tolerance
0). Device -> Arrow: type, validity and values (floats by their bits).
The refusals (decimal256, unmapped types, nulls inside lists, a pad
width too small, decimals past their precision) raise the same errors.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_jni_tpu import interop as jinterop
from spark_rapids_jni_tpu import struct as jstruct
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch import struct as pstruct

SIZES = (0, 1, 1023, 1024, 1025)


def _live_tables() -> tuple:
    from spark_rapids_jni_tpu import runtime_bridge as jrb

    return len(rb._RESIDENT), jrb.resident_table_count()


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves both resident registries as it found them (F6)."""
    before = _live_tables()
    yield
    assert _live_tables() == before


def _nulls(rng, n, p=0.1):
    return rng.random(n) < p


def _dec(unscaled, mask, precision: int, scale: int):
    """Arrow decimal128(precision, scale) of the given unscaled ints."""
    return pa.array([None if mask[i] else decimal.Decimal(int(v)).scaleb(-scale)
                     for i, v in enumerate(unscaled)],
                    pa.decimal128(precision, scale))


def _arrays(rng, n: int) -> dict:
    """One array of every mapped Arrow type, ~10 % null."""
    m = _nulls(rng, n)
    f64 = rng.standard_normal(n)
    f64[: min(n, 5)] = [np.nan, -0.0, 5e-324, np.inf, -1e-310][: min(n, 5)]
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[: min(n, 4)] = np.array([np.nan, -0.0, 1e-45, -np.inf],
                                np.float32)[: min(n, 4)]
    ints = {f"{k}{w}": rng.integers(np.iinfo(f"{k}{w}").min,
                                    np.iinfo(f"{k}{w}").max, n,
                                    dtype=f"{k}{w}", endpoint=True)
            for k in ("int", "uint") for w in (8, 16, 32, 64)}
    out = {name: pa.array(v, mask=m) for name, v in ints.items()}
    words = [None if m[i] else ("ü" * (i % 3) + f"s{i % 17}")
             for i in range(n)]
    raw = [None if m[i] else bytes(rng.integers(0, 256, i % 5, np.uint8))
           for i in range(n)]
    lists = [None if m[i] else list(range(i % 4)) for i in range(n)]
    out.update({
        "f32": pa.array(f32, mask=m),
        "f64": pa.array(f64, mask=m),
        "b": pa.array(rng.random(n) > 0.5, mask=m),
        "date": pa.array(rng.integers(-20000, 20000, n).astype(np.int32),
                         mask=m).cast(pa.date32()),
        **{f"ts_{u}": pa.array(rng.integers(-2**40, 2**40, n),
                               mask=m).cast(pa.timestamp(u))
           for u in ("s", "ms", "us", "ns")},
        **{f"dur_{u}": pa.array(rng.integers(-2**40, 2**40, n),
                                mask=m).cast(pa.duration(u))
           for u in ("s", "ms", "us", "ns")},
        "dec32": _dec(rng.integers(-999_999_999, 999_999_999, n), m, 9, 2),
        "dec64": _dec(rng.integers(-10**17, 10**17, n), m, 18, 4),
        "dec128": _dec([int(v) * 10**20 + i for i, v in enumerate(
            rng.integers(-10**17, 10**17, n))], m, 38, 10),
        "str": pa.array(words, pa.string()),
        "large_str": pa.array(words, pa.large_string()),
        "bin": pa.array(raw, pa.binary()),
        "list_i32": pa.array(lists, pa.list_(pa.int32())),
        "list_u16": pa.array(lists, pa.list_(pa.uint16())),
        "large_list_i64": pa.array(lists, pa.large_list(pa.int64())),
        "list_f32": pa.array([None if v is None else [float(x) / 3 for x in v]
                              for v in lists], pa.list_(pa.float32())),
        "list_b": pa.array([None if v is None else [x % 2 == 0 for x in v]
                            for v in lists], pa.list_(pa.bool_())),
    })
    return out


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(17)
    return {n: _arrays(rng, n) for n in SIZES}


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


def _same_arrow(a, b, what=""):
    assert a.type == b.type, what
    assert len(a) == len(b), what
    assert a.is_valid().equals(b.is_valid()), what
    if pa.types.is_floating(a.type):
        w = {4: np.uint32, 8: np.uint64}[a.type.bit_width // 8]
        x = np.asarray(a.fill_null(0)).view(w)
        y = np.asarray(b.fill_null(0)).view(w)
        assert np.array_equal(x, y), what
    else:
        assert a.equals(b), what


NAMES = sorted(_arrays(np.random.default_rng(0), 3))


@pytest.mark.parametrize("name", NAMES)
def test_column_from_arrow(arrays, name):
    for n in SIZES:
        arr = arrays[n][name]
        cases = {"whole": arr, "sliced": arr.slice(min(3, n)),
                 "chunked": pa.chunked_array(
                     [arr.slice(0, n // 3), arr.slice(n // 3, 2),
                      arr.slice(n // 3 + 2)], type=arr.type)}
        for how, a in cases.items():
            what = f"{name} n={n} {how}"
            _same_column(jinterop.column_from_arrow(a),
                         interop.column_from_arrow(a, device="cpu"), what)


@pytest.mark.parametrize("name", NAMES)
def test_column_to_arrow(arrays, name):
    for n in SIZES:
        arr = arrays[n][name].slice(min(1, n))
        jc = jinterop.column_from_arrow(arr)
        pc = interop.column_from_arrow(arr, device="cpu")
        _same_arrow(jinterop.column_to_arrow(jc), interop.column_to_arrow(pc),
                    f"{name} n={n}")


def test_table_round_trip(arrays):
    tbl = pa.table(arrays[1025])
    jt = jinterop.table_from_arrow(tbl)
    pt = interop.table_from_arrow(tbl, device="cpu")
    assert list(jt.names) == list(pt.names) == tbl.column_names
    for jc, pc, name in zip(jt.columns, pt.columns, tbl.column_names):
        _same_column(jc, pc, name)
    ja, pa_ = jinterop.table_to_arrow(jt), interop.table_to_arrow(pt)
    assert ja.schema == pa_.schema
    for name in tbl.column_names:
        _same_arrow(ja.column(name).combine_chunks(),
                    pa_.column(name).combine_chunks(), name)


def test_unnamed_table_to_arrow():
    from spark_rapids_jni_tpu.column import Table as JTable

    arr = pa.array([1, None, 3], pa.int64())
    jt = JTable([jinterop.column_from_arrow(arr)])
    pt = interop.Table([interop.column_from_arrow(arr, device="cpu")])
    assert (jinterop.table_to_arrow(jt).column_names
            == interop.table_to_arrow(pt).column_names == ["c0"])


def test_pad_widths(arrays):
    tbl = pa.table({"s": arrays[1023]["str"], "l": arrays[1023]["list_i32"]})
    pads = {"s": 12, "l": 6}
    jt = jinterop.table_from_arrow(tbl, pad_widths=pads)
    pt = interop.table_from_arrow(tbl, pad_widths=pads, device="cpu")
    assert pt["s"].pad_width == 12 and pt["l"].data.shape[1] == 6
    for name in pads:
        _same_column(jt[name], pt[name], name)
    for name, small in (("str", 2), ("list_i32", 1)):
        arr = arrays[1023][name]
        with pytest.raises(ValueError) as je:
            jinterop.column_from_arrow(arr, pad_width=small)
        with pytest.raises(ValueError) as pe:
            interop.column_from_arrow(arr, pad_width=small, device="cpu")
        assert str(je.value) == str(pe.value)


def test_non_utf8_binary_round_trip():
    raw = [b"\xff\xfe", None, b"ok", b"\xc3", b"", b"\x80abc"]
    arr = pa.array(raw, pa.binary())
    pc = interop.column_from_arrow(arr, device="cpu")
    _same_column(jinterop.column_from_arrow(arr), pc)
    back = interop.column_to_arrow(pc)
    assert back.type == pa.binary() and back.to_pylist() == raw
    _same_arrow(jinterop.column_to_arrow(jinterop.column_from_arrow(arr)),
                back)
    text = pa.array(["añb", None, ""], pa.binary())
    assert interop.column_to_arrow(
        interop.column_from_arrow(text, device="cpu")).type == pa.string()


@pytest.mark.parametrize("arr,err", [
    (pa.array([1], pa.decimal256(40, 2)), TypeError),
    (pa.array([{"a": 1}]), TypeError),
    (pa.array(["x"]).dictionary_encode(), TypeError),
    (pa.array([[1, None], [2]], pa.list_(pa.int32())), TypeError),
    (pa.array([[1.0]], pa.list_(pa.float64())), TypeError),
    (pa.array([[1]], pa.list_(pa.date32())), TypeError),
], ids=["decimal256", "struct", "dictionary", "null-in-list",
        "list-f64", "list-date"])
def test_refusals_match(arr, err):
    with pytest.raises(err) as je:
        jinterop.column_from_arrow(arr)
    with pytest.raises(err) as pe:
        interop.column_from_arrow(arr, device="cpu")
    assert str(je.value) == str(pe.value)


def test_null_list_rows_hide_their_children():
    # a null list row whose child range holds a null element is fine in
    # both packages: only valid rows are checked
    arr = pa.ListArray.from_arrays(pa.array([0, 1, 3, 3], pa.int32()),
                                   pa.array([5, None, 7], pa.int32()),
                                   mask=pa.array([False, True, False]))
    _same_column(jinterop.column_from_arrow(arr),
                 interop.column_from_arrow(arr, device="cpu"))


@pytest.mark.parametrize("tid,value", [
    ("dec32", 10**9), ("dec32", -(10**9)), ("dec64", 10**18),
    ("dec64", -(10**18)), ("dec128", 10**38), ("dec128", -(10**38)),
])
def test_decimal_precision_limit(tid, value):
    from spark_rapids_jni_tpu import dtype as jdt
    from spark_rapids_jni_tpu.column import Column as JColumn
    from spark_rapids_jni_tpu_torch import Column
    from spark_rapids_jni_tpu_torch import dtype as dt

    vals = [0, value, None]
    if tid == "dec128":
        jc = JColumn.from_decimal128(vals, scale=-2)
        pc = Column.from_decimal128(vals, scale=-2, device="cpu")
    else:
        width = {"dec32": np.int32, "dec64": np.int64}[tid]
        host = np.array([0, value, 0], width)  # the limit fits the width
        mask = np.array([True, True, False])
        jd = (jdt.decimal32 if tid == "dec32" else jdt.decimal64)(-2)
        pd = (dt.decimal32 if tid == "dec32" else dt.decimal64)(-2)
        jc = JColumn.from_numpy(host, mask, jd)
        pc = Column.from_numpy(host, mask, pd, device="cpu")
    with pytest.raises(ValueError) as je:
        jinterop.column_to_arrow(jc)
    with pytest.raises(ValueError) as pe:
        interop.column_to_arrow(pc)
    assert str(je.value) == str(pe.value)
    # one below the limit goes through, equal in both packages
    ok = [0, value - 1 if value > 0 else value + 1, None]
    if tid == "dec128":
        jc = JColumn.from_decimal128(ok, scale=-2)
        pc = Column.from_decimal128(ok, scale=-2, device="cpu")
    else:
        host = np.array([0, ok[1], 0], width)
        jc = JColumn.from_numpy(host, mask, jd)
        pc = Column.from_numpy(host, mask, pd, device="cpu")
    _same_arrow(jinterop.column_to_arrow(jc), interop.column_to_arrow(pc))


def test_validity_bitmaps():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 8, 9, 1025):
        valid = rng.random(n) > 0.3
        bm = interop.pack_validity(valid)
        assert bm == jinterop.pack_validity(valid)
        for off in (0, 1, 5):
            got = interop.unpack_validity(bm + b"\xff", max(n - off, 0), off)
            want = jinterop.unpack_validity(bm + b"\xff", max(n - off, 0), off)
            assert np.array_equal(got, want)
    assert interop.unpack_validity(None, 3) is None


@pytest.mark.parametrize("n", SIZES)
def test_struct_arrow(arrays, n):
    a = arrays[n]
    mask = pa.array(_nulls(np.random.default_rng(n), n, 0.2))
    sa = pa.StructArray.from_arrays(
        [a["int32"], a["f64"], a["str"], a["dec64"]],
        names=["i", "f", "s", "d"], mask=mask)
    for how, arr in (("whole", sa), ("sliced", sa.slice(min(2, n))),
                     ("chunked", pa.chunked_array([sa.slice(0, n // 2),
                                                   sa.slice(n // 2)]))):
        js = jstruct.struct_from_arrow(arr)
        ps = pstruct.struct_from_arrow(arr, device="cpu")
        assert list(js.names) == list(ps.names)
        assert (js.validity is None) == (ps.validity is None), how
        if js.validity is not None:
            assert np.array_equal(np.asarray(js.validity), ps.validity.numpy())
        for jc, pc in zip(js.children, ps.children):
            _same_column(jc, pc, how)
        jo, po = jstruct.struct_to_arrow(js), pstruct.struct_to_arrow(ps)
        assert jo.type == po.type and jo.is_valid().equals(po.is_valid())
        for i in range(jo.type.num_fields):
            _same_arrow(jo.field(i), po.field(i), how)
    with pytest.raises(TypeError):
        pstruct.struct_from_arrow(a["int32"], device="cpu")
