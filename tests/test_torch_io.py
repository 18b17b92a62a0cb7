"""The port's IO layer (``spark_rapids_jni_tpu_torch.io``) against the JAX
package's, on the CPU: every format's ``read_*``/``scan_*``/``write_*``.

pyarrow writes each file once under a module-scoped temporary directory
(1,025 rows made with numpy from a seed, row groups of 100); both
packages read the same file with the same arguments and their tables
are compared byte for byte (data, validity, string lengths, names, row
count; tolerance 0). Covered: footer pruning (the batches a scan
yields), the exact device residual for every predicate op, projections
(a predicate on an unprojected column too), a directory of part files,
``row_groups_per_batch`` > 1, an all-pruned file, ``prefetch`` 2 against
the serial scan, an early exit after which the worker thread is gone,
and the producer's error raised at the consumer. Writers: the port's
files read back equal to the JAX package's. ``import
spark_rapids_jni_tpu_torch`` and Avro work with pyarrow hidden.
"""

import dataclasses
import decimal
import json as _json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.csv as pa_csv
import pyarrow.orc as pa_orc
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import interop as jinterop
from spark_rapids_jni_tpu import io as jio
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.io import predicates as jpreds
from spark_rapids_jni_tpu_torch import Table, interop
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import io as pio
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.io import parquet as pparquet
from spark_rapids_jni_tpu_torch.io import predicates as ppreds

N = 1025
GROUP = 100
CPU = {"device": "cpu"}


def _live_tables() -> tuple:
    from spark_rapids_jni_tpu import runtime_bridge as jrb

    return len(rb._RESIDENT), jrb.resident_table_count()


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves both resident registries as it found them (F6)."""
    before = _live_tables()
    yield
    assert _live_tables() == before


def _arrow_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    m = rng.random(n) < 0.1
    words = ["", "a", "bb", "ccc", "añ", "zzzz"]
    return pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),  # sorted: prunable
        "i32": pa.array(rng.integers(-100, 100, n).astype(np.int32), mask=m),
        "i8": pa.array(rng.integers(-100, 100, n).astype(np.int8)),
        "f64": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.05),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "b": pa.array(rng.random(n) > 0.5, mask=m),
        "s": pa.array([None if m[i] else words[i % 6] + str(i % 9)
                       for i in range(n)]),
        "dec": pa.array([None if m[i] else decimal.Decimal(int(v)).scaleb(-2)
                         for i, v in enumerate(rng.integers(-10**6, 10**6, n))],
                        pa.decimal128(9, 2)),
        "date": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                         mask=m).cast(pa.date32()),
    })


def _simple_table(n: int, seed: int) -> pa.Table:
    """The types every text format reads back as they were written."""
    t = _arrow_table(n, seed)
    return t.select(["k", "i32", "f64", "b", "s"])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("io")
    tbl = _arrow_table(N, 0)
    out = {"dir": d, "tbl": tbl}
    out["parquet"] = str(d / "t.parquet")
    pq.write_table(tbl, out["parquet"], row_group_size=GROUP)
    parts = d / "parts"
    parts.mkdir()
    for i in range(3):
        pq.write_table(_arrow_table(300 + i, i + 1),
                       str(parts / f"part-{i:05d}.parquet"),
                       row_group_size=GROUP)
    out["parts"] = sorted(str(parts / f) for f in os.listdir(parts))
    simple = _simple_table(N, 0)
    out["simple"] = simple
    out["orc"] = str(d / "t.orc")
    pa_orc.write_table(tbl.drop_columns(["date"]), out["orc"],
                       stripe_size=64 * 1024)
    out["csv"] = str(d / "t.csv")
    pa_csv.write_csv(simple, out["csv"])
    out["json"] = str(d / "t.jsonl")
    with open(out["json"], "w") as f:
        for row in simple.to_pylist():
            f.write(_json.dumps(row) + "\n")
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


def _same_tables(js, ps, what=""):
    js, ps = list(js), list(ps)
    assert len(js) == len(ps), what
    for i, (a, b) in enumerate(zip(js, ps)):
        _same_table(a, b, f"{what} batch {i}")


# every leaf op, on integer, float, string, decimal and date columns
PREDICATES = {
    "eq": [("i32", "==", 7)],
    "eq_alias": [("i32", "=", 7)],
    "ne": [("i8", "!=", 3)],
    "lt_k": [("k", "<", 333)],
    "range_k": [("k", ">=", 150), ("k", "<", 180)],
    "le_f": [("f64", "<=", -0.5)],
    "gt_f32": [("f32", ">", 1.0)],
    "ge_s": [("s", ">=", "bb")],
    "eq_s": [("s", "==", "a1")],
    "in": [("i8", "in", (1, 2, 3))],
    "in_s": [("s", "in", ("a1", "zzzz4", "nope"))],
    "not_in": [("i32", "not in", (0, 5))],
    "empty_in": [("i32", "in", ())],
    "empty_not_in": [("i32", "not in", ())],
    "is_null": [("s", "is_null", None)],
    "is_not_null": [("dec", "is_not_null", None)],
    "dec_gt": [("dec", ">", 12.5)],
    "date_lt": [("date", "<", 9000)],
    "dnf_or": [[("i8", ">", 50)], [("i8", "<", -50)]],
}


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_read_parquet_filters(data, name):
    f = PREDICATES[name]
    _same_table(jio.read_parquet(data["parquet"], filters=f),
                pio.read_parquet(data["parquet"], filters=f, **CPU), name)


def test_predicate_objects_and_projection(data):
    p = data["parquet"]
    cases = [
        (["k", "s"], ppreds.col("i8") > 0,
         jpreds.col("i8") > 0),
        (["f64"], (ppreds.col("k") < 100) | ppreds.col("s").is_null(),
         (jpreds.col("k") < 100) | jpreds.col("s").is_null()),
        (None, ppreds.and_(ppreds.col("i32").isin([1, 2]),
                           ppreds.col("b") == True),  # noqa: E712
         jpreds.and_(jpreds.col("i32").isin([1, 2]),
                     jpreds.col("b") == True)),  # noqa: E712
        (["date", "dec"], ppreds.col("i8").not_in([0]),
         jpreds.col("i8").not_in([0])),
    ]
    for cols, pp, jp in cases:
        _same_table(jio.read_parquet(p, columns=cols, filters=jp),
                    pio.read_parquet(p, columns=cols, filters=pp, **CPU))
    cols, pp, jp = cases[1]  # its predicate prunes to one row group
    _same_tables(jio.scan_parquet(p, columns=cols, filters=jp),
                 pio.scan_parquet(p, columns=cols, filters=pp, **CPU))
    out = pio.read_parquet(p, columns=["k"], filters=ppreds.col("i8") > 0,
                           **CPU)
    assert list(out.names) == ["k"]


def test_pruning_is_observable(data):
    p = data["parquet"]
    pred = [("k", ">=", 150), ("k", "<", 180)]
    for dd in (False, True):
        got = list(pio.scan_parquet(p, filters=pred, exact_filter=False,
                                    device_decode=dd, **CPU))
        want = list(jio.scan_parquet(p, filters=pred, exact_filter=False,
                                     device_decode=dd))
        assert [t.row_count for t in got] == [100]  # only [100, 200)
        _same_tables(want, got)
    exact = pio.read_parquet(p, filters=pred, **CPU)
    k = exact["k"].to_numpy()
    assert k.min() == 150 and k.max() == 179 and len(k) == 30
    groups = pparquet._surviving_row_groups(pq.ParquetFile(p),
                                            ppreds.from_dnf(pred))
    assert groups == [1]


def test_parquet_metadata(data):
    jm = jio.parquet_metadata(data["parquet"])
    pm = pio.parquet_metadata(data["parquet"])
    assert {k: v for k, v in jm.items() if k != "row_groups"} == {
        k: v for k, v in pm.items() if k != "row_groups"}
    assert len(jm["row_groups"]) == len(pm["row_groups"]) == 11
    for a, b in zip(jm["row_groups"], pm["row_groups"]):
        assert a["num_rows"] == b["num_rows"]
        assert ({k: dataclasses.asdict(v) for k, v in a["stats"].items()}
                == {k: dataclasses.asdict(v) for k, v in b["stats"].items()})


@pytest.mark.parametrize("dd", [False, True])
def test_scan_parquet_batches(data, dd):
    p = data["parquet"]
    # the device decode's batches of one row group: test_torch_parquet_device
    for rgpb in ((1, 3) if not dd else (3,)):
        kw = dict(row_groups_per_batch=rgpb, device_decode=dd)
        js = list(jio.scan_parquet(p, **kw))
        ps = list(pio.scan_parquet(p, **kw, **CPU))
        assert len(ps) == (11 if rgpb == 1 else 4)
        _same_tables(js, ps, f"rgpb={rgpb}")


def test_part_files(data):
    parts = data["parts"]
    _same_table(jio.read_parquet(parts), pio.read_parquet(parts, **CPU))
    kw = dict(columns=["s", "k"], filters=[("i8", "<", 0)])
    _same_table(jio.read_parquet(parts, **kw),
                pio.read_parquet(parts, **kw, **CPU))
    _same_tables(jio.scan_parquet(parts, device_decode=True, **kw),
                 pio.scan_parquet(parts, device_decode=True, **kw, **CPU))
    import pathlib

    paths = [pathlib.Path(x) for x in parts]
    assert pio.read_parquet(paths, **CPU).row_count == 903


def test_all_pruned(data):
    p = data["parquet"]
    f = [("k", ">", 10**9)]
    j, t = jio.read_parquet(p, filters=f), pio.read_parquet(p, filters=f, **CPU)
    assert t.row_count == 0
    _same_table(j, t)
    assert list(pio.scan_parquet(p, filters=f, device_decode=True, **CPU)) == []


def test_prefetch_matches_serial(data):
    p = data["parquet"]
    for dd in (False, True):
        serial = list(pio.scan_parquet(p, device_decode=dd, **CPU))
        pre = list(pio.scan_parquet(p, prefetch=2, device_decode=dd, **CPU))
        _same_tables(jio.scan_parquet(p, device_decode=dd), pre)
        _same_tables(jio.scan_parquet(p, device_decode=dd), serial)


def _workers() -> list:
    return [t for t in threading.enumerate() if t.name == "scan-prefetch"]


def _wait_gone(timeout_s: float = 10.0) -> bool:
    end = time.monotonic() + timeout_s
    while _workers() and time.monotonic() < end:
        time.sleep(0.02)
    return not _workers()


def test_prefetch_early_exit_ends_the_worker(data):
    assert _wait_gone()
    it = pio.scan_parquet(data["parquet"], prefetch=2, **CPU)
    first = next(it)
    assert first.row_count == GROUP
    assert _workers()  # the producer runs ahead
    it.close()  # LIMIT: the consumer stops early
    assert _wait_gone()

    def consume():
        for _ in pio.scan_parquet(data["parquet"], prefetch=2, **CPU):
            raise KeyError("consumer failed")

    with pytest.raises(KeyError):
        consume()
    assert _wait_gone()


def test_prefetch_propagates_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        list(pio.scan_parquet(str(tmp_path / "missing.parquet"), prefetch=2,
                              **CPU))

    def gen():
        yield 1
        raise ValueError("producer failed")

    it = pparquet._prefetch_iter(gen(), 2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)
    assert _wait_gone()


def test_write_parquet(data, tmp_path):
    tbl = data["tbl"]
    jt = jinterop.table_from_arrow(tbl)
    pt = interop.table_from_arrow(tbl, **CPU)
    jp, pp = str(tmp_path / "j.parquet"), str(tmp_path / "p.parquet")
    jio.write_parquet(jt, jp, row_group_size=300)
    pio.write_parquet(pt, pp, row_group_size=300)
    a, b = pq.read_table(jp), pq.read_table(pp)
    assert a.schema == b.schema
    assert pq.ParquetFile(pp).metadata.num_row_groups == 4
    _same_table(jio.read_parquet(jp), pio.read_parquet(pp, **CPU))


# ---------------------------------------------------------------------------
# ORC, CSV, JSON, Arrow IPC, Avro
# ---------------------------------------------------------------------------


def test_orc(data, tmp_path):
    p = data["orc"]
    kw = dict(columns=["k", "s", "dec"], filters=[("i32", "<", 0)])
    _same_table(jio.read_orc(p), pio.read_orc(p, **CPU))
    _same_table(jio.read_orc(p, **kw), pio.read_orc(p, **kw, **CPU))
    serial = list(pio.scan_orc(p, **kw, **CPU))
    assert len(serial) > 1
    _same_tables(jio.scan_orc(p, **kw), serial)
    _same_tables(jio.scan_orc(p, **kw), pio.scan_orc(p, prefetch=2, **kw,
                                                     **CPU))
    pt = pio.read_orc(p, **CPU)
    w = str(tmp_path / "w.orc")
    pio.write_orc(pt, w)
    _same_table(jio.read_orc(p), pio.read_orc(w, **CPU))


def test_csv(data, tmp_path):
    p = data["csv"]
    _same_table(jio.read_csv(p), pio.read_csv(p, **CPU))
    kw = dict(columns=["s", "f64"], filters=[("k", "<", 500)])
    _same_table(jio.read_csv(p, **kw), pio.read_csv(p, **kw, **CPU))
    names = ["a", "b", "c", "d", "e"]
    _same_table(jio.read_csv(p, column_names=names),
                pio.read_csv(p, column_names=names, **CPU))
    pins = {"i32": pa.float64()}
    scan_kw = dict(block_size=1 << 13, dtypes=pins,
                   filters=[("i32", ">", 0)])
    serial = list(pio.scan_csv(p, columns=["k"], **scan_kw, **CPU))
    assert len(serial) > 1
    _same_tables(jio.scan_csv(p, columns=["k"], **scan_kw), serial)
    _same_tables(serial, pio.scan_csv(p, columns=["k"], prefetch=2,
                                      **scan_kw, **CPU))
    for header in (True, False):
        jp, pp = str(tmp_path / f"j{header}.csv"), str(tmp_path / f"p{header}.csv")
        jio.write_csv(jio.read_csv(p), jp, header=header, delimiter="|")
        pio.write_csv(pio.read_csv(p, **CPU), pp, header=header, delimiter="|")
        with open(jp, "rb") as a, open(pp, "rb") as b:
            assert a.read() == b.read()


def test_json(data, tmp_path):
    p = data["json"]
    _same_table(jio.read_json(p), pio.read_json(p, **CPU))
    kw = dict(columns=["s"], filters=[("k", ">=", 1000)])
    _same_table(jio.read_json(p, **kw), pio.read_json(p, **kw, **CPU))
    pins = {"f64": pa.float64(), "i32": pa.int32()}
    _same_table(jio.read_json(p, dtypes=pins), pio.read_json(p, dtypes=pins,
                                                             **CPU))
    serial = list(pio.scan_json(p, block_rows=300, **CPU))
    assert len(serial) == 4
    _same_tables(jio.scan_json(p, block_rows=300), serial)
    _same_tables(jio.scan_json(p, block_rows=300, **kw),
                 pio.scan_json(p, block_rows=300, prefetch=2, **kw, **CPU))
    jp, pp = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    jt = JTable.from_pydict({"f": [1.0, float("nan"), float("inf"), None],
                             "s": ["a", None, "añ", ""]})
    pt = Table.from_pydict({"f": [1.0, float("nan"), float("inf"), None],
                            "s": ["a", None, "añ", ""]}, **CPU)
    jio.write_json(jt, jp)
    pio.write_json(pt, pp)
    with open(jp, "rb") as a, open(pp, "rb") as b:
        assert a.read() == b.read()
    assert pio.read_json(pp, **CPU)["f"].to_pylist() == [1.0, None, None, None]


def test_scan_json_sparse_and_blank_blocks(tmp_path):
    p = str(tmp_path / "sparse.jsonl")
    with open(p, "w") as f:
        for i in range(900):
            f.write('{"k": %d}\n' % i if i < 500
                    else '{"k": %d, "x": %d}\n' % (i, 2 * i))
        f.write("\n" * 120)
        for i in range(900, 920):
            f.write('{"k": %d, "x": 1}\n' % i)
    kw = dict(columns=["x"], block_rows=256, dtypes={"x": pa.int64()})
    _same_tables(jio.scan_json(p, **kw), pio.scan_json(p, **kw, **CPU))
    got = [v for b in pio.scan_json(p, block_rows=50, **CPU)
           for v in b["k"].to_pylist()]
    assert got == list(range(920))
    with pytest.raises(ValueError) as je:
        list(jio.scan_json(p, columns=["zzz"], block_rows=50))
    with pytest.raises(ValueError) as pe:
        list(pio.scan_json(p, columns=["zzz"], block_rows=50, **CPU))
    assert str(je.value) == str(pe.value)


def test_arrow_ipc(data, tmp_path):
    tbl = data["tbl"]
    jp, pp = str(tmp_path / "j.arrow"), str(tmp_path / "p.arrow")
    jio.write_arrow_ipc(jinterop.table_from_arrow(tbl), jp)
    pio.write_arrow_ipc(interop.table_from_arrow(tbl, **CPU), pp)
    import pyarrow.ipc as pa_ipc

    with pa_ipc.open_file(jp) as a, pa_ipc.open_file(pp) as b:
        assert a.read_all().schema == b.read_all().schema
    _same_table(jio.read_arrow_ipc(jp), pio.read_arrow_ipc(pp, **CPU))
    kw = dict(columns=["s", "k"], pad_widths={"s": 16})
    _same_table(jio.read_arrow_ipc(jp, **kw), pio.read_arrow_ipc(pp, **kw,
                                                                  **CPU))


def _avro_tables(n: int, seed: int):
    rng = np.random.default_rng(seed)
    m = rng.random(n) < 0.1
    cols = {
        "i": [None if m[j] else int(v) for j, v in
              enumerate(rng.integers(-2**40, 2**40, n))],
        "i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
        "f": [None if m[j] else float(v) for j, v in
              enumerate(rng.standard_normal(n))],
        "f32": rng.standard_normal(n).astype(np.float32),
        "b": [None if m[j] else bool(v) for j, v in
              enumerate(rng.random(n) > 0.5)],
        "s": [None if m[j] else "añ" * (j % 3) + str(j) for j in range(n)],
    }
    return JTable.from_pydict(cols), Table.from_pydict(cols, **CPU)


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro(tmp_path, codec):
    jt, pt = _avro_tables(N, 4)
    jp, pp = str(tmp_path / "j.avro"), str(tmp_path / "p.avro")
    jio.write_avro(jt, jp, codec=codec)
    pio.write_avro(pt, pp, codec=codec)
    _same_table(jio.read_avro(jp), pio.read_avro(pp, **CPU))
    _same_table(jio.read_avro(pp), pio.read_avro(jp, **CPU))
    kw = dict(columns=["s", "f32"], filters=[("i32", "<", 0)],
              pad_widths={"s": 12})
    _same_table(jio.read_avro(jp, **kw), pio.read_avro(jp, **kw, **CPU))
    empty = Table.from_pydict({"k": np.array([], np.int64)}, **CPU)
    ep = str(tmp_path / "e.avro")
    pio.write_avro(empty, ep, codec=codec)
    back = pio.read_avro(ep, **CPU)
    assert back.row_count == 0 and back["k"].dtype == dt.INT64


def test_avro_refusals(tmp_path):
    from spark_rapids_jni_tpu.io import avro as javro
    from spark_rapids_jni_tpu_torch.io import avro as pavro

    schema = {"type": "record", "name": "r",
              "fields": [{"name": "m", "type": {"type": "map",
                                                "values": "long"}}]}
    out = bytearray(pavro._MAGIC)
    meta = {b"avro.schema": _json.dumps(schema).encode()}
    pavro._write_long(out, len(meta))
    for k, v in meta.items():
        pavro._write_long(out, len(k))
        out += k
        pavro._write_long(out, len(v))
        out += v
    pavro._write_long(out, 0)
    out += b"\x00" * 16
    bad = tmp_path / "bad.avro"
    bad.write_bytes(bytes(out))
    with pytest.raises(TypeError) as je:
        javro.read_avro(str(bad))
    with pytest.raises(TypeError) as pe:
        pavro.read_avro(str(bad), **CPU)
    assert str(je.value) == str(pe.value)
    other = tmp_path / "x.avro"
    other.write_bytes(b"PAR1 not avro")
    with pytest.raises(ValueError):
        pavro.read_avro(str(other), **CPU)
    with pytest.raises(ValueError):
        pavro.write_avro(Table.from_pydict({"k": [1]}, **CPU),
                         str(tmp_path / "z.avro"), codec="snappy")


def test_avro_reversed_union(tmp_path):
    from spark_rapids_jni_tpu_torch.io import avro as pavro

    schema = {"type": "record", "name": "r",
              "fields": [{"name": "k", "type": ["long", "null"]}]}
    body = bytearray()
    for branch, v in ((0, 7), (1, None), (0, -3)):
        pavro._write_long(body, branch)
        if v is not None:
            pavro._write_long(body, v)
    sync = b"\x01" * 16
    out = bytearray(pavro._MAGIC)
    meta = {b"avro.schema": _json.dumps(schema).encode()}
    pavro._write_long(out, len(meta))
    for k, v in meta.items():
        pavro._write_long(out, len(k))
        out += k
        pavro._write_long(out, len(v))
        out += v
    pavro._write_long(out, 0)
    out += sync
    pavro._write_long(out, 3)
    pavro._write_long(out, len(body))
    out += bytes(body) + sync
    p = tmp_path / "rev.avro"
    p.write_bytes(bytes(out))
    _same_table(jio.read_avro(str(p)), pio.read_avro(str(p), **CPU))
    assert pio.read_avro(str(p), **CPU)["k"].to_pylist() == [7, None, -3]


def test_from_pydict_pad_widths():
    vals = {"s": ["ab", None, "c"], "t": ["x", "yy", "z"]}
    pads = {"s": 32}
    _same_table(JTable.from_pydict(vals, pad_widths=pads),
                Table.from_pydict(vals, pad_widths=pads, **CPU))
    from spark_rapids_jni_tpu import dtype as jdt

    _same_table(JTable.from_pydict({"s": []}, dtypes={"s": jdt.STRING},
                                   pad_widths={"s": 4}),
                Table.from_pydict({"s": []}, dtypes={"s": dt.STRING},
                                  pad_widths={"s": 4}, **CPU))
    with pytest.raises(ValueError):
        Table.from_pydict(vals, pad_widths={"t": 1}, **CPU)


# ---------------------------------------------------------------------------
# predicates and the package surface
# ---------------------------------------------------------------------------


def test_maybe_matches_matches_jax():
    stats = [
        {"x": (10, 20, 0, 100)}, {"x": (7, 7, 0, 9)}, {"x": (None, None, 5, 5)},
        {"x": (1, 5, 2, 10)}, {"x": ("b", "d", 0, 3)}, {},
        {"x": (10, 20, None, None)},
    ]
    leaves = [("==", 15), ("==", 25), ("<", 10), ("<=", 10), (">", 20),
              (">=", 20), ("!=", 7), ("!=", 8), ("in", (1, 2)),
              ("in", (1, 12)), ("not in", (7,)), ("is_null", None),
              ("is_not_null", None), ("==", "c"), ("<", "a")]
    for st in stats:
        js = {k: jpreds.ColumnStats(*v) for k, v in st.items()}
        ps = {k: ppreds.ColumnStats(*v) for k, v in st.items()}
        for op, v in leaves:
            jl, pl = jpreds.Leaf("x", op, v), ppreds.Leaf("x", op, v)
            assert jl.maybe_matches(js) == pl.maybe_matches(ps), (st, op, v)
            for comb in (lambda a, b: a & b, lambda a, b: a | b):
                assert (comb(jl, jpreds.Leaf("x", "==", 15)).maybe_matches(js)
                        == comb(pl, ppreds.Leaf("x", "==", 15))
                        .maybe_matches(ps))
    with pytest.raises(ValueError):
        ppreds.Leaf("x", "~", 1)


def test_from_dnf_and_projection():
    for f in ([("a", "=", 1)], [("a", ">", 1), ("b", "<", 2)],
              [[("a", ">", 1)], [("b", "<>", 2), ("c", "in", (1,))]]):
        j, p = jpreds.from_dnf(f), ppreds.from_dnf(f)
        assert type(j).__name__ == type(p).__name__
        assert j.columns() == p.columns()
        assert repr(j).replace("spark_rapids_jni_tpu.", "") == repr(p).replace(
            "spark_rapids_jni_tpu_torch.", "")
        for cols in (None, ["z"], ["c", "a"]):
            assert (jpreds.projection_columns(j, cols, ["a", "b", "c", "z"])
                    == ppreds.projection_columns(p, cols, ["a", "b", "c", "z"]))
    leaf = ppreds.col("x") > 1
    assert ppreds.from_dnf(leaf) is leaf


def test_readers_build_on_cuda_unless_asked(data, tmp_path):
    """Every reader builds on ``device="cuda"`` by default: without CUDA
    it raises, with no quiet move to the CPU."""
    avro = str(tmp_path / "a.avro")
    pio.write_avro(Table.from_pydict({"k": [1, 2]}, **CPU), avro)
    calls = [lambda: pio.read_parquet(data["parquet"]),
             lambda: list(pio.scan_parquet(data["parquet"], device_decode=True)),
             lambda: pio.read_orc(data["orc"]),
             lambda: list(pio.scan_orc(data["orc"])),
             lambda: pio.read_csv(data["csv"]),
             lambda: list(pio.scan_csv(data["csv"])),
             lambda: pio.read_json(data["json"]),
             lambda: list(pio.scan_json(data["json"])),
             lambda: pio.read_avro(avro),
             lambda: interop.table_from_arrow(data["tbl"])]
    for call in calls:
        if torch.cuda.is_available():
            assert call() is not None
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_io_exports_match_jax():
    assert pio.__all__ == jio.__all__
    for name in jio.__all__:
        assert callable(getattr(pio, name)) or name == "Predicate"


def test_import_without_pyarrow(tmp_path):
    """The package and Avro work with pyarrow hidden; the Arrow readers
    raise ImportError when called."""
    code = f"""
import sys
sys.modules["pyarrow"] = None
import spark_rapids_jni_tpu_torch as srt
from spark_rapids_jni_tpu_torch import io, interop, struct
t = srt.Table.from_pydict({{"k": [1, None, 3], "s": ["a", "b", None]}},
                          device="cpu")
io.write_avro(t, {str(tmp_path / "a.avro")!r})
back = io.read_avro({str(tmp_path / "a.avro")!r}, device="cpu",
                    filters=[("k", ">", 1)])
assert back["k"].to_pylist() == [3], back["k"].to_pylist()
for fn in (lambda: io.read_parquet("x.parquet", device="cpu"),
           lambda: io.read_csv("x.csv", device="cpu"),
           lambda: interop.table_to_arrow(t)):
    try:
        fn()
    except ImportError:
        pass
    else:
        raise AssertionError("no ImportError")
assert "jax" not in sys.modules
print("ok")
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(__file__)),
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
