"""The port's TPC-DS Parquet tier (``spark_rapids_jni_tpu_torch.tpcds.
streams``) against the JAX repository's ``benchmarks/tpcds.py`` on the
CPU.

One module-scoped directory holds the port's ``generate_parquet`` at the
smallest scale (1,000 store_sales rows, 250 web_sales rows, 18,000
items, 100 customers; seed 3), another the JAX function's: every file
reads back equal. The three streams (prefetch 2) and ``load_tables``
equal the JAX functions' on the port's files byte for byte (names, row
count, each column's data, validity and string lengths), the pandas
oracles' DataFrames equal, and every verdict of the JAX runner's oracle
comparisons (``chip_smoke.stream_verdicts``) holds for the port.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest
import torch

from benchmarks import tpcds as jt
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch.column import Column
from spark_rapids_jni_tpu_torch.tpcds import streams

import chip_smoke

FILES = ["date_dim", "item", "customer", "store_sales", "web_sales"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(the port's directory, its manifest, the JAX function's
    directory)."""
    root = tmp_path_factory.mktemp("tpcds")
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    manifest = streams.generate_parquet(port_dir, scale=0.0, seed=3)
    jt.generate_parquet(jax_dir, scale=0.0, seed=3)
    return port_dir, manifest, jax_dir


def _host(x):
    if x is None:
        return None
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.shape, a.dtype.itemsize, a.tobytes()


def same_table(jtab, ttab) -> None:
    assert tuple(ttab.names) == tuple(jtab.names)
    assert ttab.row_count == jtab.row_count
    assert [(d.id.value, d.scale) for d in ttab.dtypes()] == [
        (c.dtype.id.value, c.dtype.scale) for c in jtab.columns]
    for name, a, b in zip(jtab.names, jtab.columns, ttab.columns):
        for part in ("data", "validity", "lengths"):
            assert _host(getattr(a, part)) == _host(getattr(b, part)), (
                f"column {name} {part} differs")


def test_generate_parquet_writes_the_jax_files(dirs):
    port_dir, manifest, jax_dir = dirs
    assert manifest == {"dir": port_dir, "scale": 0.0, "store_sales": 1000,
                        "web_sales": 250, "item": 18000, "customer": 100}
    for name in FILES:
        a = pq.read_table(os.path.join(port_dir, f"{name}.parquet"))
        b = pq.read_table(os.path.join(jax_dir, f"{name}.parquet"))
        assert a.equals(b), name
        assert (pq.ParquetFile(os.path.join(port_dir, f"{name}.parquet"))
                .metadata.num_row_groups == 1)
    ss = pq.read_table(os.path.join(port_dir, "store_sales.parquet"))
    assert str(ss.schema.field("sales_price").type) == "decimal128(7, 2)"
    assert ss["customer_sk"].null_count > 0  # dbgen's ~4 % null FKs


QUERIES = ["q5", "q23", "q64"]


@pytest.fixture(scope="module")
def results(dirs):
    """Each stream on the port's files: (JAX result, port result). The
    three JAX streams run at once on threads (their time is XLA's
    per-shape compiles, which release the interpreter lock); the port's
    run on this thread meanwhile."""
    port_dir, _, _ = dirs
    with ThreadPoolExecutor(len(QUERIES)) as pool:
        jax_runs = {q: pool.submit(getattr(jt, f"{q}_stream"), port_dir)
                    for q in QUERIES}
        port = {q: getattr(streams, f"{q}_stream")(port_dir, device="cpu")
                for q in QUERIES}
        return {q: (jax_runs[q].result(), port[q]) for q in QUERIES}


@pytest.mark.parametrize("name", QUERIES)
def test_stream_matches_jax(results, name):
    jres, tres = results[name]
    assert tres.row_count > 0
    same_table(jres, tres)


def test_q23_stream_keeps_one_null_customer_group(results):
    _, q23 = results["q23"]
    valid = q23["customer_sk"].validity
    assert valid is not None and int((~valid).sum()) == 1


@pytest.mark.parametrize("prefetch", [0, 1])
def test_q5_stream_prefetch_gives_the_same_bytes(dirs, results, prefetch):
    port_dir, _, _ = dirs
    jres, _ = results["q5"]
    same_table(jres, streams.q5_stream(port_dir, prefetch, device="cpu"))


def test_load_tables_matches_jax(dirs):
    port_dir, _, _ = dirs
    want = jt.load_tables(port_dir)
    got = streams.load_tables(port_dir, device="cpu")
    assert list(got) == list(want)
    for name in want:
        same_table(want[name], got[name])
    assert got["item"]["current_price"].dtype == dt.decimal32(-2)


@pytest.mark.parametrize("name", QUERIES)
def test_oracles_match_jax(dirs, name):
    port_dir, _, _ = dirs
    got = getattr(streams, f"oracle_{name}")(port_dir)
    want = getattr(jt, f"oracle_{name}")(port_dir)
    if name == "q23":
        pd.testing.assert_frame_equal(got[0], want[0], check_exact=True)
        assert got[1] == want[1]
    else:
        pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_runner_verdicts_hold(dirs, results):
    port_dir, _, _ = dirs
    verdicts = chip_smoke.stream_verdicts(
        port_dir, results["q5"][1], results["q23"][1], results["q64"][1])
    assert verdicts == {"q5": True, "q23": True, "q64": True}


def test_dec_to_float_matches_jax(results):
    from spark_rapids_jni_tpu.column import Column as JColumn
    from spark_rapids_jni_tpu import dtype as jdt

    cents = np.array([0, 1, -250, 12_345_678, 2**40 + 3], np.int64)
    got = streams._dec_to_float(
        Column.from_numpy(cents, dtype=dt.decimal64(-2), device="cpu"))
    want = jt._dec_to_float(JColumn.from_numpy(cents, dtype=jdt.decimal64(-2)))
    assert got.tobytes() == want.tobytes()
    jres, tres = results["q64"]
    assert (streams._dec_to_float(tres["sales"]).tobytes()
            == jt._dec_to_float(jres["sales"]).tobytes())


def test_stream_constants_match_jax():
    for name in ("_SS_PER_SF", "_WS_PER_SF", "_CUST_PER_SF", "_ITEM_SF1",
                 "_N_DATES", "_DATE_LO", "_DATE_HI", "_MONEY_COLS"):
        assert getattr(streams, name) == getattr(jt, name), name
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    assert (streams._money(rng_a, 50).tobytes()
            == jt._money(rng_b, 50).tobytes())
