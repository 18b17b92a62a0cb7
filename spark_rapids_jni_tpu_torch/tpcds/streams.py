"""The TPC-DS Parquet star schema, its streamed q5/q23/q64 and their
pandas oracles (port of the query half of ``benchmarks/tpcds.py``).

  generate_parquet  the spec-inspired star schema (store_sales, web_sales,
                    item, customer, date_dim) at a scale factor: SF 1 is
                    2.88M store_sales rows (the TPC-DS ratio), DECIMAL(7,2)
                    money, nullable foreign keys (~4 %, like dbgen),
                    string dimension attributes. Host only: the files
                    equal the JAX function's for the same scale and seed.
  q5_stream         channel union -> date-window pushdown -> item join
                    -> category rollup, streamed a row group a batch.
  q23_stream        frequent-item CTE over store_sales -> semi join of
                    web_sales -> per-customer aggregation.
  q64_stream        store_sales -> item (price filter) -> customer ->
                    wide-key aggregation.
  oracle_*          the same queries in pandas/pyarrow on the same files.
  load_tables       the files as the in-memory tables ``queries`` takes.

Streaming model: dimensions load resident (the small side, broadcast as
GpuBroadcastHashJoinExec does), fact batches arrive through
``io.parquet.scan_parquet`` with predicate pushdown and prefetch, each
batch joins and partially aggregates on the device, and one final
groupby combines the partials.

Not here: the JAX module's runner (``run_all``, ``run_distributed``),
which times these functions.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch

from .. import dtype as dt
from .. import ops
from ..column import Column, Table
from ..io.parquet import read_parquet, scan_parquet
from ..ops.groupby import GroupbyAgg, groupby_aggregate

# spec row-count ratios (TPC-DS dbgen at SF1, rounded)
_SS_PER_SF = 2_880_000
_WS_PER_SF = 720_000
_CUST_PER_SF = 100_000
_ITEM_SF1 = 18_000
_N_DATES = 73_049  # 1900..2100, the fixed TPC-DS calendar


def _money(rng, n, lo=50, hi=20_000):
    """DECIMAL(7,2) money as unscaled cents."""
    return rng.integers(lo, hi, n, dtype=np.int64)


def generate_parquet(out_dir: str, scale: float = 0.01, seed: int = 0):
    """Write the star schema to ``out_dir`` (``tpcds.py:59``); returns a
    manifest dict."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    n_ss = max(int(_SS_PER_SF * scale), 1000)
    n_ws = max(int(_WS_PER_SF * scale), 250)
    n_cust = max(int(_CUST_PER_SF * scale), 100)
    n_item = max(int(_ITEM_SF1 * max(scale, 1) ** 0.5), 100)
    os.makedirs(out_dir, exist_ok=True)
    money = pa.decimal128(7, 2)

    def write(name, table, row_group_rows):
        pq.write_table(
            table, os.path.join(out_dir, f"{name}.parquet"),
            row_group_size=row_group_rows,
        )

    # date_dim: dense sk, year/moy derivable from sk
    d_sk = np.arange(_N_DATES, dtype=np.int64)
    write(
        "date_dim",
        pa.table({
            "d_date_sk": d_sk,
            "d_year": 1900 + d_sk // 365,
            "d_moy": (d_sk % 365) // 31 + 1,
        }),
        _N_DATES,
    )

    # item: skewed brand/category, string attributes, decimal price
    i_sk = np.arange(n_item, dtype=np.int64)
    write(
        "item",
        pa.table({
            "i_item_sk": i_sk,
            "i_item_id": pa.array(
                [f"AAAAAAAA{i:08d}" for i in range(n_item)]
            ),
            "i_brand_id": rng.integers(1, 1000, n_item),
            "i_category_id": rng.integers(1, 11, n_item),
            "i_brand": pa.array(
                [f"brand#{int(b):03d}" for b in rng.integers(0, 200, n_item)]
            ),
            "i_category": pa.array(
                [
                    ["Books", "Home", "Electronics", "Jewelry", "Men",
                     "Music", "Shoes", "Sports", "Children", "Women"][c]
                    for c in rng.integers(0, 10, n_item)
                ]
            ),
            "i_current_price": pa.array(
                _money(rng, n_item) / 100.0
            ).cast(money),
        }),
        max(n_item, 1024),
    )

    # customer: nullable names/birth year (dbgen leaves ~3% null)
    c_sk = np.arange(n_cust, dtype=np.int64)
    first = rng.integers(0, 512, n_cust)
    last = rng.integers(0, 2048, n_cust)
    name_null = rng.random(n_cust) < 0.03
    write(
        "customer",
        pa.table({
            "c_customer_sk": c_sk,
            "c_first_name": pa.array(
                [None if m else f"F{v:03d}" for m, v in zip(name_null, first)]
            ),
            "c_last_name": pa.array(
                [None if m else f"L{v:04d}" for m, v in zip(name_null, last)]
            ),
            "c_birth_year": pa.array(
                np.where(rng.random(n_cust) < 0.03, -1,
                         rng.integers(1930, 2005, n_cust))
            ).cast(pa.int64()),
            # ca_state folded onto customer (the spec keeps it on
            # customer_address): the same join/agg shape for q64's
            # group-by
            "c_state_id": rng.integers(0, 50, n_cust),
        }),
        max(n_cust, 4096),
    )

    def fact(n):
        # zipf item popularity: the join/shuffle skew that matters
        item_fk = (rng.zipf(1.2, n) - 1) % n_item
        cust_null = rng.random(n) < 0.04  # dbgen null FK rate
        cust_fk = rng.integers(0, n_cust, n)
        return pa.table({
            "sold_date_sk": rng.integers(0, _N_DATES, n),
            "item_sk": item_fk.astype(np.int64),
            "customer_sk": pa.array(cust_fk, mask=cust_null),
            "quantity": rng.integers(1, 100, n),
            "sales_price": pa.array(_money(rng, n) / 100.0).cast(money),
            "ext_sales_price": pa.array(
                _money(rng, n, 100, 3_000_000) / 100.0
            ).cast(money),
            "net_profit": pa.array(
                rng.integers(-500_000, 1_200_000, n) / 100.0
            ).cast(money),
        })

    rg = 1 << 19  # ~512k-row groups: the streaming batch unit
    write("store_sales", fact(n_ss), rg)
    write("web_sales", fact(n_ws), rg)
    return {
        "dir": out_dir, "scale": scale, "store_sales": n_ss,
        "web_sales": n_ws, "item": n_item, "customer": n_cust,
    }


# ---------------------------------------------------------------------------
# streamed queries (scan -> join -> agg)
# ---------------------------------------------------------------------------


def _combine_partials(partials, by, agg_specs):
    whole = ops.concatenate(partials) if len(partials) > 1 else partials[0]
    return groupby_aggregate(whole, by, agg_specs)


_DATE_LO, _DATE_HI = 36_000, 36_730  # a 2-year window in the calendar


def _path(data_dir: str, name: str) -> str:
    return os.path.join(data_dir, f"{name}.parquet")


def q5_stream(data_dir: str, prefetch: int = 2,
              device: Union[str, torch.device] = "cuda") -> Table:
    """Channel union -> date pushdown -> item join -> category rollup
    (``tpcds.py:186``)."""
    from ..io.predicates import col as C

    item = read_parquet(_path(data_dir, "item"),
                        columns=["i_item_sk", "i_category_id"], device=device)
    pred = (C("sold_date_sk") >= _DATE_LO) & (C("sold_date_sk") < _DATE_HI)
    partials = []
    for name in ("store_sales", "web_sales"):
        for batch in scan_parquet(
            _path(data_dir, name),
            columns=["sold_date_sk", "item_sk", "ext_sales_price",
                     "net_profit"],
            filters=pred, prefetch=prefetch, device=device,
        ):
            joined = ops.inner_join(batch, item, ["item_sk"], ["i_item_sk"])
            partials.append(groupby_aggregate(
                joined, ["i_category_id"],
                [GroupbyAgg("ext_sales_price", "sum", "sales"),
                 GroupbyAgg("net_profit", "sum", "profit"),
                 GroupbyAgg("item_sk", "count", "n")]))
    return _combine_partials(
        partials, ["i_category_id"],
        [GroupbyAgg("sales", "sum", "sales"),
         GroupbyAgg("profit", "sum", "profit"),
         GroupbyAgg("n", "sum", "n")])


def q23_stream(data_dir: str, min_count: int = 50, prefetch: int = 2,
               device: Union[str, torch.device] = "cuda") -> Table:
    """Frequent-item CTE -> semi join -> per-customer aggregation
    (``tpcds.py:223``). The null customer key is one group."""
    # pass 1: item frequency over store_sales
    partials = []
    for batch in scan_parquet(_path(data_dir, "store_sales"),
                              columns=["item_sk"], prefetch=prefetch,
                              device=device):
        partials.append(groupby_aggregate(
            batch, ["item_sk"], [GroupbyAgg("item_sk", "count", "n")]))
    freq = _combine_partials(partials, ["item_sk"],
                             [GroupbyAgg("n", "sum", "n")])
    hot = ops.filter_table(
        freq, Column(freq["n"].data >= min_count, dt.BOOL8, None))

    # pass 2: web_sales rows on frequent items -> customer totals
    partials = []
    for batch in scan_parquet(
        _path(data_dir, "web_sales"),
        columns=["item_sk", "customer_sk", "sales_price"],
        prefetch=prefetch, device=device,
    ):
        kept = ops.semi_join(batch, hot, ["item_sk"])
        partials.append(groupby_aggregate(
            kept, ["customer_sk"],
            [GroupbyAgg("sales_price", "sum", "total")]))
    return _combine_partials(partials, ["customer_sk"],
                             [GroupbyAgg("total", "sum", "total")])


def q64_stream(data_dir: str, max_price: float = 50.0, prefetch: int = 2,
               device: Union[str, torch.device] = "cuda") -> Table:
    """store_sales -> item (price < cap) -> customer -> (brand, birth
    year) (``tpcds.py:262``)."""
    item = read_parquet(
        _path(data_dir, "item"),
        columns=["i_item_sk", "i_brand_id", "i_current_price"],
        device=device)
    # DECIMAL(7,2) predicate on the unscaled cents (exact, no decode)
    unscaled_cap = int(round(max_price * 100))
    item = ops.filter_table(item, Column(
        item["i_current_price"].data < unscaled_cap, dt.BOOL8, None))
    customer = read_parquet(_path(data_dir, "customer"),
                            columns=["c_customer_sk", "c_birth_year"],
                            device=device)
    partials = []
    for batch in scan_parquet(
        _path(data_dir, "store_sales"),
        columns=["item_sk", "customer_sk", "ext_sales_price"],
        prefetch=prefetch, device=device,
    ):
        j1 = ops.inner_join(batch, item, ["item_sk"], ["i_item_sk"])
        j2 = ops.inner_join(j1, customer, ["customer_sk"], ["c_customer_sk"])
        partials.append(groupby_aggregate(
            j2, ["i_brand_id", "c_birth_year"],
            [GroupbyAgg("ext_sales_price", "sum", "sales"),
             GroupbyAgg("item_sk", "count", "n")]))
    return _combine_partials(
        partials, ["i_brand_id", "c_birth_year"],
        [GroupbyAgg("sales", "sum", "sales"), GroupbyAgg("n", "sum", "n")])


# ---------------------------------------------------------------------------
# pandas oracles (same files, same predicates)
# ---------------------------------------------------------------------------


_MONEY_COLS = {
    "sales_price", "ext_sales_price", "net_profit", "i_current_price",
}


def _read_pd(data_dir, name, columns):
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pq.read_table(_path(data_dir, name), columns=columns)
    # decimal -> float64 for the oracle (sums in cents stay < 2^53)
    t = pa.table({
        c: (t[c].cast(pa.float64()) if c in _MONEY_COLS else t[c])
        for c in t.column_names
    })
    return t.to_pandas()


def oracle_q5(data_dir):
    """``tpcds.py:329``."""
    import pandas as pd

    item = _read_pd(data_dir, "item", ["i_item_sk", "i_category_id"])
    frames = []
    for name in ("store_sales", "web_sales"):
        df = _read_pd(
            data_dir, name,
            ["sold_date_sk", "item_sk", "ext_sales_price", "net_profit"])
        frames.append(df[(df.sold_date_sk >= _DATE_LO)
                         & (df.sold_date_sk < _DATE_HI)])
    fact = pd.concat(frames).merge(item, left_on="item_sk",
                                   right_on="i_item_sk")
    return (
        fact.groupby("i_category_id")
        .agg(sales=("ext_sales_price", "sum"),
             profit=("net_profit", "sum"), n=("item_sk", "count"))
        .reset_index()
    )


def oracle_q23(data_dir, min_count: int = 50):
    """``tpcds.py:352``: (the non-null customers' totals, the null
    customer group's total), which the stream's one null-key group is
    checked against apart."""
    ss = _read_pd(data_dir, "store_sales", ["item_sk"])
    hot = ss.groupby("item_sk").size()
    hot = set(hot[hot >= min_count].index)
    ws = _read_pd(data_dir, "web_sales",
                  ["item_sk", "customer_sk", "sales_price"])
    hot_ws = ws[ws.item_sk.isin(hot)]
    kept = hot_ws.dropna(subset=["customer_sk"])
    out = kept.groupby("customer_sk").sales_price.sum().reset_index()
    null_sum = float(hot_ws[hot_ws.customer_sk.isna()].sales_price.sum())
    return out, null_sum


def oracle_q64(data_dir, max_price: float = 50.0):
    """``tpcds.py:368``."""
    item = _read_pd(data_dir, "item",
                    ["i_item_sk", "i_brand_id", "i_current_price"])
    item = item[item.i_current_price.astype(float) < max_price]
    cust = _read_pd(data_dir, "customer", ["c_customer_sk", "c_birth_year"])
    ss = _read_pd(data_dir, "store_sales",
                  ["item_sk", "customer_sk", "ext_sales_price"])
    j = (
        ss.dropna(subset=["customer_sk"])
        .merge(item, left_on="item_sk", right_on="i_item_sk")
        .merge(cust, left_on="customer_sk", right_on="c_customer_sk")
    )
    return (
        j.groupby(["i_brand_id", "c_birth_year"])
        .agg(sales=("ext_sales_price", "sum"), n=("item_sk", "count"))
        .reset_index()
    )


def load_tables(data_dir: str,
                device: Union[str, torch.device] = "cuda") -> dict:
    """The Parquet star schema as the in-memory tables, with the column
    names, that ``queries``' DAGs and their mesh forms take
    (``tpcds.py:389``)."""
    fact_cols = ["item_sk", "customer_sk", "sold_date_sk", "quantity",
                 "sales_price", "net_profit"]
    ss = read_parquet(_path(data_dir, "store_sales"), columns=fact_cols,
                      device=device)
    ws = read_parquet(_path(data_dir, "web_sales"), columns=fact_cols,
                      device=device)

    def rename(t, names):
        return Table(list(t.columns), names)

    fact_names = ["item_sk", "customer_sk", "date_sk", "quantity",
                  "sales_price", "net_profit"]
    item = read_parquet(
        _path(data_dir, "item"),
        columns=["i_item_sk", "i_brand_id", "i_category_id",
                 "i_current_price", "i_brand"],
        device=device)
    customer = read_parquet(
        _path(data_dir, "customer"),
        columns=["c_customer_sk", "c_birth_year", "c_state_id"],
        device=device)
    date_dim = read_parquet(_path(data_dir, "date_dim"), device=device)
    return {
        "store_sales": rename(ss, fact_names),
        "web_sales": rename(ws, fact_names),
        "item": rename(item, ["item_sk", "brand_id", "category_id",
                              "current_price", "brand"]),
        "customer": rename(customer, ["customer_sk", "birth_year",
                                      "state_id"]),
        "date_dim": rename(date_dim, ["date_sk", "year", "moy"]),
    }


def _dec_to_float(col: Column) -> np.ndarray:
    """A column's values as float64 on the host, a decimal's unscaled
    values times 10^scale (``tpcds.py:464``)."""
    vals = np.asarray(col.to_numpy(), dtype=np.float64)
    if col.dtype.is_decimal:
        vals = vals * (10.0 ** col.dtype.scale)
    return vals
