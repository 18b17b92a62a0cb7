"""Synthetic TPC-DS-like star schema at a row-count scale (port of
``benchmarks/datagen.py:17`` ``generate``).

The tables q5/q23/q64 touch (store_sales, web_sales, item, customer,
date_dim) with the key distributions that matter for the ops under
test: Zipf-skewed fact item keys, dense dimension keys, date windows.
The host arrays come from the same ``default_rng`` draws in the same
order as the JAX function's, so both packages hold the same bytes for
the same ``sales_rows`` and ``seed``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column, Table, resolve_device


def generate(sales_rows: int = 100_000, seed: int = 0,
             device: Union[str, torch.device] = "cuda") -> dict:
    """Star schema sized off the fact-table row count, on ``device``.

    items ~ rows/50, customers ~ rows/20, dates = 2 years daily."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_items = max(sales_rows // 50, 8)
    n_cust = max(sales_rows // 20, 8)
    n_dates = 730

    # Zipf-ish item popularity: the skew that stresses hash partitioning
    item_pop = rng.zipf(1.3, sales_rows) % n_items

    def col(arr, dtype=None):
        return Column.from_numpy(arr, dtype=dtype, device=dev)

    def fact(n):
        # DECIMAL(7,2) money as unscaled cents at scale -2; the draws in
        # the JAX function's order (argument evaluation is left to right)
        return Table(
            [
                col(item_pop[:n].astype(np.int64)),
                col(rng.integers(0, n_cust, n, dtype=np.int64)),
                col(rng.integers(0, n_dates, n, dtype=np.int64)),
                col(rng.integers(1, 100, n, dtype=np.int64)),
                col(rng.integers(50, 30_000, n, dtype=np.int64),
                    dt.decimal64(-2)),
                col(rng.integers(-5_000, 12_000, n, dtype=np.int64),
                    dt.decimal64(-2)),
            ],
            ["item_sk", "customer_sk", "date_sk", "quantity",
             "sales_price", "net_profit"],
        )

    store_sales = fact(sales_rows)
    web_sales = fact(max(sales_rows // 4, 8))

    item = Table(
        [
            col(np.arange(n_items, dtype=np.int64)),
            col(rng.integers(0, 100, n_items, dtype=np.int64)),
            col(rng.integers(0, 12, n_items, dtype=np.int64)),
            col(rng.integers(50, 30_000, n_items, dtype=np.int64),
                dt.decimal64(-2)),
            # string dimension attribute: rides joins and the shuffle
            Column.from_strings(
                [f"brand#{i % 100:02d}" for i in range(n_items)], device=dev),
        ],
        ["item_sk", "brand_id", "category_id", "current_price", "brand"],
    )
    customer = {
        "customer_sk": np.arange(n_cust, dtype=np.int64),
        "birth_year": rng.integers(1930, 2005, n_cust, dtype=np.int64),
        "state_id": rng.integers(0, 50, n_cust, dtype=np.int64),
    }
    days = np.arange(n_dates, dtype=np.int64)
    date_dim = {"date_sk": days, "year": 2000 + days // 365,
                "moy": (days // 30) % 12 + 1}
    return {
        "store_sales": store_sales,
        "web_sales": web_sales,
        "item": item,
        "customer": Table.from_pydict(customer, device=dev),
        "date_dim": Table.from_pydict(date_dim, device=dev),
    }
