"""The repository's entry point in the port (port of ``__graft_entry__.py``
:24-69): the flagship query step over Table objects on one device.

``query_step`` is WHERE qty > 5 -> capped inner join with ``items`` ->
``mul`` -> capped groupby SUM/COUNT, with the JAX package's capacities
(the sales row count for the filter and the join, 64 segments for the
groupby), and returns ``(result table of 64 rows, group count)``. It
runs on the device of its inputs; ``entry`` builds the example tables on
``device`` (CUDA unless the caller asks for the CPU). The multi-chip dry
run waits for the distributed slice (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from . import dtype as dt
from .column import Column, Table
from .ops.binaryop import mul
from .ops.filter import filter_table_capped
from .ops.groupby import GroupbyAgg, groupby_aggregate_capped
from .ops.join import inner_join_capped

NUM_SEGMENTS = 64


def _example_tables(n_rows: int = 256, n_items: int = 32, seed: int = 0,
                    device: Union[str, torch.device] = "cuda"):
    rng = np.random.default_rng(seed)
    sales = Table.from_pydict(
        {
            "item": rng.integers(0, n_items, n_rows, dtype=np.int64),
            "qty": rng.integers(1, 10, n_rows, dtype=np.int64),
            "price": rng.standard_normal(n_rows) * 10 + 50,
        },
        device=device,
    )
    items = Table.from_pydict(
        {
            "item": np.arange(n_items, dtype=np.int64),
            "cat": rng.integers(0, 8, n_items, dtype=np.int64),
        },
        device=device,
    )
    return sales, items


def query_step(sales: Table, items: Table):
    """WHERE qty > 5 JOIN items USING(item) GROUP BY cat SUM(qty*price).
    The mask reads the qty data and ignores its validity, as the JAX
    package's does."""
    n = sales.row_count
    qty = sales["qty"].data
    mask = Column(qty > 5, dt.BOOL8, None)
    filtered, fcount = filter_table_capped(sales, mask, capacity=n)
    frow_valid = torch.arange(n, dtype=torch.int32, device=qty.device) < fcount
    joined, jcount = inner_join_capped(
        filtered, items, ["item"], capacity=n, left_valid=frow_valid
    )
    jrow_valid = torch.arange(joined.row_count, dtype=torch.int32,
                              device=qty.device) < jcount
    rev = mul(joined["qty"], joined["price"])
    with_rev = Table([*joined.columns, rev], [*joined.names, "rev"])
    return groupby_aggregate_capped(
        with_rev,
        ["cat"],
        [GroupbyAgg("rev", "sum"), GroupbyAgg("rev", "count")],
        num_segments=NUM_SEGMENTS,
        row_valid=jrow_valid,
    )


def entry(device: Union[str, torch.device] = "cuda"):
    """(query_step, example args) for a one-device run."""
    return query_step, _example_tables(device=device)
