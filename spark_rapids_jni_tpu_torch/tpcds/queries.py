"""TPC-DS q5/q23/q64-shaped queries over the port's op library (port of
``benchmarks/queries.py``).

Not the literal TPC-DS SQL (whose dimension DDL is far wider) but the
same operator DAGs at the same shapes:

* q5-shape:  multi-channel fact union -> date filter -> dimension join
             -> rollup aggregation.
* q23-shape: frequent-item CTE (groupby+filter) -> semi join against the
             fact table -> per-customer aggregation.
* q64-shape: chained multi-dimension joins (item, customer, date) with
             predicates -> wide-key aggregation.

Each query runs on one device (eager ops) or over a mesh of the port's
distributed tier (``parallel.distributed``): a hash exchange and the
local capped ops on each shard, the GpuShuffleExchangeExec replacement.
A mesh query's tables start on the mesh's first device, and what it
compacts between stages (``unpad_groupby``) lands there too.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dtype as dt
from .. import ops
from ..column import Column, Table, host_to_storage
from ..ops.groupby import GroupbyAgg
from ..parallel.distributed import (
    broadcast_inner_join,
    distributed_groupby,
    distributed_inner_join,
    distributed_semi_join,
)
from ..parallel.mesh import Sharded


def _date_filter(t: Table, lo: int, hi: int) -> Table:
    """Rows with ``lo <= date_sk < hi`` (``queries.py:36``)."""
    d = t["date_sk"].data
    return ops.filter_table(
        t, Column(torch.logical_and(d >= lo, d < hi), dt.BOOL8, None))


# ---------------------------------------------------------------------------
# q5-shape: channel union -> date window -> join item -> category rollup
# ---------------------------------------------------------------------------

_Q5_AGGS = (GroupbyAgg("revenue", "sum"), GroupbyAgg("net_profit", "sum"),
            GroupbyAgg("revenue", "count"))


def _with_revenue(joined: Table, name: str = "revenue") -> Table:
    """``joined`` with quantity x sales_price appended as ``name``."""
    rev = ops.mul(joined["quantity"], joined["sales_price"])
    return Table([*joined.columns, rev], [*joined.names, name])


def q5(tables: dict, date_lo: int = 100, date_hi: int = 200) -> Table:
    """``queries.py:49``."""
    store = _date_filter(tables["store_sales"], date_lo, date_hi)
    web = _date_filter(tables["web_sales"], date_lo, date_hi)
    allsales = ops.concatenate([store, web])
    joined = ops.inner_join(allsales, tables["item"], ["item_sk"])
    return ops.groupby_aggregate(_with_revenue(joined), ["category_id"],
                                 list(_Q5_AGGS))


def q5_distributed(tables: dict, mesh, date_lo=100, date_hi=200):
    """``queries.py:69``. The union and the date filter stay on one
    device; the item join is a BROADCAST hash join (the fact side stays
    sharded in place); the aggregation shuffles by category. Returns
    ``distributed_groupby``'s (sharded padded result, group counts,
    overflow)."""
    store = _date_filter(tables["store_sales"], date_lo, date_hi)
    web = _date_filter(tables["web_sales"], date_lo, date_hi)
    allsales = _pad_to_mesh(ops.concatenate([store, web]), mesh)
    # padding rows carry _PAD_KEY, which matches no real item_sk: the
    # inner broadcast join drops them
    joined_sh, counts = broadcast_inner_join(
        allsales, tables["item"], ["item_sk"], mesh)
    joined = _unpad_join(joined_sh, counts)
    padded = _pad_to_mesh(_with_revenue(joined), mesh)
    return distributed_groupby(padded, ["category_id"], list(_Q5_AGGS), mesh)


# ---------------------------------------------------------------------------
# q23-shape: frequent items CTE -> semi join -> per-customer spend
# ---------------------------------------------------------------------------


def _hot_items(freq: Table, min_count: int) -> Table:
    keep = freq["count_item_sk"].data >= min_count
    return ops.filter_table(freq, Column(keep, dt.BOOL8, None))


def q23(tables: dict, min_count: int = 4) -> Table:
    """``queries.py:106``."""
    sales = tables["store_sales"]
    freq = ops.groupby_aggregate(sales, ["item_sk"],
                                 [GroupbyAgg("item_sk", "count")])
    hot_sales = ops.semi_join(sales, _hot_items(freq, min_count), ["item_sk"])
    return ops.groupby_aggregate(_with_revenue(hot_sales, "spend"),
                                 ["customer_sk"],
                                 [GroupbyAgg("spend", "sum")])


def q23_distributed(tables: dict, mesh, min_count: int = 4):
    """``queries.py:123``: the frequent-item count shuffles by item, the
    (small) hot-item list is compacted on the first device, the LEFT SEMI
    join exchanges both sides by item, and the per-customer sum shuffles
    by customer. Returns ``distributed_groupby``'s triple."""
    sales_padded = _pad_to_mesh(tables["store_sales"], mesh)
    freq_padded, counts, _ = distributed_groupby(
        sales_padded, ["item_sk"], [GroupbyAgg("item_sk", "count")], mesh)
    hot = _hot_items(unpad_groupby(freq_padded, counts), min_count)
    sales_sh, occ, _, _ = distributed_semi_join(
        sales_padded, _pad_to_mesh(hot, mesh), ["item_sk"], mesh)
    hot_sales = _unpad_occupancy(sales_sh, occ)
    # customer_sk is uniform (~rows/20 distinct): the balanced default
    # capacity scales with the mesh
    return distributed_groupby(
        _pad_to_mesh(_with_revenue(hot_sales, "spend"), mesh), ["customer_sk"],
        [GroupbyAgg("spend", "sum")], mesh)


# ---------------------------------------------------------------------------
# q64-shape: chained dimension joins -> wide-key aggregation
# ---------------------------------------------------------------------------

_Q64_BY = ["brand_id", "state_id", "year"]
_Q64_AGGS = (GroupbyAgg("revenue", "sum"), GroupbyAgg("revenue", "count"))


def _price_cutoff(col: Column, max_price: float):
    """Threshold in the column's own representation (``queries.py:162``):
    decimal columns hold unscaled values, so $150.00 at scale -2 is
    15000."""
    scale = col.dtype.scale if col.dtype.is_decimal else 0
    return max_price * (10 ** -scale)


def _cheap_items(item: Table, max_price: float) -> Table:
    """Items whose price is at most ``max_price``. The JAX package
    compares the int64 cents with a Python float in float64 (x64); a
    torch int64 tensor against a Python float would promote to float32
    and round cents past 2^24, so the values are compared as float64."""
    price = item["current_price"]
    keep = (ops.compute.values(price).to(torch.float64)
            <= float(_price_cutoff(price, max_price)))
    return ops.filter_table(item, Column(keep, dt.BOOL8, None))


def _q64_rollup(j3: Table) -> Table:
    return ops.groupby_aggregate(_with_revenue(j3), _Q64_BY, list(_Q64_AGGS))


def q64(tables: dict, max_price: float = 150.0) -> Table:
    """``queries.py:169``."""
    j1 = ops.inner_join(tables["store_sales"],
                        _cheap_items(tables["item"], max_price), ["item_sk"])
    j2 = ops.inner_join(j1, tables["customer"], ["customer_sk"])
    j3 = ops.inner_join(j2, tables["date_dim"], ["date_sk"])
    return _q64_rollup(j3)


def _mesh_size(mesh) -> int:
    return int(np.prod(list(mesh.shape.values())))


def q64_distributed(tables: dict, mesh, max_price: float = 150.0) -> Table:
    """``queries.py:193``: the fact x customer join shuffles both sides;
    the small dimension joins (the cheap items, date_dim) are broadcast
    hash joins. The final rollup runs on the first device."""
    cheap = _cheap_items(tables["item"], max_price)
    j1_sh, j1_counts = broadcast_inner_join(
        _pad_to_mesh(tables["store_sales"], mesh), cheap, ["item_sk"], mesh)
    lpad = _pad_to_mesh(_unpad_join(j1_sh, j1_counts), mesh)
    rpad = _pad_to_mesh(tables["customer"], mesh)
    num = _mesh_size(mesh)
    # customer_sk is unique on the right, so a device's real matches are
    # bounded by the left rows it receives; pad rows share _PAD_KEY on
    # both sides and cross-join on one device, adding at most (num-1)^2
    joined, counts, _, _ = distributed_inner_join(
        lpad, rpad, ["customer_sk"], mesh,
        out_capacity=lpad.row_count + (num - 1) ** 2)
    out = _unpad_join(joined, counts)
    j3_sh, j3_counts = broadcast_inner_join(
        _pad_to_mesh(out, mesh), tables["date_dim"], ["date_sk"], mesh)
    return _q64_rollup(_unpad_join(j3_sh, j3_counts))


# ---------------------------------------------------------------------------
# padding helpers: a mesh's tables hold a multiple of its size in rows;
# padding rows carry a key no real row uses, so they aggregate apart and
# are dropped on unpad
# ---------------------------------------------------------------------------

_PAD_KEY = np.int64(-(2**62))


def _pad_fill(dtype: dt.DType, shape: tuple, device) -> torch.Tensor:
    """``_PAD_KEY`` cast to the column's storage as the JAX package
    casts it (``queries.py:267-270``: ``jnp.full(...).astype``): it wraps
    to 0 in 32-bit and narrower integers, both DECIMAL128 limbs hold it,
    a FLOAT32 gets the float nearest -2^62, and a FLOAT64, whose storage
    is its bit pattern in both packages, gets the pattern -2^62."""
    host = np.full(shape, _PAD_KEY).astype(dtype.host_dtype)
    return host_to_storage(host, dtype, device)


def _pad_to_mesh(table: Table, mesh) -> Table:
    """``queries.py:252``: ``table`` with pad rows appended up to a
    multiple of the mesh's size. STRING pad rows are empty (zero bytes,
    zero lengths); no pad column has a validity vector."""
    num = _mesh_size(mesh)
    rem = (-table.row_count) % num
    if rem == 0:
        return table
    pad_cols = []
    for c in table.columns:
        dev = c.data.device
        if c.dtype.is_string:
            pad_cols.append(Column(
                torch.zeros((rem, c.data.shape[1]), dtype=torch.uint8,
                            device=dev),
                c.dtype, None, torch.zeros((rem,), dtype=torch.int32,
                                           device=dev)))
            continue
        pad_cols.append(Column(
            _pad_fill(c.dtype, (rem,) + tuple(c.data.shape[1:]), dev),
            c.dtype, None))
    return ops.concatenate([table, Table(pad_cols, table.names)])


def _real_mask(table: Table) -> torch.Tensor:
    """``queries.py:275``: per row, not a padding row (keyed off the
    first column, which ``_pad_to_mesh`` fills with the sentinel)."""
    first = table.columns[0]
    fill = _pad_fill(first.dtype, (1,) + tuple(first.data.shape[1:]),
                     first.data.device)
    return first.data != fill


def _global(value):
    """A sharded value's parts in mesh order, on the mesh's first device
    (a Table or tensor passes through)."""
    return value.concat() if isinstance(value, Sharded) else value


def unpad_groupby(padded, counts) -> Table:
    """``queries.py:283``: compact a sharded padded result: keep each
    shard's first ``counts[d]`` rows and drop the padding groups (the
    ``_PAD_KEY`` key). The occupancy is computed on the device from the
    counts tensor; the filter's exact size is the one host read, as in
    ``ops.filter_table``."""
    table = _global(padded)
    dev = table.columns[0].data.device
    cnt = torch.as_tensor(_global(counts)).reshape(-1).to(dev)
    per = table.row_count // max(cnt.shape[0], 1)
    if per == 0:
        return table
    slot = torch.arange(table.row_count, dtype=torch.int32, device=dev)
    occupied = (slot % per) < cnt[slot // per]
    mask = Column(torch.logical_and(occupied, _real_mask(table)), dt.BOOL8,
                  None)
    return ops.filter_table(table, mask)


def _unpad_join(padded, counts) -> Table:
    """The same shard compaction for a distributed join's output."""
    return unpad_groupby(padded, counts)


def _unpad_occupancy(sharded, occ) -> Table:
    """Compact a padded-shard result by its occupancy (the semi/anti
    join convention), dropping ``_PAD_KEY`` padding rows too."""
    table = _global(sharded)
    occ = _global(occ).to(table.columns[0].data.device)
    mask = Column(torch.logical_and(occ, _real_mask(table)), dt.BOOL8, None)
    return ops.filter_table(table, mask)


# the JAX module's alias of the private name
_unpad_groupby = unpad_groupby
