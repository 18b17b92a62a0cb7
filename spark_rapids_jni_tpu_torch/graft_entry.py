"""The repository's entry point in the port (port of ``__graft_entry__.py``
:24-69): the flagship query step over Table objects on one device.

``query_step`` is WHERE qty > 5 -> capped inner join with ``items`` ->
``mul`` -> capped groupby SUM/COUNT, with the JAX package's capacities
(the sales row count for the filter and the join, 64 segments for the
groupby), and returns ``(result table of 64 rows, group count)``. It
runs on the device of its inputs; ``entry`` builds the example tables on
``device`` (CUDA unless the caller asks for the CPU).

``dryrun_multichip`` (port of ``__graft_entry__.py:72``) runs the
distributed tier once over a mesh of ``n_devices`` shards and checks
each result against its oracle, TPC-DS q5 on the mesh against q5 on one
device last.
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


def _mesh_pool(n_devices: int, device: Union[str, torch.device]) -> list:
    """The mesh's devices: the visible GPUs, repeated in turn up to
    ``n_devices`` where fewer are visible (one card carries several
    logical shards); or ``n_devices`` CPU shards when the caller asks for
    the CPU."""
    from .column import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n_devices
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def dryrun_multichip(n_devices: int,
                     device: Union[str, torch.device] = "cuda") -> None:
    """Run one distributed query step over an ``n_devices``-shard mesh
    and check every result: the shuffle join, the groupby against its
    oracle, the sort's total order, the broadcast join's pair count, the
    string-key join, the chunked and packed groupbys, the packed join and
    sort, the FLOAT64 -> STRING -> FLOAT64 cast round trip, and TPC-DS q5
    on the mesh against q5 on one device (``__graft_entry__.py:303-326``:
    no overflow, the same categories, revenue within 1e-6 relative)."""
    from . import parallel
    from .ops import strings as strings_mod
    from .ops.groupby_chunked import groupby_aggregate_capped_chunked
    from .ops.groupby_packed import (
        groupby_aggregate_packed_chunked, groupby_aggregate_packed_flat,
    )
    from .ops.join_packed import inner_join_batched_packed
    from .ops.sort import SortKey, sort_table
    from .ops.sort_packed import sort_table_packed

    pool = _mesh_pool(n_devices, device)
    dev = pool[0]
    gpus = len({d for d in pool if d.type == "cuda"})
    mesh = parallel.make_mesh(n_devices, devices=pool)
    rng = np.random.default_rng(1)
    n = 32 * n_devices
    sales = Table.from_pydict(
        {"item": rng.integers(0, 16, n, dtype=np.int64),
         "qty": rng.integers(1, 10, n, dtype=np.int64)}, device=dev)
    items = Table.from_pydict(
        {"item": np.tile(np.arange(16, dtype=np.int64), n_devices),
         "cat": rng.integers(0, 4, 16 * n_devices, dtype=np.int64)},
        device=dev)

    # distributed join: both sides exchanged on the key; capacities
    # planned from the counts (lossless)
    out, counts, lov, rov = parallel.distributed_inner_join(
        sales, items, ["item"], mesh)
    assert int(lov.max()) <= 0 and int(rov.max()) <= 0
    total = int(counts.sum())
    assert total > 0

    # distributed groupby, against a one-device oracle
    sum_count = [GroupbyAgg("qty", "sum"), GroupbyAgg("qty", "count")]
    agg, ngroups, overflow = parallel.distributed_groupby(
        sales, ["item"], sum_count, mesh)
    assert int(overflow.max()) <= 0
    kk = sales["item"].data.cpu().numpy()
    vv = sales["qty"].data.cpu().numpy()
    got = {}
    g_counts = ngroups.cpu().numpy()
    for d, part in enumerate(agg):
        ks = part["item"].data.cpu().numpy()
        sums = part["sum_qty"].data.cpu().numpy()
        for i in range(int(g_counts[d])):
            got[int(ks[i])] = int(sums[i])
    want = {int(u): int(vv[kk == u].sum()) for u in np.unique(kk)}
    assert got == want, "distributed groupby mismatch"

    # distributed ORDER BY: the valid prefixes in mesh order are the
    # total order
    sorted_sh, occ, sort_ov = parallel.distributed_sort(
        sales, [SortKey("item")], mesh)
    assert int(sort_ov.max()) <= 0
    occ_h = occ.concat().cpu().numpy()
    vals_h = sorted_sh.concat()["item"].data.cpu().numpy()[occ_h]
    assert (np.diff(vals_h) >= 0).all(), "distributed sort out of order"
    assert vals_h.shape[0] == n, "distributed sort lost rows"

    # broadcast join: every sales row matches items n_devices times
    bj_out, bj_counts = parallel.broadcast_inner_join(
        sales, items, ["item"], mesh)
    assert int(bj_counts.sum()) == n * n_devices, (
        "broadcast join pair count mismatch")

    # string-key distributed join: the int key space as STRING keys
    def with_str_key(t):
        ids = t["item"].data.cpu().numpy()
        return Table([Column.from_strings([f"sku{v:04d}" for v in ids],
                                          device=dev), *t.columns],
                     ["sku", *t.names])

    s_out, s_counts, s_lov, s_rov = parallel.distributed_inner_join(
        with_str_key(sales), with_str_key(items), ["sku"], mesh)
    assert int(s_lov.max()) <= 0 and int(s_rov.max()) <= 0
    s_total = int(s_counts.sum())
    assert s_total == total, (
        f"string-key join pairs {s_total} != int-key {total}")

    # the chunked two-level groupby at a tiny chunk size
    cagg, cgroups, cmax = groupby_aggregate_capped_chunked(
        sales, ["item"], sum_count, num_segments=64, chunk_rows=64,
        chunk_segments=64)
    assert int(cmax) <= 64, "chunk capacity overflow"

    def prefix_dict(t, g):
        g = int(g)
        return dict(zip(t["item"].data[:g].cpu().tolist(),
                        t["sum_qty"].data[:g].cpu().tolist()))

    assert prefix_dict(cagg, cgroups) == want, (
        "chunked groupby mismatch vs oracle")

    # the packed formulations, each against the same oracle
    pagg, pgroups, pmax, pov = groupby_aggregate_packed_chunked(
        sales, ["item"], sum_count, num_segments=64, chunk_rows=64,
        chunk_segments=64)
    assert not bool(pov), "packed groupby range overflow"
    assert int(pmax) <= 64, "packed groupby chunk capacity exceeded"
    assert prefix_dict(pagg, pgroups) == want, "packed groupby mismatch"
    pj = inner_join_batched_packed(sales, items, ["item"], probe_rows=64)
    assert pj is not None, "packed join declined an eligible shape"
    assert pj.row_count == total, "packed join pair count mismatch"
    ps_t = sort_table_packed(sales, [SortKey("item")])
    ws_t = sort_table(sales, [SortKey("item")])
    assert ps_t is not None
    assert (torch.equal(ps_t["item"].data, ws_t["item"].data)
            and torch.equal(ps_t["qty"].data, ws_t["qty"].data)), (
        "packed sort mismatch")
    for eng in ("pallas", "pallas32"):
        eagg, egroups, emax, eov = groupby_aggregate_packed_chunked(
            sales, ["item"], sum_count, num_segments=64, chunk_rows=128,
            chunk_segments=64, engine=eng)
        assert not bool(eov), f"{eng} engine overflow"
        assert int(emax) <= 64, f"{eng} engine chunk capacity exceeded"
        assert prefix_dict(eagg, egroups) == want, f"{eng} engine mismatch"
    fagg, fgroups, fov = groupby_aggregate_packed_flat(
        sales, ["item"], [GroupbyAgg("qty", "sum")], num_segments=64,
        values_via="gather")
    assert not bool(fov), "flat gather overflow"
    assert prefix_dict(fagg, fgroups) == want, "flat gather arm mismatch"

    # FLOAT64 -> STRING (Ryu) -> FLOAT64 (Eisel-Lemire), bit-exact
    fvals = (rng.standard_normal(64)
             * 10.0 ** rng.integers(-30, 30, 64)).astype(np.float64)
    fcol = Column.from_numpy(fvals, device=dev)
    rt = strings_mod.cast(strings_mod.cast(fcol, dt.STRING), dt.FLOAT64)
    assert np.array_equal(rt.to_numpy().view(np.uint64),
                          fvals.view(np.uint64)), (
        "ryu/eisel-lemire cast round-trip not bit-exact")

    # one mesh TPC-DS query step: q5 (scan -> join -> agg DAG) over the
    # mesh against its single-device result
    from .tpcds import datagen, queries

    tpcds_tables = datagen.generate(400, seed=3, device=dev)
    single = queries.q5(tpcds_tables)
    padded, q5_counts, q5_ov = queries.q5_distributed(tpcds_tables, mesh)
    assert int(q5_ov.max()) <= 0, "q5 mesh overflow"
    dist = queries.unpad_groupby(padded, q5_counts)

    def q5_to_dict(t):
        return dict(zip(t["category_id"].to_pylist(),
                        t["sum_revenue"].to_pylist()))

    sd, dd = q5_to_dict(single), q5_to_dict(dist)
    assert sd.keys() == dd.keys(), "q5 mesh category set mismatch"
    for c in sd:
        assert abs(sd[c] - dd[c]) <= 1e-6 * max(1.0, abs(sd[c])), (
            f"q5 mesh revenue mismatch cat {c}")

    print(
        f"dryrun_multichip({n_devices}) on {gpus} GPU(s)"
        f"{'' if gpus else ' (CPU shards)'}: join pairs={total}, "
        f"groups={int(g_counts.sum())}, sort rows={vals_h.shape[0]}, "
        f"broadcast pairs={int(bj_counts.sum())}, "
        f"string-key pairs={s_total}, chunked groups={int(cgroups)}, "
        f"packed groups={int(pgroups)}, packed join pairs={pj.row_count}, "
        "K4a/K4b engines ok, flat gather ok, ryu roundtrip ok, "
        f"tpcds q5 cats={len(sd)} ok")
