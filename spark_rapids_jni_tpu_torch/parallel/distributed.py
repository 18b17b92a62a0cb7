"""Distributed relational ops: shuffle, then the local capped ops on each
shard (port of ``parallel/distributed.py``).

A hash exchange co-partitions rows over the mesh, then each shard runs
the port's local capped op on its partition with padding rows masked by
occupancy. Results stay sharded (each shard owns its key range by hash),
as a Spark stage chain consumes them.

Sizing is lossless by default: exchange capacities come from the
planning pass (``shuffle.partition_counts``) and join output capacity
from a count pass. An explicit undersized capacity raises
``ShuffleOverflowError``/``JoinOverflowError``/``GroupOverflowError``
rather than dropping rows. A join exchanges each side once: the
shuffled shards serve the count pass and the materialize pass.

Every launch is a ``collective``-site replay boundary
(``tolerant.run_collective``); the overflow errors are
``faults.PermanentError``: never retried.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column, Table
from ..ops.gather import gather_table
from ..ops.groupby import GroupbyAgg, groupby_aggregate_capped
from ..ops.join import (
    inner_join_capped,
    inner_join_count,
    inner_join_from_ranges,
    left_join_capped,
    left_join_count,
    match_ranges,
    membership_mask,
)
from ..ops.partition import partition_ids_hash
from ..utils import faults, log, metrics, planstats
from .mesh import (
    SHUFFLE_AXIS, Mesh, Sharded, on_mesh, per_shard, replicate_table,
    shard_table,
)
from .shuffle import (
    _bincount,
    _ragged_impl,
    _round_capacity,
    check_overflow_compact,
    exchange_ragged,
    exchange_ragged_by_hash,
    partition_counts,
    plan_skew,
    total_recv_capacity,
    validate_on_overflow,
)
from .tolerant import run_collective


def _warn_if_recv_exceeds_hbm(cap: int, table: Table, label: str) -> None:
    """The planned per-device receive buffer against the device memory
    budget: the exchanged shard plus its sort working copy must fit, or
    the worker runs out of memory mid-exchange. A warning: the budget
    is conservative."""
    from ..utils import hbm

    est = 2 * cap * hbm.row_bytes(table)
    dev = table.columns[0].data.device if table.columns else None
    budget = hbm.budget_bytes(dev)
    log.log("INFO", "hbm", "recv_buffer_plan", label=label,
            estimated_bytes=int(est), budget_bytes=int(budget),
            fits=bool(est <= budget))
    if metrics.enabled():
        metrics.counter_add("shuffle.recv_plans")
        metrics.bytes_add("shuffle.recv_planned_bytes", int(est))
    if est > budget:
        metrics.counter_add("shuffle.recv_over_budget")
        warnings.warn(
            f"distributed {label}: planned per-device receive capacity "
            f"({cap} rows, ~{est >> 20} MiB with working set) exceeds "
            f"the per-device memory budget ({budget >> 20} MiB). Expect "
            "an out-of-memory failure; shard the input further or raise "
            "SPARK_RAPIDS_TPU_HBM_BUDGET_GB.",
            stacklevel=3)


class JoinOverflowError(faults.PermanentError):
    """A capped join produced more matches than its output capacity:
    rows would have been dropped. Raised by the host wrappers, never
    silent; never retried."""


class GroupOverflowError(faults.PermanentError):
    """A capped groupby saw more distinct keys than its segment capacity:
    groups would have been dropped. Raised by the host wrappers, never
    silent; never retried."""


def _check_groups(ngroups, seg_cap: int) -> None:
    worst = int(ngroups.max())
    if worst > seg_cap:
        raise GroupOverflowError(
            f"groups_per_device {seg_cap} undersized: a device saw "
            f"{worst} distinct keys; omit groups_per_device to auto-size")


def _local_groupby(mesh, tables, occ, by, aggs, seg_cap):
    """The capped groupby on every shard: (sharded results, (P,) group
    counts)."""
    res = per_shard(mesh, lambda s, t, o: groupby_aggregate_capped(
        t, by, aggs, num_segments=seg_cap, row_valid=o), tables, occ)
    # the JAX package's group counts are int32
    return (Sharded([a for a, _ in res], mesh),
            on_mesh([g.to(torch.int32) for _, g in res], mesh))


@metrics.traced("distributed.groupby")
def distributed_groupby(
    table: Table,
    by: Sequence[Union[int, str]],
    aggs: Sequence[GroupbyAgg],
    mesh: Mesh,
    capacity: Optional[int] = None,
    groups_per_device: Optional[int] = None,
    axis: str = SHUFFLE_AXIS,
    on_overflow: str = "raise",
):
    """Shuffle-then-aggregate GROUP BY over the mesh.

    Returns (sharded padded results, per-device group counts (P,),
    per-device shuffle overflow (P,)). Each key lives on exactly one
    device, by Spark hash partitioning. The exchange is ragged: each
    device holds ``capacity`` rows, the hottest destination's real
    total. ``capacity=None`` plans it from the counts (lossless) and
    may take the adaptive skew split; an explicit undersized
    ``capacity`` or ``groups_per_device`` raises unless
    ``on_overflow="allow"``."""
    validate_on_overflow(on_overflow)
    impl = _ragged_impl(None, mesh)
    sharded = shard_table(table, mesh, axis)
    counts = partition_counts(sharded, by, mesh, axis)
    if capacity is None:
        # adaptive skew repartitioning: a destination past
        # SKEW_SPLIT_FACTOR x the mean, with every agg decomposable,
        # salts its hot keys across k sub-partitions with a partial
        # aggregate before the exchange
        skew = plan_skew(counts)
        if skew.engaged and _skew_decomposable(table, aggs):
            return _groupby_skew_split(
                table, sharded, by, aggs, mesh, skew, axis, impl,
                on_overflow, groups_per_device)
    cap = capacity or total_recv_capacity(counts)
    _warn_if_recv_exceeds_hbm(cap, table, "groupby")
    pair_cap = _round_capacity(int(counts.max()))
    # a device can't see more groups than the rows it receives
    seg_cap = groups_per_device or cap

    def launch():
        shuffled, occ, overflow = exchange_ragged_by_hash(
            sharded, by, counts, cap, axis, impl, pair_capacity=pair_cap)
        agg, ngroups = _local_groupby(mesh, shuffled, occ, by, aggs, seg_cap)
        return agg, ngroups, overflow

    agg, ngroups, overflow = run_collective("distributed.groupby", launch)
    if on_overflow == "raise":
        check_overflow_compact(overflow, cap, "groupby")
        _check_groups(ngroups, seg_cap)
    return agg, ngroups, overflow


# aggregations whose merge is lossless AND byte-deterministic: each op
# maps to the op that combines its partials. Float sums are excluded:
# reassociating them changes the bits, and the skew path must stay
# byte-identical to the unsplit one.
_SKEW_MERGE_OPS = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def _agg_out_name(table: Table, agg: GroupbyAgg) -> str:
    """The output column name ``groupby_aggregate_capped`` assigns."""
    base = (agg.column if isinstance(agg.column, str)
            else (table.names[agg.column] if table.names
                  else f"c{agg.column}"))
    return agg.name or f"{agg.op}_{base}"


def _skew_decomposable(table: Table, aggs: Sequence[GroupbyAgg]) -> bool:
    """True when every agg splits into partial + merge without changing
    an output byte (the skew split's gate)."""
    seen = set()
    for a in aggs:
        if a.op not in _SKEW_MERGE_OPS:
            return False
        if a.op == "sum" and table.column(a.column).dtype.is_floating:
            return False
        name = _agg_out_name(table, a)
        if name in seen:
            # merge aggs address partials by name; a collision would
            # merge the wrong column
            return False
        seen.add(name)
    return True


def _groupby_skew_split(
    table: Table,
    sharded: Sharded,
    by: Sequence[Union[int, str]],
    aggs: Sequence[GroupbyAgg],
    mesh: Mesh,
    skew,
    axis: str,
    impl: str,
    on_overflow: str,
    groups_per_device: Optional[int],
):
    """Salted two-phase GROUP BY for skewed keys (the AQE skew-join split
    applied to aggregation).

    Each shard partial-aggregates its rows by ``(keys, salt)``, where
    ``salt = iota % k`` for rows bound to a hot destination (0
    otherwise), and exchanges the partials to ``(hash + salt) % P``:
    a hot key's traffic spreads over ``k`` destinations. Each device
    merges what it received by key; one more (small) exchange on
    ``hash % P`` and a final merge make every key whole on the device
    the unsplit path places it, in the same local key order and with
    the same bytes. Both exchanges are sized from their own counts."""
    num = int(mesh.shape[axis])
    nby = len(by)
    k = int(skew.k)
    hot_mask = np.zeros((num,), dtype=bool)
    for d in skew.hot:
        hot_mask[d] = True
    partial_aggs = [GroupbyAgg(a.column, a.op, name=_agg_out_name(table, a))
                    for a in aggs]
    merge_aggs = [GroupbyAgg(_agg_out_name(table, a), _SKEW_MERGE_OPS[a.op],
                             name=_agg_out_name(table, a)) for a in aggs]

    def partial(local: Table):
        """Local (key, salt) partial aggregation: the map-side combine."""
        n = local.row_count
        dev = local.columns[0].data.device
        h = partition_ids_hash(local, by, num).to(torch.int64)
        hot = torch.from_numpy(hot_mask).to(dev)
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        salt = torch.where(hot[h], iota % k, 0).to(torch.int32)
        names = (list(local.names) + ["__skew_salt__"]
                 if local.names else None)
        pt = Table(list(local.columns) + [Column(salt, dt.INT32, None)], names)
        pby = list(by) + [len(local.columns)]
        return groupby_aggregate_capped(pt, pby, partial_aggs, num_segments=n)

    def partial_side(s, local: Table):
        """A shard's partials, each row's destination ((hash(keys) +
        salt) % P) and the partials' occupancy."""
        p, pg = partial(local)
        rv = torch.arange(p.row_count, device=pg.device) < pg
        h = partition_ids_hash(p, list(range(nby)), num).to(torch.int64)
        salt = p.columns[nby].data.to(torch.int64)
        return p, torch.remainder(h + salt, num).to(torch.int32), rv

    # ---- planning pass 1: post-split counts of the partial exchange
    def count1():
        def count(s, local):
            _, dest, rv = partial_side(s, local)
            return _bincount(torch.where(rv, dest, num), num)

        return on_mesh(per_shard(mesh, count, sharded), mesh)

    counts1 = run_collective("shuffle.skew_counts", count1, site="shuffle")
    cap1 = total_recv_capacity(counts1)
    _warn_if_recv_exceeds_hbm(cap1, table, "groupby-skew")
    pair_cap1 = _round_capacity(int(counts1.max()))
    recv1 = counts1.to(torch.int64).sum(0).cpu().numpy()
    post_max = int(recv1.max()) if recv1.size else 0
    post_mean = float(recv1.mean()) if recv1.size else 0.0
    post_ratio = post_max / post_mean if post_mean > 0 else 0.0
    if metrics.enabled():
        metrics.counter_add("shuffle.skew_splits", len(skew.hot))
        metrics.gauge_set("shuffle.skew_recv_before", skew.max_recv)
        metrics.gauge_set("shuffle.skew_recv_after", post_max)
        metrics.gauge_set("shuffle.skew_post_ratio_x100",
                          int(post_ratio * 100))
    planstats.note_skew({
        "site": "distributed.groupby",
        "action": "split",
        "factor": float(skew.factor),
        "k": int(skew.k),
        "hot_destinations": [int(d) for d in skew.hot],
        "max_recv": int(skew.max_recv),
        "mean_recv": float(skew.mean_recv),
        "ratio": float(skew.ratio),
        "post_max_recv": post_max,
        "post_mean_recv": post_mean,
        "post_ratio": post_ratio,
        "devices": num,
    })

    # ---- pass 2: exchange the salted partials, merge on each device
    def pass2():
        ps = per_shard(mesh, partial_side, sharded)
        shuffled, occ, overflow = exchange_ragged(
            Sharded([p for p, _, _ in ps], mesh), [d for _, d, _ in ps],
            counts1, cap1, axis, impl, row_valid=[rv for _, _, rv in ps],
            pair_capacity=pair_cap1)

        def merge(s, t, o):
            # drop the salt: partials of one key that landed here (any
            # salt) combine into one row
            cols = list(t.columns[:nby]) + list(t.columns[nby + 1:])
            names = (list(t.names[:nby]) + list(t.names[nby + 1:])
                     if t.names else None)
            return groupby_aggregate_capped(
                Table(cols, names), list(range(nby)), merge_aggs,
                num_segments=cap1, row_valid=o)

        res = per_shard(mesh, merge, shuffled, occ)
        return (Sharded([m for m, _ in res], mesh),
                on_mesh([g.to(torch.int32) for _, g in res], mesh), overflow)

    merged, mgroups, ov1 = run_collective("shuffle.skew_exchange", pass2,
                                          site="shuffle")
    if on_overflow == "raise":
        check_overflow_compact(ov1, cap1, "skew-split groupby")

    def merged_dest(s, m_local):
        dev = m_local.columns[0].data.device
        rv = torch.arange(m_local.row_count, device=dev) < mgroups[s].to(dev)
        return partition_ids_hash(m_local, list(range(nby)), num), rv

    # ---- planning pass 2: counts of the (small) completion exchange
    def count3():
        def count(s, m_local):
            h, rv = merged_dest(s, m_local)
            return _bincount(torch.where(rv, h, num), num)

        return on_mesh(per_shard(mesh, count, merged), mesh)

    counts3 = run_collective("shuffle.skew_completion_counts", count3,
                             site="shuffle")
    cap3 = total_recv_capacity(counts3)
    pair_cap3 = _round_capacity(int(counts3.max()))
    seg_cap = groups_per_device or cap3

    # ---- pass 3: completion exchange + final merge: each key ends on
    # the device the unsplit path places it (hash % P), in the same
    # local key order, with the same bytes
    def pass3():
        dests = per_shard(mesh, merged_dest, merged)
        shuffled, occ, overflow = exchange_ragged(
            merged, [h for h, _ in dests], counts3, cap3, axis, impl,
            row_valid=[rv for _, rv in dests], pair_capacity=pair_cap3)
        agg, ngroups = _local_groupby(mesh, shuffled, occ,
                                      list(range(nby)), merge_aggs, seg_cap)
        return agg, ngroups, overflow

    agg, ngroups, ov2 = run_collective("shuffle.skew_completion", pass3,
                                       site="shuffle")
    if on_overflow == "raise":
        check_overflow_compact(ov2, cap3, "skew-split groupby completion")
        _check_groups(ngroups, seg_cap)
    return agg, ngroups, ov2


@metrics.traced("distributed.inner_join")
def distributed_inner_join(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    mesh: Mesh,
    capacity: Optional[int] = None,
    out_capacity: Optional[int] = None,
    axis: str = SHUFFLE_AXIS,
    on_overflow: str = "raise",
):
    """Shuffle-shuffle hash-partitioned inner join over the mesh: both
    sides hash-exchanged on the keys, then each shard joins its
    partitions. Returns (sharded padded output, per-device match counts,
    left/right shuffle overflows). ``capacity=None`` plans both
    exchanges exactly; ``out_capacity=None`` counts the matches on the
    co-partitioned shards and sizes the output to the real per-device
    maximum. Each side is exchanged once."""
    return _shuffle_join(
        left, right, on, mesh, capacity, out_capacity, axis, on_overflow,
        inner_join_count, inner_join_capped, "join")


def _shuffle_join(left, right, on, mesh, capacity, out_capacity, axis,
                  on_overflow, count_fn, capped_fn, label: str):
    """The shuffle joins' shared body: co-partition (the count pass
    rides the exchange), size the output, run the local capped join per
    shard, check overflow."""
    validate_on_overflow(on_overflow)
    count_pass = out_capacity is None
    ls, locc, lov, rs, rocc, rov, cnts = _co_partition(
        left, right, on, mesh, capacity, axis, on_overflow,
        count_fn=((lambda ls, locc, rs, rocc: count_fn(
            ls, rs, on, left_valid=locc, right_valid=rocc))
            if count_pass else None))
    ocap = _round_capacity(int(cnts.max())) if count_pass else out_capacity

    def launch():
        res = per_shard(mesh, lambda s, lt, lo, rt, ro: capped_fn(
            lt, rt, on, capacity=ocap, left_valid=lo, right_valid=ro),
            ls, locc, rs, rocc)
        return (Sharded([o for o, _ in res], mesh),
                on_mesh([c for _, c in res], mesh))

    out, count = run_collective(f"distributed.{label}", launch)
    if on_overflow == "raise":
        worst = int(count.max())
        if worst > ocap:
            raise JoinOverflowError(
                f"{label} output capacity {ocap} undersized: a device "
                f"produced {worst} rows; pass out_capacity=None to "
                "auto-size")
    return out, count, lov, rov


def _co_partition(left, right, on, mesh, capacity, axis, on_overflow,
                  count_fn=None):
    """The shuffle joins' exchange: both sides hash-exchanged on the join
    keys, each once. ``count_fn(ls, locc, rs, rocc)`` rides the same
    launch (the inner join's sizing pass); its per-device results come
    back last."""
    impl = _ragged_impl(None, mesh)
    lsh = shard_table(left, mesh, axis)
    rsh = shard_table(right, mesh, axis)
    lcounts = partition_counts(lsh, on, mesh, axis)
    rcounts = partition_counts(rsh, on, mesh, axis)
    lcap = capacity or total_recv_capacity(lcounts)
    rcap = capacity or total_recv_capacity(rcounts)
    lpair = _round_capacity(int(lcounts.max()))
    rpair = _round_capacity(int(rcounts.max()))

    def launch():
        ls, locc, lov = exchange_ragged_by_hash(
            lsh, on, lcounts, lcap, axis, impl, pair_capacity=lpair)
        rs, rocc, rov = exchange_ragged_by_hash(
            rsh, on, rcounts, rcap, axis, impl, pair_capacity=rpair)
        if count_fn is not None:
            cnt = on_mesh(per_shard(
                mesh, lambda s, a, b, c, d: count_fn(a, b, c, d),
                ls, locc, rs, rocc), mesh)
        else:
            cnt = torch.zeros((mesh.size,), dtype=torch.int64,
                              device=mesh.devices[0])
        return ls, locc, lov, rs, rocc, rov, cnt

    out = run_collective("distributed.co_partition", launch)
    if on_overflow == "raise":
        check_overflow_compact(out[2], lcap, "left side")
        check_overflow_compact(out[5], rcap, "right side")
    return out


@metrics.traced("distributed.left_join")
def distributed_left_join(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    mesh: Mesh,
    capacity: Optional[int] = None,
    out_capacity: Optional[int] = None,
    axis: str = SHUFFLE_AXIS,
    on_overflow: str = "raise",
):
    """Shuffle-shuffle LEFT OUTER join over the mesh: co-partition both
    sides, then each shard left-joins its partitions (every valid left
    row emits at least once). Two-phase sizing like
    :func:`distributed_inner_join`. Returns (sharded padded output,
    per-device row counts, left/right shuffle overflows)."""
    return _shuffle_join(
        left, right, on, mesh, capacity, out_capacity, axis, on_overflow,
        left_join_count, left_join_capped, "left join")


def _distributed_membership_join(left, right, on, mesh, capacity, axis,
                                 on_overflow, anti: bool):
    validate_on_overflow(on_overflow)
    ls, locc, lov, rs, rocc, rov, _ = _co_partition(
        left, right, on, mesh, capacity, axis, on_overflow)

    def body(s, lt, lo, rt, ro):
        member = membership_mask(lt, rt, on, left_valid=lo, right_valid=ro)
        return lo & (~member if anti else member)

    occ = run_collective(
        "distributed.membership",
        lambda: Sharded(per_shard(mesh, body, ls, locc, rs, rocc), mesh))
    return ls, occ, lov, rov


@metrics.traced("distributed.semi_join")
def distributed_semi_join(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    mesh: Mesh,
    capacity: Optional[int] = None,
    axis: str = SHUFFLE_AXIS,
    on_overflow: str = "raise",
):
    """Distributed LEFT SEMI join: co-partition, then mark each left row
    with membership. Returns (sharded left shards, occupancy of the
    surviving rows, left/right shuffle overflows): rows stay in place and
    the occupancy is the result."""
    return _distributed_membership_join(
        left, right, on, mesh, capacity, axis, on_overflow, anti=False)


@metrics.traced("distributed.anti_join")
def distributed_anti_join(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    mesh: Mesh,
    capacity: Optional[int] = None,
    axis: str = SHUFFLE_AXIS,
    on_overflow: str = "raise",
):
    """Distributed LEFT ANTI join (the rows of left with no match)."""
    return _distributed_membership_join(
        left, right, on, mesh, capacity, axis, on_overflow, anti=True)


@metrics.traced("distributed.distinct")
def distributed_distinct(
    table: Table,
    keys: Optional[Sequence[Union[int, str]]] = None,
    mesh: Mesh = None,
    capacity: Optional[int] = None,
    axis: str = SHUFFLE_AXIS,
    on_overflow: str = "raise",
):
    """Distributed DISTINCT: hash-exchange by the key columns so every
    duplicate lands on one device, then a local groupby with no
    aggregations. Returns (sharded padded key tables, per-device distinct
    counts, shuffle overflow)."""
    if mesh is None:
        raise TypeError(
            "distributed_distinct: mesh is required "
            "(keys defaults to all columns, mesh does not default)")
    if keys is None:
        keys = (list(table.names) if table.names is not None
                else list(range(table.num_columns)))
    return distributed_groupby(table, keys, [], mesh, capacity=capacity,
                               axis=axis, on_overflow=on_overflow)


@metrics.traced("distributed.broadcast_join")
def broadcast_inner_join(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    mesh: Mesh,
    out_capacity: Optional[int] = None,
    axis: str = SHUFFLE_AXIS,
    on_overflow: str = "raise",
):
    """Broadcast-hash inner join: the small (dimension) side is copied to
    every device and the big side stays sharded in place, with no
    exchange of it. ``out_capacity=None`` sizes the output from a count
    pass, whose match ranges the materialize pass reuses. Returns
    (sharded padded output, per-device match counts)."""
    validate_on_overflow(on_overflow)
    lsh = shard_table(left, mesh, axis)
    rrep = replicate_table(right, mesh)
    on_l = list(on)
    if out_capacity is None:
        def count():
            ranges = per_shard(mesh, lambda s, lt, rt: match_ranges(
                lt, rt, on_l, on_l), lsh, rrep)
            return ranges, on_mesh([c.sum() for _, _, c in ranges], mesh)

        ranges, cnts = run_collective("distributed.broadcast_count", count)
        ocap = _round_capacity(int(cnts.max()))

        def body(s, lt, rt, rg):
            perm_r, lo, counts = rg
            return inner_join_from_ranges(lt, rt, on_l, perm_r, lo, counts,
                                          ocap)

        def launch():
            return per_shard(mesh, body, lsh, rrep, ranges)
    else:
        ocap = out_capacity

        def launch():
            return per_shard(mesh, lambda s, lt, rt: inner_join_capped(
                lt, rt, on, capacity=ocap), lsh, rrep)

    res = run_collective("distributed.broadcast_join", launch)
    out = Sharded([o for o, _ in res], mesh)
    count = on_mesh([c for _, c in res], mesh)
    if on_overflow == "raise":
        worst = int(count.max())
        if worst > ocap:
            raise JoinOverflowError(
                f"broadcast join output capacity {ocap} undersized: a "
                f"device produced {worst} matches; pass "
                "out_capacity=None to auto-size")
    return out, count


@metrics.traced("distributed.sort")
def distributed_sort(
    table: Table,
    sort_keys,
    mesh: Mesh,
    capacity: Optional[int] = None,
    sample_size: int = 8192,
    axis: str = SHUFFLE_AXIS,
    on_overflow: str = "raise",
):
    """Distributed ORDER BY: sample -> range partition -> local sort.

    P-1 splitters come from a deterministic host sample of the sort-key
    order words; every row is range-partitioned to the device owning
    its key range (ragged exchange), and each device sorts its range.
    Reading the devices in mesh order (valid prefixes, by the occupancy)
    gives the total order. Returns (sharded sorted padded tables,
    occupancy, overflow)."""
    from ..ops.sort import SortKey, _key_words, lexsort, sort_table

    validate_on_overflow(on_overflow)
    impl = _ragged_impl(None, mesh)
    num = int(mesh.shape[axis])
    sort_keys = [k if isinstance(k, SortKey) else SortKey(k)
                 for k in sort_keys]
    if num == 1:
        # one device: the range partition is trivial, a local sort
        out = shard_table(sort_table(table, sort_keys), mesh, axis)
        dev = mesh.devices[0]
        occ = torch.ones((table.row_count,), dtype=torch.bool, device=dev)
        return (out, Sharded([occ], mesh),
                torch.zeros((1,), dtype=torch.int64, device=dev))
    sharded = shard_table(table, mesh, axis)

    # splitters from a deterministic host sample of the key words
    words = []
    for k in sort_keys:
        words.extend(_key_words(table.column(k.column), k))
    n = table.row_count
    stride = max(n // max(sample_size, 1), 1)
    samp = [w[::stride].cpu().numpy() for w in words]
    order = np.lexsort(samp[::-1])
    m = order.shape[0]
    cut = [order[(i * m) // num] for i in range(1, num)]
    splitters = [np.stack([s[c] for c in cut]) for s in samp]

    def dest_of(s, local: Table):
        dev = local.columns[0].data.device
        lwords = []
        for k in sort_keys:
            lwords.extend(_key_words(local.column(k.column), k))
        sp = [torch.from_numpy(x).to(dev) for x in splitters]
        nloc = local.row_count
        # partition id = number of splitters <= key (lexicographic)
        dest = torch.zeros((nloc,), dtype=torch.int32, device=dev)
        for i in range(num - 1):
            le = torch.zeros((nloc,), dtype=torch.bool, device=dev)
            eq = torch.ones((nloc,), dtype=torch.bool, device=dev)
            for w, spw in zip(lwords, sp):
                sv = spw[i]
                le = le | (eq & (sv < w))
                eq = eq & (sv == w)
            dest = dest + (le | eq).to(torch.int32)
        return dest

    # planning pass: per-(src, dst) counts under the range partitioning
    counts = run_collective(
        "distributed.sort_counts",
        lambda: on_mesh([_bincount(d, num)
                         for d in per_shard(mesh, dest_of, sharded)], mesh))
    cap = capacity or total_recv_capacity(counts)
    _warn_if_recv_exceeds_hbm(cap, table, "sort")
    pair_cap = _round_capacity(int(counts.max()))

    def local_sort(s, t, occ):
        # padding rows (occupancy False) sort last
        swords = [(~occ).to(torch.uint8)]
        for k in sort_keys:
            swords.extend(_key_words(t.column(k.column), k))
        perm = lexsort(swords)
        return gather_table(t, perm), occ[perm]

    def launch():
        dests = per_shard(mesh, dest_of, sharded)
        shuffled, occ, overflow = exchange_ragged(
            sharded, dests, counts, cap, axis, impl, pair_capacity=pair_cap)
        res = per_shard(mesh, local_sort, shuffled, occ)
        return (Sharded([t for t, _ in res], mesh),
                Sharded([o for _, o in res], mesh), overflow)

    out, occ, overflow = run_collective("distributed.sort", launch)
    if on_overflow == "raise":
        check_overflow_compact(overflow, cap, "distributed sort")
    return out, occ, overflow
