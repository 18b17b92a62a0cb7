"""Shuffle exchange over a mesh (port of ``parallel/shuffle.py``): the
replacement of the RAPIDS UCX/NCCL shuffle manager.

A JAX ``shard_map`` body that calls a collective in its middle runs here
as three phases: a per-shard function on each shard's device, the
collective (``mesh.all_to_all``), and a per-shard function again. Each
device buckets its rows by Spark-compatible partition id
(pmod(murmur3), K5 on CUDA), packs them per destination and the
all-to-all moves every bucket to its owner; received padding is tracked
by an occupancy mask.

Two exchange forms, with the JAX package's bytes:

* :func:`exchange` — a fixed capacity per (src, dst) pair. Its slots
  gather with clipped indices, so an unoccupied slot holds a real row's
  bytes, as in JAX.
* :func:`exchange_ragged` — each receiver gets exactly its rows,
  ``[src-0 rows | src-1 rows | ...]`` then a zeroed tail behind the
  occupancy. ``ragged`` moves each (src, dst) pair's rows as slices of
  the stably sorted shard (one host read of the (P, P) counts);
  ``dense_compact`` is the per-pair-capacity form compacted on the
  receiver. Both give the same bytes; ``_ragged_impl(None)`` takes
  ``ragged`` on CUDA and ``dense_compact`` on the CPU.

The host wrappers (:func:`shuffle_table`, :func:`shuffle_table_compact`)
plan capacity from the real counts (lossless), raise
``ShuffleOverflowError`` on an explicit undersized capacity, and run
every launch through ``tolerant.run_collective``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..column import Table
from ..ops.gather import gather_table
from ..ops.partition import partition_ids_hash
from ..utils import config, faults, flight, metrics, profiler
from .mesh import (
    SHUFFLE_AXIS, Mesh, Sharded, all_to_all, map_tensors, on_mesh,
    per_shard, shard_table,
)
from .tolerant import run_collective


class ShuffleOverflowError(faults.PermanentError):
    """An exchange received more rows for a (src, dst) pair than its
    capacity: rows would have been dropped. Raised by the host wrappers,
    never silent. A ``faults.PermanentError``: a replay at the same
    capacity overflows the same way, so it is never retried."""


def validate_on_overflow(on_overflow: str) -> None:
    """A typo must not silently disable overflow detection."""
    if on_overflow not in ("raise", "allow"):
        raise ValueError(
            f"on_overflow must be 'raise' or 'allow', got {on_overflow!r}")


def check_overflow(
    overflow,
    capacity: int,
    what: str,
    unit: str = "rows per (src, dst) pair",
    remedy: str = "pass capacity=None to auto-plan",
) -> None:
    """Raise ``ShuffleOverflowError`` if any device reported overflow."""
    worst = int(overflow.max())
    if worst > 0:
        raise ShuffleOverflowError(
            f"{what} exchange capacity {capacity} undersized by {worst} "
            f"{unit}; {remedy}")


def check_overflow_compact(overflow, out_size: int, what: str) -> None:
    """Overflow check of the ragged exchange, whose capacity is the TOTAL
    per-device receive buffer."""
    check_overflow(
        overflow, out_size, what,
        unit="rows in the per-device receive buffer",
        remedy="pass out_size=None / capacity=None to auto-plan")


def _bincount(dest: torch.Tensor, length: int) -> torch.Tensor:
    """``jnp.bincount(dest, length=length)`` of int ids in [0, length]
    (an id of ``length`` is dropped), as int32."""
    return torch.bincount(dest.to(torch.int64),
                          minlength=length + 1)[:length].to(torch.int32)


def partition_counts(
    sharded: Sharded,
    columns: Optional[Sequence[Union[int, str]]],
    mesh: Mesh,
    axis: str = SHUFFLE_AXIS,
) -> torch.Tensor:
    """(num, num) per-(src, dst) row counts — the shuffle planning pass.
    Row [s, d] is how many of source s's rows hash to partition d."""
    num = int(mesh.shape[axis])

    def launch():
        rows = per_shard(mesh, lambda s, local: _bincount(
            partition_ids_hash(local, columns, num), num), sharded)
        return on_mesh(rows, mesh)

    # the counts matrix is the lineage of everything downstream: its
    # launch gets the same replay boundary as the exchange itself
    return run_collective("shuffle.partition_counts", launch, site="shuffle")


def _round_capacity(exact: int) -> int:
    """A planned capacity rounded up to the next power of two (min 16),
    so repeated shuffles of similar volume share shapes."""
    cap = 16
    while cap < exact:
        cap *= 2
    return cap


def plan_capacity(
    sharded: Sharded,
    columns: Optional[Sequence[Union[int, str]]],
    mesh: Mesh,
    axis: str = SHUFFLE_AXIS,
) -> int:
    """The overflow-free exchange capacity of ``sharded`` (one host
    read)."""
    with metrics.span("shuffle.plan"):
        counts = partition_counts(sharded, columns, mesh, axis)
        cap = _round_capacity(int(counts.max()))
    if metrics.enabled():
        metrics.counter_add("shuffle.plans")
        metrics.gauge_set("shuffle.pair_capacity", cap)
    return cap


def _send_order(dest: torch.Tensor, row_valid, num: int):
    """(int32 destinations with every ``row_valid`` False row sent to
    bucket ``num``, past every real partition; their stable order)."""
    dest = dest.to(torch.int32)
    if row_valid is not None:
        dest = torch.where(row_valid, dest, num)
    return dest, torch.sort(dest, stable=True).indices


def exchange(
    local: Sharded,
    dest: Sequence[torch.Tensor],
    num_partitions: int,
    capacity: int,
    axis: str = SHUFFLE_AXIS,
    row_valid: Optional[Sequence[torch.Tensor]] = None,
):
    """All-to-all each shard's rows to their destination partitions
    (``dest``: one id tensor a shard; the mesh's size is
    ``num_partitions``). Returns (received tables of ``num_partitions *
    capacity`` rows, occupancy, overflow (P,)): rows past ``capacity``
    per (src, dst) pair are dropped, and ``overflow`` (max per-dest count
    less the capacity, per sender) says so."""
    mesh = local.mesh
    num = num_partitions

    def send(s, t, d, rv):
        n = t.row_count
        dev = d.device
        d, order = _send_order(d, rv, num)
        counts = _bincount(d, num)
        start = torch.cumsum(counts, 0) - counts
        j = torch.arange(capacity, dtype=torch.int64, device=dev)
        flat = (start[:, None] + j[None, :]).clamp(0, max(n - 1, 0))
        idx = order[flat]  # (P, cap) source row of each slot
        valid = j[None, :] < counts[:, None].clamp(max=capacity)
        blocks = [map_tensors(t, lambda x, r=idx[p]: x[r]) for p in range(num)]
        return blocks, [valid[p] for p in range(num)], counts.max() - capacity

    sent = per_shard(mesh, send, local, dest, row_valid)
    out = all_to_all([b for b, _, _ in sent], mesh)
    occ = all_to_all([v for _, v, _ in sent], mesh)
    return (Sharded(out, mesh), Sharded(occ, mesh),
            on_mesh([o for _, _, o in sent], mesh))


def exchange_by_hash(
    local: Sharded,
    columns: Optional[Sequence[Union[int, str]]],
    num_partitions: int,
    capacity: int,
    axis: str = SHUFFLE_AXIS,
    row_valid: Optional[Sequence[torch.Tensor]] = None,
):
    """:func:`exchange` keyed by Spark hash partitioning of ``columns``."""
    dest = per_shard(local.mesh, lambda s, t: partition_ids_hash(
        t, columns, num_partitions), local)
    return exchange(local, dest, num_partitions, capacity, axis, row_valid)


def total_recv_capacity(counts) -> int:
    """Per-device buffer of the ragged exchange: the largest destination's
    TOTAL received rows (one host read), rounded. The floor under one
    shape for every device: the hottest destination's real total, not
    num_partitions x the hottest pair."""
    cap = _round_capacity(int(counts.to(torch.int64).sum(0).max()))
    if metrics.enabled():
        metrics.counter_add("shuffle.plans")
        metrics.gauge_set("shuffle.recv_capacity", cap)
    return cap


class SkewPlan:
    """The adaptive-skew decision from the planning counts.

    ``engaged`` means at least one destination's planned received total
    passes ``factor x`` the mean (Spark AQE's skew-join-split signal).
    ``k`` is the salt fan-out: hot keys spread over ``k``
    sub-partitions, each carrying about a mean destination's rows."""

    __slots__ = ("engaged", "factor", "k", "hot", "max_recv", "mean_recv")

    def __init__(self, engaged, factor, k, hot, max_recv, mean_recv):
        self.engaged = engaged
        self.factor = factor
        self.k = k
        self.hot = tuple(hot)
        self.max_recv = max_recv
        self.mean_recv = mean_recv

    @property
    def ratio(self) -> float:
        return self.max_recv / self.mean_recv if self.mean_recv > 0 else 0.0

    def to_doc(self) -> dict:
        return {
            "engaged": self.engaged,
            "factor": self.factor,
            "k": self.k,
            "hot_destinations": list(self.hot),
            "max_recv": self.max_recv,
            "mean_recv": self.mean_recv,
            "ratio": self.ratio,
        }


def plan_skew(counts, factor: Optional[float] = None) -> SkewPlan:
    """Skew decision of a planned exchange (one host read). Destinations
    whose planned totals (column sums of the (P, P) counts) pass
    ``factor x`` the mean are hot; ``factor`` defaults to the
    ``SKEW_SPLIT_FACTOR`` flag, and ``SKEW_SPLIT`` gates it all."""
    if factor is None:
        factor = float(config.get_flag("SKEW_SPLIT_FACTOR"))
    raw = config.get_flag("SKEW_SPLIT")
    split_on = config._as_bool(raw) if isinstance(raw, str) else bool(raw)
    recv = counts.to(torch.int64).sum(0).cpu().numpy()
    num = int(recv.shape[0])
    total = int(recv.sum())
    max_recv = int(recv.max()) if recv.size else 0
    mean = total / num if num else 0.0
    if not split_on or num < 2 or total == 0:
        return SkewPlan(False, factor, 1, (), max_recv, mean)
    hot = [int(d) for d in np.nonzero(recv > factor * mean)[0]]
    if not hot:
        return SkewPlan(False, factor, 1, (), max_recv, mean)
    k = int(min(num, max(2, -(-max_recv // max(int(mean), 1)))))
    if metrics.enabled():
        metrics.gauge_set("shuffle.skew_k", k)
        metrics.gauge_set("shuffle.skew_hot_destinations", len(hot))
    return SkewPlan(True, factor, k, hot, max_recv, mean)


def _ragged_impl(impl: Optional[str], mesh: Optional[Mesh] = None) -> str:
    """The exchange form: ``impl`` where given, else ``ragged`` for a
    mesh of CUDA devices and ``dense_compact`` on the CPU (the JAX
    package's TPU/CPU split)."""
    if impl is not None:
        if impl not in ("ragged", "dense_compact"):
            raise ValueError(f"unknown exchange impl {impl!r}")
        return impl
    cuda = (all(d.type == "cuda" for d in mesh.devices) if mesh is not None
            else torch.cuda.is_available())
    return "ragged" if cuda else "dense_compact"


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` zero-extended to ``rows`` rows."""
    if x.shape[0] == rows:
        return x
    pad = x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad])


def exchange_ragged(
    local: Sharded,
    dest: Sequence[torch.Tensor],
    counts: torch.Tensor,
    out_size: int,
    axis: str = SHUFFLE_AXIS,
    impl: str = "dense_compact",
    row_valid: Optional[Sequence[torch.Tensor]] = None,
    pair_capacity: Optional[int] = None,
):
    """Compact all-to-all: each device receives exactly its real rows.

    ``counts`` is the (P, P) per-(src, dst) matrix of
    :func:`partition_counts` (of these ``dest`` ids, ``row_valid`` rows
    only). The received layout is ``[src-0 rows | src-1 rows | ...]``
    with the padding zeroed at the tail, ``out_size`` rows a device
    (:func:`total_recv_capacity`). Returns (tables, occupancy, overflow
    (P,) = rows received past ``out_size``)."""
    mesh = local.mesh
    num = int(counts.shape[0])
    if impl not in ("ragged", "dense_compact"):
        raise ValueError(f"unknown exchange impl {impl!r}")

    orders = per_shard(mesh, lambda s, t, d, rv: _send_order(d, rv, num)[1],
                       local, dest, row_valid)
    if impl == "ragged":
        return _ragged(local, orders, counts, out_size, mesh)
    return _dense_compact(local, orders, counts, out_size, mesh,
                          pair_capacity)


def _ragged(local: Sharded, orders, counts, out_size: int, mesh: Mesh):
    """Each (src, dst) pair's rows as one slice of the stably sorted
    shard, clamped so an undersized ``out_size`` never writes past the
    buffer (the dropped tail shows in the overflow)."""
    C = counts.to(torch.int64).cpu().numpy()  # the one host read
    num = C.shape[0]
    in_off = np.cumsum(C, axis=1) - C  # sender s's block d starts here
    out_off = np.cumsum(C, axis=0) - C  # receiver d places sender s here
    off_c = np.minimum(out_off, out_size)
    send_c = np.minimum(C, np.maximum(out_size - off_c, 0))

    def send(s, t, order):
        csort = gather_table(t, order)
        return [map_tensors(csort, lambda x, a=int(in_off[s, d]),
                            b=int(in_off[s, d] + send_c[s, d]): x[a:b])
                for d in range(num)]

    blocks = per_shard(mesh, send, local, orders)
    got = all_to_all(blocks, mesh)
    n_recv = C.sum(axis=0)

    def finish(d, t):
        dev = mesh.devices[d]
        occ = torch.arange(out_size, device=dev) < int(n_recv[d])
        return map_tensors(t, lambda x: _pad_rows(x, out_size)), occ

    done = per_shard(mesh, finish, got)
    overflow = torch.from_numpy((n_recv - out_size).astype(np.int64))
    return (Sharded([t for t, _ in done], mesh),
            Sharded([o for _, o in done], mesh),
            overflow.to(mesh.devices[0]))


def _dense_compact(local: Sharded, orders, counts, out_size: int, mesh: Mesh,
                   pair_capacity: Optional[int]):
    """A uniform all-to-all at the per-pair capacity, then a compaction
    on the receiver to the ragged layout. The slot grid (num x pair_cap)
    may be smaller than ``out_size``: its index is padded, and the tail
    zeroed by the occupancy."""
    num = int(counts.shape[0])
    pair_cap = min(pair_capacity or out_size, out_size)

    def send(s, t, order):
        n = t.row_count
        dev = order.device
        C = counts.to(dev).to(torch.int64)
        send_sizes = C[s]
        start = torch.cumsum(send_sizes, 0) - send_sizes
        j = torch.arange(pair_cap, dtype=torch.int64, device=dev)
        flat = (start[:, None] + j[None, :]).clamp(0, max(n - 1, 0))
        idx = order[flat]
        valid = j[None, :] < send_sizes[:, None].clamp(max=pair_cap)
        return ([map_tensors(t, lambda x, r=idx[p]: x[r]) for p in range(num)],
                [valid[p] for p in range(num)])

    sent = per_shard(mesh, send, local, orders)
    got = all_to_all([b for b, _ in sent], mesh)
    got_valid = all_to_all([v for _, v in sent], mesh)
    slots = num * pair_cap

    def finish(d, t, flat_valid):
        dev = flat_valid.device
        C = counts.to(dev).to(torch.int64)
        n_recv = C[:, d].sum()
        comp = torch.sort((~flat_valid).to(torch.uint8), stable=True).indices
        comp = (_pad_rows(comp, out_size) if slots < out_size
                else comp[:out_size])
        occ = torch.arange(out_size, device=dev) < n_recv

        def compact(x):
            g = x[comp]
            m = occ.reshape((out_size,) + (1,) * (g.dim() - 1))
            return torch.where(m, g, torch.zeros_like(g))

        return map_tensors(t, compact), occ, n_recv - out_size

    done = per_shard(mesh, finish, got, got_valid)
    return (Sharded([t for t, _, _ in done], mesh),
            Sharded([o for _, o, _ in done], mesh),
            on_mesh([v for _, _, v in done], mesh))


def exchange_ragged_by_hash(
    local: Sharded,
    columns: Optional[Sequence[Union[int, str]]],
    counts: torch.Tensor,
    out_size: int,
    axis: str = SHUFFLE_AXIS,
    impl: str = "dense_compact",
    row_valid: Optional[Sequence[torch.Tensor]] = None,
    pair_capacity: Optional[int] = None,
):
    """:func:`exchange_ragged` keyed by Spark hash partitioning."""
    num = int(counts.shape[0])
    dest = per_shard(local.mesh, lambda s, t: partition_ids_hash(
        t, columns, num), local)
    return exchange_ragged(local, dest, counts, out_size, axis, impl,
                           row_valid, pair_capacity)


@metrics.traced("shuffle.table_compact")
def shuffle_table_compact(
    table: Table,
    columns: Optional[Sequence[Union[int, str]]],
    mesh: Mesh,
    out_size: Optional[int] = None,
    axis: str = SHUFFLE_AXIS,
    impl: Optional[str] = None,
    on_overflow: str = "raise",
    donate_input: bool = False,
):
    """Host-level compact shuffle: plan the counts, ragged-exchange the
    rows. Each device's buffer is ``out_size`` rows (by default the
    hottest destination's real total, rounded). Returns (sharded tables,
    occupancy, overflow (P,)). The exchange launch is a ``shuffle``-site
    replay boundary; ``donate_input=True`` makes it at-most-once."""
    metrics.counter_add("shuffle.exchanges")
    metrics.counter_add("shuffle.rows_exchanged", table.row_count)
    profiler.note_shuffle(table.row_count)
    if flight.enabled():
        flight.record("I", "shuffle.exchange", table.row_count)
    validate_on_overflow(on_overflow)
    impl = _ragged_impl(impl, mesh)
    sharded = shard_table(table, mesh, axis)
    counts = partition_counts(sharded, columns, mesh, axis)
    size = out_size or total_recv_capacity(counts)
    pair_cap = _round_capacity(int(counts.max()))
    out, occ, overflow = run_collective(
        "shuffle.table_compact",
        lambda: exchange_ragged_by_hash(sharded, columns, counts, size, axis,
                                        impl, pair_capacity=pair_cap),
        site="shuffle", donated=donate_input)
    if on_overflow == "raise":
        check_overflow_compact(overflow, size, "compact shuffle")
    return out, occ, overflow


@metrics.traced("shuffle.table")
def shuffle_table(
    table: Table,
    columns: Optional[Sequence[Union[int, str]]],
    mesh: Mesh,
    capacity: Optional[int] = None,
    axis: str = SHUFFLE_AXIS,
    on_overflow: str = "raise",
    donate_input: bool = False,
):
    """Host-level shuffle: row-shard ``table`` and hash-exchange it.
    Returns (sharded padded tables, occupancy, overflow (P,)).
    ``capacity=None`` plans it exactly from the counts; an explicit
    undersized one raises ``ShuffleOverflowError`` (``on_overflow=
    "allow"`` leaves the check to the caller). The exchange launch is a
    ``shuffle``-site replay boundary; ``donate_input=True`` makes it
    at-most-once."""
    metrics.counter_add("shuffle.exchanges")
    metrics.counter_add("shuffle.rows_exchanged", table.row_count)
    profiler.note_shuffle(table.row_count)
    if flight.enabled():
        flight.record("I", "shuffle.exchange", table.row_count)
    validate_on_overflow(on_overflow)
    num = int(mesh.shape[axis])
    sharded = shard_table(table, mesh, axis)
    if capacity is None:
        capacity = plan_capacity(sharded, columns, mesh, axis)
    out, occ, overflow = run_collective(
        "shuffle.table",
        lambda: exchange_by_hash(sharded, columns, num, capacity, axis),
        site="shuffle", donated=donate_input)
    if on_overflow == "raise":
        check_overflow(overflow, capacity, "shuffle")
    return out, occ, overflow
