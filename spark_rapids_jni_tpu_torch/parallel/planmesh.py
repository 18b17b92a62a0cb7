"""Plans over the mesh for row-local segments (port of
``parallel/planmesh.py``).

``run_plan_mesh`` runs a plan whose every op is row-local (``cast``,
``filter``, ``rlike``: ``plan._ROW_LOCAL``) as one stage of a
:class:`~.tolerant.MeshRunner`: the rows split into contiguous blocks,
one a device, each shard runs the fused segment body of the
single-device path (``plan._run_segment_traced``), and the host gathers
each shard's valid prefix back in mesh order.

A plan may carry ONE ``partition`` op (``plan._EXCHANGE_OPS``) anywhere
in its chain: the scan-side chain, a counts pass, a ragged all-to-all,
a stable sort back into partition order on each device and the
merge-side chain then run as one stage. The exchange launches are
``shuffle``-site replay boundaries inside it.

Parity contract: row-local ops neither reorder rows nor look across
them, so the block-sharded run and the in-order prefix gather give the
single-device result byte for byte, at any mesh size. The partition
boundary keeps it: device ``d`` takes the contiguous pid range
``[d*num//size, (d+1)*num//size)`` (monotonic in pid), rows travel in
stable (src, in-src) order, and each device stable-sorts its received
prefix by pid, so it holds the ``d``-th slice of the exact path's
reordered table. That independence of the mesh size makes the
degradation ladder safe: a replay on fewer devices re-derives layout,
counts and capacities from the untouched input and the bytes do not
change.

Anything else (rest tables, a non-row-local op, two partition
boundaries, an empty table) raises :class:`MeshUnsupported`, and
``plan.run_plan`` runs the single-device path.

``run_plan_mesh_stream`` drives a sequence of batches through one plan,
staging batch N+1's pack and counts pass on the pipeline's workers
(``pipeline.stage_ahead``) while batch N's exchange runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..column import Table
from ..ops.gather import gather_table
from ..utils import metrics
from .mesh import Sharded, map_tensors, on_mesh, per_shard, shard_table
from .tolerant import MeshRunner, run_collective


class MeshUnsupported(Exception):
    """This plan or input has no mesh path; use the exact path."""


def _split_at_exchange(ops: Sequence[dict]):
    """``(pre_ops, partition_op | None, post_ops)``: the plan split at its
    one exchange boundary."""
    from .. import plan as plan_mod

    idx = [i for i, o in enumerate(ops)
           if o.get("op") in plan_mod._EXCHANGE_OPS]
    if not idx:
        return list(ops), None, []
    if len(idx) > 1:
        raise MeshUnsupported(
            "mesh path handles one partition boundary per plan; "
            f"got {len(idx)}")
    i = idx[0]
    return list(ops[:i]), ops[i], list(ops[i + 1:])


def _check_supported(ops: Sequence[dict], table: Table,
                     rest: Sequence[Table]):
    from .. import plan as plan_mod

    if rest:
        raise MeshUnsupported("mesh plan path takes no rest tables")
    if not ops:
        raise MeshUnsupported("empty plan")
    if not table.columns or table.logical_row_count == 0:
        raise MeshUnsupported("empty table")
    pre, part, post = _split_at_exchange(ops)
    for op in (*pre, *post):
        name = op.get("op")
        if name not in plan_mod._ROW_LOCAL:
            raise MeshUnsupported(
                f"op {name!r} is not row-local; mesh path handles "
                f"{sorted(plan_mod._ROW_LOCAL)} chains (around one "
                "optional partition boundary) only")
    if part is not None and part.get("kind", "hash") == "range" and pre:
        # range splitters are sampled from the exchange input, which
        # with a scan-side chain exists only per shard mid-stage
        raise MeshUnsupported(
            "range partition needs an empty scan-side chain: splitters "
            "are sampled from the full exchange input")
    return pre, part, post


def _pack_sharded(table: Table, mesh, axis: str, n: int):
    """(zero-padded sharded table, per-shard valid counts as device
    scalars) of a contiguous row-block layout: the pack step."""
    size = int(mesh.shape[axis])
    per = -(-n // size)  # ceil: contiguous row blocks, one a device
    pad = per * size - n

    def padleaf(x):
        if not pad:
            return x
        return torch.cat(
            [x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    pt = shard_table(map_tensors(table, padleaf), mesh, axis)
    counts = np.clip(n - np.arange(size) * per, 0, per)
    cnt = [torch.full((), int(c), dtype=torch.int64, device=d)
           for c, d in zip(counts, mesh.devices)]
    return pt, cnt


def _gather_prefix(out_t: Sharded, out_c) -> Table:
    """Each shard's valid prefix, in mesh order, on the mesh's first
    device: the single-device result of a row-local segment."""
    got = on_mesh(out_c, out_t.mesh).cpu().tolist()  # the one host read
    return Sharded([map_tensors(t, lambda x, k=int(k): x[:k])
                    for t, k in zip(out_t, got)], out_t.mesh).concat()


def _rowlocal_stage(seg_ops, table: Table, n: int, axis: str):
    """Stage closure of a plan without an exchange boundary."""
    from .. import plan as plan_mod

    def stage(mesh):
        # re-derived at every replay: a smaller surviving mesh re-plans
        # the layout and the per-shard counts from the same lineage
        pt, cnt = _pack_sharded(table, mesh, axis, n)
        res = per_shard(mesh, lambda s, t, c: plan_mod._run_segment_traced(
            seg_ops, t, c), pt, cnt)
        return _gather_prefix(Sharded([t for t, _ in res], mesh),
                              [c for _, c in res])

    return stage


def _pids(part: dict, table: Table):
    """The partition id function of one ``partition`` op (range
    splitters sampled once, from the whole exchange input)."""
    from ..ops import partition as partition_mod

    num = int(part["num"])
    keys = list(part.get("keys", []))
    if part.get("kind", "hash") == "hash":
        return lambda t: partition_mod.partition_ids_hash(t, keys or None,
                                                          num)
    splitters = partition_mod.range_splitters(table, keys, num)

    def range_ids(t):
        dev = t.columns[0].data.device
        return partition_mod.partition_ids_range(
            t, keys, [s.to(dev) for s in splitters])

    return range_ids


def _counts_pass(pre, pids_of, num: int, mesh, pt, cnt):
    """Scan-side chain + per-(src, dst-device) send counts: the sizing
    pass, a shuffle-site replay boundary."""
    from .. import plan as plan_mod

    size = mesh.size

    def count(s, t, c):
        t2, n2 = plan_mod._run_segment_traced(pre, t, c)
        rv = torch.arange(t2.row_count, device=n2.device) < n2
        dd = torch.where(rv, (pids_of(t2).to(torch.int64) * size) // num,
                         size)
        return torch.bincount(dd, minlength=size + 1)[:size].to(torch.int32)

    return run_collective(
        "plan.partition_counts",
        lambda: on_mesh(per_shard(mesh, count, pt, cnt), mesh),
        site="shuffle")


def _partition_stage(pre, part, post, table: Table, n: int, axis: str,
                     prepared: Optional[dict] = None):
    """Stage closure of a plan with one partition boundary: scan-side
    chain -> counts pass -> ragged exchange -> stable pid sort ->
    merge-side chain, all re-derivable from the host-side lineage.
    ``prepared`` (:func:`prepare_exchange`) is a pack and counts pass
    already run for one mesh, used only on that mesh."""
    from .. import plan as plan_mod
    from .shuffle import (
        _ragged_impl, _round_capacity, check_overflow_compact,
        exchange_ragged, total_recv_capacity,
    )

    num = int(part["num"])
    # range splitters come from the whole input: the exact path's sample
    pids_of = _pids(part, table)

    def stage(mesh):
        size = int(mesh.shape[axis])
        impl = _ragged_impl(None, mesh)
        if (prepared is not None and prepared.get("mesh") is mesh
                and prepared.get("size") == size):
            pt, cnt = prepared["pt"], prepared["cnt"]
            counts = prepared["counts"]
        else:
            pt, cnt = _pack_sharded(table, mesh, axis, n)
            counts = _counts_pass(pre, pids_of, num, mesh, pt, cnt)
        cap = total_recv_capacity(counts)
        pair_cap = _round_capacity(int(counts.max()))

        def scan_side(s, t, c):
            t2, n2 = plan_mod._run_segment_traced(pre, t, c)
            rv = torch.arange(t2.row_count, device=n2.device) < n2
            dd = ((pids_of(t2).to(torch.int64) * size) // num).to(torch.int32)
            return t2, dd, rv

        def merge_side(s, t, occ):
            # received rows arrive in stable (src, in-src) order; a stable
            # sort by the recomputed pid (padding keyed past every pid)
            # gives this device its slice of the globally pid-sorted table
            skey = torch.where(occ, pids_of(t).to(torch.int32), num)
            perm = torch.sort(skey, stable=True).indices
            n_recv = occ.to(torch.int64).sum()
            return plan_mod._run_segment_traced(
                post, gather_table(t, perm), n_recv)

        def launch():
            sides = per_shard(mesh, scan_side, pt, cnt)
            out, occ, overflow = exchange_ragged(
                Sharded([t for t, _, _ in sides], mesh),
                [d for _, d, _ in sides], counts, cap, axis, impl,
                row_valid=[rv for _, _, rv in sides],
                pair_capacity=pair_cap)
            res = per_shard(mesh, merge_side, out, occ)
            return (Sharded([t for t, _ in res], mesh),
                    [c for _, c in res], overflow)

        out_t, out_c, out_ov = run_collective(
            "plan.partition_exchange", launch, site="shuffle")
        # capacity came from the real counts: overflow means a bug
        check_overflow_compact(out_ov, cap, "plan partition")
        if metrics.enabled():
            metrics.counter_add("partition.mesh_segments")
            metrics.counter_add("partition.rows_exchanged", n)
        return _gather_prefix(out_t, out_c)

    return stage


def run_plan_mesh(
    ops: Sequence[dict],
    table: Table,
    runner: MeshRunner,
    rest: Sequence[Table] = (),
) -> Table:
    """Run a row-local plan (around at most one ``partition`` boundary)
    data-parallel over ``runner``'s mesh.

    Never consumes ``table`` (the input is the replay lineage); returns
    the exact (unpadded) result. Raises :class:`MeshUnsupported` when
    the plan has no mesh path and ``faults.Degraded`` when the runner's
    ladder reaches its floor."""
    from ..utils import buckets

    pre, part, post = _check_supported(ops, table, rest)
    # a bucket-padded upload shrinks to its real rows: the mesh stage
    # derives its own shard padding
    table = buckets.unpad_table(table)
    n = int(table.row_count)
    axis = runner.axis
    if part is None:
        return runner.run_stage(
            "plan.mesh", _rowlocal_stage(list(ops), table, n, axis))
    return runner.run_stage(
        "plan.mesh.partition",
        _partition_stage(pre, part, post, table, n, axis))


def prepare_exchange(ops: Sequence[dict], table: Table,
                     runner: MeshRunner) -> Optional[dict]:
    """The pack and scan-side counts pass of ``table`` at the runner's
    current mesh: the work ``run_plan_mesh_stream`` overlaps with the
    previous batch's exchange. None when the plan has no partition
    boundary (nothing worth staging ahead)."""
    from ..utils import buckets

    pre, part, post = _check_supported(ops, table, ())
    if part is None:
        return None
    table = buckets.unpad_table(table)
    n = int(table.row_count)
    mesh = runner.mesh
    size = int(mesh.shape[runner.axis])
    pt, cnt = _pack_sharded(table, mesh, runner.axis, n)
    counts = _counts_pass(pre, _pids(part, table), int(part["num"]), mesh,
                          pt, cnt)
    return {"mesh": mesh, "size": size, "pt": pt, "cnt": cnt,
            "counts": counts}


def run_plan_mesh_stream(
    ops: Sequence[dict],
    batches: Sequence[Table],
    runner: MeshRunner,
) -> list:
    """``batches`` through one plan, batch N+1's counts pass and pack
    staged on the pipeline's workers (``pipeline.stage_ahead``) while
    batch N's exchange runs; with the pipeline off they run one after
    another, byte-identically, in input order. A pack staged for a mesh
    the runner has since left is re-derived at the new size."""
    from .. import pipeline
    from ..utils import buckets

    batches = list(batches)
    if not batches:
        return []
    pre, part, post = _check_supported(ops, batches[0], ())

    def prepare(b: Table):
        return b, prepare_exchange(ops, b, runner)

    def execute(prepped):
        b, prepared = prepped
        t = buckets.unpad_table(b)
        n = int(t.row_count)
        axis = runner.axis
        if part is None:
            return runner.run_stage(
                "plan.mesh", _rowlocal_stage(list(ops), t, n, axis))
        return runner.run_stage(
            "plan.mesh.partition",
            _partition_stage(pre, part, post, t, n, axis,
                             prepared=prepared))

    return pipeline.stage_ahead(batches, prepare, execute, "mesh.prepare")
