"""Plan runner (port of ``plan.py`` ``run_plan``).

A plan is a JSON list of op objects run one after another over a flowing
table. With bucketing on (``SPARK_RAPIDS_TPU_BUCKETS``) the plan runs by
:func:`segment_plan`, as in the JAX package: a ``"fused"`` segment (a
run of two or more fusable ops, a groupby closing its run) threads
``(table, device count)`` through the bucketed runners' op bodies
(``bucketed._do_*``) at its input's one bucket length and reads the
count on the host once, at its end (:func:`_run_fused`); the kernel tier
is not consulted inside it, as the JAX package's fused executable
consults none. An ``"exact"`` segment is one op through
``runtime_bridge._dispatch_once`` (kernel tier, then the bucketed runner,
then the exact path on unpadded inputs). With bucketing off every op is
an exact segment.

Fault tolerance: an exact op runs under :func:`_run_op_tolerant`, a
fused segment under :func:`_run_fused_tolerant` (spill for headroom,
half-batch chunks of an all-row-local segment, transient retries); a
fused segment that still fails is replayed op by op
(``plan.fallbacks``), and one without a bucket runs op by op
(``plan.declined``). Counters: ``plan.calls``, ``plan.segments``,
``plan.fused_segments``, ``plan.fused_ops``, ``plan.exact_ops``,
``plan.fallbacks``, ``plan.declined``, ``plan.chunked_segments``,
``plan.oom_spill_retries``; spans ``plan`` and ``plan.segment``.

A ``mesh_runner`` (``parallel.MeshRunner``) offers the plan to the mesh
path first (``parallel/planmesh.py``), which runs the same fused segment
body (:func:`_run_segment_traced`) on every shard: ``plan.mesh_segments``
when it ran, ``plan.mesh_declined`` when the plan has no mesh path, and
``plan.mesh_fallbacks`` when the runner's ladder reached its floor and
the single-device path below ran instead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import bucketed
from . import dtype as dt
from .column import Column, Table, table_tensors
from .utils import buckets, faults, hbm, log, metrics, spill

# ops whose output over a row range depends only on the rows in that
# range: an out-of-memory failure may run them in two halves and
# concatenate, byte-identically. sort_by/distinct/groupby/slice are
# global and never split.
_ROW_LOCAL = frozenset({"cast", "filter", "rlike"})


# mesh exchange boundaries: planmesh splits a plan at these ops into a
# scan-side chain -> counts-sized all-to-all -> merge-side chain; on the
# single-device path they run through the per-op dispatch
_EXCHANGE_OPS = frozenset({"partition"})

# single-table ops a fused segment carries anywhere in its run
_SIMPLE_FUSABLE = frozenset(
    {"cast", "filter", "rlike", "distinct", "sort_by", "slice"})

# a fused segment's failure replays it op by op; warn once an op chain
_WARNED_SIGS = set()


def op_fusable(op: dict) -> bool:
    """Could this op ride inside a fused segment? (A groupby closes its
    run, see :func:`segment_plan`.) The bucketable single-table ops,
    ``slice`` with non-negative bounds (a negative one raises on the
    exact path), and a groupby without a collect aggregation (its list
    pad is sized from the data)."""
    if not isinstance(op, dict):
        return False
    name = op.get("op")
    if name in _SIMPLE_FUSABLE:
        if name == "slice":
            try:
                start = int(op.get("start", 0))
                stop = op.get("stop")
                return start >= 0 and (stop is None or int(stop) >= 0)
            except (TypeError, ValueError):
                return False
        return True
    if name == "groupby":
        from .ops.groupby import _COLLECT_OPS

        return not any(a.get("agg") in _COLLECT_OPS
                       for a in op.get("aggs", ()))
    return False


def segment_indices(ops: Sequence[dict]) -> List[Tuple[str, List[int]]]:
    """A plan's segments by op index, ``[(kind, [indices])]``: ``"fused"``
    (a run of two or more fusable ops, a groupby closing its run) or
    ``"exact"`` (one op through the per-op dispatch)."""
    segs: List[Tuple[str, List[int]]] = []
    cur: List[int] = []

    def flush():
        nonlocal cur
        if len(cur) >= 2:
            segs.append(("fused", cur))
        else:
            segs.extend(("exact", [i]) for i in cur)
        cur = []

    for i, op in enumerate(ops):
        if op_fusable(op):
            cur.append(i)
            if op.get("op") == "groupby":
                flush()
        else:
            flush()
            segs.append(("exact", [i]))
    flush()
    return segs


def segment_plan(ops: Sequence[dict]) -> List[Tuple[str, list]]:
    """A plan's segments, ``[(kind, ops)]`` (:func:`segment_indices`)."""
    return [(kind, [ops[i] for i in idx])
            for kind, idx in segment_indices(ops)]


# ---------------------------------------------------------------------------
# fused segments
# ---------------------------------------------------------------------------


def _fused_slice(op, t, n, rv):
    """``slice`` inside a fused segment: rows [start, stop) of the first
    ``n`` (the exact path's clamps, against the device count), compacted
    to the front at the same physical length. The bounds are clamped to
    the physical length on the host first (``n`` never exceeds it), so a
    valid bound past int32 stays exact."""
    from .ops.filter import filter_table_capped

    cap = t.row_count
    s = torch.clamp(n, max=min(int(op.get("start", 0)), cap))
    stop = op.get("stop")
    e = n if stop is None else torch.clamp(n, max=min(int(stop), cap))
    e = torch.maximum(s, e)
    iota = torch.arange(cap, device=n.device)
    keep = (iota >= s) & (iota < e)
    return filter_table_capped(t, Column(keep, dt.BOOL8, None),
                               capacity=cap)


#: op name -> fused body ``(op, padded table, device count, occupancy) ->
#: (table at the same physical length, device count)``
_FUSED = {"cast": bucketed._do_cast, "filter": bucketed._do_filter,
          "rlike": bucketed._do_rlike, "distinct": bucketed._do_distinct,
          "sort_by": bucketed._do_sort, "slice": _fused_slice,
          "groupby": bucketed._do_groupby}


def _run_segment_traced(seg_ops: Sequence[dict], t: Table,
                        n: torch.Tensor) -> Tuple[Table, torch.Tensor]:
    """The body of one fused segment: ``(table, device count)`` threaded
    through every op at the table's one physical length, with no host
    read (the mesh path runs it on every shard)."""
    for op in seg_ops:
        rv = buckets.tail_valid(t.row_count, n)
        t, n = _FUSED[op["op"]](op, t, n, rv)
    return t, n


def _run_fused(seg_ops: Sequence[dict], table: Table) -> Table:
    """One fused segment: the input at its bucket (``bucketed._Decline``
    without one), the count a device scalar through every op body, and
    one host read of the final count."""
    pt = bucketed._padded_input(table)
    t = bucketed._strip(pt)
    dev = bucketed._device(t)
    # a fill, not a copy from the host: no synchronisation
    n = torch.full((), int(pt.logical_row_count), dtype=torch.int64,
                   device=dev)
    t, n = _run_segment_traced(seg_ops, t, n)
    # the segment's one host read: the count that sizes the result
    return bucketed._finish(t, int(n))


def _run_chunked(seg_ops: Sequence[dict], table: Table,
                 run=None) -> Table:
    """The degradation path of an all-row-local segment that ran out of
    memory: run each half of the rows (``run``, by default the fused
    segment at the half's bucket) and concatenate, byte-identically.
    Raises ``faults.ResourceExhausted`` when the input is too small to
    split."""
    from .ops.copying import concatenate, slice_rows

    run = run or (lambda part: _run_fused(seg_ops, part))
    t = buckets.unpad_table(table)
    n = int(t.row_count)
    if n < 2:
        raise faults.ResourceExhausted(
            f"segment OOM at {n} row(s): nothing left to split")
    halves = [buckets.unpad_table(run(slice_rows(t, lo, hi)))
              for lo, hi in ((0, n // 2), (n // 2, n))]
    metrics.counter_add("plan.chunked_segments")
    return concatenate(halves)


def _run_fused_tolerant(seg_ops: Sequence[dict], table: Table) -> Table:
    """One fused segment under the fault ladder:

    * a ``bucketed._Decline`` and ``Cancelled``/``DeadlineExceeded``
      propagate at once;
    * an input that a failed run already consumed is at-most-once: its
      error surfaces as-is;
    * a ``ResourceExhausted``-classified failure first asks the spill
      tier for headroom (twice the input's bytes) and retries the same
      segment; when nothing could spill, an all-row-local segment runs in
      half-batch chunks, and if that fails too the first error surfaces;
    * a retryable failure retries with backoff up to ``RETRY_MAX`` (an
      injected fault fires before the run, so its retry is safe);
    * anything else propagates to :func:`run_plan`'s per-op replay."""
    attempt = 0
    spill_tried = False
    while True:
        faults.check_cancel()
        try:
            faults.inject("dispatch")
            return _run_fused(seg_ops, table)
        except (bucketed._Decline, faults.Cancelled,
                faults.DeadlineExceeded):
            raise
        except Exception as e:
            if _input_consumed(table):
                raise
            cls = faults.classify(e)
            if cls is faults.ResourceExhausted and not spill_tried:
                spill_tried = True
                if spill.request_headroom(2 * hbm.table_bytes(table),
                                          reason="oom"):
                    metrics.counter_add("plan.oom_spill_retries")
                    continue
            if cls is faults.ResourceExhausted and all(
                    o.get("op") in _ROW_LOCAL for o in seg_ops):
                try:
                    return _run_chunked(seg_ops, table)
                except Exception:  # the replay owns the first error
                    raise e
            if faults.retryable_class(cls) and attempt < faults.retry_max():
                attempt += 1
                faults.sleep_backoff(attempt, "plan.segment", error=e)
                continue
            raise


def _replay(seg_ops: Sequence[dict], table: Table, e: Exception) -> Table:
    """A fused segment that failed, op by op through the dispatch (the
    exact path raises an op's own error); counted and warned once an op
    chain."""
    from . import runtime_bridge

    metrics.counter_add("plan.fallbacks")
    names = ",".join(str(o.get("op", "?")) for o in seg_ops)
    if names not in _WARNED_SIGS:
        _WARNED_SIGS.add(names)
        log.log("WARN", "plan", "fused_segment_failed", ops=names,
                error=f"{type(e).__name__}: {str(e)[:200]}")
    for op in seg_ops:
        table = runtime_bridge._dispatch(op, table)
        metrics.counter_add("plan.exact_ops")
    return table


def _take_rest(op: dict, orig_rest: tuple, queue: list) -> list:
    """Extra input tables of a multi-table op: an explicit ``"rest"``
    field names indices into the call's extra tables; otherwise a join or
    cross join takes the next unconsumed extra table and a concat takes
    all that are left."""
    idxs = op.get("rest")
    if idxs is not None:
        return [orig_rest[int(i)] for i in idxs]
    name = op.get("op")
    if name in ("join", "cross_join"):
        return [queue.pop(0)] if queue else []
    if name == "concat":
        out = list(queue)
        queue.clear()
        return out
    return []


def _input_consumed(table: Table) -> bool:
    """True when an input's storage was already freed (a donated input
    released, an eviction or a reclaim): running over it again is
    impossible."""
    return any(spill.storage_freed(t) for t in table_tensors(table))


def _run_op_tolerant(op: dict, table: Table, rest: list) -> Table:
    """One op under the fault ladder, ``faults.run_with_retry`` with the
    plan's own steps in its ``on_error`` hook:

    * an input that a failed run already consumed is at-most-once: its
      error surfaces as-is;
    * a ``ResourceExhausted``-classified failure first asks the spill
      tier for headroom (``spill.request_headroom`` of twice the input's
      bytes: the coldest resident tables move to host or disk) and
      retries the same op; when nothing could spill, a row-local op runs
      in half-batch chunks, and if that fails too the first error
      surfaces;
    * a transient-classified failure retries with backoff up to
      ``RETRY_MAX`` (an injected fault fires before the launch, so its
      retry is always safe); at the limit ``retry.giveups``;
    * anything else propagates unchanged.
    """
    from . import runtime_bridge

    name = op["op"]
    spill_tried = False
    chunk_oom = []  # the failure that sent the op to half-batch chunks

    def run() -> Table:
        if chunk_oom:
            return _run_chunked([op], table, run=lambda part: (
                runtime_bridge._dispatch_once(op, part, rest, name)))
        faults.inject("dispatch")
        return runtime_bridge._dispatch_once(op, table, rest, name)

    def on_error(e: Exception, cls: type) -> bool:
        nonlocal spill_tried
        if chunk_oom:
            raise chunk_oom[0]  # the op's own typed error owns it from here
        if _input_consumed(table):
            raise e
        if cls is not faults.ResourceExhausted:
            return False
        if not spill_tried:
            spill_tried = True
            if spill.request_headroom(2 * hbm.table_bytes(table),
                                      reason="oom"):
                metrics.counter_add("plan.oom_spill_retries")
                return True
        if name in _ROW_LOCAL:
            chunk_oom.append(e)
            return True
        return False

    return faults.run_with_retry(run, f"plan.op {name}", on_error=on_error)


def _storages(tables) -> set:
    """The storage identities of ``tables``' tensors (empty ones left
    out)."""
    keys = {spill.storage_key(t) for tb in tables for t in table_tensors(tb)}
    keys.discard(0)
    return keys


def _release_consumed(inp: Table, out: Table, keep: set) -> int:
    """Free the storages of a consumed input that neither the segment's
    output nor ``keep`` holds; returns their bytes (a donation)."""
    keep = keep | _storages([out])
    seen, nbytes = set(), 0
    for t in table_tensors(inp):
        k = spill.storage_key(t)
        if not k or k in keep or k in seen:
            continue
        seen.add(k)
        nbytes += t.untyped_storage().nbytes()
        spill.free_storage(t)
    return nbytes


def _run_segment(kind: str, seg_ops: list, table: Table, orig_rest: tuple,
                 queue: list) -> Table:
    if kind == "fused":
        try:
            out = _run_fused_tolerant(seg_ops, table)
        except bucketed._Decline:  # no bucket for this shape
            metrics.counter_add("plan.declined")
        except (faults.Cancelled, faults.DeadlineExceeded):
            raise
        except Exception as e:
            if _input_consumed(table):
                raise
            return _replay(seg_ops, table, e)
        else:
            metrics.counter_add("plan.fused_segments")
            metrics.counter_add("plan.fused_ops", len(seg_ops))
            return out
    for op in seg_ops:
        table = _run_op_tolerant(op, table,
                                 _take_rest(op, orig_rest, queue))
        metrics.counter_add("plan.exact_ops")
    return table


def _run_mesh(ops: Sequence[dict], table: Table, rest: Sequence[Table],
              mesh_runner) -> Optional[Table]:
    """The plan on ``mesh_runner``'s mesh; None when the plan has no mesh
    path or the ladder reached its floor (the single-device path runs
    then: the mesh path never consumes ``table``)."""
    from .parallel import planmesh

    with metrics.span("plan.mesh"):
        try:
            out = planmesh.run_plan_mesh(ops, table, mesh_runner, rest)
        except planmesh.MeshUnsupported:
            # not a failure: this plan has no mesh path
            metrics.counter_add("plan.mesh_declined")
            return None
        except faults.Degraded as e:
            # collective failures persisted down to the runner's floor:
            # the single-device path is the degradation target
            metrics.counter_add("plan.mesh_fallbacks")
            faults.note_error_class(e, "plan.mesh")
            log.log("WARN", "plan", "mesh_degraded_to_exact",
                    error=f"{type(e).__name__}: {str(e)[:200]}")
            return None
    metrics.counter_add("plan.mesh_segments")
    return out


def run_plan(ops: Sequence[dict], table: Table, rest: Sequence[Table] = (),
             donate_input: bool = False,
             protected: Optional[set] = None,
             mesh_runner=None) -> Table:
    """Execute a plan over ``table``; ``rest`` supplies the extra tables
    of multi-table ops. Returns the final (possibly padded) table.

    ``donate_input=True`` declares ``table`` consumed by this plan
    (nothing else reads it: a wire upload, a resident id the caller gave
    up). A segment whose input the plan owns (the donated input, then
    every intermediate) releases, once it has returned, the input's
    storages that its output, a ``rest`` table or ``protected`` (storage
    identities) does not hold, counted by ``hbm.note_donation``. A later
    segment's input that shares a storage with the plan's input, a
    ``rest`` table or ``protected`` (an aliasing op passed it on) is not
    the plan's own, and releases nothing.

    ``mesh_runner`` offers the plan to the mesh path first
    (:func:`_run_mesh`)."""
    if not isinstance(ops, (list, tuple)):
        raise TypeError("plan must be a JSON list of op objects")
    for op in ops:
        if not isinstance(op, dict) or "op" not in op:
            raise ValueError(f"plan entries must be op objects, got {op!r}")
    if ops and mesh_runner is not None:
        out = _run_mesh(ops, table, rest, mesh_runner)
        if out is not None:
            return out
    orig_rest, queue = tuple(rest), list(rest)
    segs = (segment_plan(ops) if buckets.enabled()
            else [("exact", [op]) for op in ops])
    metrics.counter_add("plan.calls")
    metrics.counter_add("plan.segments", len(segs))
    keep = set(protected or ()) | _storages(orig_rest)
    guard = keep | _storages([table])
    with metrics.span("plan", segments=len(segs), ops=len(ops)):
        for i, (kind, seg_ops) in enumerate(segs):
            faults.check_cancel()  # between-segment checkpoint
            owned = (donate_input if i == 0
                     else guard.isdisjoint(_storages([table])))
            with metrics.span("plan.segment", index=i, kind=kind,
                              ops=len(seg_ops)):
                out = _run_segment(kind, seg_ops, table, orig_rest, queue)
            if owned:
                donated = _release_consumed(table, out, keep)
                if donated:
                    hbm.note_donation(donated)
            table = out
    return table
