"""Plan runner (port of ``plan.py`` ``run_plan``).

A plan is a JSON list of op objects run one after another over a flowing
table. PyTorch runs eagerly, so there is no fusion and no segmenting:
every op goes through ``runtime_bridge._dispatch_once`` (kernel tier
first, then the exact path), under the fault ladder the JAX package
applies to a fused segment (``_run_fused_tolerant``), here per op
(:func:`_run_op_tolerant`).
"""

from __future__ import annotations

from typing import Optional, Sequence

from .column import Table, table_tensors
from .utils import faults, hbm, metrics, spill

# ops whose output over a row range depends only on the rows in that
# range: an out-of-memory failure may run them in two halves and
# concatenate, byte-identically. sort_by/distinct/groupby/slice are
# global and never split.
_ROW_LOCAL = frozenset({"cast", "filter", "rlike"})


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


def _run_chunked(op: dict, table: Table, rest: list) -> Table:
    """The degradation path of a row-local op that ran out of memory: run
    each half of the rows and concatenate (byte-identical: the op is
    row-local, :data:`_ROW_LOCAL`). Raises ``faults.ResourceExhausted``
    when the input is too small to split."""
    from . import runtime_bridge
    from .ops.copying import concatenate, slice_rows

    n = int(table.row_count)
    if n < 2:
        raise faults.ResourceExhausted(
            f"op OOM at {n} row(s): nothing left to split")
    halves = [runtime_bridge._dispatch_once(
        op, slice_rows(table, lo, hi), rest, op["op"])
        for lo, hi in ((0, n // 2), (n // 2, n))]
    metrics.counter_add("plan.chunked_segments")
    return concatenate(halves)


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
            return _run_chunked(op, table, rest)
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


def _release_consumed(inp: Table, out: Table, protected: set) -> int:
    """Free the storages of a consumed input that neither the op's output
    nor a protected table holds; returns their bytes (a donation)."""
    keep = protected | {spill.storage_key(t) for t in table_tensors(out)}
    seen, nbytes = set(), 0
    for t in table_tensors(inp):
        k = spill.storage_key(t)
        if not k or k in keep or k in seen:
            continue
        seen.add(k)
        nbytes += t.untyped_storage().nbytes()
        spill.free_storage(t)
    return nbytes


def run_plan(ops: Sequence[dict], table: Table, rest: Sequence[Table] = (),
             donate_input: bool = False,
             protected: Optional[set] = None) -> Table:
    """Execute a plan over ``table``; ``rest`` supplies the extra tables
    of multi-table ops. Returns the final table.

    ``donate_input=True`` declares ``table`` consumed by this plan
    (nothing else reads it: a wire upload, a resident id the caller gave
    up): once the first op has returned, the input's storages that the
    output, a ``rest`` table or ``protected`` (storage identities) does
    not hold are freed, counted by ``hbm.note_donation``. Later
    intermediates are the plan's own and go as the loop moves on."""
    if not isinstance(ops, (list, tuple)):
        raise TypeError("plan must be a JSON list of op objects")
    for op in ops:
        if not isinstance(op, dict) or "op" not in op:
            raise ValueError(f"plan entries must be op objects, got {op!r}")
    orig_rest, queue = tuple(rest), list(rest)
    metrics.counter_add("plan.calls")
    for i, op in enumerate(ops):
        faults.check_cancel()  # between-op checkpoint
        out = _run_op_tolerant(op, table, _take_rest(op, orig_rest, queue))
        if i == 0 and donate_input:
            keep = set(protected or ())
            for t in orig_rest:
                keep.update(spill.storage_key(x) for x in table_tensors(t))
            donated = _release_consumed(table, out, keep)
            if donated:
                hbm.note_donation(donated)
        table = out
    return table
