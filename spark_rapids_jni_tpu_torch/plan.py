"""Plan runner (port of ``plan.py`` ``run_plan``).

A plan is a JSON list of op objects run one after another over a flowing
table. PyTorch runs eagerly, so there is no fusion and no segmenting:
every op goes through ``runtime_bridge._dispatch_once`` (kernel tier
first, then the exact path).
"""

from __future__ import annotations

from typing import Sequence

from .column import Table


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


def run_plan(ops: Sequence[dict], table: Table,
             rest: Sequence[Table] = ()) -> Table:
    """Execute a plan over ``table``; ``rest`` supplies the extra tables
    of multi-table ops. Returns the final table."""
    from . import runtime_bridge

    if not isinstance(ops, (list, tuple)):
        raise TypeError("plan must be a JSON list of op objects")
    for op in ops:
        if not isinstance(op, dict) or "op" not in op:
            raise ValueError(f"plan entries must be op objects, got {op!r}")
    orig_rest, queue = tuple(rest), list(rest)
    for op in ops:
        table = runtime_bridge._dispatch_once(
            op, table, _take_rest(op, orig_rest, queue), op["op"]
        )
    return table
