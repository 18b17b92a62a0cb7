"""Two-level groupby plan pieces (port of the parts of
``ops/groupby_chunked.py`` that the packed-key groupby imports).

Every aggregation here has an exact two-level decomposition: phase 1
computes partials per chunk, phase 2 combines them (sums of sums, min of
mins, first of firsts in chunk-major order); ``mean`` is a sum and a count.

The chunked groupby itself (``groupby_aggregate_capped_chunked``,
``groupby_aggregate_chunked``) runs the capped groupby with ``row_valid``
per chunk, which the port does not have yet; both, and
``chunked_groupby_supported`` that routes to them, are queued in
ROADMAP.md Queue 1.
"""

from __future__ import annotations

from typing import Sequence

from .. import dtype as dt
from ..column import Table
from .groupby import GroupbyAgg

# aggregations with an exact two-level decomposition
DECOMPOSABLE_OPS = {"sum", "count", "min", "max", "mean", "first", "last"}

# phase-1 partial op + phase-2 combine op per user-facing op
_COMBINE = {
    "sum": "sum",
    "count": "sum",
    "min": "min",
    "max": "max",
    "first": "first",
    "last": "last",
}


def _phase1_plan(table: Table, by, aggs: Sequence[GroupbyAgg]):
    """The partial aggregations phase 1 must compute: every requested
    decomposable op, plus a count per mean column (mean = Σsum/Σcount).
    Returns (phase-1 agg list, per-user-agg plan entries)."""
    p1: list[GroupbyAgg] = []
    names: dict = {}

    def need(column, op) -> str:
        key = (id(table.column(column)), op)
        if key not in names:
            nm = f"__p1_{len(p1)}_{op}"
            names[key] = nm
            p1.append(GroupbyAgg(column, op, name=nm))
        return names[key]

    plan = []
    for a in aggs:
        if a.op not in DECOMPOSABLE_OPS:
            raise ValueError(
                f"{a.op} has no two-level decomposition; route through "
                "the single-pass groupby"
            )
        if a.op == "mean":
            if table.column(a.column).dtype.id == dt.TypeId.DECIMAL128:
                raise ValueError(
                    "DECIMAL128 mean is not chunkable (needs the 128-bit "
                    "limb decode); use the single-pass groupby"
                )
            plan.append(
                ("mean", a, need(a.column, "sum"), need(a.column, "count"))
            )
        else:
            plan.append((a.op, a, need(a.column, a.op), None))
    return p1, plan

