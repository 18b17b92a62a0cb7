"""Two-level (chunked) group-by (port of ``ops/groupby_chunked.py``).

The single-pass groupby (``ops/groupby.py``) sorts all rows once. The
two-level form cuts the rows into (C, T) chunks:

  phase 1  the capped groupby runs per chunk (the JAX package vmaps it;
           the port runs the chunks one after another), each chunk
           reduced to at most ``chunk_segments`` partials;
  phase 2  the C x S partials concatenate into one small table that one
           capped groupby combines: sums of sums, min of mins, first of
           firsts in chunk-major order; ``mean`` is a sum and a count.

Every aggregation here has an exact two-level decomposition but for the
floats: a FLOAT64 sum adds in another order than the single pass (the
JAX package's own bytes, which the port reproduces). ``variance``,
``nunique`` and the collects stay on the single pass.

Capacity: a chunk with more distinct keys than ``chunk_segments`` would
truncate groups, so the capped form returns the largest per-chunk group
count; the eager form probes chunk 0, sizes the capacity with 4x
headroom, checks the count after the run, doubles once, and else
returns None (the caller runs the single pass).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .. import dtype as dt
from ..column import Table
from . import compute
from .groupby import GroupbyAgg, groupby_aggregate_capped

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


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _pad_chunks(table: Table, chunk_rows: int):
    """``[(chunk table, occupancy)]`` of the (C, T) chunks: the last one
    zero-padded to ``chunk_rows`` rows (validity False, lengths 0), as
    the JAX package pads the whole table before its reshape."""
    from ..utils.buckets import pad_column
    from .copying import slice_rows

    n = table.row_count
    dev = table.columns[0].data.device
    out = []
    for lo in range(0, n, chunk_rows):
        part = slice_rows(table, lo, min(lo + chunk_rows, n))
        occ = torch.arange(chunk_rows, device=dev) < part.row_count
        out.append((Table([pad_column(c, chunk_rows) for c in part.columns],
                          table.names), occ))
    return out


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



def groupby_aggregate_capped_chunked(
    table: Table,
    by: Sequence[Union[int, str]],
    aggs: Sequence[GroupbyAgg],
    num_segments: int,
    chunk_rows: int = 1 << 18,
    chunk_segments: int = 1 << 14,
) -> tuple[Table, torch.Tensor, torch.Tensor]:
    """Two-level groupby with a static output size.

    Returns ``(result of num_segments rows, total group count, largest
    per-chunk group count)``; the result is exact iff the last is at most
    ``chunk_segments``."""
    from .copying import concatenate

    key_names = [c if isinstance(c, str)
                 else (table.names[c] if table.names else f"key{i}")
                 for i, c in enumerate(by)]
    p1_aggs, plan = _phase1_plan(table, by, aggs)

    parts, chunk_groups = [], []
    for chunk, occ in _pad_chunks(table, chunk_rows):
        part, g = groupby_aggregate_capped(
            chunk, by, p1_aggs, num_segments=chunk_segments, row_valid=occ)
        parts.append(part)
        chunk_groups.append(g)
    chunk_groups = torch.stack(chunk_groups)
    flat = concatenate(parts)
    dev = chunk_groups.device
    seg_iota = torch.arange(chunk_segments, device=dev)[None, :]
    p2_valid = (seg_iota < chunk_groups[:, None]).reshape(-1)

    p2_aggs = [GroupbyAgg(a.name, _COMBINE[a.op], name=f"__p2_{i}")
               for i, a in enumerate(p1_aggs)]
    combined, num_groups = groupby_aggregate_capped(
        Table(flat.columns, flat.names), key_names, p2_aggs,
        num_segments=num_segments, row_valid=p2_valid)

    out_cols = list(combined.columns[: len(by)])
    out_names = list(combined.names[: len(by)])
    p2_of = {a.name: combined.column(f"__p2_{i}")
             for i, a in enumerate(p1_aggs)}
    flush = compute.flush_subnormal
    for op, a, main_name, count_name in plan:
        colref = a.column
        base = (colref if isinstance(colref, str)
                else (table.names[colref] if table.names else f"c{colref}"))
        out_names.append(a.name or f"{a.op}_{base}")
        if op != "mean":
            out_cols.append(p2_of[main_name])
            continue
        total, cnt = p2_of[main_name], p2_of[count_name]
        n_valid = compute.values(cnt)
        mean = flush(compute.astype(compute.values(total), torch.float64)
                     / n_valid.clamp(min=1).to(torch.float64))
        src = table.column(colref).dtype
        if src.is_decimal and src.id != dt.TypeId.DECIMAL128:
            mean = flush(mean * (10.0 ** src.scale))
        has = compute.valid_mask(cnt) & (n_valid > 0)
        out_cols.append(compute.from_values(mean, dt.FLOAT64, has))
    return Table(out_cols, out_names), num_groups, chunk_groups.max()


def chunked_groupby_supported(table: Table,
                              aggs: Sequence[GroupbyAgg]) -> bool:
    for a in aggs:
        if a.op not in DECOMPOSABLE_OPS:
            return False
        if (a.op == "mean"
                and table.column(a.column).dtype.id == dt.TypeId.DECIMAL128):
            # a DECIMAL128 mean needs the 128-bit decode of the summed
            # limbs, which only the single pass has
            return False
    return True


def groupby_aggregate_chunked(
    table: Table,
    by: Sequence[Union[int, str]],
    aggs: Sequence[GroupbyAgg],
    chunk_rows: int = 1 << 18,
    chunk_segments: Optional[int] = None,
) -> Optional[Table]:
    """Two-level groupby with an exact output size, or None when chunking
    cannot win (too few rows, a non-decomposable aggregation, keys too
    spread): the caller runs the single pass.

    The capacity protocol: probe chunk 0 for its group count; size
    ``chunk_segments`` with 4x headroom; the largest per-chunk count of
    the run proves it sufficed; one doubling retry, else None."""
    from .copying import slice_rows

    n = table.row_count
    if n <= chunk_rows or not chunked_groupby_supported(table, aggs):
        return None
    if chunk_segments is None:
        _, g0 = groupby_aggregate_capped(
            slice_rows(table, 0, chunk_rows), by,
            [GroupbyAgg(by[0], "count")], num_segments=chunk_rows)
        g0 = int(g0)
        if g0 > chunk_rows // 4:
            return None  # near-distinct keys: chunking only adds passes
        chunk_segments = min(chunk_rows, _ceil_pow2(4 * g0 + 64))
    c = -(-n // chunk_rows)
    for _ in range(2):
        out, num_groups, max_chunk = groupby_aggregate_capped_chunked(
            table, by, aggs, min(c * chunk_segments, n), chunk_rows,
            chunk_segments)
        if int(max_chunk) <= chunk_segments:
            return slice_rows(out, 0, int(num_groups))
        if chunk_segments >= chunk_rows:
            break
        chunk_segments = min(chunk_rows, _ceil_pow2(int(max_chunk)))
    return None
