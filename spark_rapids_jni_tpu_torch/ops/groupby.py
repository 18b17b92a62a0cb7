"""Group-by aggregation, sort-based (port of ``ops/groupby.py``).

The exact path of the slice: order words (ops/keys.py) -> stable lexsort
-> segment boundaries -> per-segment reductions. Null keys form their own
group, which sorts first. Output columns, dtypes and validity follow the
JAX package: every output column carries a validity tensor; ``count`` is
INT64; ``sum`` is INT64 (FLOAT64 for floats, DECIMAL64 at the input's
scale for decimals); ``min``/``max`` keep the input type; a group with no
valid value is null.

Sums are cumsum differences over the sorted rows, as in the JAX package:
exact for integers even when the running sum wraps. A floating cumsum adds
in the order of XLA's CPU scan (:func:`_scan_sum16`), and a floating
min/max maps -0.0 to +0.0 as the JAX package's associative scan does, so
float results are the JAX package's bytes on the CPU and on the card.

Only sum/count/min/max are ported in this slice; the other aggregations
of the JAX module raise :class:`NotImplementedError`. The sorted-segment
helpers ``_segment_sum``, ``_segment_bounds`` and
``_sorted_segment_extreme`` also serve the packed-key groupby
(ops/groupby_packed.py), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column, Table
from . import compute
from . import keys as keys_mod
from .sort import lexsort

_AGG_OPS = {
    "sum", "count", "min", "max", "mean", "variance", "std",
    "collect_list", "collect_set", "nunique", "first", "last",
}
PORTED_AGGS = frozenset({"sum", "count", "min", "max"})


@dataclasses.dataclass(frozen=True)
class GroupbyAgg:
    """One aggregation: (value column, op, output name)."""

    column: Union[int, str]
    op: str
    name: Optional[str] = None
    list_capacity: Optional[int] = None

    def __post_init__(self):
        if self.op not in _AGG_OPS:
            raise ValueError(f"unknown aggregation {self.op!r}")


def _group_words(key_cols: Sequence[Column],
                 row_valid: Optional[torch.Tensor] = None) -> list:
    """The sort words of a groupby: a leading occupancy word when
    ``row_valid`` is given (padding rows last), then per key column a
    validity word (null keys group together, first) and its order words
    with null rows set to the u64 word 0."""
    words: list[torch.Tensor] = []
    if row_valid is not None:
        words.append((~row_valid).to(torch.int64))
    for c in key_cols:
        ks = keys_mod.column_order_keys(c)
        if c.validity is not None:
            words.append(c.validity.to(torch.int64))
            words.extend(torch.where(c.validity, w, keys_mod.SIGN64)
                         for w in ks)
        else:
            words.extend(ks)
    return words


def _sorted_segments(words):
    """(perm, seg, boundary) of a stable sort by ``words``: segment ids
    count the rows where any word changes."""
    perm = lexsort(words)
    n = perm.shape[0]
    boundary = torch.zeros(n, dtype=torch.bool, device=perm.device)
    boundary[:1] = True
    for w in words:
        sw = w[perm]
        boundary[1:] |= sw[1:] != sw[:-1]
    return perm, torch.cumsum(boundary, 0) - 1, boundary


def _segment_ids(key_cols: Sequence[Column]):
    """(perm, seg, starts, ends) of a stable sort by the key words."""
    perm, seg, boundary = _sorted_segments(_group_words(key_cols))
    starts = torch.nonzero(boundary).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([perm.shape[0]])])
    return perm, seg, starts, ends


_SCAN_BASE = 16


def _scan_sum16(v: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """Inclusive cumsum of a 1-D floating vector in the order of XLA's CPU
    scan, which is what ``jnp.cumsum`` runs on the JAX package's CPU path:
    blocks of 16 each summed left to right from +0.0, the block totals
    scanned the same way (recursively), and the scanned total of the
    blocks before added to every element of a block. IEEE adds are
    deterministic, so the bytes are the same on the CPU and on the card.
    Starting from +0.0 maps every -0.0 to +0.0, as XLA does for n >= 2; a
    single element is returned as it is unless ``rows`` (the length the
    JAX package scans, by default ``v``'s) is 2 or more."""
    n = v.shape[0]
    if (n if rows is None else rows) < 2:
        return v.clone()
    m = -(-n // _SCAN_BASE)
    x = v.new_zeros(m * _SCAN_BASE)
    x[:n] = v
    x = x.view(m, _SCAN_BASE)
    acc = x[:, 0] + 0.0
    inner = [acc]
    for j in range(1, _SCAN_BASE):
        acc = acc + x[:, j]
        inner.append(acc)
    out = torch.stack(inner, 1)
    if m > 1:
        before = _scan_sum16(out[:, -1].contiguous())[:-1]
        out = out + torch.cat([before.new_zeros(1), before])[:, None]
    else:
        out = out + 0.0
    return out.reshape(-1)[:n]


def _cumsum(vals: torch.Tensor, rows: Optional[int]) -> torch.Tensor:
    """Running sums for the segment sums: integers by ``torch.cumsum``
    (exact, whatever the order), floats in XLA's scan order (FLOAT64
    through ``kernels/scan16.py``: the scan16 kernel on CUDA,
    :func:`_scan_sum16` on the CPU)."""
    if not vals.is_floating_point():
        return torch.cumsum(vals, 0)
    if vals.dtype != torch.float64:
        return _scan_sum16(vals, rows)
    from ..kernels.scan16 import scan_sum16

    return scan_sum16(vals, rows)


def _segment_sum(vals: torch.Tensor, starts, ends,
                 rows: Optional[int] = None) -> torch.Tensor:
    """Per-segment sums of row-sorted ``vals`` as cumsum differences
    (exact for integers even when the running sum wraps; floats scan in
    XLA's order over ``rows``, :func:`_scan_sum16`). An empty segment
    reads garbage (at
    the front, ``c[-1]``): the packed groupby, whose partial slots can be
    empty, masks those; the exact path has none."""
    c = _cumsum(vals, rows)
    hi = c[ends - 1]
    lo = torch.where(starts > 0, c[(starts - 1).clamp(min=0)],
                     torch.zeros((), dtype=c.dtype, device=c.device))
    return hi - lo


def _segment_bounds(seg: torch.Tensor, num_segments: int):
    """Per-segment [start, end) row ranges of a nondecreasing segment-id
    vector, by binary search (int32 results, as in the JAX package)."""
    ids = torch.arange(num_segments, dtype=seg.dtype, device=seg.device)
    starts = torch.searchsorted(seg, ids).to(torch.int32)
    ends = torch.searchsorted(seg, ids, right=True).to(torch.int32)
    return starts, ends


def _clip_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.clamp(0, max(n - 1, 0)).to(torch.int64)


def _sorted_segment_extreme(masked_vals, seg, ends, is_min: bool):
    """Per-segment min/max of a row-sorted vector, one value per entry of
    ``ends``. The JAX package runs a segmented associative scan and reads
    each segment's last row; torch has no such scan, so one
    ``scatter_reduce`` over the segment ids gives the same value for every
    non-empty segment (empty ones hold 0; segment ids past the end land in
    one dropped slot). Unsigned and bool values reduce as int64 carriers
    in their order, floats as they are (NaN propagates, as jnp.minimum;
    -0.0 becomes +0.0, :func:`_zero_sign`)."""
    num_segments = ends.shape[0]
    dtype = masked_vals.dtype
    if dtype == torch.uint64:
        work = masked_vals.view(torch.int64) ^ keys_mod.SIGN64
    elif dtype == torch.bool or dtype in (torch.uint8, torch.uint16,
                                           torch.uint32):
        work = masked_vals.to(torch.int64)
    else:
        work = masked_vals
    idx = seg.clamp(max=num_segments).to(torch.int64)
    out = torch.zeros(num_segments + 1, dtype=work.dtype, device=work.device)
    out = out.scatter_reduce(0, idx, work, "amin" if is_min else "amax",
                             include_self=False)[:num_segments]
    if dtype == torch.uint64:
        return (out ^ keys_mod.SIGN64).view(torch.uint64)
    return _zero_sign(out.to(dtype), masked_vals.shape[0])


def _zero_sign(extremes: torch.Tensor, n: int) -> torch.Tensor:
    """Floating extremes of a scan over ``n`` rows as the JAX package
    gives them: its associative scan interleaves zero-padded halves with
    an add, so for n >= 2 every -0.0 comes out +0.0. Adding +0.0 does the
    same and leaves every other value, NaN included, as it is."""
    if extremes.is_floating_point() and n >= 2:
        return extremes + 0.0
    return extremes


def _sum_dtype(d: dt.DType) -> dt.DType:
    if d.is_floating:
        return dt.FLOAT64
    if d.is_decimal:
        return dt.DType(dt.TypeId.DECIMAL64, d.scale)
    return dt.INT64


def _aggregate(col: Column, op: str, perm, seg, starts, ends,
               rows: int) -> Column:
    """One aggregation over the sorted segments; ``rows`` is the length the
    JAX package scans (see :func:`groupby_aggregate`'s ``padded``)."""
    if col.dtype.id == dt.TypeId.DECIMAL128:
        raise NotImplementedError(
            "DECIMAL128 aggregation is not ported yet (ops/int128 slice)"
        )
    vals = compute.values(col)[perm]
    valid = compute.valid_mask(col)[perm]
    n_valid = _segment_sum(valid.to(torch.int64), starts, ends)
    has = n_valid > 0
    if op == "count":
        return Column(n_valid, dt.INT64, torch.ones_like(has))
    if op == "sum":
        acc = torch.float64 if col.dtype.is_floating else torch.int64
        v = vals.to(acc)
        total = _segment_sum(torch.where(valid, v, torch.zeros_like(v)),
                             starts, ends, rows)
        return compute.from_values(total, _sum_dtype(col.dtype), has)
    # min / max: masked sentinels, then one segment reduction
    is_min = op == "min"
    work = vals.to(torch.uint8) if col.dtype.is_boolean else vals
    if col.dtype.is_floating:
        sentinel = np.inf if is_min else -np.inf
    elif col.dtype.is_boolean:
        sentinel = 1 if is_min else 0
    else:
        info = torch.iinfo(work.dtype)
        sentinel = info.max if is_min else info.min
    masked = torch.where(valid, work, torch.full_like(work, sentinel))
    out = torch.empty(starts.shape[0], dtype=work.dtype, device=work.device)
    out = out.scatter_reduce(0, seg, masked, "amin" if is_min else "amax",
                             include_self=False)
    if col.dtype.is_boolean:
        out = out.to(torch.bool)
    return compute.from_values(_zero_sign(out, rows), col.dtype, has)


def _out_name(table: Table, c, fallback: str) -> str:
    if isinstance(c, str):
        return c
    return table.names[c] if table.names else fallback


def groupby_aggregate(
    table: Table,
    by: Sequence[Union[int, str]],
    aggs: Sequence[GroupbyAgg],
    padded: bool = False,
) -> Table:
    """Groupby with an exact output size (one host sync for the count).

    ``padded=True`` reduces as the JAX package's wire entries do: they pad
    a table to its shape bucket (never fewer than 2 rows) before the
    groupby, so a 1-row table's -0.0 float sum, min or max comes out +0.0
    there. Every other result is the same either way."""
    for a in aggs:
        if a.op not in PORTED_AGGS:
            raise NotImplementedError(
                f"groupby aggregation {a.op!r} is not ported yet: it lands "
                "with the rest of ops/groupby.py (ROADMAP Queue 1, item 5)"
            )
    key_cols = [table.column(c) for c in by]
    out_names = [_out_name(table, c, f"key{i}") for i, c in enumerate(by)]
    out_names += [
        a.name or f"{a.op}_{_out_name(table, a.column, f'c{a.column}')}"
        for a in aggs
    ]
    if table.row_count == 0:
        return _empty_result(table, key_cols, aggs, out_names)
    perm, seg, starts, ends = _segment_ids(key_cols)
    first_rows = perm[starts]
    out_cols = []
    for k in key_cols:
        out_cols.append(Column(
            k.data[first_rows], k.dtype,
            compute.valid_mask(k)[first_rows],
            None if k.lengths is None else k.lengths[first_rows],
        ))
    for a in aggs:
        out_cols.append(_aggregate(table.column(a.column), a.op, perm,
                                   seg, starts, ends,
                                   max(table.row_count, 2) if padded
                                   else table.row_count))
    return Table(out_cols, out_names)


def _empty_result(table, key_cols, aggs, out_names) -> Table:
    """The 0-row result with the exact output schema."""
    dev = key_cols[0].data.device if key_cols else None
    no_rows = torch.zeros(0, dtype=torch.bool, device=dev)
    cols = [Column(k.data[:0], k.dtype, no_rows,
                   None if k.lengths is None else k.lengths[:0])
            for k in key_cols]
    for a in aggs:
        d = table.column(a.column).dtype
        out = {"count": dt.INT64, "sum": _sum_dtype(d)}.get(a.op, d)
        cols.append(Column(torch.zeros(0, dtype=out.storage_dtype,
                                       device=dev), out, no_rows))
    return Table(cols, out_names)


# ---------------------------------------------------------------------------
# capped groupby: a static segment count, a device group count
# ---------------------------------------------------------------------------


def _capped_segment_sum(vals: torch.Tensor, starts, ends, rows: int):
    """The JAX package's ``_sorted_segment_sum``: cumsum differences over
    all ``rows`` sorted rows (floats in XLA's scan order), 0 for an empty
    segment."""
    n = vals.shape[0]
    c = _cumsum(vals, rows)
    hi = c[_clip_rows(ends.to(torch.int64) - 1, n)]
    lo = torch.where(starts > 0, c[_clip_rows(starts.to(torch.int64) - 1, n)],
                     torch.zeros((), dtype=c.dtype, device=c.device))
    return torch.where(ends > starts, hi - lo,
                       torch.zeros((), dtype=c.dtype, device=c.device))


def _capped_aggregate(col: Column, op: str, perm, seg, starts, ends,
                      row_valid, num_segments: int) -> Column:
    """One aggregation of the capped groupby, with the JAX package's bytes
    in every one of its ``num_segments`` rows."""
    if col.dtype.id == dt.TypeId.DECIMAL128:
        raise NotImplementedError(
            "DECIMAL128 aggregation is not ported yet (ops/int128 slice)")
    n = perm.shape[0]
    vals = compute.values(col)[perm]
    valid = compute.valid_mask(col)
    if row_valid is not None:
        valid = valid & row_valid
    valid = valid[perm]
    n_valid = _capped_segment_sum(valid.to(torch.int64), starts, ends, n)
    has = n_valid > 0
    if op == "count":
        return Column(n_valid, dt.INT64, None)
    if op == "sum":
        acc = torch.float64 if col.dtype.is_floating else torch.int64
        v = compute.astype(torch.where(valid, vals, torch.zeros_like(vals)),
                           acc)
        total = _capped_segment_sum(v, starts, ends, n)
        return compute.from_values(total, _sum_dtype(col.dtype), has)
    # min / max: masked sentinels; a segment's extreme is the value the
    # JAX package's segmented scan holds at the segment's last row, and an
    # empty segment (past the groups) reads the last row's segment's
    is_min = op == "min"
    if col.dtype.is_floating:
        sentinel = np.inf if is_min else -np.inf
    elif col.dtype.is_boolean:
        sentinel = is_min
    else:
        info = np.iinfo(compute.NP_OF[vals.dtype])
        sentinel = int(info.max if is_min else info.min)
    masked = torch.where(valid, vals, torch.full_like(vals, sentinel))
    ext = _sorted_segment_extreme(masked, seg, ends, is_min)
    out = ext[seg[_clip_rows(ends.to(torch.int64) - 1, n)].clamp(
        max=num_segments - 1)]
    return compute.from_values(out, col.dtype, has)


def groupby_aggregate_capped(
    table: Table,
    by: Sequence[Union[int, str]],
    aggs: Sequence[GroupbyAgg],
    num_segments: int,
    row_valid: Optional[torch.Tensor] = None,
) -> tuple[Table, torch.Tensor]:
    """Groupby with a static output size: (result of ``num_segments``
    rows, device group count). Keys and values past the count are null.
    ``row_valid`` False rows (padding) sort behind every real row, behind
    a leading occupancy word, and the count is the highest segment that
    holds a valid row. Only sum/count/min/max are ported."""
    for a in aggs:
        if a.op not in PORTED_AGGS:
            raise NotImplementedError(
                f"groupby aggregation {a.op!r} is not ported yet: it lands "
                "with the rest of ops/groupby.py (ROADMAP Queue 1, item 5)")
    key_cols = [table.column(c) for c in by]
    n = table.row_count
    perm, seg, _ = _sorted_segments(_group_words(key_cols, row_valid))
    if row_valid is not None:
        rv_sorted = row_valid[perm]
        num_groups = torch.where(rv_sorted, seg + 1, 0).max()
    else:
        num_groups = seg[-1] + 1
    starts, ends = _segment_bounds(seg, num_segments)
    in_range = torch.arange(num_segments, device=perm.device) < num_groups
    first_rows = perm[_clip_rows(starts.to(torch.int64), n)]
    out_cols, out_names = [], []
    for i, (c, col) in enumerate(zip(by, key_cols)):
        valid = compute.valid_mask(col)[first_rows] & in_range
        out_cols.append(Column(
            col.data[first_rows], col.dtype, valid,
            None if col.lengths is None else col.lengths[first_rows]))
        out_names.append(_out_name(table, c, f"key{i}"))
    for a in aggs:
        r = _capped_aggregate(table.column(a.column), a.op, perm, seg, starts,
                              ends, row_valid, num_segments)
        valid = compute.valid_mask(r) & in_range
        out_cols.append(Column(r.data, r.dtype, valid, r.lengths))
        out_names.append(
            a.name or f"{a.op}_{_out_name(table, a.column, f'c{a.column}')}")
    return Table(out_cols, out_names), num_groups
