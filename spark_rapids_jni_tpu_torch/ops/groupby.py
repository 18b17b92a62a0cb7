"""Group-by aggregation, sort-based (port of ``ops/groupby.py``).

The exact path: order words (ops/keys.py) -> stable lexsort -> segment
boundaries -> per-segment reductions. Null keys form their own group,
which sorts first. Output columns, dtypes and validity follow the JAX
package: every output column carries a validity tensor; ``count`` and
``nunique`` are INT64; ``sum`` is INT64 (FLOAT64 for floats, DECIMAL64 at
the input's scale for decimals); ``mean``, ``variance`` and ``std`` are
FLOAT64 (variance and std: the two-pass sample form, null below 2 valid
rows); ``min``/``max``/``first``/``last`` keep the input type (first and
last: the first and last valid value); ``collect_list``/``collect_set``
are LIST columns of ``(groups, pad)`` child values with per-group
lengths, nulls dropped, sets ascending. A group with no valid value is
null. STRING keys group by their bytes; a STRING value takes only
``count`` (the JAX package's groupby refuses every aggregation of one,
ROADMAP Queue 3). A DECIMAL128 value (``(n, 2)`` limbs, ops/int128.py)
sums exactly mod 2^128 to DECIMAL128 at its scale; its mean, variance
and std work on its float64 image; ``nunique`` and the collects refuse
it, as in the JAX package.

Sums are cumsum differences over the sorted rows, as in the JAX package:
exact for integers even when the running sum wraps. A floating cumsum adds
in the order of XLA's CPU scan (:func:`_scan_sum16`), and a floating
min/max maps -0.0 to +0.0 as the JAX package's associative scan does.
XLA's CPU code flushes subnormal floats to zero, in what every float
operation reads and returns; the float reductions here flush at the same
points (``compute.flush_subnormal``). So float results are the JAX
package's bytes on the CPU and on the card. The sorted-segment helpers
``_segment_sum``, ``_segment_bounds`` and ``_sorted_segment_extreme`` also
serve the packed-key groupby (ops/groupby_packed.py), as in the JAX
package.
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
from .gather import take_rows
from .sort import lexsort, lexsort_occupied

_AGG_OPS = {
    "sum", "count", "min", "max", "mean", "variance", "std",
    "collect_list", "collect_set", "nunique", "first", "last",
}
_COLLECT_OPS = frozenset({"collect_list", "collect_set"})
_LIST_CHILD_IDS = frozenset({
    dt.TypeId.INT8, dt.TypeId.INT16, dt.TypeId.INT32, dt.TypeId.INT64,
    dt.TypeId.UINT8, dt.TypeId.UINT16, dt.TypeId.UINT32, dt.TypeId.UINT64,
    dt.TypeId.FLOAT32, dt.TypeId.BOOL8,
})


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
        words.append((~row_valid).to(torch.uint8))
    for c in key_cols:
        ks = keys_mod.column_order_keys(c)
        if c.validity is not None:
            words.append(c.validity.to(torch.uint8))
            words.extend(torch.where(c.validity, w, keys_mod.SIGN64)
                         for w in ks)
        else:
            words.extend(ks)
    return words


def _sorted_segments(words, perm=None):
    """(perm, seg, boundary) of a stable sort by ``words`` (``perm`` when
    the caller sorted them): segment ids count the rows where any word
    changes."""
    if perm is None:
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
    JAX package scans, by default ``v``'s) is 2 or more. Subnormals are
    flushed to zero in the input and after every add, as XLA's CPU code
    runs."""
    n = v.shape[0]
    if (n if rows is None else rows) < 2:
        return v.clone()
    flush = compute.flush_subnormal
    m = -(-n // _SCAN_BASE)
    x = v.new_zeros(m * _SCAN_BASE)
    x[:n] = flush(v)
    x = x.view(m, _SCAN_BASE)
    acc = x[:, 0] + 0.0
    inner = [acc]
    for j in range(1, _SCAN_BASE):
        acc = flush(acc + x[:, j])
        inner.append(acc)
    out = torch.stack(inner, 1)
    if m > 1:
        before = _scan_sum16(out[:, -1].contiguous())[:-1]
        out = flush(out + torch.cat([before.new_zeros(1), before])[:, None])
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
    XLA's order over ``rows``, :func:`_scan_sum16`; their differences
    flushed as XLA's subtraction flushes them). An empty segment
    reads garbage (at
    the front, ``c[-1]``): the packed groupby, whose partial slots can be
    empty, masks those; the exact path has none."""
    c = _cumsum(vals, rows)
    hi = c[ends - 1]
    lo = torch.where(starts > 0, c[(starts - 1).clamp(min=0)],
                     torch.zeros((), dtype=c.dtype, device=c.device))
    return compute.flush_subnormal(hi - lo)


def _segment_bounds(seg: torch.Tensor, num_segments: int):
    """Per-segment [start, end) row ranges of a nondecreasing segment-id
    vector, by binary search (int32 results, as in the JAX package)."""
    ids = torch.arange(num_segments, dtype=seg.dtype, device=seg.device)
    starts = torch.searchsorted(seg, ids).to(torch.int32)
    ends = torch.searchsorted(seg, ids, right=True).to(torch.int32)
    return starts, ends


def _clip_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.clamp(0, max(n - 1, 0)).to(torch.int64)


def _sorted_segment_extreme(masked_vals, seg, ends, is_min: bool,
                            rows: Optional[int] = None):
    """Per-segment min/max of a row-sorted vector, one value per entry of
    ``ends``. The JAX package runs a segmented associative scan and reads
    each segment's last row; torch has no such scan, so one
    ``scatter_reduce`` over the segment ids gives the same value for every
    non-empty segment (empty ones hold 0; segment ids past the end land in
    one dropped slot). Unsigned and bool values reduce as int64 carriers
    in their order, floats as they are (NaN propagates, as jnp.minimum;
    -0.0 becomes +0.0 when the JAX package scans ``rows`` >= 2 rows, by
    default ``masked_vals``'s, :func:`_zero_sign`)."""
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
    return _zero_sign(out.to(dtype),
                      masked_vals.shape[0] if rows is None else rows)


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


def _out_dtype(op: str, d: dt.DType) -> dt.DType:
    """An aggregation's output type (the JAX module's rules)."""
    if op in ("count", "nunique"):
        return dt.INT64
    if op == "sum":
        return _sum_dtype(d)
    if op in ("mean", "variance", "std"):
        return dt.FLOAT64
    if op in _COLLECT_OPS:
        return dt.LIST
    return d


def _check_value(col: Column, op: str) -> None:
    if col.dtype.is_string and op != "count":
        raise TypeError(f"aggregation {op!r} not supported on STRING values")
    if col.dtype.id == dt.TypeId.DECIMAL128 and (
            op in _COLLECT_OPS or op == "nunique"):
        raise TypeError(f"{op} not supported for {col.dtype}")
    if op in _COLLECT_OPS and col.dtype.id not in _LIST_CHILD_IDS:
        raise TypeError(
            f"{op} not supported for {col.dtype} (LIST children are "
            "int8..64, uint8..64, float32, bool)")


def _float_values(vals: torch.Tensor, d: dt.DType) -> torch.Tensor:
    """``vals.astype(float64)`` (decimals times ``10.0 ** scale``) as XLA's
    CPU code computes it, subnormals flushed in and out."""
    f = compute.astype(compute.flush_subnormal(vals), torch.float64)
    if d.is_decimal:
        f = compute.flush_subnormal(f * (10.0 ** d.scale))
    return f


def _valid_rank_rows(valid: torch.Tensor, starts, ranks) -> torch.Tensor:
    """The sorted-row index of each segment's r-th VALID row (JAX
    ``_valid_rank_rows``): rank r of a segment lives at the first row
    where the running valid count reaches the count before the segment
    plus r. ``ranks`` is (segments, k); ranks past a segment's valid rows
    land on whatever row the search finds, as in the JAX package (the
    caller masks them). Unclipped: a search past the last row returns
    ``n``."""
    n = valid.shape[0]
    cvalid = torch.cumsum(valid.to(torch.int64), 0)
    st = starts.to(torch.int64)
    base = torch.where(st > 0, cvalid[_clip_rows(st - 1, n)],
                       torch.zeros((), dtype=torch.int64, device=st.device))
    target = base[:, None] + ranks.to(torch.int64)
    return torch.searchsorted(cvalid, target.reshape(-1)).reshape(
        target.shape)


def _masked_rows(data: torch.Tensor, rows: torch.Tensor,
                 n: int) -> torch.Tensor:
    """``data[rows]`` clipped to the table, as the JAX package's gather
    clips."""
    return take_rows(data, _clip_rows(rows, n))


def _first_occurrence(d: dt.DType, seg, data, valid):
    """Rows re-sorted by (segment, valid first, value word), stably, and
    the mask of each segment's first row of each distinct valid value
    (JAX ``_first_occurrence``, the core of collect_set and nunique).
    Segments keep their row ranges."""
    from .sort import lexsort

    vword = keys_mod.column_order_keys(Column(data, d))[0]
    perm = lexsort([seg.to(torch.int64), (~valid).to(torch.uint8), vword])
    seg2, vword2 = seg[perm], vword[perm]
    new = torch.ones(perm.shape[0], dtype=torch.bool, device=perm.device)
    new[1:] = (seg2[1:] != seg2[:-1]) | (vword2[1:] != vword2[:-1])
    return data[perm], valid[perm] & new


def _collect(d: dt.DType, op: str, pad: int, seg, data, valid, starts,
             ends, segsum) -> Column:
    """collect_list / collect_set: a LIST column of (segments, pad) child
    values and per-group lengths; nulls dropped, sets ascending (JAX
    ``_collect_segment``)."""
    if op == "collect_set":
        data, valid = _first_occurrence(d, seg, data, valid)
    n = data.shape[0]
    counts = segsum(valid.to(torch.int32), starts, ends)
    lens = counts.clamp(max=pad)
    ranks = torch.arange(1, pad + 1, device=data.device)[None, :]
    mat = data[_clip_rows(_valid_rank_rows(valid, starts, ranks), n)]
    slot_ok = torch.arange(pad, device=data.device)[None, :] < lens[:, None]
    zero = torch.zeros((), dtype=mat.dtype, device=mat.device)
    return Column(torch.where(slot_ok, mat, zero), dt.LIST, None,
                  lens.to(torch.int32))


def _reduce(col: Column, op: str, data, valid, seg, starts, ends, segsum,
            seg_clip: int, scan_rows: int, list_capacity) -> Column:
    """One aggregation over row-sorted ``data`` (storage) and ``valid``;
    ``segsum(vals, starts, ends)`` is the path's segment sum, ``seg_clip``
    its largest segment id and ``scan_rows`` the length the JAX package
    scans. Every float result is flushed as XLA's CPU code flushes it."""
    d = col.dtype
    n_valid = segsum(valid.to(torch.int64), starts, ends)
    if op == "count":
        return Column(n_valid, dt.INT64, None)
    has = n_valid > 0
    if op in ("first", "last"):
        ranks = (torch.ones_like(n_valid) if op == "first" else n_valid)
        rows = _valid_rank_rows(valid, starts, ranks[:, None])[:, 0]
        return Column(_masked_rows(data, rows, data.shape[0]),
                      d, has)
    if d.id == dt.TypeId.DECIMAL128:
        return _reduce_dec128(d, op, data, valid, seg, starts, ends, segsum,
                              seg_clip, scan_rows, n_valid)
    vals = compute.values(Column(data, d))
    if op == "nunique":
        _, first = _first_occurrence(d, seg, data, valid)
        return Column(segsum(first.to(torch.int64), starts, ends), dt.INT64,
                      None)
    if op in _COLLECT_OPS:
        if list_capacity is None:
            raise ValueError(
                f"{op} in the capped API needs GroupbyAgg.list_capacity "
                "(the static LIST pad width)")
        return _collect(d, op, list_capacity, seg, data, valid, starts, ends,
                        segsum)
    if op in ("sum", "mean"):
        if d.is_floating:
            # the scan flushes what it reads; a FLOAT32 value is flushed
            # before it widens, as XLA's convert reads it
            if d.id != dt.TypeId.FLOAT64:
                vals = compute.flush_subnormal(vals)
            v = torch.where(valid, vals.to(torch.float64), 0.0)
        else:
            v = compute.astype(
                torch.where(valid, vals, torch.zeros_like(vals)), torch.int64)
        total = segsum(v, starts, ends)
        if op == "sum":
            return compute.from_values(total, _sum_dtype(d), has)
        mean = compute.flush_subnormal(
            total.to(torch.float64) / n_valid.clamp(min=1).to(torch.float64))
        if d.is_decimal:
            mean = compute.flush_subnormal(mean * (10.0 ** d.scale))
        return compute.from_values(mean, dt.FLOAT64, has)
    if op in ("variance", "std"):
        # two-pass: segment mean, back to the rows, segment sum of the
        # squared deviations; sample variance (ddof 1), null below 2 rows
        flush = compute.flush_subnormal
        fvals = _float_values(vals, d)
        nf = n_valid.to(torch.float64)
        s1 = segsum(torch.where(valid, fvals, 0.0), starts, ends)
        mean = flush(s1 / nf.clamp(min=1))
        mean_row = mean[seg.clamp(0, seg_clip)]
        if d.is_decimal and scan_rows >= 2:
            # XLA's compiled graph recomputes the scaling in the deviation's
            # fusion and contracts the two into one fma (over one row it
            # shares the product instead and rounds it)
            dev = flush(compute.fma(_float_values(vals, dt.FLOAT64),
                                    10.0 ** d.scale, -mean_row))
        else:
            dev = flush(fvals - mean_row)
        sq = segsum(torch.where(valid, flush(dev * dev), 0.0), starts, ends)
        var = flush(sq / (nf - 1).clamp(min=1))
        out = compute.sqrt_rn(var) if op == "std" else var
        return compute.from_values(out, dt.FLOAT64, n_valid > 1)
    # min / max: masked sentinels, then one segment reduction
    is_min = op == "min"
    if d.is_floating:
        sentinel = np.inf if is_min else -np.inf
    elif d.is_boolean:
        sentinel = is_min
    else:
        info = np.iinfo(compute.NP_OF[vals.dtype])
        sentinel = int(info.max if is_min else info.min)
    masked = torch.where(valid, vals, torch.full_like(vals, sentinel))
    ext = _sorted_segment_extreme(masked, seg, ends, is_min, scan_rows)
    return compute.from_values(ext, d, has)


def _reduce_dec128(d: dt.DType, op: str, data, valid, seg, starts, ends,
                   segsum, seg_clip: int, scan_rows: int, n_valid) -> Column:
    """DECIMAL128 aggregations over row-sorted ``(n, 2)`` limbs (JAX
    ``_aggregate_segment_dec128``). sum is exact mod 2^128: each limb
    splits into 32-bit halves whose segment totals cannot wrap (n <
    2^32), and the four partial sums recombine with 128-bit carries.
    min/max take the lexicographic extreme of the order words. mean,
    variance and std use the float64 image of the 128-bit value."""
    from . import int128

    flush = compute.flush_subnormal
    lo, hi = data[:, 0], data[:, 1]
    has = n_valid > 0
    zero = torch.zeros((), dtype=torch.int64, device=data.device)
    if op in ("sum", "mean"):
        parts = []
        for limb in (lo, hi):
            parts.append(torch.where(valid, limb & 0xFFFFFFFF, zero))
            parts.append(torch.where(valid, int128.lshr(limb, 32), zero))
        s_ll, s_lh, s_hl, s_hh = [segsum(p, starts, ends) for p in parts]
        nil = torch.zeros_like(s_ll)
        out_lo, out_hi = int128.add(s_ll, nil, s_lh << 32,
                                    int128.lshr(s_lh, 32))
        out_lo, out_hi = int128.add(out_lo, out_hi, nil, s_hl)
        out_lo, out_hi = int128.add(out_lo, out_hi, nil, s_hh << 32)
        if op == "mean":
            mean = flush(int128.to_float64(out_lo, out_hi)
                         / n_valid.clamp(min=1).to(torch.float64))
            mean = flush(mean * (10.0 ** d.scale))
            return compute.from_values(mean, dt.FLOAT64, has)
        return Column(torch.stack([out_lo, out_hi], 1), d, has)
    if op in ("variance", "std"):
        scale = 10.0 ** d.scale
        image = int128.to_float64(lo, hi)
        fvals = flush(image * scale)
        nf = n_valid.to(torch.float64)
        s1 = segsum(torch.where(valid, fvals, 0.0), starts, ends)
        mean = flush(s1 / nf.clamp(min=1))
        mean_row = mean[seg.clamp(0, seg_clip)]
        if scan_rows >= 2:
            # as for DECIMAL64: XLA's compiled graph recomputes the scaling
            # in the deviation's fusion and contracts it into one fma
            dev = flush(compute.fma(image, scale, -mean_row))
        else:
            dev = flush(fvals - mean_row)
        sq = segsum(torch.where(valid, flush(dev * dev), 0.0), starts, ends)
        var = flush(sq / (nf - 1).clamp(min=1))
        out = compute.sqrt_rn(var) if op == "std" else var
        return compute.from_values(out, dt.FLOAT64, n_valid > 1)
    # min / max: the extreme of the hi word, then of the lo word among the
    # rows that hold it; the order words as carriers (hi is its own, lo
    # has its top bit flipped), invalid rows as the sentinel word
    is_min = op == "min"
    sent = torch.full((), 2**63 - 1 if is_min else -(2**63),
                      dtype=torch.int64, device=data.device)
    k_hi = torch.where(valid, hi, sent)
    k_lo = torch.where(valid, lo ^ keys_mod.SIGN64, sent)
    ext_hi = _sorted_segment_extreme(k_hi, seg, ends, is_min)
    at_ext = k_hi == ext_hi[seg.clamp(0, ends.shape[0] - 1)]
    ext_lo = _sorted_segment_extreme(torch.where(at_ext, k_lo, sent), seg,
                                     ends, is_min)
    return Column(torch.stack([ext_lo ^ keys_mod.SIGN64, ext_hi], 1), d, has)


def _aggregate(col: Column, op: str, perm, seg, starts, ends,
               rows: int, list_capacity) -> Column:
    """One aggregation of the exact groupby; ``rows`` is the length the
    JAX package scans (see :func:`groupby_aggregate`'s ``padded``)."""
    _check_value(col, op)
    data = take_rows(col.data, perm)
    valid = compute.valid_mask(col)[perm]

    def segsum(v, s, e):
        return _segment_sum(v, s, e, rows)

    r = _reduce(col, op, data, valid, seg, starts, ends, segsum,
                starts.shape[0] - 1, rows, list_capacity)
    if op == "count":
        return Column(r.data, r.dtype, torch.ones_like(r.data, dtype=torch.bool))
    if r.validity is None:
        return Column(r.data, r.dtype,
                      torch.ones(r.data.shape[0], dtype=torch.bool,
                                 device=r.data.device), r.lengths)
    return r


def _out_name(table: Table, c, fallback: str) -> str:
    if isinstance(c, str):
        return c
    return table.names[c] if table.names else fallback


def _agg_names(table: Table, by, aggs) -> list:
    names = [_out_name(table, c, f"key{i}") for i, c in enumerate(by)]
    names += [
        a.name or f"{a.op}_{_out_name(table, a.column, f'c{a.column}')}"
        for a in aggs
    ]
    return names


def groupby_aggregate(
    table: Table,
    by: Sequence[Union[int, str]],
    aggs: Sequence[GroupbyAgg],
) -> Table:
    """Groupby with an exact output size (one host sync for the count;
    one more sizes the LIST pad of a collect aggregation without a
    ``list_capacity``: the largest group's valid rows, as the JAX
    package's count pre-pass gives it).

    Above :data:`CHUNKED_MIN_ROWS` rows the ``GROUPBY_FORMULATION`` flag
    routes it as the JAX package does: ``single`` (the default) runs the
    one sort below; ``packed`` tries the packed-key design
    (``groupby_packed.groupby_aggregate_packed``), then the chunked one;
    ``chunked`` the chunked one (``groupby_chunked``). A design that
    cannot take the shape gives way to the next."""
    formulation = "single"
    if table.row_count > CHUNKED_MIN_ROWS:
        from ..utils.config import get_flag

        formulation = get_flag("GROUPBY_FORMULATION")
    if formulation == "packed":
        from .groupby_packed import (
            groupby_aggregate_packed, packed_groupby_supported,
        )

        if packed_groupby_supported(table, by, aggs):
            out = groupby_aggregate_packed(table, by, aggs)
            if out is not None:
                return out
    if formulation in ("packed", "chunked"):
        from .groupby_chunked import (
            chunked_groupby_supported, groupby_aggregate_chunked,
        )

        if chunked_groupby_supported(table, aggs):
            out = groupby_aggregate_chunked(table, by, aggs)
            if out is not None:
                return out
    for a in aggs:
        _check_value(table.column(a.column), a.op)
    key_cols = [table.column(c) for c in by]
    out_names = _agg_names(table, by, aggs)
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
        col = table.column(a.column)
        cap = a.list_capacity
        if a.op in _COLLECT_OPS and cap is None:
            nv = _segment_sum(compute.valid_mask(col)[perm].to(torch.int64),
                              starts, ends)
            cap = max(1, int(nv.max()))
        out_cols.append(_aggregate(col, a.op, perm, seg, starts, ends,
                                   table.row_count, cap))
    return Table(out_cols, out_names)


#: above this, ``GROUPBY_FORMULATION`` packed/chunked routes a groupby
#: through the two-level designs (the JAX package's threshold)
CHUNKED_MIN_ROWS = 4_000_000


def _empty_result(table, key_cols, aggs, out_names) -> Table:
    """The 0-row result with the exact output schema."""
    dev = key_cols[0].data.device if key_cols else None
    no_rows = torch.zeros(0, dtype=torch.bool, device=dev)
    cols = [Column(k.data[:0], k.dtype, no_rows,
                   None if k.lengths is None else k.lengths[:0])
            for k in key_cols]
    for a in aggs:
        col = table.column(a.column)
        out = _out_dtype(a.op, col.dtype)
        if out.id == dt.TypeId.LIST:
            cols.append(Column(col.data.new_zeros((0, 1)), out, no_rows,
                               torch.zeros(0, dtype=torch.int32, device=dev)))
            continue
        cols.append(Column(torch.zeros(0, dtype=out.storage_dtype,
                                       device=dev), out, no_rows))
    return Table(cols, out_names)


# ---------------------------------------------------------------------------
# capped groupby: a static segment count, a device group count
# ---------------------------------------------------------------------------


def _capped_segment_sum(vals: torch.Tensor, starts, ends, rows: int):
    """The JAX package's ``_sorted_segment_sum``: cumsum differences over
    all ``rows`` sorted rows (floats in XLA's scan order, differences
    flushed), 0 for an empty segment."""
    n = vals.shape[0]
    c = _cumsum(vals, rows)
    hi = c[_clip_rows(ends.to(torch.int64) - 1, n)]
    lo = torch.where(starts > 0, c[_clip_rows(starts.to(torch.int64) - 1, n)],
                     torch.zeros((), dtype=c.dtype, device=c.device))
    return torch.where(ends > starts, compute.flush_subnormal(hi - lo),
                       torch.zeros((), dtype=c.dtype, device=c.device))


def _capped_aggregate(col: Column, op: str, perm, seg, starts, ends,
                      row_valid, num_segments: int, list_capacity) -> Column:
    """One aggregation of the capped groupby, with the JAX package's bytes
    in every one of its ``num_segments`` rows."""
    _check_value(col, op)
    n = perm.shape[0]
    valid = compute.valid_mask(col)
    if row_valid is not None:
        valid = valid & row_valid
    valid = valid[perm]
    data = take_rows(col.data, perm)

    def segsum(v, s, e):
        return _capped_segment_sum(v, s, e, n)

    if op in ("min", "max"):
        # a segment's extreme is the value the JAX package's segmented
        # scan holds at the segment's last row, and an empty segment
        # (past the groups) reads the last row's segment's
        r = _reduce(col, op, data, valid, seg, starts, ends, segsum,
                    num_segments - 1, n, None)
        ext = r.data[seg[_clip_rows(ends.to(torch.int64) - 1, n)].clamp(
            max=num_segments - 1)]
        return Column(ext, r.dtype, r.validity)
    return _reduce(col, op, data, valid, seg, starts, ends, segsum,
                   num_segments - 1, n, list_capacity)


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
    holds a valid row. A collect aggregation needs its ``list_capacity``
    (groups past it are truncated to it).

    Every segment id past the last one the rows reach is empty, and its
    output row is the same for each of them (a range past the last row):
    the aggregations run over the segments reached and one empty one,
    whose row fills the rest (one host sync reads the segment count)."""
    for a in aggs:
        _check_value(table.column(a.column), a.op)
    key_cols = [table.column(c) for c in by]
    n = table.row_count
    words = _group_words(key_cols, row_valid)
    perm = (None if row_valid is None
            else lexsort_occupied(words[1:], row_valid))
    perm, seg, _ = _sorted_segments(words, perm)
    if row_valid is not None:
        rv_sorted = row_valid[perm]
        num_groups = torch.where(rv_sorted, seg + 1, 0).max()
    else:
        num_groups = seg[-1] + 1
    m = num_segments if n == 0 else min(num_segments, int(seg[-1]) + 2)
    starts, ends = _segment_bounds(seg, m)
    in_range = torch.arange(m, device=perm.device) < num_groups
    first_rows = perm[_clip_rows(starts.to(torch.int64), n)]
    out_cols = []
    for col in key_cols:
        valid = compute.valid_mask(col)[first_rows] & in_range
        out_cols.append(Column(
            col.data[first_rows], col.dtype, valid,
            None if col.lengths is None else col.lengths[first_rows]))
    for a in aggs:
        r = _capped_aggregate(table.column(a.column), a.op, perm, seg, starts,
                              ends, row_valid, m, a.list_capacity)
        valid = compute.valid_mask(r) & in_range
        out_cols.append(Column(r.data, r.dtype, valid, r.lengths))
    out_cols = [Column(*(_fill_rows(x, num_segments)
                         for x in (c.data, c.dtype, c.validity, c.lengths)))
                for c in out_cols]
    return Table(out_cols, _agg_names(table, by, aggs)), num_groups


def _fill_rows(x, rows: int):
    """``x`` (a column's buffer) to ``rows`` rows, its last row repeated;
    anything else as it is."""
    if not isinstance(x, torch.Tensor) or x.shape[0] >= rows:
        return x
    return torch.cat([x, x[-1:].expand(rows - x.shape[0], *x.shape[1:])])
