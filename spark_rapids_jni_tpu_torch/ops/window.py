"""Window functions (port of ``ops/window.py``: cudf ``rolling_window`` /
grouped windows, Spark WindowExec): rolling aggregates over ROW and
RANGE frames, lead/lag, row_number and the rank family, with or without
PARTITION BY.

SUM/COUNT/MEAN windows are prefix-sum differences: FLOAT64 prefixes run
in XLA's scan order through ``groupby._cumsum`` (the scan16 kernel on
CUDA, its plain version on the CPU), integer prefixes ``torch.cumsum``.
MIN/MAX windows combine two overlapping power-of-two blocks of a sparse
table of winner positions, built level by level with only the newest
level's keys alive. Partition clamping is index arithmetic on the
layout sorted by (partition, order). Where the JAX package indexes with
``x[i]`` (which clamps), the port clamps the index.

The rank family (``rank``, ``dense_rank``, ``percent_rank``) also takes
``SortKey`` order terms (e.g. descending), on which the JAX package's
functions raise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column, Table
from . import compute
from .keys import CARRIER_MAX, SIGN64, column_order_keys

_SUMLIKE = {"sum", "count", "mean"}
_MINMAX = {"min", "max"}


def _at(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[idx]`` with the index clamped into range (JAX's gather)."""
    return v[idx.clamp(0, max(v.shape[0] - 1, 0)).long()]


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _window_bounds(n, preceding: int, following: int, part_start, part_end):
    """Per-row [start, end) frame, clamped to the partition."""
    i = _arange(n, part_start.device)
    start = torch.maximum(i - preceding, part_start)
    end = torch.minimum(i + following + 1, part_end)
    return start, torch.maximum(end, start)


def _count_window(valid, start, end):
    """Per-row count of valid values in [start, end) via prefix sums."""
    cnt = torch.cat([valid.new_zeros(1, dtype=torch.int64),
                     torch.cumsum(valid.to(torch.int64), 0)])
    return _at(cnt, end) - _at(cnt, start)


def _prefix_window(vals, valid, start, end, agg):
    """SUM/COUNT/MEAN via exclusive prefix sums over masked values.
    Returns ``(out, has, wcnt)``."""
    from .groupby import _cumsum

    flush = compute.flush_subnormal
    masked = torch.where(valid, vals, 0)
    if vals.is_floating_point():
        if masked.dtype == torch.float32:
            masked = flush(masked)  # XLA's convert reads them as zero
        acc = masked.to(torch.float64)
        cs = torch.cat([acc.new_zeros(1), _cumsum(acc, None)])
        wsum = flush(flush(_at(cs, end)) - flush(_at(cs, start)))
    else:
        acc = compute.as_int64(masked)
        cs = torch.cat([acc.new_zeros(1), torch.cumsum(acc, 0)])
        wsum = _at(cs, end) - _at(cs, start)
    wcnt = _count_window(valid, start, end)
    if agg == "count":
        return wcnt, wcnt >= 0, wcnt
    if agg == "sum":
        return wsum, wcnt > 0, wcnt
    mean = flush(compute.astype(wsum, torch.float64) / wcnt.clamp(min=1))
    return mean, wcnt > 0, wcnt


def _minmax_window(col: Column, start, end, op):
    """MIN/MAX over [start, end) via two overlapping blocks of a sparse
    table of winner positions, on order words (exact for every
    fixed-width dtype incl. f64 bit patterns). Nulls take an exiled word
    so they only win all-null frames; word ties between a null and a
    legitimate extreme break toward the VALID row, so the winner's
    validity decides the output. The block level is bit_length(len) - 1:
    where the JAX package's float log2 lands one level lower (at some
    powers of two), both levels cover the frame and give the same bytes
    (an all-null frame's winner is its first row either way)."""
    keys = column_order_keys(col)
    if len(keys) != 1:
        raise TypeError("window min/max: fixed-width columns only")
    valid = compute.valid_mask(col)
    exile = CARRIER_MAX if op == "min" else SIGN64
    key = torch.where(valid, keys[0], exile)
    length = (end - start).clamp(min=1)
    k = torch.frexp(length.to(torch.float64)).exponent - 1
    pos_table = _sparse_table_pos(key, valid, op)
    levels, n = pos_table.shape
    k = k.clamp(0, levels - 1).to(torch.int64)
    second = torch.maximum(end - torch.ones_like(k).bitwise_left_shift(k),
                           start)
    flat = pos_table.view(-1)
    pl = flat[k * n + start.clamp(0, max(n - 1, 0)).long()].long()
    pr = flat[k * n + second.clamp(0, max(n - 1, 0)).long()].long()
    kl, vl = key[pl], valid[pl]
    kr, vr = key[pr], valid[pr]
    tie = (kl == kr) & (vl | ~vr)
    take_left = ((kl < kr) if op == "min" else (kl > kr)) | tie
    pos = torch.where(take_left, pl, pr)
    # the winner is null only when the whole frame is null (or empty)
    return pos, valid[pos] & (end > start)


def _sparse_table_pos(keys, valid, op):
    """(K, n) int32 table of the index attaining the op over [i, i+2^k),
    with key ties broken toward valid rows (see _minmax_window). Each
    level is built from the one before; only that level's keys and
    validity stay alive, so the peak is the table plus two levels."""
    n = keys.shape[0]
    pad_val = CARRIER_MAX if op == "min" else SIGN64
    levels = 1 + max(n - 1, 0).bit_length()
    table = torch.empty((levels, n), dtype=torch.int32, device=keys.device)
    table[0] = _arange(n, keys.device)
    pk, pv = keys, valid
    k, lvl = 1, 1
    while k < n:
        pp = table[lvl - 1]
        pad_n = min(k, n)
        sk = torch.cat([pk[k:], pk.new_full((pad_n,), pad_val)])
        sv = torch.cat([pv[k:], pv.new_zeros(pad_n)])
        sp = torch.cat([pp[k:], pp[:pad_n]])
        tie = (pk == sk) & (pv | ~sv)
        keep = ((pk < sk) if op == "min" else (pk > sk)) | tie
        torch.where(keep, pp, sp, out=table[lvl])
        pk, pv = torch.where(keep, pk, sk), torch.where(keep, pv, sv)
        del sk, sv, sp, keep, tie
        k *= 2
        lvl += 1
    return table


def rolling_aggregate(
    col: Column,
    preceding: int,
    following: int,
    agg: str,
    min_periods: int = 1,
    partition_starts: Optional[torch.Tensor] = None,
    partition_ends: Optional[torch.Tensor] = None,
) -> Column:
    """Row-based rolling window over the column's current order.

    ``preceding``/``following`` are row counts either side of the current
    row (cudf rolling_window semantics). Rows whose frame holds fewer
    than ``min_periods`` valid values are null.
    """
    n = col.row_count
    dev = col.data.device
    ps = (partition_starts if partition_starts is not None
          else torch.zeros((n,), dtype=torch.int32, device=dev))
    pe = (partition_ends if partition_ends is not None
          else torch.full((n,), n, dtype=torch.int32, device=dev))
    start, end = _window_bounds(n, preceding, following, ps, pe)
    return _frame_aggregate(col, start, end, agg, min_periods)


def _frame_aggregate(
    col: Column, start, end, agg: str, min_periods: int
) -> Column:
    """Aggregate per-row frames [start, end) — the shared back half of
    the ROW and RANGE window paths."""
    valid = compute.valid_mask(col)

    if agg in _SUMLIKE:
        vals = compute.values(col)
        out, has, cnt = _prefix_window(vals, valid, start, end, agg)
        ok = has & (cnt >= min_periods)
        if agg == "count":
            return Column(out.to(torch.int32), dt.INT32, ok)
        if agg == "mean":
            if col.dtype.is_decimal:
                # unscaled ints -> logical values
                out = compute.flush_subnormal(out * (10.0 ** col.dtype.scale))
            if col.dtype.is_floating:
                # f64 accumulation, the input floating type out
                return compute.from_values(_narrow(out, vals.dtype),
                                           col.dtype, ok)
            return compute.from_values(out, dt.FLOAT64, ok)
        if col.dtype.is_floating:
            return compute.from_values(_narrow(out, vals.dtype), col.dtype,
                                       ok)
        out_dt = (dt.DType(dt.TypeId.DECIMAL64, col.dtype.scale)
                  if col.dtype.is_decimal else dt.INT64)
        return compute.from_values(out, out_dt, ok)

    if agg in _MINMAX:
        pos, has = _minmax_window(col, start, end, agg)
        cnt = _count_window(valid, start, end)
        ok = has & (cnt >= min_periods)
        return Column(col.data[pos], col.dtype, ok)

    raise ValueError(f"unknown window aggregation {agg!r}")


def _narrow(v: torch.Tensor, to: torch.dtype) -> torch.Tensor:
    """float64 -> the column's float type, results flushed as XLA's
    convert flushes them."""
    if to == torch.float64:
        return v
    return compute.flush_subnormal(v.to(to))


def _saturating_offset(vals: torch.Tensor, delta) -> torch.Tensor:
    """``vals + delta`` with integer wrap-around clamped to the dtype
    extreme (floats saturate to +-inf on their own). UINT64 values are
    walked on their bit patterns and compared unsigned (top bit
    flipped), never with signed wrap checks."""
    if vals.is_floating_point():
        flush = compute.flush_subnormal
        return flush(flush(vals) + torch.tensor(delta, dtype=vals.dtype))
    delta = int(delta)
    if delta == 0:
        return vals
    info = np.iinfo(compute.NP_OF[vals.dtype])
    if info.bits < 64:
        # widen: int64 holds any narrow dtype plus a clamped delta
        d = max(min(delta, 1 << 62), -(1 << 62))
        out = (compute.to_carrier(vals).to(torch.int64) + d).clamp(
            int(info.min), int(info.max))
        return compute.from_carrier(out, vals.dtype)
    # 8-byte lanes: walk the offset in quarter steps that fit int64,
    # detecting wrap after each (saturation is sticky)
    unsigned = vals.dtype == torch.uint64
    flip = SIGN64 if unsigned else 0
    out = vals.view(torch.int64) if unsigned else vals
    top = (info.max - (1 << 64)) if unsigned else int(info.max)
    bottom = int(info.min)
    mag = min(abs(delta), 1 << 64)  # >= full dtype span: total saturation
    while mag:
        q = min(mag, 1 << 62)
        mag -= q
        if delta > 0:
            nxt = out + q
            out = torch.where((nxt ^ flip) < (out ^ flip), top, nxt)
        else:
            nxt = out - q
            out = torch.where((nxt ^ flip) > (out ^ flip), bottom, nxt)
    return out.view(torch.uint64) if unsigned else out


def grouped_range_rolling_aggregate(
    table: Table,
    partition_by: Sequence,
    order_by: Union[int, str],
    value: Union[int, str],
    preceding,
    following,
    agg: str,
    min_periods: int = 1,
    ascending: bool = True,
) -> Column:
    """RANGE-framed rolling window (libcudf grouped_range_rolling_window /
    Spark ``RANGE BETWEEN x PRECEDING AND y FOLLOWING``), result in the
    table's ORIGINAL row order.

    Row i's frame holds every partition row j whose ORDER BY value lies
    within ``[v_i - preceding, v_i + following]`` (descending frames span
    ``[v_i - following, v_i + preceding]``); peers share a frame.
    ``None`` bounds are UNBOUNDED. Exactly one ORDER BY column; bounds
    are in its storage units. NULL order rows form one peer frame per
    partition.

    Each frame end is a multi-word binary search
    (``join._lex_searchsorted``) of ``(partition run, null word, order
    word of v_i -/+ bound)`` against the sorted rows' own words."""
    from .gather import gather_column
    from .join import _lex_searchsorted
    from .sort import SortKey

    n = table.row_count
    okey = SortKey(order_by, ascending=ascending)
    sorted_t, starts, ends, inv, _, new_part = _window_scaffold(
        table, partition_by, [okey])

    oc = sorted_t.column(order_by)
    okeys = column_order_keys(oc)
    if len(okeys) != 1:
        raise TypeError(
            "range frames need a fixed-width ORDER BY column "
            f"(got {oc.dtype})"
        )
    ovalid = compute.valid_mask(oc)
    vals = compute.values(oc)

    # the three words the rows are ordered by: partition run id, the
    # sort's null-placement word, and the direction-adjusted order word
    # (the u64 word 0 under nulls, whatever the sort's tie order)
    pid = torch.cumsum(new_part.to(torch.int64), 0)
    null_first = okey.resolved_nulls_first
    null_word = (ovalid if null_first else ~ovalid).to(torch.int64)
    kw = okeys[0] if ascending else ~okeys[0]
    kw = torch.where(ovalid, kw, SIGN64)
    sorted_words = [pid, null_word, kw]

    def shifted_key(delta):
        if delta is None:
            return None
        shifted = _saturating_offset(vals, delta)
        col = Column(compute.encode_values(shifted, oc.dtype), oc.dtype, None)
        k = column_order_keys(col)[0]
        return k if ascending else ~k

    if ascending:
        lo_kw = shifted_key(-preceding if preceding is not None else None)
        hi_kw = shifted_key(following if following is not None else None)
    else:
        lo_kw = shifted_key(preceding if preceding is not None else None)
        hi_kw = shifted_key(-following if following is not None else None)

    if lo_kw is None:
        start = starts
    else:
        # null rows bracket their own peer run (word zero, as sorted)
        q = [pid, null_word, torch.where(ovalid, lo_kw, SIGN64)]
        start = _lex_searchsorted(sorted_words, q, "left")
    if hi_kw is None:
        end = ends
    else:
        q = [pid, null_word, torch.where(ovalid, hi_kw, SIGN64)]
        end = _lex_searchsorted(sorted_words, q, "right")
    start = torch.minimum(torch.maximum(start, starts), ends)
    end = torch.minimum(torch.maximum(end, start), ends)

    out_sorted = _frame_aggregate(
        sorted_t.column(value), start, end, agg, min_periods)
    return gather_column(out_sorted, inv)


def _partition_bounds(new_part: torch.Tensor):
    """(starts, ends) per row for rows sorted by the partition keys, from
    the partition-boundary vector ``new_part``."""
    n = new_part.shape[0]
    # starts: the last boundary at or before the row (cummax of
    # boundary indices); ends: the first boundary after it, else n
    starts = compute.last_true_index(new_part).clamp(min=0)
    ends = torch.cat([compute.next_true_index(new_part)[1:],
                      new_part.new_full((min(n, 1),), n, dtype=torch.int64)])
    return starts.to(torch.int32), ends.to(torch.int32)


def grouped_rolling_aggregate(
    table: Table,
    partition_by: Sequence,
    order_by: Sequence,
    value: Union[int, str],
    preceding: int,
    following: int,
    agg: str,
    min_periods: int = 1,
) -> Column:
    """PARTITION BY + ORDER BY rolling window; result aligned to the
    table's ORIGINAL row order (Spark WindowExec contract)."""
    from .gather import gather_column

    sorted_t, starts, ends, inv, _, _ = _window_scaffold(
        table, partition_by, order_by)
    out_sorted = rolling_aggregate(
        sorted_t.column(value), preceding, following, agg, min_periods,
        partition_starts=starts, partition_ends=ends)
    return gather_column(out_sorted, inv)


def lead(col: Column, n: int = 1, partition_ids=None) -> Column:
    """Value ``n`` rows ahead; null past the end (Spark LEAD)."""
    return _shift(col, -n, partition_ids)


def lag(col: Column, n: int = 1, partition_ids=None) -> Column:
    """Value ``n`` rows behind; null before the start (Spark LAG)."""
    return _shift(col, n, partition_ids)


def _shift(col: Column, n: int, partition_ids) -> Column:
    size = col.row_count
    idx = _arange(size, col.data.device) - n
    in_range = (idx >= 0) & (idx < size)
    safe = idx.clamp(0, max(size - 1, 0)).long()
    if partition_ids is not None:
        in_range = in_range & (partition_ids[safe] == partition_ids)
    from .gather import take_rows

    data = take_rows(col.data, safe)
    valid = (in_range if col.validity is None
             else in_range & col.validity[safe])
    lengths = None if col.lengths is None else col.lengths[safe]
    return Column(data, col.dtype, valid, lengths)


def row_number(
    table: Table, partition_by: Sequence, order_by: Sequence
) -> Column:
    """1-based rank within each partition, in the table's original row
    order (Spark ROW_NUMBER)."""
    from .gather import gather_column

    _, starts, _, inv, idx, _ = _window_scaffold(
        table, partition_by, order_by)
    return gather_column(Column(idx - starts + 1, dt.INT32, None), inv)


def _key_ref(k):
    from .sort import SortKey

    return k.column if isinstance(k, SortKey) else k


def _change_boundaries(table: "_SortedView", keys: Sequence) -> torch.Tensor:
    """(n,) bool: row i starts a new run of the key columns. Null rows
    compare EQUAL to each other (payload words are zeroed under the
    validity mask and the mask itself is a word) — the SQL tie rule for
    NULL order keys."""
    n = table.row_count
    boundary = None
    for c in (table.column(_key_ref(k)) for k in keys):
        cwords = column_order_keys(c)
        if c.validity is not None:
            cwords = [torch.where(c.validity, w, SIGN64)
                      for w in cwords]
            cwords.append(c.validity.to(torch.int64))
        for w in cwords:
            change = torch.ones((n,), dtype=torch.bool, device=w.device)
            change[1:] = w[1:] != w[:-1]
            boundary = change if boundary is None else boundary | change
    if boundary is None:
        return torch.zeros((n,), dtype=torch.bool, device=table.device)
    return boundary


class _SortedView:
    """A table's rows in ``perm`` order, each column gathered when it is
    first read: a window reads its keys and one value column, where the
    JAX package's ``gather_table`` moves every column of the table."""

    def __init__(self, table: Table, perm: torch.Tensor):
        self._table, self._perm, self._cols = table, perm, {}
        self.row_count, self.device = table.row_count, perm.device

    def column(self, key) -> Column:
        from .gather import gather_column

        i = self._table.names.index(key) if isinstance(key, str) else key
        if i not in self._cols:
            self._cols[i] = gather_column(self._table.columns[i], self._perm)
        return self._cols[i]


def _window_scaffold(table: Table, partition_by, order_by):
    """Shared sort scaffolding for the ranking and range-frame families:
    the table sorted by (partition, order) keys (a :class:`_SortedView`),
    per-row partition [start, end), the inverse permutation back to the
    original row order, and the partition-boundary vector. Entries of
    ``order_by`` may be plain column refs or SortKey."""
    from .sort import SortKey, argsort_table

    n = table.row_count
    sort_keys = [k if isinstance(k, SortKey) else SortKey(k)
                 for k in [*partition_by, *order_by]]
    perm = argsort_table(table, sort_keys)
    sorted_t = _SortedView(table, perm)
    part_refs = [_key_ref(k) for k in partition_by]
    new_part = _change_boundaries(sorted_t, part_refs)
    starts, ends = _partition_bounds(new_part)
    idx = _arange(n, perm.device)
    inv = torch.zeros((n,), dtype=torch.int32, device=perm.device)
    inv.scatter_(0, perm, idx)
    return sorted_t, starts, ends, inv.long(), idx, new_part


def _rank_sorted(table: Table, partition_by, order_by, kind: str):
    """Shared rank machinery: the rank vector in sorted order plus the
    inverse permutation back to table order."""
    n = table.row_count
    sorted_t, starts, ends, inv, idx, _ = _window_scaffold(
        table, partition_by, order_by)
    # tie boundary: any (partition + order) key run changes
    boundary = _change_boundaries(sorted_t, [*partition_by, *order_by])
    if kind == "rank":
        # rank = position of the tie group's first row within partition
        group_start = compute.last_true_index(boundary).clamp(min=0)
        r = group_start - starts + 1
    elif kind == "dense_rank":
        # count of tie boundaries since the partition start (inclusive)
        cum_b = torch.cumsum(boundary.to(torch.int32), 0)
        r = cum_b - _at(cum_b, starts) + 1
    else:
        raise ValueError(f"unknown rank kind {kind!r}")
    return r.to(torch.int32), inv, starts, ends


def rank(table: Table, partition_by: Sequence, order_by: Sequence) -> Column:
    """SQL RANK(): 1-based with gaps after ties (Spark/cudf rank),
    returned in the table's original row order."""
    from .gather import gather_column

    r, inv, _, _ = _rank_sorted(table, partition_by, order_by, "rank")
    return gather_column(Column(r, dt.INT32, None), inv)


def dense_rank(
    table: Table, partition_by: Sequence, order_by: Sequence
) -> Column:
    """SQL DENSE_RANK(): 1-based, no gaps after ties."""
    from .gather import gather_column

    r, inv, _, _ = _rank_sorted(table, partition_by, order_by, "dense_rank")
    return gather_column(Column(r, dt.INT32, None), inv)


def percent_rank(
    table: Table, partition_by: Sequence, order_by: Sequence
) -> Column:
    """SQL PERCENT_RANK(): (rank - 1) / (partition rows - 1); 0.0 for
    single-row partitions (Spark semantics)."""
    from .gather import gather_column

    r, inv, starts, ends = _rank_sorted(table, partition_by, order_by,
                                        "rank")
    size = (ends - starts).to(torch.float64)
    pr = torch.where(size > 1,
                     (r - 1).to(torch.float64) / (size - 1).clamp(min=1),
                     0.0)
    return gather_column(compute.from_values(pr, dt.FLOAT64, None), inv)


def ntile(
    table: Table, partition_by: Sequence, order_by: Sequence, n_tiles: int
) -> Column:
    """SQL NTILE(n): 1-based bucket of each row within its partition,
    larger buckets first when rows don't divide evenly (Spark/cudf)."""
    from .gather import gather_column

    if n_tiles <= 0:
        raise ValueError("ntile: n_tiles must be positive")
    _, starts, ends, inv, idx, _ = _window_scaffold(
        table, partition_by, order_by)
    pos = idx - starts  # 0-based position within partition
    size = ends - starts
    base = size // n_tiles
    rem = size % n_tiles
    # first `rem` buckets have base+1 rows
    big_span = rem * (base + 1)
    tile = torch.where(
        pos < big_span,
        pos // (base + 1).clamp(min=1),
        rem + (pos - big_span) // base.clamp(min=1),
    )
    return gather_column(Column((tile + 1).to(torch.int32), dt.INT32, None),
                         inv)
