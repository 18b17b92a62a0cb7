"""Equi-joins (port of ``ops/join.py``): inner, left, right and full
outer, semi and anti, their capped and count forms, and the chunked
inner join.

Output order is the JAX package's: left rows in order, each followed by
its matches in the right side's stable (validity, key) order; a right or
full outer join then appends the unmatched right rows in their original
order. Inner and left joins give the left table's columns, then the
right table's minus its join keys (Spark USING); right and full joins
coalesce the key columns (left's key where a left row exists, else
right's). Null keys never match: a semi join drops null-key rows and an
anti join keeps them (Spark's NOT EXISTS).

Where the JAX package binary-searches a sorted build side, the port
gives every key tuple of both sides one dense id (``torch.unique`` over
the order words) and reads match ranges off a stable sort of the right
side by (valid, id) — the same pairs in the same order, and the same
lower bounds, which unmatched and padding rows read.

The JAX joins raise ``TypeError`` when the build side has 0 rows and the
probe side has rows (right and full joins also when the left side is
empty); the port returns Spark's result there.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .. import dtype as dt
from ..column import Column, Table
from . import compute
from . import keys as keys_mod
from .gather import gather_table

#: The chunked inner join's smallest output budget a probe chunk (a host
#: rule: a chunk whose padded output passes its budget splits in two).
MIN_CHUNK_OUT_BYTES = 64 << 20


def _resolve(table: Table, c) -> int:
    if isinstance(c, str):
        return table.names.index(c)
    return int(c)


def join_output(
    left: Table,
    right: Table,
    right_on: Sequence[Union[int, str]],
    left_idx: torch.Tensor,
    right_idx: torch.Tensor,
    matched: Optional[torch.Tensor],
) -> Table:
    """left columns + right columns minus the right join keys; rows whose
    ``matched`` is False are null on the right side (and may point into
    an empty right table)."""
    drop = {_resolve(right, c) for c in right_on
            if not isinstance(c, str) or right.names is not None}
    out_cols = list(gather_table(left, left_idx).columns)
    out_names = (list(left.names) if left.names
                 else [f"l{i}" for i in range(left.num_columns)])
    for j, c in enumerate(right.columns):
        if j in drop:
            continue
        out_cols.append(
            _gather_clipped(Table([c]), right_idx, matched).columns[0]
        )
        out_names.append(right.names[j] if right.names else f"r{j}")
    return Table(out_cols, out_names)


def _key_words(cols: Sequence[Column], occupied: Optional[torch.Tensor]):
    """(order words with null-key rows set to the u64 word 0, mask of the
    rows that can match: every key valid and ``occupied``), as the JAX
    package's ``_key_words`` and its ``left_valid``/``right_valid`` give
    them."""
    valid = torch.ones(cols[0].data.shape[0], dtype=torch.bool,
                       device=cols[0].data.device)
    for c in cols:
        if c.validity is not None:
            valid = valid & c.validity
    words = [torch.where(valid, w, keys_mod.SIGN64)
             for w in keys_mod.table_order_keys(list(cols))]
    if occupied is not None:
        valid = valid & occupied
    return words, valid


def _lex_searchsorted(sorted_words: Sequence[torch.Tensor],
                      query_words: Sequence[torch.Tensor],
                      side: str) -> torch.Tensor:
    """Vectorized multi-word binary search (lower or upper bound) of each
    query row in rows sorted by ``sorted_words`` (int64 carrier words,
    so signed compares are the JAX package's unsigned ones): a fixed
    ceil(log2(m + 1)) steps, each a gather and two compares a word, the
    same steps and the same int32 result as the JAX package's."""
    m = sorted_words[0].shape[0]
    nq = query_words[0].shape[0]
    dev = query_words[0].device
    lo = torch.zeros((nq,), dtype=torch.int32, device=dev)
    hi = torch.full((nq,), m, dtype=torch.int32, device=dev)
    steps = max(1, m.bit_length())  # ceil(log2(m + 1)), at least 1
    for _ in range(steps):
        mid = (lo + hi) // 2
        safe_mid = mid.clamp(0, max(m - 1, 0)).long()
        # go_right: sorted[mid] < q (lower bound) or <= q (upper bound)
        lt = torch.zeros((nq,), dtype=torch.bool, device=dev)
        eq = torch.ones((nq,), dtype=torch.bool, device=dev)
        for sw, qw in zip(sorted_words, query_words):
            sv = sw[safe_mid] if m > 0 else torch.zeros_like(qw)
            lt = lt | (eq & (sv < qw))
            eq = eq & (sv == qw)
        go_right = lt | eq if side == "right" else lt
        active = lo < hi
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _equalize_string_keys(lcols, rcols):
    """String key pairs repadded to one width, so both sides give the
    same number of order words (pad bytes are zero; lengths stay). A
    STRING key against a non-STRING one raises ``TypeError``."""
    lcols, rcols = list(lcols), list(rcols)
    for i, (lc, rc) in enumerate(zip(lcols, rcols)):
        if lc.dtype.is_string or rc.dtype.is_string:
            if not (lc.dtype.is_string and rc.dtype.is_string):
                raise TypeError("join key dtypes differ: STRING vs non-STRING")
            from .strings import common_pad

            lcols[i], rcols[i] = common_pad([lc, rc])
    return lcols, rcols


def _dense_ids(lwords, rwords):
    """One dense id per distinct key tuple over both sides, in the key
    order (ids of a one-word key from a 1-D ``torch.unique``)."""
    if len(lwords) == 1:
        both = torch.cat([lwords[0], rwords[0]])
        _, kid = torch.unique(both, return_inverse=True)
    else:
        both = torch.stack(
            [torch.cat([lw, rw]) for lw, rw in zip(lwords, rwords)], dim=1)
        _, kid = torch.unique(both, dim=0, return_inverse=True)
    return kid


def match_ranges(
    left: Table,
    right: Table,
    left_on: Sequence[Union[int, str]],
    right_on: Sequence[Union[int, str]],
    left_valid: Optional[torch.Tensor] = None,
    right_valid: Optional[torch.Tensor] = None,
):
    """(perm_r, lo, counts) of the JAX package's ``_match_ranges``: the
    right rows stably sorted by (valid, key) — rows with a null key or
    ``right_valid`` False first, each group by its key — and per left
    row the ``[lo, lo + count)`` range of its matches in that order.
    ``lo`` is the lower bound the JAX package's binary search returns
    (for rows that match nothing too); rows with a null key or
    ``left_valid`` False match nothing."""
    lcols, rcols = _equalize_string_keys([left.column(c) for c in left_on],
                                         [right.column(c) for c in right_on])
    lwords, lvalid = _key_words(lcols, left_valid)
    rwords, rvalid = _key_words(rcols, right_valid)
    nl = lvalid.shape[0]
    kid = _dense_ids(lwords, rwords)
    lkid, rkid = kid[:nl], kid[nl:]
    nr = rkid.shape[0]
    nkeys = nl + nr  # a bound on the ids, known without a sync
    perm_r = torch.sort(rkid + rvalid.to(torch.int64) * nkeys,
                        stable=True).indices
    # rows that cannot match count in a slot of their own past the ids
    # (padding rows would pile onto their one key's counter)
    per_key = torch.zeros(nkeys + nr, dtype=torch.int64, device=kid.device)
    per_key.index_add_(0, torch.where(
        rvalid, rkid, nkeys + torch.arange(nr, device=kid.device)),
        rvalid.to(torch.int64))
    per_key = per_key[:nkeys]
    first = torch.cumsum(per_key, 0) - per_key
    n_invalid = (~rvalid).sum()
    lo = n_invalid + first[lkid]
    counts = torch.where(lvalid, per_key[lkid], 0)
    return perm_r, lo, counts


def _gather_clipped(table: Table, idx: torch.Tensor,
                    index_valid: Optional[torch.Tensor] = None) -> Table:
    """``gather_table`` that also takes rows of a 0-row table (where the
    JAX package's clipped gather raises): such rows read zeros, null
    wherever ``index_valid`` says so."""
    if table.row_count == 0 and idx.numel():
        one = [Column(c.data.new_zeros((1,) + tuple(c.data.shape[1:])),
                      c.dtype,
                      None if c.validity is None else c.validity.new_zeros(1),
                      None if c.lengths is None else c.lengths.new_zeros(1))
               for c in table.columns]
        table, idx = Table(one, table.names), torch.zeros_like(idx)
    return gather_table(table, idx, index_valid)


def _expand(perm_r, lo, counts, total: int,
            emit: Optional[torch.Tensor] = None):
    """(left_idx, right_idx, matched, in_range) of ``total`` pair slots,
    without a host sync: left row i owns ``emit[i]`` slots (by default
    ``counts[i]``), so the owner of slot p is the number of rows whose
    slots end at or before p (one binary search over the running ends);
    slots past the emitted total repeat the last left row, as
    ``jnp.repeat``'s ``total_repeat_length`` fills them. ``matched`` is
    the slots that hold a match; the others of an emitting row are its
    outer row."""
    dev = counts.device
    if emit is None:
        emit = counts
    n_left = counts.shape[0]
    slot = torch.arange(total, device=dev)
    if n_left == 0:
        none = torch.zeros(total, dtype=torch.bool, device=dev)
        zero = torch.zeros(total, dtype=torch.int64, device=dev)
        return zero, zero, none, none
    ends = torch.cumsum(emit, 0)
    start = ends - emit
    in_range = slot < ends[-1]
    left_idx = torch.where(
        in_range, torch.searchsorted(ends, slot, right=True), n_left - 1)
    k = slot - start[left_idx]
    matched = (k < counts[left_idx]) & in_range
    if perm_r.numel() == 0:
        right_idx = torch.zeros_like(slot)
    else:
        pos = (lo[left_idx] + k).clamp(0, perm_r.shape[0] - 1)
        right_idx = perm_r[pos]
    return left_idx, right_idx, matched, in_range


def _empty_pairs(left: Table, right: Table, right_on) -> Table:
    """The JAX package's 0-row join result: right columns gain an empty
    validity vector from its zero-length match mask."""
    dev = left.columns[0].data.device
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    return join_output(left, right, right_on, empty, empty,
                       torch.zeros(0, dtype=torch.bool, device=dev))


def inner_join(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    right_on: Optional[Sequence[Union[int, str]]] = None,
) -> Table:
    """Inner equi-join with an exact output size (one host sync)."""
    right_on = right_on or on
    if left.row_count == 0 or right.row_count == 0:
        return _empty_pairs(left, right, right_on)
    perm_r, lo, counts = match_ranges(left, right, on, right_on)
    return _inner_pairs(left, right, right_on, perm_r, lo, counts,
                        int(counts.sum()))


def _inner_pairs(left, right, right_on, perm_r, lo, counts,
                 total: int) -> Table:
    """The exact inner join of already-computed match ranges."""
    if total == 0:
        return _empty_pairs(left, right, right_on)
    left_idx, right_idx, _, _ = _expand(perm_r, lo, counts, total)
    return join_output(left, right, right_on, left_idx, right_idx, None)


def inner_join_count(left, right, on, right_on=None, left_valid=None,
                     right_valid=None) -> torch.Tensor:
    """The device match count: phase 1 of two-phase output sizing."""
    right_on = right_on or on
    _, _, counts = match_ranges(left, right, on, right_on, left_valid,
                                right_valid)
    return counts.sum()


# ---------------------------------------------------------------------------
# capped join: a static output capacity, a device match count
# ---------------------------------------------------------------------------


def _null_padding(out: Table, in_range: torch.Tensor) -> Table:
    """Every column of a pair slot past the count is null."""
    cols = [Column(c.data, c.dtype,
                   in_range if c.validity is None else c.validity & in_range,
                   c.lengths) for c in out.columns]
    return Table(cols, out.names)


def inner_join_from_ranges(
    left: Table,
    right: Table,
    right_on: Sequence[Union[int, str]],
    perm_r,
    lo,
    counts,
    capacity: int,
) -> tuple[Table, torch.Tensor]:
    """A capped inner join from already-computed match ranges: pairs past
    the count are padding, and every column of a padding row is null."""
    left_idx, right_idx, matched, in_range = _expand(
        perm_r, lo, counts, capacity)
    out = join_output(left, right, right_on, left_idx, right_idx, matched)
    return _null_padding(out, in_range), counts.sum()


def inner_join_capped(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    capacity: int,
    right_on: Optional[Sequence[Union[int, str]]] = None,
    left_valid: Optional[torch.Tensor] = None,
    right_valid: Optional[torch.Tensor] = None,
) -> tuple[Table, torch.Tensor]:
    """Inner join with a static output capacity: (table of ``capacity``
    rows, device match count). Pairs come in the JAX package's order:
    left rows in order, each followed by its matches in the right side's
    stable order; rows with ``left_valid``/``right_valid`` False match
    nothing."""
    right_on = right_on or on
    perm_r, lo, counts = match_ranges(
        left, right, on, right_on, left_valid, right_valid)
    return inner_join_from_ranges(left, right, right_on, perm_r, lo, counts,
                                  capacity)


def _left_emit(counts: torch.Tensor,
               left_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Output rows a left row emits in a LEFT OUTER join: its matches, or
    one null-extended row; a padding row (``left_valid`` False) none."""
    emit = counts.clamp(min=1)
    return emit if left_valid is None else torch.where(left_valid, emit, 0)


def left_join_capped(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    capacity: int,
    right_on: Optional[Sequence[Union[int, str]]] = None,
    left_valid: Optional[torch.Tensor] = None,
    right_valid: Optional[torch.Tensor] = None,
) -> tuple[Table, torch.Tensor]:
    """LEFT OUTER join with a static output capacity: (table of
    ``capacity`` rows, device row count). Every occupied left row emits
    at least once; rows past the count are null."""
    right_on = right_on or on
    perm_r, lo, counts = match_ranges(
        left, right, on, right_on, left_valid, right_valid)
    emit = _left_emit(counts, left_valid)
    left_idx, right_idx, matched, in_range = _expand(
        perm_r, lo, counts, capacity, emit)
    out = join_output(left, right, right_on, left_idx, right_idx, matched)
    return _null_padding(out, in_range), emit.sum()


def left_join_count(left, right, on, right_on=None, left_valid=None,
                    right_valid=None) -> torch.Tensor:
    """The device row count of a LEFT OUTER join: matches plus one per
    unmatched occupied left row (null-key rows count, padding rows do
    not)."""
    right_on = right_on or on
    _, _, counts = match_ranges(left, right, on, right_on, left_valid,
                                right_valid)
    return _left_emit(counts, left_valid).sum()


def left_join(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    right_on: Optional[Sequence[Union[int, str]]] = None,
) -> Table:
    """LEFT OUTER equi-join with an exact output size (one host sync):
    every left row with its matches, or once with a null right side."""
    right_on = right_on or on
    perm_r, lo, counts = match_ranges(left, right, on, right_on)
    emit = counts.clamp(min=1)
    left_idx, right_idx, matched, _ = _expand(perm_r, lo, counts,
                                              int(emit.sum()), emit)
    return join_output(left, right, right_on, left_idx, right_idx, matched)


# ---------------------------------------------------------------------------
# semi / anti joins
# ---------------------------------------------------------------------------


def membership_mask(left, right, on, right_on=None, left_valid=None,
                    right_valid=None) -> torch.Tensor:
    """Per left row: has at least one match in ``right`` (the SEMI/ANTI
    predicate). A null key or ``left_valid`` False never matches."""
    right_on = right_on or on
    _, _, counts = match_ranges(left, right, on, right_on, left_valid,
                                right_valid)
    return counts > 0


def _keep(left: Table, keep: torch.Tensor) -> Table:
    from .filter import filter_table

    return filter_table(left, Column(keep, dt.BOOL8, None))


def semi_join(left, right, on, right_on=None) -> Table:
    """Rows of ``left`` with at least one match (LEFT SEMI)."""
    return _keep(left, membership_mask(left, right, on, right_on))


def anti_join(left, right, on, right_on=None) -> Table:
    """Rows of ``left`` with no match (LEFT ANTI): null-key rows stay."""
    return _keep(left, ~membership_mask(left, right, on, right_on))


# ---------------------------------------------------------------------------
# right / full outer joins
# ---------------------------------------------------------------------------


def _coalesce_key(lc: Column, rc: Column, left_idx, right_idx, left_ok,
                  right_ok) -> Column:
    """An output key column under USING: ``coalesce(l.k, r.k)``, left's
    key where a left row exists, right's on right-only rows."""
    if lc.dtype != rc.dtype:
        raise TypeError(
            f"outer-join key dtypes differ: {lc.dtype} vs {rc.dtype}")
    if lc.dtype.is_string:
        from .strings import common_pad

        lc, rc = common_pad([lc, rc])
    lg = _gather_clipped(Table([lc]), left_idx).columns[0]
    rg = _gather_clipped(Table([rc]), right_idx).columns[0]
    pick = left_ok.reshape(left_ok.shape + (1,) * (lg.data.dim() - 1))
    data = torch.where(pick, lg.data, rg.data)
    valid = torch.where(left_ok, compute.valid_mask(lg) & left_ok,
                        compute.valid_mask(rg) & right_ok)
    lengths = (None if lg.lengths is None
               else torch.where(left_ok, lg.lengths, rg.lengths))
    return Column(data, lc.dtype, valid, lengths)


def _outer_output(left, right, left_on, right_on, left_idx, right_idx,
                  left_ok, right_ok) -> Table:
    """Key columns coalesced, left non-keys null where ``left_ok`` is
    False, right non-keys (minus the right join keys) where ``right_ok``
    is."""
    lkeys = [_resolve(left, c) for c in left_on]
    rkeys = [_resolve(right, c) for c in right_on]
    rkey_of = dict(zip(lkeys, rkeys))
    names = (list(left.names) if left.names
             else [f"l{i}" for i in range(left.num_columns)])
    out = []
    for j, c in enumerate(left.columns):
        if j in rkey_of:
            out.append(_coalesce_key(c, right.columns[rkey_of[j]], left_idx,
                                     right_idx, left_ok, right_ok))
        else:
            out.append(
                _gather_clipped(Table([c]), left_idx, left_ok).columns[0])
    for j, c in enumerate(right.columns):
        if j in rkeys:
            continue
        out.append(_gather_clipped(Table([c]), right_idx, right_ok).columns[0])
        names.append(right.names[j] if right.names else f"r{j}")
    return Table(out, names)


def _unmatched_right(left, right, on, right_on) -> torch.Tensor:
    """Right rows with no match in ``left`` (null keys included): the rows
    a RIGHT/FULL OUTER join appends."""
    _, _, counts = match_ranges(right, left, right_on, on)
    return counts == 0


def _with_right_only(left, right, on, right_on, left_idx, right_idx,
                     right_ok) -> Table:
    """Pairs, then the unmatched right rows in their order with a null
    left side (left row 0, as the JAX package gathers it)."""
    run_idx = torch.nonzero(_unmatched_right(left, right, on,
                                             right_on)).flatten()
    n_pairs, n_run = left_idx.shape[0], run_idx.shape[0]
    dev = left_idx.device
    left_idx = torch.cat([left_idx, torch.zeros(n_run, dtype=left_idx.dtype,
                                                device=dev)])
    right_idx = torch.cat([right_idx, run_idx])
    left_ok = torch.arange(n_pairs + n_run, device=dev) < n_pairs
    right_ok = torch.cat([right_ok, torch.ones(n_run, dtype=torch.bool,
                                               device=dev)])
    return _outer_output(left, right, on, right_on, left_idx, right_idx,
                         left_ok, right_ok)


def right_join(left, right, on, right_on=None) -> Table:
    """RIGHT OUTER equi-join: the inner pairs, then the unmatched right
    rows with a null left side (keys coalesced from the right)."""
    right_on = right_on or on
    perm_r, lo, counts = match_ranges(left, right, on, right_on)
    left_idx, right_idx, matched, _ = _expand(perm_r, lo, counts,
                                              int(counts.sum()))
    return _with_right_only(left, right, on, right_on, left_idx, right_idx,
                            torch.ones_like(matched))


def full_join(left, right, on, right_on=None) -> Table:
    """FULL OUTER equi-join: the left join's rows, then the unmatched
    right rows with a null left side."""
    right_on = right_on or on
    perm_r, lo, counts = match_ranges(left, right, on, right_on)
    emit = counts.clamp(min=1)
    left_idx, right_idx, matched, _ = _expand(perm_r, lo, counts,
                                              int(emit.sum()), emit)
    return _with_right_only(left, right, on, right_on, left_idx, right_idx,
                            matched)


# ---------------------------------------------------------------------------
# the memory-bounded chunked inner join
# ---------------------------------------------------------------------------


def inner_join_batched(left, right, on, right_on=None,
                       probe_rows: Optional[int] = None) -> Table:
    """The inner join in probe-side chunks (:func:`inner_join_batches`),
    concatenated: the same rows as :func:`inner_join`."""
    from .copying import concatenate

    right_on = right_on or on
    pieces = list(inner_join_batches(left, right, on, right_on, probe_rows))
    if not pieces:
        return _empty_pairs(left, right, right_on)
    return concatenate(pieces) if len(pieces) > 1 else pieces[0]


def inner_join_batches(left, right, on, right_on=None,
                       probe_rows: Optional[int] = None):
    """The inner join as one result table per probe chunk, in order,
    skipping chunks without matches: at no point is more than one
    chunk's output held. A chunk has ``probe_rows`` rows, by default the
    device-memory plan's (``utils/hbm.py`` ``join_plan``: what fits the
    budget beside both inputs and the build's key words); a chunk of
    more than 1,024 rows whose output, padded to a power of two, passes
    its budget (at least :data:`MIN_CHUNK_OUT_BYTES`) splits in two.
    Arguments, and the warning that the inputs alone pass the budget,
    come at the call, not at the first chunk."""
    from ..utils import hbm

    right_on = right_on or on
    if probe_rows is None:
        plan = hbm.join_plan(left, right, on, right_on)
        if not plan["fits"]:
            # no probe size can save it; the reserve is conservative, so
            # this warns and proceeds at the smallest chunks
            import warnings

            warnings.warn(
                "join inputs exceed the device memory budget before any "
                f"probe chunk ({plan['fixed_bytes']} fixed vs "
                f"{plan['budget_bytes']} budget); expect allocator "
                "pressure. Raise SPARK_RAPIDS_TPU_HBM_BUDGET_GB if the "
                "device really has more.",
                stacklevel=2,
            )
        probe_rows = plan["probe_rows"]
    if probe_rows <= 0:
        raise ValueError(f"probe_rows must be positive, got {probe_rows}")
    out_row_bytes = hbm.row_bytes(left) + hbm.row_bytes(right)
    return _inner_join_batches_gen(left, right, on, right_on, probe_rows,
                                   out_row_bytes)


def _inner_join_batches_gen(left, right, on, right_on, probe_rows,
                            out_row_bytes):
    from collections import deque

    from .copying import slice_rows

    n = left.row_count
    if n == 0 or right.row_count == 0:
        return
    budget = max(probe_rows * 2 * out_row_bytes, MIN_CHUNK_OUT_BYTES)
    spans = deque((s, min(s + probe_rows, n)) for s in range(0, n, probe_rows))
    while spans:
        start, stop = spans.popleft()
        chunk = slice_rows(left, start, stop)
        perm_r, lo, counts = match_ranges(chunk, right, on, right_on)
        total = int(counts.sum())
        if total == 0:
            continue
        cap = max(32, 1 << (total - 1).bit_length())
        if cap * out_row_bytes > budget and stop - start > 1024:
            mid = (start + stop) // 2
            spans.appendleft((mid, stop))
            spans.appendleft((start, mid))
            continue
        yield _inner_pairs(chunk, right, right_on, perm_r, lo, counts, total)
