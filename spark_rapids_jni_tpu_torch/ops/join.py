"""Inner equi-join (port of ``ops/join.py`` ``inner_join`` and
``inner_join_capped``).

Output order is the JAX package's: left rows in order, each followed by
its matches in the right side's original order (the stable build sort);
columns are the left table's, then the right table's minus its join keys
(Spark USING). Null keys never match.

Where the JAX package binary-searches a sorted build side, the port
gives every key tuple of both sides one dense id (``torch.unique`` over
the order words) and reads match ranges off a stable sort of the right
side by (valid, id) — the same pairs in the same order, and the same
lower bounds, which the capped join's padding rows read.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..column import Column, Table
from . import keys as keys_mod
from .gather import gather_table


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
    """left columns + right columns minus the right join keys."""
    drop = {_resolve(right, c) for c in right_on
            if not isinstance(c, str) or right.names is not None}
    out_cols = list(gather_table(left, left_idx).columns)
    out_names = (list(left.names) if left.names
                 else [f"l{i}" for i in range(left.num_columns)])
    for j, c in enumerate(right.columns):
        if j in drop:
            continue
        out_cols.append(
            gather_table(Table([c]), right_idx, matched).columns[0]
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
    lwords, lvalid = _key_words([left.column(c) for c in left_on],
                                left_valid)
    rwords, rvalid = _key_words([right.column(c) for c in right_on],
                                right_valid)
    nl = lvalid.shape[0]
    kid = _dense_ids(lwords, rwords)
    lkid, rkid = kid[:nl], kid[nl:]
    nkeys = nl + rkid.shape[0]  # a bound on the ids, known without a sync
    perm_r = torch.sort(rkid + rvalid.to(torch.int64) * nkeys,
                        stable=True).indices
    per_key = torch.zeros(nkeys, dtype=torch.int64, device=kid.device)
    per_key.index_add_(0, rkid, rvalid.to(torch.int64))
    first = torch.cumsum(per_key, 0) - per_key
    n_invalid = (~rvalid).sum()
    lo = n_invalid + first[lkid]
    counts = torch.where(lvalid, per_key[lkid], 0)
    return perm_r, lo, counts


def inner_join(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    right_on: Optional[Sequence[Union[int, str]]] = None,
) -> Table:
    """Inner equi-join with an exact output size (one host sync)."""
    right_on = right_on or on
    dev = left.columns[0].data.device
    if left.row_count == 0 or right.row_count == 0:
        total = 0
    else:
        perm_r, lo, counts = match_ranges(left, right, on, right_on)
        total = int(counts.sum())
    if total == 0:
        # the JAX package's empty result: right columns gain an empty
        # validity vector from its zero-length match mask
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return join_output(left, right, right_on, empty, empty,
                           torch.zeros(0, dtype=torch.bool, device=dev))
    left_idx = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts,
        output_size=total,
    )
    out_start = torch.cumsum(counts, 0) - counts
    k = torch.arange(total, device=dev) - out_start[left_idx]
    right_idx = perm_r[lo[left_idx] + k]
    return join_output(left, right, right_on, left_idx, right_idx, None)


# ---------------------------------------------------------------------------
# capped join: a static output capacity, a device match count
# ---------------------------------------------------------------------------


def _expand_capped(perm_r, lo, counts, capacity: int):
    """(left_idx, right_idx, matched, in_range) of ``capacity`` pair
    slots, without a host sync: left row i owns slots [start_i, start_i
    + count_i), so the owner of slot p is the number of rows whose slots
    end at or before p (one binary search over the running ends, whose
    queries come in order); slots past the total repeat the last left
    row, as ``jnp.repeat``'s ``total_repeat_length`` fills them."""
    dev = counts.device
    n_left = counts.shape[0]
    ends = torch.cumsum(counts, 0)
    start = ends - counts
    slot = torch.arange(capacity, device=dev)
    in_range = slot < ends[-1]
    left_idx = torch.where(
        in_range, torch.searchsorted(ends, slot, right=True), n_left - 1)
    k = slot - start[left_idx]
    matched = (k < counts[left_idx]) & in_range
    pos = (lo[left_idx] + k).clamp(0, max(perm_r.shape[0] - 1, 0))
    return left_idx, perm_r[pos], matched, in_range


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
    left_idx, right_idx, matched, in_range = _expand_capped(
        perm_r, lo, counts, capacity)
    out = join_output(left, right, right_on, left_idx, right_idx, matched)
    cols = [Column(c.data, c.dtype,
                   in_range if c.validity is None else c.validity & in_range,
                   c.lengths) for c in out.columns]
    return Table(cols, out.names), counts.sum()


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
