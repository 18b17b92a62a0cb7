"""Packed-key ORDER BY: the narrow-key form of ``sort_table`` (port of
``ops/sort_packed.py``).

With no-null integer-family keys whose combined spans fit ``64 -
log2(n)`` bits (dates, dictionary codes, ids, alone or composed), the
key words and the row iota collapse into one u64::

    packed = (rel_1 << b_2 | rel_2 | ...) << iota_bits  |  row_iota

each field ``kw_i - kmin_i`` for an ascending key and ``kmax_i - kw_i``
for a descending one. The words are unique, so the sort needs no
tiebreak and the permutation is their low bits; the key columns are
rebuilt from their bit fields, and every other buffer follows the
permutation. The JAX package sorts the word with ``lax.sort`` outside
any Pallas kernel; the port sorts it with K3 (``srt_radix_sort_u64``
through ``kernels.bitonic_sort.batched_sort_u64_looped``; its plain
version on the CPU). Ineligible shapes return None: the caller runs
``sort_table``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..column import Column, Table
from .gather import take_rows
from .groupby_packed import _key_supported, _unkey
from .keys import column_order_keys, fold_fields, peel_fields
from .keys import minmax_host as _minmax
from .sort import SortKey


def sort_u64_words(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sorted words, perm int64)`` of a 1-D tensor of u64 bit patterns
    (int64), ascending as u64, stably, through K3 in one row of
    ``next_pow2(n)``: the extra slots take the all-ones word at tail
    indices, so the index tiebreak keeps them behind every real row."""
    from ..kernels.bitonic_sort import batched_sort_u64_looped

    n = words.shape[0]
    t = 1 << max(1, (n - 1).bit_length())
    key = words if t == n else torch.cat([words, words.new_full((t - n,), -1)])
    out = batched_sort_u64_looped(key[None, :].contiguous())
    return out[0][0, :n], out[1][0, :n].to(torch.int64)


def sort_table_packed(
    table: Table,
    sort_keys: Sequence[Union[SortKey, str, int]],
    values_via: str = "sort",
) -> Optional[Table]:
    """Packed ORDER BY, or None when ineligible (nulls, non-integer keys,
    duplicate key columns, combined span too wide): fall back to
    ``sort_table``. ``values_via`` is the JAX package's choice of
    carrying the payloads through its sort (``"sort"``) or gathering
    them afterwards (``"gather"``); the port gathers either way, which
    gives the same rows."""
    if values_via not in ("sort", "gather"):
        raise ValueError(f"unknown values_via {values_via!r}")
    if not sort_keys:
        return None
    keys = [k if isinstance(k, SortKey) else SortKey(k) for k in sort_keys]
    n = table.row_count
    if n == 0:
        return None
    key_cis = []
    for k in keys:
        kcol = table.column(k.column)
        if not _key_supported(kcol):
            return None
        key_cis.append(next(i for i, c in enumerate(table.columns)
                            if c is kcol))
    if len(set(key_cis)) != len(key_cis):
        return None  # duplicate key column: field peeling is ambiguous
    bits = max(1, (n - 1).bit_length())
    kws, kbases, field_bits = [], [], []
    for k, ci in zip(keys, key_cis):
        kw = column_order_keys(table.columns[ci])[0]
        lo, hi = _minmax(kw)
        kws.append(kw)
        field_bits.append(max(1, (hi - lo).bit_length()))
        kbases.append(lo if k.ascending else hi)
    if sum(field_bits) + bits > 64:
        return None  # no sentinel word: all 64 bits are usable
    rels = [(kw - base) if k.ascending else (base - kw)
            for kw, base, k in zip(kws, kbases, keys)]
    dev = kws[0].device
    packed = ((fold_fields(rels, field_bits) << bits)
              | torch.arange(n, dtype=torch.int64, device=dev))
    sorted_words, _ = sort_u64_words(packed)
    perm = sorted_words & ((1 << bits) - 1)
    rel_s = (sorted_words >> bits) & ((1 << (64 - bits)) - 1)
    fields = dict(zip(key_cis, peel_fields(rel_s, field_bits)))

    cols = []
    for ci, c in enumerate(table.columns):
        if ci in fields:
            i = key_cis.index(ci)
            kw = (kbases[i] + fields[ci] if keys[i].ascending
                  else kbases[i] - fields[ci])
            data = _unkey(kw, c.dtype)
        else:
            data = take_rows(c.data, perm)
        cols.append(Column(
            data, c.dtype,
            None if c.validity is None else c.validity[perm],
            None if c.lengths is None else c.lengths[perm]))
    return Table(cols, table.names)
