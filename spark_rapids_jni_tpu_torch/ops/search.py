"""Search ops (port of ``ops/search.py``: cudf ``lower_bound`` /
``upper_bound`` / ``contains``).

Rows reduce to the order words of ops/keys.py (int64 carriers) and the
bounds run through the join's fixed-step multi-word binary search,
``join._lex_searchsorted``: one code path for every fixed-width and
string type.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import dtype as dt
from ..column import Column, Table
from .join import _lex_searchsorted
from .keys import CARRIER_MAX, table_order_keys
from .sort import lexsort


def _key_words(table: Table, keys: Sequence | None) -> list[torch.Tensor]:
    cols = ([table.column(k) for k in keys] if keys is not None
            else list(table.columns))
    return table_order_keys(cols)


def lower_bound(
    haystack: Table, needles: Table, keys: Sequence | None = None
) -> Column:
    """First insertion index of each needle row into the sorted haystack
    (cudf ``lower_bound``). ``haystack`` must already be sorted ascending
    on ``keys`` (defaults: positionally, all columns)."""
    return _bound(haystack, needles, keys, "left")


def upper_bound(
    haystack: Table, needles: Table, keys: Sequence | None = None
) -> Column:
    """One-past-last insertion index (cudf ``upper_bound``)."""
    return _bound(haystack, needles, keys, "right")


def _bound(haystack: Table, needles: Table, keys, side: str) -> Column:
    hwords = _key_words(haystack, keys)
    nwords = _key_words(
        needles,
        keys if keys is not None and _names_apply(needles, keys) else None)
    if len(hwords) != len(nwords):
        raise ValueError("lower/upper_bound: key schemas differ")
    out = _lex_searchsorted(hwords, nwords, side)
    return Column(out.to(torch.int32), dt.INT32, None)


def _names_apply(table: Table, keys) -> bool:
    try:
        for k in keys:
            table.column(k)
        return True
    except (KeyError, IndexError, ValueError):
        return False


def contains_column(haystack: Column, needles: Column) -> Column:
    """BOOL8 column: is each needle value present in haystack (cudf
    ``contains``, the IN-list expression). Null needles stay null; null
    haystack entries never match."""
    if haystack.dtype != needles.dtype:
        raise TypeError(
            f"contains: dtype mismatch {haystack.dtype} vs {needles.dtype}"
        )
    hwords = table_order_keys([haystack])
    nwords = table_order_keys([needles])
    if haystack.validity is not None:
        # exile null rows to the max word; the range check below keeps
        # needles from matching them
        mask = haystack.validity
        hwords = [torch.where(mask, w, CARRIER_MAX) for w in hwords]
    if hwords[0].shape[0] > 0:
        perm = lexsort(hwords)
        hwords = [w[perm] for w in hwords]
    lo = _lex_searchsorted(hwords, nwords, "left")
    hi = _lex_searchsorted(hwords, nwords, "right")
    found = hi > lo
    if haystack.validity is not None:
        # cap the range at the count of valid rows
        n_valid = haystack.validity.sum().to(torch.int32)
        found = found & (lo < n_valid)
    return Column(found, dt.BOOL8, needles.validity)
