"""Sort / order-by (port of ``ops/sort.py``).

Key columns become int64 carrier order words (ops/keys.py); descending
inverts them and each nullable key adds a leading null-placement word.
A stable multi-key sort is a chain of stable single-word sorts from the
last word to the first (LSD order), the torch form of ``jnp.lexsort``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from ..column import Column, Table
from . import keys as keys_mod
from .gather import gather_table


@dataclasses.dataclass(frozen=True)
class SortKey:
    """One ORDER BY term. ``nulls_first=None`` is Spark's default: nulls
    first when ascending, last when descending."""

    column: Union[int, str]
    ascending: bool = True
    nulls_first: Optional[bool] = None

    @property
    def resolved_nulls_first(self) -> bool:
        if self.nulls_first is None:
            return self.ascending
        return self.nulls_first


def _key_words(col: Column, key: SortKey) -> list[torch.Tensor]:
    words = keys_mod.column_order_keys(col)
    if not key.ascending:
        words = [~w for w in words]
    if col.validity is not None:
        # nulls are equal under ORDER BY: one constant word for all of
        # them, so ties fall through to the next key / stability
        words = [
            torch.where(col.validity, w, keys_mod.SIGN64) for w in words
        ]
        v = col.validity.to(torch.uint8)  # a one-byte word sorts in one pass
        words = [v if key.resolved_nulls_first else 1 - v] + words
    return words


def _table_key_words(
    table: Table, sort_keys: Sequence[Union[SortKey, str, int]]
) -> list[torch.Tensor]:
    keys = [k if isinstance(k, SortKey) else SortKey(k) for k in sort_keys]
    words: list[torch.Tensor] = []
    for k in keys:
        words.extend(_key_words(table.column(k.column), k))
    return words


def lexsort(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by ``words`` (first word is the
    primary key)."""
    n = words[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=words[0].device)
    for w in reversed(words):
        order = torch.sort(w[perm], stable=True).indices
        perm = perm[order]
    return perm


def occupied_prefix(row_valid: torch.Tensor) -> Optional[int]:
    """k when ``row_valid`` holds exactly its first k rows (a padded
    table's occupancy), else None. One host sync."""
    k = row_valid.sum()
    iota = torch.arange(row_valid.shape[0], device=row_valid.device)
    is_prefix = (row_valid == (iota < k)).all()
    k, is_prefix = torch.stack([k, is_prefix.to(k.dtype)]).tolist()
    return int(k) if is_prefix else None


def lexsort_occupied(words: Sequence[torch.Tensor],
                     row_valid: torch.Tensor) -> torch.Tensor:
    """``lexsort`` of the occupancy word (``row_valid`` False rows last)
    and ``words``. When the occupancy is a prefix of k rows (a padded
    table), the two parts sort apart: the k rows by ``words``, and the
    padding behind them by ``words`` too, unless every word is constant
    there (a padding of zeros or of one row's clones), which a stable
    sort leaves in row order. The permutation is the same either way;
    one host sync reads both tests."""
    n = row_valid.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=row_valid.device)
    dev = row_valid.device
    k = row_valid.sum()
    iota = torch.arange(n, device=dev)
    tests = [k, (row_valid == (iota < k)).all()] + [
        (row_valid | (w == w[-1])).all() for w in words]
    k, is_prefix, *constant = torch.stack(
        [t.to(torch.int64) for t in tests]).tolist()
    if not is_prefix:
        return lexsort([(~row_valid).to(torch.uint8)] + list(words))
    head = (lexsort([w[:k] for w in words]) if words and k
            else torch.arange(k, device=dev))
    if all(constant):
        return torch.cat([head, torch.arange(k, n, device=dev)])
    return torch.cat([head, k + lexsort([w[k:] for w in words])])


def _reads_host(count) -> bool:
    """May an occupancy-aware body read the host? Yes for a Python count
    or none (a per-op runner, a direct call), no for a device scalar (a
    fused plan segment, which reads its count once, at its end)."""
    return not isinstance(count, torch.Tensor)


def _argsort_occupied(words: Sequence[torch.Tensor],
                      row_valid: Optional[torch.Tensor],
                      count=None) -> torch.Tensor:
    """``lexsort`` of the occupancy word (``row_valid`` False rows last)
    and ``words``: ``lexsort_occupied`` (one host read) unless ``count``
    is a device scalar, then one sort of every row behind the one-byte
    occupancy word (the same permutation, no host read)."""
    if row_valid is None:
        return lexsort(words)
    if _reads_host(count):
        return lexsort_occupied(words, row_valid)
    return lexsort([(~row_valid).to(torch.uint8)] + list(words))


def argsort_table(
    table: Table,
    sort_keys: Sequence[Union[SortKey, str, int]],
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stable row permutation ordering ``table`` by ``sort_keys``;
    ``row_valid`` False rows sink to the end."""
    return _argsort_occupied(_table_key_words(table, sort_keys), row_valid)


def sort_table(
    table: Table,
    sort_keys: Sequence[Union[SortKey, str, int]],
    payload: Optional[Table] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Table:
    """ORDER BY: ``table`` (or ``payload``) reordered, stable."""
    perm = argsort_table(table, sort_keys, row_valid)
    return gather_table(payload if payload is not None else table, perm)


def _sort_occupied(table: Table, sort_keys, row_valid: torch.Tensor,
                   count) -> Table:
    """``sort_table`` of a padded table whose logical count is ``count``
    (:func:`_argsort_occupied`)."""
    words = _table_key_words(table, sort_keys)
    return gather_table(table, _argsort_occupied(words, row_valid, count))


def is_sorted(
    table: Table, sort_keys: Sequence[Union[SortKey, str, int]]
) -> torch.Tensor:
    """Device bool: rows already ordered by ``sort_keys`` (cudf
    ``is_sorted``). Nulls follow each key's resolved placement."""
    words = _table_key_words(table, sort_keys)
    n = words[0].shape[0]
    if n <= 1:
        return torch.ones((), dtype=torch.bool, device=words[0].device)
    # adjacent-pair lexicographic compare: prev <= next
    eq = torch.ones((n - 1,), dtype=torch.bool, device=words[0].device)
    ok = torch.zeros_like(eq)
    for w in words:
        a, b = w[:-1], w[1:]
        ok = ok | (eq & (a < b))
        eq = eq & (a == b)
    return (ok | eq).all()


def merge_sorted(
    tables: Sequence[Table],
    sort_keys: Sequence[Union[SortKey, str, int]],
) -> Table:
    """K-way merge of individually sorted tables into one sorted table
    (cudf ``cudf::merge``): concatenate, then one stable sort, so equal
    keys keep their inputs' order."""
    from .copying import concatenate

    if not tables:
        raise ValueError("merge_sorted: need at least one table")
    return sort_table(concatenate(tables), sort_keys)
