"""Stream compaction (port of ``ops/compaction.py``, cudf ``distinct`` /
``distinct_count`` / ``drop_nulls``).

Distinct is sort-based, as in the JAX package: rows are stably sorted by
their key words and each run's head is kept, so the kept row is the
earliest of its key and rows keep their input order. Nulls are equal to
each other (a null key's data words are zeroed and a validity word
separates it from a real zero). ``distinct`` and ``drop_nulls`` size
their output on the host; ``distinct_capped`` and ``distinct_count``
give a device count.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .. import dtype as dt
from ..column import Column, Table
from . import compute
from .filter import filter_table, filter_table_capped
from .keys import SIGN64, column_order_keys
from .sort import lexsort, occupied_prefix


def _first_of_run_mask(table: Table, keys: Optional[Sequence],
                       row_valid: Optional[torch.Tensor] = None) -> Column:
    """BOOL8 mask of the first occurrence of each distinct key row. A
    ``row_valid`` False row (padding) joins no real row's run and is never
    kept; when ``row_valid`` is a prefix (a padded table), only the
    prefix is sorted."""
    cols = ([table.column(k) for k in keys] if keys is not None
            else list(table.columns))
    words: list = []
    for c in cols:
        cwords = column_order_keys(c)
        if c.validity is not None:
            cwords = [torch.where(c.validity, w, SIGN64) for w in cwords]
            cwords.append(c.validity.to(torch.uint8))
        words.extend(cwords)
    n = table.row_count
    rows = n
    if row_valid is not None and n:
        rows = occupied_prefix(row_valid)
        if rows is None:
            rows = n
            words.append(row_valid.to(torch.uint8))
        else:
            words = [w[:rows] for w in words]
    dev = table.columns[0].data.device
    keep = torch.zeros(n, dtype=torch.bool, device=dev)
    if rows:
        perm = lexsort(words)
        head = torch.zeros(rows, dtype=torch.bool, device=dev)
        head[0] = True
        for w in words:
            sw = w[perm]
            head[1:] |= sw[1:] != sw[:-1]
        keep[perm] = head
    if row_valid is not None:
        keep = keep & row_valid
    return Column(keep, dt.BOOL8, None)


def distinct(table: Table, keys: Optional[Sequence] = None) -> Table:
    """The first occurrence of every distinct key row, in input order."""
    return filter_table(table, _first_of_run_mask(table, keys))


def distinct_capped(
    table: Table,
    keys: Optional[Sequence] = None,
    capacity: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> tuple[Table, torch.Tensor]:
    """Distinct with a static output size: (table of ``capacity`` rows,
    by default the input's, device count). ``row_valid`` excludes rows."""
    cap = capacity if capacity is not None else table.row_count
    return filter_table_capped(
        table, _first_of_run_mask(table, keys, row_valid), cap)


def distinct_count(obj: Union[Table, Column],
                   keys: Optional[Sequence] = None) -> torch.Tensor:
    """Number of distinct rows or values as a device int32 scalar; nulls
    count as one value."""
    table = obj if isinstance(obj, Table) else Table([obj], ["c"])
    return _first_of_run_mask(table, keys).data.sum().to(torch.int32)


def drop_nulls(
    table: Table,
    keys: Optional[Sequence[Union[int, str]]] = None,
    keep_threshold: Optional[int] = None,
) -> Table:
    """Rows whose key columns are valid (Spark ``dropna``): every key by
    default, at least ``keep_threshold`` of them when given."""
    cols = ([table.column(k) for k in keys] if keys is not None
            else list(table.columns))
    if keep_threshold is None:
        keep = compute.merge_validity(*cols)
        if keep is None:
            return table
    else:
        n_valid = torch.zeros(table.row_count, dtype=torch.int32,
                              device=table.columns[0].data.device)
        for c in cols:
            n_valid = n_valid + compute.valid_mask(c).to(torch.int32)
        keep = n_valid >= keep_threshold
    return filter_table(table, Column(keep, dt.BOOL8, None))
