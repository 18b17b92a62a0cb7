"""LIST-column ops over the padded-matrix layout (port of
``ops/lists.py``): the accessors (cudf ``lists::count_elements`` /
``contains`` / ``extract_list_element``; Spark ``size``,
``array_contains``, ``element_at``) and the explode family (cudf
``explode`` / ``explode_outer`` / ``explode_position``).

Explode's output size depends on the data: it is read on the host once
(``repeat_interleave`` of the per-row element counts), as the JAX
package's eager call reads it; so is whether any exploded element is
null, which decides whether the element column carries a validity
vector. ``split_explode`` splits a STRING column on a one-byte delimiter
and explodes the tokens in one op (Spark ``explode(split(...))``).
"""

from __future__ import annotations

from typing import Union

import torch

from .. import dtype as dt
from ..column import Column, Table
from .join import _resolve


def _require_list(col: Column):
    if col.dtype.id != dt.TypeId.LIST:
        raise TypeError("expected a LIST column")


def count_elements(col: Column) -> Column:
    """Per-row element count; null rows are null."""
    _require_list(col)
    return Column(col.lengths.to(torch.int32), dt.INT32, col.validity)


def list_contains(col: Column, value) -> Column:
    """True where the row's list holds ``value``."""
    _require_list(col)
    pad = col.data.shape[1]
    in_list = (torch.arange(pad, device=col.data.device)[None, :]
               < col.lengths[:, None])
    hit = ((col.data == value) & in_list).any(dim=1)
    return Column(hit, dt.BOOL8, col.validity)


def extract_list_element(col: Column, index: int) -> Column:
    """The element at ``index`` of each row (negative counts from the
    end); out-of-range rows are null."""
    _require_list(col)
    pad = col.data.shape[1]
    lens = col.lengths.to(torch.int64)
    idx = lens + index if index < 0 else torch.full_like(lens, index)
    in_range = (idx >= 0) & (idx < lens)
    vals = torch.gather(col.data, 1, idx.clamp(0, pad - 1)[:, None])[:, 0]
    validity = in_range if col.validity is None else col.validity & in_range
    return Column(vals, col.list_child_dtype, validity)


def _replicate_siblings(table: Table, ci: int, parent: torch.Tensor,
                        new_col: Column, leading=()) -> Table:
    """The table with every row repeated as ``parent`` says, the column at
    ``ci`` replaced by ``new_col`` (after the ``leading`` (name, column)
    pairs)."""
    from .gather import gather_column

    out_cols, out_names = [], []
    names = table.names
    for i, c in enumerate(table.columns):
        name = names[i] if names is not None else f"c{i}"
        if i == ci:
            for lname, lcol in leading:
                out_cols.append(lcol)
                out_names.append(lname)
            out_cols.append(new_col)
        else:
            out_cols.append(gather_column(c, parent))
        out_names.append(name)
    return Table(out_cols, out_names if names is not None else None)


def _explode_table(table: Table, column: Union[int, str], outer: bool,
                   position: bool) -> Table:
    ci = _resolve(table, column)
    lcol = table.columns[ci]
    _require_list(lcol)
    dev = lcol.data.device
    n, pad = lcol.data.shape
    lens = lcol.lengths.to(torch.int64)
    if lcol.validity is not None:
        lens = torch.where(lcol.validity, lens, 0)
    # outer: an empty or null list gives one null element
    slots = lens.clamp(min=1) if outer else lens
    parent = torch.repeat_interleave(torch.arange(n, device=dev), slots)
    starts = torch.cumsum(slots, 0) - slots
    element = torch.arange(parent.shape[0], device=dev) - starts[parent]
    elem_valid = element < lens[parent]
    valid = None if bool(elem_valid.all()) else elem_valid
    vals = lcol.data[parent, element.clamp(0, pad - 1)]
    vals = torch.where(elem_valid, vals, torch.zeros((), dtype=vals.dtype,
                                                     device=dev))
    leading = []
    if position:
        pos = torch.where(elem_valid, element, 0).to(torch.int32)
        leading.append(("pos", Column(pos, dt.INT32, valid)))
    child = Column(vals, lcol.list_child_dtype, valid)
    return _replicate_siblings(table, ci, parent, child, leading)


def explode(table: Table, column: Union[int, str]) -> Table:
    """Each row once per list element, the LIST column replaced by its
    elements (Spark ``explode`` drops empty and null lists)."""
    return _explode_table(table, column, outer=False, position=False)


def explode_outer(table: Table, column: Union[int, str]) -> Table:
    """:func:`explode`, but an empty or null list keeps one row with a
    null element."""
    return _explode_table(table, column, outer=True, position=False)


def explode_position(table: Table, column: Union[int, str],
                     outer: bool = False) -> Table:
    """Explode with a leading ``pos`` INT32 column of element indexes
    (Spark ``posexplode``)."""
    return _explode_table(table, column, outer=outer, position=True)


def split_explode(table: Table, column: Union[int, str],
                  delimiter: Union[str, bytes]) -> Table:
    """Split a STRING column on a one-byte delimiter and give each token
    a row (Spark ``explode(split(col, d))``, cudf ``split_record`` +
    ``explode``) without a LIST<STRING> column in between. A null string
    gives no row, an empty one one empty token; the other columns repeat
    a token. The token total is read on the host once."""
    from .strings import _extract_token, _literal_bytes, _require_string

    ci = _resolve(table, column)
    scol = table.columns[ci]
    _require_string(scol)
    d = _literal_bytes(delimiter)
    if len(d) != 1:
        raise ValueError("split_explode: single-byte delimiter only")
    n, pad = scol.data.shape
    dev = scol.data.device
    in_str = torch.arange(pad, device=dev)[None, :] < scol.lengths[:, None]
    counts = ((scol.data == d[0]) & in_str).sum(dim=1) + 1
    if scol.validity is not None:
        counts = torch.where(scol.validity, counts, 0)
    parent = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    tok = (torch.arange(parent.shape[0], device=dev)
           - (torch.cumsum(counts, 0) - counts)[parent])
    tokens = _extract_token(scol.data[parent], scol.lengths[parent], None,
                            d[0], tok)
    return _replicate_siblings(table, ci, parent, tokens)
