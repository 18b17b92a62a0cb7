"""STRUCT columns (port of ``struct.py``): typed child columns plus a
struct-level validity, cudf's (and Arrow's) layout.

A ``StructColumn`` owns one ``Column`` per field and an optional bool
validity tensor; it is a plain class (no pytree). Flat structs over
fixed-width, string and decimal children; ordering is lexicographic over
fields in declaration order (cudf's struct comparator), on the order
words of ``ops/keys.py``. ``struct_from_arrow``/``struct_to_arrow``
carry it to and from an Arrow StructArray.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import dtype as dt
from .column import Column, Table, resolve_device


@dataclasses.dataclass(eq=False)
class StructColumn:
    """One STRUCT column: parallel children + struct-level validity.

    A null struct row is null at THIS level; children keep whatever
    validity they carry (cudf semantics: child nulls under a valid
    struct are visible, children under a null struct are undefined)."""

    children: tuple
    names: tuple
    validity: Optional[torch.Tensor] = None

    # -- construction -----------------------------------------------------

    @staticmethod
    def from_children(
        children: Sequence[Column],
        names: Optional[Sequence[str]] = None,
        validity=None,
    ) -> "StructColumn":
        """cudf ``make_structs_column``: zip existing columns into a
        struct (a host validity goes to the children's device)."""
        children = tuple(children)
        if not children:
            raise ValueError("struct needs at least one field")
        n = children[0].data.shape[0]
        for c in children:
            if c.data.shape[0] != n:
                raise ValueError("struct children must share row count")
        names = tuple(
            names if names is not None
            else (f"f{i}" for i in range(len(children)))
        )
        if len(names) != len(children):
            raise ValueError("one name per child")
        if validity is not None and not isinstance(validity, torch.Tensor):
            validity = torch.from_numpy(
                np.asarray(validity, dtype=np.bool_)).to(
                    children[0].data.device)
        return StructColumn(children, names, validity)

    @staticmethod
    def from_pylist(
        rows: Sequence[Optional[dict]],
        dtypes: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> "StructColumn":
        """Build from a list of dicts (None = null struct row) on
        ``device``. The field set is taken from the first non-null row;
        missing keys in later rows become child nulls."""
        dev = resolve_device(device)
        first = next((r for r in rows if r is not None), None)
        if first is None:
            raise ValueError("all-null struct needs explicit dtypes/fields")
        names = list(first.keys())
        valid = np.array([r is not None for r in rows], dtype=np.bool_)
        cols = []
        for name in names:
            vals = [None if r is None else r.get(name) for r in rows]
            want = (dtypes or {}).get(name)
            if want is not None and want.id != dt.TypeId.STRING:
                arr = np.array(
                    [0 if v is None else v for v in vals],
                    dtype=want.host_dtype if want.id != dt.TypeId.FLOAT64
                    else np.float64,
                )
                v_mask = np.array([v is not None for v in vals], np.bool_)
                cols.append(Column.from_numpy(
                    arr, validity=None if v_mask.all() else v_mask,
                    dtype=want, device=dev))
            elif isinstance(first.get(name), str) or (
                want is not None and want.id == dt.TypeId.STRING
            ):
                cols.append(Column.from_strings(vals, device=dev))
            else:
                tbl = Table.from_pydict({name: vals}, device=dev)
                cols.append(tbl.columns[0])
        return StructColumn.from_children(
            cols, names, None if valid.all() else valid)

    # -- basic accessors --------------------------------------------------

    @property
    def dtype(self) -> dt.DType:
        return dt.STRUCT

    @property
    def row_count(self) -> int:
        return int(self.children[0].data.shape[0])

    @property
    def num_fields(self) -> int:
        return len(self.children)

    def field(self, key: Union[int, str]) -> Column:
        """Child extraction (cudf struct ``get_child`` / Spark
        ``struct.field``): child nulls OR struct-level nulls."""
        i = self.names.index(key) if isinstance(key, str) else key
        c = self.children[i]
        if self.validity is None:
            return c
        v = self.validity if c.validity is None else c.validity & self.validity
        return Column(c.data, c.dtype, v, c.lengths)

    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int((~self.validity).sum())

    def to_pylist(self) -> list:
        fields = [c.to_pylist() for c in self.children]
        valid = ([True] * self.row_count if self.validity is None
                 else self.validity.cpu().numpy().tolist())
        return [
            dict(zip(self.names, vals)) if ok else None
            for ok, *vals in zip(valid, *fields)
        ]

    # -- row selection ----------------------------------------------------

    def gather(self, indices, index_valid=None) -> "StructColumn":
        """Rows at ``indices`` (clamped into range, as the JAX package's
        ``take(mode="clip")``); ``index_valid`` False rows become null."""
        from .ops.gather import gather_column

        n = self.row_count
        indices = torch.as_tensor(indices, device=self.children[0].data.device)
        safe = indices.clamp(0, max(n - 1, 0)).long()
        children = tuple(gather_column(c, safe, None) for c in self.children)
        valid = None
        if self.validity is not None:
            valid = self.validity[safe]
        if index_valid is not None:
            valid = index_valid if valid is None else valid & index_valid
        return StructColumn(children, self.names, valid)

    def filter(self, mask: Column) -> "StructColumn":
        """Eager row filter by a BOOL8 mask column (host-syncs the
        count, like filter_table)."""
        from .ops import compute

        keep = mask.data & compute.valid_mask(mask)
        idx = torch.nonzero(keep).flatten().to(torch.int32)
        return self.gather(idx)

    # -- ordering ---------------------------------------------------------

    def order_keys(self) -> list:
        """Order words (int64 carriers): the struct-level null word
        (nulls first), then each field's words with its null word
        before them — cudf's lexicographic struct comparator, flattened
        for a lexsort."""
        from .ops import keys as keys_mod

        words: list[torch.Tensor] = []
        if self.validity is not None:
            words.append(self.validity.to(torch.int64))
        for c in self.children:
            if c.validity is not None:
                words.append(c.validity.to(torch.int64))
            words.extend(keys_mod.column_order_keys(c))
        return words

    def argsort(self, ascending: bool = True) -> torch.Tensor:
        """Stable permutation ordering rows by lexicographic field
        comparison (struct-level nulls first when ascending)."""
        from .ops.sort import lexsort

        words = self.order_keys()
        if not ascending:
            words = [~w for w in words]
        if self.row_count == 0:
            return torch.zeros(0, dtype=torch.int64,
                               device=words[0].device)
        return lexsort(words)


def pack(table: Table, columns: Sequence[Union[int, str]],
         name: str = "s") -> StructColumn:
    """Zip table columns into a StructColumn (Spark ``struct(cols...)``)."""
    cols = [table.column(c) for c in columns]
    names = [
        c if isinstance(c, str) else (
            table.names[c] if table.names else f"f{c}"
        )
        for c in columns
    ]
    return StructColumn.from_children(cols, names)


def unpack(struct: StructColumn) -> Table:
    """Flatten a StructColumn into a Table of its fields (struct-level
    validity folded into every child)."""
    return Table(
        [struct.field(i) for i in range(struct.num_fields)],
        list(struct.names),
    )


def struct_from_arrow(arr, device: Union[str, torch.device] = "cuda"
                      ) -> StructColumn:
    """Arrow StructArray -> port StructColumn on ``device`` (flat
    structs)."""
    from .interop import _require_pyarrow, column_from_arrow, pa

    _require_pyarrow()
    dev = resolve_device(device)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if not pa.types.is_struct(arr.type):
        raise TypeError(f"expected a struct array, got {arr.type}")
    validity = np.asarray(arr.is_valid()) if arr.null_count else None
    names = [f.name for f in arr.type]
    children = [column_from_arrow(arr.field(i), device=dev)
                for i in range(len(names))]
    return StructColumn.from_children(children, names, validity)


def struct_to_arrow(sc: StructColumn):
    """Port StructColumn -> Arrow StructArray."""
    from .interop import _require_pyarrow, column_to_arrow, pa

    _require_pyarrow()
    fields = [column_to_arrow(c) for c in sc.children]
    mask = None
    if sc.validity is not None:
        mask = pa.array(~sc.validity.cpu().numpy(), type=pa.bool_())
    return pa.StructArray.from_arrays(fields, names=list(sc.names),
                                      mask=mask)
