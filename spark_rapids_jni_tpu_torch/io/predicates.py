"""Scan predicates: host-side statistics pruning + device residual filter
(port of the JAX package's ``io/predicates.py``).

A predicate is a DNF tree (an OR of ANDs of leaf comparisons), the shape
pyarrow and Spark push down to Parquet readers. Two evaluators:

* ``maybe_matches(stats)`` — a conservative host check against one row
  group's (or stripe's) min/max/null statistics: may a row of this group
  satisfy the predicate? False means the group is skipped before decode.
* ``evaluate(table)`` — exact evaluation on the table's device, a BOOL8
  mask column through the binaryop library, with Spark's null semantics
  (a null comparison is null, so WHERE drops the row).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column, Table, host_to_storage

_LEAF_OPS = {"==", "!=", "<", "<=", ">", ">=", "in", "not in", "is_null",
             "is_not_null"}

_BINOP_NAME = {"==": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt",
               ">=": "ge"}


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """One group's statistics as found in a Parquet footer / ORC stripe."""

    min: Any = None
    max: Any = None
    null_count: Optional[int] = None
    num_values: Optional[int] = None

    @property
    def has_nulls(self) -> Optional[bool]:
        if self.null_count is None:
            return None
        return self.null_count > 0

    @property
    def all_null(self) -> Optional[bool]:
        if self.null_count is None or self.num_values is None:
            return None
        return self.null_count >= self.num_values


class Predicate:
    """Base class; build with ``col("x") > 3``, ``and_``/``or_``."""

    def maybe_matches(self, stats: dict) -> bool:
        raise NotImplementedError

    def evaluate(self, table: Table) -> Column:
        raise NotImplementedError

    def columns(self) -> set:
        raise NotImplementedError

    def __and__(self, other: "Predicate") -> "Predicate":
        return And([self, other])

    def __or__(self, other: "Predicate") -> "Predicate":
        return Or([self, other])


def _literal_column(value, n: int, like: Column) -> Column:
    """A Python literal broadcast to an n-row column of ``like``'s type,
    on ``like``'s device."""
    dev = like.data.device
    if like.dtype.is_string:
        if isinstance(value, str):
            value = value.encode("utf-8", "surrogateescape")
        pad = max(len(value), 1)
        row = np.zeros((1, pad), np.uint8)
        row[0, :len(value)] = np.frombuffer(value, np.uint8)
        mat = torch.from_numpy(row).to(dev).expand(n, pad).contiguous()
        lens = torch.full((n,), len(value), dtype=torch.int32, device=dev)
        return Column(mat, dt.STRING, None, lens)
    if like.dtype.is_decimal:
        # the literal is given in scaled units (a plain number): the
        # column's unscaled representation
        unscaled = int(round(float(value) * 10 ** (-like.dtype.scale)))
        host = np.full((1,), unscaled, like.dtype.value_dtype)
    elif like.dtype.is_timestamp or like.dtype.is_duration:
        host = np.full((1,), int(value), np.dtype(f"i{like.dtype.itemsize}"))
    else:
        host = np.full((1,), value, like.dtype.value_dtype)
    return Column(host_to_storage(host, like.dtype, dev).expand(n).contiguous(),
                  like.dtype)


@dataclasses.dataclass(frozen=True)
class Leaf(Predicate):
    name: str
    op: str
    value: Any = None

    def __post_init__(self):
        # pyarrow/SQL spellings
        aliases = {"=": "==", "<>": "!="}
        if self.op in aliases:
            object.__setattr__(self, "op", aliases[self.op])
        if self.op not in _LEAF_OPS:
            raise ValueError(f"unknown predicate op {self.op!r}")

    def columns(self) -> set:
        return {self.name}

    # -- host pruning ----------------------------------------------------
    def maybe_matches(self, stats: dict) -> bool:
        st = stats.get(self.name)
        if st is None:
            return True  # no stats: cannot prune
        if self.op == "is_null":
            return st.has_nulls is not False
        if self.op == "is_not_null":
            return st.all_null is not True
        lo, hi = st.min, st.max
        if lo is None or hi is None:
            return True
        v = self.value
        try:
            if self.op == "==":
                return lo <= v <= hi
            if self.op == "!=":
                return not (lo == v == hi)
            if self.op == "<":
                return lo < v
            if self.op == "<=":
                return lo <= v
            if self.op == ">":
                return hi > v
            if self.op == ">=":
                return hi >= v
            if self.op == "in":
                return any(lo <= x <= hi for x in v)
            if self.op == "not in":
                return not any(lo == x == hi for x in v)
        except TypeError:
            return True  # a literal the stats can't compare: keep the group
        return True

    # -- device residual -------------------------------------------------
    def evaluate(self, table: Table) -> Column:
        from ..ops import binaryop, unaryop

        c = table[self.name]
        if self.op == "is_null":
            return unaryop.is_null(c)
        if self.op == "is_not_null":
            return unaryop.is_not_null(c)
        if self.op in ("in", "not in"):
            acc = None
            for v in self.value:
                term = binaryop.binary_op(
                    "eq", c, _literal_column(v, c.row_count, c))
                acc = term if acc is None else binaryop.binary_op(
                    "or", acc, term)
            if acc is None:
                # SQL's empty list: x IN () is false, x NOT IN () is
                # true — both null for a null x
                if self.op == "not in":
                    return unaryop.is_not_null(c)
                return Column(torch.zeros(c.row_count, dtype=torch.bool,
                                          device=c.data.device), dt.BOOL8)
            if self.op == "not in":
                return unaryop.unary_op("not", acc)
            return acc
        lit = _literal_column(self.value, c.row_count, c)
        return binaryop.binary_op(_BINOP_NAME[self.op], c, lit)


@dataclasses.dataclass(frozen=True)
class And(Predicate):
    children: Sequence[Predicate]

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))

    def columns(self) -> set:
        return set().union(*(c.columns() for c in self.children))

    def maybe_matches(self, stats: dict) -> bool:
        return all(c.maybe_matches(stats) for c in self.children)

    def evaluate(self, table: Table) -> Column:
        from ..ops import binaryop

        out = self.children[0].evaluate(table)
        for c in self.children[1:]:
            out = binaryop.binary_op("and", out, c.evaluate(table))
        return out


@dataclasses.dataclass(frozen=True)
class Or(Predicate):
    children: Sequence[Predicate]

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))

    def columns(self) -> set:
        return set().union(*(c.columns() for c in self.children))

    def maybe_matches(self, stats: dict) -> bool:
        return any(c.maybe_matches(stats) for c in self.children)

    def evaluate(self, table: Table) -> Column:
        from ..ops import binaryop

        out = self.children[0].evaluate(table)
        for c in self.children[1:]:
            out = binaryop.binary_op("or", out, c.evaluate(table))
        return out


class _ColBuilder:
    """``col("x") > 3`` sugar for building Leaf predicates."""

    def __init__(self, name: str):
        self._name = name

    def __eq__(self, other):  # type: ignore[override]
        return Leaf(self._name, "==", other)

    def __ne__(self, other):  # type: ignore[override]
        return Leaf(self._name, "!=", other)

    def __lt__(self, other):
        return Leaf(self._name, "<", other)

    def __le__(self, other):
        return Leaf(self._name, "<=", other)

    def __gt__(self, other):
        return Leaf(self._name, ">", other)

    def __ge__(self, other):
        return Leaf(self._name, ">=", other)

    def isin(self, values):
        return Leaf(self._name, "in", tuple(values))

    def not_in(self, values):
        return Leaf(self._name, "not in", tuple(values))

    def is_null(self):
        return Leaf(self._name, "is_null")

    def is_not_null(self):
        return Leaf(self._name, "is_not_null")

    __hash__ = None  # builders are not hashable (== builds a Leaf)


def col(name: str) -> _ColBuilder:
    return _ColBuilder(name)


def and_(*preds: Predicate) -> Predicate:
    return And(preds) if len(preds) > 1 else preds[0]


def or_(*preds: Predicate) -> Predicate:
    return Or(preds) if len(preds) > 1 else preds[0]


def projection_columns(
    predicate: Optional[Predicate], columns, all_names
) -> tuple[list, list]:
    """(wanted output columns, columns to decode). The decode set adds
    the predicate's columns so the residual filter can evaluate them;
    they are dropped again after filtering, as Spark does for pushed-down
    scan filters."""
    want = list(columns) if columns is not None else list(all_names)
    read_cols = want
    if predicate is not None:
        extra = [c for c in sorted(predicate.columns()) if c not in want]
        read_cols = want + extra
    return want, read_cols


def from_dnf(filters) -> Predicate:
    """pyarrow-style DNF list(s) of (col, op, value) -> Predicate tree."""
    if isinstance(filters, Predicate):
        return filters
    if filters and isinstance(filters[0], tuple):
        filters = [filters]
    conjunctions = []
    for conj in filters:
        leaves = [Leaf(name, op, value) for (name, op, value) in conj]
        conjunctions.append(And(leaves) if len(leaves) > 1 else leaves[0])
    return Or(conjunctions) if len(conjunctions) > 1 else conjunctions[0]
