"""Column factories and utilities: the cudf factory surface (port of
``factories.py``).

Constructors (``sequence``, ``full``, ``full_null``, ``empty_like``), the
copy and reshape family (``concatenate``, ``concatenate_tables``,
``slice_column``, ``slice_table``, ``split_table``,
``interleave_columns``, ``copy_if_else``), the shape-bucket entry points
for callers that drive the op library directly (``pad_to_bucket``,
``unpad_table``, and ``run_plan`` over a padded table), and the Arrow
validity bitmask (``pack_bitmask``, ``unpack_bitmask``). Where
``ops/copying.py`` computes the same thing, these call it. Constructors
take ``device=`` (default ``"cuda"``); the rest follow their inputs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from . import dtype as dt
from .column import Column, Table, resolve_device
from .ops import compute
from .ops import copying


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def sequence(n: int, start=0, step=1, dtype: dt.DType = dt.INT32,
             device: Union[str, torch.device] = "cuda") -> Column:
    """0, step, 2*step, ... from ``start`` (cudf::detail::sequence)."""
    return copying.sequence(n, start, step, dtype, device=device)


def full(n: int, value, dtype: dt.DType,
         device: Union[str, torch.device] = "cuda") -> Column:
    """A column of ``n`` copies of ``value`` (a cudf scalar + fill)."""
    dev = resolve_device(device)
    if dtype.is_string:
        if isinstance(value, str):
            value = value.encode("utf-8", "surrogateescape")
        return Column.from_strings([value] * n, device=dev)
    wide = torch.float64 if dtype.is_floating else torch.int64
    if dtype.is_boolean:
        wide = torch.bool
    vals = torch.full((n,), value, dtype=wide, device=dev)
    return compute.from_values(vals, dtype, None)


def full_null(n: int, dtype: dt.DType,
              device: Union[str, torch.device] = "cuda") -> Column:
    """An all-null column (zero payload, validity all False)."""
    dev = resolve_device(device)
    valid = torch.zeros((n,), dtype=torch.bool, device=dev)
    if dtype.is_string:
        return Column(torch.zeros((n, 1), dtype=torch.uint8, device=dev),
                      dt.STRING, valid,
                      torch.zeros((n,), dtype=torch.int32, device=dev))
    return Column(torch.zeros((n,), dtype=dtype.storage_dtype, device=dev),
                  dtype, valid)


def empty_like(col: Column, n: Optional[int] = None) -> Column:
    """A zero column of the same dtype and layout (cudf's
    make_fixed_width_column with uninitialised contents), no validity."""
    rows = col.row_count if n is None else n
    dev = col.data.device
    if col.dtype.is_string:
        return Column(
            torch.zeros((rows, col.pad_width), dtype=torch.uint8, device=dev),
            dt.STRING, None, torch.zeros((rows,), dtype=torch.int32,
                                         device=dev))
    return Column(torch.zeros((rows,), dtype=col.data.dtype, device=dev),
                  col.dtype, None)


# ---------------------------------------------------------------------------
# copying / reshape
# ---------------------------------------------------------------------------


def concatenate(cols: Sequence[Column]) -> Column:
    """Vertical concatenation (cudf::concatenate)."""
    if not cols:
        raise ValueError("concatenate of no columns")
    return copying.concatenate_columns(cols)


def concatenate_tables(tables: Sequence[Table]) -> Table:
    """Row-wise table concatenation (the schemas must match)."""
    if not tables:
        raise ValueError("concatenate of no tables")
    return copying.concatenate(tables)


def slice_column(col: Column, start: int, end: int) -> Column:
    """A contiguous row slice (cudf::slice), without a copy."""
    return copying.slice_rows(Table([col]), start, end).columns[0]


def slice_table(table: Table, start: int, end: int) -> Table:
    return copying.slice_rows(table, start, end)


def split_table(table: Table, splits: Sequence[int]) -> list:
    """cudf::split: cut points -> contiguous sub-tables (Python slice
    bounds, unchecked, as in the JAX package)."""
    bounds = [0, *splits, table.row_count]
    return [copying.slice_rows(table, bounds[i], bounds[i + 1])
            for i in range(len(bounds) - 1)]


def interleave_columns(cols: Sequence[Column]) -> Column:
    """Row-interleave equal-length same-type columns
    (cudf::interleave_columns: out[i*k+j] = cols[j][i])."""
    if not cols:
        raise ValueError("interleave of no columns")
    if cols[0].dtype.is_string:
        raise TypeError("interleave_columns: fixed-width only")
    n = cols[0].row_count
    for c in cols:
        if c.dtype != cols[0].dtype or c.row_count != n:
            raise ValueError("interleave requires same dtype and length")
    return copying.interleave_columns(Table(list(cols)))


def copy_if_else(lhs: Column, rhs: Column, mask: Column) -> Column:
    """Per row: mask ? lhs : rhs (cudf::copy_if_else); a null mask row
    selects ``rhs`` (Spark's CASE WHEN)."""
    if not mask.dtype.is_boolean:
        raise TypeError("copy_if_else mask must be BOOL8")
    if lhs.dtype != rhs.dtype:
        raise TypeError("copy_if_else requires matching dtypes")
    return copying.copy_if_else(mask, lhs, rhs)


# ---------------------------------------------------------------------------
# shape buckets for callers of the op library (the dispatch plane buckets
# by itself): pad once, run a plan, unpad at the end
# ---------------------------------------------------------------------------


def pad_to_bucket(table: Table, bucket: Optional[int] = None) -> Table:
    """Pad ``table`` to its row-count bucket (or ``bucket``), carrying the
    logical row count (``Table.logical_rows``). The input itself when
    bucketing is off or the size has no bucket."""
    from .utils import buckets

    if bucket is None:
        bucket = buckets.bucket_for(table.logical_row_count)
        if bucket is None:
            return table
    return buckets.pad_table(table, bucket)


def unpad_table(table: Table) -> Table:
    """Exact-shape view of a possibly padded table (the inverse of
    :func:`pad_to_bucket`)."""
    from .utils import buckets

    return buckets.unpad_table(table)


def run_plan(ops: Sequence[dict], table: Table, rest: Sequence[Table] = (),
             unpad: bool = True, donate_input: bool = False) -> Table:
    """A plan (the ``table_plan_wire`` op list) over tables on the
    device, op by op through the dispatch plane (``plan.run_plan``): a
    padded input stays padded through the bucketed runners. ``unpad``
    (the default) returns the exact-shape result; ``unpad=False`` keeps
    the padded one for another plan. ``donate_input=True`` declares
    ``table`` consumed (its storage may be released after the first
    op). Under ``PROFILE`` a profile session (``plan_python``) scopes
    the run, keyed by the table's schema and seeded with
    ``plancheck.analyze``'s prediction, as the wire entries do."""
    from . import plan as plan_mod
    from .utils import buckets, profiler

    ops = list(ops)
    schema = None
    report = None
    if profiler.enabled():
        # stats keying only: plan.run_plan stays the loud validator
        from . import plancheck

        try:
            schema = plancheck.schema_of_table(table)
            report = plancheck.analyze(
                ops, schema=schema, rows=int(table.logical_row_count))
        except Exception:  # keying is best-effort; run_plan validates
            schema = report = None
    with profiler.maybe_session(ops, label="plan_python", schema=schema,
                                static=report):
        out = plan_mod.run_plan(ops, table, tuple(rest),
                                donate_input=donate_input)
        return buckets.unpad_table(out) if unpad else out


# ---------------------------------------------------------------------------
# validity bitmasks (the Arrow wire form <-> bool vectors)
# ---------------------------------------------------------------------------

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def pack_bitmask(valid: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> ceil(n/8) uint8, least significant bit first (the
    Arrow and cudf bitmask layout)."""
    n = valid.shape[0]
    nbytes = -(-n // 8)
    bits = torch.zeros(nbytes * 8, dtype=torch.int32, device=valid.device)
    bits[:n] = valid.to(torch.int32)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=valid.device)
    return (bits.reshape(nbytes, 8) * w).sum(1).to(torch.uint8)


def unpack_bitmask(packed: torch.Tensor, n: int) -> torch.Tensor:
    """ceil(n/8) uint8 least significant bit first -> (n,) bool (the
    inverse of :func:`pack_bitmask`)."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, None] & w) != 0
    return bits.reshape(-1)[:n]
