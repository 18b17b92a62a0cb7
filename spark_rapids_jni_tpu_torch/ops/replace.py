"""Replace-family ops (port of ``ops/replace.py``: cudf ``replace_nulls``
/ ``nans_to_nulls`` / ``find_and_replace`` / ``clamp``).

The fill policies are cumulative maxima over row indices, as in the JAX
package. Float comparisons and min/max read subnormals as zero, as the
JAX package's CPU code does (``compute.flush_subnormal``).
"""

from __future__ import annotations

from typing import Union

import torch

from .. import dtype as dt
from ..column import Column
from . import compute

PRECEDING = "preceding"  # carry last valid value forward
FOLLOWING = "following"  # carry next valid value backward


def replace_nulls(col: Column, value) -> Column:
    """Nulls -> ``value`` (scalar or same-dtype column); the result keeps
    nulls only where a replacement column is itself null. Strings route
    through copy_if_else."""
    if col.validity is None:
        return col
    if col.dtype.is_string:
        from .copying import copy_if_else

        if not isinstance(value, Column):
            value = Column.from_strings([value] * col.row_count,
                                        device=col.data.device)
        mask = Column(col.validity, dt.BOOL8, None)
        return copy_if_else(mask, col, value)
    if isinstance(value, Column):
        if value.dtype != col.dtype:
            raise TypeError("replace_nulls: replacement dtype mismatch")
        data = torch.where(_rows(col.validity, col.data), col.data,
                           value.data)
        valid = col.validity | compute.valid_mask(value)
        return Column(data, col.dtype, valid)
    v = compute.scalar_tensor(value)
    if col.dtype.id == dt.TypeId.FLOAT64:
        fill = compute.astype(v, torch.float64).view(torch.int64)
    else:
        fill = compute.astype(v, col.dtype.storage_dtype)
    data = torch.where(_rows(col.validity, col.data), col.data, fill)
    return Column(data, col.dtype, None)


def _rows(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """A row mask shaped to broadcast over ``data`` (DECIMAL128 limbs)."""
    return mask[:, None] if data.dim() == 2 else mask


def replace_nulls_policy(col: Column, policy: str) -> Column:
    """Directional fill: PRECEDING = last observation carried forward,
    FOLLOWING = next observation carried backward. Leading (resp.
    trailing) nulls stay null."""
    if col.validity is None:
        return col
    if col.dtype.is_string:
        raise TypeError("replace_nulls_policy: fixed-width only")
    n = col.row_count
    if policy == PRECEDING:
        # source[i] = largest valid row index <= i
        src = compute.last_true_index(col.validity)
        valid = src >= 0
    elif policy == FOLLOWING:
        # source[i] = smallest valid row index >= i
        src = compute.next_true_index(col.validity)
        valid = src <= n - 1
    else:
        raise ValueError(f"unknown fill policy {policy!r}")
    data = col.data[src.clamp(0, max(n - 1, 0))]
    return Column(data, col.dtype, valid)


def nans_to_nulls(col: Column) -> Column:
    """Float NaN payloads become nulls (cudf ``nans_to_nulls``)."""
    if not col.dtype.is_floating:
        return col
    not_nan = ~torch.isnan(compute.values(col))
    valid = not_nan if col.validity is None else col.validity & not_nan
    return Column(col.data, col.dtype, valid)


def find_and_replace(col: Column, old_values, new_values) -> Column:
    """Value substitution table (cudf ``find_and_replace_all``): each row
    equal to old_values[k] becomes new_values[k]."""
    if len(old_values) != len(new_values):
        raise ValueError("find_and_replace: length mismatch")
    vals = compute.values(col)
    probe = _comparable(vals)
    out = vals
    for old, new in zip(old_values, new_values):
        if isinstance(old, float) and not vals.is_floating_point():
            # an int column against a Python float compares as float64
            hit = compute.astype(vals, torch.float64) == old
        else:
            hit = probe == _comparable(_scalar_like(old, vals))
        out = torch.where(hit, _scalar_like(new, out), out)
    return compute.from_values(out, col.dtype, col.validity)


def clamp(
    col: Column,
    lo: Union[int, float, None] = None,
    hi: Union[int, float, None] = None,
) -> Column:
    """Clamp values into [lo, hi] (cudf ``clamp``); None bound = open."""
    vals = compute.values(col)
    if vals.is_floating_point():
        if lo is not None:
            vals = compute.float_maximum(vals, _scalar_like(lo, vals))
        if hi is not None:
            vals = compute.float_minimum(vals, _scalar_like(hi, vals))
        return compute.from_values(vals, col.dtype, col.validity)
    word = compute.int_order_word
    work = word(vals)
    if lo is not None:
        work = torch.maximum(work, word(_scalar_like(lo, vals)))
    if hi is not None:
        work = torch.minimum(work, word(_scalar_like(hi, vals)))
    return compute.from_values(compute.from_int_order_word(work, vals.dtype),
                               col.dtype, col.validity)


def _scalar_like(value, like: torch.Tensor) -> torch.Tensor:
    """``jnp.asarray(value, like.dtype)`` as a 0-d CPU tensor."""
    return compute.astype(compute.scalar_tensor(value), like.dtype)


def _comparable(v: torch.Tensor) -> torch.Tensor:
    """Values whose ``==`` is the JAX package's: floats with subnormals
    read as zero, wide unsigned ints as int64 carriers."""
    if v.is_floating_point():
        return compute.flush_subnormal(v)
    return compute.to_carrier(v)

