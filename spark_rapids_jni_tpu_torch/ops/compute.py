"""Storage tensors <-> arithmetic values (port of ``ops/compute.py``).

FLOAT64 storage is an int64 bit pattern; ``values`` views it as float64
and ``from_values`` views results back. Both are free reinterpretations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import torch

from .. import dtype as dt
from ..column import Column


def values(col: Column) -> torch.Tensor:
    """The arithmetic view of a column's data (FLOAT64 bits -> f64)."""
    if col.dtype.id == dt.TypeId.FLOAT64:
        return col.data.view(torch.float64)
    return col.data


def encode_values(vals: torch.Tensor, dtype: dt.DType) -> torch.Tensor:
    """Arithmetic values -> storage tensor for ``dtype``."""
    if dtype.id == dt.TypeId.FLOAT64:
        return vals.to(torch.float64).view(torch.int64)
    return vals.to(dtype.storage_dtype)


def from_values(
    vals: torch.Tensor, dtype: dt.DType, validity: Optional[torch.Tensor]
) -> Column:
    return Column(encode_values(vals, dtype), dtype, validity)


def valid_mask(col: Column) -> torch.Tensor:
    """(n,) bool validity, materialized (all True when validity is None)."""
    if col.validity is None:
        return torch.ones(col.data.shape[:1], dtype=torch.bool,
                          device=col.data.device)
    return col.validity


def merge_validity(*cols: Column) -> Optional[torch.Tensor]:
    """AND of the validities present; None if all are absent."""
    masks = [c.validity for c in cols if c.validity is not None]
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


# ---------------------------------------------------------------------------
# value conversions with the JAX package's (XLA's) semantics
# ---------------------------------------------------------------------------

#: torch dtype of each value dtype (numpy) the ops compute in
TORCH_OF = {
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32, np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.bool_): torch.bool,
}
NP_OF = {v: k for k, v in TORCH_OF.items()}
#: unsigned dtypes that torch computes little with: they travel as int64
#: carriers (values for 16 and 32 bits, the bit pattern for 64)
WIDE_UNSIGNED = {torch.uint16: 16, torch.uint32: 32, torch.uint64: 64}


def to_carrier(v: torch.Tensor) -> torch.Tensor:
    """Values -> the tensor the ops compute on: uint16/uint32 as int64
    values, uint64 as its int64 bit pattern, every other dtype as it is."""
    if v.dtype == torch.uint64:
        return v.view(torch.int64)
    if v.dtype in WIDE_UNSIGNED:
        return v.to(torch.int64)
    return v


def from_carrier(c: torch.Tensor, to: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_carrier` for the value dtype ``to``; integer
    carriers wrap to its width."""
    bits = WIDE_UNSIGNED.get(to)
    if bits == 64:
        return c.to(torch.int64).view(torch.uint64)
    if bits is not None:
        return (c.to(torch.int64) & ((1 << bits) - 1)).to(to)
    return c if c.dtype == to else c.to(to)


def _float_to_int(v: torch.Tensor, to: torch.dtype) -> torch.Tensor:
    """XLA's float -> integer convert: truncation toward zero, saturated
    to the target's range, NaN -> 0. The bounds are taken in float64,
    never through torch's conversion of NaN, inf or out-of-range values
    (undefined on CUDA)."""
    f = v.to(torch.float64)
    nan = torch.isnan(f)
    f = torch.where(nan, 0.0, f)
    if to == torch.int64:
        top = f >= 2.0**63
        body = f.clamp(-(2.0**63), 2.0**63 - 1024).to(torch.int64)
        return torch.where(top, torch.iinfo(torch.int64).max, body)
    if to == torch.uint64:
        f = f.clamp(min=0.0)
        top = f >= 2.0**64
        high = f >= 2.0**63
        lo = torch.where(high, 0.0, f).to(torch.int64)
        hi = (torch.where(high, f - 2.0**63, 0.0).clamp(max=2.0**63 - 2048)
              .to(torch.int64) ^ (-(2**63)))
        bits = torch.where(top, -1, torch.where(high, hi, lo))
        return bits.view(torch.uint64)
    info = np.iinfo(NP_OF[to])
    return from_carrier(f.clamp(float(info.min), float(info.max))
                        .to(torch.int64), to)


def astype(v: torch.Tensor, to: torch.dtype) -> torch.Tensor:
    """``v.astype(to)`` as the JAX package computes it on values:
    integers wrap, floats -> integers saturate (:func:`_float_to_int`),
    anything -> bool is ``!= 0``."""
    if v.dtype == to:
        return v
    if to == torch.bool:
        return to_carrier(v) != 0
    if to.is_floating_point:
        if v.dtype in (torch.uint16, torch.uint32):
            return v.to(torch.int64).to(to)
        return v.to(to)
    if v.is_floating_point():
        return _float_to_int(v, to)
    return from_carrier(to_carrier(v).to(torch.int64), to)


def flush_subnormal(v: torch.Tensor) -> torch.Tensor:
    """Subnormal floats -> zero of the same sign. The JAX package's CPU
    code runs with denormals flushed, inputs and results alike (its TPU
    has none), so the float ops flush what they read and what they
    return."""
    if not v.is_floating_point():
        return v
    tiny = torch.finfo(v.dtype).tiny
    return torch.where(v.abs() < tiny, v * 0.0, v)


def sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as XLA computes it: torch's on
    CUDA (IEEE round-to-nearest); numpy's on the CPU, where torch's
    vectorised path can be 1 ulp off (1,589 of 200,000 random doubles).
    A negative input gives NaN, as in XLA."""
    if v.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(v.numpy()))
    return torch.sqrt(v)


def _split(v: torch.Tensor):
    """Veltkamp's split of float64 values into two 26-bit halves."""
    t = 134217729.0 * v
    hi = t - (t - v)
    return hi, v - hi


def fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, as XLA's CPU code contracts a multiply
    feeding an add in one fusion (float64; ``b`` a constant): Dekker's
    exact product and Knuth's two-sum, then one rounding of the three
    parts. Plain IEEE operations, so the same bytes on any device."""
    bt = torch.full_like(a, b)
    p = a * bt
    ah, al = _split(a)
    bh, bl = _split(bt)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def float_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's elementwise float min as the JAX package's CPU code runs it:
    subnormals read and returned as zero, -0.0 below +0.0, and a NaN
    operand returned as it is (the first when both are NaN)."""
    a, b = flush_subnormal(a), flush_subnormal(b)
    take_a = torch.isnan(a) | (~torch.isnan(b) & (
        (a < b) | ((a == b) & torch.signbit(a))))
    return torch.where(take_a, a, b)


def float_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's elementwise float max (see :func:`float_minimum`): +0.0
    above -0.0."""
    a, b = flush_subnormal(a), flush_subnormal(b)
    take_a = torch.isnan(a) | (~torch.isnan(b) & (
        (a > b) | ((a == b) & ~torch.signbit(a))))
    return torch.where(take_a, a, b)


def scalar_tensor(value) -> torch.Tensor:
    """A 0-d CPU tensor of a Python or numpy scalar in the dtype the JAX
    package gives ``jnp.full((1,), value)``: bool, int64 for a Python
    int, float64 for a Python float, a numpy scalar's own. Elementwise
    ops take it beside CUDA tensors as a scalar argument, with no copy
    to the card (and no host sync)."""
    arr = np.asarray(value)
    if arr.dtype.kind in "iu":  # e.g. numpy's ulonglong for 2**64 - 1
        arr = arr.astype(f"{arr.dtype.kind}{arr.dtype.itemsize}")
    return torch.from_numpy(arr.reshape(()))



def last_true_index(flags: torch.Tensor) -> torch.Tensor:
    """int64 (n,): for each row i the largest j <= i with ``flags[j]``,
    -1 where there is none. ``cummax(where(flags, iota, -1))`` without
    torch's cummax, whose CUDA kernel also computes indices and runs
    about 100 times slower than a cumsum and a scatter at 2^23 rows."""
    n = flags.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=flags.device)
    rank = torch.cumsum(flags.to(torch.int64), 0) - 1
    # slot k holds the k-th flagged row; unflagged rows write slot n
    first = torch.full((n + 1,), -1, dtype=torch.int64, device=flags.device)
    first.scatter_(0, torch.where(flags, rank, n), idx)
    return torch.where(rank >= 0, first[rank.clamp(min=0)], -1)


def next_true_index(flags: torch.Tensor) -> torch.Tensor:
    """int64 (n,): for each row i the smallest j >= i with ``flags[j]``,
    n where there is none (see :func:`last_true_index`)."""
    n = flags.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=flags.device)
    count = torch.cumsum(flags.to(torch.int64), 0)
    first = torch.full((n + 1,), n, dtype=torch.int64, device=flags.device)
    first.scatter_(0, torch.where(flags, count - 1, n), idx)
    before = count - flags.to(torch.int64)  # flagged rows before row i
    return first[before]


def true_divide(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, as IEEE division: torch divides a CUDA
    tensor by a Python scalar as a multiply by its reciprocal, which
    rounds twice; a 0-d tensor on the same device (filled there, no
    copy from the host) keeps the division."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def as_int64(v: torch.Tensor) -> torch.Tensor:
    """``v.astype(int64)`` of integers or bools as the JAX package
    computes it (UINT64: its bit pattern)."""
    if v.dtype == torch.uint64:
        return v.view(torch.int64)
    return to_carrier(v).to(torch.int64)


def int_order_word(v: torch.Tensor) -> torch.Tensor:
    """Integers or bools -> int64 whose signed order is theirs (UINT64:
    its bit pattern with the top bit flipped)."""
    if v.dtype == torch.uint64:
        return v.view(torch.int64) ^ (-(2**63))
    return as_int64(v)


def from_int_order_word(w: torch.Tensor, to: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`int_order_word` for the value dtype ``to``."""
    if to == torch.uint64:
        return (w ^ (-(2**63))).view(torch.uint64)
    if to == torch.bool:
        return w != 0
    return from_carrier(w, to)
