"""Rounding (port of ``ops/rounding.py``: cudf ``round``, HALF_UP /
HALF_EVEN) for numeric and decimal columns.

Decimals and integers round on the stored integer exactly, in the
column's own width with its wraparound; floats scale, round and unscale
in their own type, each step reading and writing subnormals as zero as
the JAX package's CPU code does.
"""

from __future__ import annotations

import torch

from ..column import Column
from . import compute
from .keys import SIGN64

HALF_UP = "half_up"
HALF_EVEN = "half_even"



def _round_half_up(vals, scale):
    # half away from zero (Spark/cudf HALF_UP), not floor(x+0.5)
    flush = compute.flush_subnormal
    scaled = flush(flush(vals) * scale)
    up = torch.floor(flush(scaled + 0.5))
    down = torch.ceil(flush(scaled - 0.5))
    return flush(compute.true_divide(torch.where(scaled >= 0, up, down),
                                     scale))


def _round_half_even(vals, scale):
    # torch.round, like jnp.round, rounds half to even
    flush = compute.flush_subnormal
    return flush(compute.true_divide(
        torch.round(flush(flush(vals) * scale)), scale))


def _wrap(value: int, bits: int, signed: bool) -> int:
    """A Python int reduced to a ``bits``-wide integer, as the column's
    own arithmetic wraps it (``10 ** shift`` in the column dtype)."""
    value &= (1 << bits) - 1
    if signed and value >= 1 << (bits - 1):
        value -= 1 << bits
    return value


def _round_signed(x: torch.Tensor, p: int, how: str) -> torch.Tensor:
    """Round signed ``x`` to a multiple of ``p`` (the wrapped power of
    ten), in ``x``'s dtype with its wraparound: floor quotient,
    remainder in [0, p) (or (p, 0] for a wrapped negative p)."""
    q = x // p  # p stays a Python int: no copy to the card
    r = x - q * p
    if how == HALF_UP:
        # half away from zero: for negatives the floor remainder's tie
        # stays at q (the more negative floor), positives move up
        up = torch.where(x >= 0, r * 2 >= p, r * 2 > p)
    else:
        tie = r * 2 == p
        up = torch.where(tie, q % 2 != 0, r * 2 > p)
    return (q + up.to(x.dtype)) * p


def _round_unsigned(x: torch.Tensor, p: int, how: str,
                    bits: int) -> torch.Tensor:
    """:func:`_round_signed` for unsigned ``x`` of ``bits`` bits, held as
    int64 (values for 8-32 bits, the bit pattern for 64): quotient and
    remainder exact, every product wrapped to the width, compared
    unsigned."""
    if bits < 64:
        mask = (1 << bits) - 1
        q = x // p
        r = x - q * p
        r2 = (r * 2) & mask
        if how == HALF_UP:
            up = r2 >= p
        else:
            up = torch.where(r2 == p, q % 2 != 0, r2 > p)
        return ((q + up.to(torch.int64)) * p) & mask
    q, r = _udivmod64(x, p)
    r2 = r * 2  # wraps mod 2**64 as uint64 does
    pc = _signed_word(p)
    if how == HALF_UP:
        up = (r2 ^ SIGN64) >= (pc ^ SIGN64)
    else:
        up = torch.where(r2 == pc, (q & 1) != 0,
                         (r2 ^ SIGN64) > (pc ^ SIGN64))
    return (q + up.to(torch.int64)) * pc


def _signed_word(p: int) -> int:
    return p - (1 << 64) if p >= 1 << 63 else p


def _udivmod64(x: torch.Tensor, p: int):
    """Unsigned 64-bit ``divmod(x, p)`` of int64 bit patterns by a
    constant 0 < p < 2**64, exactly: halve, divide signed, fix up."""
    pc = _signed_word(p)
    if p >= 1 << 63:
        ge = (x ^ SIGN64) >= (pc ^ SIGN64)
        q = ge.to(torch.int64)
        return q, x - q * pc
    half = (x >> 1) & 0x7FFFFFFFFFFFFFFF
    q = (half // p) << 1
    r = x - q * p
    fix = (r ^ SIGN64) >= (p ^ SIGN64)
    return q + fix.to(torch.int64), torch.where(fix, r - p, r)


def _round_unscaled(data: torch.Tensor, shift: int, how: str,
                    unsigned: bool) -> torch.Tensor:
    """Round integer storage to a multiple of 10**shift (shift > 0),
    exactly. A power of ten that wraps to 0 in the width gives 0, as the
    JAX package's (XLA's) division by zero then multiplies by 0."""
    bits = torch.iinfo(data.dtype).bits
    p = _wrap(10 ** shift, bits, not unsigned)
    if p == 0:
        return torch.zeros_like(data)
    if not unsigned:
        return _round_signed(data, p, how)
    carrier = compute.to_carrier(data)
    if data.dtype == torch.uint8:
        carrier = carrier.to(torch.int64)
    return compute.from_carrier(_round_unsigned(carrier, p, how, bits),
                                data.dtype)


def round_column(
    col: Column, decimal_places: int = 0, how: str = HALF_UP
) -> Column:
    """Round to ``decimal_places`` (negative = powers of ten left of the
    point). Output dtype: unchanged for floats/ints; decimals keep their
    scale (cudf round keeps the column type, adjusting only values)."""
    if how not in (HALF_UP, HALF_EVEN):
        raise ValueError(f"unknown rounding mode {how!r}")
    d = col.dtype
    if d.is_decimal:
        # value = unscaled * 10^scale; rounding at decimal_places means
        # zeroing digits below 10^(-decimal_places)
        shift = -decimal_places - d.scale
        if shift <= 0:
            return col  # already coarser than requested
        out = _round_unscaled(col.data, shift, how, False)
        return Column(out, d, col.validity)
    if d.is_floating:
        vals = compute.values(col)
        scale = 10.0 ** decimal_places
        fn = _round_half_up if how == HALF_UP else _round_half_even
        return compute.from_values(fn(vals, scale), d, col.validity)
    if d.is_integer:
        if decimal_places >= 0:
            return col
        out = _round_unscaled(col.data, -decimal_places, how, d.is_unsigned)
        return Column(out, d, col.validity)
    raise TypeError(f"round: unsupported dtype {d}")
