"""128-bit integer arithmetic over two-limb vectors (port of
``ops/int128.py``).

A DECIMAL128 column of n unscaled values is an ``(n, 2)`` int64 buffer of
little-endian limbs ``[lo, hi]`` (two's complement; the sign is hi's top
bit). Each limb is a u64 bit pattern carried in int64, as everywhere in
the port: adds and products wrap modulo 2^64 alike in both, every right
shift that can see the top bit is logical (``ryu.lshr``), and carries,
borrows and the low limb's order compare unsigned (``ryu.ult``). The
JAX package's uint64 division becomes a long division in base 2^16,
whose partial dividends stay below 2^48 (positive in int64).

All vector functions take and return ``(lo, hi)`` pairs of int64
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .ryu import lshr, ult

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_SIGN64 = -(2**63)
_TWO64 = 2.0**64


def carrier(u: int) -> int:
    """The int64 carrier of a u64 constant."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= 1 << 63 else u


def from_signed_int(v: torch.Tensor):
    """Sign-extend an int64 (or narrower) vector to (lo, hi)."""
    lo = v.to(torch.int64)
    return lo, lo >> 63  # arithmetic: 0 or all ones


def from_py_ints(values, n=None) -> np.ndarray:
    """Host helper: Python ints (None is 0) -> (n, 2) uint64 limbs."""
    vals = list(values)
    out = np.zeros((len(vals) if n is None else n, 2), dtype=np.uint64)
    mask = (1 << 64) - 1
    for i, v in enumerate(vals):
        if v is None:
            continue
        u = v & ((1 << 128) - 1)  # two's complement
        out[i, 0] = u & mask
        out[i, 1] = (u >> 64) & mask
    return out


def to_py_ints(limbs) -> list:
    """Host helper: (n, 2) limbs (uint64 or int64 carriers) -> signed
    Python ints."""
    if torch.is_tensor(limbs):
        limbs = limbs.cpu().numpy()
    out = []
    for lo, hi in np.asarray(limbs).view(np.uint64).reshape(-1, 2):
        u = (int(hi) << 64) | int(lo)
        out.append(u - (1 << 128) if u >= (1 << 127) else u)
    return out


def add(a_lo, a_hi, b_lo, b_hi):
    """128-bit add (wrapping)."""
    lo = a_lo + b_lo
    return lo, a_hi + b_hi + ult(lo, a_lo).to(torch.int64)


def negate(lo, hi):
    """Two's-complement negation: ~x + 1, where the +1 carries into hi
    exactly when lo == 0."""
    return ~lo + 1, ~hi + (lo == 0).to(torch.int64)


def sub(a_lo, a_hi, b_lo, b_hi):
    nb_lo, nb_hi = negate(b_lo, b_hi)
    return add(a_lo, a_hi, nb_lo, nb_hi)


def _mul_u64(a, b):
    """64 x 64 -> 128 unsigned multiply via 32-bit halves; ``b`` may be
    a tensor or a u64 constant."""
    if not torch.is_tensor(b):
        b = torch.full_like(a, carrier(int(b)))
    a_lo, a_hi = a & _M32, lshr(a, 32)
    b_lo, b_hi = b & _M32, lshr(b, 32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = lshr(ll, 32) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | (mid << 32)
    hi = hh + lshr(lh, 32) + lshr(hl, 32) + lshr(mid, 32)
    return lo, hi


def mul_u64(lo, hi, m):
    """128-bit x u64 multiply (wrapping), ``m`` a constant or a vector:
    the rescale primitive (x * 10**k when widening a decimal scale)."""
    p_lo, p_hi = _mul_u64(lo, m)
    mm = m if torch.is_tensor(m) else carrier(int(m))
    return p_lo, p_hi + hi * mm


def lt_signed(a_lo, a_hi, b_lo, b_hi):
    """Signed 128-bit a < b."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & ult(a_lo, b_lo))


def eq(a_lo, a_hi, b_lo, b_hi):
    return (a_lo == b_lo) & (a_hi == b_hi)


def _u64_to_float64(u: torch.Tensor) -> torch.Tensor:
    """u64 bits -> the nearest float64 (one rounding: the 32-bit halves
    convert exactly, and their sum rounds once)."""
    return (lshr(u, 32).to(torch.float64) * 2.0**32
            + (u & _M32).to(torch.float64))


def to_float64(lo, hi):
    """Approximate float64 value (for mean/float casts): the magnitude's
    limbs each rounded to float64, then hi * 2^64 + lo, as the JAX
    package computes it."""
    neg = hi < 0
    nlo, nhi = negate(lo, hi)
    ulo = torch.where(neg, nlo, lo)
    uhi = torch.where(neg, nhi, hi)
    mag = _u64_to_float64(uhi) * _TWO64 + _u64_to_float64(ulo)
    return torch.where(neg, -mag, mag)


def order_key_words(limbs: torch.Tensor) -> list:
    """(n, 2) limbs -> [hi ^ signbit, lo] u64 words whose lexicographic
    unsigned order equals signed 128-bit order (keys.py convention)."""
    return [limbs[:, 1] ^ _SIGN64, limbs[:, 0]]


def pow10_limbs(k: int):
    """(lo, hi) host limbs of 10**k, 0 <= k <= 38, as uint64 scalars."""
    if not 0 <= k <= 38:
        raise ValueError(f"10**{k} out of decimal128 range")
    u = 10**k
    return np.uint64(u & ((1 << 64) - 1)), np.uint64(u >> 64)


def divmod_u32_rem(lo, hi, d: int):
    """128-bit unsigned division by a u32 constant (d < 2**32) by long
    division. Returns (q_lo, q_hi, remainder): the JAX package's base
    2^32 steps here in base 2^16, so every partial dividend
    (r << 16 | digit, r < d) stays below 2^48."""
    if not 0 < d < 2**32:
        raise ValueError("divisor must fit in u32")
    r = torch.zeros_like(lo)
    q = []
    for word in (hi, lo):
        for shift in (48, 32, 16, 0):
            cur = (r << 16) | (lshr(word, shift) & _M16)
            q.append(cur // d)
            r = cur % d
    q_hi = (q[0] << 48) | (q[1] << 32) | (q[2] << 16) | q[3]
    q_lo = (q[4] << 48) | (q[5] << 32) | (q[6] << 16) | q[7]
    return q_lo, q_hi, r


def divmod_u32(lo, hi, d: int):
    """128-bit unsigned division by a u32 constant; remainder discarded."""
    q_lo, q_hi, _ = divmod_u32_rem(lo, hi, d)
    return q_lo, q_hi


def rescale(lo, hi, from_scale: int, to_scale: int):
    """Change a decimal's scale: multiply (scale down) or divide
    (scale up) by the power of ten, chunked so every step fits the limb
    primitives. Division truncates toward zero (magnitude divide), the
    cudf fixed_point convention."""
    if from_scale == to_scale:
        return lo, hi
    if to_scale < from_scale:
        k = from_scale - to_scale
        while k > 0:
            step = min(k, 19)
            lo, hi = mul_u64(lo, hi, 10**step)
            k -= step
        return lo, hi
    # divide by 10^k on magnitudes, then restore the sign
    k = to_scale - from_scale
    neg = hi < 0
    nlo, nhi = negate(lo, hi)
    mlo = torch.where(neg, nlo, lo)
    mhi = torch.where(neg, nhi, hi)
    while k > 0:
        step = min(k, 9)
        mlo, mhi = divmod_u32(mlo, mhi, 10**step)
        k -= step
    rlo, rhi = negate(mlo, mhi)
    return torch.where(neg, rlo, mlo), torch.where(neg, rhi, mhi)
