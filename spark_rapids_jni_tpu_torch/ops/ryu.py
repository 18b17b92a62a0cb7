"""Shortest round-trip decimal digits of floats (Ryu) and the correctly
rounded decimal -> binary conversion (Eisel-Lemire): the port of
``ops/ryu.py``.

The FLOAT -> STRING cast needs, per element, the shortest decimal
``digits x 10^exp10`` that parses back to the same float; STRING ->
FLOAT needs ``w x 10^q`` rounded correctly. Both are written as
fixed-shape vector integer arithmetic, as in the JAX package:

* the 128-bit power-of-five tables are generated at import time from
  exact Python integers and kept as pairs of 64-bit limbs;
* 64 x 64 -> 128-bit products are built from 32-bit limbs;
* the digit-trimming loops run a fixed number of masked trips (22 for
  FLOAT64, 11 for FLOAT32), so no row waits on the host.

u64 values ride in int64 tensors holding their bit pattern: additions
and products wrap alike, and every right shift, unsigned compare and
division of a value that can reach 2^63 goes through :func:`lshr` or
:func:`ult` (torch's int64 ``>>`` is arithmetic and its compares are
signed).

Algorithms: Ulf Adams, "Ryu: fast float-to-string conversion" (PLDI
2018); Daniel Lemire, "Number parsing at a gigabyte per second" (SP&E
2021).
"""

from __future__ import annotations

import functools

import torch

_D_POW5_INV_BITCOUNT = 125
_D_POW5_BITCOUNT = 125
_F_POW5_INV_BITCOUNT = 59
_F_POW5_BITCOUNT = 61

_M32 = 0xFFFFFFFF
_MAX64 = 2**63 - 1
_SIGN64 = -(2**63)


def _i64(v: int) -> int:
    """A u64 value as the int64 holding its bits."""
    v &= 0xFFFFFFFFFFFFFFFF
    return v - 2**64 if v >= 2**63 else v


def _pow5bits(e):
    """Ryu's bit-length bound of 5^e (exact for 0 <= e <= 3528); on
    Python ints and int64 tensors alike."""
    return ((e * 1217359) >> 19) + 1


@functools.lru_cache(maxsize=1)
def _double_tables():
    inv_lo, inv_hi = [], []
    for q in range(342):
        pow5 = 5 ** q
        j = _pow5bits(q) - 1 + _D_POW5_INV_BITCOUNT
        inv = (1 << j) // pow5 + 1
        inv_lo.append(_i64(inv))
        inv_hi.append(_i64(inv >> 64))
    sp_lo, sp_hi = [], []
    for i in range(326):
        pow5 = 5 ** i
        shift = _pow5bits(i) - _D_POW5_BITCOUNT
        v = pow5 >> shift if shift >= 0 else pow5 << -shift
        sp_lo.append(_i64(v))
        sp_hi.append(_i64(v >> 64))
    return inv_lo, inv_hi, sp_lo, sp_hi


@functools.lru_cache(maxsize=1)
def _float_tables():
    inv = []
    for q in range(31):
        j = _pow5bits(q) - 1 + _F_POW5_INV_BITCOUNT
        inv.append((1 << j) // 5 ** q + 1)
    sp = []
    for i in range(48):
        pow5 = 5 ** i
        shift = _pow5bits(i) - _F_POW5_BITCOUNT
        sp.append(pow5 >> shift if shift >= 0 else pow5 << -shift)
    return inv, sp


_POW5_U64 = [5 ** k for k in range(23)]


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """One host table as an int64 tensor on ``device`` (cached)."""
    if name.startswith("d"):
        vals = _double_tables()[("d_inv_lo", "d_inv_hi", "d_sp_lo",
                                 "d_sp_hi").index(name)]
    elif name.startswith("f"):
        vals = _float_tables()[("f_inv", "f_sp").index(name)]
    elif name.startswith("el"):
        vals = _el_pow5_tables()[("el_hi", "el_lo").index(name)]
    else:
        vals = _POW5_U64
    return torch.tensor(vals, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# u64 arithmetic on int64 carriers
# ---------------------------------------------------------------------------


def lshr(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of u64 bits by ``s`` in [0, 63] (an int or a
    tensor)."""
    if isinstance(s, int):
        return x if s == 0 else (x >> s) & ((1 << (64 - s)) - 1)
    s = s.to(torch.int64)
    return torch.where(s == 0, x, ((x >> 1) & _MAX64) >> (s - 1).clamp(min=0))


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a < b`` of u64 bit patterns."""
    return (a ^ _SIGN64) < (b ^ _SIGN64)


def _umul128(a: torch.Tensor, b: torch.Tensor):
    """(hi, lo) of the exact 128-bit product of two u64 vectors."""
    a_lo, a_hi = a & _M32, lshr(a, 32)
    b_lo, b_hi = b & _M32, lshr(b, 32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = lshr(ll, 32) + (lh & _M32) + (hl & _M32)
    lo = (mid << 32) | (ll & _M32)
    hi = hh + lshr(lh, 32) + lshr(hl, 32) + lshr(mid, 32)
    return hi, lo


def _mulshift64(m, factor_hi, factor_lo, j):
    """(m * (factor_hi:factor_lo)) >> j for 64 < j < 128; the result fits
    u64 (Ryu's invariant)."""
    b0_hi, _ = _umul128(m, factor_lo)
    b2_hi, b2_lo = _umul128(m, factor_hi)
    s_lo = b2_lo + b0_hi
    s_hi = b2_hi + ult(s_lo, b2_lo).to(torch.int64)
    dist = j - 64
    return (s_hi << (64 - dist)) | lshr(s_lo, dist)


def _mulshift32(m, factor, shift):
    """(m * factor) >> shift with m < 2^27, factor < 2^61, shift > 32."""
    f_lo, f_hi = factor & _M32, factor >> 32
    return (((m * f_lo) >> 32) + m * f_hi) >> (shift - 32)


def _pow5_factor_ge(value, p):
    """True where 5^p divides ``value`` (p clipped to the 5^22 table)."""
    return torch.remainder(value, _table("pow5", value.device)[
        p.clamp(0, 22)]) == 0


def _multiple_of_pow2(value, p):
    p = p.clamp(0, 62)
    return (value & ((torch.ones_like(p) << p) - 1)) == 0


def _log10_pow2(e):
    return (e * 78913) >> 18


def _log10_pow5(e):
    return (e * 732923) >> 20


def _trim_loop(vr, vp, vm, last0, vr_tz, vm_tz, trips: int):
    """Ryu's digit-removal loops as ``trips`` masked steps each: remove
    digits while ``vp/10 > vm/10``, then, where ``vm_tz`` held, while
    ``vm`` ends in 0. Returns ``(vr, vm, removed, last, vr_tz,
    vm_tz)``; vm is the trimmed lower bound."""
    removed = torch.zeros_like(vr)
    last = last0
    for _ in range(trips):
        vp_d, vm_d, vr_d = vp // 10, vm // 10, vr // 10
        go = vp_d > vm_d
        vr_rem = vr - 10 * vr_d
        vr_tz = torch.where(go, vr_tz & (last == 0), vr_tz)
        vm_tz = torch.where(go, vm_tz & (vm - 10 * vm_d == 0), vm_tz)
        last = torch.where(go, vr_rem, last)
        vr = torch.where(go, vr_d, vr)
        vp = torch.where(go, vp_d, vp)
        vm = torch.where(go, vm_d, vm)
        removed = removed + go.to(torch.int64)
    vr2, vp2, vm2, removed2, last2, vr_tz2 = vr, vp, vm, removed, last, vr_tz
    for _ in range(trips):
        vm_d, vr_d = vm2 // 10, vr2 // 10
        go = (vm2 - 10 * vm_d == 0) & (vm2 != 0)
        vr_rem = vr2 - 10 * vr_d
        vr_tz2 = torch.where(go, vr_tz2 & (last2 == 0), vr_tz2)
        last2 = torch.where(go, vr_rem, last2)
        vr2 = torch.where(go, vr_d, vr2)
        vp2 = torch.where(go, vp2 // 10, vp2)
        vm2 = torch.where(go, vm_d, vm2)
        removed2 = removed2 + go.to(torch.int64)
    pick = vm_tz
    return (torch.where(pick, vr2, vr), torch.where(pick, vm2, vm),
            torch.where(pick, removed2, removed),
            torch.where(pick, last2, last),
            torch.where(pick, vr_tz2, vr_tz), vm_tz)


def _finish(vr, vm, removed, last, vr_tz, vm_tz, accept, e10):
    half_even = vr_tz & (last == 5) & ((vr & 1) == 0)
    last = torch.where(half_even, 4, last)
    round_up = ((vr == vm) & (~accept | ~vm_tz)) | (last >= 5)
    return vr + round_up.to(torch.int64), e10 + removed


# ---------------------------------------------------------------------------
# FLOAT64
# ---------------------------------------------------------------------------


def shortest_decimal64(bits: torch.Tensor):
    """Ryu d2d over FLOAT64 bit patterns (int64). Returns ``(sign,
    digits, exp10, is_zero, is_inf, is_nan)``: for finite nonzero values
    ``value = ±digits * 10^exp10``, the shortest correctly rounded form
    (no trailing zeros in ``digits``)."""
    dev = bits.device
    ieee_m = bits & ((1 << 52) - 1)
    ieee_e = lshr(bits, 52) & 0x7FF
    sign = bits < 0
    is_zero = (ieee_e == 0) & (ieee_m == 0)
    is_inf = (ieee_e == 0x7FF) & (ieee_m == 0)
    is_nan = (ieee_e == 0x7FF) & (ieee_m != 0)

    subnormal = ieee_e == 0
    e2 = torch.where(subnormal, 1, ieee_e) - 1023 - 52 - 2
    m2 = torch.where(subnormal, ieee_m, ieee_m | (1 << 52))
    accept = (m2 & 1) == 0
    mv = 4 * m2
    mm_shift = ((ieee_m != 0) | (ieee_e <= 1)).to(torch.int64)

    # e2 >= 0
    e2c = e2.clamp(min=0)
    q_pos = _log10_pow2(e2c) - (e2c > 3).to(torch.int64)
    k_pos = _D_POW5_INV_BITCOUNT + _pow5bits(q_pos) - 1
    j_pos = -e2c + q_pos + k_pos
    qp_idx = q_pos.clamp(0, 341)
    # e2 < 0
    e2n = (-e2).clamp(min=0)
    q_neg = _log10_pow5(e2n) - (e2n > 1).to(torch.int64)
    i_neg = (e2n - q_neg).clamp(0, 325)
    k_neg = _pow5bits(i_neg) - _D_POW5_BITCOUNT
    j_neg = q_neg - k_neg

    pos = e2 >= 0
    f_hi = torch.where(pos, _table("d_inv_hi", dev)[qp_idx],
                       _table("d_sp_hi", dev)[i_neg])
    f_lo = torch.where(pos, _table("d_inv_lo", dev)[qp_idx],
                       _table("d_sp_lo", dev)[i_neg])
    j = torch.where(pos, j_pos, j_neg)
    q = torch.where(pos, q_pos, q_neg)
    e10 = torch.where(pos, q_pos, q_neg + e2)

    mp = mv + 2
    mm = mv - 1 - mm_shift
    vr = _mulshift64(mv, f_hi, f_lo, j)
    vp = _mulshift64(mp, f_hi, f_lo, j)
    vm = _mulshift64(mm, f_hi, f_lo, j)

    false = torch.zeros_like(pos)
    small_q = pos & (q <= 21)
    mv_mod5 = torch.remainder(mv, 5) == 0
    vr_tz = torch.where(small_q & mv_mod5, _pow5_factor_ge(mv, q), false)
    vm_tz = torch.where(small_q & ~mv_mod5 & accept,
                        _pow5_factor_ge(mm, q), false)
    vp_adj = torch.where(small_q & ~mv_mod5 & ~accept,
                         _pow5_factor_ge(mp, q), false)
    neg_q1 = ~pos & (q <= 1)
    vr_tz = vr_tz | neg_q1
    vm_tz = torch.where(neg_q1 & accept, mm_shift == 1, vm_tz)
    vp_adj = vp_adj | (neg_q1 & ~accept)
    neg_q63 = ~pos & (q > 1) & (q < 63)
    vr_tz = torch.where(neg_q63, _multiple_of_pow2(mv, q - 1), vr_tz)
    vp = vp - vp_adj.to(torch.int64)

    state = _trim_loop(vr, vp, vm, torch.zeros_like(vr), vr_tz, vm_tz, 22)
    digits, exp10 = _finish(*state, accept, e10)
    return sign, digits, exp10, is_zero, is_inf, is_nan


# ---------------------------------------------------------------------------
# FLOAT32
# ---------------------------------------------------------------------------


def shortest_decimal32(bits: torch.Tensor):
    """Ryu f2f over FLOAT32 bit patterns (int32, or int64 holding the u32
    word); the contract of :func:`shortest_decimal64` (digits fit 9
    decimal digits)."""
    dev = bits.device
    b = bits.to(torch.int64) & _M32
    ieee_m = b & ((1 << 23) - 1)
    ieee_e = (b >> 23) & 0xFF
    sign = (b >> 31) != 0
    is_zero = (ieee_e == 0) & (ieee_m == 0)
    is_inf = (ieee_e == 0xFF) & (ieee_m == 0)
    is_nan = (ieee_e == 0xFF) & (ieee_m != 0)

    subnormal = ieee_e == 0
    e2 = torch.where(subnormal, 1, ieee_e) - 127 - 23 - 2
    m2 = torch.where(subnormal, ieee_m, ieee_m | (1 << 23))
    accept = (m2 & 1) == 0
    mv = 4 * m2
    mm_shift = ((ieee_m != 0) | (ieee_e <= 1)).to(torch.int64)
    mp = mv + 2
    mm = mv - 1 - mm_shift
    inv, sp = _table("f_inv", dev), _table("f_sp", dev)

    # e2 >= 0
    e2c = e2.clamp(min=0)
    q_pos = _log10_pow2(e2c)
    k_pos = _F_POW5_INV_BITCOUNT + _pow5bits(q_pos) - 1
    j_pos = -e2c + q_pos + k_pos
    f_pos = inv[q_pos.clamp(0, 30)]
    qm1 = (q_pos - 1).clamp(0, 30)
    j_pos1 = -e2c + (q_pos - 1) + _F_POW5_INV_BITCOUNT + _pow5bits(qm1) - 1
    f_pos1 = inv[qm1]
    # e2 < 0
    e2n = (-e2).clamp(min=0)
    q_neg = _log10_pow5(e2n)
    i_neg = (e2n - q_neg).clamp(0, 47)
    j_neg = q_neg - (_pow5bits(i_neg) - _F_POW5_BITCOUNT)
    f_neg = sp[i_neg]
    i1 = (i_neg + 1).clamp(0, 47)
    j_neg1 = q_neg - 1 - (_pow5bits(i1) - _F_POW5_BITCOUNT)
    f_neg1 = sp[i1]

    pos = e2 >= 0
    factor = torch.where(pos, f_pos, f_neg)
    j = torch.where(pos, j_pos, j_neg)
    q = torch.where(pos, q_pos, q_neg)
    e10 = torch.where(pos, q_pos, q_neg + e2)
    factor1 = torch.where(pos, f_pos1, f_neg1)
    j1 = torch.where(pos, j_pos1, j_neg1)

    vr = _mulshift32(mv, factor, j)
    vp = _mulshift32(mp, factor, j)
    vm = _mulshift32(mm, factor, j)
    # f2s takes lastRemovedDigit one scale down when the trim loop will
    # not run
    pre_last = torch.remainder(_mulshift32(mv, factor1, j1), 10)
    need_pre = (q != 0) & ((vp - 1) // 10 <= vm // 10)
    last0 = torch.where(need_pre, pre_last, 0)

    false = torch.zeros_like(pos)
    small_q = pos & (q <= 9)
    mv_mod5 = torch.remainder(mv, 5) == 0
    vr_tz = torch.where(small_q & mv_mod5, _pow5_factor_ge(mv, q), false)
    vm_tz = torch.where(small_q & ~mv_mod5 & accept,
                        _pow5_factor_ge(mm, q), false)
    vp_adj = torch.where(small_q & ~mv_mod5 & ~accept,
                         _pow5_factor_ge(mp, q), false)
    neg_q1 = ~pos & (q <= 1)
    vr_tz = vr_tz | neg_q1
    vm_tz = torch.where(neg_q1 & accept, mm_shift == 1, vm_tz)
    vp_adj = vp_adj | (neg_q1 & ~accept)
    neg_q31 = ~pos & (q > 1) & (q < 31)
    vr_tz = torch.where(neg_q31, _multiple_of_pow2(mv, q - 1), vr_tz)
    vp = vp - vp_adj.to(torch.int64)

    state = _trim_loop(vr, vp, vm, last0, vr_tz, vm_tz, 11)
    digits, exp10 = _finish(*state, accept, e10)
    return sign, digits, exp10, is_zero, is_inf, is_nan


# ---------------------------------------------------------------------------
# Eisel-Lemire: correctly rounded decimal -> binary
# ---------------------------------------------------------------------------
#
# For w <= 19 digits the 128-bit product suffices (Lemire, Thm. 1, with
# the explicit round-to-even window), so there is no slow path; callers
# keep the top 19 significant digits of longer mantissas.

_EL_SMALLEST_Q = -342
_EL_LARGEST_Q = 308


@functools.lru_cache(maxsize=1)
def _el_pow5_tables():
    his, los = [], []
    for q in range(_EL_SMALLEST_Q, _EL_LARGEST_Q + 1):
        if q >= 0:
            v = 5 ** q
            b = v.bit_length()
            v = v << (128 - b) if b <= 128 else v >> (b - 128)
        else:
            p = 5 ** (-q)
            v = (1 << (p.bit_length() + 127)) // p + 1
        assert v.bit_length() == 128
        his.append(_i64(v >> 64))
        los.append(_i64(v))
    return his, los


def _clz64(w: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u64 bit patterns (w != 0)."""
    n = torch.zeros_like(w)
    x = w
    for s in (32, 16, 8, 4, 2, 1):
        top_empty = lshr(x, 64 - s) == 0
        n = n + torch.where(top_empty, s, 0)
        x = torch.where(top_empty, x << s, x)
    return n


def decimal_to_bits(w: torch.Tensor, q: torch.Tensor, bits64: bool = True):
    """``w x 10^q`` correctly rounded to a positive IEEE bit pattern.

    ``w`` holds u64 mantissas (int64 carriers; callers handle w == 0),
    ``q`` the decimal exponents. Returns int64 tensors: FLOAT64 bits, or
    the FLOAT32 word in the low 32 bits; overflow gives +inf and
    underflow +0."""
    dev = w.device
    q = q.to(torch.int64)
    if bits64:
        expl_bits, prec_shift, min_exp = 52, 9, -1023
        tie_lo, tie_hi, inf_exp = -4, 23, 0x7FF
    else:
        expl_bits, prec_shift, min_exp = 23, 38, -127
        tie_lo, tie_hi, inf_exp = -17, 10, 0xFF

    qi = q.clamp(_EL_SMALLEST_Q, _EL_LARGEST_Q) - _EL_SMALLEST_Q
    f_hi = _table("el_hi", dev)[qi]
    f_lo = _table("el_lo", dev)[qi]

    lz = _clz64(torch.where(w == 0, 1, w))
    wn = w << lz
    hi, lo = _umul128(wn, f_hi)
    prec_mask = (1 << prec_shift) - 1
    need2 = (hi & prec_mask) == prec_mask
    hi2, _ = _umul128(wn, f_lo)
    lo_r = lo + hi2
    carry = ult(lo_r, lo).to(torch.int64)
    hi = torch.where(need2, hi + carry, hi)
    lo = torch.where(need2, lo_r, lo)

    upperbit = lshr(hi, 63)
    m = lshr(hi, upperbit + prec_shift)
    pow_q = ((217706 * q) >> 16) + 63
    power2 = pow_q + upperbit - lz - min_exp

    # subnormal path
    sub_shift = (1 - power2).clamp(0, 63)
    m_sub = m >> sub_shift
    m_sub = (m_sub + (m_sub & 1)) >> 1
    sub_bits = m_sub | ((m_sub >> expl_bits) << expl_bits)
    underflow = (1 - power2) >= 64

    # normal path, with the round-ties-to-even window
    tie = (~ult(1, lo) & (q >= tie_lo) & (q <= tie_hi) & ((m & 3) == 1)
           & ((m << (upperbit + prec_shift)) == hi))
    m_n = torch.where(tie, m & ~1, m)
    m_n = (m_n + (m_n & 1)) >> 1
    ovf = m_n >= (1 << (expl_bits + 1))
    m_n = torch.where(ovf, 1 << expl_bits, m_n)
    power2 = power2 + ovf.to(torch.int64)
    m_n = m_n & ~(1 << expl_bits)
    norm_bits = (power2 << expl_bits) | m_n

    bits = torch.where(power2 <= 0, sub_bits, norm_bits)
    bits = torch.where(underflow & (power2 <= 0), 0, bits)
    inf_bits = inf_exp << expl_bits
    bits = torch.where(power2 >= inf_exp, inf_bits, bits)
    bits = torch.where(q > _EL_LARGEST_Q, inf_bits, bits)
    bits = torch.where(q < _EL_SMALLEST_Q, 0, bits)
    return torch.where(w == 0, 0, bits)
