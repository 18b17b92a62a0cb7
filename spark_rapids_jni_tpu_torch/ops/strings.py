"""STRING columns (port of ``ops/strings.py``): repadding, comparisons
and ``||``, Spark CAST to and from STRING, the order-preserving
dictionary codes of string keys, and the string function library
(``length`` ... ``translate``, at the end of the module).

A STRING column is an ``(n, pad)`` uint8 matrix, zero past each row's
length, plus int32 ``lengths``. Every op here is vector byte arithmetic
over that matrix, as in the JAX package; the result pad widths of the
formatters are constants of the source type, so no cast syncs with the
host.

CAST follows Spark's non-ANSI contract: a string that does not parse
gives null. STRING -> FLOAT parses through the Eisel-Lemire core and
FLOAT -> STRING formats through Ryu (``ops/ryu.py``) with Java's
``Double.toString`` layout. STRING -> DECIMAL128 runs a masked Horner
over the byte matrix in 128-bit limbs, DECIMAL128 -> STRING a long
division into base-10^9 chunks (``ops/int128.py``).
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column
from . import compute
from . import keys as keys_mod
from .ryu import decimal_to_bits, lshr, shortest_decimal32, shortest_decimal64


def _require_string(col: Column):
    if not col.dtype.is_string:
        raise TypeError("expected a STRING column")


def _cols(pad: int, device) -> torch.Tensor:
    """(1, pad) int32 byte positions."""
    return torch.arange(pad, dtype=torch.int32, device=device)[None, :]


@functools.lru_cache(maxsize=1024)
def const(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device``, copied there once (a copy
    from host memory per call would sync the host)."""
    return torch.tensor(values, dtype=dtype, device=device)


def row_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Running int64 sum along each row of an (n, pad) matrix. The scan
    runs down the columns of the transposed matrix: torch's scan along a
    short innermost dimension is slow on the card."""
    return torch.cumsum(mask.T.contiguous().to(torch.int64), dim=0).T


def _in_str(col: Column) -> torch.Tensor:
    return _cols(col.data.shape[1], col.data.device) < col.lengths[:, None]


def _case_map(col: Column, to_upper: bool) -> Column:
    lo, hi = (ord("a"), ord("z")) if to_upper else (ord("A"), ord("Z"))
    mat = col.data
    shift = ((mat >= lo) & (mat <= hi)).to(torch.uint8) * 32
    out = mat - shift if to_upper else mat + shift
    return Column(out, dt.STRING, col.validity, col.lengths)


def lower(col: Column) -> Column:
    """ASCII lower case."""
    _require_string(col)
    return _case_map(col, False)


def _shift_left(col: Column, shift: torch.Tensor,
                new_len: torch.Tensor) -> Column:
    """Row-wise left shift by a per-row amount, zeroing past new_len."""
    pad = col.data.shape[1]
    j = _cols(pad, col.data.device)
    src = (j + shift[:, None]).clamp(0, pad - 1).to(torch.int64)
    out = torch.gather(col.data, 1, src)
    out = torch.where(j < new_len[:, None], out, 0).to(torch.uint8)
    return Column(out, dt.STRING, col.validity, new_len.to(torch.int32))


def _strip_counts(col: Column, chars: bytes, from_left: bool):
    """Count of strip-set bytes at the left (or right) edge of each row."""
    in_set = torch.zeros(col.data.shape, dtype=torch.bool,
                         device=col.data.device)
    for ch in chars:
        in_set = in_set | (col.data == ch)
    boundary = _in_str(col) & ~in_set
    has = boundary.any(dim=1)
    boundary = boundary.to(torch.uint8)
    lens = col.lengths.to(torch.int64)
    if from_left:
        return torch.where(has, boundary.argmax(dim=1), lens)
    pad = col.data.shape[1]
    last = pad - 1 - boundary.flip(1).argmax(dim=1)
    return torch.where(has, lens - last - 1, lens)


def strip(col: Column, chars: Union[str, bytes] = b" ") -> Column:
    """Trim the byte set from both ends (Spark ``trim``: spaces)."""
    _require_string(col)
    cset = chars.encode() if isinstance(chars, str) else bytes(chars)
    left = _strip_counts(col, cset, True)
    right = _strip_counts(col, cset, False)
    new_len = (col.lengths - left - right).clamp(min=0)
    return _shift_left(col, left, new_len)


def concat(a: Column, b: Column) -> Column:
    """Rowwise concatenation (Spark ``concat``: null if either is)."""
    _require_string(a)
    _require_string(b)
    n, pad_a = a.data.shape
    pad_b = b.data.shape[1]
    out_pad = pad_a + pad_b
    out = torch.zeros((n, out_pad), dtype=torch.uint8, device=a.data.device)
    out[:, :pad_a] = a.data
    j = _cols(out_pad, a.data.device)
    src = j - a.lengths[:, None]
    b_g = torch.gather(b.data, 1, src.clamp(0, pad_b - 1).to(torch.int64))
    out = torch.where((src >= 0) & (src < pad_b), b_g, out)
    new_len = a.lengths + b.lengths
    out = torch.where(j < new_len[:, None], out, 0).to(torch.uint8)
    return Column(out, dt.STRING, compute.merge_validity(a, b), new_len)


def repad(col: Column, pad: int) -> Column:
    """The column at another pad width (>= its longest string)."""
    _require_string(col)
    n, old = col.data.shape
    if pad == old:
        return col
    if pad > old:
        out = torch.zeros((n, pad), dtype=torch.uint8, device=col.data.device)
        out[:, :old] = col.data
    else:
        out = torch.where(_cols(pad, col.data.device) < col.lengths[:, None],
                          col.data[:, :pad], 0).to(torch.uint8)
    return Column(out, dt.STRING, col.validity, col.lengths)


def common_pad(cols) -> list:
    """STRING columns repadded to their widest pad."""
    pad = max(c.data.shape[1] for c in cols)
    return [repad(c, pad) for c in cols]


def binary_op(op: str, a: Column, b: Column) -> Column:
    """Comparisons in memcmp order (through the order words) and ``add``
    (Spark ``||``)."""
    _require_string(a)
    _require_string(b)
    a, b = common_pad([a, b])
    if op == "add":
        return concat(a, b)
    n = a.data.shape[0]
    eq = torch.ones(n, dtype=torch.bool, device=a.data.device)
    lt = torch.zeros_like(eq)
    for x, y in zip(keys_mod.column_order_keys(a),
                    keys_mod.column_order_keys(b)):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    table = {"eq": eq, "ne": ~eq, "lt": lt, "le": lt | eq,
             "gt": ~(lt | eq), "ge": ~lt}
    if op not in table:
        raise TypeError(f"binary op {op!r} not supported for strings")
    return Column(table[op], dt.BOOL8, compute.merge_validity(a, b))


# ---------------------------------------------------------------------------
# CAST
# ---------------------------------------------------------------------------


def cast(col: Column, to: dt.DType) -> Column:
    """Spark CAST between STRING and bool, the integers, the floats and
    the decimals (non-ANSI: unparseable strings are null)."""
    if col.dtype.is_string and to.is_string:
        return col
    if col.dtype.is_string:
        if to.is_boolean:
            return _parse_bool(col)
        if to.is_integer:
            return _parse_int(col, to)
        if to.is_floating:
            return _parse_float(col, to)
        if to.is_decimal:
            return _parse_decimal(col, to)
        raise TypeError(f"cast STRING -> {to} not supported")
    if to.is_string:
        if col.dtype.is_boolean:
            return _format_bool(col)
        if col.dtype.is_integer:
            return _format_int(col)
        if col.dtype.is_decimal:
            return _format_decimal(col)
        if col.dtype.is_floating:
            return _format_float(col)
        raise TypeError(f"cast {col.dtype} -> STRING not supported")
    raise TypeError(f"not a string cast: {col.dtype} -> {to}")


_WS = b" \t\r\n\x0b\x0c"
_POW10 = [10 ** k for k in range(19)]


def _pow10(device) -> torch.Tensor:
    return const(tuple(_POW10), torch.int64, device)


def _first_true(mask: torch.Tensor, default: torch.Tensor) -> torch.Tensor:
    """Index of each row's first True, else ``default``."""
    return torch.where(mask.any(dim=1), mask.to(torch.uint8).argmax(dim=1),
                       default)


def _parse_parts(col: Column) -> dict:
    """The shared scanner: whitespace-trimmed sign/digits/dot/exponent
    decomposition of every row."""
    c = strip(col, _WS)
    mat, lens = c.data, c.lengths.to(torch.int64)
    pad = mat.shape[1]
    j = _cols(pad, mat.device).to(torch.int64)
    in_str = j < lens[:, None]
    first = mat[:, 0]
    neg = (first == ord("-")) & (lens > 0)
    start = (neg | ((first == ord("+")) & (lens > 0))).to(torch.int64)
    isdigit = (mat >= ord("0")) & (mat <= ord("9")) & in_str
    isdot = (mat == ord(".")) & in_str
    is_e = ((mat == ord("e")) | (mat == ord("E"))) & in_str
    return {
        "col": c, "mat": mat, "lens": lens, "j": j, "in_str": in_str,
        "neg": neg, "start": start, "isdigit": isdigit, "isdot": isdot,
        "ndots": isdot.sum(dim=1), "nes": is_e.sum(dim=1),
        "dotpos": _first_true(isdot, lens), "epos": _first_true(is_e, lens),
        "pad": pad,
    }


def _weighted_int(digits_mask, mat, max_digits: int = 18):
    """(value of the masked digit run as int64, digit count, overflow).

    Overflow counts significant digits (after leading zeros); 19 are
    accepted when the int64 sum did not wrap (value >= 10^18)."""
    cum = row_cumsum(digits_mask)
    total = cum[:, -1:]
    rank = (total - cum).clamp(0, max_digits)
    w = torch.where(digits_mask, _pow10(mat.device)[rank], 0)
    dig = mat.to(torch.int64) - ord("0")
    val = torch.where(digits_mask, dig * w, 0).sum(dim=1)
    nonzero = digits_mask & (mat != ord("0"))
    lead_zero = digits_mask & (row_cumsum(nonzero) == 0)
    sig = total[:, 0] - lead_zero.sum(dim=1)
    if max_digits >= 18:
        overflow = (sig > 19) | ((sig == 19) & (val < 10**18))
    else:
        overflow = sig > max_digits
    return val, total[:, 0], overflow


def _int_syntax_ok(p, int_mask, frac_mask):
    """Bytes after the sign are digits or one dot (fraction digits are
    allowed and truncated: Spark's '3.7' -> 3)."""
    body = p["in_str"] & (p["j"] >= p["start"][:, None])
    ok_bytes = (~body | p["isdigit"] | p["isdot"]).all(dim=1)
    some_digit = (int_mask | frac_mask).any(dim=1)
    return (ok_bytes & (p["ndots"] <= 1) & (p["lens"] > p["start"])
            & some_digit)


def _valid(col: Column, ok: torch.Tensor) -> torch.Tensor:
    return ok if col.validity is None else col.validity & ok


def _store(vals: torch.Tensor, to: dt.DType, valid) -> Column:
    """int64 (or float) values -> a column of ``to`` (integer values wrap
    to its width)."""
    want = compute.TORCH_OF[to.value_dtype]
    if not want.is_floating_point and want != torch.bool:
        vals = compute.from_carrier(vals, want)
    return compute.from_values(vals, to, valid)


def _parse_int(col: Column, to: dt.DType) -> Column:
    p = _parse_parts(col)
    j = p["j"]
    int_mask = (p["isdigit"] & (j >= p["start"][:, None])
                & (j < p["dotpos"][:, None]))
    frac_mask = p["isdigit"] & (j > p["dotpos"][:, None])
    val, _, overflow = _weighted_int(int_mask, p["mat"])
    ok = _int_syntax_ok(p, int_mask, frac_mask) & ~overflow & (p["nes"] == 0)
    signed = torch.where(p["neg"], -val, val)
    info = np.iinfo(to.host_dtype)
    if info.max > 2**63:  # UINT64: the non-negative int64 values
        in_range = signed >= 0
    else:
        in_range = (signed >= int(info.min)) & (signed <= int(info.max))
    ok = ok & in_range
    return _store(torch.where(ok, signed, 0), to, _valid(col, ok))


_SPECIALS = {
    b"nan": float("nan"), b"inf": float("inf"), b"infinity": float("inf"),
    b"+inf": float("inf"), b"+infinity": float("inf"),
    b"-inf": -float("inf"), b"-infinity": -float("inf"),
}


def _literal_eq(low: Column, lit: bytes) -> torch.Tensor:
    """Rows equal to ``lit``; ``low`` is already lower-cased."""
    m = len(lit)
    n, pad = low.data.shape
    if m > pad:
        return torch.zeros(n, dtype=torch.bool, device=low.data.device)
    want = const(tuple(lit), torch.uint8, low.data.device)
    return (low.data[:, :m] == want[None, :]).all(dim=1) & (low.lengths == m)


def _parse_float(col: Column, to: dt.DType) -> Column:
    p = _parse_parts(col)
    c, j, mat = p["col"], p["j"], p["mat"]
    dotpos, epos = p["dotpos"][:, None], p["epos"][:, None]
    int_mask = (p["isdigit"] & (j >= p["start"][:, None]) & (j < dotpos)
                & (j < epos))
    frac_mask = p["isdigit"] & (j > dotpos) & (j < epos)
    mant_mask = int_mask | frac_mask
    # the mantissa as one exact u64 over its top 19 significant digits;
    # digits below that window shift into the decimal exponent
    cum = row_cumsum(mant_mask)
    total = cum[:, -1]
    rank = total[:, None] - cum
    dig = mat.to(torch.int64) - ord("0")
    nz_seen = row_cumsum(mant_mask & (dig != 0))
    lead = (mant_mask & (nz_seen == 0)).sum(dim=1)
    hi_cut = total - lead
    lo_cut = (hi_cut - 19).clamp(min=0)
    in_window = (mant_mask & (rank < hi_cut[:, None])
                 & (rank >= lo_cut[:, None]))
    w_rank = (rank - lo_cut[:, None]).clamp(0, 18)
    mant_w = torch.where(in_window, dig * _pow10(mat.device)[w_rank],
                         0).sum(dim=1)
    n_frac = frac_mask.sum(dim=1)
    # exponent: an optional sign, then digits after e/E
    e_start = p["epos"] + 1
    e_first = torch.gather(mat, 1, e_start.clamp(0, p["pad"] - 1)[:, None])[:, 0]
    in_e = e_start < p["lens"]
    e_neg = (e_first == ord("-")) & in_e
    e_sign = e_neg | ((e_first == ord("+")) & in_e)
    e_body_from = (e_start + e_sign.to(torch.int64))[:, None]
    e_digits = p["isdigit"] & (j >= e_body_from)
    e_val, e_count, _ = _weighted_int(e_digits, mat, max_digits=3)
    has_e = p["nes"] > 0
    exp = torch.where(has_e, torch.where(e_neg, -e_val, e_val), 0)
    is64 = to.id == dt.TypeId.FLOAT64
    bits = decimal_to_bits(mant_w, exp - n_frac + lo_cut, bits64=is64)
    # the sign goes onto the bit pattern, and FLOAT32 never passes
    # through FLOAT64 arithmetic
    if is64:
        value = (bits | (p["neg"].to(torch.int64) << 63)).view(torch.float64)
    else:
        b32 = bits | (p["neg"].to(torch.int64) << 31)
        value = ((b32 ^ 2**31) - 2**31).to(torch.int32).view(torch.float32)

    body = p["in_str"] & (j >= p["start"][:, None]) & (j < epos)
    ok_mant = (~body | p["isdigit"] | p["isdot"]).all(dim=1)
    e_body = p["in_str"] & (j >= e_body_from)
    ok_exp = (~e_body | p["isdigit"]).all(dim=1) & (~has_e | (e_count > 0))
    some_digit = mant_mask.sum(dim=1) > 0
    ok = (ok_mant & ok_exp & some_digit & (p["ndots"] <= 1) & (p["nes"] <= 1)
          & ((p["ndots"] == 0) | (p["dotpos"] <= p["epos"])))
    low = lower(c)
    for lit, sval in _SPECIALS.items():
        hit = _literal_eq(low, lit)
        value = torch.where(hit, sval, value)
        ok = ok | hit
    return compute.from_values(torch.where(ok, value, 0.0), to,
                               _valid(col, ok))


_TRUE = (b"t", b"true", b"y", b"yes", b"1")
_FALSE = (b"f", b"false", b"n", b"no", b"0")


def _parse_bool(col: Column) -> Column:
    low = lower(strip(col, _WS))
    is_true = torch.zeros(col.row_count, dtype=torch.bool,
                          device=col.data.device)
    is_false = torch.zeros_like(is_true)
    for lit in _TRUE:
        is_true = is_true | _literal_eq(low, lit)
    for lit in _FALSE:
        is_false = is_false | _literal_eq(low, lit)
    return Column(is_true, dt.BOOL8, _valid(col, is_true | is_false))


def _decimal_parts(p, k: int, drop_int: int):
    """The kept-digit masks of STRING -> decimal, for both accumulator
    widths: ``(int_keep, frac_keep, frac_mask, sig_int, int_mask)``. A
    positive target scale ``drop_int`` leaves the last that many integer
    digits out (truncation toward zero before they are summed)."""
    j, mat = p["j"], p["mat"]
    int_mask = (p["isdigit"] & (j >= p["start"][:, None])
                & (j < p["dotpos"][:, None]))
    int_keep = int_mask
    if drop_int > 0:
        cum_int = row_cumsum(int_mask)
        int_keep = int_mask & (cum_int[:, -1:] - cum_int >= drop_int)
    frac_keep = (p["isdigit"] & (j > p["dotpos"][:, None])
                 & (j <= (p["dotpos"] + k)[:, None]))
    frac_mask = p["isdigit"] & (j > p["dotpos"][:, None])
    nonzero = int_keep & (mat != ord("0"))
    lead = int_keep & (row_cumsum(nonzero) == 0)
    sig_int = int_keep.sum(dim=1) - lead.sum(dim=1)
    return int_keep, frac_keep, frac_mask, sig_int, int_mask


def _parse_decimal128(col: Column, to: dt.DType) -> Column:
    """STRING -> DECIMAL128: a masked Horner over the byte matrix, one
    column at a time, in (lo, hi) limbs (the running value times ten
    plus the digit where the byte is a kept digit); missing fraction
    places fill with one or two u64 powers of ten. Up to 38 significant
    digits (Spark's DECIMAL(38)); more is null."""
    from . import int128

    p = _parse_parts(col)
    mat = p["mat"]
    k = max(-to.scale, 0)
    int_keep, frac_keep, frac_mask, sig_int, int_mask = _decimal_parts(
        p, k, max(to.scale, 0))
    kept = int_keep | frac_keep
    dig = mat.to(torch.int64) - ord("0")
    lo = torch.zeros(mat.shape[0], dtype=torch.int64, device=mat.device)
    hi = torch.zeros_like(lo)
    for c in range(p["pad"]):
        tlo, thi = int128.mul_u64(lo, hi, 10)
        nlo = tlo + dig[:, c]
        nhi = thi + int128.ult(nlo, tlo).to(torch.int64)
        lo = torch.where(kept[:, c], nlo, lo)
        hi = torch.where(kept[:, c], nhi, hi)
    fill = (k - frac_keep.sum(dim=1)).clamp(0, 38)
    p10 = const(tuple(int128.carrier(10**t) for t in range(20)), torch.int64,
                mat.device)
    lo, hi = int128.mul_u64(lo, hi, p10[fill.clamp(max=19)])
    lo, hi = int128.mul_u64(lo, hi, p10[(fill - 19).clamp(0, 19)])
    ok = (_int_syntax_ok(p, int_mask, frac_mask) & (p["nes"] == 0)
          & ((sig_int + k) <= 38))
    nlo, nhi = int128.negate(lo, hi)
    lo = torch.where(p["neg"], nlo, lo)
    hi = torch.where(p["neg"], nhi, hi)
    limbs = torch.stack([torch.where(ok, lo, 0), torch.where(ok, hi, 0)], 1)
    return Column(limbs, to, _valid(col, ok))


def _parse_decimal(col: Column, to: dt.DType) -> Column:
    """STRING -> DECIMAL32/64: the unscaled value is the integer part
    times 10^-scale plus the first -scale fraction digits (more truncate,
    cudf fixed_point); a positive scale drops that many integer digits
    before they are summed. Unrepresentable values are null."""
    if to.id == dt.TypeId.DECIMAL128:
        return _parse_decimal128(col, to)
    p = _parse_parts(col)
    mat = p["mat"]
    k = max(-to.scale, 0)
    int_keep, frac_keep, frac_mask, sig_int, int_mask = _decimal_parts(
        p, k, max(to.scale, 0))
    int_val, _, int_over = _weighted_int(int_keep, mat)
    pos = torch.where(frac_keep, row_cumsum(frac_keep), 0)
    w = torch.where(frac_keep, _pow10(mat.device)[(k - pos).clamp(0, 18)], 0)
    dig = mat.to(torch.int64) - ord("0")
    frac_val = torch.where(frac_keep, dig * w, 0).sum(dim=1)
    unscaled = int_val * (10 ** min(k, 18)) + frac_val
    signed = torch.where(p["neg"], -unscaled, unscaled)
    info = np.iinfo(to.host_dtype)
    ok = (_int_syntax_ok(p, int_mask, frac_mask) & ~int_over & (p["nes"] == 0)
          & ((sig_int + k) <= 18) & (signed >= int(info.min))
          & (signed <= int(info.max)))
    return _store(torch.where(ok, signed, 0), to, _valid(col, ok))


def _format_bool(col: Column) -> Column:
    dev = col.data.device
    t = const(tuple(b"true\x00"), torch.uint8, dev)
    f = const(tuple(b"false"), torch.uint8, dev)
    b = col.data.to(torch.bool)
    data = torch.where(b[:, None], t[None, :], f[None, :])
    lens = torch.where(b, 4, 5).to(torch.int32)
    return Column(data, dt.STRING, col.validity, lens)


def _digit_matrix(mag: torch.Tensor, K: int):
    """(digits least-significant first (n, K+1) int64, digit count) of
    u64 magnitudes (int64 carriers; 2^63 is the one above the int64
    range). One unsigned division by 10 first, then signed ones."""
    q = lshr(mag, 1) // 5  # floor(mag / 10) of the u64 value
    pows = _pow10(mag.device)[:K]
    digs = torch.cat([(mag - 10 * q)[:, None],
                      torch.remainder(q[:, None] // pows[None, :], 10)], 1)
    ndig = ((mag != 0).to(torch.int64)
            + (q[:, None] >= pows[None, :]).sum(dim=1)).clamp(min=1)
    return digs, ndig


def _digit_matrix128(lo: torch.Tensor, hi: torch.Tensor):
    """(digits least-significant first (n, 40) int64, digit count) of a
    128-bit magnitude in limbs: five base-10^9 chunks by long division,
    then each chunk's nine digits (a u128 has at most 39)."""
    from .int128 import divmod_u32_rem

    chunks = []
    for _ in range(4):
        lo, hi, r = divmod_u32_rem(lo, hi, 10**9)
        chunks.append(r)
    chunks.append(lo)  # below 10^3 after four divisions
    pows9 = _pow10(lo.device)[:9]
    digs = torch.cat([torch.remainder(c[:, None] // pows9[None, :], 10)
                      for c in chunks], 1)[:, :40]
    nz = digs != 0
    highest = 39 - nz.flip(1).to(torch.uint8).argmax(dim=1)
    return digs, torch.where(nz.any(dim=1), highest + 1, 1)


def _abs_u64(v: torch.Tensor):
    """(v < 0, |v| as u64 bits) of int64 values (|INT64_MIN| = 2^63)."""
    neg = v < 0
    return neg, torch.where(neg, -v, v)


def _chars(digs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(digs, 1, idx.to(torch.int64)) + ord("0")


def _format_int(col: Column) -> Column:
    """INT -> STRING: up to 19 digits, leading zeros suppressed, the
    sign prepended."""
    # the value as int64, as the JAX package takes it (a UINT64 value
    # past 2^63 prints negative there too)
    neg, mag = _abs_u64(compute.to_carrier(compute.values(col)).to(torch.int64))
    K = 19
    digs, ndig = _digit_matrix(mag, K)
    o = neg.to(torch.int64)
    lens = ndig + o
    j = _cols(K + 2, mag.device).to(torch.int64)
    idx = (ndig[:, None] - 1 - (j - o[:, None])).clamp(0, K)
    out = torch.where(neg[:, None] & (j == 0), ord("-"), _chars(digs, idx))
    out = torch.where(j < lens[:, None], out, 0).to(torch.uint8)
    return Column(out, dt.STRING, col.validity, lens.to(torch.int32))


def _format_decimal(col: Column) -> Column:
    """DECIMAL32/64/128 -> STRING at any scale: the digits with a point
    ``-scale`` digits from the right (integer part at least one digit);
    a positive scale appends that many zeros."""
    s = col.dtype.scale
    d = -s
    if col.dtype.id == dt.TypeId.DECIMAL128:
        from .int128 import negate

        lo, hi = col.data[:, 0], col.data[:, 1]
        neg = hi < 0
        nlo, nhi = negate(lo, hi)
        digs, ndig = _digit_matrix128(torch.where(neg, nlo, lo),
                                      torch.where(neg, nhi, hi))
        K = 39
    elif s == 0:
        return _format_int(col)
    else:
        neg, mag = _abs_u64(compute.values(col).to(torch.int64))
        K = 19
        digs, ndig = _digit_matrix(mag, K)
    dev = digs.device
    o = neg.to(torch.int64)
    if s > 0:
        lens = o + ndig + s
        j = _cols(K + 2 + s, dev).to(torch.int64)
        p = j - o[:, None]
        in_digits = (p >= 0) & (p < ndig[:, None])
        idx = (ndig[:, None] - 1 - p).clamp(0, K)
        chars = torch.where(in_digits, _chars(digs, idx), ord("0"))
        out = torch.where(neg[:, None] & (j == 0), ord("-"), chars)
        out = torch.where(j < lens[:, None], out, 0).to(torch.uint8)
        return Column(out, dt.STRING, col.validity, lens.to(torch.int32))
    int_digits = (ndig - d).clamp(min=1)
    lens = o + int_digits + (1 + d if d else 0)
    j = _cols(K + 3 + max(d - K, 0), dev).to(torch.int64)
    p = j - o[:, None]
    point_at = int_digits[:, None]
    di = torch.where(p < point_at, point_at - 1 - p + d, d - 1 - (p - point_at - 1))
    chars = torch.where(di <= K, _chars(digs, di.clamp(0, K)), ord("0"))
    out = torch.where(p == point_at, ord("."), chars) if d else chars
    out = torch.where(neg[:, None] & (j == 0), ord("-"), out)
    out = torch.where(j < lens[:, None], out, 0).to(torch.uint8)
    return Column(out, dt.STRING, col.validity, lens.to(torch.int32))


def _padded_literal(lit: bytes, width: int, device) -> torch.Tensor:
    return const(tuple(lit.ljust(width, b"\0")), torch.int64, device)


def _format_float(col: Column) -> Column:
    """FLOAT32/64 -> STRING: Ryu's shortest digits placed by Java's
    ``Double.toString`` rules: plain decimal when the normalized exponent
    is in [-3, 7) (at least one fraction digit, so 4.0), else
    ``d.fffE[-]x``; "NaN", "Infinity", "-Infinity" and signed zeros as
    they are."""
    if col.dtype.id == dt.TypeId.FLOAT64:
        sign, digits, exp10, is_zero, is_inf, is_nan = shortest_decimal64(
            col.data)
        K, width = 17, 26
    else:
        sign, digits, exp10, is_zero, is_inf, is_nan = shortest_decimal32(
            col.data.view(torch.int32))
        K, width = 9, 18
    dev = digits.device
    digs, olen = _digit_matrix(digits, K)
    sci_exp = olen - 1 + exp10
    plain = (sci_exp >= -3) & (sci_exp < 7)
    neg = sign & ~is_nan
    o = neg.to(torch.int64)
    int_len = torch.where(plain & (sci_exp >= 0), sci_exp + 1, 1)
    lead_zeros = torch.where(plain & (sci_exp < 0), -sci_exp - 1, 0)
    frac_digits = torch.where(
        plain,
        torch.where(sci_exp >= 0, (olen - (sci_exp + 1)).clamp(min=1),
                    lead_zeros + olen),
        (olen - 1).clamp(min=1))
    point_at = o + int_len
    eabs = sci_exp.abs()
    e_ndig = torch.where(eabs >= 100, 3, torch.where(eabs >= 10, 2, 1))
    e_neg = (sci_exp < 0).to(torch.int64)
    suffix_len = torch.where(plain, 0, 1 + e_neg + e_ndig)
    lens = o + int_len + 1 + frac_digits + suffix_len
    lens = torch.where(is_nan, 3, lens)
    lens = torch.where(is_inf, 8 + o, lens)
    lens = torch.where(is_zero, 3 + o, lens)

    j = _cols(width, dev).to(torch.int64)
    p = j - o[:, None]
    pa = point_at[:, None]
    frac_k = j - (pa + 1)
    plain_pos_i = torch.where(j < pa, p, int_len[:, None] + frac_k)
    planb_digit = frac_k - lead_zeros[:, None]
    sci_i = torch.where(j < pa, 0, 1 + frac_k)
    ms_i = torch.where(
        plain[:, None],
        torch.where((sci_exp >= 0)[:, None], plain_pos_i,
                    torch.where(j < pa, K, planb_digit)),
        sci_i)  # index K: a forced zero
    in_digits = (ms_i >= 0) & (ms_i < olen[:, None])
    idx = (olen[:, None] - 1 - ms_i).clamp(0, K)
    out = torch.where(in_digits, _chars(digs, idx), ord("0"))
    out = torch.where(j == pa, ord("."), out)

    sci = ~plain[:, None]
    e_at = (point_at + 1 + frac_digits)[:, None]
    out = torch.where(sci & (j == e_at), ord("E"), out)
    out = torch.where(sci & (e_neg == 1)[:, None] & (j == e_at + 1), ord("-"),
                      out)
    e_digit_ms = j - (e_at + 1 + e_neg[:, None])
    e_ls = (e_ndig[:, None] - 1 - e_digit_ms).clamp(0, 3)
    e_pows = const((1, 10, 100, 1000), torch.int64, dev)
    e_chars = torch.remainder(eabs[:, None] // e_pows[e_ls], 10) + ord("0")
    in_exp = (e_digit_ms >= 0) & (e_digit_ms < e_ndig[:, None])
    out = torch.where(sci & in_exp, e_chars, out)

    out = torch.where(neg[:, None] & (j == 0), ord("-"), out)
    out = torch.where(is_nan[:, None], _padded_literal(b"NaN", width, dev),
                      out)
    shifted = (p >= 0) & (p < width)
    at = p.clamp(0, width - 1)
    inf_s = _padded_literal(b"Infinity", width, dev)
    zero_s = _padded_literal(b"0.0", width, dev)
    out = torch.where(is_inf[:, None],
                      torch.where(shifted & (p < 8), inf_s[at], 0), out)
    out = torch.where(is_zero[:, None],
                      torch.where(shifted & (p < 3), zero_s[at], 0), out)
    out = torch.where((is_inf | is_zero)[:, None] & neg[:, None] & (j == 0),
                      ord("-"), out)
    out = torch.where(j < lens[:, None], out, 0).to(torch.uint8)
    return Column(out, dt.STRING, col.validity, lens.to(torch.int32))


# ---------------------------------------------------------------------------
# dictionary codes
# ---------------------------------------------------------------------------


def _dictionary_codes(col: Column):
    """(codes int32 in row order, perm, seg): one stable sort of the key
    words and a boundary scan. Codes preserve order: code order is key
    order (nulls first), so they can stand in for the key words."""
    from .groupby import _segment_ids

    perm, seg, _, _ = _segment_ids([col])
    codes = torch.empty_like(seg)
    codes[perm] = seg
    return codes.to(torch.int32), perm, seg


def dictionary_encode(col: Column):
    """(codes INT32 column, uniques STRING column): codes index into the
    sorted unique values."""
    _require_string(col)
    from .groupby import _segment_ids
    from .gather import gather_column

    perm, seg, starts, _ = _segment_ids([col])
    codes = torch.empty_like(seg)
    codes[perm] = seg
    return (Column(codes.to(torch.int32), dt.INT32, col.validity),
            gather_column(col, perm[starts]))


def encode_join_keys(left: Column, right: Column):
    """Two string key columns coded against one shared dictionary, so
    equality and order of codes are those of the strings across both."""
    _require_string(left)
    _require_string(right)
    left_r, right_r = common_pad([left, right])
    both = Column(torch.cat([left_r.data, right_r.data]), dt.STRING, None,
                  torch.cat([left.lengths, right.lengths]))
    codes, _, _ = _dictionary_codes(both)
    nl = left.row_count
    return (Column(codes[:nl], dt.INT32, left.validity),
            Column(codes[nl:], dt.INT32, right.validity))


# ---------------------------------------------------------------------------
# the string function library (Spark ``length``, ``upper``, ``substring``,
# ``instr``, ``lpad``, ``replace``, ``split(...)[i]``, ``concat_ws``,
# ``translate``, ...): byte-level vector arithmetic over the padded
# matrix, the JAX package's functions with its bytes, pad widths
# included. ``replace`` with a width change and ``url_encode`` read the
# host as the JAX package's eager calls do.
# ---------------------------------------------------------------------------


def length(col: Column) -> Column:
    """Byte length (Spark ``length`` counts characters: equal for
    ASCII; ``strings_utf8.char_length`` counts characters)."""
    _require_string(col)
    return Column(col.lengths.to(torch.int32), dt.INT32, col.validity)


def upper(col: Column) -> Column:
    """ASCII upper case."""
    _require_string(col)
    return _case_map(col, True)


def _literal_bytes(pat: Union[str, bytes]) -> bytes:
    if isinstance(pat, str):
        return pat.encode("utf-8", "surrogateescape")
    return bytes(pat)


def _bools(n: int, value: bool, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.bool, device=device)


def _match_ends(col: Column, pat: bytes) -> torch.Tensor:
    """(n, pad) bool: the literal ``pat`` (1 <= len <= pad) ends at byte
    j, all of it inside the string. One compare a pattern byte over the
    matrix (the JAX package runs a shift-or scan; the matches are the
    same)."""
    m = len(pat)
    data = col.data
    span = data.shape[1] - m + 1
    hit = data[:, :span] == pat[0]
    for i in range(1, m):
        hit = hit & (data[:, i:i + span] == pat[i])
    ends = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    ends[:, m - 1:] = hit
    return ends & _in_str(col)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """(has any, index of the first True) along each row."""
    return mask.any(dim=1), mask.to(torch.uint8).argmax(dim=1)


def contains(col: Column, pattern: Union[str, bytes]) -> Column:
    """Literal substring search (Spark ``contains``)."""
    _require_string(col)
    pat = _literal_bytes(pattern)
    n, pad = col.data.shape
    if not pat or len(pat) > pad:
        return Column(_bools(n, not pat, col.data.device), dt.BOOL8,
                      col.validity)
    return Column(_match_ends(col, pat).any(dim=1), dt.BOOL8, col.validity)


def starts_with(col: Column, pattern: Union[str, bytes]) -> Column:
    _require_string(col)
    pat = _literal_bytes(pattern)
    m = len(pat)
    n, pad = col.data.shape
    if not m or m > pad:
        return Column(_bools(n, not m, col.data.device), dt.BOOL8,
                      col.validity)
    want = const(tuple(pat), torch.uint8, col.data.device)
    ok = (col.data[:, :m] == want).all(dim=1) & (col.lengths >= m)
    return Column(ok, dt.BOOL8, col.validity)


def ends_with(col: Column, pattern: Union[str, bytes]) -> Column:
    _require_string(col)
    pat = _literal_bytes(pattern)
    m = len(pat)
    n, pad = col.data.shape
    if not m or m > pad:
        return Column(_bools(n, not m, col.data.device), dt.BOOL8,
                      col.validity)
    dev = col.data.device
    starts = (col.lengths - m).clamp(0, pad - m).to(torch.int64)
    tail = torch.gather(col.data, 1, starts[:, None] + _cols(m, dev))
    ok = ((tail == const(tuple(pat), torch.uint8, dev)).all(dim=1)
          & (col.lengths >= m))
    return Column(ok, dt.BOOL8, col.validity)


def substring(col: Column, start: int, slice_len: int) -> Column:
    """0-based substring with a fixed start and length (Spark
    ``substring``); the result's pad is ``slice_len`` (at most the
    input's, at least 1)."""
    _require_string(col)
    pad = col.data.shape[1]
    out_pad = max(min(slice_len, pad), 1)
    out = torch.roll(col.data, -start, dims=1)[:, :out_pad]
    new_len = (col.lengths - start).clamp(0, slice_len).to(torch.int32)
    out = torch.where(_cols(out_pad, out.device) < new_len[:, None], out,
                      0).to(torch.uint8)
    return Column(out, dt.STRING, col.validity, new_len)


def _strip_set(chars) -> bytes:
    return chars.encode() if isinstance(chars, str) else bytes(chars)


def lstrip(col: Column, chars: Union[str, bytes] = b" ") -> Column:
    """Spark ``ltrim`` (spaces by default)."""
    _require_string(col)
    left = _strip_counts(col, _strip_set(chars), True)
    return _shift_left(col, left, col.lengths - left)


def rstrip(col: Column, chars: Union[str, bytes] = b" ") -> Column:
    """Spark ``rtrim`` (spaces by default)."""
    _require_string(col)
    right = _strip_counts(col, _strip_set(chars), False)
    return _shift_left(col, torch.zeros_like(col.lengths),
                       col.lengths - right)


def find(col: Column, pattern: Union[str, bytes]) -> Column:
    """First byte index of the literal pattern, -1 if absent (Spark
    ``instr`` is this + 1)."""
    _require_string(col)
    pat = _literal_bytes(pattern)
    m = len(pat)
    n, pad = col.data.shape
    dev = col.data.device
    if not m:
        return Column(torch.zeros(n, dtype=torch.int32, device=dev),
                      dt.INT32, col.validity)
    pos = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if m <= pad:
        has, end = _first(_match_ends(col, pat))
        pos = torch.where(has, (end - (m - 1)).to(torch.int32), pos)
    return Column(pos, dt.INT32, col.validity)


def pad(col: Column, width: int, side: str = "right",
        fill: Union[str, bytes] = " ") -> Column:
    """Spark ``lpad``/``rpad``: exactly ``width`` bytes, padded with the
    (possibly multi-byte) ``fill`` pattern or cut to the leading
    ``width`` bytes; the result's pad is ``max(width, 1)``."""
    _require_string(col)
    fill_b = _literal_bytes(fill)
    if not fill_b:
        raise ValueError("pad: fill must be non-empty")
    if side not in ("left", "right"):
        raise ValueError("side must be 'left' or 'right'")
    n, old = col.data.shape
    c = repad(col, max(old, width))
    out_pad = c.data.shape[1]
    dev = c.data.device
    j = _cols(out_pad, dev)
    fillv = const(tuple(fill_b), torch.uint8, dev)
    m = len(fill_b)
    lens = c.lengths[:, None]
    if side == "right":
        data = torch.where(j < lens.clamp(max=width), c.data,
                           fillv[torch.remainder(j - lens, m).to(torch.int64)])
    else:
        shift = (width - lens).clamp(min=0)
        src = (j - shift).clamp(0, out_pad - 1).to(torch.int64)
        data = torch.where(j < shift, fillv[(j % m).to(torch.int64)],
                           torch.gather(c.data, 1, src))
    data = torch.where(j < width, data, 0).to(torch.uint8)
    out = Column(data, dt.STRING, c.validity,
                 torch.full((n,), width, dtype=torch.int32, device=dev))
    return repad(out, max(width, 1))


def replace(col: Column, old: Union[str, bytes],
            new: Union[str, bytes]) -> Column:
    """Literal, non-overlapping, leftmost-first replacement (Spark
    ``replace``). An equal-width substitution stays on the device; a
    width-changing one rebuilds the column on the host, as the JAX
    package's eager call does."""
    _require_string(col)
    old_b, new_b = _literal_bytes(old), _literal_bytes(new)
    m = len(old_b)
    if not m:
        return col
    n, pad_w = col.data.shape
    if len(new_b) == m and m <= pad_w:
        # row s: the matches that start at byte s
        starts = _match_ends(col, old_b)[:, m - 1:].T.contiguous()
        span = starts.shape[0]
        sel = torch.zeros_like(starts)
        next_free = torch.zeros(n, dtype=torch.int32, device=starts.device)
        for s in range(span):  # greedy: a match after the last one taken
            sel[s] = starts[s] & (next_free <= s)
            next_free = torch.where(sel[s], s + m, next_free)
        sel = sel.T
        data = col.data
        for i, b in enumerate(new_b):
            at = torch.zeros_like(col.data, dtype=torch.bool)
            at[:, i:i + span] = sel
            data = torch.where(at, b, data)
        return Column(data.to(torch.uint8), dt.STRING, col.validity,
                      col.lengths)
    o = old if isinstance(old, str) else old.decode("utf-8", "surrogateescape")
    w = new if isinstance(new, str) else new.decode("utf-8", "surrogateescape")
    return Column.from_strings(
        [None if v is None else v.replace(o, w) for v in col.to_pylist()],
        device=col.data.device)


def _extract_token(data, lengths, validity, delim_byte: int,
                   token_index) -> Column:
    """The k-th ``delim_byte``-separated token of each row (``split_get``
    and ``lists.split_explode``); ``token_index`` is an int or a per-row
    tensor. A token past the last is the empty string."""
    pad_w = data.shape[1]
    in_str = _cols(pad_w, data.device) < lengths[:, None]
    is_delim = (data == delim_byte) & in_str
    d = is_delim.to(torch.int32)
    field = torch.cumsum(d, dim=1) - d
    idx = (token_index[:, None] if isinstance(token_index, torch.Tensor)
           else token_index)
    keep = in_str & ~is_delim & (field == idx)
    has, first = _first(keep)
    start = torch.where(has, first, 0).to(torch.int32)
    return _shift_left(Column(data, dt.STRING, validity, lengths), start,
                       keep.sum(dim=1).to(torch.int32))


def split_get(col: Column, delimiter: Union[str, bytes],
              index: int) -> Column:
    """The 0-based ``index``-th field after splitting on a one-byte
    delimiter (Spark ``split(...)[i]``); the empty string past the
    last."""
    _require_string(col)
    d = _literal_bytes(delimiter)
    if len(d) != 1:
        raise ValueError("split_get: single-byte delimiter only")
    return _extract_token(col.data, col.lengths, col.validity, d[0], index)


def reverse(col: Column) -> Column:
    """Byte-wise reversal (Spark ``reverse``; exact for ASCII)."""
    _require_string(col)
    pad_w = col.data.shape[1]
    j = _cols(pad_w, col.data.device)
    src = (col.lengths[:, None] - 1 - j).clamp(0, pad_w - 1).to(torch.int64)
    out = torch.where(j < col.lengths[:, None],
                      torch.gather(col.data, 1, src), 0).to(torch.uint8)
    return Column(out, dt.STRING, col.validity, col.lengths)


# character classes (cudf ``all_characters_of_type``)


def _between(m, lo: str, hi: str):
    return (m >= ord(lo)) & (m <= ord(hi))


def _char_class_pred(col: Column, in_class) -> Column:
    """True where every byte of the non-empty string is in the class
    (an empty string is False, as in cudf and Python)."""
    _require_string(col)
    ok = ((~_in_str(col) | in_class(col.data)).all(dim=1)
          & (col.lengths > 0))
    return Column(ok, dt.BOOL8, col.validity)


def is_digit(col: Column) -> Column:
    return _char_class_pred(col, lambda m: _between(m, "0", "9"))


def is_alpha(col: Column) -> Column:
    return _char_class_pred(
        col, lambda m: _between(m, "a", "z") | _between(m, "A", "Z"))


def is_alnum(col: Column) -> Column:
    return _char_class_pred(
        col, lambda m: (_between(m, "a", "z") | _between(m, "A", "Z")
                        | _between(m, "0", "9")))


def is_space(col: Column) -> Column:
    return _char_class_pred(col, lambda m: (m == ord(" ")) | ((m >= 9)
                                                              & (m <= 13)))


def _case_pred(col: Column, want_upper: bool) -> Column:
    _require_string(col)
    in_str = _in_str(col)
    low = _between(col.data, "a", "z") & in_str
    up = _between(col.data, "A", "Z") & in_str
    if want_upper:
        ok = ~low.any(dim=1) & up.any(dim=1)
    else:
        ok = ~up.any(dim=1) & low.any(dim=1)
    return Column(ok, dt.BOOL8, col.validity)


def is_upper(col: Column) -> Column:
    """No lower-case letter and at least one upper-case (cudf
    ``isUpper``)."""
    return _case_pred(col, True)


def is_lower(col: Column) -> Column:
    """No upper-case letter and at least one lower-case (cudf
    ``isLower``)."""
    return _case_pred(col, False)


def zfill(col: Column, width: int) -> Column:
    """Left-pad with '0' to ``width`` bytes after a leading +/- sign
    (Python ``str.zfill``); longer strings are unchanged."""
    _require_string(col)
    out_pad = max(col.data.shape[1], width)
    c = repad(col, out_pad)
    j = _cols(out_pad, c.data.device)
    first = c.data[:, 0]
    has_sign = ((first == ord("+")) | (first == ord("-"))) & (c.lengths > 0)
    shift = (width - c.lengths).clamp(min=0)[:, None]
    new_len = c.lengths.clamp(min=width)
    sign = has_sign.to(torch.int32)[:, None]
    src = (j - shift).clamp(0, out_pad - 1).to(torch.int64)
    data = torch.where((j >= sign) & (j < sign + shift), ord("0"),
                       torch.gather(c.data, 1, src))
    data[:, 0] = torch.where(has_sign, first, data[:, 0])
    data = torch.where(j < new_len[:, None], data, 0).to(torch.uint8)
    return Column(data, dt.STRING, col.validity, new_len.to(torch.int32))


def capitalize(col: Column) -> Column:
    """First byte upper-cased, the rest lower-cased (cudf
    ``capitalize``)."""
    _require_string(col)
    data = _case_map(col, False).data.clone()
    first = data[:, 0]
    data[:, 0] = torch.where(_between(first, "a", "z"), first - 32, first)
    return Column(data, dt.STRING, col.validity, col.lengths)


def title(col: Column) -> Column:
    """Every letter after a non-letter upper-cased, the rest lower-cased
    (cudf ``title``)."""
    _require_string(col)
    low = _case_map(col, False).data
    letter = _between(low, "a", "z") | _between(low, "A", "Z")
    prev = torch.zeros_like(letter)
    prev[:, 1:] = letter[:, :-1]
    start = letter & ~prev & _between(low, "a", "z")
    data = torch.where(start, low - 32, low).to(torch.uint8)
    return Column(data, dt.STRING, col.validity, col.lengths)


# URL encoding (cudf ``url_encode``/``url_decode``)

_HEX_UPPER = b"0123456789ABCDEF"


def _hex_val(m: torch.Tensor) -> torch.Tensor:
    """Each byte's hex digit value (garbage for a non-hex byte)."""
    m = m.to(torch.int32)
    out = torch.where(_between(m, "a", "f"), m - ord("a") + 10, m - ord("0"))
    return torch.where(_between(m, "A", "F"), m - ord("A") + 10, out)


def _compact_bytes(values: torch.Tensor, keep: torch.Tensor):
    """The kept bytes of each row moved to its front (each to its rank,
    the rest into one dropped column): ((n, pad) uint8 zero past the new
    lengths, (n,) int32 lengths)."""
    n, pad_w = values.shape
    k = keep.to(torch.int32)
    new_len = k.sum(dim=1).to(torch.int32)
    idx = torch.where(keep, torch.cumsum(k, dim=1) - 1, pad_w)
    out = torch.zeros((n, pad_w + 1), dtype=torch.uint8, device=values.device)
    out.scatter_(1, idx.to(torch.int64),
                 torch.where(keep, values, 0).to(torch.uint8))
    data = torch.where(_cols(pad_w, values.device) < new_len[:, None],
                       out[:, :pad_w], 0).to(torch.uint8)
    return data, new_len


def _shifted(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """``x`` moved ``k`` columns (left for k > 0, right for k < 0), the
    columns moved in set to ``fill``."""
    out = torch.full_like(x, fill)
    if k > 0:
        out[:, :-k] = x[:, k:]
    else:
        out[:, -k:] = x[:, :k]
    return out


def url_decode(col: Column) -> Column:
    """Percent-decoding: ``%XX`` -> its byte, ``+`` -> space (cudf
    ``url_decode``, java.net.URLDecoder); a malformed escape passes
    through as it is."""
    _require_string(col)
    m = col.data
    j = _cols(m.shape[1], m.device)
    in_str = _in_str(col)
    is_hex = (_between(m, "0", "9") | _between(m, "A", "F")
              | _between(m, "a", "f"))
    esc = ((m == ord("%")) & _shifted(is_hex, 1, False)
           & _shifted(is_hex, 2, False) & ((j + 2) < col.lengths[:, None])
           & in_str)
    decoded = (_hex_val(torch.roll(m, -1, dims=1)) * 16
               + _hex_val(torch.roll(m, -2, dims=1))).to(torch.uint8)
    emits = in_str & ~_shifted(esc, -1, False) & ~_shifted(esc, -2, False)
    out_val = torch.where(esc, decoded,
                          torch.where(m == ord("+"), ord(" "), m))
    data, new_len = _compact_bytes(out_val, emits)
    return Column(data, dt.STRING, col.validity, new_len)


def url_encode(col: Column) -> Column:
    """Percent-encoding: unreserved bytes (alnum and ``-_.~``) pass, every
    other byte becomes ``%XX`` (upper-case hex), space included (cudf
    ``url_encode``). The result's pad is read on the host (one sync, as
    the JAX package's eager call)."""
    _require_string(col)
    n, pad_w = col.data.shape
    m = col.data
    dev = m.device
    in_str = _in_str(col)
    unreserved = (_between(m, "a", "z") | _between(m, "A", "Z")
                  | _between(m, "0", "9") | (m == ord("-")) | (m == ord("_"))
                  | (m == ord(".")) | (m == ord("~")))
    widths = torch.where(in_str, torch.where(unreserved, 1, 3), 0)
    ends = torch.cumsum(widths, dim=1)
    starts = ends - widths
    new_len = ends[:, -1].to(torch.int32)
    if n == 0:
        return Column(col.data, dt.STRING, col.validity, col.lengths)
    pad_out = max(int(new_len.max()), 1)
    hexv = const(tuple(_HEX_UPPER), torch.uint8, dev)
    out = torch.zeros((n, pad_out + 1), dtype=torch.uint8, device=dev)
    esc = in_str & ~unreserved
    mi = m.to(torch.int64)
    for at, val, where in (
            (starts, torch.where(unreserved, m, ord("%")), in_str),
            (starts + 1, hexv[mi >> 4], esc),
            (starts + 2, hexv[mi & 0xF], esc)):
        idx = torch.where(where, at.clamp(max=pad_out), pad_out)
        out.scatter_(1, idx.to(torch.int64),
                     torch.where(where, val, 0).to(torch.uint8))
    data = torch.where(_cols(pad_out, dev) < new_len[:, None],
                       out[:, :pad_out], 0).to(torch.uint8)
    return Column(data, dt.STRING, col.validity, new_len)


def concat_ws(sep: Union[str, bytes], *cols: Column) -> Column:
    """Separator-joined rowwise concatenation (Spark ``concat_ws``): null
    inputs are skipped, and the result is never null (a row whose inputs
    are all null is the empty string)."""
    if not cols:
        raise ValueError("concat_ws needs at least one column")
    for c in cols:
        _require_string(c)
    sep_b = _literal_bytes(sep)
    n = cols[0].data.shape[0]
    dev = cols[0].data.device
    sep_data = const(tuple(sep_b.ljust(max(len(sep_b), 1), b"\0")),
                     torch.uint8, dev).expand(n, -1)
    out = None
    started = None  # a piece was emitted before
    for c in cols:
        have = compute.valid_mask(c)
        lens = torch.where(have, c.lengths, 0).to(torch.int32)
        data = c.data
        if c.validity is not None:
            # a null row's bytes past its zeroed length go
            data = torch.where(_cols(data.shape[1], dev) < lens[:, None],
                               data, 0).to(torch.uint8)
        piece = Column(data, dt.STRING, None, lens)
        if out is None:
            out, started = piece, have
            continue
        sep_lens = torch.where(started & have, len(sep_b), 0).to(torch.int32)
        out = concat(concat(out, Column(sep_data, dt.STRING, None,
                                        sep_lens)), piece)
        started = started | have
    return Column(out.data, dt.STRING, None, out.lengths)


def substring_column(col: Column, starts: Column, lengths: Column) -> Column:
    """Per-row substring with 0-based start and length columns (cudf
    ``slice_strings`` with column offsets); out-of-range starts clamp, a
    null start or length gives null."""
    _require_string(col)
    s = torch.minimum(starts.data.to(torch.int32).clamp(min=0), col.lengths)
    want = lengths.data.to(torch.int32).clamp(min=0)
    out = _shift_left(col, s, torch.minimum(want, col.lengths - s))
    return Column(out.data, dt.STRING,
                  compute.merge_validity(col, starts, lengths), out.lengths)


def translate(col: Column, from_chars: Union[str, bytes],
              to_chars: Union[str, bytes]) -> Column:
    """Per-byte mapping (Spark ``translate``): byte ``from_chars[i]``
    becomes ``to_chars[i]``, and a byte of ``from_chars`` past
    ``len(to_chars)`` is deleted (the first occurrence of a byte
    decides)."""
    _require_string(col)
    for name, s in (("from_chars", from_chars), ("to_chars", to_chars)):
        if isinstance(s, str) and not s.isascii():
            raise ValueError(
                f"translate: {name} must be ASCII (byte-level op; "
                "multi-byte UTF-8 chars would corrupt unrelated bytes)")
    f, t = _literal_bytes(from_chars), _literal_bytes(to_chars)
    lut = list(range(256))  # -1 deletes
    seen = set()
    for i, ch in enumerate(f):
        if ch not in seen:
            seen.add(ch)
            lut[ch] = t[i] if i < len(t) else -1
    dev = col.data.device
    mapped = const(tuple(lut), torch.int32, dev)[col.data.to(torch.int64)]
    in_str = _in_str(col)
    if min(lut) >= 0:
        data = torch.where(in_str, mapped, 0).to(torch.uint8)
        return Column(data, dt.STRING, col.validity, col.lengths)
    data, new_len = _compact_bytes(mapped, in_str & (mapped >= 0))
    return Column(data, dt.STRING, col.validity, new_len)
