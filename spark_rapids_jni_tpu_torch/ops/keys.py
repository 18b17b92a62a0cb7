"""Order-preserving key words (port of ``ops/keys.py``).

The JAX package maps each column to uint64 words whose unsigned order is
the column's order. torch has no unsigned 64-bit comparisons, so the port
carries each word as int64 with the top bit flipped: ``s = u ^ 2**63``.
Signed order of ``s`` equals unsigned order of ``u``, ``~s`` corresponds
to ``~u``, and :func:`to_unsigned_bits` recovers ``u``'s bit pattern
(for the hash table's 32-bit halves). For signed integers the word is
simply the value widened to int64. A STRING column gives pad/8
big-endian words of its zero-padded bytes (memcmp order), then its
length as the tiebreaker word (embedded NULs).

The packed-key helpers (:func:`minmax_host`, :func:`fold_fields`,
:func:`peel_fields`) work on relative words ``carrier - min carrier``,
which equal the u64 words' differences bit for bit.
"""

from __future__ import annotations

import torch

from .. import dtype as dt
from ..column import Column

SIGN64 = -(2**63)  # int64 with only the top bit set; the carrier of u64 0
CARRIER_MAX = 2**63 - 1  # the carrier of the u64 word 0xFFFF...FF
_MASK32 = 0xFFFFFFFF


def _float_order(bits: torch.Tensor, width: int) -> torch.Tensor:
    """IEEE bits (int32/int64) -> the order word as an int64 carrier.

    Unsigned trick: negatives invert all bits, positives set the sign
    bit. In the carrier (top bit flipped once more) that is: negatives
    invert all bits but the sign, positives stay as they are."""
    if width == 64:
        neg = bits < 0
        u = torch.where(neg, ~bits, bits | SIGN64)
        return u ^ SIGN64
    b = bits.to(torch.int64) & _MASK32
    neg = (b >> 31) != 0
    u = torch.where(neg, (~b) & _MASK32, b | (1 << 31))
    return u ^ SIGN64


def column_order_keys(col: Column) -> list[torch.Tensor]:
    """int64 carrier word(s) whose signed order == the column's order."""
    d = col.dtype
    data = col.data
    if d.is_string:
        return _string_order_keys(col)
    if d.id == dt.TypeId.LIST:
        raise TypeError("LIST columns have no order keys")
    if d.id == dt.TypeId.DECIMAL128:
        # (n, 2) limbs: the sign-flipped hi word then the lo word (the
        # 128-bit instance of the signed sign-flip rule), as carriers
        from .int128 import order_key_words

        return [w ^ SIGN64 for w in order_key_words(data)]
    if d.id == dt.TypeId.FLOAT64:
        return [_float_order(data, 64)]
    if d.id == dt.TypeId.FLOAT32:
        return [_float_order(data.view(torch.int32), 32)]
    if d.is_boolean:
        return [data.to(torch.int64) ^ SIGN64]
    if d.id == dt.TypeId.UINT64:
        return [data.view(torch.int64) ^ SIGN64]
    if d.is_unsigned:
        return [data.to(torch.int64) ^ SIGN64]
    # signed ints, decimals, timestamps, durations: the widened value IS
    # the carrier (u = widened ^ 2**63, s = u ^ 2**63)
    return [data.to(torch.int64)]


def _string_order_keys(col: Column) -> list[torch.Tensor]:
    """pad/8 words of 8 bytes each, big-endian (so signed carrier order
    is memcmp order), then the length word."""
    mat = col.data
    n, pad = mat.shape
    nwords = (pad + 7) // 8
    if pad != 8 * nwords:
        mat = torch.nn.functional.pad(mat, (0, 8 * nwords - pad))
    # bytes reversed within each word, read as little-endian int64
    words = (mat.reshape(n, nwords, 8).flip(2).contiguous()
             .view(torch.int64).reshape(n, nwords).T.contiguous())
    out = [w ^ SIGN64 for w in words]
    out.append(col.lengths.to(torch.int64) ^ SIGN64)
    return out


def to_unsigned_bits(word: torch.Tensor) -> torch.Tensor:
    """Carrier word -> the int64 tensor holding the uint64 word's bits."""
    return word ^ SIGN64


def split_u32(word: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Carrier word -> (lo, hi) 32-bit halves of the uint64 word, each as
    an int32 tensor holding the u32 bit pattern."""
    u = to_unsigned_bits(word)
    lo = (u & _MASK32).to(torch.int32)
    hi = ((u >> 32) & _MASK32).to(torch.int32)
    return lo, hi


def table_order_keys(cols: list[Column]) -> list[torch.Tensor]:
    out = []
    for c in cols:
        out.extend(column_order_keys(c))
    return out


def composite_compare_le(a_keys: list[torch.Tensor], a_idx,
                         b_keys: list[torch.Tensor], b_idx) -> torch.Tensor:
    """Lexicographic ``a[a_idx] <= b[b_idx]`` over parallel carrier key
    lists (signed carrier order is the u64 words' order)."""
    shape = torch.as_tensor(a_idx).shape
    dev = a_keys[0].device
    lt = torch.zeros(shape, dtype=torch.bool, device=dev)
    eq = torch.ones(shape, dtype=torch.bool, device=dev)
    for ak, bk in zip(a_keys, b_keys):
        av, bv = ak[a_idx], bk[b_idx]
        lt = lt | (eq & (av < bv))
        eq = eq & (av == bv)
    return lt | eq


def rows_equal(a_keys: list[torch.Tensor], a_idx,
               b_keys: list[torch.Tensor], b_idx) -> torch.Tensor:
    """Row ``a[a_idx]`` equals row ``b[b_idx]`` in every key word."""
    eq = torch.ones(torch.as_tensor(a_idx).shape, dtype=torch.bool,
                    device=a_keys[0].device)
    for ak, bk in zip(a_keys, b_keys):
        eq = eq & (ak[a_idx] == bk[b_idx])
    return eq


def minmax_host(kw: torch.Tensor) -> tuple[int, int]:
    """Host (int, int) min/max of a carrier word — the eager range probe
    of the packed-key routers. ``hi - lo`` of the two carriers is the span
    of the u64 words: the top-bit flip adds the same 2^63 to both."""
    lo, hi = torch.aminmax(kw)
    return int(lo), int(hi)


def fold_fields(rels, field_bits) -> torch.Tensor:
    """Pack parallel relative-key words (u64 bits in int64) as bit fields
    of ONE word, first field in the high bits: lexicographic order of the
    tuple == unsigned order of the composite. Callers validate that each
    rel fits its declared width."""
    out = torch.zeros_like(rels[0])
    for r, b in zip(rels, field_bits):
        out = (out << b) | r
    return out


def peel_fields(word: torch.Tensor, field_bits) -> list[torch.Tensor]:
    """Inverse of :func:`fold_fields`: the per-key relative fields. The
    mask after each shift drops the bits an arithmetic ``>>`` copies in
    from the top."""
    shift = 0
    fields = []
    for b in reversed(field_bits):
        fields.append((word >> shift) & ((1 << b) - 1))
        shift += b
    fields.reverse()
    return fields
