"""UTF-8-aware string ops (port of ``ops/strings_utf8.py``): character
length and substring, and case mapping over the Basic Multilingual
Plane.

The host builds a 64K-entry case table once from Python's Unicode
database; the device classifies lead bytes, assembles code points,
gathers them through the table and writes the bytes back, each
continuation byte taking its character's mapped code point through a
running maximum of the character starts.

Case mapping covers the 1:1 mappings that keep a character's UTF-8
length (ASCII, Latin-1 and Extended, Greek, Cyrillic, full-width forms);
length-changing mappings (German ß -> SS) and 4-byte characters pass
through unchanged, as do malformed bytes.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column
from .strings import _cols, _in_str, _require_string, _shift_left


def _is_char_start(col: Column) -> torch.Tensor:
    """Bytes that begin a character: all but 0b10xxxxxx."""
    return ((col.data & 0xC0) != 0x80) & _in_str(col)


def char_length(col: Column) -> Column:
    """Character count (Spark ``length``; cudf ``count_characters``)."""
    _require_string(col)
    return Column(_is_char_start(col).sum(dim=1).to(torch.int32), dt.INT32,
                  col.validity)


def utf8_substring(col: Column, start: int,
                   length: Optional[int] = None) -> Column:
    """Character-indexed substring (0-based ``start``; a negative one
    counts from the end). Continuation bytes travel with their
    character, so the kept bytes are one range."""
    _require_string(col)
    is_start = _is_char_start(col).to(torch.int32)
    char_idx = torch.cumsum(is_start, dim=1) - 1
    total = is_start.sum(dim=1)
    s = ((total + start).clamp(min=0) if start < 0
         else torch.full_like(total, start))[:, None]
    keep = _in_str(col) & (char_idx >= s)
    if length is not None:
        keep = keep & (char_idx < s + length)
    first = torch.where(keep.any(dim=1), keep.to(torch.uint8).argmax(dim=1),
                        0).to(torch.int32)
    return _shift_left(col, first, keep.sum(dim=1).to(torch.int32))


@functools.lru_cache(maxsize=4)
def _bmp_case_table(upper: bool) -> np.ndarray:
    """(65536,) int32: code point -> its case mapping, kept only where
    the mapping is 1:1 and keeps the UTF-8 length (so no bytes move)."""

    def u8len(cp: int) -> int:
        return 1 if cp < 0x80 else 2 if cp < 0x800 else 3

    table = np.arange(0x10000, dtype=np.int32)
    for cp in range(0x10000):
        if 0xD800 <= cp <= 0xDFFF:
            continue  # surrogates are not characters
        c = chr(cp)
        mapped = c.upper() if upper else c.lower()
        if len(mapped) == 1:
            mcp = ord(mapped)
            if mcp < 0x10000 and u8len(mcp) == u8len(cp):
                table[cp] = mcp
    return table


@functools.lru_cache(maxsize=8)
def _case_table(upper: bool, device) -> torch.Tensor:
    return torch.from_numpy(_bmp_case_table(upper)).to(device)


def _case_map_utf8(col: Column, upper: bool) -> Column:
    _require_string(col)
    mat = col.data.to(torch.int32)
    pad = mat.shape[1]
    dev = mat.device
    j = _cols(pad, dev)
    in_str = _in_str(col)
    b = torch.where(in_str, mat, 0)
    is1 = (b < 0x80) & in_str
    is2 = (b & 0xE0) == 0xC0
    is3 = (b & 0xF0) == 0xE0
    is4 = (b & 0xF8) == 0xF0

    def nxt(k):
        return torch.where(j + k < pad, torch.roll(b, -k, dims=1), 0) & 0x3F

    cp = torch.where(is1, b, torch.where(
        is2, ((b & 0x1F) << 6) | nxt(1),
        ((b & 0x0F) << 12) | (nxt(1) << 6) | nxt(2)))
    mapped = _case_table(upper, dev)[cp.clamp(0, 0xFFFF).to(torch.int64)]
    # every byte takes its character's start: a running max of the
    # start positions
    start_pos = torch.cummax(torch.where(is1 | is2 | is3 | is4, j, -1),
                             dim=1).values
    safe = start_pos.clamp(0, pad - 1).to(torch.int64)
    my = torch.gather(mapped, 1, safe)
    my_len = torch.gather(torch.where(is1, 1, torch.where(
        is2, 2, torch.where(is3, 3, 4))), 1, safe)
    k = j - safe
    cont = 0x80 | (my & 0x3F)
    out = torch.where(my_len == 1, my, torch.where(
        my_len == 2, torch.where(k == 0, 0xC0 | (my >> 6), cont),
        torch.where(my_len == 3, torch.where(
            k == 0, 0xE0 | (my >> 12),
            torch.where(k == 1, 0x80 | ((my >> 6) & 0x3F), cont)), b)))
    # malformed leads (no start before them) and padding keep their bytes
    out = torch.where((start_pos >= 0) & in_str, out, mat)
    return Column(out.to(torch.uint8), dt.STRING, col.validity, col.lengths)


def utf8_upper(col: Column) -> Column:
    """UTF-8 upper case (cudf ``strings::to_upper``)."""
    return _case_map_utf8(col, True)


def utf8_lower(col: Column) -> Column:
    """UTF-8 lower case."""
    return _case_map_utf8(col, False)
