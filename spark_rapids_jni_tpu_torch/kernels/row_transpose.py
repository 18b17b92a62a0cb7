"""Packed-row transpose: kernels K1a (pack) and K1b (unpack), plus their
plain versions (port of ``kernels/row_transpose.py``).

Columns are ``(n, w_i)`` uint8 little-endian byte matrices
(``t.view(torch.uint8)`` of a column costs nothing) and ``layout`` is a
``rows.RowLayout``. ``pack_rows_columns``/``unpack_rows_columns`` are the
kernels' own form: one ``(n,)`` bool validity vector a column (None: no
nulls) and per-column null counts, as ``rows.py`` keeps them.
``pack_rows``/``unpack_rows`` keep the JAX package's argument layout, an
``(n, num_cols)`` uint8 0/1 validity matrix, which they split or stack
around the same kernels. The CUDA kernels live in
``csrc/row_transpose.cu``: a tile transpose staged in shared memory, a
block a tile of up to 512 rows, every access to device memory coalesced
(design notes there).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import (
    check_status, library, ptr, register, require_cuda, stream_of,
)

PACK = register(
    "pack_rows", "spark_rapids_jni_tpu_torch/csrc/row_transpose.cu",
    "spark_rapids_jni_tpu/kernels/row_transpose.py:149",
)
UNPACK = register(
    "unpack_rows", "spark_rapids_jni_tpu_torch/csrc/row_transpose.cu",
    "spark_rapids_jni_tpu/kernels/row_transpose.py:219",
)

#: the kernels' parameter block holds this many column slots
MAX_COLS = 128

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_U64S = ctypes.POINTER(ctypes.c_uint64)
# host arrays: column pointers, offsets, widths
_LAYOUT_ARGS = (_U64S, ctypes.POINTER(_I), ctypes.POINTER(_I))
_DECLARED = False


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = library("row_transpose")
    if not _DECLARED:
        lib.srt_error_string.argtypes = [_I]
        lib.srt_error_string.restype = ctypes.c_char_p
        lib.srt_pack_rows.argtypes = [
            *_LAYOUT_ARGS, _I, _U64S, _P, _I64, _I, _I, _I, _P,
        ]
        lib.srt_pack_rows.restype = _I
        lib.srt_unpack_rows.argtypes = [
            *_LAYOUT_ARGS, _I, _P, _U64S, _P, _I64, _I, _I, _P,
        ]
        lib.srt_unpack_rows.restype = _I
        _DECLARED = True
    return lib


_BIT_WEIGHTS = [1, 2, 4, 8, 16, 32, 64, 128]


def pack_rows_plain(col_bytes: Sequence[torch.Tensor], valid: torch.Tensor,
                    layout) -> torch.Tensor:
    """Reference for K1a: (n, w_i) byte matrices + (n, cols) 0/1 validity
    -> (n, row_size) packed rows."""
    n = valid.shape[0]
    dev = valid.device
    out = torch.zeros((n, layout.row_size), dtype=torch.uint8, device=dev)
    for b, off, w in zip(col_bytes, layout.column_offsets,
                         layout.column_widths):
        out[:, off:off + w] = b
    cols = len(layout.column_widths)
    vb = layout.validity_bytes
    bits = torch.zeros((n, vb * 8), dtype=torch.int32, device=dev)
    bits[:, :cols] = (valid != 0).to(torch.int32)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=dev)
    packed = (bits.reshape(n, vb, 8) * weights).sum(-1).to(torch.uint8)
    vo = layout.validity_offset
    out[:, vo:vo + vb] = packed
    return out


def unpack_rows_plain(rows: torch.Tensor, layout):
    """Reference for K1b: (n, row_size) rows -> ([(n, w_i) uint8],
    (n, cols) 0/1 uint8)."""
    n = rows.shape[0]
    cols = [rows[:, off:off + w].contiguous()
            for off, w in zip(layout.column_offsets, layout.column_widths)]
    vo, vb = layout.validity_offset, layout.validity_bytes
    vbytes = rows[:, vo:vo + vb].to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=rows.device)
    bits = (vbytes.unsqueeze(-1) >> shifts) & 1
    num_cols = len(layout.column_widths)
    valid = bits.reshape(n, vb * 8)[:, :num_cols].to(torch.uint8)
    return cols, valid.contiguous()


def _validity_matrix(validities: Sequence, n: int,
                    device) -> torch.Tensor:
    """One validity vector a column (None: all valid) -> the (n, cols)
    uint8 0/1 matrix of the JAX contract."""
    return torch.stack(
        [torch.ones(n, dtype=torch.bool, device=device) if v is None else v
         for v in validities], dim=1,
    ).to(torch.uint8)


def pack_rows_columns_plain(col_bytes: Sequence[torch.Tensor],
                            validities: Sequence, layout) -> torch.Tensor:
    """Reference for K1a with one validity vector a column."""
    n = col_bytes[0].shape[0]
    return pack_rows_plain(
        col_bytes, _validity_matrix(validities, n, col_bytes[0].device), layout)


def unpack_rows_columns_plain(rows: torch.Tensor, layout):
    """Reference for K1b into one validity vector a column: ([(n, w_i)
    uint8 ...], [(n,) bool ...], (cols,) int32 null counts)."""
    cols, valid = unpack_rows_plain(rows, layout)
    valid = valid != 0
    validities = [valid[:, i].contiguous() for i in range(valid.shape[1])]
    return cols, validities, (~valid).sum(0, dtype=torch.int32)


@functools.lru_cache(maxsize=256)
def _layout_arrays(offsets: tuple, widths: tuple):
    """The C entries' host arrays of column offsets and widths (kept a
    layout: they are read, never written)."""
    k = len(widths)
    if not 1 <= k <= MAX_COLS:
        raise ValueError(f"row kernels take 1..{MAX_COLS} columns, got {k}")
    return (ctypes.c_int * k)(*offsets), (ctypes.c_int * k)(*widths)


def _pointers(addresses) -> ctypes.Array:
    addresses = list(addresses)
    return (ctypes.c_uint64 * len(addresses))(*addresses)


def _check_aligned(t: torch.Tensor, w: int, name: str) -> None:
    if t.data_ptr() % min(w, 8):
        raise ValueError(f"{name} is not aligned to {min(w, 8)} bytes")


def _pack_cuda(col_bytes, validities, layout) -> torch.Tensor:
    n = col_bytes[0].shape[0]
    for i, (b, w) in enumerate(zip(col_bytes, layout.column_widths)):
        require_cuda(b, f"col_bytes[{i}]", torch.uint8, (n, w))
        _check_aligned(b, w, f"col_bytes[{i}]")
    for i, v in enumerate(validities):
        if v is not None:
            if v.dtype not in (torch.bool, torch.uint8):
                raise TypeError(f"validities[{i}] must be bool or uint8")
            require_cuda(v, f"validities[{i}]", v.dtype, (n,))
    out = torch.empty((n, layout.row_size), dtype=torch.uint8,
                      device=col_bytes[0].device)
    if n == 0:
        return out
    offs, widths = _layout_arrays(layout.column_offsets, layout.column_widths)
    lib = _lib()
    rc = lib.srt_pack_rows(
        _pointers(b.data_ptr() for b in col_bytes), offs, widths,
        len(col_bytes),
        _pointers(0 if v is None else v.data_ptr() for v in validities),
        ptr(out), n, layout.row_size, layout.validity_offset,
        layout.validity_bytes, stream_of(out),
    )
    check_status(lib, rc, "pack_rows")
    PACK.count()
    return out


def pack_rows_columns(col_bytes: Sequence[torch.Tensor], validities: Sequence,
                      layout) -> torch.Tensor:
    """(n, w_i) uint8 byte matrices + one (n,) bool or 0/1 uint8 validity
    vector a column (None: all valid) -> (n, row_size) packed rows."""
    if not (len(col_bytes) == len(validities) == len(layout.column_widths)):
        raise ValueError("one byte matrix and one validity per layout "
                         "column expected")
    if col_bytes[0].device.type == "cpu":
        return pack_rows_columns_plain(col_bytes, validities, layout)
    return _pack_cuda(col_bytes, validities, layout)


def pack_rows(col_bytes: Sequence[torch.Tensor], valid: torch.Tensor,
              layout) -> torch.Tensor:
    """(n, w_i) uint8 byte matrices + (n, num_cols) 0/1 validity ->
    (n, row_size) packed rows."""
    if len(col_bytes) != len(layout.column_widths):
        raise ValueError("one byte matrix per layout column expected")
    if valid.device.type == "cpu":
        return pack_rows_plain(col_bytes, valid, layout)
    require_cuda(valid, "valid", torch.uint8,
                 (valid.shape[0], len(layout.column_widths)))
    return _pack_cuda(col_bytes, list(valid.t().contiguous()), layout)


def _unpack_cuda(rows, layout):
    """K1b: ([(n, w_i) uint8 ...], (cols, n) bool validity, (cols,) int32
    null counts)."""
    n = rows.shape[0]
    require_cuda(rows, "rows", torch.uint8, (n, layout.row_size))
    _check_aligned(rows, 8, "rows")
    widths = layout.column_widths
    k = len(widths)
    # one allocation a call: every column, then the (cols, n) validity,
    # then the null counts, each starting on 16 bytes
    starts, end = [], 0
    for size in [n * w for w in widths] + [k * n, 4 * k]:
        starts.append(end)
        end += -(-size // 16) * 16
    buf = torch.empty(end, dtype=torch.uint8, device=rows.device)
    cols = [buf[s:s + n * w].view(n, w) for s, w in zip(starts, widths)]
    valid = buf[starts[k]:starts[k] + k * n].view(torch.bool).view(k, n)
    nulls = buf[starts[k + 1]:starts[k + 1] + 4 * k].view(torch.int32)
    if n == 0:
        return cols, valid, nulls.zero_()
    offs, cwidths = _layout_arrays(layout.column_offsets, widths)
    vbase = valid.data_ptr()
    lib = _lib()
    rc = lib.srt_unpack_rows(  # zeroes nulls, then counts
        _pointers(c.data_ptr() for c in cols), offs, cwidths, k, ptr(rows),
        _pointers(range(vbase, vbase + k * n, n)), ptr(nulls), n,
        layout.row_size, layout.validity_offset, stream_of(rows),
    )
    check_status(lib, rc, "unpack_rows")
    UNPACK.count()
    return cols, valid, nulls


def unpack_rows_columns(rows: torch.Tensor, layout):
    """(n, row_size) packed rows -> ([(n, w_i) uint8 ...], [(n,) bool
    validity a column], (cols,) int32 null counts)."""
    if rows.device.type == "cpu":
        return unpack_rows_columns_plain(rows, layout)
    cols, valid, nulls = _unpack_cuda(rows, layout)
    return cols, list(valid), nulls


def unpack_rows(rows: torch.Tensor, layout):
    """(n, row_size) packed rows -> ([(n, w_i) uint8 ...], (n, cols) 0/1
    uint8)."""
    if rows.device.type == "cpu":
        return unpack_rows_plain(rows, layout)
    cols, valid, _ = _unpack_cuda(rows, layout)
    return cols, valid.t().contiguous().view(torch.uint8)
