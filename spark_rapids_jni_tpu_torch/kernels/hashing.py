"""Spark Murmur3 table hash: kernel K5 and its plain version (port of
``kernels/hashing.py``).

Spark's ``Murmur3_x86_32`` chained left to right over fixed-width key
columns, seed 42, a null row leaving the running hash unchanged — the
hash of ``HashPartitioning``. The word rules are the JAX package's
``_column_words``: the int family hashes one u32 word (the value widened
to int32), FLOAT32 its bits with -0.0 made +0.0, the long family two u32
words (low, high) of the value widened to int64, FLOAT64 its bits with
-0.0 made +0.0.

The plain version is the port's only torch copy of the arithmetic: u32
values ride in int64 masked to 32 bits, products in 16-bit halves
(``hash_table.mul32``). The CUDA kernel lives in ``csrc/murmur3.cu``
(design notes there).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import dtype as dt
from ..column import Column
from . import check_status, library, register, stream_of
from .hash_table import mul32

DEFAULT_SEED = 42
#: the kernel's descriptor block holds this many key columns
MAX_COLS = 32

MURMUR3 = register(
    "murmur3_table_fused", "spark_rapids_jni_tpu_torch/csrc/murmur3.cu",
    "spark_rapids_jni_tpu/kernels/hashing.py:158",
)

_M32 = 0xFFFFFFFF
_SIGN64 = -(2**63)

_INT_IDS = frozenset({
    dt.TypeId.INT8, dt.TypeId.INT16, dt.TypeId.INT32, dt.TypeId.UINT8,
    dt.TypeId.UINT16, dt.TypeId.UINT32, dt.TypeId.TIMESTAMP_DAYS,
    dt.TypeId.DURATION_DAYS, dt.TypeId.DICTIONARY32, dt.TypeId.BOOL8,
})
# the kernel's HashKind codes
_KINDS = {"int": 0, "float32": 1, "long": 2, "float64": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_DECLARED = False


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = library("murmur3")
    if not _DECLARED:
        lib.srt_error_string.argtypes = [_I]
        lib.srt_error_string.restype = ctypes.c_char_p
        arr = ctypes.POINTER
        lib.srt_murmur3_table.argtypes = [
            arr(ctypes.c_uint64), arr(ctypes.c_uint64), arr(_I), arr(_I),
            arr(_I), _I, ctypes.c_uint32, _P, ctypes.c_int64, _P,
        ]
        lib.srt_murmur3_table.restype = _I
        _DECLARED = True
    return lib


def column_kind(d: dt.DType) -> str:
    """"int", "float32", "long" or "float64": how a key column hashes."""
    if not d.is_fixed_width or d.id == dt.TypeId.DECIMAL128:
        raise TypeError(f"{d!r} has no Murmur3 word rule in the kernel")
    if d.id == dt.TypeId.FLOAT32:
        return "float32"
    if d.id == dt.TypeId.FLOAT64:
        return "float64"
    return "int" if d.id in _INT_IDS else "long"


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return mul32(_rotl(mul32(k1, 0xCC9E2D51), 15), 0x1B873593)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    return (_rotl(h1 ^ k1, 13) * 5 + 0xE6546B64) & _M32


def _fmix(h1: torch.Tensor, length: int) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _column_words(col: Column) -> list:
    """The column's u32 words (int64 tensors in [0, 2^32))."""
    kind = column_kind(col.dtype)
    data = col.data
    if kind == "float32":
        bits = data.view(torch.int32).to(torch.int64) & _M32
        return [torch.where(data == 0, 0, bits)]
    if kind == "int":
        return [data.to(torch.int64) & _M32]
    if kind == "float64":
        x = torch.where(data == _SIGN64, 0, data)
    elif data.dtype == torch.uint64:
        x = data.view(torch.int64)
    else:
        x = data.to(torch.int64)
    return [x & _M32, (x >> 32) & _M32]


def chain_plain(col: Column, h: torch.Tensor) -> torch.Tensor:
    """The running hash ``h`` (int64 holding u32) updated by one
    fixed-width key column; null rows keep ``h``."""
    words = _column_words(col)
    nxt = h
    for w in words:
        nxt = _mix_h1(nxt, _mix_k1(w))
    nxt = _fmix(nxt, 4 * len(words))
    return nxt if col.validity is None else torch.where(col.validity, nxt, h)


def murmur3_plain(cols: Sequence[Column], seed: int = DEFAULT_SEED):
    """Reference for K5: the chained hash of ``cols`` as an (n,) int32
    tensor."""
    n = cols[0].row_count
    h = torch.full((n,), seed & _M32, dtype=torch.int64,
                   device=cols[0].data.device)
    for c in cols:
        h = chain_plain(c, h)
    return ((h ^ 2**31) - 2**31).to(torch.int32)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _murmur3_cuda(cols: Sequence[Column], seed: int) -> torch.Tensor:
    k = len(cols)
    if k > MAX_COLS:
        raise ValueError(
            f"murmur3 kernel takes 1..{MAX_COLS} key columns, got {k}")
    n = cols[0].row_count
    dev = cols[0].data.device
    kinds = [_KINDS[column_kind(c.dtype)] for c in cols]
    for i, c in enumerate(cols):
        for name, t in (("data", c.data), ("validity", c.validity)):
            if t is None:
                continue
            if t.device != dev or t.dim() != 1 or t.shape[0] != n:
                raise ValueError(f"key {i} {name}: expected ({n},) on {dev}, "
                                 f"got {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"key {i} {name} must be contiguous")
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    u64s = ctypes.c_uint64 * k
    ints = ctypes.c_int * k
    lib = _lib()
    rc = lib.srt_murmur3_table(
        u64s(*[c.data.data_ptr() for c in cols]),
        u64s(*[0 if c.validity is None else c.validity.data_ptr()
               for c in cols]),
        ints(*[c.data.element_size() for c in cols]),
        ints(*[int(c.data.dtype.is_signed) for c in cols]),
        ints(*kinds), k, ctypes.c_uint32(seed & _M32),
        ctypes.c_void_p(out.data_ptr()), n, stream_of(out),
    )
    check_status(lib, rc, "murmur3_table")
    MURMUR3.count()
    return out


def supports(cols) -> bool:
    """True when every key column has a kernel word format
    (``kernels/hashing.py:169``: STRING keys take the op library's
    chain)."""
    return all(not c.dtype.is_string for c in cols)


def murmur3_columns(cols: Sequence[Column], seed: int = DEFAULT_SEED):
    """The chained Murmur3 of one or more fixed-width key columns, as an
    (n,) int32 tensor on their device."""
    if not cols:
        raise ValueError("murmur3 needs at least one key column")
    dev = cols[0].data.device
    if dev.type == "cpu":
        return murmur3_plain(cols, seed)
    if dev.type != "cuda":
        raise ValueError(f"key columns must be CUDA tensors, got {dev}")
    return _murmur3_cuda(cols, seed)
