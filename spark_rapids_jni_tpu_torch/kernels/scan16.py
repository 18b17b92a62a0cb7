"""FLOAT64 inclusive scan in XLA's CPU add order: the scan16 kernel and
its plain version.

The JAX package's FLOAT64 segment sums are cumsum differences, and
``jnp.cumsum`` on its CPU path is XLA's recursive base-16 scan
(``ops/groupby.py`` ``_scan_sum16`` is the plain torch copy of that
order, about 90 launches at 2^23 rows). The CUDA kernel in
``csrc/scan16.cu`` computes the same sums in the same order, bit for
bit, in one launch at any length (after one memset of its flags from two
tiles on): tiles of 4096 elements (three whole levels of the recursion)
in shared memory, each tile taking the scan of the tile totals before it
from totals its predecessors publish (design notes there).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import check_status, library, ptr, register, require_cuda, stream_of

SCAN16 = register(
    "scan16", "spark_rapids_jni_tpu_torch/csrc/scan16.cu",
    "spark_rapids_jni_tpu/ops/groupby.py:164",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_DECLARED = False


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = library("scan16")
    if not _DECLARED:
        lib.srt_error_string.argtypes = [ctypes.c_int]
        lib.srt_error_string.restype = ctypes.c_char_p
        lib.srt_scan16_scratch_bytes.argtypes = [_I64]
        lib.srt_scan16_scratch_bytes.restype = _I64
        lib.srt_scan16.argtypes = [_P, _I64, _P, _I64, _P, _P]
        lib.srt_scan16.restype = ctypes.c_int
        _DECLARED = True
    return lib


def scan_sum16_plain(v: torch.Tensor, rows: Optional[int] = None):
    """The plain version: ``ops/groupby.py``'s ``_scan_sum16``."""
    from ..ops.groupby import _scan_sum16

    return _scan_sum16(v, rows)


def _scan_cuda(v: torch.Tensor) -> torch.Tensor:
    """One launch: the flags and published totals live in a scratch
    buffer the kernel's C entry clears (one memset) before it."""
    lib = _lib()
    n = v.shape[0]
    size = lib.srt_scan16_scratch_bytes(n)
    if size < 0:
        raise ValueError(f"scan16: {n} elements are past the kernel's levels")
    scratch = torch.empty(max(size, 8), dtype=torch.uint8, device=v.device)
    out = torch.empty_like(v)
    rc = lib.srt_scan16(ptr(v), n, ptr(scratch), size, ptr(out), stream_of(v))
    check_status(lib, rc, "scan16")
    return out


def scan_sum16(v: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """Inclusive cumsum of a 1-D float64 vector in XLA's CPU order (see
    ``ops/groupby.py`` ``_scan_sum16`` for ``rows``): the plain version
    for a CPU tensor, the kernel for a CUDA one."""
    if v.device.type == "cpu":
        return scan_sum16_plain(v, rows)
    if not v.is_cuda:
        raise ValueError(f"v must be a CUDA tensor, got {v.device}")
    n = v.shape[0]
    if (n if rows is None else rows) < 2 or n == 0:
        return v.clone()
    v = v.contiguous()
    require_cuda(v, "v", torch.float64, (n,))
    out = _scan_cuda(v)
    SCAN16.count()
    return out
