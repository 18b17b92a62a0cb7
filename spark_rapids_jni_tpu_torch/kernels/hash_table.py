"""Open-addressing hash build/probe: kernels K2a and K2b, plus their plain
versions (port of ``kernels/hash_table.py``).

Keys are u64 order words split into 32-bit halves. torch has no unsigned
32-bit arithmetic on the CPU, so ``lo``/``hi`` and the stored
``table_lo``/``table_hi`` are int32 tensors holding the u32 bit patterns;
the plain versions do their u32 arithmetic in int64, masked to 32 bits.

The CUDA kernels live in ``csrc/hash_table.cu`` (design notes there).
"""

from __future__ import annotations

import ctypes

import torch

from . import (
    check_status, library, ptr, register, require_cuda, stream_of,
)

#: Linear-probe round bound, as in the JAX package.
MAX_PROBES = 64

_M32 = 0xFFFFFFFF

BUILD = register(
    "build_table", "spark_rapids_jni_tpu_torch/csrc/hash_table.cu",
    "spark_rapids_jni_tpu/kernels/hash_table.py:134",
)
PROBE = register(
    "probe_table", "spark_rapids_jni_tpu_torch/csrc/hash_table.cu",
    "spark_rapids_jni_tpu/kernels/hash_table.py:240",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_DECLARED = False


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = library("hash_table")
    if not _DECLARED:
        lib.srt_error_string.argtypes = [_I]
        lib.srt_error_string.restype = ctypes.c_char_p
        lib.srt_build_table.argtypes = [_P] * 8 + [_I64, _I, _I, _I, _P]
        lib.srt_build_table.restype = _I
        lib.srt_build_table_regime.argtypes = [_I, _I]
        lib.srt_build_table_regime.restype = _I
        lib.srt_probe_table.argtypes = [_P] * 9 + [_I64, _I, _I, _I, _P]
        lib.srt_probe_table.restype = _I
        _DECLARED = True
    return lib


def _check_pow2(s: int) -> None:
    if s & (s - 1) or s < 2:
        raise ValueError(f"table_slots must be a power of two, got {s}")


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for u32 ``a`` in int64 and a u32 constant, in
    16-bit halves of ``b`` so no int64 product overflows."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_word(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """fmix32 slot hash of the u64 word (hi << 32 | lo), bit for bit as
    the JAX package's ``hash_word``; u32 values carried in int64."""
    h = lo ^ mul32(hi, 0x9E3779B9)
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).to(torch.int64) & _M32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 -> int32 tensor of the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def build_table_plain(lo, hi, valid, *, table_slots: int,
                      max_probes: int = MAX_PROBES):
    """The JAX package's round loop in torch (reference for K2a)."""
    c, t = lo.shape
    s = int(table_slots)
    _check_pow2(s)
    dev = lo.device
    n, ns = c * t, c * s
    klo, khi = _u32(lo), _u32(hi)
    live = valid.reshape(-1) != 0
    pslot = hash_word(klo, khi) & (s - 1)
    idx = torch.arange(n, device=dev)
    rowid = idx % t
    base = (idx // t) * s
    out_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    tlo = torch.zeros(ns, dtype=torch.int64, device=dev)
    thi = torch.zeros(ns, dtype=torch.int64, device=dev)
    trow = torch.full((ns,), -1, dtype=torch.int64, device=dev)
    dup = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(max_probes):
        if not bool(live.any()):
            break  # later rounds change nothing
        fidx = base + pslot
        cand = live & (trow[fidx] < 0)
        claim = torch.full((ns,), n, dtype=torch.int64, device=dev)
        claim = claim.scatter_reduce(0, fidx[cand], rowid[cand], "amin")
        won = cand & (claim[fidx] == rowid)
        w = fidx[won]
        tlo[w] = klo[won]
        thi[w] = khi[won]
        trow[w] = rowid[won]
        owner = trow[fidx]
        hit = live & (owner >= 0) & (tlo[fidx] == klo) & (thi[fidx] == khi)
        out_slot = torch.where(hit, pslot, out_slot)
        dup = dup + (hit & (owner != rowid)).sum()
        live = live & ~hit
        pslot = torch.where(live, (pslot + 1) & (s - 1), pslot)
    return (
        out_slot.to(torch.int32).reshape(c, t),
        _as_i32(tlo).reshape(c, s),
        _as_i32(thi).reshape(c, s),
        trow.to(torch.int32).reshape(c, s),
        live.sum().to(torch.int32),
        dup.to(torch.int32),
    )


def _build_cuda(lo, hi, valid, s: int, max_probes: int):
    """K2a in one launch (``csrc/hash_table.cu``): a chunk's table in shared
    memory where it fits, else one cooperative launch over the whole
    table. A slot's claim lives in its row word while a round runs and a
    row's probe state in its slot word, so no scratch is allocated; the
    entry zeroes ``counters`` (overflow, dup)."""
    c, t = lo.shape
    require_cuda(lo, "lo", torch.int32)
    require_cuda(hi, "hi", torch.int32, (c, t))
    require_cuda(valid, "valid", torch.int32, (c, t))
    if s * c >= 2**31 or t >= 2**31:
        raise ValueError(f"hash table of {c} x {s} slots exceeds int32 ids")
    dev = lo.device
    slot = torch.empty((c, t), dtype=torch.int32, device=dev)
    tlo = torch.empty((c, s), dtype=torch.int32, device=dev)
    thi = torch.empty((c, s), dtype=torch.int32, device=dev)
    trow = torch.empty((c, s), dtype=torch.int32, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.srt_build_table(
        ptr(lo), ptr(hi), ptr(valid), ptr(slot), ptr(tlo), ptr(thi),
        ptr(trow), ptr(counters), c, t, s, int(max_probes), stream_of(lo),
    )
    check_status(lib, rc, "build_table")
    BUILD.count()
    return slot, tlo, thi, trow, counters[0], counters[1]


def build_regime(rows: int, table_slots: int) -> str:
    """Which K2a kernel a build of ``rows`` rows a chunk into
    ``table_slots`` slots runs on the current CUDA device: ``"chunk"`` (a
    chunk's table in one block's shared memory) or ``"grid"`` (one
    cooperative launch)."""
    lib = _lib()
    rc = lib.srt_build_table_regime(int(rows), int(table_slots))
    if rc < 0:
        check_status(lib, -rc, "build_table_regime")
    return "chunk" if rc else "grid"


def build_table(lo, hi, valid, *, table_slots: int,
                max_probes: int = MAX_PROBES):
    """Build one open-addressing table per chunk.

    ``lo``/``hi``: (C, T) int32 u32 halves; ``valid``: (C, T) int32
    occupancy (0 = null, never inserted). Returns ``(slot (C,T) i32,
    table_lo (C,S), table_hi (C,S), table_row (C,S) i32, overflow,
    dup)`` exactly as the JAX ``build_table``; ``overflow`` and ``dup``
    are 0-d int32 tensors on the input's device.
    """
    s = int(table_slots)
    _check_pow2(s)
    if lo.device.type == "cpu":
        return build_table_plain(lo, hi, valid, table_slots=s,
                                 max_probes=max_probes)
    return _build_cuda(lo, hi, valid, s, max_probes)


def probe_table_plain(lo, hi, valid, table_lo, table_hi, table_row, *,
                      max_probes: int = MAX_PROBES):
    """The JAX package's probe rounds in torch (reference for K2b)."""
    c, t = lo.shape
    s = int(table_lo.shape[1])
    _check_pow2(s)
    dev = lo.device
    n = c * t
    klo, khi = _u32(lo), _u32(hi)
    tlo, thi = _u32(table_lo), _u32(table_hi)
    trow = table_row.reshape(-1).to(torch.int64)
    live = valid.reshape(-1) != 0
    pslot = hash_word(klo, khi) & (s - 1)
    base = (torch.arange(n, device=dev) // t) * s
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    row = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for _ in range(max_probes):
        if not bool(live.any()):
            break
        fidx = base + pslot
        owner = trow[fidx]
        occ = owner >= 0
        hit = live & occ & (tlo[fidx] == klo) & (thi[fidx] == khi)
        found = found | hit
        row = torch.where(hit, owner, row)
        live = live & occ & ~hit
        pslot = torch.where(live, (pslot + 1) & (s - 1), pslot)
    return (
        found.to(torch.int32).reshape(c, t),
        row.to(torch.int32).reshape(c, t),
        live.sum().to(torch.int32),
    )


def _probe_cuda(lo, hi, valid, table_lo, table_hi, table_row, max_probes):
    """K2b (``csrc/hash_table.cu``): one memset of ``unresolved`` and one
    launch."""
    c, t = lo.shape
    s = int(table_lo.shape[1])
    require_cuda(lo, "lo", torch.int32)
    require_cuda(hi, "hi", torch.int32, (c, t))
    require_cuda(valid, "valid", torch.int32, (c, t))
    require_cuda(table_lo, "table_lo", torch.int32, (c, s))
    require_cuda(table_hi, "table_hi", torch.int32, (c, s))
    require_cuda(table_row, "table_row", torch.int32, (c, s))
    dev = lo.device
    out = torch.empty((2, c, t), dtype=torch.int32, device=dev)
    found, row = out.unbind(0)
    unresolved = torch.empty((), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.srt_probe_table(
        ptr(lo), ptr(hi), ptr(valid), ptr(table_lo), ptr(table_hi),
        ptr(table_row), ptr(found), ptr(row), ptr(unresolved),
        c, t, s, int(max_probes), stream_of(lo),
    )
    check_status(lib, rc, "probe_table")
    PROBE.count()
    return found, row, unresolved


def probe_table(lo, hi, valid, table_lo, table_hi, table_row, *,
                max_probes: int = MAX_PROBES):
    """Probe (C, T) query keys against per-chunk tables from
    :func:`build_table`. Returns ``(found (C,T) i32, row (C,T) i32,
    unresolved)`` exactly as the JAX ``probe_table``."""
    _check_pow2(int(table_lo.shape[1]))
    if lo.device.type == "cpu":
        return probe_table_plain(lo, hi, valid, table_lo, table_hi,
                                 table_row, max_probes=max_probes)
    return _probe_cuda(lo, hi, valid, table_lo, table_hi, table_row,
                       max_probes)
