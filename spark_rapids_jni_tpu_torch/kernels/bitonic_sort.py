"""Batched sorts: kernels K3, K4a and K4b and their plain versions (port
of ``kernels/bitonic_sort.py``, whose name the module keeps).

K3 ``batched_sort_u64_looped`` and K4a ``batched_sort_u64`` share one
contract (the JAX package's ``batched_sort_u64_looped`` docstring says it
has ``batched_sort_u64``'s semantics) and one CUDA entry, the radix sort of
``csrc/radix_sort.cu``; each wrapper counts its own launches. K4b
``batched_sort_u32`` sorts u32 keys that are distinct within a row (the
packed groupby's word) with the same radix sort on 4-byte keys, its own
entry, with no perm; see the end of this module. Design notes are in the
source.

The contract is the JAX package's: each row of a ``(C, T)`` u64 key (T a
power of two) is sorted ascending, stably, with payloads carried along;
the result is ``(sorted_key, perm int32, *sorted_payloads)`` where perm is
each output's source index within its row. torch has no unsigned 64-bit
order on the CPU, so the key travels as an int64 tensor holding the u64
bit pattern (``ops.keys.to_unsigned_bits`` of an order word). Payloads
keep their bits:
the JAX package splits 8-byte payloads into two u32 words, bitcasts
4-byte ones and widens narrower integers, all of which round-trip exactly;
a narrow float raises there and here.

The plain versions are the JAX networks in torch ops: a different
algorithm computing the same function, against which the kernels are held
byte for byte.
"""

from __future__ import annotations

import ctypes

import torch

from . import check_status, library, ptr, register, require_cuda, stream_of

_RADIX = "spark_rapids_jni_tpu_torch/csrc/radix_sort.cu"
SORT = register("batched_sort_u64_looped", _RADIX,
                "spark_rapids_jni_tpu/kernels/bitonic_sort.py:401")
SORT_U64 = register("batched_sort_u64", _RADIX,
                    "spark_rapids_jni_tpu/kernels/bitonic_sort.py:116")
SORT_U32 = register("batched_sort_u32", _RADIX,
                    "spark_rapids_jni_tpu/kernels/bitonic_sort.py:265")

#: the kernels' launch geometry: rows ride gridDim.y, and the perm is int32
MAX_ROWS = 65535
MAX_T = 1 << 30

_M32 = 0xFFFFFFFF
# same-width signed views: torch on the CPU gathers no unsigned dtype
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_DECLARED = False


def _lib() -> ctypes.CDLL:
    """The library of ``csrc/radix_sort.cu``, its entries declared."""
    global _DECLARED
    lib = library("radix_sort")
    if not _DECLARED:
        lib.srt_error_string.argtypes = [_I]
        lib.srt_error_string.restype = ctypes.c_char_p
        u64s = ctypes.POINTER(ctypes.c_uint64)
        sort_args = [_P, _P, _P, _I64, _I64, _P, _I64, u64s, u64s,
                     ctypes.POINTER(_I), _I, _P]
        lib.srt_radix_sort_u64_scratch.argtypes = [_I64, _I64]
        lib.srt_radix_sort_u64_scratch.restype = _I64
        lib.srt_radix_sort_u64.argtypes = sort_args
        lib.srt_radix_sort_u64.restype = _I
        lib.srt_radix_sort_u32_scratch.argtypes = [_I64, _I64, _I]
        lib.srt_radix_sort_u32_scratch.restype = _I64
        lib.srt_radix_sort_u32.argtypes = sort_args
        lib.srt_radix_sort_u32.restype = _I
        _DECLARED = True
    return lib


def _payload_args(payloads, outs):
    """The C entries' payload arrays: source and destination pointers and
    each payload's width in bytes."""
    m = len(payloads)
    u64s = ctypes.c_uint64 * m
    return (u64s(*[p.data_ptr() for p in payloads]),
            u64s(*[o.data_ptr() for o in outs]),
            (ctypes.c_int * m)(*[p.element_size() for p in payloads]), m)


def _check(key: torch.Tensor, payloads) -> None:
    if key.dtype != torch.int64:
        raise TypeError(f"key must hold u64 bits in int64, got {key.dtype}")
    if key.dim() != 2:
        raise ValueError(f"key must be (C, T), got {tuple(key.shape)}")
    c, t = key.shape
    if t < 2 or t & (t - 1):
        raise ValueError(f"chunk length must be a power of two, got {t}")
    if t > MAX_T:
        raise ValueError(f"chunk length {t} over the int32 perm bound {MAX_T}")
    for p in payloads:
        if tuple(p.shape) != (c, t):
            raise ValueError(f"payload {tuple(p.shape)} != key {(c, t)}")
        if p.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"payload {p.dtype} is not 1, 2, 4 or 8 bytes")
        if p.dtype.is_floating_point and p.element_size() < 4:
            raise TypeError(
                f"narrow float payload {p.dtype} would lose bits "
                "through the u32 widening; cast it to float32 first"
            )


def batched_sort_plain(key: torch.Tensor, *payloads: torch.Tensor):
    """Reference for K3: the JAX loop form's bitonic network in torch ops
    (partner ``i ^ j``, lexicographic compare of (hi, lo, idx) as u32
    values held in int64, select), then the payloads gathered through the
    perm. The riding index makes every key distinct, so gathering after
    the network equals carrying the payloads through it."""
    _check(key, payloads)
    c, t = key.shape
    hi, lo = (key >> 32) & _M32, key & _M32
    i = torch.arange(t, device=key.device)
    idx = i.expand(c, t)
    k = 2
    while k <= t:
        j = k // 2
        while j >= 1:
            p = i ^ j
            ph, pl, pi = hi[:, p], lo[:, p], idx[:, p]
            p_lt = ((ph < hi) | ((ph == hi) & (pl < lo))
                    | ((ph == hi) & (pl == lo) & (pi < idx)))
            keep_min = ((i & j) == 0) == ((i & k) == 0)
            take = torch.where(keep_min, p_lt, ~p_lt)
            hi = torch.where(take, ph, hi)
            lo = torch.where(take, pl, lo)
            idx = torch.where(take, pi, idx)
            j //= 2
        k *= 2
    sorted_key = (hi << 32) | lo
    outs = []
    for pay in payloads:
        signed = _SIGNED.get(pay.dtype, pay.dtype)
        outs.append(torch.gather(pay.view(signed), 1, idx).view(pay.dtype))
    return (sorted_key, idx.to(torch.int32), *outs)


def _require_batch(key: torch.Tensor, payloads) -> None:
    c, t = key.shape
    if c > MAX_ROWS:
        raise ValueError(f"{c} rows over the kernel's {MAX_ROWS}-row grid")
    require_cuda(key, "key", key.dtype, (c, t))
    for n, p in enumerate(payloads):
        require_cuda(p, f"payloads[{n}]", p.dtype, (c, t))


def _sort_cuda(info, key: torch.Tensor, payloads):
    """The radix sort of ``csrc/radix_sort.cu`` for ``info`` (K3 or K4a),
    counted there. Its scratch (a second (key, index) buffer and the
    digit counts) is allocated here, as the C entry sizes it."""
    _require_batch(key, payloads)
    c, t = key.shape
    sorted_key = torch.empty_like(key)
    perm = torch.empty((c, t), dtype=torch.int32, device=key.device)
    outs = [torch.empty_like(p) for p in payloads]
    lib = _lib()
    nbytes = lib.srt_radix_sort_u64_scratch(c, t)  # 0 when a row fits a block
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=key.device)
    rc = lib.srt_radix_sort_u64(
        ptr(key), ptr(sorted_key), ptr(perm), c, t, ptr(scratch), nbytes,
        *_payload_args(payloads, outs), stream_of(key),
    )
    check_status(lib, rc, info.name)
    info.count()
    return (sorted_key, perm, *outs)


def batched_sort_u64_looped(key: torch.Tensor, *payloads: torch.Tensor):
    """Sort each row of ``key`` (C, T) ascending as u64, stably, carrying
    ``payloads`` (each (C, T)); ``key`` is int64 holding the u64 bits.
    Returns ``(sorted_key, perm int32, *sorted_payloads)``."""
    _check(key, payloads)
    if key.device.type == "cpu":
        return batched_sort_plain(key, *payloads)
    return _sort_cuda(SORT, key, payloads)


#: K4a's plain version: K3's, the same function
batched_sort_u64_plain = batched_sort_plain


def batched_sort_u64(key: torch.Tensor, *payloads: torch.Tensor):
    """K4a: :func:`batched_sort_u64_looped`'s contract on the many-row
    batches of the packed groupby (the JAX package runs its unrolled
    network in 8-row blocks, padding C and stripping it, which changes
    nothing in the result). Counted apart from K3."""
    _check(key, payloads)
    if key.device.type == "cpu":
        return batched_sort_u64_plain(key, *payloads)
    return _sort_cuda(SORT_U64, key, payloads)


# ---------------------------------------------------------------------------
# K4b: u32 keys distinct within a row, no perm
# ---------------------------------------------------------------------------


def _check_u32(key: torch.Tensor, payloads) -> None:
    """The JAX wrapper's checks, in its order, before any work."""
    if key.dim() != 2:
        raise ValueError(f"key must be (C, T), got {tuple(key.shape)}")
    c, t = key.shape
    if t < 2 or t & (t - 1):
        raise ValueError(f"chunk length must be a power of two, got {t}")
    if key.dtype != torch.int32:
        raise TypeError(
            f"key must be uint32 bits held in int32, got {key.dtype}")
    for p in payloads:
        if p.element_size() > 4 or (
                p.element_size() < 4 and p.dtype.is_floating_point):
            raise TypeError(
                f"u32 network payload must be <=4-byte int or any "
                f"4-byte dtype, got {p.dtype}")
        if tuple(p.shape) != (c, t):
            raise ValueError(f"payload {tuple(p.shape)} != key {(c, t)}")
    if t > MAX_T:
        raise ValueError(f"chunk length {t} over the kernel's bound {MAX_T}")


def batched_sort_u32_plain(key: torch.Tensor, *payloads: torch.Tensor):
    """Reference for K4b: the JAX ``_kernel_u32`` network in torch ops
    (partner ``i ^ j``, unsigned compare of the u32 keys held in int64,
    select), with an index riding the same selects; payloads are
    gathered through it, which is carrying them through the network."""
    _check_u32(key, payloads)
    c, t = key.shape
    k32 = key.to(torch.int64) & _M32
    i = torch.arange(t, device=key.device)
    idx = i.expand(c, t)
    k = 2
    while k <= t:
        j = k // 2
        while j >= 1:
            p = i ^ j
            pk, pi = k32[:, p], idx[:, p]
            p_lt = pk < k32
            keep_min = ((i & j) == 0) == ((i & k) == 0)
            take = torch.where(keep_min, p_lt, ~p_lt)
            k32 = torch.where(take, pk, k32)
            idx = torch.where(take, pi, idx)
            j //= 2
        k *= 2
    outs = []
    for pay in payloads:
        signed = _SIGNED.get(pay.dtype, pay.dtype)
        outs.append(torch.gather(pay.view(signed), 1, idx).view(pay.dtype))
    return (k32.to(torch.int32), *outs)


def _sort_u32_cuda(key: torch.Tensor, payloads):
    """K4b: the radix sort of ``csrc/radix_sort.cu`` on 4-byte keys. Keys
    only, nothing rides; with payloads a u32 index rides into ``idx`` and
    moves them once. The scratch is allocated here, as the C entry sizes
    it."""
    _require_batch(key, payloads)
    c, t = key.shape
    sorted_key = torch.empty_like(key)
    idx = (torch.empty((c, t), dtype=torch.int32, device=key.device)
           if payloads else None)
    outs = [torch.empty_like(p) for p in payloads]
    lib = _lib()
    nbytes = lib.srt_radix_sort_u32_scratch(c, t, len(payloads))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=key.device)
    rc = lib.srt_radix_sort_u32(
        ptr(key), ptr(sorted_key), None if idx is None else ptr(idx), c, t,
        ptr(scratch), nbytes, *_payload_args(payloads, outs), stream_of(key),
    )
    check_status(lib, rc, SORT_U32.name)
    SORT_U32.count()
    return (sorted_key, *outs)


def batched_sort_u32(key: torch.Tensor, *payloads: torch.Tensor):
    """K4b: sort each row of ``key`` (C, T) ascending as u32, carrying
    ``payloads``; ``key`` is int32 holding the u32 bits. Keys within a row
    must be distinct (the packed-word-with-iota contract): with ties the
    payloads' order is undefined. Payloads are at most 4 bytes (no narrow
    floats). Returns ``(sorted_key, *sorted_payloads)``."""
    _check_u32(key, payloads)
    if key.device.type == "cpu":
        return batched_sort_u32_plain(key, *payloads)
    return _sort_u32_cuda(key, payloads)
