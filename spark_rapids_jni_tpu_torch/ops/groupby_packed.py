"""Packed-key two-level group-by — the narrow-key fast path (port of
``ops/groupby_packed.py``).

When the key's value range fits in ``64 - log2(chunk_rows)`` bits — 10k-key
aggregations, dictionary codes, date keys, virtually every Spark GROUP BY
that isn't keyed on a hash — the whole sort key collapses into ONE u64
word::

    packed = (order_key(k) - kmin) << iota_bits  |  row_iota
    padding rows -> 0xFFFF...F (sorts last, one garbage segment)

Ties are impossible (the embedded iota is unique), so sorted order within
a key group is original row order: first/last are segment ends, and the
low bits of a sorted word are its row's source index. Phase 1 sorts the
rows in (C, T) chunks and reduces each chunk's segments to at most
``chunk_segments`` partials; phase 2 packs the C x S partials the same way
and combines them.

Words are u64 bit patterns held in int64 tensors. Three rules follow:
``>>`` on int64 is arithmetic, so every right shift of a word masks off
the copied sign bits (:func:`_shr`); the all-ones sentinel is ``-1``; and
unsigned order is signed order of the word with its top bit flipped, so
every sort and every range compare flips it first.

Phase 1 sorts with one of three engines: ``"lax"``, a stable
``torch.sort`` of the words whose indices gather the values (the JAX
package carries them through a variadic ``lax.sort``); ``"pallas"``, the
word alone through K4a (``kernels.bitonic_sort.batched_sort_u64``);
``"pallas32"``, the word's low 32 bits through K4b
(``batched_sort_u32``) when the range fits. The two kernel engines take
the permutation from the sorted words' iota bits.

Eligibility is static (one or more no-null integer-family keys, no-null
decomposable values); whether the range fits is data-dependent and comes
back as the 0-d ``overflow`` tensor, so a mis-sized call is detected,
never silently wrong. PyTorch runs eagerly: the JAX package's ``jit`` and
its caches of jitted callables have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .. import dtype as dt
from ..column import Column, Table
from . import compute
from . import keys as keys_mod
from .groupby import (
    GroupbyAgg, _segment_bounds, _segment_sum, _sorted_segment_extreme,
)
from .groupby import _clip_rows as _clip
from .groupby_chunked import _COMBINE, DECOMPOSABLE_OPS, _phase1_plan

_U64_MAX = -1  # the all-ones u64 word, in its int64 bits
_SIGN64 = keys_mod.SIGN64
ENGINES = ("lax", "pallas", "pallas32")

# same-width signed views: torch indexes no unsigned dtype on every device
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def _shr(word: torch.Tensor, bits: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (word >> bits) & ((1 << (64 - bits)) - 1)


def _uge(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a >= b`` of u64 bits held in int64."""
    return (a ^ _SIGN64) >= (b ^ _SIGN64)


def _umax(a: torch.Tensor) -> torch.Tensor:
    """Unsigned max of u64 bits held in int64 (0-d)."""
    return (a ^ _SIGN64).max() ^ _SIGN64


def _sort_words(words: torch.Tensor):
    """Ascending unsigned sort along the last dim: (words, indices)."""
    s, order = torch.sort(words ^ _SIGN64, dim=-1, stable=True)
    return s ^ _SIGN64, order


def _take(v: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``v`` gathered along ``dim`` (``idx`` shaped like ``v``), any dtype."""
    signed = _SIGNED.get(v.dtype)
    w = v if signed is None else v.view(signed)
    out = torch.gather(w, dim, idx.to(torch.int64))
    return out if signed is None else out.view(v.dtype)


def _key_supported(col: Column) -> bool:
    d = col.dtype
    if col.validity is not None:
        return False
    if d.id in (dt.TypeId.FLOAT32, dt.TypeId.FLOAT64):
        return False  # order key inverts, but ranges are meaningless
    if d.is_string or d.id in (dt.TypeId.LIST, dt.TypeId.STRUCT):
        return False
    if d.id == dt.TypeId.DECIMAL128:
        return False  # two-word key
    return True


def _unkey(carrier: torch.Tensor, d: dt.DType) -> torch.Tensor:
    """Invert ``column_order_keys`` for the integer family. The port's
    order word is a carrier (the u64 word with its top bit flipped): for
    signed ints, timestamps, durations and decimals it is the widened
    value; unsigned and bool flip the bit back and narrow."""
    storage = d.storage_dtype
    if not (d.is_unsigned or d.is_boolean):
        return carrier.to(storage)
    u = carrier ^ _SIGN64
    if storage == torch.uint64:
        return u.view(torch.uint64)
    return u.to(storage)


def packed_groupby_supported(
    table: Table, by: Sequence, aggs: Sequence[GroupbyAgg]
) -> bool:
    """Static eligibility (range fitting is checked separately). Multi-key
    shapes are eligible when every key is integer-family and no-null: the
    composite word packs them as bit fields."""
    if not by:
        return False
    if not all(_key_supported(table.column(k)) for k in by):
        return False
    for a in aggs:
        if a.op not in DECOMPOSABLE_OPS:
            return False
        c = table.column(a.column)
        if c.validity is not None or c.dtype.is_string:
            return False
        if c.dtype.id == dt.TypeId.DECIMAL128:
            return False
    return True


def _plan(table: Table, aggs: Sequence[GroupbyAgg]):
    """Deduplicated partial ops via the two-level planner, re-indexed
    positionally: ``parts`` are (name, op, column), ``plan`` entries
    (op, agg, main part, count part or None)."""
    p1, plan_named = _phase1_plan(table, (), aggs)
    idx = {a.name: i for i, a in enumerate(p1)}
    parts = [(a.name, a.op, a.column) for a in p1]
    plan = [
        (op, a, idx[main], idx[cnt] if cnt is not None else None)
        for (op, a, main, cnt) in plan_named
    ]
    return parts, plan


def _segment_reduce(op, vals, seg, starts, ends):
    """One partial aggregation over a row-sorted flat layout."""
    n = vals.shape[0]
    if op == "sum":
        if vals.dtype.is_floating_point:
            acc = vals.to(torch.float64)
        elif vals.dtype == torch.uint64:
            acc = vals.view(torch.int64)  # the same bits, wrapping alike
        else:
            acc = vals.to(torch.int64)
        # empty partial slots hold 0
        return torch.where(ends > starts, _segment_sum(acc, starts, ends), 0)
    if op == "count":
        # no nulls on the packed path and padding confined to the garbage
        # segment: count is the segment length
        return (ends - starts).to(torch.int64)
    if op in ("min", "max"):
        return _sorted_segment_extreme(vals, seg, ends, op == "min")
    if op == "first":
        return _take(vals, _clip(starts, n))
    if op == "last":
        return _take(vals, _clip(ends - 1, n))
    raise ValueError(op)


def _pad_chunks(v: torch.Tensor, c: int, chunk_rows: int) -> torch.Tensor:
    """``v`` zero-padded to ``c * chunk_rows`` rows, as (C, T)."""
    out = v.new_zeros(c * chunk_rows)
    out[: v.shape[0]] = v
    return out.reshape(c, chunk_rows)


def pack_chunks(rel: torch.Tensor, chunk_rows: int):
    """Phase 1's (C, T) words ``rel << iota_bits | iota`` (u64 bits in
    int64), padding rows the all-ones sentinel, and the (C, T) occupancy."""
    n = rel.shape[0]
    c = -(-n // chunk_rows)
    iota_bits = max(1, (chunk_rows - 1).bit_length())
    iota = torch.arange(chunk_rows, dtype=torch.int64, device=rel.device)
    occ2d = (torch.arange(c * chunk_rows, device=rel.device) < n).reshape(
        c, chunk_rows)
    packed = _pad_chunks(rel << iota_bits, c, chunk_rows) | iota
    return torch.where(occ2d, packed, _U64_MAX), occ2d


def groupby_aggregate_packed_chunked(
    table: Table,
    by: Sequence[Union[int, str]],
    aggs: Sequence[GroupbyAgg],
    num_segments: int,
    chunk_rows: int = 1 << 18,
    chunk_segments: int = 1 << 14,
    field_bits: Optional[tuple] = None,
    engine: str = "lax",
) -> tuple[Table, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed two-level groupby.

    Returns ``(padded result of num_segments rows, num_groups,
    max_per_chunk_groups, overflow)``, the last three as 0-d tensors, so
    nothing waits on the device until the caller reads them. EXACT iff
    ``overflow`` is False and ``max_per_chunk_groups <= chunk_segments``;
    rows at and beyond ``num_groups`` hold garbage.

    ``field_bits`` (one entry per key column) packs several narrow keys as
    bit fields of one composite word; required for multi-key shapes.
    ``engine`` is ``"lax"``, ``"pallas"`` (K4a) or ``"pallas32"`` (K4b,
    whose u32 fit rides ``overflow``); the kernel engines need
    ``chunk_rows`` a power of two.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown packed-groupby engine {engine!r}")
    key_names, key_cols = _validate_and_names(table, by, aggs, field_bits)
    n = table.row_count
    dev = key_cols[0].data.device
    c = -(-n // chunk_rows)
    padded = c * chunk_rows
    iota_bits = max(1, (chunk_rows - 1).bit_length())
    p2_rows = c * (chunk_segments + 1)  # +1: per-chunk garbage slot
    iota_bits2 = max(1, (p2_rows - 1).bit_length())

    # one fewer bit than either level leaves: both sentinels stay strictly
    # above every packed word
    allowed = (
        64 - max(iota_bits, iota_bits2)
        if field_bits is None
        else 63 - max(iota_bits, iota_bits2)
    )
    rel, kmins, overflow = _composite_rel(key_cols, field_bits, allowed)

    parts, plan = _plan(table, aggs)
    ops_2d = [
        _pad_chunks(compute.values(table.column(colref)), c, chunk_rows)
        for (_, _, colref) in parts
    ]

    # ---- phase 1: batched (C, T) packed sort + flat segment reduce ----
    packed, occ2d = pack_chunks(rel, chunk_rows)
    if engine == "lax":
        spacked, order = _sort_words(packed)
    else:
        u32 = engine == "pallas32"
        if u32:
            # the narrowed word keeps the low half: exact iff every real
            # word sits strictly below the all-ones u32 sentinel, so the
            # rel value whose top word would equal it is reserved too
            if iota_bits >= 32:
                overflow = torch.ones((), dtype=torch.bool, device=dev)
            else:
                fit_line = (1 << (32 - iota_bits)) - 1
                overflow = overflow | _uge(_umax(rel), fit_line)
        spacked, order = _pallas_word_sort(packed, iota_bits, u32)
    svals = [_take(v2d, order, dim=1) for v2d in ops_2d]

    skey = _shr(spacked, iota_bits)  # (C, T) relative key words
    boundary = torch.ones_like(skey, dtype=torch.bool)
    boundary[:, 1:] = skey[:, 1:] != skey[:, :-1]
    local_seg = torch.cumsum(boundary, dim=1, dtype=torch.int32) - 1
    # group count per chunk = local segment of its last real row + 1
    # (real rows sort before the sentinel; padding forms one trailing
    # garbage segment per padded chunk)
    real_per_chunk = occ2d.sum(dim=1)
    last_real = (real_per_chunk - 1).clamp(0, chunk_rows - 1)
    chunk_groups = torch.where(
        real_per_chunk > 0,
        local_seg.gather(1, last_real[:, None])[:, 0] + 1,
        0,
    )
    max_chunk = chunk_groups.max()

    # per-chunk stride is S+1: slot S is a dedicated garbage slot, so a
    # padded chunk whose real groups fill all S slots cannot have its
    # padding clamped into the last real segment
    stride = chunk_segments + 1
    seg_flat = (
        torch.arange(c, dtype=torch.int32, device=dev)[:, None] * stride
        + local_seg.clamp(max=chunk_segments)
    ).reshape(-1)
    starts, ends = _segment_bounds(seg_flat, c * stride)
    # a partial slot is real iff its local id is below its chunk's group
    # count (slot S never is when exact)
    sids = torch.arange(c * stride, device=dev)
    p2_valid = (sids % stride) < chunk_groups[sids // stride]
    ends = torch.where(p2_valid, ends, starts)

    part_key = skey.reshape(-1)[_clip(starts, padded)]  # relative words
    partials = [
        _segment_reduce(op, sv.reshape(-1), seg_flat, starts, ends)
        for ((_, op, _), sv) in zip(parts, svals)
    ]

    # ---- phase 2: pack the C*S partials the same way ------------------
    iota2 = torch.arange(p2_rows, dtype=torch.int64, device=dev)
    packed2 = torch.where(p2_valid, (part_key << iota_bits2) | iota2,
                          _U64_MAX)
    sp2, order2 = _sort_words(packed2)
    sparts = [_take(p, order2) for p in partials]
    svalid2 = p2_valid[order2]

    skey2 = _shr(sp2, iota_bits2)
    boundary2 = torch.ones_like(skey2, dtype=torch.bool)
    boundary2[1:] = skey2[1:] != skey2[:-1]
    seg2 = torch.cumsum(boundary2, dim=0, dtype=torch.int32) - 1
    num_groups = torch.where(svalid2, seg2 + 1, 0).max()
    starts2, ends2 = _segment_bounds(seg2, num_segments)
    valid_out = (torch.arange(num_segments, dtype=torch.int32, device=dev)
                 < num_groups)
    ends2 = torch.where(valid_out, ends2, starts2)
    finals = [
        _segment_reduce(_COMBINE[op], sp, seg2, starts2, ends2)
        for ((_, op, _), sp) in zip(parts, sparts)
    ]

    # reconstruct the key column(s) from the segment-start word
    key_rel = skey2[_clip(starts2, p2_rows)]
    out_cols = _reconstruct_keys(key_rel, key_cols, kmins, field_bits)
    out_cols, out_names = _assemble_output(
        table, plan, finals, valid_out, out_cols, list(key_names)
    )
    return Table(out_cols, out_names), num_groups, max_chunk, overflow


def _pallas_word_sort(packed: torch.Tensor, iota_bits: int, u32: bool):
    """Sort the (C, T) packed words, key only, with K4a (``u32=False``)
    or K4b on their low 32 bits (``u32=True``; the caller folds the fit
    into its overflow flag), and return ``(sorted_words, perm)``, perm
    being each row's embedded-iota source index. The all-ones sentinel
    narrows to the all-ones u32 and maps back; its iota bits are masked
    into [0, T) (T a power of two), so padding rows gather garbage that
    lands in the trailing garbage segment."""
    from ..kernels.bitonic_sort import batched_sort_u32, batched_sort_u64

    if u32:
        low = packed.view(torch.int32)[:, 0::2].contiguous()  # little-endian
        s32 = batched_sort_u32(low)[0]
        spacked = torch.where(s32 == -1, _U64_MAX,
                              s32.to(torch.int64) & 0xFFFFFFFF)
    else:
        spacked = batched_sort_u64(packed)[0]
    return spacked, spacked & ((1 << iota_bits) - 1)


def _validate_and_names(table, by, aggs, field_bits):
    """Shared preamble of both packed groupbys: eligibility, field_bits
    arity, output key names, resolved key columns."""
    if not packed_groupby_supported(table, by, aggs):
        raise ValueError(
            "packed groupby: no-null integer-family keys and no-null "
            "decomposable value columns required"
        )
    if field_bits is None and len(by) != 1:
        raise ValueError("multi-key packed groupby needs field_bits")
    if field_bits is not None and len(field_bits) != len(by):
        raise ValueError("field_bits must have one entry per key")
    key_names = [
        c
        if isinstance(c, str)
        else (table.names[c] if table.names else f"key{i}")
        for i, c in enumerate(by)
    ]
    key_cols = [table.column(k) for k in by]
    return key_names, key_cols


def _slice_groups(out: Table, g: int) -> Table:
    """The capped result trimmed to its exact group count."""
    return Table(
        [
            Column(
                col.data[:g],
                col.dtype,
                None if col.validity is None else col.validity[:g],
                None if col.lengths is None else col.lengths[:g],
            )
            for col in out.columns
        ],
        out.names,
    )


def _composite_rel(key_cols, field_bits, allowed_bits: int):
    """(rel composite word (n,), kmins, overflow): the relative key word
    shared by the chunked and flat paths, as u64 bits in int64. A carrier
    difference equals the u64 words' difference; ``kmins`` are carriers.
    ``allowed_bits`` is how many high bits the packing leaves for the key
    fields; ``overflow`` trips when the data exceeds the declared widths."""
    if field_bits is None:
        kw = keys_mod.column_order_keys(key_cols[0])[0]
        kmin = kw.min()
        rel = kw - kmin
        overflow = _uge(_umax(rel), (1 << allowed_bits) - 1)
        return rel, [kmin], overflow
    if sum(field_bits) > allowed_bits:
        raise ValueError(
            f"field_bits {field_bits} exceed the {allowed_bits} bits "
            "this packing leaves; the router must decline this shape"
        )
    rels = []
    kmins = []
    overflow = torch.zeros((), dtype=torch.bool,
                           device=key_cols[0].data.device)
    for kc, b in zip(key_cols, field_bits):
        kwi = keys_mod.column_order_keys(kc)[0]
        kmini = kwi.min()
        kmins.append(kmini)
        reli = kwi - kmini
        overflow = overflow | _uge(_umax(reli), 1 << b)
        rels.append(reli)
    return keys_mod.fold_fields(rels, field_bits), kmins, overflow


def _reconstruct_keys(key_rel, key_cols, kmins, field_bits):
    """Key column(s) from the composite relative word at segment starts."""
    if field_bits is None:
        d = key_cols[0].dtype
        return [Column(_unkey(key_rel + kmins[0], d), d, None)]
    fields = keys_mod.peel_fields(key_rel, field_bits)
    return [
        Column(_unkey(f + kmini, kc.dtype), kc.dtype, None)
        for kc, kmini, f in zip(key_cols, kmins, fields)
    ]


def _assemble_output(table, plan, finals, valid_out, out_cols, out_names):
    """User-facing agg columns, schema-identical to the single-pass path
    (count INT64, float sums FLOAT64, decimal sums DECIMAL64 at the
    input's scale, min/max/first/last keep the source dtype, mean FLOAT64
    valid for the real groups)."""
    for op, a, main_i, count_i in plan:
        colref = a.column
        base = (
            colref
            if isinstance(colref, str)
            else (table.names[colref] if table.names else f"c{colref}")
        )
        out_name = a.name or f"{a.op}_{base}"
        src = table.column(colref)
        if op == "mean":
            total = finals[main_i]
            cnt = finals[count_i]
            mean = total.to(torch.float64) / cnt.clamp(min=1)
            if src.dtype.is_decimal:
                mean = mean * (10.0 ** src.dtype.scale)
            out_cols.append(compute.from_values(mean, dt.FLOAT64, valid_out))
        elif op == "count":
            out_cols.append(Column(finals[main_i], dt.INT64, None))
        elif op == "sum":
            v = finals[main_i]
            if src.dtype.is_floating:
                out_cols.append(compute.from_values(v, dt.FLOAT64, None))
            elif src.dtype.is_decimal:
                out_cols.append(Column(
                    v, dt.DType(dt.TypeId.DECIMAL64, src.dtype.scale), None))
            else:
                out_cols.append(Column(v, dt.INT64, None))
        else:
            out_cols.append(
                compute.from_values(finals[main_i], src.dtype, None))
        out_names.append(out_name)
    return out_cols, out_names


def groupby_aggregate_packed(
    table: Table,
    by: Sequence[Union[int, str]],
    aggs: Sequence[GroupbyAgg],
    chunk_rows: int = 1 << 18,
    chunk_segments: Optional[int] = None,
) -> Optional[Table]:
    """Eager packed groupby with exact output size, or None when the
    shape is ineligible (the caller falls back to another groupby).

    Range fitting is decided from one min/max probe per key (two host
    reads); ``chunk_segments`` is sized from the span product when not
    given, with one retry at the observed per-chunk count. Keys too spread
    for per-chunk dedup take the flat single-level arm."""
    n = table.row_count
    if n <= chunk_rows:
        return None
    if not packed_groupby_supported(table, by, aggs):
        return None
    spans = []
    for k in by:
        kw = keys_mod.column_order_keys(table.column(k))[0]
        lo, hi = keys_mod.minmax_host(kw)
        spans.append(hi - lo)
    c = -(-n // chunk_rows)
    iota_bits = max(1, (chunk_rows - 1).bit_length())
    if len(by) == 1:
        field_bits = None
        span_bits = max(1, spans[0].bit_length())
    else:
        field_bits = tuple(max(1, sp.bit_length()) for sp in spans)
        span_bits = sum(field_bits)
    # cardinality proxy: the product of spans caps distinct keys
    span_card = 1
    for sp in spans:
        span_card *= sp + 1
        if span_card > n:
            span_card = n
            break
    if chunk_segments is None:
        # worst-case distinct keys per chunk bounded by the span product
        guess = min(chunk_rows, 1 << max(6, (span_card - 1).bit_length()))
        chunk_segments = min(guess, 1 << 14)
    iota_bits2 = max(1, (c * (chunk_segments + 1) - 1).bit_length())
    if field_bits is None:
        limit = (1 << (64 - max(iota_bits, iota_bits2))) - 1
        if spans[0] >= limit:
            return None
    elif span_bits + max(iota_bits, iota_bits2) > 63:
        return None
    if span_card > chunk_segments * 4 and span_card > chunk_rows:
        # keys too spread for per-chunk dedup to win — but the flat packed
        # sort (one narrow word over the whole column) still applies
        flat_iota = max(1, (n - 1).bit_length())
        flat_allowed = 64 - flat_iota if field_bits is None else 63 - flat_iota
        if field_bits is None:
            if spans[0] >= (1 << flat_allowed) - 1:
                return None
        elif span_bits > flat_allowed:
            return None
        # the JAX package quantizes the capacity to bound its compiles;
        # the same capacity keeps the two packages' paths alike
        flat_cap = min(n, 1 << max(6, (span_card - 1).bit_length()))
        out, ng, ov = groupby_aggregate_packed_flat(
            table, by, aggs, flat_cap, field_bits)
        if bool(ov):
            raise RuntimeError("flat packed groupby overflow")
        return _slice_groups(out, int(ng))

    for _ in range(2):
        out, num_groups, max_chunk, overflow = (
            groupby_aggregate_packed_chunked(
                table, by, aggs, min(c * chunk_segments, n), chunk_rows,
                chunk_segments, field_bits,
            ))
        if bool(overflow):
            raise RuntimeError("packed groupby range overflow")
        if int(max_chunk) <= chunk_segments:
            return _slice_groups(out, int(num_groups))
        if chunk_segments >= chunk_rows:
            break
        chunk_segments = min(chunk_rows,
                             1 << int(max_chunk - 1).bit_length())
    return None


def groupby_aggregate_packed_flat(
    table: Table,
    by: Sequence[Union[int, str]],
    aggs: Sequence[GroupbyAgg],
    num_segments: int,
    field_bits: Optional[tuple] = None,
    values_via: str = "sort",
) -> tuple[Table, torch.Tensor, torch.Tensor]:
    """Single-level packed groupby — the high-cardinality arm: pack, sort
    once over the whole column, segment-reduce.

    ``values_via`` routes the values to sorted order: ``"sort"`` gathers
    them through the sort's own indices (the JAX package carries them
    through its variadic sort), ``"gather"`` through the sorted words'
    embedded iota. Both give the same rows.

    Returns ``(padded result of num_segments rows, num_groups,
    overflow)``, 0-d tensors — EXACT iff ``overflow`` is False (key fields
    fit and num_groups <= num_segments)."""
    if values_via not in ("sort", "gather"):
        raise ValueError(f"unknown values_via {values_via!r}")
    key_names, key_cols = _validate_and_names(table, by, aggs, field_bits)
    n = table.row_count
    dev = key_cols[0].data.device
    iota_bits = max(1, (n - 1).bit_length())
    allowed = 64 - iota_bits if field_bits is None else 63 - iota_bits
    rel, kmins, overflow = _composite_rel(key_cols, field_bits, allowed)

    parts, plan = _plan(table, aggs)
    vals_in = [
        compute.values(table.column(colref)) for (_, _, colref) in parts
    ]
    packed = (rel << iota_bits) | torch.arange(n, device=dev)
    sword, order = _sort_words(packed)
    if values_via == "gather":
        order = sword & ((1 << iota_bits) - 1)
    svals = [_take(v, order) for v in vals_in]
    skey = _shr(sword, iota_bits)

    boundary = torch.ones_like(skey, dtype=torch.bool)
    boundary[1:] = skey[1:] != skey[:-1]
    seg = torch.cumsum(boundary, dim=0, dtype=torch.int32) - 1
    num_groups = seg[-1] + 1
    overflow = overflow | (num_groups > num_segments)

    starts, ends = _segment_bounds(seg, num_segments)
    valid_out = (torch.arange(num_segments, dtype=torch.int32, device=dev)
                 < num_groups)
    ends = torch.where(valid_out, ends, starts)
    finals = [
        _segment_reduce(op, sv, seg, starts, ends)
        for ((_, op, _), sv) in zip(parts, svals)
    ]
    key_rel = skey[_clip(starts, n)]
    out_cols = _reconstruct_keys(key_rel, key_cols, kmins, field_bits)
    out_cols, out_names = _assemble_output(
        table, plan, finals, valid_out, out_cols, list(key_names)
    )
    return Table(out_cols, out_names), num_groups, overflow
