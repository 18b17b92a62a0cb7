"""Packed-key batched inner join: the narrow-key form of
``inner_join_batched`` (port of ``ops/join_packed.py``).

When the no-null integer-family keys' combined value ranges fit in
``64 - log2(build_rows)`` bits (dictionary codes, dates, sequential ids,
alone or composed), the build side collapses into one u64 word a row::

    build:  sorted = sort((key - kmin) << bits | build_iota)
    perm:   sorted & mask
    probe:  lo = searchsorted(sorted, rel_q << bits,        'left')
            hi = searchsorted(sorted, rel_q << bits | mask, 'right')

``kmin`` is the smallest key of both sides and the fit covers both
spans, so every probe key is in range and an unmatched one gets
``lo == hi``. The pairs and the output are the batched join's
(``join._inner_pairs``): the same rows in the same order. The JAX
package sorts the word with ``lax.sort`` outside any Pallas kernel; the
port sorts it with K3 (``sort_packed.sort_u64_words``) and searches it
with ``torch.searchsorted`` on the words with their top bit flipped
(signed order of the flipped word is unsigned order of the word).
Ineligible shapes return None: the caller runs ``inner_join_batched``.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Sequence, Union

import torch

from ..column import Table
from . import keys as keys_mod
from .groupby_packed import _key_supported
from .keys import minmax_host as _minmax

#: the JAX package's largest probe chunk (its fused-graph fence); a chunk
#: size changes how the output is cut, never its rows
FUSED_PROBE_MAX_ROWS = 16_000_000


def packed_join_supported(left: Table, right: Table, on: Sequence,
                          right_on: Sequence) -> bool:
    """Every key pair integer-family and no-null on both sides
    (several pairs pack as composite bit fields)."""
    if not on or len(on) != len(right_on):
        return False
    return all(_key_supported(left.column(lk))
               and _key_supported(right.column(rk))
               for lk, rk in zip(on, right_on))


def _composite(kws, kmins, field_bits) -> torch.Tensor:
    return keys_mod.fold_fields([kw - kmin for kw, kmin in zip(kws, kmins)],
                                field_bits)


def _probe_rows(left: Table, right: Table, nk: int) -> int:
    """The JAX package's probe chunk: what the device-memory budget
    leaves beside both inputs, the packed build (a word and a perm a
    build row) and both sides' key words."""
    import warnings

    from ..utils import hbm

    n, m = left.row_count, right.row_count
    budget = hbm.budget_bytes(left.columns[0].data.device)
    fixed = (hbm.table_bytes(left) + hbm.table_bytes(right) + 12 * m
             + 8 * nk * (n + m))
    out_row = hbm.row_bytes(left) + hbm.row_bytes(right)
    per_probe_row = hbm.row_bytes(left) + 8 + 2 * out_row
    avail = budget - fixed
    if avail <= 0:
        warnings.warn(
            "join inputs exceed the device memory budget before any probe "
            f"chunk ({fixed} fixed vs {budget} budget); expect allocator "
            "pressure. Raise SPARK_RAPIDS_TPU_HBM_BUDGET_GB if the device "
            "really has more.", stacklevel=3)
    return min(FUSED_PROBE_MAX_ROWS, max(1024, avail // max(per_probe_row, 1)))


def inner_join_batched_packed(
    left: Table,
    right: Table,
    on: Sequence[Union[int, str]],
    right_on: Optional[Sequence[Union[int, str]]] = None,
    probe_rows: Optional[int] = None,
) -> Optional[Table]:
    """Batched inner join through the packed build, or None when the
    shape is ineligible or the key span does not fit. Probe chunks whose
    output passes their budget split in two, as the batched join's do."""
    from ..utils import hbm
    from . import join as join_mod
    from .copying import concatenate, slice_rows

    right_on = right_on or on
    if probe_rows is not None and probe_rows <= 0:
        raise ValueError(f"probe_rows must be positive, got {probe_rows}")
    if not packed_join_supported(left, right, on, right_on):
        return None
    n, m = left.row_count, right.row_count
    if n == 0 or m == 0:
        return None
    bits = max(1, (m - 1).bit_length())
    kws_l = [keys_mod.column_order_keys(left.column(k))[0] for k in on]
    kws_r = [keys_mod.column_order_keys(right.column(k))[0]
             for k in right_on]
    kmins, field_bits = [], []
    for kl, kr in zip(kws_l, kws_r):
        lo_l, hi_l = _minmax(kl)
        lo_r, hi_r = _minmax(kr)
        kmin = min(lo_l, lo_r)
        kmins.append(kmin)
        field_bits.append(max(1, (max(hi_l, hi_r) - kmin).bit_length()))
    if sum(field_bits) + bits > 64:
        return None  # no sentinel here: all 64 bits are usable
    if probe_rows is None:
        probe_rows = _probe_rows(left, right, len(on))

    from .sort_packed import sort_u64_words

    mask = (1 << bits) - 1
    dev = kws_r[0].device
    build = ((_composite(kws_r, kmins, field_bits) << bits)
             | torch.arange(m, dtype=torch.int64, device=dev))
    sorted_words, _ = sort_u64_words(build)
    perm_r = sorted_words & mask
    # top bit flipped: signed order of the carriers is u64 order
    flipped = sorted_words ^ keys_mod.SIGN64

    out_row_bytes = hbm.row_bytes(left) + hbm.row_bytes(right)
    budget = max(probe_rows * 2 * out_row_bytes, join_mod.MIN_CHUNK_OUT_BYTES)
    pieces = []
    spans = deque((s, min(s + probe_rows, n)) for s in range(0, n, probe_rows))
    while spans:
        start, stop = spans.popleft()
        base = _composite([kw[start:stop] for kw in kws_l], kmins,
                          field_bits) << bits
        lo = torch.searchsorted(flipped, base ^ keys_mod.SIGN64)
        hi = torch.searchsorted(flipped, (base | mask) ^ keys_mod.SIGN64,
                                right=True)
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            continue
        cap = max(32, 1 << (total - 1).bit_length())
        if cap * out_row_bytes > budget and stop - start > 1024:
            mid = (start + stop) // 2
            spans.appendleft((mid, stop))
            spans.appendleft((start, mid))
            continue
        pieces.append(join_mod._inner_pairs(
            slice_rows(left, start, stop), right, list(right_on), perm_r, lo,
            counts, total))
    if not pieces:
        # zero matches: the joined schema without the match mask the
        # exact join's empty result carries
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        return join_mod.join_output(slice_rows(left, 0, 0), right,
                                    list(right_on), z, z, None)
    return concatenate(pieces) if len(pieces) > 1 else pieces[0]
