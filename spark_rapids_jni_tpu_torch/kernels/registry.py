"""The kernel tier of the port (port of ``kernels/registry.py``).

One entry per accelerated inner loop, each with an applicability
predicate (a decline reason, or None) and a runner whose result is byte
for byte the exact path's. ``runtime_bridge._dispatch_once`` asks the
tier first; a declined op runs on the exact path.

The tier is gated as the JAX package's is, by ``SPARK_RAPIDS_TPU_KERNELS``
(``utils/config.py``): ``on`` tries every applicable route, ``off``
none, ``auto`` (the default) only for tables whose tensors are on a CUDA
device. With the metrics flag on, every route that runs counts
``kernel.launches`` and every decline ``kernel.declines``. The gate
governs the tier's routes that have an exact twin: ``hash_build_probe``,
``hash_groupby`` and ``packed_sort``. The row transpose has no second
implementation in the port, so ``to_rows``/``from_rows`` run K1a/K1b
whatever the gate (``run_kernel``, outside the counters, as the JAX
package's exact path runs its own transpose); the tier's ``row_pack``
and ``row_unpack`` entries count them when it is on.

What carries over from the JAX package is every SEMANTIC decline: multi-
column, nullable, string or DECIMAL128 keys; duplicate build keys of an
inner join; ``overflow``/``unresolved`` probe bounds; non-decomposable
aggregations; float and decimal aggregation values. What does not:

* the replay on the exact path. A kernel that does not build or launch
  raises. A fault that an armed ``FAULTS`` plan injects at the ``kernel``
  site (``faults.inject("kernel")``, before the runner) is a transient
  that retries the same runner once (``kernel.retries``), so the exact
  path never stands in for a kernel;
* the TPU VMEM bounds. The port's tables live in device memory; its only
  bounds keep every row and slot id inside the kernels' int32 indices
  (see the constants below);
* the bucket. A runner takes the JAX tier's padded input (the table's
  bucket, ``utils/buckets.py``), masks the padding with the tail
  occupancy and returns the JAX tier's padded result, padding bytes
  included. Where the table has no bucket (``BUCKETS=off``, past the
  ladder's cap) the JAX tier declines ("no shape bucket"); the port's
  kernels need none, so its runners take the exact table and give the
  exact path's bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import dtype as dt
from ..column import Column, Table
from ..utils import buckets, config, faults, metrics, profiler

#: Registered kernel entries.
KERNEL_NAMES = frozenset(
    {"packed_sort", "hash_build_probe", "hash_groupby", "row_pack",
     "row_unpack"}
)

#: hash_groupby chunk length T; each chunk's table has S = 2T slots. The
#: merged result does not depend on T.
GROUPBY_CHUNK_ROWS = 4096

#: Bounds from the kernels' int32 row and slot ids. A join build of B
#: rows gets S = 2 * next_pow2(B) slots, so B <= 2^29 keeps S <= 2^30.
#: The device memory of such a table is 20 bytes a slot (key halves, row
#: id, claim tag): 2^30 slots = 21.5 GB of the H100's 80 GB, and the
#: probe side's 12 bytes of keys per row and 8 bytes of results fit the
#: rest for up to 2^30 rows.
JOIN_BUILD_MAX_ROWS = 1 << 29
JOIN_PROBE_MAX_ROWS = 1 << 30
#: hash_groupby: C chunks of S = 2T slots need C * S < 2^31, so the
#: input stays under 2^30 rows.
GROUPBY_MAX_ROWS = 1 << 30

_AGG_OPS = frozenset({"sum", "count", "min", "max"})


class KernelDecline(Exception):
    """This op opts out of the kernel tier: the exact path runs."""


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _order_word_reason(col: Column) -> Optional[str]:
    """Why this column cannot be a one-word kernel key, or None."""
    d = col.dtype
    if d.is_string:
        return "string key (multi-word order key)"
    if d.id == dt.TypeId.DECIMAL128:
        return "DECIMAL128 key (two-word order key)"
    if d.id in (dt.TypeId.LIST, dt.TypeId.STRUCT):
        return f"{d.id.name} key"
    if col.validity is not None:
        return "nullable key (null-placement word)"
    return None


def _bucketed_input(table: Table) -> Table:
    """The input a runner works on: a padded table as it is, an exact one
    padded to its bucket as the JAX tier pads it, or (no bucket) the
    exact table."""
    if table.logical_rows is not None or not buckets.enabled():
        return table
    b = buckets.bucket_for(table.logical_row_count)
    return table if b is None else buckets.pad_table(table, b)


def _occupancy(table: Table) -> torch.Tensor:
    """True for the logical rows of the table's physical ones."""
    return buckets.tail_valid(table.row_count, table.logical_row_count,
                              table.columns[0].data.device)


def _resolve_col(table: Table, spec) -> Optional[Column]:
    try:
        return table.column(spec)
    except (KeyError, IndexError, TypeError, ValueError):
        return None


def _key_halves(col: Column):
    """(lo, hi) int32 halves of the column's one order word, as (1, n)."""
    from ..ops import keys as keys_mod

    lo, hi = keys_mod.split_u32(keys_mod.column_order_keys(col)[0])
    return lo[None, :], hi[None, :]


# ---------------------------------------------------------------------------
# packed_sort — single-key sort_by through the bitonic network (K3)
# ---------------------------------------------------------------------------


def _payload_buffers(table: Table) -> list:
    """``(column, attr, tensor)`` of every 1-D buffer that rides the sort
    as a payload: data, validity, lengths. Matrix data (DECIMAL128 limbs,
    LIST bytes) gathers through the perm instead."""
    out = []
    for i, c in enumerate(table.columns):
        for attr in ("data", "validity", "lengths"):
            buf = getattr(c, attr)
            if buf is not None and buf.dim() == 1:
                out.append((i, attr, buf))
    return out


def _a_packed_sort(op: dict, table: Table, rest) -> Optional[str]:
    ks = op.get("keys") or []
    if len(ks) != 1:
        return "multi-key sort (one packed word per network)"
    col = _resolve_col(table, ks[0].get("column"))
    if col is None:
        return "unresolvable sort key column"
    r = _order_word_reason(col)
    if r is not None:
        return r
    from . import bitonic_sort

    if table.logical_row_count == 0:
        return "empty input"
    # the rows pad to T = next_pow2(bucket), which the int32 perm bounds
    n = _bucketed_rows(table)
    if _next_pow2(max(n, 2)) > bitonic_sort.MAX_T:
        return f"{n} rows over the int32 perm bound"
    return None


def _bucketed_rows(table: Table) -> int:
    """The physical rows of :func:`_bucketed_input` of the table."""
    if table.logical_rows is not None or not buckets.enabled():
        return table.row_count
    return buckets.bucket_for(table.logical_row_count) or table.row_count


def _r_packed_sort(op: dict, table: Table, rest) -> Table:
    from ..ops import keys as keys_mod
    from . import bitonic_sort

    table = _bucketed_input(table)
    kspec = op["keys"][0]
    w = keys_mod.column_order_keys(table.column(kspec["column"]))[0]
    if not bool(kspec.get("ascending", True)):
        w = ~w
    n = table.row_count
    pad = _next_pow2(max(n, 2)) - n
    # padding rows, of the bucket and of the network, take the all-ones
    # key, so the index tiebreak keeps a real all-ones key (INT64 max
    # ascending, INT64 min descending) ahead of them and the bucket's
    # padding rows in their order behind the real ones
    u = keys_mod.to_unsigned_bits(w)
    if table.logical_rows is not None:
        u = torch.where(_occupancy(table), u, -1)
    key = torch.cat([u, u.new_full((pad,), -1)]) if pad else u
    bufs = _payload_buffers(table)
    pays = [torch.cat([b, b.new_zeros(pad)]) if pad else b.contiguous()
            for _, _, b in bufs]
    out = bitonic_sort.batched_sort_u64_looped(
        key[None, :], *[p[None, :] for p in pays])
    perm = out[1][0, :n]
    got = {}
    for (i, attr, _), sorted_buf in zip(bufs, out[2:]):
        got[(i, attr)] = sorted_buf[0, :n]
    cols = []
    for i, c in enumerate(table.columns):
        data = got.get((i, "data"))
        if data is None:
            data = c.data[perm.to(torch.int64)]
        cols.append(Column(data, c.dtype, got.get((i, "validity")),
                           got.get((i, "lengths"))))
    return Table(cols, table.names, logical_rows=table.logical_rows)


# ---------------------------------------------------------------------------
# hash_build_probe — inner, semi and anti joins through the hash table
# (K2a + K2b)
# ---------------------------------------------------------------------------


_KERNEL_JOIN_HOWS = frozenset({"inner", "semi", "anti"})


def _a_hash_join(op: dict, table: Table, rest) -> Optional[str]:
    how = op.get("how", "inner")
    if how not in _KERNEL_JOIN_HOWS:
        return f"join how={how!r} (left/outer build on exact machinery)"
    if not rest:
        return "missing build-side table"
    on = op.get("on") or []
    if len(on) != 1:
        return "multi-column join key"
    lcol = _resolve_col(table, on[0])
    rcol = _resolve_col(rest[0], on[0])
    if lcol is None or rcol is None:
        return "unresolvable join key column"
    for side, col in (("probe", lcol), ("build", rcol)):
        r = _order_word_reason(col)
        if r is not None:
            return f"{side} side: {r}"
    if table.logical_row_count == 0 or rest[0].logical_row_count == 0:
        return "empty join side"
    if _bucketed_rows(rest[0]) > JOIN_BUILD_MAX_ROWS:
        return f"build side {rest[0].row_count} rows over the int32 slot bound"
    if _bucketed_rows(table) > JOIN_PROBE_MAX_ROWS:
        return f"probe side {table.row_count} rows over the int32 row bound"
    return None


def _r_hash_join(op: dict, table: Table, rest) -> Table:
    from ..ops.filter import filter_table, filter_table_capped
    from ..ops.join import join_output
    from . import hash_table

    table = _bucketed_input(table)
    right = _bucketed_input(rest[0])
    padded = table.logical_rows is not None or right.logical_rows is not None
    lv, rv = _occupancy(table), _occupancy(right)
    on = list(op["on"])
    blo, bhi = _key_halves(right.column(on[0]))
    slots = 2 * _next_pow2(right.row_count)
    _, tlo, thi, trow, ovf, dup = hash_table.build_table(
        blo, bhi, rv.to(torch.int32)[None, :], table_slots=slots
    )
    plo, phi = _key_halves(table.column(on[0]))
    found, rrow, unres = hash_table.probe_table(
        plo, phi, lv.to(torch.int32)[None, :], tlo, thi, trow
    )
    ovf, dup, unres = (int(x) for x in torch.stack([ovf, dup, unres]).cpu())
    if ovf or unres:
        raise KernelDecline("hash table probe bound exceeded")
    how = op.get("how", "inner")
    # padding rows neither build nor probe; the probe keys are not null
    # (the predicate declines nullable keys)
    has = (found[0] != 0) & lv
    if how in ("semi", "anti"):
        # membership only: duplicate build keys change nothing
        keep = Column((~has & lv) if how == "anti" else has, dt.BOOL8, None)
        if table.logical_rows is None:
            return filter_table(table, keep)
        out, count = filter_table_capped(table, keep,
                                         capacity=table.row_count)
        return Table(out.columns, out.names, logical_rows=int(count))
    if dup:
        # the one-slot-per-key table holds one right row per key, so only
        # a unique-key build is byte-exact here
        raise KernelDecline("duplicate build-side keys")
    left_idx = torch.nonzero(has).flatten()
    total = left_idx.numel()
    if total == 0:
        raise KernelDecline("empty join result (exact path's schema)")
    right_idx = rrow[0][left_idx].to(torch.int64)
    cap = buckets.bucket_for(total) if padded else None
    if cap is None:
        return join_output(table, right, on, left_idx, right_idx, None)
    # the JAX tier's output bucket: slots past the total read row 0 of
    # both sides
    pad = torch.zeros(cap - total, dtype=torch.int64, device=left_idx.device)
    out = join_output(table, right, on, torch.cat([left_idx, pad]),
                      torch.cat([right_idx, pad]), None)
    return Table(out.columns, out.names, logical_rows=total)


# ---------------------------------------------------------------------------
# hash_groupby — chunked hash partials + one small exact merge
# ---------------------------------------------------------------------------


def _a_hash_groupby(op: dict, table: Table, rest) -> Optional[str]:
    by = op.get("by") or []
    if len(by) != 1:
        return "multi-column group key"
    aggs = op.get("aggs") or []
    if not aggs:
        return "no aggregations"
    bad = [a.get("agg") for a in aggs if a.get("agg") not in _AGG_OPS]
    if bad:
        return f"non-decomposable agg {bad[0]!r}"
    col = _resolve_col(table, by[0])
    if col is None:
        return "unresolvable group key column"
    r = _order_word_reason(col)
    if r is not None:
        return r
    for a in aggs:
        vc = _resolve_col(table, a.get("column"))
        if vc is None:
            return "unresolvable aggregation column"
        d = vc.dtype
        if d.is_string or d.is_decimal or d.is_floating or vc.data.ndim != 1:
            return f"{d.id.name} aggregation value (order-sensitive or multi-word)"
    if table.logical_row_count == 0:
        return "empty input"
    if _bucketed_rows(table) > GROUPBY_MAX_ROWS:
        return f"{table.row_count} rows over the int32 slot bound"
    return None


def _partial(acol: Column, aop: str, pid, ns: int, m) -> Column:
    """One aggregation's per-slot partial over the live rows ``m``, in
    ``ns + 1`` slots: slot ``ns``, which no row reaches, holds what an
    unused slot holds (no rows: count 0, sum 0, the extremes' sentinel,
    not valid)."""
    from ..ops import compute

    dev = pid.device

    def seg_sum(v):
        return torch.zeros(ns + 1, dtype=torch.int64, device=dev).index_add_(
            0, pid, v)

    if aop == "count":
        return Column(seg_sum(m.to(torch.int64)), dt.INT64)
    pv = seg_sum(m.to(torch.int64)) > 0
    vals = compute.values(acol)
    if aop == "sum":
        v = torch.where(m, vals.to(torch.int64), 0)
        return compute.from_values(seg_sum(v), dt.INT64, pv)
    is_min = aop == "min"
    if acol.dtype.is_boolean:
        work, sentinel = vals.to(torch.uint8), int(is_min)
    else:
        info = torch.iinfo(vals.dtype)
        work, sentinel = vals, info.max if is_min else info.min
    masked = torch.where(m, work, torch.full_like(work, sentinel))
    part = torch.full((ns + 1,), sentinel, dtype=work.dtype, device=dev)
    part = part.scatter_reduce(0, pid, masked, "amin" if is_min else "amax")
    if acol.dtype.is_boolean:
        part = part.to(torch.bool)
    return compute.from_values(part, acol.dtype, pv)


def _group_names(op: dict, table: Table) -> list:
    """The exact path's output names of a one-key groupby."""
    by0 = op["by"][0]
    names = table.names
    out = [by0 if isinstance(by0, str)
           else (names[by0] if names else "key0")]
    for a in op["aggs"]:
        ac = a["column"]
        base = ac if isinstance(ac, str) else (names[ac] if names else f"c{ac}")
        out.append(f"{a['agg']}_{base}")
    return out


_MERGE_OP = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def _r_hash_groupby(op: dict, table: Table, rest) -> Table:
    """The JAX tier's runner at the bucket length, and its bytes: the
    padding rows build nothing, and the exact capped groupby merges the
    C x S partial slots over the used ones into a result of the bucket's
    rows (the exact path's rows, unpadded, for a table without a
    bucket). The JAX package merges all C x S slots, the unused ones (each
    no rows, with row 0's key) sorting behind the used ones as one
    segment; one such slot in their place gives the same bytes, and the
    partials take only the logical rows (the padding's are the dropped
    slot's, and would pile onto one address)."""
    from ..ops import compute
    from ..ops.gather import gather_table
    from ..ops.groupby import GroupbyAgg, groupby_aggregate_capped
    from . import hash_table

    table = _bucketed_input(table)
    exact = table.logical_rows is None  # no bucket: an exact result
    by0 = op["by"][0]
    aggs = list(op["aggs"])
    b, n = table.row_count, table.logical_row_count
    t = min(GROUPBY_CHUNK_ROWS, _next_pow2(b))
    c = -(-b // t)
    s = 2 * t
    ns = c * s
    key_col = table.column(by0)
    lo, hi = _key_halves(key_col)
    rv = _occupancy(table)
    dev = lo.device

    def chunks(x):
        return torch.nn.functional.pad(x, (0, c * t - b)).reshape(c, t)

    slot, _, _, trow, ovf, _ = hash_table.build_table(
        chunks(lo[0]), chunks(hi[0]), chunks(rv.to(torch.int32)),
        table_slots=s)
    if int(ovf):
        raise KernelDecline("chunk hash table overflow")
    # every logical row holds a slot (no overflow): partial id chunk * S
    # + slot
    pid = (torch.arange(n, device=dev) // t) * s + slot.reshape(-1)[:n].to(
        torch.int64)
    trow_f = trow.reshape(-1).to(torch.int64)
    used = torch.nonzero(trow_f >= 0).flatten()
    # the used slots in slot order, then one unused slot (index ns)
    take = torch.cat([used, used.new_full((1,), ns)])
    rep = torch.cat([(used // s) * t + trow_f[used], used.new_zeros(1)])
    part_cols = [Column(key_col.data[rep], key_col.dtype, None)]
    rows = buckets.unpad_table(table)
    for a in aggs:
        acol = rows.column(a["column"])
        part = _partial(acol, a["agg"], pid, ns, compute.valid_mask(acol))
        part_cols.append(gather_table(Table([part]), take).columns[0])
    merged, num_groups = groupby_aggregate_capped(
        Table(part_cols), [0],
        [GroupbyAgg(i + 1, _MERGE_OP[a["agg"]]) for i, a in enumerate(aggs)],
        num_segments=b, row_valid=take < ns)
    out = Table(merged.columns, _group_names(op, table),
                logical_rows=int(num_groups))
    return buckets.unpad_table(out) if exact else out




# ---------------------------------------------------------------------------
# row_pack / row_unpack — the row <-> columnar transpose (K1a / K1b)
# ---------------------------------------------------------------------------


def _a_row_pack(op: dict, table: Table, rest) -> Optional[str]:
    for c in table.columns:
        if not c.dtype.is_fixed_width:
            return f"{c.dtype.id.name} column has no fixed-width row slot"
    return None


def _r_row_pack(op: dict, table: Table, rest) -> Table:
    from .. import rows as rows_mod

    return Table([rows_mod.to_rows_list(buckets.unpad_table(table))])


def _a_row_unpack(op: dict, table: Table, rest) -> Optional[str]:
    if not table.columns or table.columns[0].dtype.id != dt.TypeId.LIST:
        return "legacy flat row buffer (the exact path's route)"
    for tid in op.get("type_ids", ()):
        if dt.TypeId(int(tid)) not in dt._WIDTHS:
            return "non-fixed-width target schema"
    return None


def _r_row_unpack(op: dict, table: Table, rest) -> Table:
    from .. import rows as rows_mod

    schema = [dt.DType(dt.TypeId(t_), s_)
              for t_, s_ in zip(op["type_ids"], op["scales"])]
    return rows_mod.from_rows_list(buckets.unpad_table(table).columns[0],
                                   schema)


# ---------------------------------------------------------------------------
# the registry + dispatch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One accelerated inner loop: op coverage + predicate + runner."""

    name: str
    ops: Tuple[str, ...]
    applicable: Callable[[dict, Table, Sequence[Table]], Optional[str]]
    runner: Callable[[dict, Table, Sequence[Table]], Table]
    doc: str


_REGISTRY = {
    "packed_sort": KernelSpec(
        "packed_sort", ("sort_by",), _a_packed_sort, _r_packed_sort,
        "single-key ORDER BY through the bitonic network (K3)",
    ),
    "hash_build_probe": KernelSpec(
        "hash_build_probe", ("join",), _a_hash_join, _r_hash_join,
        "inner, semi and anti joins through the open-addressing table "
        "(K2a + K2b)",
    ),
    "hash_groupby": KernelSpec(
        "hash_groupby", ("groupby",), _a_hash_groupby, _r_hash_groupby,
        "chunked hash partial aggregation (K2a) + one small exact merge",
    ),
    "row_pack": KernelSpec(
        "row_pack", ("to_rows",), _a_row_pack, _r_row_pack,
        "columnar -> packed rows (K1a)",
    ),
    "row_unpack": KernelSpec(
        "row_unpack", ("from_rows",), _a_row_unpack, _r_row_unpack,
        "packed rows -> columnar (K1b)",
    ),
}

if KERNEL_NAMES != frozenset(_REGISTRY):
    raise RuntimeError("KERNEL_NAMES drifted from the registry")

_BY_OP: dict = {}
for _spec in _REGISTRY.values():
    for _op_name in _spec.ops:
        _BY_OP.setdefault(_op_name, []).append(_spec)


def decline_reason(kernel: str, op: dict, table: Table,
                   rest: Sequence[Table]) -> Optional[str]:
    """Why ``kernel`` declines this op, or None."""
    return _REGISTRY[kernel].applicable(op, table, rest)


def run_kernel(kernel: str, op: dict, table: Table,
               rest: Sequence[Table]) -> Table:
    """Run one entry's runner outside the gate and the counters (the row
    transpose, which has no other route)."""
    return _REGISTRY[kernel].runner(op, table, rest)


_GEN = -1
_MODE = "auto"


def tier_mode() -> str:
    """The ``KERNELS`` flag, re-read when the flag plane's generation
    moves (an unknown value raises ``ValueError``)."""
    global _GEN, _MODE
    g = config.generation()
    if g != _GEN:
        _MODE = config.get_flag("KERNELS")
        _GEN = g
    return _MODE


def _on_cuda(table: Table, rest: Sequence[Table]) -> bool:
    return any(c.data.is_cuda for t in (table, *rest) for c in t.columns[:1])


def _gate_open(table: Table, rest: Sequence[Table]) -> bool:
    mode = tier_mode()
    return mode == "on" or (mode == "auto" and _on_cuda(table, rest))


def routes(name: str, table: Table, rest: Sequence[Table] = ()) -> bool:
    """True when the tier's gate is open for these tables and an entry
    covers the op ``name`` (it may still decline the op)."""
    return bool(_BY_OP.get(name)) and _gate_open(table, rest)


def dispatch_kernel(
    op: dict, table: Table, rest: Sequence[Table], name: str
) -> Optional[Table]:
    """Run one op through the kernel tier. Returns the result Table, or
    None when the gate is closed, no kernel applies or the runner
    declined: the caller then runs the exact path. A fault that an armed
    ``FAULTS`` plan injects at the ``kernel`` site retries the same
    runner (``kernel.retries``, and a fallback on the profiler's segment,
    where the JAX package replays the op); a failure of the runner
    itself raises. Neither is replayed on the exact path. Each runner
    runs under a ``kernel.<name>`` span."""
    if not _gate_open(table, rest):
        return None
    for spec in _BY_OP.get(name, ()):
        if spec.applicable(op, table, rest) is not None:
            metrics.counter_add("kernel.declines")
            continue
        with metrics.span("kernel." + spec.name):
            try:
                # the ``kernel`` fault site: an injected fault fires
                # before the launch, so the retry is the same runner's
                # first launch
                faults.inject("kernel")
            except faults.FaultError:
                metrics.counter_add("kernel.retries")
                profiler.note_fallback("kernel")
            try:
                out = spec.runner(op, table, rest)
            except KernelDecline:
                metrics.counter_add("kernel.declines")
                continue
        metrics.counter_add("kernel.launches")
        return out
    return None
