"""Bucketed op runners: the dispatch plane's pad-to-bucket path (port of
``bucketed.py``).

``runtime_bridge._dispatch_once`` offers every op to the kernel tier,
then to :func:`dispatch_bucketed`, then runs the exact path on
unpadded inputs. A runner

1. pads its input tables to their row-count buckets
   (``utils/buckets.pad_table``; wire uploads arrive padded on the host,
   so this is usually nothing),
2. takes the op's callable from the ``(op, schema signature, bucket)``
   cache (``utils/buckets.cached_jit``: the JAX package's executable
   cache, its hit and miss counts included; nothing compiles here),
3. runs the op at the BUCKET length, the padding rows masked with the
   ``row_valid`` occupancy of the capped ops (``groupby_aggregate_capped``,
   ``match_ranges``' ``left_valid``/``right_valid``, ``sort_table``'s and
   ``distinct_capped``'s ``row_valid``),
4. returns a PADDED result that carries ``Table.logical_rows``: the wire
   boundary slices it on the host, and the next bucketed op reads it as
   it is.

For the first ``logical_rows`` rows the result has the exact path's
bytes; the padding rows hold what the JAX package's runners leave there
(zeros, or clones of kept rows after a capped filter), which an op that
reads past a group's rows (``first``, a LEFT join's unmatched row) shows.
A shape without a bucket (``_Decline``) or a runner that fails runs the
op again on the exact path, on unpadded inputs: the JAX package's
semantics, under which bucketing changes shapes, never results.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import dtype as dt
from .column import Column, Table
from .utils import buckets, log, metrics


class _Decline(Exception):
    """This op or shape opts out of bucketing (the exact path runs)."""


_WARNED_OPS = set()


def _warn_once(name: str, event: str, e: Exception) -> None:
    if name not in _WARNED_OPS:
        _WARNED_OPS.add(name)
        log.log("WARN", "buckets", event, op=name,
                error=f"{type(e).__name__}: {str(e)[:200]}")


def dispatch_bucketed(op: dict, table: Table, rest: Sequence[Table],
                      name: str) -> Optional[Table]:
    """Run one op through the bucket plane. Returns the (possibly padded)
    result, or None when the op or shape is not bucketable or the runner
    failed: the caller then runs the exact path on unpadded inputs."""
    runner = _RUNNERS.get(name)
    if runner is None:
        return None
    with metrics.span("bucketed." + name):
        try:
            out = runner(op, table, tuple(rest))
        except _Decline:
            metrics.counter_add("bucket.declined")
            return None
        except Exception as e:  # the exact path raises the op's own error
            metrics.counter_add("bucket.fallback_errors")
            _warn_once(name, "bucketed_runner_failed", e)
            return None
    metrics.counter_add("bucket.dispatched")
    return out


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------


def _padded_input(t: Table) -> Table:
    """The bucketed view of an input: a padded table as it is (its
    physical size keys the cache), an exact one padded to its bucket; a
    size without a bucket declines."""
    n = t.logical_row_count
    if n <= 0:
        raise _Decline
    if t.logical_rows is not None:
        return t
    b = buckets.bucket_for(n)
    if b is None:
        raise _Decline
    return buckets.pad_table(t, b)


def _strip(t: Table) -> Table:
    """The table without its logical count (the count travels apart)."""
    return Table(t.columns, t.names)


def _n_dev(t: Table) -> int:
    """The logical row count: a Python int (the JAX package passes it as
    a device scalar, so that one executable serves every count of a
    bucket)."""
    return int(t.logical_row_count)


def _finish(padded_out: Table, logical) -> Table:
    return Table(padded_out.columns, padded_out.names,
                 logical_rows=int(logical))


def _key(kind: str, op: dict, *tables: Table, extra: tuple = ()) -> tuple:
    return buckets.cache_key(kind, op, tables, extra)


def _device(t: Table):
    return t.columns[0].data.device if t.columns else None


def _gate(mask: Column, rv: torch.Tensor) -> Column:
    """The filter mask with the occupancy applied: the tail of a padded
    table may hold clones of kept rows, and padding strings are empty."""
    return Column(mask.data.to(torch.bool) & rv, mask.dtype, mask.validity)


# ---------------------------------------------------------------------------
# the op bodies of the runners and of the plan's fused segments: each
# takes (op, padded table, logical count, occupancy) and returns (table at
# the same physical length, new logical count). A per-op runner gives the
# count as a Python int and the body may read the host once more (the
# prefix shortcuts of ``lexsort_occupied`` and of a prefix-occupied
# distinct, the groupby's segment count);
# a fused segment gives it as a device scalar and the body reads nothing
# (``plan._run_fused``). Both forms give the same bytes, padding included.
# ---------------------------------------------------------------------------


def _do_cast(op, t, n, rv):
    from .ops.cast import cast

    ci = int(op["column"])
    target = dt.DType(dt.TypeId(op["type_id"]), op.get("scale", 0))
    cols = list(t.columns)
    cols[ci] = cast(t.columns[ci], target)
    return Table(cols, t.names), n


def _do_filter(op, t, n, rv):
    from .ops.filter import filter_table_capped

    mi = int(op["mask"])
    kept = Table([c for i, c in enumerate(t.columns) if i != mi])
    return filter_table_capped(kept, _gate(t.columns[mi], rv),
                               capacity=t.row_count)


def _do_rlike(op, t, n, rv):
    from .ops.filter import filter_table_capped
    from .ops.regex import contains_re

    mask = contains_re(t.columns[int(op["column"])], op["pattern"])
    return filter_table_capped(t, _gate(mask, rv), capacity=t.row_count)


def _do_distinct(op, t, n, rv):
    from .ops.compaction import _distinct_capped

    return _distinct_capped(t, op.get("keys"), t.row_count, rv, n)


def _do_sort(op, t, n, rv):
    from .ops.sort import SortKey, _sort_occupied

    ks = [SortKey(k["column"], ascending=k.get("ascending", True))
          for k in op["keys"]]
    return _sort_occupied(t, ks, rv, n), n


def _do_groupby(op, t, n, rv):
    from .ops.groupby import GroupbyAgg, _groupby_capped

    aggs = [GroupbyAgg(a["column"], a["agg"]) for a in op["aggs"]]
    return _groupby_capped(t, list(op["by"]), aggs, t.row_count, rv, n)


def _single(kind: str, body, name: str):
    """A runner of one single-table op: pad, take the cached callable,
    run it at the bucket length."""

    def runner(op: dict, table: Table, rest) -> Table:
        pt = _padded_input(table)

        def build():
            def fn(t, n):
                return body(op, t, n, buckets.tail_valid(t.row_count, n,
                                                         _device(t)))

            return fn

        fn = buckets.cached_jit(_key(kind, op, pt), build, name)
        out, count = fn(_strip(pt), _n_dev(pt))
        return _finish(out, int(count))

    return runner


def _r_groupby(op: dict, table: Table, rest) -> Table:
    from .ops.groupby import _COLLECT_OPS

    if any(a["agg"] in _COLLECT_OPS for a in op["aggs"]):
        # collect_* sizes its LIST pad from the data: the exact path's
        raise _Decline
    return _single("groupby", _do_groupby, "srt_bucketed_groupby")(
        op, table, rest)


_BUCKETED_JOIN_HOWS = frozenset({"inner", "left", "semi", "anti"})


def _r_join(op: dict, table: Table, rest) -> Table:
    from .ops.join import _expand, _left_emit, join_output, match_ranges

    how = op.get("how", "inner")
    if how not in _BUCKETED_JOIN_HOWS or not rest:
        raise _Decline  # right/full join on the exact machinery
    lt = _padded_input(table)
    rt = _padded_input(rest[0])
    on = list(op["on"])

    def occupancy(lt_, rt_, ln, rn):
        return (buckets.tail_valid(lt_.row_count, ln, _device(lt_)),
                buckets.tail_valid(rt_.row_count, rn, _device(rt_)))

    if how in ("semi", "anti"):
        anti = how == "anti"

        def build_sa():
            def fn(l, r, ln, rn):
                from .ops.filter import filter_table_capped

                lv, rv = occupancy(l, r, ln, rn)
                _, _, counts = match_ranges(l, r, on, on, lv, rv)
                has = counts > 0  # zero for null keys and padding rows
                # a null-key row matches nothing and ANTI keeps it;
                # padding rows are kept by neither
                keep = (~has & lv) if anti else has
                return filter_table_capped(
                    l, Column(keep, dt.BOOL8, None), capacity=l.row_count)

            return fn

        fn = buckets.cached_jit(_key("join." + how, op, lt, rt), build_sa,
                                "srt_bucketed_join_" + how)
        out, count = fn(_strip(lt), _strip(rt), _n_dev(lt), _n_dev(rt))
        return _finish(out, int(count))

    # inner/left: the probe per input bucket pair, the materialisation
    # per output bucket
    def build_probe():
        def fn(l, r, ln, rn):
            lv, rv = occupancy(l, r, ln, rn)
            perm_r, lo, counts = match_ranges(l, r, on, on, lv, rv)
            return (perm_r, lo, counts, counts.sum(),
                    _left_emit(counts, lv).sum())

        return fn

    p1 = buckets.cached_jit(_key("join.ranges", {"on": on}, lt, rt),
                            build_probe, "srt_bucketed_join_probe")
    perm_r, lo, counts, inner_total, left_total = p1(
        _strip(lt), _strip(rt), _n_dev(lt), _n_dev(rt))
    total = int(left_total if how == "left" else inner_total)
    cap = buckets.bucket_for(total)
    if cap is None:
        # no output bucket (an empty result, or a fan-out past the
        # ladder's cap): the exact path owns those shapes
        raise _Decline
    left_outer = how == "left"

    def build_mat():
        def fn(l, r, perm_r, lo, counts, ln):
            if left_outer:
                lv = buckets.tail_valid(l.row_count, ln, _device(l))
                left_idx, right_idx, matched, _ = _expand(
                    perm_r, lo, counts, cap, _left_emit(counts, lv))
                return join_output(l, r, on, left_idx, right_idx, matched)
            # rows past the total are garbage behind the logical count
            left_idx, right_idx, _, _ = _expand(perm_r, lo, counts, cap)
            return join_output(l, r, on, left_idx, right_idx, None)

        return fn

    p2 = buckets.cached_jit(
        _key("join.mat." + how, {"on": on}, lt, rt, extra=(cap,)),
        build_mat, "srt_bucketed_join_mat")
    out = p2(_strip(lt), _strip(rt), perm_r, lo, counts, _n_dev(lt))
    return _finish(out, total)


_RUNNERS = {
    "cast": _single("cast", _do_cast, "srt_bucketed_cast"),
    "filter": _single("filter", _do_filter, "srt_bucketed_filter"),
    "sort_by": _single("sort_by", _do_sort, "srt_bucketed_sort"),
    "groupby": _r_groupby,
    "distinct": _single("distinct", _do_distinct, "srt_bucketed_distinct"),
    "rlike": _single("rlike", _do_rlike, "srt_bucketed_rlike"),
    "join": _r_join,
}


def is_bucketable(op: dict) -> bool:
    """Could this op take the bucketed path at all? The wire entries pad
    an upload only for such an op (another would unpad at once)."""
    name = op.get("op")
    if name not in _RUNNERS:
        return False
    if name == "join":
        return op.get("how", "inner") in _BUCKETED_JOIN_HOWS
    if name == "groupby":
        from .ops.groupby import _COLLECT_OPS

        return not any(a.get("agg") in _COLLECT_OPS
                       for a in op.get("aggs", ()))
    return True
