"""Shape buckets and the runner cache (port of ``utils/buckets.py``).

Spark executors stream batches of one schema and ragged row counts. The
JAX package pads every batch to a small geometric ladder of row-count
buckets, so that its compiled executables are reused across sizes; the
port pads the same way and to the same buckets, so that both packages
give the same bytes, padding included, and so that every op of a ragged
stream sees O(#buckets) shapes (the precondition for replaying the
runners as CUDA graphs, a later step):

* **Bucket policy** — the ladder (default x2 from a 1024 floor, capped
  at 2^23 rows), set by ``SPARK_RAPIDS_TPU_BUCKETS``
  (``floor:growth[:cap]``, an explicit ``a,b,c`` list, or
  ``off|none|false|disabled|0``); a malformed spec raises
  :class:`ValueError` when it is read.
* **Pad / unpad** — :func:`pad_table` zero-pads every buffer of a table
  to its bucket and records the real count as ``Table.logical_rows``;
  :func:`unpad_table` slices it back. The bucketed runners
  (``bucketed.py``) mask the tail with :func:`tail_valid`.
* **Runner cache** — :func:`cached_jit` keys a runner's built callable
  on ``(op, schema signature, bucket)``, an LRU of 256 entries. PyTorch
  runs eagerly, so nothing compiles: an entry is the callable the
  runner built, and ``compile_cache.hit``/``compile_cache.miss`` count
  what the JAX package's executable cache counts for the same sequence
  of calls.

Metrics (with ``METRICS`` on): ``bucket.pad_tables``,
``bucket.pad_waste_bytes``, the histograms ``bucket.size`` and
``bucket.pad_rows``, ``compile_cache.hit``/``miss`` and the gauge
``compile_cache.size``.
"""

from __future__ import annotations

import dataclasses
import json
from collections import OrderedDict
from typing import Any, Callable, Optional, Tuple

import torch

from . import config, lockcheck, log, metrics

# default ladder: 1024, 2048, ... 2^23 rows; sizes above it run exact
DEFAULT_FLOOR = 1024
DEFAULT_GROWTH = 2
DEFAULT_CAP = 1 << 23

_OFF_VALUES = frozenset({"off", "none", "false", "disabled", "0"})


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    enabled: bool
    floor: int = DEFAULT_FLOOR
    growth: int = DEFAULT_GROWTH
    cap: int = DEFAULT_CAP
    explicit: Optional[Tuple[int, ...]] = None

    def buckets_upto(self, n: int) -> Tuple[int, ...]:
        """Every bucket the ladder can produce for sizes <= n."""
        if not self.enabled:
            return ()
        if self.explicit is not None:
            return tuple(b for b in self.explicit
                         if b <= max(n, self.explicit[0]))
        out = []
        b = self.floor
        while b <= self.cap:
            out.append(b)
            if b >= n:
                break
            b *= self.growth
        return tuple(out)


_OFF = BucketPolicy(enabled=False)


def _parse_spec(raw: str) -> BucketPolicy:
    got = raw.strip().lower()
    if not got:
        return BucketPolicy(enabled=True)
    if got in _OFF_VALUES:
        return _OFF
    try:
        if "," in got:
            sizes = sorted({int(p) for p in got.split(",") if p.strip()})
            if not sizes or sizes[0] <= 0:
                raise ValueError
            return BucketPolicy(enabled=True, floor=sizes[0], cap=sizes[-1],
                                explicit=tuple(sizes))
        parts = [int(p) for p in got.split(":")]
        if len(parts) == 1:
            floor, growth, cap = parts[0], DEFAULT_GROWTH, DEFAULT_CAP
        elif len(parts) == 2:
            floor, growth, cap = parts[0], parts[1], DEFAULT_CAP
        elif len(parts) == 3:
            floor, growth, cap = parts
        else:
            raise ValueError
        if floor <= 0 or growth < 2 or cap < floor:
            raise ValueError
        return BucketPolicy(enabled=True, floor=floor, growth=growth, cap=cap)
    except ValueError:
        raise ValueError(
            f"SPARK_RAPIDS_TPU_BUCKETS must be 'floor:growth[:cap]', an "
            f"explicit 'a,b,c' list, or off|none|0 — got {raw!r}"
        ) from None


# the policy is re-parsed only when the flag plane's generation moves
_POLICY: BucketPolicy = _OFF
_POLICY_GEN = -1
_POLICY_LOCK = lockcheck.make_lock("buckets.policy")


def policy() -> BucketPolicy:
    global _POLICY, _POLICY_GEN
    gen = config.generation()
    if _POLICY_GEN != gen:
        with _POLICY_LOCK:
            if _POLICY_GEN != gen:
                _POLICY = _parse_spec(str(config.get_flag("BUCKETS")))
                _POLICY_GEN = gen
    return _POLICY


def enabled() -> bool:
    """True when pad-to-bucket batching is on for the dispatch plane."""
    return policy().enabled


def bucket_for(n: int) -> Optional[int]:
    """Smallest bucket >= ``n``, or None when ``n`` has no bucket
    (bucketing off, an empty input, or past the ladder's cap: those run
    on the exact path)."""
    p = policy()
    if not p.enabled or n <= 0:
        return None
    if p.explicit is not None:
        for b in p.explicit:
            if b >= n:
                return b
        return None
    if n > p.cap:
        return None
    b = p.floor
    while b < n:
        b *= p.growth
    return b if b <= p.cap else None


# ---------------------------------------------------------------------------
# pad / unpad
# ---------------------------------------------------------------------------


def tail_valid(physical: int, n, device=None) -> torch.Tensor:
    """Row-occupancy mask of a padded buffer: True for the first ``n``
    of ``physical`` rows. ``n`` is a Python int or a device scalar (a
    fused segment's count, compared on its device without a host
    read)."""
    if isinstance(n, torch.Tensor):
        return torch.arange(physical, device=n.device) < n
    return torch.arange(physical, device=device) < int(n)


def _pad_tensor(x: Optional[torch.Tensor], target: int):
    """``x`` with its rows zero-extended to ``target``: one allocation of
    the bucket and one copy of the rows."""
    if x is None:
        return None
    out = torch.zeros((target,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[: x.shape[0]] = x
    return out


def pad_column(col, target: int):
    """Zero-pad one column's buffers to ``target`` rows (tail validity
    False, tail lengths 0)."""
    from ..column import Column

    n = col.row_count
    if n == target:
        return col
    if n > target:
        raise ValueError(f"cannot pad {n} rows down to {target}")
    return Column(_pad_tensor(col.data, target), col.dtype,
                  _pad_tensor(col.validity, target),
                  _pad_tensor(col.lengths, target))


def _record_pad_metrics(table, target: int, logical: int) -> None:
    """Pad accounting shared by :func:`pad_table` and the host-side wire
    padding (``runtime_bridge``): per-row bytes from the table's buffers
    over its physical rows, times the pad rows."""
    if not metrics.enabled():
        return
    from . import hbm

    extra = target - logical
    if extra > 0 and table.columns:
        per_row = -(-hbm.table_bytes(table) // max(table.row_count, 1))
        metrics.bytes_add("bucket.pad_waste_bytes", extra * per_row)
    metrics.counter_add("bucket.pad_tables")
    metrics.hist_observe("bucket.size", target)
    metrics.hist_observe("bucket.pad_rows", max(extra, 0))


def note_padded(table) -> None:
    """Record pad metrics for a table padded elsewhere (the wire entries
    pad on the host, before the upload)."""
    if table.logical_rows is not None:
        _record_pad_metrics(table, table.row_count, table.logical_rows)


def pad_table(table, target: Optional[int] = None):
    """Pad every column to ``target`` rows (default: the table's bucket)
    and carry the logical row count on the result. Returns the input
    unchanged when no bucket applies, and a table already padded to
    ``target`` or more as it is."""
    from ..column import Table

    n = table.logical_row_count
    if target is None:
        target = bucket_for(n)
        if target is None:
            return table
    if table.logical_rows is not None and table.row_count >= target:
        return table
    _record_pad_metrics(table, target, n)
    return Table([pad_column(c, target) for c in table.columns], table.names,
                 logical_rows=n)


def unpad_table(table):
    """Exact-shape view of a possibly padded table (row slices to the
    logical count; the input itself for an exact table)."""
    from ..column import Column, Table

    lr = table.logical_rows
    if lr is None:
        return table
    if lr == table.row_count:
        return Table(table.columns, table.names)
    return Table(
        [Column(c.data[:lr], c.dtype,
                None if c.validity is None else c.validity[:lr],
                None if c.lengths is None else c.lengths[:lr])
         for c in table.columns],
        table.names)


def table_signature(table) -> tuple:
    """Cache-key signature of a table: per column (type id, scale, matrix
    width, validity and lengths presence), plus the names."""
    cols = tuple(
        (int(c.dtype.id.value), int(c.dtype.scale),
         int(c.data.shape[1]) if c.data.dim() > 1 else 0,
         c.validity is not None, c.lengths is not None)
        for c in table.columns)
    return (cols, table.names)


def cache_key(kind: str, payload, tables, extra: tuple = ()) -> tuple:
    """The runner cache's key: ``(kind, canonical payload JSON, per-table
    schema signatures, per-table physical row counts, extra)``."""
    return (kind, json.dumps(payload, sort_keys=True),
            tuple(table_signature(t) for t in tables),
            tuple(t.row_count for t in tables), extra)


# ---------------------------------------------------------------------------
# the runner cache
# ---------------------------------------------------------------------------

CACHE_CAPACITY = 256

_CACHE_LOCK = lockcheck.make_lock("buckets.cache")
_CACHE: "OrderedDict[tuple, Any]" = OrderedDict()


def cached_jit(key: tuple, build: Callable[[], Callable], name: str):
    """The callable cached under ``key``; ``build`` makes it on a miss
    and ``name`` becomes its ``__name__``. The name is the JAX
    package's: the port builds a Python callable and compiles nothing."""
    with _CACHE_LOCK:
        fn = _CACHE.get(key)
        if fn is not None:
            _CACHE.move_to_end(key)
    if fn is not None:
        metrics.counter_add("compile_cache.hit")
        return fn
    from . import faults

    faults.inject("compile")
    raw = build()
    raw.__name__ = name
    raw.__qualname__ = name
    with _CACHE_LOCK:
        cur = _CACHE.setdefault(key, raw)
        won = cur is raw
        if won:
            while len(_CACHE) > CACHE_CAPACITY:
                _CACHE.popitem(last=False)
        size = len(_CACHE)
    if won:
        metrics.counter_add("compile_cache.miss")
        metrics.gauge_set("compile_cache.size", size)
        if log.enabled("DEBUG", "buckets"):
            log.log("DEBUG", "buckets", "compile_cache_miss", name=name,
                    size=size)
    else:
        metrics.counter_add("compile_cache.hit")
    return cur


def cache_stats() -> dict:
    with _CACHE_LOCK:
        return {"size": len(_CACHE), "capacity": CACHE_CAPACITY}


def cache_clear() -> None:
    """Drop every cached entry (test isolation)."""
    with _CACHE_LOCK:
        _CACHE.clear()
