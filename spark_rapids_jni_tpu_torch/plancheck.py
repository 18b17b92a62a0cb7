"""Host-only plan check (port of the part of ``plancheck.py`` the port's
entries run).

Before any upload or donation, :func:`check_plan` walks a plan's JSON op
list against the input schema (from the wire: :func:`schema_from_wire`;
from a resident table: :func:`schema_of_table`), infers each op's output
schema with the JAX package's rules and raises :class:`PlanCheckError`
naming the first op that statically cannot run, with the JAX package's
index, op name and reason. Like the reference it is permissive: only
what is certain to raise is refused, and a walk whose schema is unknown
checks structure only.

The rules are those of every op the JAX package dispatches.
:func:`analyze` also tags each op with its support tier (``fusable``,
``per-op``, ``exact-only``, ``unsupported``, with a reason: the
``GpuOverrides`` tag) and with the kernel of the PORT's kernel tier
(``kernels/registry.py``) that it is statically eligible for, predicts
the fusion segments (:func:`predict_segments`, the runner's own rule)
and bounds each segment's device-memory working set
(``est_hbm_bytes``, the plan's ``est_hbm_peak_bytes``) from the row
bounds and nominal row widths. :func:`render_report` is the report's
human form (``tools/explain.py --static``), the JAX package's text.

The kernel tag predicts the port's tier, which differs from the JAX
one: it needs no bucket and has no VMEM bounds, so a sort or a build
over 2^16 rows keeps its tag; what it declines statically besides the
JAX package's reasons is an empty input and a row bound past its int32
slot and row ids.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import dtype as dt

__all__ = ["ColType", "PlanCheckError", "schema_from_wire",
           "schema_of_table", "predict_segments", "analyze", "check_plan",
           "render_report"]


@dataclasses.dataclass(frozen=True)
class ColType:
    """Static column signature: type id + decimal scale + LIST child id
    (the wire's scale slot carries a LIST's child type id)."""

    id: dt.TypeId
    scale: int = 0
    child: Optional[dt.TypeId] = None

    @property
    def is_fixed_width(self) -> bool:
        return self.id in dt._WIDTHS

    @property
    def is_string(self) -> bool:
        return self.id == dt.TypeId.STRING

    @property
    def is_list(self) -> bool:
        return self.id == dt.TypeId.LIST

    @property
    def is_decimal(self) -> bool:
        return self.id in dt._DECIMAL_IDS

    @property
    def is_integer(self) -> bool:
        return self.id in dt._SIGNED_INT_IDS or self.id in dt._UNSIGNED_INT_IDS

    @property
    def is_floating(self) -> bool:
        return self.id in dt._FLOAT_IDS

    @property
    def is_boolean(self) -> bool:
        return self.id == dt.TypeId.BOOL8

    def pretty(self) -> str:
        if self.is_list:
            child = self.child.name if self.child is not None else "?"
            return f"LIST<{child}>"
        if self.is_decimal and self.scale:
            return f"{self.id.name}(scale={self.scale})"
        return self.id.name

    def to_json(self) -> dict:
        return {
            "type_id": int(self.id),
            "scale": int(self.scale),
            "child": int(self.child) if self.child is not None else None,
            "pretty": self.pretty(),
        }


def schema_from_wire(type_ids: Sequence[int],
                     scales: Sequence[int]) -> List[ColType]:
    """Schema signature from the wire's parallel (type_ids, scales)."""
    out: List[ColType] = []
    for tid, scale in zip(type_ids, scales):
        tid = dt.TypeId(int(tid))
        if tid == dt.TypeId.LIST:
            out.append(ColType(tid, 0, dt.TypeId(int(scale))))
        else:
            out.append(ColType(tid, int(scale)))
    return out


def schema_of_table(table) -> List[ColType]:
    """Schema signature of a live table (the resident entry's input)."""
    out: List[ColType] = []
    for col in table.columns:
        d = col.dtype
        if d.id == dt.TypeId.LIST:
            out.append(ColType(d.id, 0, col.list_child_dtype.id))
        else:
            out.append(ColType(d.id, int(d.scale)))
    return out


class PlanCheckError(ValueError):
    """A plan that statically cannot run: the op index, op name and
    reason, and the report of the walk so far."""

    def __init__(self, index: int, op_name, reason: str, plan_report=None):
        self.index = index
        self.op_name = op_name
        self.reason = reason
        self.plan_report = plan_report
        super().__init__(f"plancheck: op[{index}] {op_name!r}: {reason}")


class _Reject(Exception):
    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(reason)


# nominal per-row byte widths of the variable-width layouts, for the
# footprint ESTIMATE only (never a support decision): a string is a
# padded byte matrix plus a length, a list a child run plus a length
_STRING_EST_BYTES = 20
_LIST_EST_ELEMS = 8


def _col_width(col: ColType) -> int:
    w = dt._WIDTHS.get(col.id)
    if w is not None:
        return w
    if col.is_string:
        return _STRING_EST_BYTES
    if col.is_list:
        cw = dt._WIDTHS.get(col.child, 8) if col.child is not None else 8
        return cw * _LIST_EST_ELEMS + 4
    return 8


def _row_width(schema: Optional[List[ColType]]) -> Optional[int]:
    if schema is None:
        return None
    return sum(_col_width(c) for c in schema)


def _col_index(op: dict, key: str, schema, *, what: str) -> int:
    if key not in op:
        raise _Reject(f"missing required field {key!r}")
    ref = op[key]
    if isinstance(ref, bool) or not isinstance(ref, int):
        raise _Reject(f"{what} must be an integer column index, got {ref!r}")
    if schema is not None and not 0 <= ref < len(schema):
        raise _Reject(f"{what} index {ref} out of range for "
                      f"{len(schema)}-column input")
    return ref


def _key_ref(ref, schema, names, *, what: str) -> Optional[int]:
    """A key given as an index or a name; None when it cannot be
    resolved statically."""
    if isinstance(ref, bool):
        raise _Reject(f"{what} must be a column index or name, got {ref!r}")
    if isinstance(ref, int):
        if schema is not None and not 0 <= ref < len(schema):
            raise _Reject(f"{what} index {ref} out of range for "
                          f"{len(schema)}-column input")
        return ref
    if isinstance(ref, str):
        if schema is None:
            return None
        if not names:
            raise _Reject(f"column name {ref!r} on an unnamed table")
        if ref not in names:
            raise _Reject(f"unknown column name {ref!r}")
        return list(names).index(ref)
    raise _Reject(f"{what} must be a column index or name, got {ref!r}")


def _dtype_str(c: ColType) -> str:
    if c.is_decimal:
        return f"DType({c.id.name}, scale={c.scale})"
    return f"DType({c.id.name})"


def _cast_ok(src: ColType, to: ColType) -> Optional[str]:
    """None when the JAX package's cast takes ``src`` -> ``to``, else its
    refusal."""
    to_d, src_d = _dtype_str(to), _dtype_str(src)
    if src.is_string or to.is_string:
        if src.is_string:
            ok = (to.is_boolean or to.is_integer or to.is_floating
                  or to.is_decimal or to.is_string)
            return None if ok else f"cast STRING -> {to_d} not supported"
        ok = src.is_boolean or src.is_integer or src.is_decimal or src.is_floating
        return None if ok else f"cast {src_d} -> STRING not supported"
    if src.id == to.id and src.scale == to.scale:
        return None
    if to.id == dt.TypeId.DECIMAL128:
        if src.is_decimal or src.is_integer:
            return None
        return f"cannot cast {src_d} to DECIMAL128"
    if src.id == dt.TypeId.DECIMAL128:
        if to.is_decimal or to.is_floating or to.is_integer or to.is_boolean:
            return None
        return f"cannot cast DECIMAL128 to {to_d}"
    if not src.is_fixed_width or not to.is_fixed_width:
        return f"cast {src_d} -> {to_d} not supported"
    return None


_LIST_CHILD_IDS = frozenset({
    dt.TypeId.INT8, dt.TypeId.INT16, dt.TypeId.INT32, dt.TypeId.INT64,
    dt.TypeId.UINT8, dt.TypeId.UINT16, dt.TypeId.UINT32, dt.TypeId.UINT64,
    dt.TypeId.FLOAT32, dt.TypeId.BOOL8,
})


def _agg_out(agg: str, col: ColType) -> ColType:
    """An aggregation's output type (ops/groupby.py's rules)."""
    i64 = ColType(dt.TypeId.INT64)
    if agg == "count":
        return i64
    if col.is_string:
        raise _Reject(f"aggregation {agg!r} not supported on STRING values")
    if col.is_list:
        raise _Reject(f"aggregation {agg!r} not supported on LIST values")
    if agg == "nunique":
        if col.id == dt.TypeId.DECIMAL128:
            raise _Reject("nunique not supported for DECIMAL128")
        return i64
    if agg in ("first", "last", "min", "max"):
        return col
    if agg in ("collect_list", "collect_set"):
        if col.id not in _LIST_CHILD_IDS:
            raise _Reject(
                f"{agg} not supported for DType({col.id.name}) (LIST "
                "children are int8..64, uint8..64, float32, bool)")
        return ColType(dt.TypeId.LIST, 0, col.id)
    if agg == "sum":
        if col.is_floating:
            return ColType(dt.TypeId.FLOAT64)
        if col.id in (dt.TypeId.DECIMAL32, dt.TypeId.DECIMAL64):
            return ColType(dt.TypeId.DECIMAL64, col.scale)
        if col.id == dt.TypeId.DECIMAL128:
            return ColType(dt.TypeId.DECIMAL128, col.scale)
        return i64
    if agg in ("mean", "variance", "std"):
        return ColType(dt.TypeId.FLOAT64)
    raise _Reject(f"unknown aggregation {agg!r}")


class _State:
    """The flowing schema, names and row bound, and the extra tables of
    the multi-table ops, taken as ``plan._take_rest`` takes them: an
    explicit ``rest`` index list, else a join or cross join the next one
    and a concat all that are left."""

    def __init__(self, schema, names, rows, rest):
        self.schema = schema
        self.names = names
        self.rows = rows
        self.orig_rest: List[Tuple] = list(rest)
        self.queue: List[Tuple] = list(rest)

    def take_rest(self, op: dict) -> List[Tuple]:
        from .plan import _take_rest

        try:
            return _take_rest(op, tuple(self.orig_rest), self.queue)
        except (IndexError, TypeError, ValueError):
            raise _Reject(f"'rest' indices {op.get('rest')!r} out of range "
                          f"for {len(self.orig_rest)} extra tables") from None


def _r_cast(op, st):
    ci = _col_index(op, "column", st.schema, what="cast column")
    if "type_id" not in op:
        raise _Reject("missing required field 'type_id'")
    try:
        target_id = dt.TypeId(int(op["type_id"]))
    except (ValueError, TypeError):
        raise _Reject(f"unknown type_id {op.get('type_id')!r}") from None
    scale = op.get("scale", 0)
    if not isinstance(scale, int) or isinstance(scale, bool):
        raise _Reject(f"cast scale must be an integer, got {scale!r}")
    if scale != 0 and target_id not in dt._DECIMAL_IDS:
        raise _Reject(f"non-zero scale on non-decimal type {target_id!r}")
    target = ColType(target_id, scale)
    if st.schema is None:
        return None, None, st.rows
    why = _cast_ok(st.schema[ci], target)
    if why is not None:
        raise _Reject(why)
    out = list(st.schema)
    out[ci] = target
    return out, st.names, st.rows


def _r_filter(op, st):
    mi = _col_index(op, "mask", st.schema, what="filter mask")
    if st.schema is None:
        return None, None, st.rows
    if not st.schema[mi].is_boolean:
        raise _Reject(f"filter mask must be BOOL8, got {st.schema[mi].pretty()}")
    out = [c for i, c in enumerate(st.schema) if i != mi]
    if not out:
        raise _Reject("filter would leave a zero-column table")
    return out, None, st.rows


def _r_rlike(op, st):
    ci = _col_index(op, "column", st.schema, what="rlike column")
    pat = op.get("pattern")
    if not isinstance(pat, str):
        raise _Reject(f"rlike pattern must be a string, got {pat!r}")
    if st.schema is None:
        return None, None, st.rows
    if not st.schema[ci].is_string:
        raise _Reject(
            f"rlike expected a STRING column, got {st.schema[ci].pretty()}")
    return list(st.schema), st.names, st.rows


def _r_explode(op, st):
    ci = _col_index(op, "column", st.schema, what="explode column")
    if st.schema is None:
        return None, None, None  # output rows are data-dependent
    col = st.schema[ci]
    if not col.is_list:
        raise _Reject(f"explode expected a LIST column, got {col.pretty()}")
    out = list(st.schema)
    out[ci] = ColType(col.child if col.child is not None else dt.TypeId.INT64)
    return out, st.names, None


def _r_sort_by(op, st):
    keys = op.get("keys")
    if not isinstance(keys, list) or not keys:
        raise _Reject("sort_by needs a non-empty 'keys' list")
    for k in keys:
        if not isinstance(k, dict) or "column" not in k:
            raise _Reject(f"sort_by key must be {{'column': ...}}, got {k!r}")
        _key_ref(k["column"], st.schema, st.names, what="sort_by key")
    if st.schema is None:
        return None, None, st.rows
    return list(st.schema), st.names, st.rows


def _r_distinct(op, st):
    keys = op.get("keys")
    if keys is not None:
        if not isinstance(keys, list):
            raise _Reject(f"distinct 'keys' must be a list, got {keys!r}")
        for k in keys:
            _key_ref(k, st.schema, st.names, what="distinct key")
    if st.schema is None:
        return None, None, st.rows
    return list(st.schema), st.names, st.rows


def _r_slice(op, st):
    start, stop = op.get("start", 0), op.get("stop")
    try:
        start_i = int(start)
        stop_i = None if stop is None else int(stop)
    except (TypeError, ValueError):
        raise _Reject(f"slice bounds must be integers, got start={start!r} "
                      f"stop={stop!r}") from None
    if start_i < 0 or (stop_i is not None and stop_i < 0):
        raise _Reject("slice: negative bounds not supported "
                      f"(start={start_i}, stop={stop_i})")
    rows = st.rows
    if rows is not None:
        hi = rows if stop_i is None else min(stop_i, rows)
        rows = max(0, hi - min(start_i, rows))
    elif stop_i is not None:
        rows = max(0, stop_i - start_i)
    if st.schema is None:
        return None, None, rows
    return list(st.schema), st.names, rows


def _r_cross_join(op, st):
    rest = st.take_rest(op)
    if not rest:
        raise _Reject("cross_join needs two input tables")
    r_schema, r_rows = rest[0]
    rows = None
    if st.rows is not None and r_rows is not None:
        rows = st.rows * r_rows
    if st.schema is None or r_schema is None:
        return None, None, rows
    return list(st.schema) + list(r_schema), None, rows


def _r_concat(op, st):
    rest = st.take_rest(op)
    rows = st.rows
    out = list(st.schema) if st.schema is not None else None
    for r_schema, r_rows in rest:
        rows = (rows + r_rows if rows is not None and r_rows is not None
                else None)
        if out is None or r_schema is None:
            out = None
            continue
        if len(r_schema) != len(out):
            raise _Reject("concatenate: column counts differ "
                          f"({len(out)} vs {len(r_schema)})")
        for a, b in zip(out, r_schema):
            if (a.id, a.scale, a.child) != (b.id, b.scale, b.child):
                raise _Reject(f"concatenate dtype mismatch: {a.pretty()} vs "
                              f"{b.pretty()}")
    return out, (st.names if out is not None else None), rows


def _r_repeat(op, st):
    count = op.get("count")
    if isinstance(count, bool) or not isinstance(count, int):
        raise _Reject(f"repeat count must be an integer, got {count!r}")
    if count < 0:
        raise _Reject("repeat: count must be non-negative")
    rows = st.rows * count if st.rows is not None else None
    if st.schema is None:
        return None, None, rows
    return list(st.schema), st.names, rows


def _r_sample(op, st):
    n = op.get("n")
    if isinstance(n, bool) or not isinstance(n, int):
        raise _Reject(f"sample n must be an integer, got {n!r}")
    if n < 0:
        raise _Reject(f"sample n must be non-negative, got {n}")
    # n past the rows without replacement is a run-time error: the live
    # row count after a filter is data-dependent
    if st.schema is None:
        return None, None, n
    return list(st.schema), st.names, n


_KNOWN_AGGS = frozenset({
    "sum", "count", "min", "max", "mean", "variance", "std", "collect_list",
    "collect_set", "nunique", "first", "last",
})


def _r_groupby(op, st):
    by = op.get("by")
    if not isinstance(by, list) or not by:
        raise _Reject("groupby needs a non-empty 'by' list")
    aggs = op.get("aggs")
    if not isinstance(aggs, list):
        raise _Reject("groupby needs an 'aggs' list")
    key_idx = [_key_ref(b, st.schema, st.names, what="groupby 'by' column")
               for b in by]
    specs = []
    for a in aggs:
        if not isinstance(a, dict) or "column" not in a or "agg" not in a:
            raise _Reject("groupby agg must be {'column': ..., 'agg': ...}, "
                          f"got {a!r}")
        if a["agg"] not in _KNOWN_AGGS:
            raise _Reject(f"unknown aggregation {a!r}")
        specs.append((_key_ref(a["column"], st.schema, st.names,
                               what="groupby agg column"), a["agg"]))
    if st.schema is None:
        return None, None, st.rows
    out = [st.schema[i] for i in key_idx]
    out.extend(_agg_out(agg, st.schema[ci]) for ci, agg in specs)
    return out, None, st.rows


_JOIN_HOWS = frozenset({"inner", "left", "right", "full", "semi", "anti"})


def _r_join(op, st):
    how = op.get("how", "inner")
    if how not in _JOIN_HOWS:
        raise _Reject(f"unknown join how={how!r}")
    rest = st.take_rest(op)
    if not rest:
        raise _Reject("join needs two input tables")
    on = op.get("on")
    if on is None:
        raise _Reject("missing required field 'on'")
    on = on if isinstance(on, list) else [on]
    left_idx = [_key_ref(c, st.schema, st.names, what="join 'on' column")
                for c in on]
    r_schema, r_rows = rest[0]
    right_idx = None
    if r_schema is not None:
        right_idx = []
        for c in on:
            if isinstance(c, int) and not isinstance(c, bool):
                if not 0 <= c < len(r_schema):
                    raise _Reject(f"join 'on' index {c} out of range for "
                                  f"{len(r_schema)}-column right table")
                right_idx.append(c)
            else:
                right_idx = None
                break
    if (how in ("right", "full") and st.schema is not None
            and right_idx is not None and None not in left_idx):
        for li, ri in zip(left_idx, right_idx):
            lt, rt = st.schema[li], r_schema[ri]
            if (lt.id, lt.scale) != (rt.id, rt.scale):
                raise _Reject("outer-join key dtypes differ: "
                              f"{lt.pretty()} vs {rt.pretty()}")
    rows = None
    if st.rows is not None and r_rows is not None:
        rows = st.rows if how in ("semi", "anti") else st.rows * r_rows
    if how in ("semi", "anti"):
        return (list(st.schema) if st.schema is not None else None,
                st.names, rows)
    if st.schema is None or r_schema is None or right_idx is None:
        return None, None, rows
    out = list(st.schema)
    out.extend(c for i, c in enumerate(r_schema) if i not in set(right_idx))
    return out, None, rows


def _r_to_rows(op, st):
    if st.schema is None:
        return None, None, st.rows
    if not st.schema:
        raise _Reject("row format requires at least one column")
    for c in st.schema:
        if not c.is_fixed_width:
            raise _Reject("only fixed-width types supported in row format "
                          f"(got {c.pretty()})")
    return [ColType(dt.TypeId.LIST, 0, dt.TypeId.UINT8)], None, st.rows


def _r_from_rows(op, st):
    tids, scales = op.get("type_ids"), op.get("scales")
    if not isinstance(tids, list) or not isinstance(scales, list):
        raise _Reject("from_rows needs 'type_ids' and 'scales' lists")
    if len(tids) != len(scales):
        raise _Reject(f"from_rows type_ids/scales length mismatch "
                      f"({len(tids)} vs {len(scales)})")
    if not tids:
        raise _Reject("row format requires at least one column")
    out: List[ColType] = []
    for t, s in zip(tids, scales):
        try:
            tid = dt.TypeId(int(t))
        except (ValueError, TypeError):
            raise _Reject(f"unknown type_id {t!r} in from_rows") from None
        if tid not in dt._WIDTHS:
            raise _Reject("only fixed-width types supported in row format "
                          f"(got {tid.name})")
        if s != 0 and tid not in dt._DECIMAL_IDS:
            raise _Reject(f"non-zero scale on non-decimal type {tid!r}")
        out.append(ColType(tid, int(s)))
    if st.schema is not None:
        first = st.schema[0] if st.schema else None
        if first is not None and not (first.is_list
                                      or first.id == dt.TypeId.UINT8):
            raise _Reject("from_rows input must be a LIST<UINT8> row column "
                          f"or a flat UINT8 buffer, got {first.pretty()}")
        if first is not None and not first.is_list and "num_rows" not in op:
            raise _Reject("from_rows on a flat UINT8 buffer needs 'num_rows'")
    rows = st.rows
    if "num_rows" in op:
        nr = op["num_rows"]
        if isinstance(nr, bool) or not isinstance(nr, int) or nr < 0:
            raise _Reject("from_rows num_rows must be a non-negative "
                          f"integer, got {nr!r}")
        rows = nr
    return out, None, rows


def _r_partition(op, st):
    kind = op.get("kind", "hash")
    if kind not in ("hash", "range"):
        raise _Reject(f"unknown partition kind {kind!r}")
    num = op.get("num")
    if isinstance(num, bool) or not isinstance(num, int):
        raise _Reject(f"partition num must be an integer, got {num!r}")
    if num < 1:
        raise _Reject(f"partition num must be >= 1, got {num}")
    keys = op.get("keys", [])
    if not isinstance(keys, list):
        raise _Reject(f"partition 'keys' must be a list, got {keys!r}")
    if kind == "range" and not keys:
        raise _Reject("partition kind='range' needs a non-empty 'keys' list")
    for k in keys:
        _key_ref(k, st.schema, st.names, what="partition key")
    if st.schema is None:
        return None, None, st.rows
    return list(st.schema), st.names, st.rows


#: The rule of every dispatch op.
_RULES = {
    "join": _r_join, "concat": _r_concat, "groupby": _r_groupby,
    "sort_by": _r_sort_by, "filter": _r_filter, "distinct": _r_distinct,
    "cast": _r_cast, "explode": _r_explode, "rlike": _r_rlike,
    "cross_join": _r_cross_join, "slice": _r_slice,
    "repeat": _r_repeat, "sample": _r_sample, "partition": _r_partition,
    "to_rows": _r_to_rows, "from_rows": _r_from_rows,
}


# ---------------------------------------------------------------------------
# support tiers (the GpuOverrides tag)
# ---------------------------------------------------------------------------

#: ops the per-op bucketed runners cover (``bucketed._RUNNERS``)
_BUCKETED_OPS = frozenset(
    {"cast", "filter", "sort_by", "groupby", "distinct", "rlike", "join"})
_BUCKETED_JOIN_HOWS = frozenset({"inner", "left", "semi", "anti"})

_EXACT_REASONS = {
    "concat": "multi-table op: exact path only",
    "join": "multi-table op: exact path only",
    "cross_join": "multi-table op with n*m row expansion: exact only",
    "explode": "data-dependent output rows: exact path only",
    "repeat": "row-multiplying op: exact path only",
    "sample": "data-dependent gather: exact path only",
    "partition": "exchange boundary: exact path reorders in place; "
                 "the mesh path (planmesh) runs a counts-sized "
                 "all-to-all here and fuses the chains either side",
    "to_rows": "row-format transpose: exact path only",
    "from_rows": "row-format transpose: exact path only",
}


def _tier(op: dict) -> Tuple[str, str]:
    """(tier, reason) of a well-formed op."""
    from .plan import op_fusable

    name = op.get("op")
    if op_fusable(op):
        if name == "groupby":
            return ("fusable",
                    "rides a fused segment tail-only: the groupby closes "
                    "its run (plan.segment_plan)")
        if name == "slice":
            return ("fusable",
                    "non-negative static bounds ride inside a fused segment")
        return "fusable", "single-table row-local op: rides fused segments"
    if name in _BUCKETED_OPS:
        if name == "join":
            how = op.get("how", "inner")
            if how in _BUCKETED_JOIN_HOWS:
                return ("per-op",
                        f"join how={how!r} has a bucketed per-op runner")
            return ("exact-only",
                    f"join how={how!r} needs the exact path (outer-side "
                    "row expansion defeats bucket padding)")
        if name == "groupby":
            return ("exact-only",
                    "collect_list/collect_set needs a data-dependent list "
                    "capacity pre-pass only the exact path owns")
    if name == "slice":
        return ("exact-only",
                "non-static slice bounds fall back to the exact path")
    if name in _RULES:
        return "exact-only", _EXACT_REASONS.get(
            name, "no fused or bucketed runner: exact path only")
    return "unsupported", f"unknown table op {name!r}"


# ---------------------------------------------------------------------------
# kernel tier (kernels/registry.py): static eligibility tags
#
# The static halves of the port's registry predicates; the keys of
# _KERNEL_RULES equal kernels.registry.KERNEL_NAMES. The tag is additive
# to the support tier: a tagged op may still decline on facts the plan
# does not carry (a nullable key, the gate, duplicate build keys).
# ---------------------------------------------------------------------------

_KERNEL_JOIN_HOWS = frozenset({"inner", "semi", "anti"})
_KERNEL_AGG_OPS = frozenset({"sum", "count", "min", "max"})
# the registry's int32 row and slot bounds (kernels/registry.py)
_JOIN_BUILD_MAX_ROWS = 1 << 29
_JOIN_PROBE_MAX_ROWS = 1 << 30
_GROUPBY_MAX_ROWS = 1 << 30
_SORT_MAX_ROWS = 1 << 30


def _kernel_key_reason(ct: Optional[ColType]) -> Optional[str]:
    """Why this column can never be a one-word kernel key (None: maybe;
    a nullable key is a runtime fact)."""
    if ct is None:
        return None
    if ct.is_string:
        return "string key (multi-word order key)"
    if ct.id == dt.TypeId.DECIMAL128:
        return "DECIMAL128 key (two-word order key)"
    if ct.id in (dt.TypeId.LIST, dt.TypeId.STRUCT):
        return f"{ct.id.name} key"
    return None


def _kernel_col(ref, schema, names) -> Tuple[Optional[ColType], bool]:
    """(coltype, resolvable) of a key ref, without raising; an unknown
    schema answers (None, True)."""
    try:
        idx = _key_ref(ref, schema, names, what="kernel key")
    except _Reject:
        return None, False
    if idx is None or schema is None:
        return None, True
    return schema[idx], True


def _peek_rest(op: dict, st) -> Optional[List[Tuple]]:
    """The (schema, rows) pairs ``take_rest`` WOULD hand this op, without
    consuming them."""
    idxs = op.get("rest")
    if idxs is not None:
        try:
            return [st.orig_rest[int(i)] for i in idxs]
        except (IndexError, TypeError, ValueError):
            return None
    return [st.queue[0]] if st.queue else []


def _rows_reason(rows, bound: int, what: str) -> Optional[str]:
    if rows is None:
        return None
    if int(rows) == 0:
        return f"empty {what}"
    if int(rows) > bound:
        return f"{what} {int(rows)} rows over the int32 bound"
    return None


def _k_packed_sort(op: dict, st) -> Optional[str]:
    ks = op.get("keys")
    if not isinstance(ks, list) or len(ks) != 1 \
            or not isinstance(ks[0], dict):
        return "multi-key sort (one packed word per network)"
    ct, ok = _kernel_col(ks[0].get("column"), st.schema, st.names)
    if not ok:
        return "unresolvable sort key column"
    return _kernel_key_reason(ct) or _rows_reason(
        st.rows, _SORT_MAX_ROWS, "input")


def _k_hash_join(op: dict, st) -> Optional[str]:
    how = op.get("how", "inner")
    if how not in _KERNEL_JOIN_HOWS:
        return f"join how={how!r} (left/outer build on exact machinery)"
    on = op.get("on")
    if not isinstance(on, list) or len(on) != 1:
        return "multi-column join key"
    rest = _peek_rest(op, st)
    if not rest:
        return "missing build-side table"
    lct, lok = _kernel_col(on[0], st.schema, st.names)
    rct, rok = _kernel_col(on[0], rest[0][0], None)
    if not (lok and rok):
        return "unresolvable join key column"
    for side, ct in (("probe", lct), ("build", rct)):
        r = _kernel_key_reason(ct)
        if r is not None:
            return f"{side} side: {r}"
    return (_rows_reason(st.rows, _JOIN_PROBE_MAX_ROWS, "probe side")
            or _rows_reason(rest[0][1], _JOIN_BUILD_MAX_ROWS, "build side"))


def _k_hash_groupby(op: dict, st) -> Optional[str]:
    by = op.get("by")
    if not isinstance(by, list) or len(by) != 1:
        return "multi-column group key"
    aggs = op.get("aggs")
    if not isinstance(aggs, list) or not aggs:
        return "no aggregations"
    for a in aggs:
        if not isinstance(a, dict):
            return "malformed aggregation spec"
        if a.get("agg") not in _KERNEL_AGG_OPS:
            return f"non-decomposable agg {a.get('agg')!r}"
    ct, ok = _kernel_col(by[0], st.schema, st.names)
    if not ok:
        return "unresolvable group key column"
    r = _kernel_key_reason(ct)
    if r is not None:
        return r
    for a in aggs:
        vct, vok = _kernel_col(a.get("column"), st.schema, st.names)
        if not vok:
            return "unresolvable aggregation column"
        if vct is not None and (vct.is_string or vct.is_decimal
                                or vct.is_floating or vct.is_list):
            return (f"{vct.id.name} aggregation value (order-sensitive or "
                    "multi-word)")
    return _rows_reason(st.rows, _GROUPBY_MAX_ROWS, "input")


def _k_row_pack(op: dict, st) -> Optional[str]:
    if st.schema is not None:
        for ct in st.schema:
            if not ct.is_fixed_width:
                return f"{ct.id.name} column has no fixed-width row slot"
    return None


def _k_row_unpack(op: dict, st) -> Optional[str]:
    if st.schema is not None and st.schema:
        if not st.schema[0].is_list:
            return "legacy flat row buffer (host decode path)"
    for tid in op.get("type_ids") or ():
        try:
            if dt.TypeId(int(tid)) not in dt._WIDTHS:
                return "non-fixed-width target schema"
        except (TypeError, ValueError):
            return "non-fixed-width target schema"
    return None


#: kernel name -> (covered op, static eligibility rule); the op coverage
#: mirrors the registry's ``KernelSpec.ops``
_KERNEL_RULES = {
    "packed_sort": ("sort_by", _k_packed_sort),
    "hash_build_probe": ("join", _k_hash_join),
    "hash_groupby": ("groupby", _k_hash_groupby),
    "row_pack": ("to_rows", _k_row_pack),
    "row_unpack": ("from_rows", _k_row_unpack),
}

_KERNELS_BY_OP: Dict[str, List[str]] = {}
for _kname, (_opname, _) in _KERNEL_RULES.items():
    _KERNELS_BY_OP.setdefault(_opname, []).append(_kname)
for _v in _KERNELS_BY_OP.values():
    _v.sort()


def _kernel_tag(op: dict, st) -> Optional[str]:
    """The kernel-tier tag of one op against its INPUT state: the kernel
    name when the op is statically eligible, else None. Never raises: a
    malformed spec answers None and the op rule reports the refusal."""
    for kname in _KERNELS_BY_OP.get(op.get("op"), ()):
        _, krule = _KERNEL_RULES[kname]
        try:
            if krule(op, st) is None:
                return kname
        except Exception:  # advisory: a surprise degrades to untagged
            return None
    return None


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------


def analyze(ops, schema: Optional[Sequence[ColType]] = None,
            rows: Optional[int] = None,
            rest: Sequence[Tuple[Optional[Sequence[ColType]],
                                 Optional[int]]] = (),
            names: Optional[Sequence[str]] = None) -> dict:
    """Walk a plan and return its tagged report (never raises for plan
    content: a malformed op becomes an ``unsupported`` entry with ``ok``
    False, and the walk goes on with its schema unknown). Per op: the
    support tier and reason, the kernel tag, the inferred output schema
    (a list of :class:`ColType`) and row bound; then the predicted
    segments with their ``est_hbm_bytes`` and the plan's
    ``est_hbm_peak_bytes``. ``schema=None`` degrades to structural
    validation; ``rest`` carries the extra input tables as ``(schema,
    rows)`` pairs, taken as ``plan._take_rest`` takes them."""
    report: dict = {"ok": True, "rows_in": rows, "ops": [],
                    "kernel_ops": [], "segments": [],
                    "est_hbm_peak_bytes": None}
    if not isinstance(ops, list):
        report["ok"] = False
        report["ops"].append({
            "index": 0, "op": None, "tier": "unsupported",
            "reason": "plan must be a JSON list of op objects, got "
                      + type(ops).__name__,
            "out_schema": None, "rows_bound": None})
        return report
    st = _State(list(schema) if schema is not None else None, names, rows,
                rest)
    op_rows: List[Optional[int]] = []
    op_widths: List[Tuple[Optional[int], Optional[int]]] = []
    for i, op in enumerate(ops):
        entry = {"index": i, "op": None, "tier": None, "reason": None,
                 "kernel": None, "out_schema": None, "rows_bound": None}
        report["ops"].append(entry)
        if not isinstance(op, dict) or "op" not in op:
            entry["tier"] = "unsupported"
            entry["reason"] = f"plan entries must be op objects, got {op!r}"
            report["ok"] = False
            op_rows.append(None)
            op_widths.append((None, None))
            st.schema, st.names, st.rows = None, None, None
            continue
        name = entry["op"] = op.get("op")
        entry["tier"], entry["reason"] = _tier(op)
        # against the INPUT state, before the rule advances past this op
        entry["kernel"] = _kernel_tag(op, st)
        rule = _RULES.get(name)
        if rule is None:
            report["ok"] = False
            op_rows.append(None)
            op_widths.append((None, None))
            st.schema, st.names, st.rows = None, None, None
            continue
        width_in = _row_width(st.schema)
        try:
            out_schema, out_names, out_rows = rule(op, st)
        except _Reject as e:
            entry["tier"] = "unsupported"
            entry["reason"] = e.reason
            entry["kernel"] = None
            report["ok"] = False
            op_rows.append(None)
            op_widths.append((width_in, None))
            st.schema, st.names, st.rows = None, None, None
            continue
        entry["out_schema"] = out_schema
        entry["rows_bound"] = out_rows
        op_rows.append(out_rows)
        op_widths.append((width_in, _row_width(out_schema)))
        st.schema, st.names, st.rows = out_schema, out_names, out_rows
    report["kernel_ops"] = [e["index"] for e in report["ops"]
                            if e.get("kernel")]
    report["out_schema"] = (report["ops"][-1]["out_schema"] if report["ops"]
                            else (list(schema) if schema is not None
                                  else None))
    report["rows_out_bound"] = op_rows[-1] if op_rows else rows
    # per-op working set ~ rows_in*width_in + rows_out*width_out; a
    # segment's bound is the max over its ops, the plan's peak the max
    # over segments; None propagates (an unknown schema or row bound)
    peak: Optional[int] = None
    rows_before = [rows] + op_rows[:-1] if ops else []
    for kind, idxs in predict_segments(ops):
        seg_bytes: Optional[int] = 0
        seg_rows: Optional[int] = None
        for i in idxs:
            win, wout = op_widths[i]
            rin, rout = rows_before[i], op_rows[i]
            seg_rows = rout
            if None in (win, rin):
                op_bytes = None
            else:
                op_bytes = rin * win
                if wout is not None and rout is not None:
                    op_bytes += rout * wout
            if op_bytes is None:
                seg_bytes = None
            elif seg_bytes is not None:
                seg_bytes = max(seg_bytes, op_bytes)
        report["segments"].append({"kind": kind, "ops": list(idxs),
                                   "rows_bound": seg_rows,
                                   "est_hbm_bytes": seg_bytes})
        if seg_bytes is not None:
            peak = seg_bytes if peak is None else max(peak, seg_bytes)
    report["est_hbm_peak_bytes"] = peak
    return report


def check_plan(ops, schema: Optional[Sequence[ColType]] = None,
               rows: Optional[int] = None,
               rest: Sequence[Tuple[Optional[Sequence[ColType]],
                                    Optional[int]]] = (),
               names: Optional[Sequence[str]] = None) -> dict:
    """:func:`analyze`, raising :class:`PlanCheckError` at the first op
    that cannot run; returns the report of a clean plan."""
    report = analyze(ops, schema=schema, rows=rows, rest=rest, names=names)
    if not report["ok"]:
        for entry in report["ops"]:
            if entry["tier"] == "unsupported":
                raise PlanCheckError(entry["index"], entry["op"],
                                     entry["reason"], report)
        raise PlanCheckError(0, None, "plan failed static analysis", report)
    return report


def predict_segments(ops: Sequence[dict]) -> List[Tuple[str, List[int]]]:
    """The plan's fusion segments as ``[(kind, [op indices])]``, by the
    runner's own rule (``plan.segment_indices``)."""
    from .plan import segment_indices

    return segment_indices(ops)


# ---------------------------------------------------------------------------
# rendering (tools/explain.py --static)
# ---------------------------------------------------------------------------

_TIER_GLYPH = {"fusable": "*", "per-op": "+", "exact-only": "=",
               "unsupported": "!"}


def _pretty(c) -> str:
    return c["pretty"] if isinstance(c, dict) else c.pretty()


def render_report(report: dict) -> str:
    """Human-readable tagged plan, GpuOverrides-style: one line per op
    with its tier glyph, inferred output schema and reason, then the
    predicted segments and the static footprint bound (the JAX
    package's text for the same report)."""
    lines: List[str] = []
    lines.append(f"plancheck: {'clean' if report.get('ok', False) else 'REJECTED'}")
    rows_in = report.get("rows_in")
    if rows_in is not None:
        lines.append(f"rows in: {rows_in}")
    for e in report.get("ops", []):
        glyph = _TIER_GLYPH.get(e.get("tier"), "?")
        schema = e.get("out_schema")
        sch = "?" if schema is None else (
            "[" + ", ".join(_pretty(c) for c in schema) + "]")
        rb = e.get("rows_bound")
        rows_s = f" rows<={rb}" if rb is not None else ""
        kern = e.get("kernel")
        kern_s = f" ~kernel:{kern}" if kern else ""
        lines.append(f"  {glyph} op[{e['index']}] {e.get('op')!s:<10} "
                     f"{e.get('tier') or '?':<11} -> {sch}{rows_s}{kern_s}")
        lines.append(f"      {e.get('reason')}")
    segs = report.get("segments", [])
    if segs:
        parts = []
        for sg in segs:
            idxs = ",".join(str(i) for i in sg["ops"])
            b = sg.get("est_hbm_bytes")
            b_s = f" ~{b}B" if b is not None else ""
            parts.append(f"{sg['kind']}[{idxs}]{b_s}")
        lines.append("segments: " + " | ".join(parts))
    peak = report.get("est_hbm_peak_bytes")
    lines.append("est HBM peak: " + (f"{peak} bytes" if peak is not None
                                     else "unbounded/unknown"))
    return "\n".join(lines)
