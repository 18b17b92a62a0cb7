"""Line-delimited JSON read/write: host parse -> upload (port of the JAX
package's ``io/json.py``), with the same projection, device filter and
prefetch streaming as the other readers.
"""

from __future__ import annotations

import io as _io
import json as _json
import math
from typing import Optional, Sequence, Union

import torch
from ..utils.tracing import trace_range

from ..column import Table, resolve_device
from . import predicates as preds

try:  # pyarrow is optional: required at call time, never at import
    import pyarrow as pa
    import pyarrow.json as pa_json
except ImportError:  # pragma: no cover
    pa = pa_json = None


def _require():
    if pa_json is None:  # pragma: no cover
        raise ImportError("pyarrow.json not available")


def _parse_options(dtypes):
    if not dtypes:
        return None
    return pa_json.ParseOptions(
        explicit_schema=pa.schema(list(dtypes.items())),
        unexpected_field_behavior="infer")


def read_json(
    path,
    columns: Optional[Sequence[str]] = None,
    filters=None,
    dtypes: Optional[dict] = None,
    pad_widths: Optional[dict] = None,
    device: Union[str, torch.device] = "cuda",
) -> Table:
    """JSON-lines file -> Table on ``device`` (projection + device
    filter). ``dtypes`` maps a column name to the pyarrow type its parse
    is pinned to; unlisted columns are inferred."""
    _require()
    from ..interop import table_from_arrow
    from .parquet import _apply_exact_filter

    dev = resolve_device(device)
    predicate = preds.from_dnf(filters) if filters is not None else None
    with trace_range("io.json.parse"):
        atbl = pa_json.read_json(path, parse_options=_parse_options(dtypes))
    want, read_cols = preds.projection_columns(predicate, columns,
                                               atbl.column_names)
    atbl = atbl.select(read_cols)
    with trace_range("io.json.upload"):
        out = table_from_arrow(atbl, pad_widths=pad_widths, device=dev)
    if predicate is not None:
        with trace_range("io.json.filter"):
            out = _apply_exact_filter(out, predicate, want)
    return out


def _clean(v):
    # strict JSON has no NaN/Inf token, and Arrow's reader rejects
    # Python's spelling: non-finite floats are written as null
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def write_json(table: Table, path) -> None:
    """Table -> JSON-lines file; non-finite floats become null."""
    with trace_range("io.json.write"):
        names = (list(table.names) if table.names is not None
                 else [f"c{i}" for i in range(len(table.columns))])
        rows = zip(*(c.to_pylist() for c in table.columns))
        with open(path, "w") as f:
            for row in rows:
                f.write(_json.dumps({n: _clean(v) for n, v in zip(names, row)},
                                    allow_nan=False))
                f.write("\n")


def scan_json(
    path,
    columns: Optional[Sequence[str]] = None,
    filters=None,
    block_rows: int = 1 << 16,
    dtypes: Optional[dict] = None,
    pad_widths: Optional[dict] = None,
    prefetch: int = 0,
    device: Union[str, torch.device] = "cuda",
):
    """Stream a JSON-lines file as Table batches of ~``block_rows``
    records on ``device``. Arrow's JSON reader has no incremental mode,
    so the file is cut on line boundaries and each chunk parsed alone;
    pin via ``dtypes`` any column whose early records underdetermine its
    type. ``prefetch=N`` parses and uploads ahead on a background
    thread."""
    _require()
    from .parquet import _prefetch_iter

    dev = resolve_device(device)
    if prefetch > 0:
        return _prefetch_iter(
            scan_json(path, columns, filters, block_rows, dtypes, pad_widths,
                      prefetch=0, device=dev),
            prefetch, dev)
    return _scan_json_serial(path, columns, filters, block_rows, dtypes,
                             pad_widths, dev)


def _scan_json_serial(path, columns, filters, block_rows, dtypes,
                      pad_widths, dev):
    from ..interop import table_from_arrow
    from .parquet import _apply_exact_filter

    predicate = preds.from_dnf(filters) if filters is not None else None
    parse_opts = _parse_options(dtypes)
    # with a projection the read set is known before the first chunk (a
    # projected column may be absent from early chunks)
    want = read_cols = None
    if columns is not None:
        want, read_cols = preds.projection_columns(predicate, columns,
                                                   columns)
    seen_schema = None
    with open(path, "rb") as f:
        eof = False
        while not eof:
            with trace_range("io.json.parse"):
                lines = []
                for _ in range(block_rows):
                    line = f.readline()
                    if not line:
                        eof = True
                        break
                    if line.strip():
                        lines.append(line)
                if not lines:
                    continue  # a blank-only block is not the end
                atbl = pa_json.read_json(_io.BytesIO(b"".join(lines)),
                                         parse_options=parse_opts)
            if want is None:
                want, read_cols = preds.projection_columns(
                    predicate, columns, atbl.column_names)
            # key sets drift across chunks; the whole-file reader fills
            # nulls, so the scanner does too, typed by the pin or the
            # first chunk's schema (a column never seen raises)
            missing = [c for c in read_cols if c not in atbl.column_names]
            if missing:
                fills = []
                for c in missing:
                    typ = None
                    if dtypes and c in dtypes:
                        typ = dtypes[c]
                    elif seen_schema is not None and c in seen_schema.names:
                        typ = seen_schema.field(c).type
                    if typ is None:
                        raise ValueError(
                            f"scan_json: column {c!r} missing from a "
                            "chunk and its type is unknown — pin it via "
                            "dtypes=")
                    fills.append(pa.nulls(len(atbl), type=typ))
                atbl = pa.table(list(atbl.columns) + fills,
                                names=list(atbl.column_names) + missing)
            if seen_schema is None:
                seen_schema = atbl.schema
            with trace_range("io.json.upload"):
                out = table_from_arrow(atbl.select(read_cols),
                                       pad_widths=pad_widths, device=dev)
            if predicate is not None:
                with trace_range("io.json.filter"):
                    out = _apply_exact_filter(out, predicate, want)
            yield out
