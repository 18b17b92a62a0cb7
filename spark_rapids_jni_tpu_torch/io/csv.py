"""CSV read/write: host parse -> upload (port of the JAX package's
``io/csv.py``). Arrow's multithreaded CSV reader parses on the host;
the typed columns then upload once.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from ..utils.tracing import trace_range

from ..column import Table, resolve_device
from . import predicates as preds

try:  # pyarrow is optional: required at call time, never at import
    import pyarrow as pa
    import pyarrow.csv as pa_csv
except ImportError:  # pragma: no cover
    pa = pa_csv = None


def _require():
    if pa_csv is None:  # pragma: no cover
        raise ImportError("pyarrow.csv not available")


def read_csv(
    path,
    columns: Optional[Sequence[str]] = None,
    filters=None,
    delimiter: str = ",",
    header: bool = True,
    column_names: Optional[Sequence[str]] = None,
    dtypes: Optional[dict] = None,
    pad_widths: Optional[dict] = None,
    device: Union[str, torch.device] = "cuda",
) -> Table:
    """CSV file -> Table on ``device`` (optional projection + device
    filter)."""
    _require()
    from ..interop import table_from_arrow
    from .parquet import _apply_exact_filter

    dev = resolve_device(device)
    predicate = preds.from_dnf(filters) if filters is not None else None
    read_opts = pa_csv.ReadOptions(
        column_names=list(column_names) if column_names else None,
        autogenerate_column_names=not header and column_names is None,
        # with explicit names the file's header line is data to
        # pyarrow: skip it here
        skip_rows=1 if (header and column_names) else 0,
    )
    parse_opts = pa_csv.ParseOptions(delimiter=delimiter)
    # with a projection the decode set is known up front, so unused
    # columns skip type conversion; without one it is known after the read
    if columns is not None:
        want, read_cols = preds.projection_columns(predicate, columns,
                                                   columns)
    else:
        want = read_cols = None
    convert_opts = pa_csv.ConvertOptions(
        column_types=dict(dtypes or {}), include_columns=read_cols)
    with trace_range("io.csv.parse"):
        atbl = pa_csv.read_csv(path, read_options=read_opts,
                               parse_options=parse_opts,
                               convert_options=convert_opts)
    if want is None:
        want, read_cols = preds.projection_columns(predicate, None,
                                                   atbl.column_names)
        atbl = atbl.select(read_cols)
    with trace_range("io.csv.upload"):
        out = table_from_arrow(atbl, pad_widths=pad_widths, device=dev)
    if predicate is not None:
        with trace_range("io.csv.filter"):
            out = _apply_exact_filter(out, predicate, want)
    return out


def write_csv(table: Table, path, delimiter: str = ",",
              header: bool = True) -> None:
    """Table -> CSV file."""
    _require()
    from ..interop import table_to_arrow

    with trace_range("io.csv.write"):
        pa_csv.write_csv(
            table_to_arrow(table), path,
            write_options=pa_csv.WriteOptions(include_header=header,
                                              delimiter=delimiter))


def scan_csv(
    path,
    columns: Optional[Sequence[str]] = None,
    filters=None,
    delimiter: str = ",",
    header: bool = True,
    block_size: int = 1 << 22,
    dtypes: Optional[dict] = None,
    pad_widths: Optional[dict] = None,
    prefetch: int = 0,
    device: Union[str, torch.device] = "cuda",
):
    """Stream a CSV file as Table batches on ``device`` (Arrow's
    incremental reader, a batch per ~``block_size`` bytes); ``prefetch=N``
    parses and uploads ahead on a background thread.

    ``dtypes`` pins column types up front: the incremental reader infers
    types from the first block only and fails on later drift, so pin any
    column whose early rows underdetermine its type."""
    _require()
    from .parquet import _prefetch_iter

    dev = resolve_device(device)
    if prefetch > 0:
        return _prefetch_iter(
            scan_csv(path, columns, filters, delimiter, header, block_size,
                     dtypes, pad_widths, prefetch=0, device=dev),
            prefetch, dev)
    return _scan_csv_serial(path, columns, filters, delimiter, header,
                            block_size, dtypes, pad_widths, dev)


def _scan_csv_serial(path, columns, filters, delimiter, header, block_size,
                     dtypes, pad_widths, dev):
    from ..interop import table_from_arrow
    from .parquet import _apply_exact_filter

    predicate = preds.from_dnf(filters) if filters is not None else None
    read_opts = pa_csv.ReadOptions(autogenerate_column_names=not header,
                                   block_size=block_size)
    parse_opts = pa_csv.ParseOptions(delimiter=delimiter)
    want = read_cols = None
    if columns is not None:
        want, read_cols = preds.projection_columns(predicate, columns,
                                                   columns)
    convert_opts = pa_csv.ConvertOptions(
        column_types=dict(dtypes or {}), include_columns=read_cols)
    with pa_csv.open_csv(path, read_options=read_opts,
                         parse_options=parse_opts,
                         convert_options=convert_opts) as reader:
        while True:
            with trace_range("io.csv.parse"):
                try:
                    batch = reader.read_next_batch()
                except StopIteration:
                    break
                atbl = pa.Table.from_batches([batch])
            if want is None:
                want, read_cols = preds.projection_columns(
                    predicate, None, atbl.column_names)
            with trace_range("io.csv.upload"):
                out = table_from_arrow(atbl.select(read_cols),
                                       pad_widths=pad_widths, device=dev)
            if predicate is not None:
                with trace_range("io.csv.filter"):
                    out = _apply_exact_filter(out, predicate, want)
            yield out
