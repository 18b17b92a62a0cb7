"""Parquet scan/write: host decode -> upload -> device filter (port of
the JAX package's ``io/parquet.py``).

Three things are pushed down before any byte reaches the device:

1. column projection (only the requested and predicate columns are
   decoded),
2. row-group pruning against the footer's min/max/null statistics
   (``predicates.Leaf.maybe_matches``), and
3. the exact residual filter on the device over the uploaded batch
   (``predicates.Predicate.evaluate`` + ``ops.filter``), with Spark's
   null semantics.

``scan_parquet`` streams row-group batches; ``read_parquet`` is the
eager single-table form. ``device_decode=True`` decodes fixed-width
PLAIN/dictionary pages on the device (``io/parquet_device.py``). The
stages run under ``tracing.trace_range`` (under ``TRACE``) with the
JAX package's trace names (``io.parquet.decode``, ``io.parquet.upload``,
``io.parquet.device_decode``, ``io.parquet.filter``,
``io.parquet.write``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Sequence, Union

import torch
from ..utils.tracing import trace_range

from ..column import Table, resolve_device, table_tensors
from . import predicates as preds
from .predicates import ColumnStats, Predicate

try:  # pyarrow is optional: required at call time, never at import
    import pyarrow as pa
    import pyarrow.parquet as pq
except ImportError:  # pragma: no cover
    pa = pq = None


def _require():
    if pq is None:  # pragma: no cover
        raise ImportError("pyarrow.parquet not available")


def _normalize_paths(path) -> list:
    def one(p):
        # os.fspath: a pathlib.Path behaves as its str (the device
        # decode takes str paths only)
        try:
            return os.fspath(p)
        except TypeError:
            return p  # file-like objects pass through

    if isinstance(path, (list, tuple)):
        return [one(p) for p in path]
    return [one(path)]


def _row_group_stats(meta, rg_index: int, names: Sequence[str]) -> dict:
    """Footer statistics of one row group, keyed by column name."""
    out = {}
    rg = meta.row_group(rg_index)
    want = set(names)
    for ci in range(rg.num_columns):
        colmeta = rg.column(ci)
        name = colmeta.path_in_schema
        if name not in want:
            continue
        st = colmeta.statistics
        if st is None:
            continue
        try:
            lo = st.min if st.has_min_max else None
            hi = st.max if st.has_min_max else None
        except (ValueError, TypeError):  # undecodable physical stats
            lo = hi = None
        out[name] = ColumnStats(
            min=lo,
            max=hi,
            null_count=st.null_count if st.has_null_count else None,
            num_values=colmeta.num_values,
        )
    return out


def parquet_metadata(path) -> dict:
    """Schema + per-row-group stats (host only, reads just the footer)."""
    _require()
    pf = pq.ParquetFile(path)
    names = pf.schema_arrow.names
    return {
        "num_rows": pf.metadata.num_rows,
        "num_row_groups": pf.metadata.num_row_groups,
        "columns": names,
        "row_groups": [
            {
                "num_rows": pf.metadata.row_group(i).num_rows,
                "stats": _row_group_stats(pf.metadata, i, names),
            }
            for i in range(pf.metadata.num_row_groups)
        ],
    }


def _apply_exact_filter(table: Table, predicate: Predicate,
                        keep_names) -> Table:
    from ..ops.filter import filter_table

    out = filter_table(table, predicate.evaluate(table))
    if keep_names is not None and list(out.names) != list(keep_names):
        out = Table([out.column(n) for n in keep_names], list(keep_names))
    return out


def _prefetch_iter(gen: Iterator, depth: int,
                   device: Union[str, torch.device, None] = None
                   ) -> Iterator:
    """Run ``gen`` on a daemon thread ``depth`` items ahead of the
    consumer, so that batch k+1 decodes and uploads while the consumer
    computes on batch k (Arrow's decode and the pinned copies release
    the GIL).

    On a CUDA ``device`` the worker runs ``gen`` on a stream of its own
    and records an event after each item; the consumer's current stream
    waits on that event before the item is handed over, and every
    tensor of a Table item is ``record_stream``-ed on the consumer's
    stream, so the caching allocator does not reuse its memory while the
    consumer may still read it. A stop event ends the worker when the
    consumer exits early (LIMIT, an exception); an exception in the
    producer re-raises at the consumer."""
    import queue
    import threading

    dev = None if device is None else torch.device(device)
    cuda = dev is not None and dev.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    failure: list = []
    stop = threading.Event()

    def put(entry) -> None:
        # a bounded put that observes shutdown: an early-exiting
        # consumer must not leave this thread blocked on a full queue
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.1)
                return
            except queue.Full:
                continue

    def produce() -> None:
        stream = torch.cuda.Stream(dev) if cuda else None
        with (torch.cuda.device(dev) if cuda else contextlib.nullcontext()), \
                (torch.cuda.stream(stream) if cuda
                 else contextlib.nullcontext()):
            for item in gen:
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(stream)
                put((item, done))
                if stop.is_set():
                    break

    def worker() -> None:
        try:
            produce()
        # captured and re-raised at the consumer: a relocation, not a swallow
        except BaseException as e:
            failure.append(e)
        finally:
            gen.close()
            put((sentinel, None))  # the sentinel must land, or the consumer blocks

    thread = threading.Thread(target=worker, daemon=True,
                              name="scan-prefetch")
    thread.start()
    try:
        while True:
            item, done = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            if done is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                if isinstance(item, Table):
                    for t in table_tensors(item):
                        t.record_stream(consumer)
            yield item
    finally:
        stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def scan_parquet(
    path,
    columns: Optional[Sequence[str]] = None,
    filters=None,
    pad_widths: Optional[dict] = None,
    row_groups_per_batch: int = 1,
    exact_filter: bool = True,
    prefetch: int = 0,
    device_decode: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Iterator[Table]:
    """Stream a Parquet file (or list of files) as Table batches on
    ``device``.

    Each batch covers ``row_groups_per_batch`` surviving row groups.
    ``filters`` is a Predicate (``col("x") > 3``) or a pyarrow-style DNF
    list of (name, op, value) tuples. ``prefetch=N`` decodes and uploads
    up to N batches ahead on a background thread (on CUDA, on a stream
    of its own).

    ``device_decode=True`` decodes fixed-width PLAIN/dictionary columns
    on the device (``io/parquet_device.py``): the host parses headers
    and uploads the still-encoded page bytes, the device does the O(n)
    expansion. Columns the device path does not take are decoded by
    Arrow."""
    _require()
    dev = resolve_device(device)
    if prefetch > 0:
        return _prefetch_iter(
            scan_parquet(path, columns, filters, pad_widths,
                         row_groups_per_batch, exact_filter, prefetch=0,
                         device_decode=device_decode, device=dev),
            prefetch, dev)
    return _scan_parquet_serial(path, columns, filters, pad_widths,
                                row_groups_per_batch, exact_filter,
                                device_decode, dev)


def _device_decode_batch(path, pf, row_groups, read_cols, pad_widths, dev):
    """Device-decode one batch; Arrow decodes only what the device path
    refuses, and the requested column order is kept."""
    from ..interop import table_from_arrow
    from . import parquet_device as pdev

    per_rg = []
    for rg in row_groups:
        decoded, fallback = pdev.decode_row_group(path, pf, rg, read_cols,
                                                  dev)
        if fallback:
            atbl = pf.read_row_groups([rg], columns=fallback)
            host = table_from_arrow(atbl, pad_widths=pad_widths, device=dev)
            for name, col in zip(host.names, host.columns):
                decoded[name] = col
        per_rg.append(Table([decoded[n] for n in read_cols], list(read_cols)))
    if len(per_rg) == 1:
        return per_rg[0]
    from ..ops.copying import concatenate

    return concatenate(per_rg)


def _surviving_row_groups(pf, predicate) -> list:
    if predicate is None:
        return list(range(pf.metadata.num_row_groups))
    stats_names = sorted(predicate.columns())
    return [rg for rg in range(pf.metadata.num_row_groups)
            if predicate.maybe_matches(
                _row_group_stats(pf.metadata, rg, stats_names))]


def _scan_parquet_serial(path, columns, filters, pad_widths,
                         row_groups_per_batch, exact_filter,
                         device_decode, dev) -> Iterator[Table]:
    from ..interop import table_from_arrow

    predicate = preds.from_dnf(filters) if filters is not None else None
    step = max(row_groups_per_batch, 1)
    for p in _normalize_paths(path):
        pf = pq.ParquetFile(p)
        want, read_cols = preds.projection_columns(
            predicate, columns, pf.schema_arrow.names)
        surviving = _surviving_row_groups(pf, predicate)
        for i in range(0, len(surviving), step):
            batch = surviving[i:i + step]
            if device_decode and isinstance(p, str):
                with trace_range("io.parquet.device_decode"):
                    out = _device_decode_batch(p, pf, batch, read_cols,
                                               pad_widths, dev)
            else:
                with trace_range("io.parquet.decode"):
                    atbl = pf.read_row_groups(batch, columns=read_cols)
                with trace_range("io.parquet.upload"):
                    out = table_from_arrow(atbl, pad_widths=pad_widths,
                                           device=dev)
            if predicate is not None and exact_filter:
                with trace_range("io.parquet.filter"):
                    out = _apply_exact_filter(out, predicate, want)
            yield out


def read_parquet(
    path,
    columns: Optional[Sequence[str]] = None,
    filters=None,
    pad_widths: Optional[dict] = None,
    exact_filter: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Table:
    """Eager read on ``device``: prune row groups, decode once, upload,
    filter on the device."""
    _require()
    from ..interop import table_from_arrow

    dev = resolve_device(device)
    predicate = preds.from_dnf(filters) if filters is not None else None
    tables = []
    for p in _normalize_paths(path):
        pf = pq.ParquetFile(p)
        _, read_cols = preds.projection_columns(
            predicate, columns, pf.schema_arrow.names)
        with trace_range("io.parquet.decode"):
            tables.append(pf.read_row_groups(_surviving_row_groups(
                pf, predicate), columns=read_cols))
    merged = tables[0] if len(tables) == 1 else pa.concat_tables(tables)
    with trace_range("io.parquet.upload"):
        out = table_from_arrow(merged, pad_widths=pad_widths, device=dev)
    if predicate is not None and exact_filter:
        with trace_range("io.parquet.filter"):
            want = list(columns) if columns is not None else out.names
            out = _apply_exact_filter(out, predicate, want)
    return out


def write_parquet(table: Table, path, compression: str = "snappy",
                  row_group_size: Optional[int] = None) -> None:
    """Table -> Parquet file (host readback + Arrow writer)."""
    _require()
    from ..interop import table_to_arrow

    with trace_range("io.parquet.write"):
        pq.write_table(table_to_arrow(table), path, compression=compression,
                       row_group_size=row_group_size)
