"""ORC scan/write: host Arrow decode -> upload, one stripe a batch (port
of the JAX package's ``io/orc.py``). pyarrow.orc exposes no per-stripe
statistics to Python, so pruning is by file only; the exact residual
filter runs on the device, as for Parquet.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Union

import torch
from ..utils.tracing import trace_range

from ..column import Table, resolve_device
from . import predicates as preds

try:  # pyarrow is optional: required at call time, never at import
    import pyarrow as pa
    import pyarrow.orc as pa_orc
except ImportError:  # pragma: no cover
    pa = pa_orc = None


def _require():
    if pa_orc is None:  # pragma: no cover
        raise ImportError("pyarrow.orc not available")


def scan_orc(
    path,
    columns: Optional[Sequence[str]] = None,
    filters=None,
    pad_widths: Optional[dict] = None,
    exact_filter: bool = True,
    prefetch: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> Iterator[Table]:
    """Stream an ORC file stripe by stripe as Tables on ``device``;
    ``prefetch=N`` decodes and uploads up to N stripes ahead on a
    background thread (``parquet._prefetch_iter``)."""
    _require()
    from .parquet import _prefetch_iter

    dev = resolve_device(device)
    if prefetch > 0:
        return _prefetch_iter(
            scan_orc(path, columns, filters, pad_widths, exact_filter,
                     prefetch=0, device=dev),
            prefetch, dev)
    return _scan_orc_serial(path, columns, filters, pad_widths,
                            exact_filter, dev)


def _scan_orc_serial(path, columns, filters, pad_widths, exact_filter,
                     dev) -> Iterator[Table]:
    from ..interop import table_from_arrow
    from .parquet import _apply_exact_filter

    predicate = preds.from_dnf(filters) if filters is not None else None
    f = pa_orc.ORCFile(path)
    want, read_cols = preds.projection_columns(predicate, columns,
                                               f.schema.names)
    for i in range(f.nstripes):
        with trace_range("io.orc.decode"):
            atbl = pa.Table.from_batches([f.read_stripe(i, columns=read_cols)])
        with trace_range("io.orc.upload"):
            out = table_from_arrow(atbl, pad_widths=pad_widths, device=dev)
        if predicate is not None and exact_filter:
            with trace_range("io.orc.filter"):
                out = _apply_exact_filter(out, predicate, want)
        yield out


def read_orc(
    path,
    columns: Optional[Sequence[str]] = None,
    filters=None,
    pad_widths: Optional[dict] = None,
    exact_filter: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Table:
    """Eager ORC read -> one Table on ``device``."""
    _require()
    from ..interop import table_from_arrow
    from .parquet import _apply_exact_filter

    dev = resolve_device(device)
    predicate = preds.from_dnf(filters) if filters is not None else None
    f = pa_orc.ORCFile(path)
    want, read_cols = preds.projection_columns(predicate, columns,
                                               f.schema.names)
    with trace_range("io.orc.decode"):
        atbl = f.read(columns=read_cols)
    with trace_range("io.orc.upload"):
        out = table_from_arrow(atbl, pad_widths=pad_widths, device=dev)
    if predicate is not None and exact_filter:
        with trace_range("io.orc.filter"):
            out = _apply_exact_filter(out, predicate, want)
    return out


def write_orc(table: Table, path, compression: str = "zstd") -> None:
    """Table -> ORC file."""
    _require()
    from ..interop import table_to_arrow

    with trace_range("io.orc.write"):
        pa_orc.write_table(table_to_arrow(table), path,
                           compression=compression)
