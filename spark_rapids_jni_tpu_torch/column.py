"""Column / Table over torch tensors — the port of ``column.py``.

A column is a data tensor plus an optional bool validity tensor (True =
valid, Arrow/cudf polarity). LIST and STRING columns keep the JAX
package's padded layout: ``data`` is an ``(n, pad)`` matrix (LIST: child
storage values; STRING: uint8 bytes, zero past each row's length) and
``lengths`` the int32 element or byte counts; packed rows are
LIST<UINT8> with every length equal to the row size.

``Table.logical_rows`` carries the real row count of a table padded to
a shape bucket (``utils/buckets.py``): its buffers hold ``row_count``
rows, of which the first ``logical_rows`` are real; None means every
row is. Only the bucketed dispatch layer (``bucketed.py``, the kernel
tier) reads a padded table; every other op gets
``buckets.unpad_table`` of it first.

Entry points that create tensors take ``device=`` (default ``"cuda"``)
and raise when CUDA is absent and the caller did not ask for the CPU.
Every op after that follows its input tensors' device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import dtype as dt


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point builds on: CUDA unless the caller asks
    for the CPU. There is no silent fallback from CUDA to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def upload(arr: np.ndarray, device: torch.device,
           rows: Optional[int] = None) -> torch.Tensor:
    """A host array as a tensor on ``device``, its row dimension zero-
    padded to ``rows`` (a shape bucket) when that is given. To a CUDA
    device the array is staged in pinned host memory (one host copy,
    which also frees the caller's bytes at once; the padding is zeroed
    in that buffer) and copied with ``non_blocking=True`` on the current
    stream: the host returns before the copy ends, and the caching host
    allocator keeps the staging block until the copy is done. On the CPU
    an unpadded tensor shares a writeable array's memory."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    shape = arr.shape if rows is None or rows == n else (rows,) + arr.shape[1:]
    if torch.device(device).type != "cuda":
        if shape != arr.shape:
            out = np.zeros(shape, arr.dtype)
            out[:n] = arr
            return torch.from_numpy(out)
        if not arr.flags.writeable:  # e.g. a view of wire bytes
            arr = arr.copy()
        return torch.from_numpy(np.ascontiguousarray(arr))
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    staged = torch.empty(shape, dtype=dtype, pin_memory=True)
    host = staged.numpy()
    np.copyto(host[:n], arr, casting="no")
    if shape != arr.shape:
        host[n:] = 0
    out = torch.empty(shape, dtype=dtype, device=device)
    out.copy_(staged, non_blocking=True)
    return out


def host_to_storage(
    arr: np.ndarray, dtype: dt.DType, device: torch.device,
    rows: Optional[int] = None,
) -> torch.Tensor:
    """Host buffer (the JAX package's storage dtype, or FLOAT64 values)
    -> the port's storage tensor on ``device`` (zero-padded to ``rows``,
    see :func:`upload`)."""
    arr = np.asarray(arr)
    if dtype.id == dt.TypeId.FLOAT64 and arr.dtype == np.float64:
        arr = arr.view(np.uint64)
    if arr.dtype != dtype.host_dtype:
        arr = arr.astype(dtype.host_dtype)
    if arr.dtype == np.uint64 and dtype.storage_dtype == torch.int64:
        arr = arr.view(np.int64)  # FLOAT64 bits and DECIMAL128 limbs
    return upload(arr, device, rows)


def host_storage_view(arr: np.ndarray, dtype: dt.DType) -> np.ndarray:
    """A host copy of a storage tensor, viewed in the JAX package's
    storage dtype (FLOAT64 as uint64 bits)."""
    if not dtype.is_fixed_width:  # STRING bytes, LIST children
        return arr
    if dtype.storage_dtype == torch.int64 and dtype.host_dtype == np.uint64:
        arr = arr.view(np.uint64)
    return arr


def storage_to_host(data: torch.Tensor, dtype: dt.DType) -> np.ndarray:
    """Inverse of :func:`host_to_storage`: the host buffer in the JAX
    package's storage dtype (FLOAT64 as uint64 bits)."""
    return host_storage_view(data.cpu().numpy(), dtype)


def table_tensors(table) -> list:
    """Every tensor a table holds: each column's data, validity and
    lengths that are not None."""
    out = []
    for c in table.columns:
        out += [t for t in (c.data, c.validity, c.lengths) if t is not None]
    return out


def download_tensors(tensors: Sequence[Optional[torch.Tensor]]) -> list:
    """Host copies of ``tensors`` (None stays None) as CPU tensors, in
    one pass: the CUDA ones are copied into pinned host memory with
    ``non_blocking=True`` on the current stream, then one event recorded
    after the last copy is synchronised, so the host waits for this
    stream's work alone and not for other streams' kernels. CPU tensors
    are returned as they are."""
    staged, last = [], None
    for t in tensors:
        if t is not None and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            staged.append(h)
            last = t.device
        else:
            staged.append(t)
    if last is not None:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(last))
        done.synchronize()
    return staged


def download(tensors: Sequence[Optional[torch.Tensor]]) -> list:
    """:func:`download_tensors` as numpy arrays (CPU tensors as views)."""
    return [None if h is None else h.numpy()
            for h in download_tensors(tensors)]


@dataclasses.dataclass(eq=False)
class Column:
    """One column: data tensor + optional validity (+ LIST lengths).

    Invariants:
      * fixed-width: ``data.shape == (n,)`` of ``dtype.storage_dtype``
        (DECIMAL128: ``(n, 2)`` int64 limbs).
      * LIST: ``data.shape == (n, pad)``, ``lengths.shape == (n,)`` int32.
      * STRING: ``data.shape == (n, pad)`` uint8, ``lengths.shape ==
        (n,)`` int32, bytes past ``lengths[i]`` are zero.
      * ``validity`` is None (no nulls) or an ``(n,)`` bool tensor.
    """

    data: torch.Tensor
    dtype: dt.DType
    validity: Optional[torch.Tensor] = None
    lengths: Optional[torch.Tensor] = None

    @property
    def row_count(self) -> int:
        return int(self.data.shape[0])

    @property
    def pad_width(self) -> int:
        if not self.dtype.is_string:
            raise TypeError("pad_width only applies to STRING columns")
        return int(self.data.shape[1])

    @property
    def list_child_dtype(self) -> dt.DType:
        if self.dtype.id != dt.TypeId.LIST:
            raise TypeError("not a LIST column")
        return dt.list_child_from_storage(self.data.dtype)

    @staticmethod
    def from_numpy(
        arr: np.ndarray,
        validity: Optional[np.ndarray] = None,
        dtype: Optional[dt.DType] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> "Column":
        """Build a fixed-width column from host data on ``device``."""
        dev = resolve_device(device)
        arr = np.asarray(arr)
        if dtype is None:
            dtype = dt.from_numpy_dtype(arr.dtype)
        want_ndim = 2 if dtype.id == dt.TypeId.DECIMAL128 else 1
        if arr.ndim != want_ndim:
            raise ValueError(f"expected a {want_ndim}-D host array")
        data = host_to_storage(arr, dtype, dev)
        valid = None
        if validity is not None:
            v = np.asarray(validity, dtype=np.bool_)
            if v.shape != arr.shape[:1]:
                raise ValueError("validity shape mismatch")
            valid = torch.from_numpy(v).to(dev)
        return Column(data, dtype, valid)

    @staticmethod
    def from_strings(
        values: Sequence[Optional[Union[str, bytes]]],
        pad_width: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> "Column":
        """Build a STRING column (the padded byte matrix) on ``device``;
        None is null. ``str`` values are UTF-8 with surrogateescape, so
        arbitrary bytes round-trip."""
        dev = resolve_device(device)
        raw = [v.encode("utf-8", "surrogateescape") if isinstance(v, str)
               else v for v in values]
        max_len = max((len(v) for v in raw if v is not None), default=0)
        pad = pad_width if pad_width is not None else max(max_len, 1)
        if max_len > pad:
            raise ValueError(
                f"string of length {max_len} exceeds pad width {pad}")
        mat = np.zeros((len(raw), pad), np.uint8)
        lens = np.zeros((len(raw),), np.int32)
        valid = np.array([v is not None for v in raw], np.bool_)
        for i, v in enumerate(raw):
            if v is not None:
                mat[i, :len(v)] = np.frombuffer(v, np.uint8)
                lens[i] = len(v)
        return Column(torch.from_numpy(mat).to(dev), dt.STRING,
                      None if valid.all() else torch.from_numpy(valid).to(dev),
                      torch.from_numpy(lens).to(dev))

    @staticmethod
    def from_decimal128(
        values: Sequence[Optional[int]],
        scale: int = 0,
        device: Union[str, torch.device] = "cuda",
    ) -> "Column":
        """Build a DECIMAL128 column from Python ints (unscaled values;
        None is null): ``(n, 2)`` int64 limbs [lo, hi] on ``device``."""
        from .ops.int128 import from_py_ints

        limbs = from_py_ints(values)
        valid = np.array([v is not None for v in values], dtype=np.bool_)
        return Column.from_numpy(
            limbs, None if valid.all() else valid,
            dt.DType(dt.TypeId.DECIMAL128, scale), device)

    def to_pylist(self) -> list:
        """Host values with None for nulls: ``str`` for STRING columns
        (surrogateescape), signed Python ints (the unscaled values) for
        DECIMAL128, else the values of :meth:`to_numpy`."""
        valid = (np.ones(self.row_count, np.bool_) if self.validity is None
                 else self.validity.cpu().numpy())
        if self.dtype.is_string:
            mat = self.data.cpu().numpy()
            lens = self.lengths.cpu().numpy()
            return [bytes(mat[i, :lens[i]]).decode("utf-8", "surrogateescape")
                    if valid[i] else None for i in range(self.row_count)]
        if self.dtype.id == dt.TypeId.DECIMAL128:
            from .ops.int128 import to_py_ints

            vals = to_py_ints(self.data)
            return [v if ok else None for v, ok in zip(vals, valid)]
        vals = self.to_numpy().tolist()
        return [v if ok else None for v, ok in zip(vals, valid)]

    def to_numpy(self) -> np.ndarray:
        """Raw data on the host (nulls carry unspecified payload);
        FLOAT64 as float64 values."""
        arr = storage_to_host(self.data, self.dtype)
        if self.dtype.id == dt.TypeId.FLOAT64:
            return arr.view(np.float64)
        return arr


class Table:
    """An ordered collection of equal-length columns, optionally named."""

    def __init__(
        self,
        columns: Sequence[Column],
        names: Optional[Sequence[str]] = None,
        logical_rows: Optional[int] = None,
    ):
        columns = tuple(columns)
        if columns:
            n = columns[0].row_count
            for c in columns[1:]:
                if c.row_count != n:
                    raise ValueError("column length mismatch")
        if names is not None:
            names = tuple(names)
            if len(names) != len(columns):
                raise ValueError("names/columns length mismatch")
        if logical_rows is not None:
            logical_rows = int(logical_rows)
            physical = columns[0].row_count if columns else 0
            if not 0 <= logical_rows <= physical:
                raise ValueError(
                    f"logical_rows {logical_rows} out of range for "
                    f"{physical} physical rows")
        self.columns = columns
        self.names = names
        self.logical_rows = logical_rows

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def row_count(self) -> int:
        return self.columns[0].row_count if self.columns else 0

    @property
    def logical_row_count(self) -> int:
        if self.logical_rows is not None:
            return self.logical_rows
        return self.row_count

    @property
    def is_padded(self) -> bool:
        return self.logical_rows is not None

    def column(self, key: Union[int, str]) -> Column:
        if isinstance(key, str):
            if self.names is None:
                raise KeyError("table has no column names")
            key = self.names.index(key)
        return self.columns[key]

    def __getitem__(self, key) -> Column:
        return self.column(key)

    def dtypes(self) -> tuple[dt.DType, ...]:
        return tuple(c.dtype for c in self.columns)

    @staticmethod
    def from_pydict(
        data: dict,
        dtypes: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> "Table":
        """Host constructor from numpy arrays or lists with None for nulls;
        a list of ``str``/``bytes`` makes a STRING column."""
        dev = resolve_device(device)
        cols, names = [], []
        for name, values in data.items():
            want = (dtypes or {}).get(name)
            arr = np.asarray(values)
            present = [v for v in values if v is not None]
            if present and all(isinstance(v, (str, bytes)) for v in present):
                cols.append(Column.from_strings(list(values), device=dev))
            elif arr.dtype == object:
                mask = np.array([v is not None for v in values])
                if present and all(isinstance(v, bool) for v in present):
                    filled = np.array([bool(v) for v in values], np.bool_)
                else:
                    filled = np.array([v if v is not None else 0 for v in values])
                cols.append(Column.from_numpy(filled, mask, want, dev))
            else:
                cols.append(Column.from_numpy(arr, dtype=want, device=dev))
            names.append(name)
        return Table(cols, names)

    def __repr__(self) -> str:
        parts = []
        for i, c in enumerate(self.columns):
            name = self.names[i] if self.names else f"c{i}"
            parts.append(f"{name}: {c.dtype!r}[{c.row_count}]")
        return f"Table({', '.join(parts)})"
