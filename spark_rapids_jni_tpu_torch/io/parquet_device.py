"""Parquet page decode on the device: PLAIN and RLE/dictionary pages of
fixed-width columns (port of the JAX package's ``io/parquet_device.py``).

  host    reads the raw column-chunk bytes, parses the page headers (a
          minimal Thrift compact-protocol reader: pyarrow exposes no
          page-level API), decompresses the codec (snappy/zstd through
          ``pyarrow.Codec``) and parses the RLE run headers only:
          O(#runs), not O(values).
  upload  the still-encoded payload bytes (pinned staging, copies on
          the current stream): a dictionary-encoded page is several
          times smaller than its decoded column.
  device  everything O(n), as torch ops: definition levels -> validity
          and the compaction gather, bit-field extraction of dictionary
          indices (a searchsorted over the run table, a 4-byte window
          gather and a shift), the dictionary gather, and PLAIN bytes
          reinterpreted in place.

Scope: fixed-width physical types (INT32/INT64/FLOAT/DOUBLE, with the
DECIMAL and DATE logical types stored on them), PLAIN and
RLE_DICTIONARY/PLAIN_DICTIONARY encodings, v1 data pages, flat schemas.
Any other column raises ``_Unsupported`` and is decoded by Arrow
(``io/parquet.py``), so ``scan_parquet(..., device_decode=True)`` gives
the Arrow path's values whichever path a column takes.
"""

from __future__ import annotations

import dataclasses
import struct as _struct

import numpy as np
import torch

from .. import dtype as dt
from ..column import Column, upload

# parquet-format enums (format/Encodings.md)
_PAGE_DATA = 0
_PAGE_INDEX = 1
_PAGE_DICT = 2
_PAGE_DATA_V2 = 3
_ENC_PLAIN = 0
_ENC_PLAIN_DICT = 2
_ENC_RLE = 3
_ENC_RLE_DICT = 8

_PHYS_WIDTH = {  # parquet physical type id -> byte width
    1: 4,   # INT32
    2: 8,   # INT64
    4: 4,   # FLOAT
    5: 8,   # DOUBLE
}
# torch dtype each physical type's bytes are read as: DOUBLE as its bit
# pattern in int64, the port's FLOAT64 storage (dtype.py)
_PHYS_TORCH = {1: torch.int32, 2: torch.int64, 4: torch.float32,
               5: torch.int64}


class _Unsupported(Exception):
    """The column can't take the device path; the caller falls back to
    Arrow."""


# ---------------------------------------------------------------------------
# host: Thrift compact-protocol PageHeader reader
# ---------------------------------------------------------------------------


class _Compact:
    """Just enough of the Thrift compact protocol to walk PageHeader
    structs (parquet-format.thrift): varints, zigzag, field skipping."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def skip(self, ftype: int) -> None:
        if ftype in (1, 2):       # bool true/false: the value is the type
            return
        if ftype == 3:            # byte
            self.pos += 1
        elif ftype in (4, 5, 6):  # i16/i32/i64
            self.varint()
        elif ftype == 7:          # double
            self.pos += 8
        elif ftype == 8:          # binary
            # not `self.pos += self.varint()`: the augmented assignment
            # loads pos before varint() advances it
            n = self.varint()
            self.pos += n
        elif ftype in (9, 10):    # list/set
            head = self.byte()
            size = head >> 4
            etype = head & 0x0F
            if size == 15:
                size = self.varint()
            for _ in range(size):
                self.skip(etype)
        elif ftype == 12:         # struct
            self.struct_skip()
        else:  # map etc. do not appear in a PageHeader
            raise _Unsupported(f"unsupported thrift compact type {ftype}")

    def struct_skip(self) -> None:
        last = 0
        while True:
            head = self.byte()
            if head == 0:
                return
            delta = head >> 4
            ftype = head & 0x0F
            last = last + delta if delta else self.zigzag()
            self.skip(ftype)

    def struct_fields(self) -> dict:
        """One struct as {field_id: value}: integers decoded,
        sub-structs recursed, everything else skipped."""
        out = {}
        last = 0
        while True:
            head = self.byte()
            if head == 0:
                return out
            delta = head >> 4
            ftype = head & 0x0F
            fid = last + delta if delta else self.zigzag()
            last = fid
            if ftype == 1:
                out[fid] = True
            elif ftype == 2:
                out[fid] = False
            elif ftype in (4, 5, 6):
                out[fid] = self.zigzag()
            elif ftype == 12:
                out[fid] = self.struct_fields()
            else:
                self.skip(ftype)


@dataclasses.dataclass
class _Page:
    kind: int
    num_values: int
    encoding: int
    def_encoding: int
    payload: bytes  # decompressed


def _decompress(codec: str, buf: bytes, uncompressed_size: int) -> bytes:
    if codec in ("UNCOMPRESSED", None):
        return buf
    import pyarrow as pa

    try:
        return (pa.Codec(codec.lower())
                .decompress(buf, decompressed_size=uncompressed_size)
                .to_pybytes())
    except (pa.ArrowException, OSError, ValueError) as e:
        # an unknown codec name (ArrowInvalid) or a corrupt or truncated
        # buffer (the codecs raise OSError): Arrow decodes the column
        raise _Unsupported(f"codec {codec}: {e}") from e


def _header_field(hdr: dict, fid: int):
    if fid not in hdr:
        raise _Unsupported(f"page header without field {fid}")
    return hdr[fid]


def read_chunk_pages(f, colmeta) -> list:
    """Walk one column chunk's raw bytes into decompressed pages."""
    offsets = [colmeta.data_page_offset]
    # truthiness also rejects 0: no page starts at the PAR1 magic, and
    # some writers give "no dictionary" as 0 rather than None
    if colmeta.dictionary_page_offset:
        offsets.append(colmeta.dictionary_page_offset)
    start = min(offsets)
    f.seek(start)
    raw = f.read(colmeta.total_compressed_size)
    codec = colmeta.compression
    pages = []
    pos = 0
    while pos < len(raw):
        rd = _Compact(raw, pos)
        hdr = rd.struct_fields()
        pos = rd.pos
        comp_size = _header_field(hdr, 3)
        unc_size = _header_field(hdr, 2)
        payload = _decompress(codec, raw[pos:pos + comp_size], unc_size)
        pos += comp_size
        kind = _header_field(hdr, 1)
        if kind == _PAGE_DICT:
            sub = hdr.get(7, {})
            pages.append(_Page(kind, sub.get(1, 0), sub.get(2, 0), 0, payload))
        elif kind == _PAGE_DATA:
            sub = hdr.get(5, {})
            pages.append(_Page(kind, sub.get(1, 0), sub.get(2, 0),
                               sub.get(3, 0), payload))
        else:
            # v2 and index pages: the whole chunk falls back to Arrow
            raise _Unsupported(f"page type {kind}")
    return pages


# ---------------------------------------------------------------------------
# host: RLE/bit-packed hybrid run-header parse — O(#runs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _RunTable:
    out_start: np.ndarray   # (R,) int32 first output index of each run
    is_packed: np.ndarray   # (R,) bool
    value: np.ndarray       # (R,) int32 repeated value (RLE runs)
    bit_base: np.ndarray    # (R,) int64 payload bit offset (packed runs)
    consumed: int           # payload bytes consumed


def parse_rle_runs(buf: bytes, bit_width: int, num_values: int) -> _RunTable:
    pos = 0
    out = 0
    starts, packed, values, bases = [], [], [], []
    vbytes = (bit_width + 7) // 8
    while out < num_values:
        if pos >= len(buf):
            raise _Unsupported("RLE stream truncated")
        rd = _Compact(buf, pos)
        header = rd.varint()
        pos = rd.pos
        if header & 1:
            groups = header >> 1
            starts.append(out)
            packed.append(True)
            values.append(0)
            bases.append(pos * 8)
            pos += groups * bit_width
            out += groups * 8
        else:
            count = header >> 1
            if count == 0:
                raise _Unsupported("zero-length RLE run")
            v = int.from_bytes(buf[pos:pos + vbytes], "little")
            starts.append(out)
            packed.append(False)
            values.append(v)
            bases.append(0)
            pos += vbytes
            out += count
    return _RunTable(
        np.asarray(starts, np.int32),
        np.asarray(packed, np.bool_),
        np.asarray(values, np.int32),
        np.asarray(bases, np.int64),
        pos,
    )


# ---------------------------------------------------------------------------
# device: the O(n) decode, as torch ops on the payload's device
# ---------------------------------------------------------------------------


def _upload_bytes(buf: bytes, device: torch.device) -> torch.Tensor:
    """Encoded bytes as a uint8 tensor on ``device`` (its own storage, so
    a PLAIN section can be viewed as its value type in place)."""
    return upload(np.frombuffer(buf, np.uint8), device)


def _device_expand_runs(runs: _RunTable, packed_bytes: torch.Tensor,
                        bit_width: int, n: int) -> torch.Tensor:
    """(n,) int32 values of an RLE/bit-packed hybrid stream: for each
    output one searchsorted over the run table, then for packed runs a
    4-byte gather, a shift and a mask. The window reads zeros for the
    4 bytes past the payload's end, as the JAX package's zero-padded
    buffer does."""
    if bit_width > 24:
        # a 4-byte window can't always cover a >24-bit field that
        # crosses a byte boundary
        raise _Unsupported(f"bit width {bit_width} > 24")
    dev = packed_bytes.device
    if len(runs.out_start) == 0:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    out_start = upload(runs.out_start, dev).to(torch.int64)
    is_packed = upload(runs.is_packed, dev)
    value = upload(runs.value, dev)
    bit_base = upload(runs.bit_base, dev)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    r = (torch.searchsorted(out_start, pos, right=True) - 1).clamp_(
        0, out_start.shape[0] - 1)
    bit = bit_base[r] + (pos - out_start[r]) * bit_width
    byte = bit >> 3
    payload = torch.cat([packed_bytes,
                         torch.zeros(4, dtype=torch.uint8, device=dev)])
    last = payload.shape[0] - 1
    word = torch.zeros(n, dtype=torch.int64, device=dev)
    for k in range(4):
        word |= payload[(byte + k).clamp_(max=last)].to(torch.int64) << (8 * k)
    extracted = ((word >> (bit & 7)) & ((1 << bit_width) - 1)).to(torch.int32)
    return torch.where(is_packed[r], extracted, value[r])


def _defined_count(runs: _RunTable, buf: bytes, n: int) -> int:
    """Exact host count of definition level 1 — O(#runs) plus a popcount
    over the bit-packed sections (1 bit a value). A dictionary page's
    index stream holds only the defined values, so the index parse needs
    this count."""
    total = 0
    starts = runs.out_start
    for i in range(len(starts)):
        start = int(starts[i])
        end = int(starts[i + 1]) if i + 1 < len(starts) else n
        end = min(end, n)
        run_len = max(0, end - start)
        if run_len == 0:
            continue
        if runs.is_packed[i]:
            base = int(runs.bit_base[i]) // 8
            nbytes = (run_len + 7) // 8
            bits = np.unpackbits(
                np.frombuffer(buf[base:base + nbytes], np.uint8),
                bitorder="little",
            )[:run_len]
            total += int(bits.sum())
        elif int(runs.value[i]) == 1:
            total += run_len
    return total


def _device_defined(def_runs, def_bytes, n: int, device) -> torch.Tensor:
    """Definition levels (flat schema: max level 1) -> (n,) bool."""
    if def_runs is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    return _device_expand_runs(def_runs, def_bytes, 1, n) == 1


def _device_plain(values_u8: torch.Tensor, phys_id: int,
                  n_defined_cap: int) -> torch.Tensor:
    """PLAIN page payload -> (n,) values: the little-endian bytes viewed
    as the physical type (DOUBLE as its int64 bit pattern), so NaN
    payloads, -0.0 and subnormals come through unchanged."""
    width = _PHYS_WIDTH[phys_id]
    n = min(n_defined_cap, values_u8.shape[0] // width)
    if n == 0:
        return torch.empty(0, dtype=_PHYS_TORCH[phys_id],
                           device=values_u8.device)
    return values_u8[:n * width].view(_PHYS_TORCH[phys_id])


# ---------------------------------------------------------------------------
# column assembly
# ---------------------------------------------------------------------------


def _gather_source(vals: torch.Tensor, what: str) -> torch.Tensor:
    # the JAX package's gather from an empty array fails, and that
    # column goes to Arrow: so does this one (an all-null chunk)
    if vals.shape[0] == 0:
        raise _Unsupported(f"empty {what}")
    return vals


def _decode_data_page(page: _Page, phys_id: int, nullable: bool,
                      dict_vals, device):
    """One v1 data page -> (values (n,), defined (n,) bool)."""
    n = page.num_values
    buf = page.payload
    pos = 0
    def_runs = None
    def_bytes = None
    raw_def = b""
    if nullable:
        if page.def_encoding != _ENC_RLE:
            raise _Unsupported("non-RLE definition levels")
        (dl,) = _struct.unpack_from("<i", buf, pos)
        pos += 4
        raw_def = buf[pos:pos + dl]
        def_runs = parse_rle_runs(raw_def, 1, n)
        def_bytes = _upload_bytes(raw_def, device)
        pos += dl
    defined = _device_defined(def_runs, def_bytes, n, device)
    # the dense value stream holds the defined values only
    n_dense = n if def_runs is None else _defined_count(def_runs, raw_def, n)

    if page.encoding == _ENC_PLAIN:
        vals_dense = _device_plain(_upload_bytes(buf[pos:], device), phys_id,
                                   max(n_dense, 1))
    elif page.encoding in (_ENC_PLAIN_DICT, _ENC_RLE_DICT):
        if dict_vals is None:
            raise _Unsupported("dictionary page missing")
        bw = buf[pos]
        pos += 1
        if bw == 0:
            idx_dense = torch.zeros(max(n_dense, 1), dtype=torch.int64,
                                    device=device)
        else:
            runs = parse_rle_runs(buf[pos:], bw, max(n_dense, 1))
            packed = _upload_bytes(buf[pos:pos + runs.consumed], device)
            idx_dense = _device_expand_runs(runs, packed, bw,
                                            max(n_dense, 1)).to(torch.int64)
        source = _gather_source(dict_vals, "dictionary")
        vals_dense = source[idx_dense.clamp_(0, source.shape[0] - 1)]
    else:
        raise _Unsupported(f"encoding {page.encoding}")

    if not nullable:
        return vals_dense[:n], defined

    # row i reads dense slot cumsum(defined) - 1; null rows read any
    # slot and are zeroed
    source = _gather_source(vals_dense, "value stream")
    slot = torch.cumsum(defined, 0) - 1
    vals = source[slot.clamp_(0, source.shape[0] - 1)]
    return torch.where(defined, vals, torch.zeros((), dtype=vals.dtype,
                                                  device=device)), defined


def decode_column_chunk(f, colmeta, field_dtype: dt.DType, nullable: bool,
                        device="cuda") -> Column:
    """One row group x one column -> a Column on ``device``, or
    ``_Unsupported``. ``nullable`` is the schema field's nullability:
    pyarrow writes definition levels for every optional field, nulls
    present or not, and the column then carries a validity vector."""
    device = torch.device(device)
    phys_id = {"INT32": 1, "INT64": 2, "FLOAT": 4, "DOUBLE": 5}.get(
        colmeta.physical_type)
    if phys_id is None:
        raise _Unsupported(f"physical type {colmeta.physical_type}")
    pages = read_chunk_pages(f, colmeta)
    dict_vals = None
    parts, masks = [], []
    for p in pages:
        if p.kind == _PAGE_DICT:
            if p.encoding not in (_ENC_PLAIN, _ENC_PLAIN_DICT):
                raise _Unsupported("non-PLAIN dictionary page")
            dict_vals = _device_plain(_upload_bytes(p.payload, device),
                                      phys_id, p.num_values)
        else:
            vals, defined = _decode_data_page(p, phys_id, nullable,
                                              dict_vals, device)
            parts.append(vals)
            masks.append(defined)
    if not parts:
        raise _Unsupported("no data pages")
    vals = parts[0] if len(parts) == 1 else torch.cat(parts)
    validity = None
    if nullable:
        validity = masks[0] if len(masks) == 1 else torch.cat(masks)
    if field_dtype.storage_dtype != vals.dtype:
        # logical narrowing: INT8/16 and UINT8/16/32 stored as INT32,
        # UINT64 as INT64 (a conversion, which wraps as the JAX astype)
        vals = vals.to(field_dtype.storage_dtype)
    return Column(vals, field_dtype, validity)


def decode_row_group(path: str, pf, rg: int, columns,
                     device="cuda") -> tuple:
    """Try the device path for every requested column of one row group.

    Returns ``(decoded {name: Column}, fallback [names])``: the caller
    reads the fallback columns through Arrow and reassembles the order.
    A column falls back on the failures that mean "Arrow decodes this
    one": ``_Unsupported`` (an encoding, page kind or physical type out
    of scope, a codec error), and a truncated chunk or short payload
    (``IndexError``, ``struct.error``); an Arrow type the port does not
    map falls back too, so Arrow's reader raises its ``TypeError``. Any
    other error (a torch or CUDA failure) propagates."""
    from ..interop import _arrow_type_to_dtype as dtype_from_arrow

    schema = pf.schema_arrow
    rgmeta = pf.metadata.row_group(rg)
    name_to_ci = {rgmeta.column(ci).path_in_schema: ci
                  for ci in range(rgmeta.num_columns)}
    decoded = {}
    fallback = []
    with open(path, "rb") as f:
        for name in columns:
            ci = name_to_ci.get(name)
            if ci is None:
                fallback.append(name)
                continue
            field = schema.field(name)
            try:
                fdt = dtype_from_arrow(field.type)
            except TypeError:
                fallback.append(name)
                continue
            try:
                decoded[name] = decode_column_chunk(
                    f, rgmeta.column(ci), fdt, field.nullable, device)
            except (_Unsupported, IndexError, _struct.error):
                fallback.append(name)
    return decoded, fallback
