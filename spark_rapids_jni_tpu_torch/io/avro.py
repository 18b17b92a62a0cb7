"""Avro object container files: read and write (port of the JAX
package's ``io/avro.py``).

A self-contained codec, pure Python with ``zlib``: header and schema
parse, zigzag varints, the ``null`` and ``deflate`` codecs, one value at
a time. Record fields may be Avro primitives (boolean/int/long/float/
double/string/bytes) or the nullable union ``["null", <primitive>]``,
cudf's Avro reader scope; anything else raises. Decoded columns upload
once, with the same projection and device filter as the other readers.
The writer round-trips tables for tests and interop.
"""

from __future__ import annotations

import io as _io
import json
import os
import struct as _struct
import zlib
from typing import Optional, Sequence, Union

import torch
from torch.profiler import record_function

from .. import dtype as dt
from ..column import Table, resolve_device
from . import predicates as preds

_MAGIC = b"Obj\x01"

_PRIMITIVES = {"boolean", "int", "long", "float", "double", "string", "bytes"}

_AVRO_TO_DTYPE = {
    "boolean": dt.BOOL8,
    "int": dt.INT32,
    "long": dt.INT64,
    "float": dt.FLOAT32,
    "double": dt.FLOAT64,
    "string": dt.STRING,
    "bytes": dt.STRING,
}


# ---------------------------------------------------------------------------
# varint / zigzag primitives
# ---------------------------------------------------------------------------


def _read_long(buf: _io.BytesIO) -> int:
    """Zigzag varint (Avro int and long share the encoding)."""
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        v = b[0]
        acc |= (v & 0x7F) << shift
        if not (v & 0x80):
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _write_long(out: bytearray, v: int) -> None:
    z = (v << 1) ^ (v >> 63) if v < 0 else (v << 1)
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            break


def _read_bytes(buf: _io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated bytes")
    return data


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------


def _field_plan(field: dict) -> tuple:
    """(name, primitive type, null-branch index) of one record field (-1:
    not nullable); raises outside the primitive scope. A union may put
    its null branch first or second: the wire index follows the
    declaration order."""
    name = field["name"]
    t = field["type"]
    null_branch = -1
    if isinstance(t, list):
        branches = [b for b in t if b != "null"]
        if len(branches) != 1 or len(t) > 2:
            raise TypeError(
                f"avro field {name!r}: only two-branch null unions "
                f"are supported, got {t}")
        if "null" in t:
            null_branch = t.index("null")
        t = branches[0]
    if isinstance(t, dict):
        t = t.get("type", t)
    if t not in _PRIMITIVES:
        raise TypeError(
            f"avro field {name!r}: unsupported type {t!r} (primitive "
            "types only, matching the cudf Avro reader scope)")
    return name, t, null_branch


def _parse_schema(meta: dict) -> list:
    schema = json.loads(meta[b"avro.schema"].decode())
    if isinstance(schema, dict) and schema.get("type") == "record":
        return [_field_plan(f) for f in schema.get("fields", [])]
    raise TypeError("avro: top-level schema must be a record")


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _read_header(f) -> tuple:
    if f.read(4) != _MAGIC:
        raise ValueError("not an Avro object container file")
    buf = _io.BytesIO(f.read())
    meta = {}
    while True:
        count = _read_long(buf)
        if count == 0:
            break
        if count < 0:  # a block with a byte size prefix
            _read_long(buf)
            count = -count
        for _ in range(count):
            k = _read_bytes(buf)
            meta[k] = _read_bytes(buf)
    sync = buf.read(16)
    return meta, sync, buf


def _decode_value(buf: _io.BytesIO, typ: str):
    if typ == "boolean":
        return buf.read(1)[0] != 0
    if typ in ("int", "long"):
        return _read_long(buf)
    if typ == "float":
        return _struct.unpack("<f", buf.read(4))[0]
    if typ == "double":
        return _struct.unpack("<d", buf.read(8))[0]
    raw = _read_bytes(buf)  # string / bytes
    return raw.decode("utf-8", "surrogateescape") if typ == "string" else raw


def read_avro(
    path,
    columns: Optional[Sequence[str]] = None,
    filters=None,
    pad_widths: Optional[dict] = None,
    device: Union[str, torch.device] = "cuda",
) -> Table:
    """Avro container file -> Table on ``device`` (projection + device
    filter)."""
    from .parquet import _apply_exact_filter

    dev = resolve_device(device)
    predicate = preds.from_dnf(filters) if filters is not None else None
    with record_function("io.avro.parse"), open(path, "rb") as f:
        meta, sync, buf = _read_header(f)
        plan = _parse_schema(meta)
        codec = meta.get(b"avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            raise ValueError(f"avro codec {codec!r} not supported")
        values: dict = {name: [] for name, _, _ in plan}
        while True:
            try:
                nrecords = _read_long(buf)
            except EOFError:
                break
            nbytes = _read_long(buf)
            block = buf.read(nbytes)
            if len(block) != nbytes:
                raise EOFError("truncated avro block")
            if codec == "deflate":
                block = zlib.decompress(block, -15)
            bbuf = _io.BytesIO(block)
            for _ in range(nrecords):
                for name, typ, null_branch in plan:
                    if null_branch >= 0:
                        branch = _read_long(bbuf)
                        if branch == null_branch:
                            values[name].append(None)
                            continue
                    values[name].append(_decode_value(bbuf, typ))
            if buf.read(16) != sync:
                raise ValueError("avro sync-marker mismatch")

    want, read_cols = preds.projection_columns(predicate, columns,
                                               list(values.keys()))
    # the decode set only, typed by the Avro schema: inference from the
    # values would widen float to float64 and type a 0-row file anyhow
    dtypes = {name: _AVRO_TO_DTYPE[typ] for name, typ, _ in plan
              if name in read_cols}
    out = Table.from_pydict({k: values[k] for k in read_cols},
                            dtypes=dtypes, pad_widths=pad_widths, device=dev)
    if predicate is not None:
        with record_function("io.avro.filter"):
            out = _apply_exact_filter(out, predicate, want)
    return out


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_AVRO_TYPE = {
    dt.TypeId.INT64: "long", dt.TypeId.INT32: "int", dt.TypeId.INT16: "int",
    dt.TypeId.INT8: "int", dt.TypeId.UINT8: "int", dt.TypeId.UINT16: "int",
    dt.TypeId.UINT32: "long", dt.TypeId.FLOAT64: "double",
    dt.TypeId.FLOAT32: "float", dt.TypeId.BOOL8: "boolean",
    dt.TypeId.STRING: "string",
    # a decimal goes out as its unscaled integer
    dt.TypeId.DECIMAL32: "int", dt.TypeId.DECIMAL64: "long",
}


def write_avro(table: Table, path, codec: str = "null") -> None:
    """Table -> Avro container file (primitive columns)."""
    if codec not in ("null", "deflate"):
        raise ValueError(f"avro codec {codec!r} not supported")
    names = (list(table.names) if table.names is not None
             else [f"c{i}" for i in range(len(table.columns))])
    plan = []
    pylists = []
    for name, col in zip(names, table.columns):
        typ = _AVRO_TYPE.get(col.dtype.id)
        if typ is None:
            raise TypeError(f"avro writer: unsupported column dtype {col.dtype}")
        vals = col.to_pylist()
        plan.append((name, typ, any(v is None for v in vals)))
        pylists.append(vals)

    schema = {
        "type": "record",
        "name": "spark_rapids_tpu",
        "fields": [{"name": n, "type": (["null", t] if nullable else t)}
                   for n, t, nullable in plan],
    }
    body = bytearray()
    n_rows = table.row_count
    for i in range(n_rows):
        for (name, typ, nullable), vals in zip(plan, pylists):
            v = vals[i]
            if nullable:
                _write_long(body, 0 if v is None else 1)
                if v is None:
                    continue
            if typ == "boolean":
                body.append(1 if v else 0)
            elif typ in ("int", "long"):
                _write_long(body, int(v))
            elif typ == "float":
                body += _struct.pack("<f", float(v))
            elif typ == "double":
                body += _struct.pack("<d", float(v))
            else:
                raw = (v.encode("utf-8", "surrogateescape")
                       if isinstance(v, str) else bytes(v))
                _write_long(body, len(raw))
                body += raw
    payload = bytes(body)
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        payload = comp.compress(payload) + comp.flush()

    sync = os.urandom(16)
    out = bytearray(_MAGIC)
    meta = {b"avro.schema": json.dumps(schema).encode(),
            b"avro.codec": codec.encode()}
    _write_long(out, len(meta))
    for k, v in meta.items():
        _write_long(out, len(k))
        out += k
        _write_long(out, len(v))
        out += v
    _write_long(out, 0)
    out += sync
    if n_rows:
        _write_long(out, n_rows)
        _write_long(out, len(payload))
        out += payload
        out += sync
    with open(path, "wb") as f:
        f.write(bytes(out))
