"""Length-prefixed frame codec of the serving daemon's wire protocol
(port of ``serving/frames.py``; the port keeps its own copy, and the
bytes are the same: the format is the contract with clients).

One frame is::

    u32_be total_len | u32_be header_len | header (UTF-8 JSON) | buffers

``total_len`` covers everything after itself. The header is a plain
JSON object carrying the command / response fields plus per-batch
buffer metadata; the raw column buffers follow concatenated, in batch
order, data-then-validity per column: the byte strings of the runtime
bridge's wire 5-tuple ``(type_ids, scales, datas, valids, num_rows)``,
so the daemon reuses ``_table_from_wire`` / ``_table_to_wire`` with no
re-encoding.

A batch is described in the header as::

    {"type_ids": [...], "scales": [...], "num_rows": n,
     "lens": [[data_len, valid_len_or_-1], ...]}

with ``-1`` meaning "no buffer follows" (a NULL-free column's validity,
or an empty data buffer encoded as length 0 vs. absent as -1).

Hello and command headers may carry ``deadline_s`` (float seconds):
on hello it sets the session's default request deadline, on a
``stream`` / ``plan`` command it bounds that one request (a
``faults.CancelToken`` checked between plan segments and stream
batches, answering ``deadline_exceeded`` when it elapses), and
``traceparent``, the W3C-style trace-context header
(``utils/tracing.py``), which the server joins for the request. A
malformed ``traceparent`` is ignored, never an error.
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional, Sequence, Tuple

# hard ceiling on one frame: a corrupt / hostile length prefix must
# fail loudly instead of allocating the universe
MAX_FRAME_BYTES = 1 << 30

_U32 = struct.Struct(">I")


class ProtocolError(RuntimeError):
    """Malformed frame: bad length prefix, truncated payload, or a
    header that is not a JSON object."""


def _recv_exact(sock, n: int) -> bytearray:
    """Read exactly ``n`` bytes into one buffer (no chunk list to join) or
    raise ConnectionError on EOF."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 24))
        if not k:
            raise ConnectionError(
                f"connection closed mid-frame ({got}/{n} bytes)"
            )
        got += k
    return buf


def send_frame(sock, header: dict, buffers: Sequence[bytes] = ()) -> None:
    """Serialize and send one frame (single ``sendall`` for the prefix +
    header; buffers follow individually to avoid concatenating large
    payloads host-side)."""
    hdr = json.dumps(header, separators=(",", ":")).encode()
    total = 4 + len(hdr) + sum(len(b) for b in buffers)
    if total > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame of {total} bytes exceeds MAX_FRAME_BYTES "
            f"({MAX_FRAME_BYTES})"
        )
    sock.sendall(_U32.pack(total) + _U32.pack(len(hdr)) + hdr)
    for b in buffers:
        if b:
            sock.sendall(b)


def recv_frame(sock) -> Tuple[dict, memoryview]:
    """Receive one frame -> ``(header, payload)`` where ``payload`` is a
    view of the concatenated buffer bytes after the header (the frame is
    read once; :func:`batch_from_parts` copies each buffer out of it)."""
    total = _U32.unpack(_recv_exact(sock, 4))[0]
    if total < 4 or total > MAX_FRAME_BYTES:
        raise ProtocolError(f"bad frame length {total}")
    body = _recv_exact(sock, total)
    hdr_len = _U32.unpack_from(body)[0]
    if hdr_len > total - 4:
        raise ProtocolError(
            f"header length {hdr_len} exceeds frame body {total - 4}"
        )
    try:
        header = json.loads(bytes(body[4:4 + hdr_len]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"undecodable frame header: {e}")
    if not isinstance(header, dict):
        raise ProtocolError(
            f"frame header must be a JSON object, got {type(header).__name__}"
        )
    return header, memoryview(body)[4 + hdr_len:]


# ---------------------------------------------------------------------------
# batch <-> (meta, buffers)
# ---------------------------------------------------------------------------


def batch_to_parts(batch) -> Tuple[dict, List[bytes]]:
    """Wire 5-tuple -> (header meta dict, ordered buffer list)."""
    type_ids, scales, datas, valids, num_rows = batch
    lens = []
    buffers: List[bytes] = []
    for d, v in zip(datas, valids):
        dl = -1 if d is None else len(d)
        vl = -1 if v is None else len(v)
        lens.append([dl, vl])
        if d is not None:
            buffers.append(bytes(d))
        if v is not None:
            buffers.append(bytes(v))
    return (
        {
            "type_ids": [int(t) for t in type_ids],
            "scales": [int(s) for s in scales],
            "num_rows": int(num_rows),
            "lens": lens,
        },
        buffers,
    )


def batch_from_parts(meta: dict, payload: bytes, offset: int):
    """(header meta, payload, offset) -> (wire 5-tuple, next offset)."""
    try:
        type_ids = meta["type_ids"]
        scales = meta["scales"]
        num_rows = int(meta["num_rows"])
        lens = meta["lens"]
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"malformed batch meta: {e}")
    if not (len(type_ids) == len(scales) == len(lens)):
        raise ProtocolError(
            f"batch meta arity mismatch: {len(type_ids)} type_ids, "
            f"{len(scales)} scales, {len(lens)} lens"
        )
    datas: List[Optional[bytes]] = []
    valids: List[Optional[bytes]] = []
    for dl, vl in lens:
        if dl < 0:
            datas.append(None)
        else:
            if offset + dl > len(payload):
                raise ProtocolError("truncated batch payload")
            datas.append(bytes(payload[offset:offset + dl]))
            offset += dl
        if vl < 0:
            valids.append(None)
        else:
            if offset + vl > len(payload):
                raise ProtocolError("truncated batch payload")
            valids.append(bytes(payload[offset:offset + vl]))
            offset += vl
    return (type_ids, scales, datas, valids, num_rows), offset


def batches_to_parts(batches) -> Tuple[List[dict], List[bytes]]:
    """Many wire 5-tuples -> (meta list, one ordered buffer list)."""
    metas: List[dict] = []
    buffers: List[bytes] = []
    for b in batches:
        m, bufs = batch_to_parts(b)
        metas.append(m)
        buffers.extend(bufs)
    return metas, buffers


def batches_from_parts(metas, payload: bytes) -> list:
    """(meta list, payload) -> list of wire 5-tuples."""
    out = []
    offset = 0
    for m in metas:
        b, offset = batch_from_parts(m, payload, offset)
        out.append(b)
    return out
