"""Durable serving: crash-safe checkpoint and restore of sessions (port
of ``serving/durable.py``).

Every namespace mutation (upload / plan output / free / bye) is
journaled to a per-session write-ahead log before the response leaves
the process, table payloads are checkpointed through the spill tier's
``.npz`` serde (``spill.save_table_npz``), and on restart the daemon
replays the journals to recover session namespaces, memory accounting
and budgets, then replays every plan it served before from the
warm-start manifest, before the listener accepts traffic.

Journal format (``<sid>.wal`` in the checkpoint directory), byte for
byte the JAX package's, so either package restores the other's:

* header: the 6-byte magic ``SRTJ1\\n``
* records: ``u32 LE payload length | u32 LE crc32(payload) | payload``
  where payload is UTF-8 JSON. Appends are flushed and ``fsync``'d;
  payload ``.npz`` files are written tmp + fsync + atomic rename BEFORE
  their journal record, so a record always points at a whole payload.

Recovery:

* a **torn tail** (a crash mid-append) recovers to the last complete
  record; the incomplete bytes are truncated and counted
  (``restore.torn_records``);
* **mid-file corruption** (a bad CRC with more data after it) raises the
  typed :class:`CheckpointCorrupt` and the session is **quarantined**
  (journal renamed ``.quarantined``): the daemon serves every other
  session and never a partial table;
* a journal whose last record is ``bye`` is a cleanly closed session;
  its files are erased at scan time.

The warm start differs in meaning from the JAX package's: there is no
executable to compile, so :meth:`Manifest.warm_start` replays each
recorded plan once on zero-filled tables on the server's device, which
fills the bucketed runner cache (``utils/buckets.py``) and loads the
kernels; ``restore.warm_compiles`` counts those replays.

With ``SPARK_RAPIDS_TPU_DURABLE=off`` (the default) a mutation costs one
cached generation compare.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import tempfile
import uuid
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import config, faults, flight, lockcheck, log, metrics, spill

_MAGIC = b"SRTJ1\n"
_FRAME = struct.Struct("<II")
DEDUP_CAP = 512  # idempotency window per session (request ids)


# ---------------------------------------------------------------------------
# typed errors (wired into server._ERROR_TYPES / client._ERROR_CLASSES)
# ---------------------------------------------------------------------------


class CheckpointCorrupt(faults.PermanentError):
    """A journal or payload whose integrity check failed mid-file: the
    session's durable state cannot be trusted, so it is quarantined —
    corrupt data is never served, partially or otherwise."""


class ResumeDenied(Exception):
    """A hello named an existing durable session but carried a missing
    or wrong resume token — another client's session is not yours."""


class SessionQuarantined(Exception):
    """The session's durable state was quarantined during restore; its
    tables are unrecoverable and a fresh session must be opened."""


class Draining(Exception):
    """The daemon is draining for a rolling restart: no new sessions or
    device work; in-flight work finishes, then the daemon exits."""


# ---------------------------------------------------------------------------
# flag gate + directory
# ---------------------------------------------------------------------------

_GATE = (None, False)


def enabled() -> bool:
    global _GATE
    gen = config.generation()
    if _GATE[0] != gen:
        _GATE = (gen, bool(config.get_flag("DURABLE")))
    return _GATE[1]


def checkpoint_dir() -> str:
    """Directory for journals, payloads, and the warm-start manifest;
    created lazily. Unlike the spill scratch dir the default is STABLE
    across processes (no pid) — a checkpoint only earns its fsyncs by
    outliving the process that wrote it."""
    d = str(config.get_flag("CHECKPOINT_DIR") or "").strip()
    if not d:
        d = os.path.join(tempfile.gettempdir(), "srt-checkpoint")
    os.makedirs(d, exist_ok=True)
    return d


def new_resume_token() -> str:
    return uuid.uuid4().hex


# ---------------------------------------------------------------------------
# counters: metrics (checkpoint.* / restore.*) + an always-on mirror so
# server.stats() has a durability block even with METRICS off
# ---------------------------------------------------------------------------

_STATS_LOCK = lockcheck.make_lock("durable.stats")
_STATS: Dict[str, int] = {}


def count(name: str, n: int = 1, as_bytes: bool = False) -> None:
    with _STATS_LOCK:
        _STATS[name] = _STATS.get(name, 0) + int(n)
    if as_bytes:
        metrics.bytes_add(name, n)
    else:
        metrics.counter_add(name, n)


def stats_doc() -> dict:
    with _STATS_LOCK:
        doc = dict(sorted(_STATS.items()))
    doc["enabled"] = enabled()
    return doc


def reset() -> None:
    """Test hook: zero the counter mirror (files are the caller's)."""
    with _STATS_LOCK:
        _STATS.clear()


# ---------------------------------------------------------------------------
# journal: CRC-framed, fsync'd, append-only
# ---------------------------------------------------------------------------


class Journal:
    """One append-only record log. Thread-safe appends; each append is
    flushed and fsync'd before returning — a mutation acknowledged to
    the client is on disk. The ``checkpoint`` fault site emulates a
    torn write here: half the frame is persisted, then the typed fault
    raises. A later append self-heals by truncating back to the last
    good offset first (the recover-the-tail discipline of real WALs)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = lockcheck.make_lock("durable.journal")
        self._f = open(path, "ab")
        size = os.fstat(self._f.fileno()).st_size
        if size == 0:
            self._f.write(_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
            size = len(_MAGIC)
        self._good = size

    def append(self, record: dict) -> None:
        payload = json.dumps(record, sort_keys=True).encode()
        frame = _FRAME.pack(
            len(payload), zlib.crc32(payload) & 0xFFFFFFFF
        ) + payload
        with self._lock:
            if self._f.closed:
                raise CheckpointCorrupt(
                    f"{self.path}: journal is closed"
                )
            size = os.fstat(self._f.fileno()).st_size
            if size != self._good:
                # a previous append tore (injected fault): recover the
                # tail before writing, keeping the journal parseable
                self._f.truncate(self._good)
            try:
                faults.inject("checkpoint")
            except faults.FaultError:
                self._f.write(frame[: max(len(frame) // 2, 1)])
                self._f.flush()
                with contextlib.suppress(OSError):
                    os.fsync(self._f.fileno())
                raise
            self._f.write(frame)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._good = os.fstat(self._f.fileno()).st_size

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def read_journal(path: str) -> Tuple[List[dict], int, int]:
    """Parse a journal. Returns ``(records, torn, good_off)`` where
    ``torn`` counts incomplete trailing records (0 or 1) and
    ``good_off`` is the byte offset of the last complete record's end.
    Raises :class:`CheckpointCorrupt` for a bad magic or a CRC/decode
    failure that is NOT the file tail — torn tails recover, corruption
    quarantines."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_MAGIC):
        raise CheckpointCorrupt(f"{path}: bad journal magic")
    off = len(_MAGIC)
    n = len(blob)
    records: List[dict] = []
    torn = 0
    while off < n:
        if off + _FRAME.size > n:
            torn = 1  # header truncated mid-append
            break
        length, crc = _FRAME.unpack_from(blob, off)
        end = off + _FRAME.size + length
        if end > n:
            torn = 1  # payload truncated mid-append
            break
        payload = blob[off + _FRAME.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            if end == n:
                torn = 1  # full-length tail frame with torn payload
                break
            raise CheckpointCorrupt(
                f"{path}: CRC mismatch at offset {off} with "
                f"{n - end} byte(s) after it — mid-journal corruption"
            )
        try:
            records.append(json.loads(payload.decode()))
        except ValueError:
            if end == n:
                torn = 1
                break
            raise CheckpointCorrupt(
                f"{path}: undecodable record at offset {off}"
            )
        off = end
    return records, torn, off


# ---------------------------------------------------------------------------
# per-session WAL + payload files
# ---------------------------------------------------------------------------


def _payload_name(sid: str, local: int) -> str:
    return f"{sid}-t{int(local)}.npz"


class SessionLog:
    """One session's durable state: ``<sid>.wal`` plus one ``.npz``
    payload per live table. Local ids are never reused within a
    session, so payload filenames never collide."""

    def __init__(self, sid: str, dirpath: Optional[str] = None):
        self.sid = sid
        self.dir = dirpath or checkpoint_dir()
        self.path = os.path.join(self.dir, f"{sid}.wal")
        self._journal = Journal(self.path)

    def _payload_path(self, local: int) -> str:
        return os.path.join(self.dir, _payload_name(self.sid, local))

    def _unlink_payload(self, local: int) -> None:
        with contextlib.suppress(OSError):
            os.unlink(self._payload_path(local))

    def log_open(self, name: str, weight: float, budget: int,
                 token: str) -> None:
        self._journal.append({
            "t": "open", "name": name, "weight": float(weight),
            "budget": int(budget), "token": token,
        })
        count("checkpoint.records")

    def log_put(self, local: int, table, nbytes: int,
                drop: Optional[int] = None, req: Optional[str] = None,
                resp: Optional[dict] = None) -> None:
        """Checkpoint one namespace put: payload first (atomic), then
        the journal record naming it — a record never points at a
        missing or partial payload. ``drop`` is the local id of a
        donated (consumed) plan input, removed in the same record."""
        path = self._payload_path(local)
        with metrics.span("checkpoint.put"):
            faults.inject("checkpoint")
            disk_bytes = spill.save_table_npz(path, table)
            rec = {
                "t": "put", "local": int(local), "bytes": int(nbytes),
                "file": _payload_name(self.sid, local),
            }
            if drop is not None:
                rec["drop"] = int(drop)
            if req:
                rec["req"] = str(req)
                rec["resp"] = dict(resp or {})
            self._journal.append(rec)
        count("checkpoint.records")
        count("checkpoint.tables")
        count("checkpoint.bytes", disk_bytes, as_bytes=True)
        if drop is not None:
            self._unlink_payload(drop)
        if flight.enabled():
            flight.record("I", "checkpoint.put", f"{self.sid}:{local}")

    def log_free(self, local: int, nbytes: int,
                 req: Optional[str] = None,
                 resp: Optional[dict] = None) -> None:
        rec = {"t": "free", "local": int(local), "bytes": int(nbytes)}
        if req:
            rec["req"] = str(req)
            rec["resp"] = dict(resp or {})
        self._journal.append(rec)
        count("checkpoint.records")
        self._unlink_payload(local)

    def log_bye(self) -> None:
        """Clean close: journal the bye, then erase — a byed session
        has nothing to restore."""
        with contextlib.suppress(faults.FaultError, OSError):
            self._journal.append({"t": "bye"})
            count("checkpoint.records")
        self.erase()

    def erase(self) -> None:
        self._journal.close()
        erase_session_files(self.sid, self.dir)

    def close(self) -> None:
        self._journal.close()


def erase_session_files(sid: str, dirpath: Optional[str] = None) -> None:
    d = dirpath or checkpoint_dir()
    prefix = f"{sid}-t"
    for fn in os.listdir(d):
        if fn == f"{sid}.wal" or (
            fn.startswith(prefix) and fn.endswith(".npz")
        ):
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(d, fn))


def quarantine(sid: str, reason: str,
               dirpath: Optional[str] = None) -> None:
    """Set a session's durable state aside: its journal is renamed
    ``.quarantined`` (kept for forensics, never replayed) and the
    daemon keeps serving everything else."""
    d = dirpath or checkpoint_dir()
    src = os.path.join(d, f"{sid}.wal")
    with contextlib.suppress(OSError):
        os.replace(src, src + ".quarantined")
    count("restore.quarantined")
    log.log("ERROR", "serving", "quarantine", session=sid,
            reason=reason)
    if flight.enabled():
        flight.record("I", "restore.quarantine", sid)


# ---------------------------------------------------------------------------
# restore: journal replay -> recovered session state
# ---------------------------------------------------------------------------


class RestoredSession:
    """Final replayed state of one session's journal."""

    __slots__ = ("sid", "name", "weight", "budget", "token", "tables",
                 "dedup", "next_local", "records")

    def __init__(self, sid: str):
        self.sid = sid
        self.name = sid
        self.weight = 1.0
        self.budget = 0
        self.token: Optional[str] = None
        self.tables: Dict[int, Tuple[str, int]] = {}  # local->(file, B)
        self.dedup: Dict[str, dict] = {}
        self.next_local = 1
        self.records = 0


def _replay(sid: str, records: List[dict]) -> Optional[RestoredSession]:
    """Apply journal records in order; ``None`` means cleanly closed
    (``bye`` seen) — nothing to restore."""
    rs = RestoredSession(sid)
    for rec in records:
        rs.records += 1
        t = rec.get("t")
        if t == "open":
            rs.name = str(rec.get("name") or sid)
            rs.weight = float(rec.get("weight", 1.0))
            rs.budget = int(rec.get("budget", 0))
            rs.token = rec.get("token")
        elif t == "put":
            local = int(rec["local"])
            rs.tables[local] = (str(rec["file"]), int(rec["bytes"]))
            rs.next_local = max(rs.next_local, local + 1)
            if rec.get("drop") is not None:
                rs.tables.pop(int(rec["drop"]), None)
            if rec.get("req"):
                rs.dedup[str(rec["req"])] = dict(rec.get("resp") or {})
        elif t == "free":
            rs.tables.pop(int(rec["local"]), None)
            if rec.get("req"):
                rs.dedup[str(rec["req"])] = dict(rec.get("resp") or {})
        elif t == "bye":
            return None
        else:
            raise CheckpointCorrupt(
                f"{sid}.wal: unknown record type {t!r}"
            )
    return rs


def restore_scan(
    dirpath: Optional[str] = None,
) -> Tuple[List[RestoredSession], Dict[str, str]]:
    """Scan the checkpoint dir, replay every session journal. Returns
    ``(restorable sessions, {sid: quarantine reason})``. Torn tails
    are truncated in place (so the reopened journal appends after the
    last complete record); corrupt journals are quarantined, never
    fatal — the daemon must come up with whatever state is sound."""
    d = dirpath or checkpoint_dir()
    sessions: List[RestoredSession] = []
    quarantined: Dict[str, str] = {}
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".wal") or fn == "manifest.wal":
            continue
        sid = fn[:-len(".wal")]
        path = os.path.join(d, fn)
        try:
            records, torn, good_off = read_journal(path)
            if torn:
                count("restore.torn_records", torn)
                log.log("WARN", "serving", "torn_tail", session=sid,
                        recovered_records=len(records))
                os.truncate(path, good_off)
            rs = _replay(sid, records)
        except (CheckpointCorrupt, OSError) as e:
            quarantined[sid] = str(e)
            quarantine(sid, str(e), d)
            continue
        if rs is None:
            erase_session_files(sid, d)  # clean bye: leftovers only
            continue
        count("restore.records_replayed", rs.records)
        sessions.append(rs)
    return sessions, quarantined


def load_payload(path: str, device="cuda"):
    """Restore-time payload read (a Table on ``device``), under the
    checkpoint fault site: an injected or real read failure surfaces
    typed and quarantines the session, it never serves a partial
    table."""
    faults.inject("checkpoint")
    try:
        return spill.load_table_npz(path, device=device)
    except (OSError, ValueError, KeyError) as e:
        raise CheckpointCorrupt(f"{path}: unreadable payload: {e}")


# ---------------------------------------------------------------------------
# warm-start manifest: the plans served before the crash
# ---------------------------------------------------------------------------


def _storage_name(t) -> str:
    """The numpy name of a tensor's storage dtype (the JAX package
    records ``str(array.dtype)``)."""
    return torch.empty(0, dtype=t.dtype).numpy().dtype.name


def _table_record(table) -> dict:
    """Everything needed to synthesize a table of the same signature:
    per-column storage dtype/shape plus rows and logical rows (FLOAT64
    and DECIMAL128 data named ``uint64``, as the JAX package stores it
    and as the checkpoint payloads hold it)."""
    cols = []
    rows = 0
    for c in table.columns:
        shape = c.data.shape
        rows = int(shape[0])
        cols.append([
            int(c.dtype.id), int(c.dtype.scale),
            "uint64" if spill.u64_on_disk(c.dtype.id)
            else _storage_name(c.data),
            int(shape[1]) if len(shape) > 1 else 0,
            None if c.validity is None else _storage_name(c.validity),
            None if c.lengths is None else _storage_name(c.lengths),
        ])
    return {
        "cols": cols,
        "names": None if table.names is None else list(table.names),
        "rows": rows,
        "logical": (
            None if table.logical_rows is None
            else int(table.logical_rows)
        ),
    }


def _torch_dtype(name: str) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(name))).dtype


def _synth_table(trec: dict, device):
    """Zero-filled table on ``device`` matching a manifest record's
    signature: all-valid validity, empty strings, and LIST rows full of
    zeros (a packed-rows batch must hold whole rows for ``from_rows`` to
    replay; the JAX package's zero lengths make that replay fail)."""
    from .. import dtype as dt
    from ..column import Column, Table

    rows = int(trec["rows"])
    cols = []
    for ti, sc, dstr, width, vstr, lstr in trec["cols"]:
        shape = (rows, width) if width else (rows,)
        data = (torch.int64 if spill.u64_on_disk(ti)
                else _torch_dtype(dstr))
        cols.append(Column(
            torch.zeros(shape, dtype=data, device=device),
            dt.DType(dt.TypeId(ti), sc),
            None if vstr is None else torch.ones(
                rows, dtype=_torch_dtype(vstr), device=device),
            None if lstr is None else torch.full(
                (rows,), width if ti == int(dt.TypeId.LIST) else 0,
                dtype=_torch_dtype(lstr), device=device)))
    return Table(cols, trec["names"], trec["logical"])


class Manifest:
    """Journal of unique ``(plan, schema signature, bucket, donation)``
    combinations served while durable. ``warm_start`` replays them
    against zero-filled tables of the recorded signatures, so the
    restarted daemon's runner cache holds every bucketed runner and every
    kernel library the first life loaded."""

    def __init__(self, dirpath: Optional[str] = None):
        self.dir = dirpath or checkpoint_dir()
        self.path = os.path.join(self.dir, "manifest.wal")
        self._lock = lockcheck.make_lock("durable.manifest")
        self._seen: set = set()
        self._records: List[dict] = []
        if os.path.exists(self.path):
            try:
                records, torn, good_off = read_journal(self.path)
                if torn:
                    os.truncate(self.path, good_off)
            except (CheckpointCorrupt, OSError) as e:
                # a corrupt manifest only costs the warm start — set it
                # aside and start fresh, never block the restore
                log.log("ERROR", "serving", "manifest_corrupt",
                        reason=str(e))
                with contextlib.suppress(OSError):
                    os.replace(self.path, self.path + ".quarantined")
                records = []
            for rec in records:
                key = json.dumps(rec, sort_keys=True)
                if key not in self._seen:
                    self._seen.add(key)
                    self._records.append(rec)
        self._journal = Journal(self.path)

    def note(self, ops: list, tables, donate: bool) -> None:
        """Record one served plan invocation (deduped). Failures only
        cost a future warm start — never the serving request."""
        try:
            rec = {
                "t": "plan", "ops": list(ops), "donate": bool(donate),
                "tables": [_table_record(t) for t in tables],
            }
            key = json.dumps(rec, sort_keys=True)
            with self._lock:
                if key in self._seen:
                    return
                self._seen.add(key)
                self._records.append(rec)
            try:
                self._journal.append(rec)
            except (faults.FaultError, OSError):
                count("checkpoint.errors")
                with self._lock:
                    self._seen.discard(key)  # retry on a later serve
                    with contextlib.suppress(ValueError):
                        self._records.remove(rec)
                return
            count("checkpoint.manifest_plans")
        # srt: allow-broad-except(the manifest is a warm-start optimization; a signature it cannot record must never fail the live request)
        except Exception:
            count("checkpoint.errors")

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    def warm_start(self, device="cuda") -> Tuple[int, int]:
        """Replay every recorded plan once (zero-filled inputs on
        ``device``, the real ``run_plan``); called before the listener
        opens. Returns ``(replayed, failed)``; a record that cannot
        replay is counted and skipped, never fatal."""
        from .. import plan as plan_mod

        replayed = failed = 0
        with metrics.span("restore.warm_start"):
            for rec in self.records():
                try:
                    tabs = [_synth_table(t, device) for t in rec["tables"]]
                    plan_mod.run_plan(
                        rec["ops"], tabs[0], tabs[1:],
                        donate_input=bool(rec.get("donate")),
                    )
                    replayed += 1
                # srt: allow-broad-except(warm start is best-effort: one unreplayable plan must not block the listener from opening)
                except Exception as e:
                    failed += 1
                    log.log("WARN", "serving", "warm_start_failed",
                            reason=str(e))
        count("restore.warm_compiles", replayed)
        if failed:
            count("restore.warm_failures", failed)
        if flight.enabled():
            flight.record("I", "restore.warm_start", replayed)
        return replayed, failed

    def close(self) -> None:
        self._journal.close()


flight.register_exit_section("durable", stats_doc)
