"""Plan-statistics store and prediction-drift telemetry (port of
``utils/planstats.py``).

* A crash-tolerant, append-only, CRC-framed **stats store**: one record
  per finished profile session, keyed by plan fingerprint x schema x
  bucket, with per-segment observed wall/compile/execute time, rows in
  and out, bytes moved, a working-set proxy, and the spill/retry/
  exchange counter deltas of the session.
* A **drift layer** comparing each record against plancheck's static
  prediction (the session doc's ``pred``) and the plan's own history,
  emitting ``drift.*`` counters and typed findings when the observed
  segmentation, cardinality or memory diverge past the
  ``SPARK_RAPIDS_TPU_DRIFT_*_FACTOR`` thresholds; :func:`note_skew`
  adds the mesh shuffle's skew decisions.
* A **report plane**: :func:`drift_report` / :func:`render_drift`
  (``tools/explain.py --drift``), :func:`summary`, :func:`stats_doc`.

Store format (``planstats-<host>-<pid>.wal`` in ``PLANSTATS_DIR``,
default ``<tempdir>/srt-planstats``): the 6-byte magic ``SRTS1\\n``,
then records of ``u32 LE payload length | u32 LE crc32(payload) | UTF-8
JSON`` (keys sorted). The records and :func:`plan_fingerprint` are the
JAX package's byte for byte, so either package reads a directory the
other wrote. A torn tail is dropped; mid-file corruption stops that
file's scan with a ``planstats.corrupt_files`` tick. Past
``PLANSTATS_ROTATE_MB`` the live file rotates to ``<name>.wal.1``.
Every append goes through :class:`StatsWriter`.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import socket
import struct
import tempfile
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import config
from . import flight
from . import lockcheck
from . import metrics

_MAGIC = b"SRTS1\n"
_FRAME = struct.Struct("<II")
_HOST = socket.gethostname()

# ---------------------------------------------------------------------------
# flag gate (the metrics._GATE_GEN discipline)
# ---------------------------------------------------------------------------

_GATE = (None, False)


def enabled() -> bool:
    """True when sessions should append stats records (cached gate);
    a configured PLANSTATS_DIR implies PLANSTATS, the dump-path
    convention."""
    global _GATE
    gen = config.generation()
    if _GATE[0] != gen:
        _GATE = (
            gen,
            bool(config.get_flag("PLANSTATS"))
            or bool(str(config.get_flag("PLANSTATS_DIR") or "")),
        )
    return _GATE[1]


def stats_dir() -> str:
    """Directory for store files; created lazily. Like CHECKPOINT_DIR
    (and unlike SPILL_DIR) the default is STABLE across processes and
    never swept — cross-process history is what drift compares
    against."""
    d = str(config.get_flag("PLANSTATS_DIR") or "").strip()
    if not d:
        d = os.path.join(tempfile.gettempdir(), "srt-planstats")
    os.makedirs(d, exist_ok=True)
    return d


# ---------------------------------------------------------------------------
# always-on counter mirror (the durable.count pattern): server.stats()
# gets a planstats block even when the metrics plane is off
# ---------------------------------------------------------------------------

_STATS_LOCK = lockcheck.make_lock("planstats.stats")
_STATS: Dict[str, int] = {}

# recent typed drift findings, newest last — the serving stats /
# flight-dump surfacing for "what diverged lately"
_FINDINGS: "deque" = deque(maxlen=64)

# skew events observed mid-plan (shuffle exchange planning) waiting to
# ride the next session record as typed "skew" findings; bounded so an
# always-disabled planstats can't leak
_PENDING_SKEW: "deque" = deque(maxlen=64)


def _count(name: str, n: int = 1, as_bytes: bool = False) -> None:
    with _STATS_LOCK:
        _STATS[name] = _STATS.get(name, 0) + int(n)
    if as_bytes:
        metrics.bytes_add(name, n)
    else:
        metrics.counter_add(name, n)


def _skew_detail(ev: dict) -> str:
    """Human line for one skew event (the --drift rendering)."""
    try:
        site = ev.get("site", "?")
        ratio = float(ev.get("ratio") or 0.0)
        factor = float(ev.get("factor") or 0.0)
        if ev.get("action") == "split":
            hot = ev.get("hot_destinations") or 0
            nhot = len(hot) if isinstance(hot, (list, tuple)) else int(hot)
            return (
                f"{site}: split {nhot} hot "
                f"destination(s) across k={int(ev.get('k') or 0)} salts — "
                f"planned max recv {int(ev.get('max_recv') or 0)} rows "
                f"(x{ratio:.1f} mean) -> {int(ev.get('post_max_recv') or 0)} "
                f"(x{float(ev.get('post_ratio') or 0.0):.1f}) "
                f"at factor {factor:g}"
            )
        return (
            f"{site}: planned max recv {int(ev.get('max_recv') or 0)} rows "
            f"is x{ratio:.1f} the mean at factor {factor:g} — "
            "no split applied"
        )
    # srt: allow-broad-except(telemetry formatting must never raise into the shuffle path)
    except Exception:
        return repr(ev)


def note_skew(detail: dict) -> None:
    """Record one adaptive-skew decision from the shuffle plane. Surfaces
    immediately in the always-on findings ring (serving stats, flight
    dumps) and rides the next ``record_session`` record as a typed
    ``skew`` drift finding so ``explain --drift`` shows it next to the
    cardinality/HBM divergences. Never raises into the exchange path."""
    try:
        ev = dict(detail)
        entry = {
            "type": "skew",
            "segment": None,
            "detail": _skew_detail(ev),
            "event": ev,
            "fp": None,
            "schema": None,
            "bucket": None,
            "ts": None,
        }
        with _STATS_LOCK:
            _FINDINGS.append(dict(entry))
            _PENDING_SKEW.append(entry)
        _count("drift.skew")
    # srt: allow-broad-except(telemetry hook on the hot shuffle path)
    except Exception:
        pass


def _drain_skew(rec: dict) -> List[dict]:
    """Pop pending skew events into findings stamped with the session
    record's identity (fp/schema/bucket/ts)."""
    with _STATS_LOCK:
        pending = list(_PENDING_SKEW)
        _PENDING_SKEW.clear()
    out = []
    for entry in pending:
        e = dict(entry)
        e["fp"] = rec.get("fp")
        e["schema"] = rec.get("schema")
        e["bucket"] = rec.get("bucket")
        e["ts"] = rec.get("ts")
        out.append(e)
    return out


def stats_doc() -> dict:
    """Always-available summary block (serving stats, flight dumps)."""
    with _STATS_LOCK:
        doc: Dict[str, Any] = dict(sorted(_STATS.items()))
    doc["enabled"] = enabled()
    doc["findings"] = list(_FINDINGS)
    return doc


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------


def plan_fingerprint(ops) -> str:
    """Stable 16-hex fingerprint of a plan's canonical JSON — the store
    key that makes 'same plan, different day' one history."""
    try:
        blob = json.dumps(ops, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError):
        blob = repr(ops)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# the CRC-framed writer — every append in the process funnels here
# ---------------------------------------------------------------------------


def _open_append(path: str):
    """THE one raw append-mode open of the stats path: keeping it one
    function keeps the CRC framing un-bypassable by construction."""
    return open(path, "ab")


class StatsWriter:
    """One process's append-only store file. Thread-safe; each append
    is framed (len | crc32 | JSON), written and flushed — the kernel
    owns acknowledged bytes, so SIGKILL loses at most the record being
    framed. A torn write (partial frame on disk after a crash landed
    mid-``write``) self-heals on the next append by truncating back to
    the last good offset, the durable.Journal discipline."""

    def __init__(self, path: str):
        self.path = path
        self._lock = lockcheck.make_lock("planstats.writer")
        self._f = _open_append(path)
        size = os.fstat(self._f.fileno()).st_size
        if size == 0:
            self._f.write(_MAGIC)
            self._f.flush()
            size = len(_MAGIC)
        self._good = size

    def append(self, record: dict) -> int:
        """Append one record; returns the framed size in bytes."""
        payload = json.dumps(record, sort_keys=True).encode()
        frame = _FRAME.pack(
            len(payload), zlib.crc32(payload) & 0xFFFFFFFF
        ) + payload
        with self._lock:
            self._maybe_rotate()
            size = os.fstat(self._f.fileno()).st_size
            if size != self._good:
                self._f.truncate(self._good)
            self._f.write(frame)
            self._f.flush()
            self._good = os.fstat(self._f.fileno()).st_size
        return len(frame)

    def _maybe_rotate(self) -> None:
        limit = float(config.get_flag("PLANSTATS_ROTATE_MB")) * (1 << 20)
        if self._good <= limit:
            return
        self._f.close()
        os.replace(self.path, self.path + ".1")  # old generation
        self._f = _open_append(self.path)
        self._f.write(_MAGIC)
        self._f.flush()
        self._good = len(_MAGIC)
        _count("planstats.rotations")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass
                self._f.close()


_WRITER_LOCK = lockcheck.make_lock("planstats.writer_singleton")
_WRITER: Optional[StatsWriter] = None


def _writer() -> StatsWriter:
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None or _WRITER._f.closed:
            path = os.path.join(
                stats_dir(), f"planstats-{_HOST}-{os.getpid()}.wal"
            )
            _WRITER = StatsWriter(path)
        return _WRITER


# ---------------------------------------------------------------------------
# readers — torn tails recover silently; corruption never raises
# ---------------------------------------------------------------------------


def read_stats_file(path: str) -> Tuple[List[dict], int]:
    """Parse one store file. Returns ``(records, torn)`` where torn
    counts the incomplete trailing record (0 or 1). A bad magic or
    mid-file CRC/decode failure stops THIS file's scan with a
    ``planstats.corrupt_files`` tick instead of raising — unlike
    durable journals, stats carry no client-acknowledged state, so the
    reader degrades to 'what survived' rather than quarantining."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return [], 0
    if not blob.startswith(_MAGIC):
        _count("planstats.corrupt_files")
        return [], 0
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
            else:
                _count("planstats.corrupt_files")
            break
        try:
            records.append(json.loads(payload.decode()))
        except ValueError:
            if end == n:
                torn = 1
            else:
                _count("planstats.corrupt_files")
            break
        off = end
    if torn:
        _count("planstats.torn_records")
    return records, torn


def load(path: Optional[str] = None) -> List[dict]:
    """Every record across the store, oldest first (by ``ts``).
    ``path`` may be a directory (default: :func:`stats_dir`), one store
    file, or absent."""
    if path is None:
        path = stats_dir()
    if os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, "planstats-*.wal"))) \
            + sorted(glob.glob(os.path.join(path, "planstats-*.wal.1")))
    else:
        paths = [path]
    records: List[dict] = []
    for p in paths:
        recs, _torn = read_stats_file(p)
        records.extend(recs)
    records.sort(key=lambda r: (r.get("ts") or 0))
    return records


# ---------------------------------------------------------------------------
# the session hook (called by profiler._SessionScope, lazily)
# ---------------------------------------------------------------------------

# counter names whose session-scoped deltas ride every record: the
# spill/retry/shed/exchange story of one plan execution
_DELTA_KEYS = (
    "spill.evictions", "spill.demotions", "spill.repages",
    "spill.bytes_out", "spill.bytes_in",
    "retry.attempts", "retry.giveups",
    "serving.shed",
    "shuffle.exchanges", "shuffle.rows_exchanged",
    "shuffle.skew_splits",
    "plan.oom_spill_retries", "plan.mesh_fallbacks", "mesh.degraded",
)

# plan-key -> deque of {seg index -> rows_out} from past runs; the
# history the cardinality check medians over. Seeded once per process
# from the on-disk store so cross-process runs share one history.
_HISTORY_LOCK = lockcheck.make_lock("planstats.history")
_HISTORY: Dict[tuple, "deque"] = {}
_HISTORY_SEEDED = False
_HISTORY_KEEP = 64


def counter_snapshot() -> Dict[str, int]:
    """Base values captured at session open; diffed at close."""
    return metrics.counter_values(_DELTA_KEYS)


def _plan_key(rec: dict) -> tuple:
    return (rec.get("fp"), rec.get("schema"), rec.get("bucket"))


def _seg_rows(rec: dict) -> Dict[int, int]:
    return {
        int(s["index"]): int(s.get("rows_out") or 0)
        for s in rec.get("segments") or []
        if s.get("index") is not None
    }


def _seed_history_locked() -> None:
    global _HISTORY_SEEDED
    if _HISTORY_SEEDED:
        return
    _HISTORY_SEEDED = True
    for rec in load():
        _HISTORY.setdefault(
            _plan_key(rec), deque(maxlen=_HISTORY_KEEP)
        ).append(_seg_rows(rec))


def _history_medians(key: tuple) -> Dict[int, float]:
    """Per-segment-index median rows_out over the plan's history."""
    with _HISTORY_LOCK:
        _seed_history_locked()
        runs = list(_HISTORY.get(key) or ())
    by_seg: Dict[int, List[int]] = {}
    for run in runs:
        for idx, rows in run.items():
            by_seg.setdefault(idx, []).append(rows)
    out: Dict[int, float] = {}
    for idx, vals in by_seg.items():
        vals.sort()
        m = len(vals) // 2
        out[idx] = (
            float(vals[m]) if len(vals) % 2
            else (vals[m - 1] + vals[m]) / 2.0
        )
    return out


def _push_history(rec: dict) -> None:
    with _HISTORY_LOCK:
        _seed_history_locked()
        _HISTORY.setdefault(
            _plan_key(rec), deque(maxlen=_HISTORY_KEEP)
        ).append(_seg_rows(rec))


def _seg_hbm_proxy(seg: dict) -> Optional[int]:
    """Observed working-set proxy for one segment: rows_in at the
    observed output row width plus the output itself — the same
    rows x width shape plancheck's static ``est_hbm_bytes`` bounds, so
    the two are comparable. None when the segment moved no bytes
    (resident-only chains report out_bytes 0)."""
    out_bytes = int(seg.get("out_bytes") or 0)
    rows_out = int(seg.get("rows_out") or 0)
    rows_in = int(seg.get("rows_in") or 0)
    calls = max(int(seg.get("calls") or 1), 1)
    if out_bytes <= 0 or rows_out <= 0:
        return None
    width = out_bytes / rows_out
    return int((rows_in * width + out_bytes) / calls)


def _drift_check(rec: dict, pred: Optional[dict]) -> List[dict]:
    """Typed findings for one fresh record: segmentation / cardinality
    / HBM divergence vs the static prediction and the plan's history.
    Emits the structured ``drift.*`` metrics as it goes."""
    findings: List[dict] = []
    _count("drift.checks")
    segs = rec.get("segments") or []

    def finding(kind: str, segment, detail: str) -> None:
        findings.append({
            "type": kind,
            "segment": segment,
            "detail": detail,
            "fp": rec.get("fp"),
            "schema": rec.get("schema"),
            "bucket": rec.get("bucket"),
            "ts": rec.get("ts"),
        })
        _count("drift." + kind)

    if pred:
        psegs = pred.get("segments") or []
        okinds = [s.get("kind") for s in segs]
        pkinds = [s.get("kind") for s in psegs]
        # mesh runs execute whole-plan as ONE sharded "mesh" segment
        # plancheck never predicts — a different execution strategy,
        # not a mis-segmentation; same for an empty observed list
        # (not measured)
        if (
            okinds and pkinds and okinds != pkinds
            and "mesh" not in okinds
        ):
            finding(
                "segmentation", None,
                f"predicted {len(pkinds)} segment(s) "
                f"[{','.join(map(str, pkinds))}] but observed "
                f"{len(okinds)} [{','.join(map(str, okinds))}]",
            )
        hbm_factor = float(config.get_flag("DRIFT_HBM_FACTOR"))
        for seg, pseg in zip(segs, psegs):
            if seg.get("kind") == "mesh":
                continue  # whole-plan stage; pseg is one segment of it
            idx = seg.get("index")
            bound = pseg.get("rows_bound")
            rows_out = int(seg.get("rows_out") or 0)
            calls = max(int(seg.get("calls") or 1), 1)
            if bound is not None and rows_out > int(bound) * calls:
                finding(
                    "cardinality", idx,
                    f"observed rows_out {rows_out} exceeds the static "
                    f"bound {int(bound) * calls} — the row-count "
                    "inference is wrong for this plan",
                )
            est = pseg.get("est_hbm_bytes")
            obs = seg.get("hbm_bytes")
            if est and obs:
                est_eff = float(est)
                bucket = rec.get("bucket")
                # bucket padding inflates the physical working set by
                # design (plancheck estimates logical rows); drift
                # means exceeding even the bucket-scaled estimate
                if bucket and bound and int(bucket) > int(bound):
                    est_eff *= int(bucket) / float(bound)
                if obs > est_eff * hbm_factor:
                    finding(
                        "hbm", idx,
                        f"observed working set ~{obs}B exceeds the "
                        f"static estimate {int(est_eff)}B by more "
                        f"than x{hbm_factor:g}",
                    )

    rows_factor = float(config.get_flag("DRIFT_ROWS_FACTOR"))
    medians = _history_medians(_plan_key(rec))
    for seg in segs:
        idx = seg.get("index")
        med = medians.get(int(idx)) if idx is not None else None
        if med is None or med < 1.0:
            continue
        rows_out = int(seg.get("rows_out") or 0)
        if rows_out > med * rows_factor or rows_out * rows_factor < med:
            finding(
                "cardinality", idx,
                f"observed rows_out {rows_out} vs history median "
                f"{med:g} (x{max(rows_out / med, med / max(rows_out, 1)):.1f}"
                f" > factor {rows_factor:g}) — skewed input or stale "
                "history",
            )
    if findings:
        _count("drift.findings", len(findings))
        with _STATS_LOCK:
            _FINDINGS.extend(findings)
    return findings


def record_session(doc: dict, base: Optional[Dict[str, int]] = None):
    """Append one stats record for a finished profile-session doc —
    the hook profiler._SessionScope.__exit__ calls (lazily) for every
    run_plan execution. Never raises into the query path: the caller
    wraps it, and everything here degrades to 'record less'. Returns
    the record (tests) or None when disabled."""
    if not enabled():
        return None
    plan = doc.get("plan")
    counters: Dict[str, int] = {}
    if base is not None:
        now = counter_snapshot()
        counters = {
            k: now.get(k, 0) - base.get(k, 0)
            for k in now
            if now.get(k, 0) - base.get(k, 0)
        }
    segs: List[dict] = []
    bytes_moved = 0
    hbm_peak: Optional[int] = None
    for s in doc.get("segments") or []:
        proxy = _seg_hbm_proxy(s)
        segs.append({
            "index": s.get("index"),
            "kind": s.get("kind"),
            "ops": list(s.get("ops") or []),
            "calls": int(s.get("calls") or 0),
            "wall_s": round(float(s.get("wall_s") or 0.0), 6),
            "compile_s": round(float(s.get("compile_s") or 0.0), 6),
            "execute_s": round(float(s.get("execute_s") or 0.0), 6),
            "rows_in": int(s.get("rows_in") or 0),
            "rows_out": int(s.get("rows_out") or 0),
            "out_bytes": int(s.get("out_bytes") or 0),
            "hbm_bytes": proxy,
        })
        bytes_moved += int(s.get("out_bytes") or 0)
        if proxy is not None:
            hbm_peak = proxy if hbm_peak is None else max(hbm_peak, proxy)
    boundary = doc.get("boundary") or {}
    bytes_moved += int(boundary.get("serde_bytes_in") or 0)
    bytes_moved += int(boundary.get("serde_bytes_out") or 0)
    rec = {
        "v": 1,
        "fp": plan_fingerprint(plan) if plan else "-",
        "schema": doc.get("schema"),
        "bucket": doc.get("bucket"),
        "label": doc.get("label"),
        "session_id": doc.get("session_id"),
        "pid": doc.get("pid"),
        "host": doc.get("host"),
        "ts": doc.get("epoch_ns"),
        "wall_s": round(float(doc.get("wall_s") or 0.0), 6),
        "batches": doc.get("batches"),
        "segments": segs,
        "counters": counters,
        "bytes_moved": bytes_moved,
        "hbm_peak_bytes": hbm_peak,
    }
    pred = doc.get("pred")
    if pred is not None:
        rec["pred"] = pred
    drift = _drift_check(rec, pred)
    drift = list(drift) + _drain_skew(rec)
    if drift:
        rec["drift"] = drift
    nbytes = _writer().append(rec)
    _push_history(rec)
    _count("planstats.records")
    _count("planstats.bytes", nbytes, as_bytes=True)
    if flight.enabled():
        flight.record("I", "planstats.record", rec["fp"])
    return rec


# ---------------------------------------------------------------------------
# report plane (tools/explain.py --drift, serving stats, bench)
# ---------------------------------------------------------------------------


def _dist(vals: List[float]) -> dict:
    vals = sorted(vals)

    def pct(q: float) -> float:
        i = min(int(q * (len(vals) - 1) + 0.5), len(vals) - 1)
        return vals[i]

    return {
        "n": len(vals),
        "p50": pct(0.50),
        "p95": pct(0.95),
        "max": vals[-1],
    }


def drift_report(
    records: Optional[Sequence[dict]] = None,
    path: Optional[str] = None,
) -> dict:
    """Aggregate the store into per-(fp, schema, bucket) groups: runs,
    per-segment observed percentiles (wall time, rows out, bytes, HBM
    proxy) next to the static prediction, and every typed finding the
    append-time drift checks raised — the machine form behind
    ``explain --drift``."""
    if records is None:
        records = load(path)
    groups: Dict[tuple, dict] = {}
    for rec in records:
        key = _plan_key(rec)
        g = groups.get(key)
        if g is None:
            g = groups[key] = {
                "fp": rec.get("fp"),
                "schema": rec.get("schema"),
                "bucket": rec.get("bucket"),
                "labels": [],
                "runs": 0,
                "_segs": {},
                "pred": None,
                "findings": [],
                "counters": {},
            }
        g["runs"] += 1
        for ck, cv in (rec.get("counters") or {}).items():
            g["counters"][ck] = g["counters"].get(ck, 0) + int(cv)
        label = rec.get("label")
        if label and label not in g["labels"]:
            g["labels"].append(label)
        if rec.get("pred") is not None:
            g["pred"] = rec["pred"]  # latest wins
        g["findings"].extend(rec.get("drift") or [])
        for s in rec.get("segments") or []:
            idx = s.get("index")
            agg = g["_segs"].get(idx)
            if agg is None:
                agg = g["_segs"][idx] = {
                    "index": idx,
                    "kind": s.get("kind"),
                    "ops": list(s.get("ops") or []),
                    "calls": 0,
                    "wall_s": [],
                    "rows_out": [],
                    "out_bytes": [],
                    "hbm_bytes": [],
                }
            agg["kind"] = s.get("kind")
            agg["calls"] += int(s.get("calls") or 0)
            agg["wall_s"].append(float(s.get("wall_s") or 0.0))
            agg["rows_out"].append(float(s.get("rows_out") or 0))
            agg["out_bytes"].append(float(s.get("out_bytes") or 0))
            if s.get("hbm_bytes") is not None:
                agg["hbm_bytes"].append(float(s["hbm_bytes"]))
    out_groups = []
    for key in sorted(groups, key=lambda k: tuple(str(x) for x in k)):
        g = groups[key]
        psegs = (g["pred"] or {}).get("segments") or []
        segments = []
        for idx in sorted(g["_segs"], key=lambda i: (i is None, i)):
            agg = g["_segs"][idx]
            pseg = psegs[idx] if isinstance(idx, int) and idx < len(psegs) \
                else None
            segments.append({
                "index": agg["index"],
                "kind": agg["kind"],
                "ops": agg["ops"],
                "calls": agg["calls"],
                "wall_s": _dist(agg["wall_s"]) if agg["wall_s"] else None,
                "rows_out": _dist(agg["rows_out"]) if agg["rows_out"]
                else None,
                "out_bytes": _dist(agg["out_bytes"]) if agg["out_bytes"]
                else None,
                "hbm_bytes": _dist(agg["hbm_bytes"]) if agg["hbm_bytes"]
                else None,
                "pred": pseg,
            })
        out_groups.append({
            "fp": g["fp"],
            "schema": g["schema"],
            "bucket": g["bucket"],
            "labels": g["labels"],
            "runs": g["runs"],
            "segments": segments,
            "rows_out_bound": (g["pred"] or {}).get("rows_out_bound"),
            "est_hbm_peak_bytes": (g["pred"] or {}).get(
                "est_hbm_peak_bytes"
            ),
            "findings": g["findings"],
            "counters": dict(sorted(g["counters"].items())),
        })
    return {
        "version": 1,
        "records": len(list(records)),
        "groups": out_groups,
    }


def _fmt_dist(d: Optional[dict], unit: str = "", scale: float = 1.0,
              nd: int = 2) -> str:
    if not d:
        return "-"
    return (
        f"{d['p50'] * scale:.{nd}f}/{d['p95'] * scale:.{nd}f}"
        f"/{d['max'] * scale:.{nd}f}{unit}"
    )


def render_drift(report: dict) -> str:
    """The human form of :func:`drift_report`: per plan group, each
    segment's predicted bound next to the observed p50/p95/max, then
    the typed findings."""
    lines: List[str] = []
    lines.append(
        f"PLAN DRIFT  {len(report.get('groups') or [])} plan group(s), "
        f"{report.get('records', 0)} record(s)"
    )
    for g in report.get("groups") or []:
        head = f"\nplan {g.get('fp')}"
        if g.get("schema"):
            head += f"  schema={g['schema']}"
        if g.get("bucket") is not None:
            head += f"  bucket={g['bucket']}"
        head += (
            f"  runs={g.get('runs')}"
            f"  labels={','.join(g.get('labels') or []) or '-'}"
        )
        lines.append(head)
        for s in g.get("segments") or []:
            pred = s.get("pred") or {}
            lines.append(
                f"  seg {s.get('index')} [{s.get('kind', '?')}] "
                f"{','.join(s.get('ops') or [])}"
            )
            bound = pred.get("rows_bound")
            lines.append(
                "      rows_out p50/p95/max "
                + _fmt_dist(s.get("rows_out"), nd=0)
                + (f"  (pred bound {bound})" if bound is not None
                   else "  (pred bound -)")
            )
            est = pred.get("est_hbm_bytes")
            lines.append(
                "      hbm p50/p95/max "
                + _fmt_dist(s.get("hbm_bytes"), "B", nd=0)
                + (f"  (pred est {est}B)" if est is not None
                   else "  (pred est -)")
            )
            lines.append(
                "      wall p50/p95/max "
                + _fmt_dist(s.get("wall_s"), "ms", 1e3)
            )
        # the exchange story of this plan group: shuffle/partition
        # counter deltas (skew splits most of all) next to the findings
        exch = {
            k: v for k, v in (g.get("counters") or {}).items()
            if k.startswith("shuffle.") or k.startswith("partition.")
        }
        if exch:
            lines.append(
                "  exchange: "
                + " ".join(f"{k}={v}" for k, v in exch.items())
            )
        finds = g.get("findings") or []
        if finds:
            lines.append(f"  findings ({len(finds)}):")
            for f in finds:
                seg = f.get("segment")
                where = f"seg {seg}" if seg is not None else "plan"
                lines.append(
                    f"    DRIFT[{f.get('type')}] {where}: "
                    f"{f.get('detail')}"
                )
        else:
            lines.append("  findings: none")
    return "\n".join(lines)


def summary(path: Optional[str] = None) -> Optional[dict]:
    """Compact block for bench headline JSON: record/group counts and
    findings by type — small enough to ride every emit. None when the
    store is empty or unreadable."""
    try:
        report = drift_report(path=path)
    # srt: allow-broad-except(telemetry summary must never fail the bench emit)
    except Exception:
        return None
    if not report["records"]:
        return None
    by_type: Dict[str, int] = {}
    for g in report["groups"]:
        for f in g.get("findings") or []:
            t = str(f.get("type"))
            by_type[t] = by_type.get(t, 0) + 1
    return {
        "records": report["records"],
        "plans": len(report["groups"]),
        "findings": by_type,
    }


def reset() -> None:
    """Test hook: close the writer and drop in-process state (files on
    disk are the caller's to manage)."""
    global _WRITER, _HISTORY_SEEDED, _GATE
    with _WRITER_LOCK:
        if _WRITER is not None:
            _WRITER.close()
            _WRITER = None
    with _HISTORY_LOCK:
        _HISTORY.clear()
        _HISTORY_SEEDED = False
    with _STATS_LOCK:
        _STATS.clear()
        _FINDINGS.clear()
        _PENDING_SKEW.clear()
    _GATE = (None, False)


# the planstats block rides every flight dump, the durable/profiler
# exit-section discipline
flight.register_exit_section("planstats", stats_doc)
