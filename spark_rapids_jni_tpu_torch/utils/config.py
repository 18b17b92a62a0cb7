"""The flag plane of the port (the part of ``utils/config.py`` it runs).

Flags are ``SPARK_RAPIDS_TPU_*`` environment variables, the same names
the JAX package reads, with an override set through :func:`set_flag`
taking precedence. Ported flags:

* ``KERNELS`` — the kernel tier (``kernels/registry.py``): ``on`` tries
  every applicable kernel route, ``off`` never, ``auto`` (the default)
  only for tables whose tensors are on a CUDA device. Any other value
  raises :class:`ValueError`.
* ``METRICS`` — the counters, timers, gauges and histograms of
  ``utils/metrics.py``; ``METRICS_DUMP`` — the path its snapshot is
  written to at exit (a path implies ``METRICS``).
* The observability tier: ``TRACE`` (``utils/tracing.py``: profiler and
  NVTX ranges), ``TRACE_SLO_MS``, ``TRACE_TOPK`` (its slow-request log);
  ``FLIGHT``, ``FLIGHT_DUMP`` (``utils/flight.py``); ``PROFILE``,
  ``PROFILE_DUMP`` (``utils/profiler.py``); ``PLANSTATS``,
  ``PLANSTATS_DIR``, ``PLANSTATS_ROTATE_MB``, ``DRIFT_ROWS_FACTOR``,
  ``DRIFT_HBM_FACTOR`` (``utils/planstats.py``); ``LOCKCHECK``
  (``utils/lockcheck.py``); ``REFCOUNT_DEBUG`` (the allocation sites of
  ``runtime_bridge.leak_report``).
* ``LOG_LEVEL`` / ``ALLOC_LOG_LEVEL`` — ``utils/log.py``.
* ``PIPELINE`` — the pipelined dispatch plane (``pipeline.py``).
* ``FAULTS``, ``RETRY_MAX``, ``RETRY_BASE_MS``, ``DEADLINE_DEFAULT_S``,
  ``BREAKER_THRESHOLD``, ``BREAKER_PROBE_S`` — ``utils/faults.py``.
* ``SPILL``, ``SPILL_DIR``, ``HOST_SPILL_BUDGET_GB`` —
  ``utils/spill.py``; ``HBM_BUDGET_GB`` — ``utils/hbm.py``.
* ``BUCKETS`` — the shape-bucket ladder of the dispatch plane
  (``utils/buckets.py``, parsed there when it is read).
* ``GROUPBY_FORMULATION`` — the eager groupby's route above
  ``ops.groupby.CHUNKED_MIN_ROWS``: ``single`` (the default), ``packed``
  or ``chunked``; any other value raises :class:`ValueError`.
* ``SKEW_SPLIT``, ``SKEW_SPLIT_FACTOR`` — the mesh shuffle's adaptive
  skew split (``parallel/shuffle.py``, ``parallel/distributed.py``);
  ``MESH_PROBE_S`` — the mesh heartbeat's deadline
  (``parallel/mesh.py``).
* ``SERVE_PORT``, ``SERVE_MAX_SESSIONS``, ``SERVE_SESSION_HBM_FRACTION``,
  ``SERVE_QUEUE_DEPTH`` — the serving daemon (``serving/``); ``DURABLE``,
  ``CHECKPOINT_DIR`` — its checkpoints (``serving/durable.py``; the spill
  sweep never removes a file under ``CHECKPOINT_DIR``).
* ``NATIVE_LIB`` — an explicit path of the native shim
  (``utils/native.py``); the loader refuses a library that is not the
  port's.

Defaults and parsers are the JAX package's; an invalid value raises
:class:`ValueError` naming the flag when it is read.

Every :func:`set_flag`/:func:`clear_flag` bumps :func:`generation`, the
key the hot-path gates cache their reading against.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

_PREFIX = "SPARK_RAPIDS_TPU_"


def _as_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


def _parse_kernels(v: str) -> str:
    got = v.strip().lower()
    if got not in ("on", "off", "auto"):
        raise ValueError(f"KERNELS must be on|off|auto, got {v!r}")
    return got


def _parse_formulation(v: str) -> str:
    got = v.strip().lower()
    if got not in ("single", "packed", "chunked"):
        raise ValueError(
            f"GROUPBY_FORMULATION must be single|packed|chunked, got {v!r}")
    return got


def _parse_nonneg_int(name: str):
    def parse(v: str) -> int:
        try:
            got = int(v.strip())
        except ValueError:
            raise ValueError(f"{name} must be an integer, got {v!r}")
        if got < 0:
            raise ValueError(f"{name} must be >= 0, got {v!r}")
        return got

    return parse


def _parse_positive_int(name: str):
    def parse(v: str) -> int:
        try:
            got = int(v.strip())
        except ValueError:
            raise ValueError(f"{name} must be an integer, got {v!r}")
        if got <= 0:
            raise ValueError(f"{name} must be > 0, got {v!r}")
        return got

    return parse


def _parse_nonneg_float(name: str):
    def parse(v: str) -> float:
        try:
            got = float(v.strip())
        except ValueError:
            raise ValueError(f"{name} must be a float, got {v!r}")
        if got < 0.0:
            raise ValueError(f"{name} must be >= 0, got {v!r}")
        return got

    return parse


def _parse_positive_float(name: str):
    def parse(v: str) -> float:
        try:
            got = float(v.strip())
        except ValueError:
            raise ValueError(f"{name} must be a float, got {v!r}")
        if got <= 0.0:
            raise ValueError(f"{name} must be > 0, got {v!r}")
        return got

    return parse


def _parse_port(v: str) -> int:
    try:
        got = int(v.strip())
    except ValueError:
        raise ValueError(f"SERVE_PORT must be an integer, got {v!r}")
    if not (0 <= got <= 65535):
        raise ValueError(f"SERVE_PORT must be in [0, 65535], got {v!r}")
    return got


def _parse_fraction(name: str):
    def parse(v: str) -> float:
        try:
            got = float(v.strip())
        except ValueError:
            raise ValueError(f"{name} must be a float, got {v!r}")
        if not (0.0 < got <= 1.0):
            raise ValueError(f"{name} must be in (0, 1], got {v!r}")
        return got

    return parse


def _parse_checkpoint_dir(v: str) -> str:
    """A whitespace-only value, or a path that exists and is not a
    directory, is refused when read (the directory itself is made at the
    first checkpoint)."""
    if v and not v.strip():
        raise ValueError(
            "SPARK_RAPIDS_TPU_CHECKPOINT_DIR must be a directory path, "
            f"got whitespace {v!r}")
    path = v.strip()
    if path and os.path.exists(path) and not os.path.isdir(path):
        raise ValueError(
            f"SPARK_RAPIDS_TPU_CHECKPOINT_DIR={path!r} exists and is "
            "not a directory")
    return path


def _parse_fault_spec(v: str) -> str:
    """Validate a FAULTS plan (``[seed=N,]site:kind:prob[:count],...``)
    when it is read, so a typo'd plan fails loudly instead of injecting
    nothing; the compiled form lives in ``utils/faults.py``."""
    from . import faults

    spec = v.strip()
    if spec:
        faults.parse_spec(spec)  # raises ValueError naming the env var
    return spec


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str
    default: Any
    parse: Callable[[str], Any]
    doc: str

    @property
    def env_var(self) -> str:
        return _PREFIX + self.name


_FLAGS = {
    f.name: f
    for f in [
        Flag("TRACE", False, _as_bool,
             "profiler ranges (utils/tracing.py): torch.profiler "
             "record_function ranges, and NVTX ranges on a CUDA device"),
        Flag("METRICS", False, _as_bool,
             "op-level metrics counters (utils/metrics.py)"),
        Flag("METRICS_DUMP", "", str,
             "path to write metrics.snapshot() JSON at process exit; a "
             "non-empty path implies METRICS"),
        Flag("REFCOUNT_DEBUG", False, _as_bool,
             "resident-table leak tracking with the allocating span stack "
             "(runtime_bridge.leak_report)"),
        Flag("KERNELS", "auto", _parse_kernels,
             "kernel tier (kernels/registry.py): on | off | auto (the "
             "default: only for tables on a CUDA device)"),
        Flag("LOG_LEVEL", "OFF", str.upper,
             "log level (OFF|ERROR|WARN|INFO|DEBUG|TRACE) of every "
             "utils/log.py channel"),
        Flag("ALLOC_LOG_LEVEL", "OFF", str.upper,
             "log level of the hbm/handles channels; overrides LOG_LEVEL "
             "there when set"),
        Flag("HBM_BUDGET_GB", 0.0, float,
             "device memory budget in GiB for the footprint planner "
             "(utils/hbm.py); 0 = the device's own (CUDA: its total "
             "memory; CPU: 16)"),
        Flag("GROUPBY_FORMULATION", "single", _parse_formulation,
             "large-input eager groupby routing: single (one sort, the "
             "default) | packed | chunked (the two-level designs)"),
        Flag("BUCKETS", "", str,
             "shape-bucket spec for the dispatch plane (utils/buckets.py):"
             " '' = default geometric ladder (1024 x2 up to 8.4M rows), "
             "'floor:growth[:cap]', an explicit 'a,b,c' size list, or "
             "off|none|0 to disable pad-to-bucket batching"),
        Flag("PIPELINE", "", str,
             "pipelined dispatch plane (pipeline.py): off (default) = "
             "synchronous; an integer = depth (stages in flight: wire "
             "decode/encode on worker threads and their own CUDA streams "
             "overlapping the plan, resident ops enqueue and return ids "
             "at once); on = depth 2"),
        Flag("FAULTS", "", _parse_fault_spec,
             "deterministic fault-injection plan (utils/faults.py): "
             "'[seed=N,]site:kind:prob[:count],...'; '' (default) = off"),
        Flag("SPILL", False, _as_bool,
             "tiered memory (utils/spill.py): resident tables move "
             "device -> host -> disk under memory pressure and repage on "
             "access; off by default"),
        Flag("SPILL_DIR", "", str,
             "directory of disk-tier spill files; '' = a per-process "
             "directory under the system temp dir"),
        Flag("HOST_SPILL_BUDGET_GB", 4.0,
             _parse_nonneg_float("HOST_SPILL_BUDGET_GB"),
             "host-memory spill tier budget in GiB; past it the coldest "
             "host entries go to disk; 0 = straight to disk"),
        Flag("RETRY_MAX", 3, _parse_nonneg_int("RETRY_MAX"),
             "max retries of a transient-classified failure at one "
             "dispatch/serde boundary; 0 disables retry"),
        Flag("RETRY_BASE_MS", 25.0, _parse_positive_float("RETRY_BASE_MS"),
             "base backoff of a retry in ms; attempt N sleeps about "
             "base*2^(N-1) with deterministic jitter"),
        Flag("DEADLINE_DEFAULT_S", 0.0,
             _parse_nonneg_float("DEADLINE_DEFAULT_S"),
             "default request deadline in seconds; 0 = none"),
        Flag("BREAKER_THRESHOLD", 5, _parse_positive_int("BREAKER_THRESHOLD"),
             "circuit breaker: consecutive transient failures before it "
             "opens"),
        Flag("BREAKER_PROBE_S", 1.0, _parse_positive_float("BREAKER_PROBE_S"),
             "circuit breaker: seconds an open breaker waits before one "
             "half-open probe"),
        Flag("SKEW_SPLIT_FACTOR", 2.0,
             _parse_positive_float("SKEW_SPLIT_FACTOR"),
             "adaptive shuffle-skew threshold: after the counts pass, a "
             "destination whose planned received rows pass this factor x "
             "the mean gets its hot keys salted across sub-partitions "
             "(partial aggregate before the exchange, merge after); "
             "SKEW_SPLIT=0 turns the machinery off"),
        Flag("SKEW_SPLIT", True, _as_bool,
             "master switch of the adaptive skew split on the mesh "
             "shuffle path; off = capacity always from the raw "
             "per-destination counts"),
        Flag("FLIGHT", "", str,
             "flight recorder (utils/flight.py): off (default) | on = "
             "ring of 8192 events | an integer ring capacity"),
        Flag("FLIGHT_DUMP", "", str,
             "path to write the flight-recorder tail JSON at process "
             "exit; a non-empty path implies FLIGHT"),
        Flag("PROFILE", "", str,
             "query profiler (utils/profiler.py): on = a profile session "
             "around every table_plan_wire / table_plan_resident / "
             "table_stream_wire call, with per-segment compile/execute/"
             "serde/stall splits; off (default)"),
        Flag("PROFILE_DUMP", "", str,
             "path to write finished profile sessions as JSON at process "
             "exit; a non-empty path implies PROFILE"),
        Flag("PLANSTATS", False, _as_bool,
             "plan-statistics store (utils/planstats.py): every profile "
             "session appends one CRC-framed record keyed by plan "
             "fingerprint x schema x bucket, with drift findings against "
             "plancheck's predictions (implies profile sessions and the "
             "metrics plane)"),
        Flag("PLANSTATS_DIR", "", str,
             "directory of the plan-statistics files "
             "(planstats-<host>-<pid>.wal); '' = <tempdir>/srt-planstats; "
             "a non-empty path implies PLANSTATS; never swept at exit"),
        Flag("PLANSTATS_ROTATE_MB", 64.0,
             _parse_positive_float("PLANSTATS_ROTATE_MB"),
             "stats-file rotation threshold in MiB (one old generation "
             "kept as <name>.wal.1)"),
        Flag("DRIFT_ROWS_FACTOR", 4.0,
             _parse_positive_float("DRIFT_ROWS_FACTOR"),
             "cardinality drift threshold against a segment's history "
             "median of rows_out (either direction)"),
        Flag("DRIFT_HBM_FACTOR", 2.0,
             _parse_positive_float("DRIFT_HBM_FACTOR"),
             "memory drift threshold: observed working-set proxy over "
             "plancheck's est_hbm_bytes"),
        Flag("TRACE_SLO_MS", 250.0, _parse_nonneg_float("TRACE_SLO_MS"),
             "slow-request SLO in ms of the trace plane's tail sampling: "
             "a request at or over it (or ending in a typed error) keeps "
             "its span detail; 0 keeps detail for every request"),
        Flag("TRACE_TOPK", 32, _parse_positive_int("TRACE_TOPK"),
             "slow-request log depth (top-K finished requests by "
             "duration)"),
        Flag("LOCKCHECK", False, _as_bool,
             "dynamic lock-order detector (utils/lockcheck.py): held "
             "sets, the acquisition-order graph, cycles, inversions of "
             "registry->session->scheduler->spill, and locks held across "
             "a device dispatch or blocking IO; off by default"),
        Flag("SERVE_PORT", 0, _parse_port,
             "serving daemon (serving/server.py) localhost TCP port; 0 "
             "(default) = an OS-assigned port, read back from Server.port"),
        Flag("SERVE_MAX_SESSIONS", 8,
             _parse_positive_int("SERVE_MAX_SESSIONS"),
             "serving daemon session cap: a hello past this many live "
             "sessions gets a typed session_limit rejection"),
        Flag("SERVE_SESSION_HBM_FRACTION", 0.25,
             _parse_fraction("SERVE_SESSION_HBM_FRACTION"),
             "per-session device memory budget as a fraction of "
             "hbm.budget_bytes(); admission rejects (or queues behind "
             "in-flight work) a request whose estimate exceeds the rest"),
        Flag("SERVE_QUEUE_DEPTH", 16,
             _parse_positive_int("SERVE_QUEUE_DEPTH"),
             "serving daemon per-session scheduler queue depth; a request "
             "past it is shed with a typed BUSY response"),
        Flag("DURABLE", False, _as_bool,
             "durable serving (serving/durable.py): a per-session "
             "write-ahead journal of namespace mutations, table payloads "
             "checkpointed through the spill .npz serde, restore and a "
             "warm-start replay before the listener accepts; off by "
             "default"),
        Flag("CHECKPOINT_DIR", "", _parse_checkpoint_dir,
             "directory of durable serving checkpoints (journals, "
             "payloads, warm-start manifest); '' = <tempdir>/"
             "srt-checkpoint; never swept at exit"),
        Flag("NATIVE_LIB", "", str,
             "explicit path of the port's native shim "
             "(libspark_rapids_tpu_torch.so, utils/native.py)"),
        Flag("MESH_PROBE_S", 5.0, _parse_positive_float("MESH_PROBE_S"),
             "deadline in seconds of one MeshHealth heartbeat "
             "(parallel/mesh.py): a mesh that has not answered by then is "
             "unhealthy and the degradation ladder drops to fewer "
             "devices"),
    ]
}

_overrides: dict = {}
_generation = 0


def generation() -> int:
    return _generation


def get_flag(name: str):
    """Current value of a declared flag (override > env > default)."""
    flag = _FLAGS[name]
    if name in _overrides:
        return _overrides[name]
    raw = os.environ.get(flag.env_var)
    if raw is None:
        return flag.default
    return flag.parse(raw)


def flag_is_set(name: str) -> bool:
    """True when the flag has an explicit value (override or env), as
    opposed to its declared default."""
    return name in _overrides or _FLAGS[name].env_var in os.environ


def flag_default(name: str):
    """Declared default of a flag."""
    return _FLAGS[name].default


def describe_flags() -> str:
    """Human-readable flag table (the CONTRIBUTING.md:57-70 analog)."""
    return "\n".join(f"{f.env_var:<40} default={f.default!r:<10} {f.doc}"
                     for f in _FLAGS.values())


def set_flag(name: str, value) -> None:
    global _generation
    if name not in _FLAGS:
        raise KeyError(f"unknown flag {name!r}")
    _overrides[name] = _FLAGS[name].parse(value) if isinstance(value, str) else value
    _generation += 1


def clear_flag(name: str) -> None:
    global _generation
    _overrides.pop(name, None)
    _generation += 1
