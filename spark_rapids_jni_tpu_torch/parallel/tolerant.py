"""Fault-tolerant mesh execution: lineage replay and mesh degradation
(port of ``parallel/tolerant.py``).

* :func:`run_collective` is the retry boundary every host-side mesh
  launch of the tier goes through. The caller's closure is the lineage:
  it captures the input shards and the partition spec (counts,
  capacities, splitters), so a transient failure re-runs only the failed
  launch, never upstream work. Counted as ``shuffle.retries`` /
  ``shuffle.giveups``. A donated launch is at-most-once: its first
  transient surfaces with zero retries.
* :class:`MeshRunner` is the degradation ladder. A stage whose
  collective failures outlive the retry budget probes a smaller mesh
  (:class:`~.mesh.MeshHealth`), remeshes to the surviving count (halving
  down to ``min_devices``) from a prefix of the runner's device pool,
  and replays the stage there, counted as ``mesh.degraded``. Below the
  floor the typed ``faults.Degraded`` surfaces: ``plan.run_plan`` then
  runs the single-device exact path.

Each launch is a trace-tagged span pair on the flight ring
(``tracing.span_begin``/``span_end``: ``run_collective``'s label,
``mesh.stage``; a retry or a replay stays in the same trace) and, under
``TRACE``, a ``tracing.trace_range`` of the same name. Give-ups,
replays, degradations and the floor are flight instants.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from ..utils import faults, flight, lockcheck, log, metrics, tracing
from .mesh import SHUFFLE_AXIS, MeshHealth, device_pool, make_mesh


def run_collective(
    label: str,
    launch: Callable[[], object],
    site: str = "collective",
    donated: bool = False,
    max_retries: Optional[int] = None,
):
    """Run one host-side mesh launch with lineage-replay retry.

    ``launch`` must be re-runnable from host state alone (nothing is
    consumed until it succeeds). ``donated=True`` declares the opposite
    and makes the boundary at-most-once: the first transient surfaces
    unchanged (``shuffle.giveups`` still counts it). Only transient
    failures retry; out-of-memory, permanent, cancel and deadline
    classes surface unchanged."""
    tok = tracing.span_begin(label)
    err: Optional[str] = None
    try:
        with tracing.trace_range(label):
            return _run_collective(label, launch, site, donated,
                                   max_retries)
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        tracing.span_end(tok, error=err)


def _run_collective(label, launch, site, donated, max_retries):
    attempt = 0
    while True:
        faults.check_cancel()
        try:
            faults.inject(site)
            return launch()
        except (faults.Cancelled, faults.DeadlineExceeded, faults.Degraded):
            raise
        except Exception as e:
            cls = faults.classify(e)
            if cls is not faults.TransientDeviceError:
                faults.note_error_class(e, label)
                raise
            if donated:
                # at-most-once: this branch precedes every retry
                metrics.counter_add("shuffle.giveups")
                if flight.enabled():
                    flight.record("I", "shuffle.giveup", f"{label}:donated")
                raise
            limit = (faults.retry_max() if max_retries is None
                     else int(max_retries))
            if attempt >= limit:
                metrics.counter_add("shuffle.giveups")
                if flight.enabled():
                    flight.record("I", "shuffle.giveup",
                                  f"{label}:{attempt}")
                if isinstance(e, faults.FaultError):
                    raise
                raise cls(
                    f"{label}: collective retries exhausted after "
                    f"{attempt} attempt(s): "
                    f"{type(e).__name__}: {str(e)[:200]}") from e
            attempt += 1
            metrics.counter_add("shuffle.retries")
            faults.sleep_backoff(attempt, label, error=e)


class MeshRunner:
    """Owns a mesh and the ladder that shrinks it under persistent
    collective failure.

    ``run_stage(label, stage)`` runs ``stage(mesh)`` (re-runnable from
    host-side lineage) through :func:`run_collective`. When a stage's
    transient failures outlive the retry budget the runner walks down:
    probe the next smaller mesh (a prefix of its pool) with a heartbeat,
    remesh to it, and replay the stage there. At ``min_devices`` with
    failures persisting, ``faults.Degraded`` surfaces."""

    def __init__(self, n_devices: Optional[int] = None,
                 axis: str = SHUFFLE_AXIS, min_devices: int = 1,
                 health: Optional[MeshHealth] = None,
                 devices: Optional[Sequence] = None):
        self.axis = axis
        self.pool = device_pool(devices)
        self.requested = (len(self.pool) if n_devices is None
                          else int(n_devices))
        self.min_devices = max(int(min_devices), 1)
        self.health = health or MeshHealth()
        self._lock = lockcheck.make_lock("mesh.runner")
        self.mesh = make_mesh(self.requested, axis, devices=self.pool)
        self.degraded = False
        self.stages = 0
        self.replays = 0
        self.degradations = 0

    @property
    def n_devices(self) -> int:
        with self._lock:
            return int(self.mesh.shape[self.axis])

    def run_stage(self, label: str, stage: Callable[[object], object]):
        """Run ``stage(mesh)`` with retry and degradation-replay, the
        whole ladder (replays and degradations included) inside one
        trace-tagged ``mesh.stage`` span, so a replay keeps the
        original request's trace."""
        with self._lock:
            self.stages += 1
        tok = tracing.span_begin("mesh.stage")
        err: Optional[str] = None
        try:
            with tracing.trace_range("mesh.stage"):
                return self._run_stage(label, stage)
        except BaseException as e:
            err = type(e).__name__
            raise
        finally:
            tracing.span_end(tok, error=err)

    def _run_stage(self, label: str, stage: Callable[[object], object]):
        while True:
            with self._lock:
                mesh = self.mesh
            try:
                return run_collective(label, lambda: stage(mesh))
            except (faults.Cancelled, faults.DeadlineExceeded,
                    faults.Degraded):
                raise
            except Exception as e:
                if faults.classify(e) is not faults.TransientDeviceError:
                    raise
                # retries exhausted at this mesh size: walk the ladder
                self._degrade(label, mesh, e)
                with self._lock:
                    self.replays += 1
                if flight.enabled():
                    flight.record("I", "mesh.replay", label)

    def _degrade(self, label: str, failed_mesh, cause) -> None:
        """Remesh to the surviving device count (or raise Degraded)."""
        n = int(failed_mesh.shape[self.axis])
        while n > self.min_devices:
            n = max(n // 2, self.min_devices)
            try:
                candidate = make_mesh(n, self.axis, devices=self.pool)
            except (faults.FaultError, ValueError) as e:
                faults.note_error_class(e, "mesh.remesh")
                continue  # this rung is dead too; keep walking down
            if not self.health.probe(candidate, self.axis):
                continue
            with self._lock:
                # another thread may have degraded further already;
                # never grow the mesh back mid-incident
                if int(self.mesh.shape[self.axis]) > n:
                    self.mesh = candidate
                self.degraded = True
                self.degradations += 1
            metrics.counter_add("mesh.degraded")
            metrics.gauge_set("mesh.devices", n)
            if flight.enabled():
                flight.record("I", "mesh.degraded", f"{label}:{n}")
            log.log("WARN", "faults", "mesh_degraded", stage=label,
                    devices=n, was=int(failed_mesh.shape[self.axis]),
                    cause=f"{type(cause).__name__}: {str(cause)[:200]}")
            return
        metrics.counter_add("mesh.exhausted")
        if flight.enabled():
            flight.record("I", "mesh.exhausted", label)
        raise faults.Degraded(
            f"mesh stage {label!r}: collective failures persist down "
            f"to the {self.min_devices}-device floor; degrade to the "
            "single-device exact path") from cause

    def to_doc(self) -> dict:
        with self._lock:
            return {
                "axis": self.axis,
                "requested_devices": self.requested,
                "devices": int(self.mesh.shape[self.axis]),
                "min_devices": self.min_devices,
                "degraded": self.degraded,
                "stages": self.stages,
                "replays": self.replays,
                "degradations": self.degradations,
            }
