"""Fault-tolerant execution plane: taxonomy, injection, retry, cancel
(port of ``utils/faults.py``, in full).

Four planes in one file, so every dispatch boundary shares one
vocabulary:

* a **typed error taxonomy** — :class:`TransientDeviceError`,
  :class:`PermanentError`, :class:`ResourceExhausted`,
  :class:`Cancelled`, :class:`DeadlineExceeded`, and the serving shed
  state :class:`Degraded` — with :func:`classify` mapping raw exceptions
  onto it by type and message. On CUDA, ``torch.cuda.OutOfMemoryError``
  and ``CUDA error: out of memory`` are :class:`ResourceExhausted`; the
  sticky errors that leave the CUDA context unusable (an illegal memory
  access, a misaligned address, a device-side assert, an unspecified
  launch failure, an illegal instruction) are :class:`PermanentError`
  and are never retried. CUDA reports such an error at a later
  synchronisation, often at another op's boundary: one more reason not
  to retry it there.
* a **deterministic fault-injection harness** —
  ``SPARK_RAPIDS_TPU_FAULTS="[seed=N,]site:kind:prob[:count],..."``
  arms seeded rules at the named sites (:data:`SITES`). The decision
  for a rule's call ``i`` hashes ``(seed, site, kind, i)``, the JAX
  package's stream, so one spec injects at the same calls in both.
* **retry with exponential backoff and deterministic jitter** for
  transient-classified errors (:func:`run_with_retry`), counted as
  ``retry.attempts`` / ``retry.giveups`` / ``retry.backoff_ms``. Work
  that consumes its input is at-most-once: callers check for a consumed
  input before they retry.
* **deadlines and cooperative cancellation** (:class:`CancelToken`,
  :func:`scoped_token`, :func:`check_cancel`, checked between plan ops
  and stream batches) and a **circuit breaker** (:class:`CircuitBreaker`).

The plan is compiled once per ``config.generation()``, so :func:`inject`
and :func:`check_cancel` cost an int compare and an attribute read when
the plane is idle.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Callable, Optional

from . import config, lockcheck, log, metrics

# ---------------------------------------------------------------------------
# typed error taxonomy
# ---------------------------------------------------------------------------


class FaultError(RuntimeError):
    """Base of the typed taxonomy; ``str(e)`` is the operator message."""


class TransientDeviceError(FaultError):
    """The device/tunnel hiccuped (UNAVAILABLE, reset, unreachable):
    the op is intact and a retry with backoff may succeed."""


class PermanentError(FaultError):
    """A deterministic failure (bad plan, unknown op, genuine bug):
    retrying burns chip time for the same answer. Unrecognized raw
    exceptions classify here and are surfaced UNCHANGED."""


class ResourceExhausted(FaultError):
    """HBM/allocation pressure: retrying at the same shape will fail
    the same way, but half-batch chunking or the exact path may fit."""


class Cancelled(FaultError):
    """The request's cancellation token fired (client gone, explicit
    cancel): stop at the next checkpoint and reclaim."""


class DeadlineExceeded(FaultError):
    """The request's deadline passed: same checkpoint contract as
    :class:`Cancelled`, distinct type so clients can tell them apart."""


class Degraded(FaultError):
    """The serving circuit breaker is OPEN: the daemon sheds requests
    with this typed state instead of burning them against a dead
    device. Answers immediately — a degraded daemon never hangs."""


# message markers for transient device/tunnel failures — the superset
# of bench.py's historical _UNREACHABLE_MARKERS (gRPC/absl capitalize
# freely, so matching is casefolded)
_TRANSIENT_MARKERS = (
    "unreachable", "unavailable", "deadline_exceeded",
    "failed to connect", "connection reset", "socket closed",
    "connection refused", "broken pipe", "device or resource busy",
)

# "timeout" covers bench's structured {type: "timeout"} per-arm
# records; "TimeoutExpired" stays for live subprocess exceptions and
# old failure records
_TRANSIENT_TYPES = (
    "DeviceUnreachable", "TimeoutExpired", "Unavailable", "timeout",
)

_OOM_MARKERS = (
    "resource_exhausted", "resource exhausted", "out of memory",
    "out_of_memory", "allocation failure", "failed to allocate",
    "exceeds hbm budget",
)

# torch's allocator failure (its message says "CUDA out of memory" too)
_OOM_TYPES = ("OutOfMemoryError",)

# CUDA's sticky errors: the context is unusable after one, so no retry
# can succeed (cudaErrorIllegalAddress, cudaErrorMisalignedAddress,
# cudaErrorAssert, cudaErrorLaunchFailure, cudaErrorIllegalInstruction)
_STICKY_MARKERS = (
    "illegal memory access", "misaligned address",
    "device-side assert triggered", "unspecified launch failure",
    "illegal instruction",
)


def classify_text(type_name: str, message: str) -> type:
    """Map an exception's (type name, message) onto a taxonomy CLASS —
    the string form shared with bench.py, whose failure records carry
    text, not live exceptions. Unrecognized input is PermanentError:
    retrying an unknown failure is how retry storms start."""
    msg = f"{type_name} {message}".lower()
    if any(m in msg for m in _STICKY_MARKERS):
        return PermanentError
    if type_name in _OOM_TYPES or any(m in msg for m in _OOM_MARKERS):
        return ResourceExhausted
    if type_name in _TRANSIENT_TYPES or any(
        m in msg for m in _TRANSIENT_MARKERS
    ):
        return TransientDeviceError
    if "cancelled" in msg or "canceled" in msg:
        return Cancelled
    return PermanentError


def classify(exc: BaseException) -> type:
    """Taxonomy class for a raw exception (identity for exceptions
    already typed)."""
    if isinstance(exc, FaultError):
        return type(exc)
    return classify_text(type(exc).__name__, str(exc))


def retryable_class(cls: type) -> bool:
    """May a failure of this class be retried at all? Transient errors
    retry in place; ResourceExhausted retries via degradation (smaller
    chunks / exact path) — both are worth another attempt. Permanent /
    Cancelled / DeadlineExceeded / Degraded never retry."""
    return cls in (TransientDeviceError, ResourceExhausted)


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

# the injection-site registry: every name a FAULTS plan may target.
# Each site is armed at exactly one choke point:
#   dispatch     runtime_bridge._dispatch + plan._run_op_tolerant (every
#                op's launch)
#   compile      the JAX package's executable build (no port call site:
#                the port compiles nothing at run time)
#   serde        runtime_bridge._table_from_wire / _table_to_wire
#   hbm_admit    serving session.Session.admit (HBM budget admission)
#   serve_accept serving server._dispatch (per-command accept point)
#   spill        utils/spill.py eviction copy-out + repage upload
#   checkpoint   serving/durable.py journal append (torn-write
#                emulation), payload persist, and restore-time read
#   shuffle      parallel/shuffle.py host wrappers: every exchange
#                pack/all_to_all/unpack launch boundary
#   collective   parallel/distributed.py + parallel/planmesh.py: every
#                shard_map launch of a distributed op or mesh stage
#   mesh         parallel/mesh.py: mesh construction (make_mesh) and
#                the MeshHealth heartbeat probe
#   kernel       kernels/registry.py dispatch_kernel: the kernel tier's
#                launch boundary (a seeded fault here falls back to the
#                exact path byte-identically)
# hbm_admit, serve_accept, checkpoint, shuffle, collective and mesh are
# the JAX package's serving and mesh sites: the vocabulary is shared, so
# a spec may name them; the port has no call site for them yet.
SITES = ("dispatch", "compile", "serde", "hbm_admit", "serve_accept",
         "spill", "checkpoint", "shuffle", "collective", "mesh",
         "kernel")

KINDS = ("transient", "oom", "permanent")

_KIND_ERRORS = {
    "transient": TransientDeviceError,
    "oom": ResourceExhausted,
    "permanent": PermanentError,
}


class _Rule:
    """One compiled ``site:kind:prob[:count]`` entry with its per-site
    deterministic decision stream and injection budget."""

    __slots__ = ("site", "kind", "prob", "count", "calls", "injected")

    def __init__(self, site: str, kind: str, prob: float, count: int):
        self.site = site
        self.kind = kind
        self.prob = prob
        self.count = count  # 0 = unlimited
        self.calls = 0
        self.injected = 0


class FaultPlan:
    """A compiled FAULTS spec: rules grouped by site + the seed. The
    per-rule decision for call index ``i`` hashes ``(seed, site, kind,
    i)`` — independent of thread interleaving across sites and of wall
    clock, so a seeded chaos run is replayable."""

    def __init__(self, seed: int, rules):
        self.seed = seed
        self._by_site = {}
        self._lock = lockcheck.make_lock("faults.plan")
        for r in rules:
            self._by_site.setdefault(r.site, []).append(r)

    def _decide(self, rule: _Rule, index: int) -> bool:
        if rule.prob >= 1.0:
            return True
        if rule.prob <= 0.0:
            return False
        h = hashlib.sha256(
            f"{self.seed}:{rule.site}:{rule.kind}:{index}".encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64 < rule.prob

    def fire(self, site: str) -> None:
        """Raise the first armed rule for ``site`` whose deterministic
        decision stream says "inject now"; no-op otherwise."""
        rules = self._by_site.get(site)
        if not rules:
            return
        hit: Optional[_Rule] = None
        with self._lock:
            for r in rules:
                i = r.calls
                r.calls += 1
                if r.count and r.injected >= r.count:
                    continue
                if self._decide(r, i):
                    r.injected += 1
                    hit = r
                    break
        if hit is None:
            return
        metrics.counter_add("faults.injected")
        metrics.counter_add(f"faults.injected.{site}.{hit.kind}")
        raise _KIND_ERRORS[hit.kind](
            f"injected {hit.kind} fault at site {site!r} "
            f"(call {hit.calls - 1}, injection {hit.injected}"
            f"{'/' + str(hit.count) if hit.count else ''}, "
            f"seed {self.seed})"
        )

    def stats(self) -> dict:
        with self._lock:
            return {
                f"{r.site}:{r.kind}": {
                    "calls": r.calls, "injected": r.injected,
                }
                for rs in self._by_site.values() for r in rs
            }


def parse_spec(spec: str, _env="SPARK_RAPIDS_TPU_FAULTS") -> FaultPlan:
    """Compile ``[seed=N,]site:kind:prob[:count],...`` into a
    :class:`FaultPlan`; raises ValueError naming the env var on any
    grammar/vocabulary error (the loud-fail contract of config.py)."""
    seed = 0
    rules = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            try:
                seed = int(entry[len("seed="):])
            except ValueError:
                raise ValueError(
                    f"{_env}: bad seed in {entry!r} (want seed=<int>)"
                )
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"{_env}: entry {entry!r} must be "
                "site:kind:prob[:count]"
            )
        site, kind, prob_s = parts[0], parts[1], parts[2]
        if site not in SITES:
            raise ValueError(
                f"{_env}: unknown site {site!r} "
                f"(registered sites: {', '.join(SITES)})"
            )
        if kind not in KINDS:
            raise ValueError(
                f"{_env}: unknown kind {kind!r} "
                f"(kinds: {', '.join(KINDS)})"
            )
        try:
            prob = float(prob_s)
        except ValueError:
            raise ValueError(f"{_env}: bad probability in {entry!r}")
        if not (0.0 <= prob <= 1.0):
            raise ValueError(
                f"{_env}: probability must be in [0, 1], got {prob_s!r}"
            )
        count = 0
        if len(parts) == 4:
            try:
                count = int(parts[3])
            except ValueError:
                raise ValueError(f"{_env}: bad count in {entry!r}")
            if count < 0:
                raise ValueError(
                    f"{_env}: count must be >= 0, got {parts[3]!r}"
                )
        rules.append(_Rule(site, kind, prob, count))
    return FaultPlan(seed, rules)


# compiled plan cached against config.generation(): the disabled path
# (no FAULTS configured) costs one int compare + global read per
# inject() — the metrics._refresh_gate discipline
_PLAN: Optional[FaultPlan] = None
_PLAN_GEN = -1
_PLAN_LOCK = lockcheck.make_lock("faults.plan_cache")


def _plan() -> Optional[FaultPlan]:
    global _PLAN, _PLAN_GEN
    gen = config.generation()
    if _PLAN_GEN != gen:
        with _PLAN_LOCK:
            if _PLAN_GEN != gen:
                spec = str(config.get_flag("FAULTS") or "")
                _PLAN = parse_spec(spec) if spec.strip() else None
                _PLAN_GEN = gen
                if _PLAN is not None:
                    log.log(
                        "WARN", "faults", "fault_injection_armed",
                        spec=spec, seed=_PLAN.seed,
                    )
    return _PLAN


def active() -> bool:
    """Is a fault plan armed? (cached gate; see :func:`_plan`)."""
    return _plan() is not None


def inject(site: str) -> None:
    """The injection hook every registered site calls. One int compare
    when no plan is armed; with a plan, the site's rules decide
    deterministically whether to raise a typed fault here."""
    p = _plan()
    if p is not None:
        p.fire(site)


def injection_stats() -> dict:
    """Per-rule calls/injected counts of the armed plan ({} when off)."""
    p = _plan()
    return p.stats() if p is not None else {}


# ---------------------------------------------------------------------------
# retry with exponential backoff + deterministic jitter
# ---------------------------------------------------------------------------


def retry_max() -> int:
    return int(config.get_flag("RETRY_MAX"))


def backoff_ms(attempt: int, label: str = "", seed: int = 0) -> float:
    """Backoff for retry ``attempt`` (1-based): ``RETRY_BASE_MS *
    2^(attempt-1)``, jittered into [0.5x, 1.0x) by a hash of
    ``(seed, label, attempt)`` — decorrelated across call sites without
    wall-clock or global-RNG nondeterminism."""
    base = float(config.get_flag("RETRY_BASE_MS"))
    raw = base * (2.0 ** (max(int(attempt), 1) - 1))
    h = hashlib.sha256(f"{seed}:{label}:{attempt}".encode()).digest()
    frac = int.from_bytes(h[:8], "big") / 2.0 ** 64
    return raw * (0.5 + 0.5 * frac)


def sleep_backoff(attempt: int, label: str, error=None) -> float:
    """Meter one retry (``retry.attempts``, ``retry.backoff_ms``,
    WARN log) and sleep its backoff — capped to the
    bound token's remaining deadline, which is re-checked first so an
    expired request never sleeps. Returns the ms slept."""
    check_cancel()
    ms = backoff_ms(attempt, label)
    tok = current_token()
    if tok is not None:
        rem = tok.remaining()
        if rem is not None:
            ms = min(ms, max(rem, 0.0) * 1e3)
    metrics.counter_add("retry.attempts")
    metrics.hist_observe(
        "retry.backoff_ms", ms, bounds=metrics.SPAN_MS_BOUNDS
    )
    log.log(
        "WARN", "faults", "transient_retry", site=label,
        attempt=attempt, backoff_ms=round(ms, 2),
        error=(
            f"{type(error).__name__}: {str(error)[:200]}"
            if error is not None else None
        ),
    )
    if ms > 0:
        time.sleep(ms / 1e3)
    return ms


def run_with_retry(
    fn: Callable[[], object], label: str,
    on_error: Optional[Callable[[Exception, type], bool]] = None,
):
    """Run ``fn`` with transient-retry semantics at one boundary:

    * Cancelled / DeadlineExceeded / Degraded pass straight through
      (a cancelled request must stop, not persist).
    * ``on_error(e, cls)``, when given, sees every other failure with its
      class first: it may raise, return True to run ``fn`` again at once
      (no backoff, no attempt counted) or False to go on as below.
    * PermanentError-classified raw exceptions surface UNCHANGED —
      genuine op errors (ValueError, KeyError, ...) keep their exact
      type and message (tests pin them).
    * Transient/OOM-classified failures retry up to RETRY_MAX with
      backoff; exhaustion raises the typed class chained to the last
      raw error (``retry.giveups``).

    Callers whose ``fn`` consumes its input (donation) must NOT retry
    it: at-most-once is their invariant (``plan.run_plan``'s
    ``on_error`` re-raises once ``_input_consumed``)."""
    attempt = 0
    while True:
        check_cancel()
        try:
            return fn()
        except (Cancelled, DeadlineExceeded, Degraded):
            raise
        except Exception as e:
            cls = classify(e)
            if on_error is not None and on_error(e, cls):
                continue
            if not retryable_class(cls):
                raise
            if attempt >= retry_max():
                metrics.counter_add("retry.giveups")
                if isinstance(e, FaultError):
                    raise
                raise cls(
                    f"{label}: retries exhausted after {attempt} "
                    f"attempt(s): {type(e).__name__}: {str(e)[:200]}"
                ) from e
            attempt += 1
            sleep_backoff(attempt, label, error=e)


# ---------------------------------------------------------------------------
# deadlines + cooperative cancellation
# ---------------------------------------------------------------------------


class CancelToken:
    """Cooperative cancellation + optional deadline for one request.

    Checked between plan segments and stream batches
    (:func:`check_cancel`); holders call :meth:`cancel` to stop the
    work at its next checkpoint. ``clock`` is injectable for tests."""

    __slots__ = ("_cancelled", "_reason", "deadline", "_clock")

    def __init__(self, deadline_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._cancelled = False
        self._reason = ""
        self._clock = clock
        self.deadline = (
            clock() + float(deadline_s)
            if deadline_s is not None and deadline_s > 0 else None
        )

    def cancel(self, reason: str = "cancelled") -> None:
        self._cancelled = True
        self._reason = reason

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def remaining(self) -> Optional[float]:
        """Seconds until the deadline (None when none is set)."""
        if self.deadline is None:
            return None
        return self.deadline - self._clock()

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0

    def check(self) -> None:
        """Raise the typed Cancelled/DeadlineExceeded when due."""
        if self._cancelled:
            metrics.counter_add("faults.cancelled")
            raise Cancelled(self._reason or "request cancelled")
        if self.expired():
            metrics.counter_add("faults.deadline_exceeded")
            raise DeadlineExceeded(
                "request deadline exceeded "
                f"({-self.remaining():.3f}s past)"
            )


_TLS = threading.local()


def current_token() -> Optional[CancelToken]:
    return getattr(_TLS, "token", None)


class scoped_token:
    """Bind ``token`` to the calling thread for the scope — every
    :func:`check_cancel` checkpoint under it observes the token.
    ``scoped_token(None)`` is a no-op scope (keeps call sites
    branch-free)."""

    __slots__ = ("_tok", "_prev")

    def __init__(self, token: Optional[CancelToken]):
        self._tok = token

    def __enter__(self):
        self._prev = getattr(_TLS, "token", None)
        if self._tok is not None:
            _TLS.token = self._tok
        return self._tok

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._tok is not None:
            _TLS.token = self._prev
        return False


def check_cancel() -> None:
    """The cooperative checkpoint: raises the bound token's typed
    Cancelled/DeadlineExceeded, no-op (one TLS read) when no token is
    bound — cheap enough for between-segment and between-batch use."""
    tok = getattr(_TLS, "token", None)
    if tok is not None:
        tok.check()


# ---------------------------------------------------------------------------
# circuit breaker (serving daemon)
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """N-consecutive-transient-failures circuit breaker.

    CLOSED counts consecutive transient-classified failures (other
    classes neither count nor reset — a bad_request burst must not mask
    a dying device, and must not trip the breaker either). At
    ``threshold`` it flips OPEN: :meth:`allow` sheds every request with
    the typed :class:`Degraded`. After ``probe_interval_s`` one caller
    is admitted as the HALF_OPEN trial (the serving daemon also runs a
    background probe so recovery does not wait for client traffic);
    trial success closes the breaker, trial failure re-opens it and
    re-arms the probe timer. State transitions are metered
    (``breaker.opened``/``breaker.closed``/``breaker.half_open``
    counters)."""

    def __init__(self, threshold: Optional[int] = None,
                 probe_interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "serving"):
        self.threshold = (
            int(config.get_flag("BREAKER_THRESHOLD"))
            if threshold is None else int(threshold)
        )
        self.probe_interval_s = (
            float(config.get_flag("BREAKER_PROBE_S"))
            if probe_interval_s is None else float(probe_interval_s)
        )
        self.name = name
        self._clock = clock
        self._lock = lockcheck.make_lock("faults.breaker")
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._opens = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _record(self, event: str) -> None:
        metrics.counter_add(f"breaker.{event}")
        log.log("WARN", "faults", f"breaker_{event}",
                name=self.name, failures=self._failures)

    def allow(self) -> bool:
        """Admission check before serving a request. CLOSED: pass.
        OPEN: shed (typed Degraded) until the probe interval elapses,
        then admit ONE caller as the half-open trial (returns True for
        the trial so it can label itself). HALF_OPEN: shed everyone but
        the in-flight trial."""
        with self._lock:
            if self._state == CLOSED:
                return False
            now = self._clock()
            if (
                self._state == OPEN
                and now - self._opened_at >= self.probe_interval_s
            ):
                self._state = HALF_OPEN
                self._record("half_open")
                return True  # this caller IS the probe
            wait = max(
                self.probe_interval_s - (now - self._opened_at), 0.0
            )
            raise Degraded(
                f"{self.name} degraded: circuit breaker {self._state} "
                f"after {self._failures} consecutive transient "
                f"failure(s); next probe in {wait:.2f}s"
            )

    def note_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != CLOSED:
                self._state = CLOSED
                self._record("closed")

    def note_failure(self, exc: BaseException) -> bool:
        """Record a request failure; only transient-classified ones
        count toward the trip. Returns True when this failure opened
        (or re-opened) the breaker."""
        if classify(exc) is not TransientDeviceError:
            return False
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN or (
                self._state == CLOSED
                and self._failures >= self.threshold
            ):
                self._state = OPEN
                self._opened_at = self._clock()
                self._opens += 1
                self._record("opened")
                return True
            if self._state == OPEN:
                # a straggler failing while open: re-arm the timer
                self._opened_at = self._clock()
        return False

    def to_doc(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "threshold": self.threshold,
                "probe_interval_s": self.probe_interval_s,
                "opens": self._opens,
            }


def default_probe(device="cuda") -> None:
    """The background half-open trial: one small CUDA op and a
    ``torch.cuda.synchronize()`` through the serve_accept injection site
    — succeeds iff the device answers AND the armed fault plan lets
    it."""
    import torch

    inject("serve_accept")
    torch.ones(8, dtype=torch.int32, device=device).add_(1)
    torch.cuda.synchronize(device)


def note_error_class(exc: BaseException, where: str) -> None:
    """Meter one classified failure at a dispatch boundary
    (``faults.class.<Class>`` counters) — the
    classifier's presence at boundaries that do not retry (pipeline
    workers, the serving command loop)."""
    if not metrics.enabled():
        return
    metrics.counter_add(f"faults.class.{classify(exc).__name__}")
