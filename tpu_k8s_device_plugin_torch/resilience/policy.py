"""Shared retry / circuit-breaker / watchdog policies.

Before this module every failure-prone boundary rolled its own recovery:
``manager.py`` hardcoded 3x3s Register retries, ``slice/client.py``
carried a private backoff loop, ``health/client.py`` did a single-shot
RPC with no retry at all, and a hung libtpu/sysfs probe would stall the
whole pulse loop.  These three primitives replace all of that:

- :class:`RetryPolicy` — jittered exponential backoff with an attempt
  cap and an overall deadline.  The jitter RNG is seeded per policy so
  chaos runs replay byte-identically (the ``ENGINE_FUZZ_SEED``
  discipline applied to backoff).
- :class:`CircuitBreaker` — classic closed/open/half-open.  Open calls
  fail fast with :class:`CircuitOpenError`; after ``reset_timeout_s``
  ONE probe call is admitted (half-open) and its outcome decides
  whether the circuit closes again.
- :class:`Watchdog` — hung-call containment: the call runs on a worker
  thread and the caller gets :class:`WatchdogTimeout` after
  ``timeout_s`` instead of blocking forever.  The abandoned thread is
  left to die with its call (Python cannot kill it), which is exactly
  the trade the pulse loop needs: mark the probe failed NOW, let the
  wedged syscall rot in the background.

All three emit obs metrics when given a :class:`ResilienceMetrics`
(``tpu_resilience_retries_total{op}``, ``tpu_breaker_state{op}``,
``tpu_watchdog_trips_total{op}``) and journal state transitions to the
PR-4 flight recorder, so a chaos soak can assert not just that the
system reconverged but that the resilience layer is what did it.

The port's own copy of the JAX package's ``resilience/policy.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Optional,
    Tuple,
    Type,
    TypeVar,
)

if TYPE_CHECKING:  # typing only: the runtime stays stdlib-importable
    from ..obs import FlightRecorder, Registry

log = logging.getLogger(__name__)

_T = TypeVar("_T")

# tpu_breaker_state{op} gauge values (documented in the metric help
# text and docs/user-guide/resilience.md)
BREAKER_CLOSED = 0
BREAKER_OPEN = 1
BREAKER_HALF_OPEN = 2

_STATE_NAMES: Dict[int, str] = {
    BREAKER_CLOSED: "closed", BREAKER_OPEN: "open",
    BREAKER_HALF_OPEN: "half_open"}


class CircuitOpenError(RuntimeError):
    """Raised by a breaker that is refusing calls (fail-fast)."""


class WatchdogTimeout(TimeoutError):
    """The watched call exceeded its deadline and was abandoned."""


class ResilienceMetrics:
    """The resilience metric families on one obs.Registry.

    Get-or-create semantics (the registry's own) mean every policy in a
    process shares one set of families; the ``op`` label tells the
    boundaries apart.  Also carries the suppressed-errors counter the
    once-silent ``except Exception: pass`` sites now increment.
    """

    def __init__(self, registry: "Registry") -> None:
        self.retries = registry.counter(
            "tpu_resilience_retries_total",
            "Retried attempts (attempt 2 and later) per operation.",
            ("op",))
        self.giveups = registry.counter(
            "tpu_resilience_giveups_total",
            "Retry loops that exhausted attempts/deadline, per "
            "operation.", ("op",))
        self.breaker_state = registry.gauge(
            "tpu_breaker_state",
            "Circuit-breaker state per operation: 0 closed, 1 open, "
            "2 half-open.", ("op",))
        self.breaker_transitions = registry.counter(
            "tpu_breaker_transitions_total",
            "Circuit-breaker state transitions per operation.",
            ("op", "to"))
        self.watchdog_trips = registry.counter(
            "tpu_watchdog_trips_total",
            "Calls abandoned by the watchdog after exceeding their "
            "deadline, per operation.", ("op",))
        self.suppressed = registry.counter(
            "tpu_suppressed_errors_total",
            "Exceptions swallowed at deliberately-forgiving sites "
            "(logged at DEBUG), by site.", ("site",))


_SUPPRESSED_METRICS: Optional[ResilienceMetrics] = None


def set_suppressed_metrics(metrics: Optional[ResilienceMetrics]) -> None:
    """Process-wide sink for :func:`suppressed` counts.  The cmd wiring
    points this at the node registry's families; library embedders that
    never call it still get the DEBUG log line."""
    global _SUPPRESSED_METRICS
    _SUPPRESSED_METRICS = metrics


def suppressed(site: str, exc: BaseException,
               logger: Optional[logging.Logger] = None,
               metrics: Optional[ResilienceMetrics] = None) -> None:
    """Account for a deliberately-swallowed exception.

    The contract for every ``except Exception: pass`` site that
    survives review: the fault stays non-fatal, but it is logged at
    DEBUG with the exception and counted in
    ``tpu_suppressed_errors_total{site}`` so a flood of swallowed
    faults is visible on /metrics instead of invisible forever.
    *metrics* pins the counter to a specific registry; without it the
    process-wide sink (see :func:`set_suppressed_metrics`) is used."""
    (logger or log).debug("suppressed error at %s: %s: %s",
                          site, type(exc).__name__, exc)
    m = metrics if metrics is not None else _SUPPRESSED_METRICS
    if m is not None:
        m.suppressed.labels(site=site).inc()


class RetryPolicy:
    """Jittered exponential backoff with attempt + deadline caps.

    ``call()`` runs *fn* until it succeeds, raises a non-retryable
    exception, exhausts ``max_attempts``, or crosses ``deadline_s``
    (measured from the first attempt).  ``sleeps()`` exposes the raw
    backoff schedule for callers that need to own their own loop (the
    slice client's join poll, which retries on a *response*, not an
    exception).
    """

    def __init__(self,
                 max_attempts: int = 3,
                 initial_backoff_s: float = 0.5,
                 max_backoff_s: float = 15.0,
                 multiplier: float = 2.0,
                 jitter: float = 0.1,
                 deadline_s: float = 0.0,
                 seed: Optional[int] = None) -> None:
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.max_attempts = max_attempts
        self.initial_backoff_s = initial_backoff_s
        self.max_backoff_s = max_backoff_s
        self.multiplier = multiplier
        self.jitter = jitter
        self.deadline_s = deadline_s
        # seeded per policy: a chaos run with a fixed seed replays the
        # same backoff schedule every time
        self._rng = random.Random(seed)

    def backoff_s(self, attempt: int) -> float:
        """Sleep before attempt *attempt*+1 (attempt is 1-based)."""
        base = min(self.initial_backoff_s
                   * (self.multiplier ** (attempt - 1)),
                   self.max_backoff_s)
        if self.jitter:
            base *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, base)

    def call(self, fn: Callable[[], _T], *, op: str,
             retry_on: Tuple[Type[BaseException], ...] = (Exception,),
             stop: Optional[threading.Event] = None,
             metrics: Optional[ResilienceMetrics] = None,
             recorder: Optional["FlightRecorder"] = None,
             logger: Optional[logging.Logger] = None) -> _T:
        """Run *fn* under this policy.  Exceptions outside *retry_on*
        propagate immediately; the final retryable failure propagates
        after the budget is spent.  *stop* aborts the backoff sleep
        early (a stopping manager must not serve out a retry loop);
        an abort raises the last failure."""
        lg = logger or log
        t0 = time.monotonic()
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            if stop is not None and stop.is_set():
                break
            try:
                return fn()
            except retry_on as e:
                last = e
                out_of_time = (
                    self.deadline_s
                    and time.monotonic() - t0 >= self.deadline_s)
                if attempt >= self.max_attempts or out_of_time:
                    break
                delay = self.backoff_s(attempt)
                lg.warning("%s attempt %d/%d failed (%s); retrying in "
                           "%.2fs", op, attempt, self.max_attempts,
                           e, delay)
                if metrics is not None:
                    metrics.retries.labels(op=op).inc()
                if recorder is not None:
                    recorder.record("tpu_resilience_retry", op=op,
                                    attempt=attempt, error=str(e))
                if stop is not None:
                    if stop.wait(delay):
                        break
                else:
                    time.sleep(delay)
        if metrics is not None:
            metrics.giveups.labels(op=op).inc()
        if recorder is not None:
            recorder.record("tpu_resilience_giveup", op=op,
                            error=str(last))
        if last is None:
            raise CircuitOpenError(f"{op}: aborted by stop event "
                                   "before the first attempt")
        raise last


class CircuitBreaker:
    """Closed/open/half-open breaker with single-probe admission.

    ``allow()`` answers whether a call may proceed; callers then report
    the outcome via ``record_success()`` / ``record_failure()`` — or
    use ``call()`` which does all three.  ``failure_threshold``
    consecutive failures open the circuit; after ``reset_timeout_s``
    exactly one caller wins the half-open probe slot and its outcome
    closes or re-opens the circuit.  Thread-safe.
    """

    def __init__(self, op: str,
                 failure_threshold: int = 3,
                 reset_timeout_s: float = 30.0,
                 metrics: Optional[ResilienceMetrics] = None,
                 recorder: Optional["FlightRecorder"] = None,
                 logger: Optional[logging.Logger] = None) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.op = op
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._metrics = metrics
        self._recorder = recorder
        self._log = logger or log
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        if metrics is not None:
            metrics.breaker_state.labels(op=op).set(BREAKER_CLOSED)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def _transition(self, to: int) -> None:
        # lock held by caller
        if self._state == to:
            return
        self._state = to
        name = _STATE_NAMES[to]
        self._log.log(
            logging.WARNING if to != BREAKER_CLOSED else logging.INFO,
            "breaker %s -> %s", self.op, name)
        if self._metrics is not None:
            self._metrics.breaker_state.labels(op=self.op).set(to)
            self._metrics.breaker_transitions.labels(
                op=self.op, to=name).inc()
        if self._recorder is not None:
            self._recorder.record("tpu_breaker_transition", op=self.op,
                                  to=name)

    def allow(self) -> bool:
        """May a call proceed right now?  In half-open, only the first
        caller after the reset timeout gets True (the probe)."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if (time.monotonic() - self._opened_at
                    >= self.reset_timeout_s):
                if self._probe_inflight:
                    return False
                self._transition(BREAKER_HALF_OPEN)
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            self._transition(BREAKER_CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probe_inflight = False
            if self._state == BREAKER_HALF_OPEN \
                    or self._failures >= self.failure_threshold:
                self._opened_at = time.monotonic()
                self._transition(BREAKER_OPEN)

    def call(self, fn: Callable[[], _T]) -> _T:
        """Run *fn* through the breaker: :class:`CircuitOpenError`
        when open, outcome recorded otherwise.  BaseExceptions
        (KeyboardInterrupt) pass through without counting."""
        if not self.allow():
            raise CircuitOpenError(
                f"{self.op}: circuit open "
                f"({self._failures} consecutive failures)")
        try:
            result = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result


class Watchdog:
    """Fail a hung call instead of blocking its thread.

    ``call()`` runs *fn* on a fresh daemon worker thread and waits at
    most ``timeout_s``: on time, the result (or exception) is
    propagated; past it, :class:`WatchdogTimeout` is raised and the
    worker is ABANDONED — it finishes (or hangs) in the background and
    its eventual result is discarded.  That leak-a-thread trade is
    deliberate and bounded by the caller's call rate; it is the only
    containment Python offers for a call wedged inside a C extension
    (libtpu, a dead-NFS stat), and it is what keeps one wedged probe
    from freezing the whole pulse loop.
    """

    def __init__(self, op: str, timeout_s: float,
                 metrics: Optional[ResilienceMetrics] = None,
                 recorder: Optional["FlightRecorder"] = None,
                 logger: Optional[logging.Logger] = None) -> None:
        if timeout_s <= 0:
            raise ValueError("watchdog timeout must be > 0")
        self.op = op
        self.timeout_s = timeout_s
        self._metrics = metrics
        self._recorder = recorder
        self._log = logger or log

    def call(self, fn: Callable[[], _T]) -> _T:
        results: List[_T] = []
        errors: List[BaseException] = []
        done = threading.Event()

        def run() -> None:
            try:
                results.append(fn())
            # tpulint: disable=R2 -- not a swallow: the exception is re-raised to the waiter below
            except BaseException as e:
                errors.append(e)
            finally:
                done.set()

        t = threading.Thread(target=run,
                             name=f"watchdog-{self.op}", daemon=True)
        t.start()
        if not done.wait(self.timeout_s):
            self._log.warning(
                "watchdog: %s exceeded %.1fs; abandoning the call",
                self.op, self.timeout_s)
            if self._metrics is not None:
                self._metrics.watchdog_trips.labels(op=self.op).inc()
            if self._recorder is not None:
                self._recorder.record("tpu_watchdog_trip", op=self.op,
                                      timeout_s=self.timeout_s)
            raise WatchdogTimeout(
                f"{self.op} exceeded {self.timeout_s:.1f}s watchdog")
        if errors:
            raise errors[0]
        return results[0]
