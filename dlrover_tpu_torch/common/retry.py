"""The one retry/deadline policy for the whole control plane.

Before this module, retry logic was re-invented per call site
(``master_client``'s ``2**attempt`` decorator, ``cloud_launcher``'s linear
backoff loop, ``multi_process``'s fixed 0.1s socket retry) — none with
jitter, none with an overall deadline, each with its own idea of what is
retryable.  :class:`RetryPolicy` centralizes all of it:

* exponential backoff capped at ``max_delay_s``, with **full jitter**
  (delay drawn uniformly from ``[0, backoff]``) so a fleet of restarting
  agents does not synchronize its retries into thundering herds;
* an overall ``deadline_s`` — attempts stop when the budget is spent even
  if ``max_attempts`` remain, and the last backoff is clipped to the
  budget rather than sleeping past it;
* retryable-vs-fatal classification by exception type (a rejected request
  is a bug; a dropped connection is weather);
* an ``on_retry`` hook plus a ``retry`` telemetry event per backoff, so
  the job timeline shows where time went;
* injectable ``sleep``/``abort`` for abortable waits (the cloud launcher
  passes its stop-event's ``wait``), and an injectable ``rng`` so tests
  pin the jitter.

Injected faults (:class:`~dlrover_tpu_torch.common.faults.FaultInjected`) are
always retryable unless explicitly listed fatal — fault plans exist to
exercise exactly these recovery paths.

tracelint rule RTY001 flags hand-rolled retry loops outside this module.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.faults import FaultInjected


class RetryError(RuntimeError):
    """All attempts exhausted (or the deadline spent)."""

    def __init__(self, name: str, attempts: int, last_error: BaseException):
        super().__init__(
            f"{name or 'call'} failed after {attempts} attempt(s): "
            f"{type(last_error).__name__}: {last_error}"
        )
        self.attempts = attempts
        self.last_error = last_error


class RetryAborted(RetryError):
    """The caller's ``abort`` check asked the retry loop to stand down
    (node retired, process stopping) — not an error in the attempted
    operation itself."""

    def __init__(self, name: str, attempts: int,
                 last_error: Optional[BaseException] = None):
        RuntimeError.__init__(
            self, f"{name or 'call'} aborted after {attempts} attempt(s)"
        )
        self.attempts = attempts
        self.last_error = last_error


class RetryPolicy:
    """Call a function with bounded, jittered, deadline-aware retries."""

    def __init__(
        self,
        max_attempts: int = 5,
        base_delay_s: float = 0.5,
        max_delay_s: float = 10.0,
        deadline_s: Optional[float] = None,
        retryable: Tuple[Type[BaseException], ...] = (Exception,),
        fatal: Tuple[Type[BaseException], ...] = (),
        jitter: bool = True,
        on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
        sleep: Callable[[float], object] = time.sleep,
        abort: Optional[Callable[[], bool]] = None,
        rng: Optional[random.Random] = None,
        name: str = "",
        quiet: bool = False,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.deadline_s = deadline_s
        self.retryable = retryable
        self.fatal = fatal
        self.jitter = jitter
        self.on_retry = on_retry
        self._sleep = sleep
        self._abort = abort
        self._rng = rng or random
        self.name = name
        # quiet: expected-churn retries (e.g. IPC during server startup)
        # still book telemetry but skip the per-attempt warning log.
        self.quiet = quiet

    def backoff_s(self, attempt: int) -> float:
        """The (pre-jitter) backoff after the ``attempt``-th failure
        (1-based): ``min(max_delay, base * 2**(attempt-1))``."""
        return min(self.max_delay_s, self.base_delay_s * (2 ** (attempt - 1)))

    def _classify_retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, self.fatal):
            return False
        if isinstance(exc, FaultInjected):
            return True
        return isinstance(exc, self.retryable)

    def call(self, fn: Callable, *args, **kwargs):
        deadline = (
            time.monotonic() + self.deadline_s
            if self.deadline_s is not None else None
        )
        attempt = 0
        while True:
            attempt += 1
            if self._abort is not None and self._abort():
                raise RetryAborted(self.name, attempt - 1)
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — classified below
                if not self._classify_retryable(e):
                    raise
                remaining = (
                    deadline - time.monotonic() if deadline is not None
                    else None
                )
                out_of_budget = remaining is not None and remaining <= 0
                if attempt >= self.max_attempts or out_of_budget:
                    raise RetryError(self.name, attempt, e) from e
                delay = self.backoff_s(attempt)
                if self.jitter:
                    delay = self._rng.uniform(0.0, delay)
                if remaining is not None:
                    delay = min(delay, remaining)
                telemetry.event(
                    "retry",
                    policy=self.name or getattr(fn, "__name__", "?"),
                    attempt=attempt, delay_s=round(delay, 4),
                    error=type(e).__name__,
                )
                if not self.quiet:
                    logger.warning(
                        "%s attempt %d/%d failed (%s: %s); retrying in %.2fs",
                        self.name or getattr(fn, "__name__", "call"),
                        attempt, self.max_attempts, type(e).__name__, e, delay,
                    )
                if self.on_retry is not None:
                    self.on_retry(attempt, e, delay)
                # An injectable sleep returning truthy means "stop waiting"
                # (threading.Event.wait semantics) — treat as an abort.
                if self._sleep(delay):
                    raise RetryAborted(self.name, attempt, e) from e

    def wrap(self, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


class CircuitOpenError(RuntimeError):
    """The breaker is open: recent calls failed consistently enough that
    further attempts are presumed wasted until the reset window passes."""


class CircuitBreaker:
    """Classic closed → open → half-open breaker for a flaky dependency.

    ``allow()`` gates attempts; ``record_success``/``record_failure`` feed
    outcomes back.  Open trips after ``failure_threshold`` consecutive
    failures; after ``reset_after_s`` one half-open probe is let through —
    success closes the breaker, failure re-opens it for another window.
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_after_s: float = 30.0, name: str = "",
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_after_s = reset_after_s
        self.name = name
        self._clock = clock
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.reset_after_s:
            return "half-open"
        return "open"

    def allow(self) -> bool:
        state = self.state
        if state == "closed":
            return True
        if state == "half-open" and not self._probing:
            self._probing = True
            return True
        return False

    def record_success(self):
        self._failures = 0
        self._opened_at = None
        self._probing = False

    def record_failure(self):
        self._probing = False
        self._failures += 1
        if self._failures >= self.failure_threshold:
            if self._opened_at is None:
                logger.warning(
                    "circuit %s opened after %d consecutive failures",
                    self.name or "?", self._failures,
                )
                telemetry.event("circuit_open", circuit=self.name,
                                failures=self._failures)
            self._opened_at = self._clock()

    def call(self, fn: Callable, *args, **kwargs):
        if not self.allow():
            raise CircuitOpenError(
                f"circuit {self.name or '?'} is open "
                f"({self._failures} consecutive failures)"
            )
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result
