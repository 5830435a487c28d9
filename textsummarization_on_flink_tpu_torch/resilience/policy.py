"""Retry, deadline, and circuit-breaker primitives.

The reference system's only failure policy is the decoder's infinite
10-second checkpoint retry (util.py:29-41); everything else either hangs
(pipeline/io.py's ``settimeout(None)`` stream read) or dies (the
trainer's hard NaN abort).  These three primitives replace that with
bounded, observable behavior:

  * ``RetryPolicy`` — exponential backoff with decorrelated jitter
    (the AWS-architecture-blog formula: ``sleep = min(cap,
    uniform(base, prev * 3))``), seeded for deterministic tests,
    deadline-aware, obs-instrumented.
  * ``Deadline`` — a monotonic-clock budget that request paths thread
    through blocking calls (``remaining()`` feeds socket timeouts,
    ``check()`` raises the typed error).
  * ``CircuitBreaker`` — classic closed/open/half-open: `threshold`
    consecutive failures open the circuit, calls are shed for
    ``reset_secs``, then one half-open probe decides re-close vs re-open.

All three report through ``resilience/*`` obs metrics and cost nothing
when obs is disabled (the null-registry fast path).  Import-light by
design: no jax/numpy, safe for the data/pipeline layers.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Iterator, Optional, Tuple, Type

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs import locksan
from textsummarization_on_flink_tpu_torch.resilience.errors import (
    CircuitOpenError,
    DeadlineExceededError,
    RetriesExhaustedError,
)


class Deadline:
    """A wall-clock budget carried through an operation.

    Built on ``time.monotonic`` (never wall-clock, which can jump).
    ``Deadline.never()`` is the no-op deadline for unbounded callers.
    """

    __slots__ = ("_expires",)

    def __init__(self, expires_at: Optional[float]):
        self._expires = expires_at  # monotonic timestamp; None = never

    @classmethod
    def after(cls, secs: Optional[float]) -> "Deadline":
        """Deadline `secs` from now; None or <= 0 means no deadline."""
        if secs is None or secs <= 0:
            return cls(None)
        return cls(time.monotonic() + secs)

    @classmethod
    def never(cls) -> "Deadline":
        return cls(None)

    @property
    def bounded(self) -> bool:
        return self._expires is not None

    def remaining(self) -> float:
        """Seconds left (clamped at 0); +inf when unbounded."""
        if self._expires is None:
            return float("inf")
        return max(0.0, self._expires - time.monotonic())

    def expired(self) -> bool:
        return self._expires is not None and time.monotonic() >= self._expires

    def check(self, what: str = "operation") -> None:
        """Raise DeadlineExceededError if expired."""
        if self.expired():
            raise DeadlineExceededError(f"deadline exceeded during {what}")

    def timeout_for(self, default: Optional[float] = None) -> Optional[float]:
        """A value suitable for a blocking call's ``timeout=``: the lesser
        of the remaining budget and `default` (None = just the budget)."""
        if self._expires is None:
            return default
        rem = self.remaining()
        return rem if default is None else min(rem, default)


class RetryPolicy:
    """Bounded retries with exponential backoff + decorrelated jitter.

    Usage — generator style (the caller owns the try/except):

        policy = RetryPolicy(max_attempts=5, base_delay=0.05)
        for attempt in policy.attempts():   # sleeps BETWEEN attempts
            try:
                return connect()
            except OSError as e:
                policy.note_failure(e)      # raises when exhausted

    or callable style::

        policy.call(connect, retry_on=(OSError,))

    ``seed`` pins the jitter RNG (chaos tests assert exact backoff
    sequences); ``sleep`` is injectable for zero-wall-clock tests.
    ``name`` scopes the obs counters: ``resilience/<name>/retries_total``
    and ``.../retry_exhausted_total`` (plus the subsystem-wide
    ``resilience/retries_total``).
    """

    def __init__(self, max_attempts: int = 5, base_delay: float = 0.05,
                 max_delay: float = 30.0, seed: Optional[int] = None,
                 name: str = "", sleep: Callable[[float], None] = time.sleep,
                 deadline: Optional[Deadline] = None,
                 registry: Optional[obs.Registry] = None):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if base_delay <= 0 or max_delay < base_delay:
            raise ValueError("need 0 < base_delay <= max_delay")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.name = name
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._deadline = deadline if deadline is not None else Deadline.never()
        self._last_error: Optional[BaseException] = None
        self._failures = 0
        self._prev_delay = base_delay
        reg = registry if registry is not None else obs.registry()
        scope = f"resilience/{name}" if name else "resilience"
        self._c_retries = reg.counter(f"{scope}/retries_total")
        self._c_exhausted = reg.counter(f"{scope}/retry_exhausted_total")
        self._c_all = reg.counter("resilience/retries_total")

    def next_delay(self) -> float:
        """Decorrelated jitter: ``min(cap, uniform(base, prev * 3))``."""
        d = min(self.max_delay,
                self._rng.uniform(self.base_delay, self._prev_delay * 3))
        self._prev_delay = d
        return d

    def note_failure(self, err: BaseException) -> None:
        """Record a failed attempt.  Raises RetriesExhaustedError (cause
        chained) when the budget is spent — callers in generator style
        call this from their except block."""
        self._failures += 1  # tslint: disable=TS009 — a RetryPolicy instance is confined to ONE attempt loop; the reader-thread root is a different instance
        self._last_error = err  # tslint: disable=TS009 — same confinement: per-call-site instance, never shared across the roots the analyzer unions
        if self._failures >= self.max_attempts:
            self._c_exhausted.inc()
            raise RetriesExhaustedError(
                f"{self.name or 'operation'} failed after "
                f"{self._failures} attempts") from err

    def attempts(self) -> Iterator[int]:
        """Yield attempt indices 0..max_attempts-1, sleeping the backoff
        delay before every retry (never before the first attempt).
        Honors the deadline: expiry between attempts raises
        DeadlineExceededError with the last failure chained."""
        for attempt in range(self.max_attempts):
            if attempt > 0:
                # timeout_for never returns None here (default given) and
                # an expired deadline yields 0.0 — sleep nothing, then the
                # post-sleep check below raises immediately
                delay = min(self.next_delay(),
                            self._deadline.timeout_for(self.max_delay))
                self._c_retries.inc()
                self._c_all.inc()
                self._sleep(delay)
                if self._deadline.expired():
                    raise DeadlineExceededError(
                        f"deadline exceeded retrying "
                        f"{self.name or 'operation'}") from self._last_error
            yield attempt

    def call(self, fn: Callable[..., Any], *args: Any,
             retry_on: Tuple[Type[BaseException], ...] = (Exception,),
             **kwargs: Any) -> Any:
        """Run `fn`, retrying on `retry_on` with backoff; re-raises
        RetriesExhaustedError (last cause chained) when spent."""
        for _attempt in self.attempts():
            try:
                return fn(*args, **kwargs)
            except retry_on as e:  # noqa: PERF203 — retry loop by design
                self.note_failure(e)
        raise AssertionError("unreachable")  # pragma: no cover


class CircuitBreaker:
    """Closed / open / half-open circuit breaker.

    * CLOSED: calls flow; `threshold` CONSECUTIVE failures trip it open.
    * OPEN: ``allow()`` is False (callers shed) until ``reset_secs``
      elapse, then the breaker moves to HALF_OPEN.
    * HALF_OPEN: EXACTLY ONE in-flight probe is allowed (the
      ``_probe_out`` token, taken and released under the breaker lock);
      concurrent half-open callers lose the race and are SHED — they
      see the breaker as effectively open, they do not all probe at
      once.  Probe success re-closes, failure re-opens (and restarts
      the reset clock).  The probe token carries a LEASE: a probe whose
      caller vanished without ever recording an outcome (crashed
      thread, dropped future) expires after another ``reset_secs``, so
      a lost probe degrades into one more probe-sized delay instead of
      wedging the breaker half-open (shedding everything) forever.

    Thread-safe; ``clock`` is injectable for deterministic tests.  The
    obs gauge ``resilience/<name>/breaker_state`` exports 0=closed,
    1=half-open, 2=open; trips/sheds are counted.
    """

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
    _STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, threshold: int = 5, reset_secs: float = 30.0,
                 name: str = "breaker",
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[obs.Registry] = None):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.reset_secs = reset_secs
        self.name = name
        self._clock = clock
        self._lock = locksan.make_lock("CircuitBreaker._lock")
        self._state = self.CLOSED
        self._failures = 0  # consecutive, in CLOSED
        self._opened_at = 0.0
        self._probe_out = False  # a HALF_OPEN probe is in flight
        self._probe_at = 0.0  # when the in-flight probe was granted
        reg = registry if registry is not None else obs.registry()
        self._registry = reg
        self._g_state = reg.gauge(f"resilience/{name}/breaker_state")
        self._c_trips = reg.counter(f"resilience/{name}/breaker_trips_total")
        self._c_shed = reg.counter(f"resilience/{name}/breaker_shed_total")
        self._g_state.set(0)

    def _set_state(self, state: str) -> None:
        self._state = state
        self._g_state.set(self._STATE_CODE[state])

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_secs):
            self._set_state(self.HALF_OPEN)
            self._probe_out = False

    def allow(self) -> bool:
        """True if a call may proceed now.  In HALF_OPEN exactly one
        in-flight probe is allowed; concurrent callers are shed (they
        must see the breaker as open, not all probe at once).  A probe
        whose caller never reported an outcome expires after
        ``reset_secs`` and its slot re-grants."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN:
                if (self._probe_out
                        and self._clock() - self._probe_at >= self.reset_secs):
                    # the lease expired: the probe's caller died without
                    # recording success/failure — presume it lost and
                    # hand the (single) probe slot to this caller
                    self._probe_out = False
                if not self._probe_out:
                    self._probe_out = True
                    self._probe_at = self._clock()
                    return True
            self._c_shed.inc()
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_out = False
            if self._state != self.CLOSED:
                self._set_state(self.CLOSED)

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            if self._state == self.HALF_OPEN:
                # the probe failed: back to OPEN, clock restarts
                self._set_state(self.OPEN)
                self._opened_at = self._clock()
                self._probe_out = False
                self._c_trips.inc()
                tripped = True
            else:
                self._failures += 1
                if (self._state == self.CLOSED
                        and self._failures >= self.threshold):
                    self._set_state(self.OPEN)
                    self._opened_at = self._clock()
                    self._c_trips.inc()
                    tripped = True
        if tripped:
            # flight-recorder trigger OUTSIDE the breaker lock (the dump
            # is file IO): an opening breaker is exactly the moment the
            # preceding steps/ticks stop being reconstructable later
            flightrec.trigger(self._registry, f"breaker_{self.name}_open")

    def __enter__(self) -> "CircuitBreaker":
        if not self.allow():
            raise CircuitOpenError(f"circuit {self.name!r} is open")
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.record_success()
        else:
            self.record_failure()
