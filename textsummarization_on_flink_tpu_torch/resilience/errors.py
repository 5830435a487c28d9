"""Typed failure vocabulary for the resilience subsystem.

Every recovery path in the stack surfaces one of these instead of a bare
RuntimeError/OSError, so callers can route on failure *class*:

  * ``StreamIdleError`` — a long-lived stream source saw no data for the
    idle window (the pipeline/io.py dead-peer hang, fixed by never
    leaving a socket with ``settimeout(None)``).  Subclasses
    ``TimeoutError`` so generic timeout handlers keep working.
  * ``DeadlineExceededError`` — a ``Deadline`` expired mid-operation.
    Also a ``TimeoutError`` subclass.
  * ``CircuitOpenError`` — a ``CircuitBreaker`` refused the call (the
    protected dependency is shedding load).
  * ``RetriesExhaustedError`` — a ``RetryPolicy`` ran out of attempts;
    the last cause is chained.
  * ``CheckpointCorruptError`` — a checkpoint failed its checksum
    manifest verification (checkpoint/checkpointer.py falls back to the
    next-older checkpoint before surfacing this).
  * ``WorkerCrashError`` — a worker-thread pool (batcher producers)
    exhausted its restart budget; the first underlying error is chained.
    Subclasses ``RuntimeError`` so the pre-existing "producer thread
    failed" handlers keep working.
  * ``ArenaExhaustedError`` — the paged-resident-state page arena
    (decode/arena.PageArena) has fewer free pages than an
    admission needs.  BACKPRESSURE, not failure: the ContinuousBatcher
    requeues the admission until a harvest frees pages.  Defined here
    (not in decode/) so the jax-free serve scheduler can catch it
    without importing the jax-heavy decode package.

``NanLossError`` (divergence recovery gave up) lives in
train/trainer.py next to its ``NonFiniteLossError`` base — the trainer
owns the watchdog contract and this package must stay import-light.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for resilience-subsystem failures."""


class StreamIdleError(ResilienceError, TimeoutError):
    """A stream source idled past its idle window (dead peer suspected)."""


class DeadlineExceededError(ResilienceError, TimeoutError):
    """A Deadline expired before the operation completed."""


class CircuitOpenError(ResilienceError):
    """The circuit breaker is open; the call was shed, not attempted."""


class RetriesExhaustedError(ResilienceError):
    """A RetryPolicy ran out of attempts (last cause chained)."""


class CheckpointCorruptError(ResilienceError):
    """A checkpoint file failed checksum-manifest verification."""


class WorkerCrashError(ResilienceError):
    """A worker-thread pool exhausted its crash-restart budget."""


class ArenaExhaustedError(ResilienceError):
    """The page arena has fewer free pages than an admission needs
    (typed allocation-failure backpressure; carries the shortfall)."""

    def __init__(self, message: str, needed: int = 0, free: int = 0):
        super().__init__(message)
        self.needed = int(needed)
        self.free = int(free)
