"""Typed failures of the port's stream sources and workers.

The part of the JAX package's resilience/errors.py that the port
raises: ``StreamIdleError``, a long-lived stream source that saw no data
for its idle window (pipeline/io.py's socket source never leaves a read
unbounded; it subclasses ``TimeoutError`` so generic timeout handlers
keep working), and ``WorkerCrashError``, the batcher's producer threads
out of their shared restart budget (data/batcher.py).  The retry policy,
circuit breaker and the rest of the taxonomy are ROADMAP.md queue 1,
items 2d and 3b (fault injection is resilience/faultinject.py).
"""


class ResilienceError(Exception):
    """Base class of the typed stream failures."""


class StreamIdleError(ResilienceError, TimeoutError):
    """A stream source idled past its idle window (dead peer suspected)."""


class WorkerCrashError(ResilienceError, RuntimeError):
    """A worker-thread pool exhausted its crash-restart budget.  A
    RuntimeError too, as the JAX package's batcher raised before its
    typed errors, so "producer thread failed" handlers keep working."""
