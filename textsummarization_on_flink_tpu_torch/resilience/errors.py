"""Typed failures of the port's stream sources.

The part of the JAX package's resilience/errors.py that the pipeline
raises: ``StreamIdleError``, a long-lived stream source that saw no data
for its idle window (pipeline/io.py's socket source never leaves a read
unbounded).  It subclasses ``TimeoutError`` so generic timeout handlers
keep working.  The retry policy, circuit breaker and the rest of the
taxonomy are ROADMAP.md queue 1, items 2d and 3 (fault injection is
resilience/faultinject.py).
"""


class ResilienceError(Exception):
    """Base class of the typed stream failures."""


class StreamIdleError(ResilienceError, TimeoutError):
    """A stream source idled past its idle window (dead peer suspected)."""
