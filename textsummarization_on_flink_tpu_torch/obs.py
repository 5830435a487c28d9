"""A minimal metrics registry: counters, gauges and duration spans.

The part of the JAX package's obs/ that the pipeline layer and the
trainer report through: monotonic counters (``pipeline/rows_in_total``,
``rows_out_total``, ``codec_errors_total``, ``feeder_errors_total``,
``source_rows_total``, ``sink_rows_total``, ``train_jobs_total``,
``inference_jobs_total``; the trainer's ``train/nan_watchdog_total``,
``resilience/train/nan_skips_total``, ``resilience/train/rollbacks_total``,
``train/prefetch_batches_total``, ``train/prefetch_errors_total``; the
fault points' ``resilience/fault/<point>`` and
``resilience/faults_fired_total``; ``resilience/ckpt_fallbacks_total``),
gauges (``resilience/train/lr_scale``, ``train/prefetch_queue_depth``)
and spans that record how long a stage took (``pipeline/fit``,
``pipeline/transform``, ``pipeline/train_job``,
``pipeline/inference_job``, ``train/metrics_flush``,
``train/profiler_capture``), and the threaded batcher's
(data/batcher.py) ``resilience/etl_worker_restarts_total``,
``data/examples_total``, ``data/empty_articles_total``,
``data/batches_total``, ``data/oov_words_total``,
``data/enc_tokens_total`` and gauge ``data/batch_queue_depth``.  The
full registry (histograms, labels, exporters) and the flight recorder
are ROADMAP.md queue 1, item 2d.

``registry()`` is the process default; ``use_registry(reg)`` routes the
module functions through another one for a block (tests).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional


class Counter:
    """Monotonic float counter."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-written float value."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Registry:
    """Named counters and gauges, and the durations of finished spans."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._spans: Dict[str, List[float]] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def record_span(self, name: str, seconds: float) -> None:
        with self._lock:
            self._spans.setdefault(name, []).append(seconds)

    def span_seconds(self, name: str) -> List[float]:
        """The durations of every finished span of ``name``, in order."""
        with self._lock:
            return list(self._spans.get(name, ()))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"counters": {k: c.value
                                 for k, c in self._counters.items()},
                    "gauges": {k: g.value for k, g in self._gauges.items()},
                    "spans": {k: list(v) for k, v in self._spans.items()}}


_default: Optional[Registry] = None
_default_lock = threading.Lock()


def registry() -> Registry:
    """The process-wide default registry (created on first use)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Registry()
        return _default


@contextlib.contextmanager
def use_registry(reg: Registry) -> Iterator[Registry]:
    """Route the module functions through ``reg`` inside the block."""
    global _default
    prev = registry()
    with _default_lock:
        _default = reg
    try:
        yield reg
    finally:
        with _default_lock:
            _default = prev


def registry_for(hps: Any) -> Registry:
    """The registry a job reports through: the process default.  (The
    JAX package's ``obs=False`` hyperparameter, which runs a job dark,
    comes with the full registry.)"""
    return registry()


def counter(name: str) -> Counter:
    return registry().counter(name)


@contextlib.contextmanager
def span(reg: Registry, name: str) -> Iterator[None]:
    """Record the block's wall-clock duration as a span of ``name``, also
    when it raises."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        reg.record_span(name, time.monotonic() - t0)
