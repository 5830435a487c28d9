"""Unified runtime observability layer.

A copy of the JAX package's obs/ (the port imports nothing of that
package): the registry with labels and histograms, spans and request
traces, the event and Chrome-trace exporters, the flight recorder, the
lock-order sanitizer, the profiler ledger, the SLO burn-rate engine and
the HTTP exposition plane.  The port's trainer, batcher, checkpointer,
decoder, pipeline and serve layer report through it.

One process-wide registry of counters/gauges/histograms, lightweight
nesting span tracing, and exporters (unified JSONL events, Chrome-trace
dump, Prometheus-style text exposition).  Every layer of the stack —
train loop, data pipeline, beam decoder, streaming pipeline, checkpoint
IO — reports through this module; see OBSERVABILITY.md for the metric
naming scheme (``<layer>/<name>``) and the full inventory.

Usage:

    from textsummarization_on_flink_tpu_torch import obs

    obs.counter("decode/tokens_total").inc(n)
    obs.gauge("train/prefetch_queue_depth").set(q.qsize())
    obs.histogram("decode/request_latency_seconds").observe(dt)
    with obs.span("decode/batch"):
        ...
    print(obs.render_text())          # Prometheus-style exposition
    obs.snapshot(compact=True)        # dict dump (BENCH row embedding)

Disabling: ``TS_OBS=0`` in the environment kills the default registry
for the whole process (instrumented code receives shared null metrics
— near-zero cost); per-job, ``HParams(obs=False)`` makes
``registry_for(hps)`` hand back the null registry so one component can
run dark while others report.  Dependency-light by design: importing
this package never imports jax/numpy.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Sequence

from textsummarization_on_flink_tpu_torch.obs.export import (
    EventSink,
    install_event_sink as _install_event_sink,
    snapshot_event,
    write_chrome_trace as _write_chrome_trace,
)
from textsummarization_on_flink_tpu_torch.obs.registry import (
    Counter,
    DEFAULT_TIME_BUCKETS,
    Gauge,
    Histogram,
    NULL_COUNTER,
    NULL_GAUGE,
    NULL_HISTOGRAM,
    NULL_REGISTRY,
    Registry,
    exponential_buckets,
)
from textsummarization_on_flink_tpu_torch.obs.spans import (
    NULL_SPAN,
    SpanRecord,
    TraceContext,
    Tracer,
    request_event as _request_event,
    span as _span,
    tracer_for,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Tracer", "SpanRecord",
    "TraceContext", "EventSink", "NULL_REGISTRY", "NULL_COUNTER",
    "NULL_GAUGE", "NULL_HISTOGRAM", "NULL_SPAN", "DEFAULT_TIME_BUCKETS",
    "exponential_buckets", "enabled_from_env", "registry", "registry_for",
    "set_default_registry", "use_registry", "counter", "gauge", "histogram",
    "span", "request_event", "render_text", "snapshot", "snapshot_event",
    "install_event_sink", "write_chrome_trace", "tracer_for", "heartbeat",
    "install_flight_recorder", "serve_http", "install_profiler",
    "profiler_for",
]

_default: Optional[Registry] = None
_default_lock = threading.Lock()


def enabled_from_env() -> bool:
    """TS_OBS gate: unset/1/on/true/yes -> enabled; 0/off/false/no -> off."""
    return os.environ.get("TS_OBS", "1").lower() not in (
        "0", "off", "false", "no")


def registry() -> Registry:
    """The process-wide default registry (created on first use; honors
    TS_OBS at creation time)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Registry(enabled=enabled_from_env())
    return _default


def set_default_registry(reg: Optional[Registry]) -> Registry:
    """Swap the process default (None re-resolves TS_OBS on next use).
    Returns the previous default (possibly None -> the new lazy one)."""
    global _default
    with _default_lock:
        prev, _default = _default, reg
    return prev if prev is not None else registry()


class use_registry:
    """Context manager: route the module facade through `reg` (tests)."""

    def __init__(self, reg: Registry):
        self._reg = reg
        self._prev: Optional[Registry] = None

    def __enter__(self) -> Registry:
        global _default
        with _default_lock:
            self._prev = _default
            _default = self._reg
        return self._reg

    def __exit__(self, exc_type, exc, tb) -> None:
        global _default
        with _default_lock:
            _default = self._prev


def registry_for(hps: Any) -> Registry:
    """The registry a component should report through: the process
    default, unless the job's HParams carries obs=False (or the default
    itself is disabled)."""
    if hps is not None and not getattr(hps, "obs", True):
        return NULL_REGISTRY
    return registry()


# -- module-level conveniences (route through the default registry) --

def counter(name: str) -> Counter:
    return registry().counter(name)


def gauge(name: str) -> Gauge:
    return registry().gauge(name)


def histogram(name: str, buckets: Optional[Sequence[float]] = None,
              ) -> Histogram:
    return registry().histogram(name, buckets)


def span(name: str, parent: Optional["TraceContext"] = None, **attrs: Any):
    return _span(registry(), name, parent=parent, **attrs)


def request_event(event: str, ctx: Optional["TraceContext"], uuid: str,
                  **attrs: Any) -> bool:
    return _request_event(registry(), event, ctx, uuid, **attrs)


def heartbeat(name: str, period: float = 10.0) -> None:
    """Record a component liveness beat on the default registry's
    heartbeat board (`/healthz` flips it degraded when stale — the live
    exposition plane, obs/http.py).  Lazy import keeps obs itself free
    of http.server until someone actually beats or serves."""
    from textsummarization_on_flink_tpu_torch.obs import http as http_mod

    http_mod.heartbeat(registry(), name, period=period)


def install_flight_recorder(directory: str, capacity: Optional[int] = None,
                            reg: Optional[Registry] = None):
    """Attach a failure flight recorder (obs/flightrec.py) to `reg` (the
    default registry when None); returns it, or None when disabled.
    ``capacity`` follows the HParams.flight_frames convention: None =
    the module default ring, 0 = disabled (returns None)."""
    if capacity == 0:
        return None
    from textsummarization_on_flink_tpu_torch.obs import flightrec as flight_mod

    kw = {"capacity": capacity} if capacity is not None else {}
    return flight_mod.install_flight_recorder(
        reg if reg is not None else registry(), directory, **kw)


def install_profiler(reg: Optional[Registry] = None, **kw: Any):
    """Attach the performance attribution plane (obs/profile.py) to
    `reg` (default registry when None): the phase ledger and the
    divergence sentinel, exposed on /profile.  First install wins;
    kwargs (clock, divergence_factor) thread to the Profiler."""
    from textsummarization_on_flink_tpu_torch.obs import profile as profile_mod

    return profile_mod.install_profiler(
        reg if reg is not None else registry(), **kw)


def profiler_for(reg: Optional[Registry] = None):
    """The registry's profiler (obs/profile.py), or the shared null
    profiler for a dark registry — safe to call on every dispatch."""
    from textsummarization_on_flink_tpu_torch.obs import profile as profile_mod

    return profile_mod.profiler_for(reg if reg is not None else registry())


def serve_http(port: int, reg: Optional[Registry] = None):
    """Start the live exposition plane (obs/http.py) on 127.0.0.1:port
    over `reg` (default registry when None); returns the server."""
    from textsummarization_on_flink_tpu_torch.obs import http as http_mod

    return http_mod.ObsHttpServer(
        reg if reg is not None else registry(), port=port).start()


def render_text(exemplars: Optional[bool] = None,
                openmetrics: bool = False) -> str:
    return registry().render_text(exemplars=exemplars, openmetrics=openmetrics)


def snapshot(compact: bool = False) -> Dict[str, Dict]:
    return registry().snapshot(compact=compact)


def install_event_sink(directory: str, flush_secs: float = 2.0,
                       max_queue: int = 4096,
                       reg: Optional[Registry] = None) -> Optional[EventSink]:
    return _install_event_sink(reg if reg is not None else registry(),
                               directory, flush_secs=flush_secs,
                               max_queue=max_queue)


def write_chrome_trace(path: str, reg: Optional[Registry] = None) -> int:
    return _write_chrome_trace(reg if reg is not None else registry(), path)
