"""Lightweight span tracing: ``with obs.span("decode/beam_step"): ...``.

Spans nest (a thread-local stack tracks depth/parent), record both
wall-clock start (epoch, for cross-process alignment) and monotonic
duration (perf_counter, for arithmetic), and land in a bounded
per-registry ring buffer — a long-running server never grows without
bound; overflow is counted in ``obs/spans_dropped_total``.

Request-scoped distributed tracing: the thread-local
stack alone can never link the serve path's submit thread, dispatch
thread, and slot engine — so spans also carry explicit trace ids.  A
``TraceContext`` (trace_id / span_id / parent_id) is minted where a
request (or a train run) is born and handed across threads; any span
opened with ``parent=ctx`` joins that trace, and nested spans inherit
the enclosing span's trace through the stack.  Per-request lifecycle
events (``request_event``: enqueue, admit, slot, finish, evict,
resolve) stream through the registry's EventSink carrying the same ids,
so one uuid's full timeline is reconstructable from ``events.jsonl``
(scripts/trace_summary.py --request).

Two export shapes:
  * Chrome-trace events (`chrome_trace_events`) — 'ph': 'X' complete
    events in the exact dialect scripts/trace_summary.py summarizes
    (same tool as the jax.profiler captures);
  * unified JSONL records (`{"kind": "span", ...}`) pushed to the
    registry's EventSink when one is installed (obs/export.py), sharing
    the `<log_root>/<exp>/<job>/events.jsonl` file with SummaryWriter
    scalars.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

from textsummarization_on_flink_tpu_torch.obs.registry import Registry

DEFAULT_MAX_SPANS = 10_000

# process-unique span-id mint: pid disambiguates across processes
# sharing one events.jsonl, the counter across threads (next() on an
# itertools.count is GIL-atomic — no lock on this hot-ish path)
_ids = itertools.count(1)


def _next_id() -> str:
    return f"{os.getpid():x}-{next(_ids):x}"


class TraceContext:
    """One node of a request-scoped trace: ids only, no timing.

    Minted at a request's birth (``ServingServer.submit``) or a train
    run's start and CARRIED across threads on the request object —
    unlike the thread-local span stack, a TraceContext links spans and
    lifecycle events no matter which thread touches the request next.
    """

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def new(cls, trace_id: Optional[str] = None) -> "TraceContext":
        """A fresh root context (random 64-bit trace id unless given)."""
        return cls(trace_id if trace_id is not None
                   else os.urandom(8).hex(), _next_id())

    def child(self) -> "TraceContext":
        """A child node in the same trace (parent = this node)."""
        return TraceContext(self.trace_id, _next_id(), self.span_id)

    def as_dict(self) -> Dict[str, str]:
        d = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            d["parent_id"] = self.parent_id
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, parent_id={self.parent_id!r})")


class SpanRecord:
    __slots__ = ("name", "wall_start", "duration", "depth", "parent",
                 "thread_id", "thread_name", "attrs", "trace_id",
                 "span_id", "parent_id")

    def __init__(self, name: str, wall_start: float, duration: float,
                 depth: int, parent: Optional[str], thread_id: int,
                 thread_name: str, attrs: Optional[Dict[str, Any]],
                 trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 parent_id: Optional[str] = None):
        self.name = name
        self.wall_start = wall_start  # epoch seconds
        self.duration = duration  # monotonic seconds
        self.depth = depth
        self.parent = parent
        self.thread_id = thread_id
        self.thread_name = thread_name
        self.attrs = attrs
        self.trace_id = trace_id  # request-scoped linkage (None = untraced)
        self.span_id = span_id
        self.parent_id = parent_id

    def as_event(self) -> Dict[str, Any]:
        """The unified events.jsonl record shape."""
        rec: Dict[str, Any] = {
            "kind": "span",
            "name": self.name,
            "ts_us": int(self.wall_start * 1e6),
            "dur_us": int(self.duration * 1e6),
            "depth": self.depth,
            "pid": os.getpid(),
            "tid": self.thread_id,
        }
        if self.span_id:
            rec["span_id"] = self.span_id
        if self.trace_id:
            rec["trace_id"] = self.trace_id
        if self.parent_id:
            rec["parent_id"] = self.parent_id
        if self.parent:
            rec["parent"] = self.parent
        if self.attrs:
            rec["attrs"] = self.attrs
        return rec

    def as_chrome_event(self) -> Dict[str, Any]:
        """A Chrome-trace complete event ('ph': 'X', microsecond units)."""
        ev: Dict[str, Any] = {
            "ph": "X",
            "name": self.name,
            "ts": self.wall_start * 1e6,
            "dur": self.duration * 1e6,
            "pid": os.getpid(),
            "tid": self.thread_id,
        }
        args = dict(self.attrs or {})
        if self.parent:
            args["parent"] = self.parent
        if self.trace_id:
            args["trace_id"] = self.trace_id
            args["span_id"] = self.span_id
            if self.parent_id:
                args["parent_id"] = self.parent_id
        if args:
            ev["args"] = args
        return ev


class _SpanContext:
    """The live context-manager handed out by Tracer.span().

    Exposes ``ctx`` (its TraceContext) once entered, so a caller can
    hand the span's identity to work it fans out to other threads.
    """

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_wall0", "_parent",
                 "ctx")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]],
                 parent: Optional[TraceContext] = None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._parent = parent
        self.ctx: Optional[TraceContext] = None
        self._t0 = 0.0
        self._wall0 = 0.0

    def __enter__(self) -> "_SpanContext":
        stack = self._tracer._stack()
        # trace linkage: an EXPLICIT parent (a TraceContext carried
        # across threads) wins; otherwise inherit the enclosing span's
        # trace through the thread-local stack; otherwise untraced.
        if self._parent is not None:
            self.ctx = self._parent.child()
        elif stack and stack[-1][2] is not None:
            _, pspan, ptrace = stack[-1]
            self.ctx = TraceContext(ptrace, _next_id(), pspan)
        stack.append((self.name,
                      self.ctx.span_id if self.ctx else None,
                      self.ctx.trace_id if self.ctx else None))
        # wall_start is SERIALIZED (the ts_us event timestamp, aligned
        # across processes) — the one legitimate time.time() use (TS003
        # exemption, ANALYSIS.md); durations NEVER derive from it: they
        # come from the monotonic perf_counter below.
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.perf_counter() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1][0] == self.name:
            stack.pop()
        parent = stack[-1][0] if stack else None
        t = threading.current_thread()
        ctx = self.ctx
        self._tracer._record(SpanRecord(
            self.name, self._wall0, dur, depth=len(stack), parent=parent,
            thread_id=t.ident or 0, thread_name=t.name, attrs=self.attrs,
            trace_id=ctx.trace_id if ctx else None,
            span_id=ctx.span_id if ctx else None,
            parent_id=ctx.parent_id if ctx else None))


class _NullSpan:
    """Disabled-mode span: enter/exit do nothing.  Shared singleton —
    the hot-path cost of a disabled span is two empty method calls."""

    __slots__ = ()

    ctx = None  # matches _SpanContext's post-enter surface

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Per-registry span collector (bounded ring buffer)."""

    def __init__(self, registry: Registry, max_spans: int = DEFAULT_MAX_SPANS):
        self._registry = registry
        self._spans: "collections.deque[SpanRecord]" = collections.deque(
            maxlen=max_spans)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._dropped = registry.counter("obs/spans_dropped_total")

    def _stack(self) -> List[tuple]:
        """Per-thread stack of (name, span_id, trace_id) for the spans
        currently open on this thread."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = []
            self._local.stack = s
        return s

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped.inc()
            self._spans.append(rec)
        sink = self._registry.event_sink
        if sink is not None:
            sink.emit(rec.as_event())

    def span(self, name: str, parent: Optional[TraceContext] = None,
             **attrs: Any) -> _SpanContext:
        return _SpanContext(self, name, attrs or None, parent=parent)

    def finished(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def chrome_trace_events(self) -> List[Dict[str, Any]]:
        """All buffered spans as Chrome-trace events plus process/thread
        metadata rows — directly loadable by scripts/trace_summary.py."""
        spans = self.finished()
        events: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": os.getpid(),
            "args": {"name": "obs"},
        }]
        seen_tids = {}
        for s in spans:
            if s.thread_id not in seen_tids:
                seen_tids[s.thread_id] = s.thread_name
        for tid, tname in seen_tids.items():
            events.append({"ph": "M", "name": "thread_name",
                           "pid": os.getpid(), "tid": tid,
                           "args": {"name": tname}})
        events.extend(s.as_chrome_event() for s in spans)
        return events


_tracer_init_lock = threading.Lock()


def tracer_for(registry: Registry) -> Tracer:
    """The registry's tracer, created on first use (double-checked under
    a module lock so concurrent first spans share one buffer)."""
    t = registry.tracer
    if t is None:
        with _tracer_init_lock:
            t = registry.tracer
            if t is None:
                t = Tracer(registry)
                registry.tracer = t
    return t


def span(registry: Registry, name: str,
         parent: Optional[TraceContext] = None, **attrs: Any):
    """Context manager recording one span into `registry` (the module
    facade obs.span() routes here with the default registry).  An
    explicit ``parent=`` TraceContext links the span into a
    request-scoped trace regardless of which thread opens it."""
    if not registry.enabled:
        return NULL_SPAN
    return tracer_for(registry).span(name, parent=parent, **attrs)


def request_event(registry: Registry, event: str,
                  ctx: Optional[TraceContext], uuid: str,
                  **attrs: Any) -> bool:
    """Emit one per-request lifecycle record to the registry's EventSink.

    Record shape (the ``{"kind": "request"}`` events.jsonl family,
    OBSERVABILITY.md "Request-scoped tracing"):

        {"kind": "request", "event": "enqueue" | "admit" | "slot" |
         "finish" | "evict" | "resolve" | "shed" | "route" | "hedge" |
         "requeued", "uuid": ...,
         "ts_us": ..., "trace_id": ..., "span_id": ..., "pid": ...,
         "attrs": {...}}

    All events of one request carry its TraceContext's ids, so the
    timeline reconstructs by uuid OR trace_id.  No-op (False) when the
    registry is disabled or has no sink — lifecycle events exist only
    in the unified events.jsonl, never in memory."""
    if not registry.enabled:
        return False
    sink = registry.event_sink
    if sink is None:
        return False
    rec: Dict[str, Any] = {
        "kind": "request",
        "event": event,
        "uuid": uuid,
        # serialized epoch timestamp, same dialect as span ts_us (the
        # sanctioned time.time() use — see _SpanContext.__enter__)
        "ts_us": int(time.time() * 1e6),
        "pid": os.getpid(),
    }
    # fleet identity: a replica-tagged registry stamps its
    # id on every lifecycle event, so one events.jsonl shared by N
    # replicas reads as a self-describing cross-replica timeline
    rid = getattr(registry, "replica_id", "")
    if rid:
        rec["replica"] = rid
    if ctx is not None:
        rec.update(ctx.as_dict())
    if attrs:
        rec["attrs"] = attrs
    return sink.emit(rec)
