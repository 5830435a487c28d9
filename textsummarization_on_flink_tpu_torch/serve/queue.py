"""Thread-safe request queue + admission control for concurrent serving.

The unit of work is a ``ServeRequest``: one summarization request
(uuid, article, reference) already tokenized into a ``SummaryExample``,
carrying the ``ServeFuture`` its caller blocks on and a ``Deadline``
measured from *enqueue* (not batch start — time spent queued counts
against the request's budget, RESILIENCE.md degradation contract).

Admission control (``RequestQueue``): the queue depth is BOUNDED
(``serve_max_queue``).  A non-blocking submit against a full queue is
rejected with the typed ``ServeOverloadError`` — never silently dropped,
never parked unbounded — and every rejection is a *failure* recorded
against an admission ``CircuitBreaker``: under sustained overload the
breaker opens and requests are shed immediately without touching the
queue (the ``BreakerSink`` load-shedding semantics from pipeline/io.py,
applied to the ingress side), then a half-open probe admission decides
recovery.  Blocking submits (the pipeline-driving path) exert
backpressure instead: they wait for space and bypass the breaker.

Multi-tenant fairness (SERVING.md "Front door"): each
``ServeRequest`` carries a ``tenant`` ("" = the default tenant), the
queue keeps one FIFO per tenant under the shared depth bound, and the
CONSUMER side (``get``/``get_nowait``) picks across the non-empty
tenants by smooth weighted round-robin (``serve_fair_weights``) — so
one tenant's deep backlog cannot starve another's pickup, while a
single-tenant queue degenerates to exactly the historical global FIFO
(same tenant => strict arrival order).  The admission-rate side (the
per-tenant token bucket) lives in serve/frontdoor.py.

Import-light: no jax; numpy only transitively via data.batching.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Optional

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.obs import locksan
from textsummarization_on_flink_tpu_torch.resilience.policy import (
    CircuitBreaker,
    Deadline,
)
from textsummarization_on_flink_tpu_torch.serve.errors import (
    ServeClosedError,
    ServeOverloadError,
)

log = logging.getLogger(__name__)

#: bound on the fair-pickup credit map: caller-supplied tenant names
#: must not grow it without end — once past the bound, credits of
#: tenants with NO queued work are pruned (their fairness debt is at
#: most one round's weight, so the reset is noise)
MAX_TENANT_CREDITS = 4096


def track_request(registry: "obs.Registry", clock: Callable[[], float],
                  fut: "ServeFuture", tenant: str, tier: str,
                  counter: Optional["obs.registry.Counter"] = None) -> None:
    """Ingress-side accounting for ONE admitted future: the
    labeled ``serve/requests_total{tenant,tier}`` child (rolls up into
    the unlabeled total), and — when an SLO engine is installed on
    `registry` — a done-callback classifying (tenant, tier, latency,
    error) into the burn-rate windows on the future's exactly-once
    resolution.  Latency runs on the CALLER's clock (virtual in the
    committed gate).  The one helper both ingresses share
    (``ServingServer.submit`` and ``FleetRouter.submit``), so router
    and replica classification can never silently diverge — and each
    request is tracked exactly once, at the ingress that owns it (a
    replica behind a router has its tracking disabled).

    `counter` takes the ingress's construction-time
    ``serve/requests_total`` parent (the cached-sibling idiom of every
    other hot-path counter here), skipping the per-submit registry-lock
    name lookup; None resolves it per call."""
    tenant = tenant or "default"
    c = counter if counter is not None \
        else registry.counter("serve/requests_total")
    c.labels(tenant=tenant, tier=tier).inc()
    eng = registry.slo
    if eng is not None:
        t0 = clock()
        fut.add_done_callback(lambda f: eng.record(
            tenant, tier, clock() - t0, error=f.error is not None))


def track_rejection(registry: "obs.Registry", tenant: str,
                    tier: str) -> None:
    """Ingress-side SLO accounting for ONE caller-visible REJECTED
    submit (tenant throttle, open admission breaker, full queue): a
    shed request is a bad event under every objective, or total
    admission failure — the exact outage the burn-rate engine pages on
    — would read as a healthy SLO because only admitted futures ever
    reach ``track_request``'s done-callback.  Cold path (rejections);
    no-op without an installed engine."""
    eng = registry.slo
    if eng is not None:
        eng.record(tenant or "default", tier, 0.0, error=True)


class ServeFuture:
    """A per-request completion handle that resolves EXACTLY ONCE.

    ``result(timeout)`` blocks for the ``DecodedResult`` (re-raising the
    failure that rejected the request); ``add_done_callback`` runs the
    callback on the resolving thread (or immediately when already done).
    A second ``_resolve``/``_reject`` is a programming error and raises
    — the exactly-once contract is load-bearing for the acceptance test
    and for sinks that must see one row per request.
    """

    __slots__ = ("uuid", "trace", "scope", "cache_hit", "_event",
                 "_result", "_error", "_lock", "_callbacks", "_registry")

    def __init__(self, uuid: str = "",
                 registry: Optional[obs.Registry] = None):
        self.uuid = uuid
        # resolve-event scope tag: "" for replica-level
        # futures; the FleetRouter stamps its caller-visible future
        # "fleet" so a hedged/requeued uuid's TERMINAL resolve is
        # distinguishable from its replica attempts' resolves in the
        # event stream (scripts/trace_summary.py --request keys the
        # total_ms phase on it)
        self.scope = ""
        # the request's TraceContext (set by ServeRequest): resolution
        # is the terminal lifecycle event of a trace, and it can happen
        # on any thread — the dispatcher, an evictor, drain_reject —
        # so the ids ride the future itself
        self.trace: Optional[obs.TraceContext] = None
        #: True when the front door answered it from the summary cache at
        #: submit (set before it resolves): a decode that merely finished
        #: fast is not a hit
        self.cache_hit = False
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._lock = locksan.make_lock("ServeFuture._lock")
        self._callbacks: List[Callable[["ServeFuture"], None]] = []
        self._registry = registry if registry is not None else obs.registry()

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        """The rejection cause once done (None while pending / on
        success) — lets callbacks route without a try/except."""
        return self._error

    def result(self, timeout: Optional[float] = None) -> Any:
        """The DecodedResult, blocking up to `timeout` seconds.  Raises
        the rejection error verbatim, or TimeoutError on expiry."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"serve request {self.uuid!r} not resolved in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def add_done_callback(self,
                          fn: Callable[["ServeFuture"], None]) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn: Callable[["ServeFuture"], None]) -> None:
        try:
            fn(self)
        except Exception:  # a sink callback must never kill the dispatcher
            self._registry.counter("serve/callback_errors_total").inc()
            log.exception("serve future callback failed (uuid=%s)", self.uuid)

    def _finish(self, result: Any, error: Optional[BaseException]) -> None:
        with self._lock:
            if self._event.is_set():
                raise AssertionError(
                    f"ServeFuture {self.uuid!r} resolved twice")
            self._result = result
            self._error = error
            # the trace's terminal event: EVERY resolution path
            # (success, dispatch failure, eviction, drain) funnels
            # through _finish, so the enqueue->resolve timeline closes
            # exactly once per request.  Emitted BEFORE the event sets:
            # a waiter unblocked by result() must find the resolve
            # record already in the stream (emit is a non-blocking
            # queue put — cheap under the lock).
            attrs: dict = ({"error": type(error).__name__}
                           if error is not None else {})
            if self.scope:
                attrs["scope"] = self.scope
            obs.spans.request_event(self._registry, "resolve", self.trace,
                                    self.uuid, **attrs)
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            self._run_callback(fn)

    def _resolve(self, result: Any) -> None:
        self._finish(result, None)

    def _reject(self, error: BaseException) -> None:
        self._finish(None, error)


class ServeRequest:
    """One admitted (or about-to-be-admitted) summarization request."""

    __slots__ = ("uuid", "article", "reference", "example", "future",
                 "deadline", "enqueue_t", "trace", "tier", "tenant")

    def __init__(self, uuid: str, article: str, reference: str,
                 example: Any, deadline: Optional[Deadline] = None,
                 registry: Optional[obs.Registry] = None,
                 tier: str = "", trace: Optional[obs.TraceContext] = None,
                 tenant: str = ""):
        self.uuid = uuid
        self.article = article
        self.reference = reference
        self.example = example  # data.batching.SummaryExample
        # the tenant whose fairness bucket this request rides ("" = the
        # default tenant — a job that never names tenants keeps ONE
        # bucket and therefore the historical global-FIFO pickup)
        self.tenant = tenant
        # requested quality tier (SERVING.md "Quality tiers"): one of
        # config.SERVE_TIERS, or "" = the server's default.  The
        # EFFECTIVE tier may be lower — per-request deadline-pressure
        # degradation happens at dispatch, not here.
        self.tier = tier
        self.future = ServeFuture(uuid, registry=registry)
        # request-scoped trace root: minted at the request's
        # birth on the SUBMIT thread and carried on the object, so the
        # dispatch thread and slot engine stamp the same trace_id —
        # the thread-local span stack could never link them.  A dark
        # job (obs=False / TS_OBS=0) skips the mint: every consumer
        # (request_event, span parent) discards the ids anyway, so the
        # submit hot path shouldn't pay the urandom read for them.
        # An EXPLICIT ``trace`` wins over the mint: the
        # FleetRouter mints ONE context per routed request and threads
        # it through every replica attempt (primary, hedge, requeue),
        # so a request's cross-replica lifecycle shares one trace_id.
        reg = registry if registry is not None else obs.registry()
        if trace is not None:
            self.trace = trace
        else:
            self.trace = obs.TraceContext.new() if reg.enabled else None
        self.future.trace = self.trace
        # the budget runs from ENQUEUE: queue wait spends it, so a
        # request that aged in a deep queue reaches the decoder with
        # less room and degrades (or at worst expires) honestly
        self.deadline = deadline if deadline is not None else Deadline.never()
        self.enqueue_t = time.monotonic()


class RequestQueue:
    """Bounded FIFO of ServeRequests with breaker-backed admission.

    Non-blocking ``submit``: breaker-gated; a full queue raises
    ``ServeOverloadError`` and counts a breaker failure (consecutive
    failures trip it open — subsequent submits shed immediately for
    ``reset_secs`` without touching the queue).  Blocking ``submit``:
    waits up to `timeout` for space (backpressure; no breaker
    involvement) and raises ``ServeOverloadError`` only on timeout.

    Weighted-fair pickup: internally one FIFO per tenant
    under the shared ``max_depth`` bound; ``get``/``get_nowait`` pick
    the next tenant by smooth weighted round-robin over the NON-EMPTY
    tenants (``fair_weights``, unlisted tenants weigh 1.0) and pop that
    tenant's head — per-tenant order stays FIFO, cross-tenant pickup
    interleaves by weight, and the single-tenant case is byte-for-byte
    the historical global FIFO.

    Metrics (serve/ namespace, SERVING.md): ``serve/queue_depth`` gauge,
    ``serve/submitted_total`` / ``serve/shed_total`` counters, and the
    admission breaker's ``resilience/serve.admission/*`` family.
    """

    def __init__(self, max_depth: int,
                 breaker: Optional[CircuitBreaker] = None,
                 registry: Optional[obs.Registry] = None,
                 fair_weights: Optional[Dict[str, float]] = None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        # per-tenant FIFOs + TWO conditions over one lock (the stdlib
        # Queue discipline): producers blocked on space wait on
        # not_full, consumers on not_empty, and each side wakes exactly
        # ONE waiter per transition — notify_all here would cost
        # O(waiters) context switches per request under the
        # high-concurrency load the serve bench measures
        self._lock = locksan.make_lock("RequestQueue._lock")
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._buckets: "OrderedDict[str, Deque[ServeRequest]]" = \
            OrderedDict()
        self._size = 0
        self._weights: Dict[str, float] = dict(fair_weights or {})
        #: smooth-WRR credits, persistent across pickups so a tenant's
        #: fairness debt survives its bucket draining and refilling
        self._credits: Dict[str, float] = {}
        reg = registry if registry is not None else obs.registry()
        self._reg = reg
        # under sustained overload there is no point probing the queue
        # per request; a short reset window keeps shedding responsive
        # to recovery while bounding the lock traffic of hot rejection
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            threshold=2 * max_depth, reset_secs=0.25,
            name="serve.admission", registry=reg)
        self._closed = False
        self._g_depth = reg.gauge("serve/queue_depth")
        self._c_submitted = reg.counter("serve/submitted_total")
        self._c_shed = reg.counter("serve/shed_total")

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def close(self) -> None:
        """Refuse all further submits (pending requests stay queued for
        the drain; ``drain_reject`` empties them with typed errors)."""
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, req: ServeRequest, block: bool = False,
               timeout: Optional[float] = None) -> None:
        """Admit `req` or raise ``ServeOverloadError``/``ServeClosedError``.

        The request's queue clock restarts here: admission time is when
        the deadline-from-enqueue semantics begin for queue-wait
        accounting."""
        if self._closed:
            raise ServeClosedError("serving queue is closed")
        if not block and not self._breaker.allow():
            # labeled child rolls up into the unlabeled total, so the
            # per-tenant split (cost accounting) is free and
            # the aggregate dashboards keep their historical meaning
            self._c_shed.labels(tenant=req.tenant or "default").inc()
            obs.spans.request_event(self._reg, "shed", req.trace, req.uuid,
                                    cause="breaker_open")
            raise ServeOverloadError(
                "request shed: admission breaker open (sustained overload)")
        req.enqueue_t = time.monotonic()
        # lifecycle root event BEFORE the queue put: the instant the
        # request becomes visible to the dispatch thread it may emit
        # admit/slot/resolve, and those must never precede enqueue in
        # the stream (a full-queue bounce turns the trace into
        # enqueue -> shed — an honest timeline for a request that
        # reached the queue and bounced)
        obs.spans.request_event(self._reg, "enqueue", req.trace, req.uuid,
                                depth=self._size)
        if not self._put(req, block, timeout):
            if not block:
                self._breaker.record_failure()
            self._c_shed.labels(tenant=req.tenant or "default").inc()
            obs.spans.request_event(self._reg, "shed", req.trace, req.uuid,
                                    cause="queue_full")
            raise ServeOverloadError(
                f"serve queue full (depth {self.max_depth}); request "
                f"{req.uuid!r} rejected") from None
        if not block:
            self._breaker.record_success()
        self._c_submitted.inc()
        self._g_depth.set(self._size)

    def _put(self, req: ServeRequest, block: bool,
             timeout: Optional[float]) -> bool:
        """Append `req` to its tenant's FIFO; False when full (after
        waiting up to `timeout` in blocking mode)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._size >= self.max_depth:
                if not block:
                    return False
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                # loop on the PREDICATE, never on wait()'s verdict: a
                # wake that races the timeout consumes the notify, and
                # shedding here would bounce a request against a queue
                # that just freed a slot (the stdlib Queue.put
                # discipline — the next iteration's remaining<=0 check
                # is what enforces the deadline)
                self._not_full.wait(remaining)
            self._buckets.setdefault(req.tenant or "",
                                     deque()).append(req)
            self._size += 1
            self._not_empty.notify()
        return True

    def _pick_tenant(self) -> str:
        """Smooth weighted round-robin over the NON-EMPTY tenant FIFOs
        (caller holds the condition lock, size > 0): every candidate
        earns its weight in credit, the richest one pays the round's
        total back and is picked — over time each tenant's pickup share
        converges to weight/sum(weights) regardless of backlog depth.
        Deterministic: insertion order breaks ties (strict >), so the
        virtual-time SLO gate replays exactly."""
        total = 0.0
        best: Optional[str] = None
        for tenant, bucket in self._buckets.items():
            if not bucket:
                continue
            w = self._weights.get(tenant, 1.0)
            total += w
            credit = self._credits.get(tenant, 0.0) + w
            self._credits[tenant] = credit
            if best is None or credit > self._credits[best]:
                best = tenant
        assert best is not None  # caller guarantees size > 0
        self._credits[best] -= total
        return best

    def _pop(self) -> Optional[ServeRequest]:
        """Pop the next request by fair pickup (caller holds the lock);
        None when empty."""
        if self._size == 0:
            return None
        tenant = self._pick_tenant()
        bucket = self._buckets[tenant]
        req = bucket.popleft()
        if not bucket:
            # drop the empty FIFO so the pickup scan stays proportional
            # to the ACTIVE tenant count (credits persist separately —
            # but bounded: past MAX_TENANT_CREDITS, idle tenants'
            # residual debt is pruned rather than leaked)
            del self._buckets[tenant]
            if len(self._credits) > MAX_TENANT_CREDITS:
                for t in [t for t in self._credits
                          if t not in self._buckets]:
                    if len(self._credits) <= MAX_TENANT_CREDITS:
                        break
                    del self._credits[t]
        self._size -= 1
        self._not_full.notify()
        return req

    def get(self, timeout: float = 0.05) -> Optional[ServeRequest]:
        """Next request by weighted-fair pickup, or None after
        `timeout` seconds idle."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._size == 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._not_empty.wait(remaining):
                    if self._size == 0:
                        return None
            req = self._pop()
        self._g_depth.set(self._size)
        return req

    def get_nowait(self) -> Optional[ServeRequest]:
        with self._lock:
            req = self._pop()
        if req is None:
            return None
        self._g_depth.set(self._size)
        return req

    def qsize(self) -> int:
        return self._size

    def empty(self) -> bool:
        return self._size == 0

    def drain_reject(self, error: BaseException) -> int:
        """Reject every still-queued request with `error` (hard stop);
        returns the number rejected."""
        n = 0
        while True:
            req = self.get_nowait()
            if req is None:
                return n
            req.future._reject(error)
            n += 1
