"""Typed failure vocabulary for the serving subsystem.

Both errors subclass ``resilience.errors.ResilienceError`` so generic
resilience handlers (and the pre-existing RuntimeError handlers above
them) keep working:

  * ``ServeOverloadError`` — the admission controller rejected the
    request: the bounded queue is full, or the admission circuit
    breaker is open and the request was shed before touching the queue
    (the BreakerSink load-shedding semantics, RESILIENCE.md).  The
    request was NEVER enqueued; the caller may retry with backoff.
  * ``ServeClosedError`` — the server is stopping/stopped; submissions
    are refused and any request still queued at hard-stop is rejected
    with this.
  * ``TenantThrottledError`` — the request's tenant is over its
    token-bucket admission rate (the front door's per-tenant shed,
    SERVING.md "Front door"); a subclass of ``ServeOverloadError`` so
    overload handlers keep working.
  * ``ReplicaKilledError`` — the replica serving this request died
    mid-decode (chaos ``serve.replica_kill``, or a real crash surfaced
    through ``ServingServer.kill``).  The FleetRouter routes on exactly
    this type: a killed replica's residents and queued requests
    re-enqueue on survivors (SERVING.md "Elastic fleet"), so a caller
    only ever sees it when the whole fleet is gone.

Import-light by design (no jax/numpy): callers catch these in
admission paths that must stay cheap.
"""

from __future__ import annotations

from textsummarization_on_flink_tpu_torch.resilience.errors import ResilienceError


class ServeError(ResilienceError):
    """Base class for serving-subsystem failures."""


class ServeOverloadError(ServeError):
    """Admission control rejected the request (queue full / breaker
    open); it was never enqueued.  Retry with backoff, or shed."""


class ServeClosedError(ServeError):
    """The serving server is stopped (or stopping); no new requests."""


class TenantThrottledError(ServeOverloadError):
    """The request's TENANT is over its token-bucket admission rate
    (serve_tenant_rate, SERVING.md "Front door"); the request was shed
    before touching the queue or the admission breaker — one tenant's
    burst spends its own bucket, never the shared queue.  Subclasses
    ``ServeOverloadError`` so existing overload handlers (retry with
    backoff, shed) keep working unchanged."""


class ReplicaKilledError(ServeError):
    """The replica holding this request died mid-decode; the request is
    requeue-eligible (the FleetRouter re-enqueues it on a survivor)."""


class HierPartialFailureError(ServeError):
    """A hierarchical document request (serve/hiersum.py) could not
    complete its map-reduce: one or more chunk sub-requests — or the
    reduce pass — failed with a typed cause.  Raised on the PARENT
    future exactly once, and only after every outstanding chunk future
    has resolved (no orphaned sub-requests); the per-chunk verdicts
    ride ``failed`` keyed by chunk index (or the string "reduce").

    Partial output is never fabricated: a document summary missing a
    chunk would be a silently-wrong answer, which is worse than a typed
    failure the caller can retry (SERVING.md "Hierarchical
    summarization")."""

    def __init__(self, uuid: str, failed: dict, chunks: int):
        self.uuid = uuid
        #: {chunk index | "reduce": the sub-request's typed error}
        self.failed = failed
        #: total chunk fan-out width of the document
        self.chunks = chunks
        parts = ", ".join(
            f"{k}: {type(v).__name__}" for k, v in sorted(
                failed.items(), key=lambda kv: str(kv[0])))
        super().__init__(
            f"hierarchical request {uuid!r}: {len(failed)} of "
            f"{chunks} chunk sub-request(s) failed ({parts})")
