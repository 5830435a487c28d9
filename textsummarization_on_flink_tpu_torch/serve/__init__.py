"""Concurrent request serving: dynamic micro-batching, shape buckets,
admission control (SERVING.md).

A copy of the JAX package's serve/ (the port imports nothing of that
package), the fleet layer included.  The server builds the
port's ``BeamSearchDecoder`` on the hyperparameters' device, and in
continuous mode its ``SlotDecodeEngine`` (a stub engine may be
injected), and serves every quality tier: beam, greedy, and the spec
and draft tiers over the decoder's draft model.

The decode path dispatches one compiled program per batch; this package
turns that into a *service*: a thread-safe admission-controlled request
queue (``serve.queue``), a time/size micro-batcher that coalesces
independent requests into bucket-padded device batches
(``serve.batcher``), and a ``ServingServer`` (``serve.server``) whose
single dispatch thread runs them through ``BeamSearchDecoder`` — each
request resolving its own ``ServeFuture`` exactly once.

Layer map:
  * ``errors``  — ``ServeOverloadError`` / ``ServeClosedError`` (typed,
    under the resilience taxonomy).
  * ``queue``   — ``ServeFuture`` / ``ServeRequest`` / ``RequestQueue``
    (bounded depth + admission circuit breaker; jax-free).
  * ``batcher`` — ``MicroBatcher`` + ``resolve_buckets`` (coalescing
    window ``serve_max_wait_ms``, size cap ``serve_max_batch``,
    encoder-length buckets ``serve_buckets``; jax-free) and
    ``ContinuousBatcher`` (``serve_mode=continuous``: persistent slotted
    decode with in-flight refill at chunk boundaries — no
    dispatch-window barrier; jax-free, engine injected).
  * ``server``  — ``ServingServer``: submit()/serve() fronting the
    decoder, per-request quality tiers (``submit(tier=...)`` —
    beam/greedy/spec/draft, SERVING.md "Quality tiers") with
    per-request deadline re-tiering, between-batch checkpoint
    hot-swap, full obs instrumentation.
  * ``frontdoor`` — the production front door (SERVING.md
    "Front door"): ``article_key`` content hashing, in-flight
    coalescing, the bounded (content_hash, tier, params_fingerprint)
    ``SummaryCache``, and per-tenant token-bucket admission —
    ``FrontDoor`` sits between submit and the queue in BOTH the
    single-server and fleet paths (jax-free).
  * ``router``/``fleet`` — the elastic fleet (SERVING.md "Elastic
    fleet"): ``ReplicaHandle`` rotation state + least-loaded
    ``pick_replica`` (``router``), and the ``FleetRouter`` fronting N
    replicas — health-aware routing, request hedging, rolling hot-swap,
    replica failover with typed requeue (``fleet``).
  * ``procfleet`` — the same router over supervised child processes
    (``python -m textsummarization_on_flink_tpu_torch.cli
    serve-replica``) reached over loopback sockets.
  * ``hiersum`` — hierarchical (map over chunks, then reduce) document
    summarization over a server or a fleet.

``serve.queue``/``serve.batcher`` never import torch; ``serve.server``
defers the decoder import until it actually builds one, so admission
and batching logic stay testable (and chaos-drivable) without a device.
"""

from __future__ import annotations

from textsummarization_on_flink_tpu_torch.serve.errors import (
    ReplicaKilledError,
    ServeClosedError,
    ServeError,
    ServeOverloadError,
    TenantThrottledError,
)
from textsummarization_on_flink_tpu_torch.serve.queue import (
    RequestQueue,
    ServeFuture,
    ServeRequest,
)
from textsummarization_on_flink_tpu_torch.serve.batcher import (
    ContinuousBatcher,
    MicroBatcher,
    resolve_buckets,
)
from textsummarization_on_flink_tpu_torch.serve.frontdoor import (
    FrontDoor,
    SummaryCache,
    article_key,
)

__all__ = [
    "ContinuousBatcher", "FleetRouter", "FrontDoor", "MicroBatcher",
    "ReplicaKilledError", "RequestQueue", "ServeClosedError", "ServeError",
    "ServeFuture", "ServeOverloadError", "ServeRequest", "ServingServer",
    "SummaryCache", "TenantThrottledError", "article_key",
    "resolve_buckets",
]


def __getattr__(name: str):
    # ServingServer/FleetRouter lazily: serve.server imports pipeline.io
    # (sockets, breakers) and, when it builds one, the decoder (torch),
    # which light importers of this package don't need, and serve.fleet
    # imports serve.server's error surface
    if name == "ServingServer":
        from textsummarization_on_flink_tpu_torch.serve.server import (
            ServingServer,
        )

        return ServingServer
    if name == "FleetRouter":
        from textsummarization_on_flink_tpu_torch.serve.fleet import FleetRouter

        return FleetRouter
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
