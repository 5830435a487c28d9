"""The serving front door: request coalescing, a content-hash summary
cache, and per-tenant token-bucket admission (SERVING.md
"Front door").

At millions of users traffic is heavy-tailed — the same trending
article arrives thousands of times — yet every ``submit()`` used to run
a full decode.  FastSeq's core lesson is that serving throughput comes
from never doing redundant work (PAPERS.md), and the pointer-
generator's deterministic tiers make summaries exactly reusable: for a
fixed (article bytes, tier, params fingerprint) the decode is
reproducible, so a cache hit is exact, not approximate.  This module
sits between ``submit`` and the RequestQueue in BOTH the single-server
and fleet paths (``ServingServer``/``FleetRouter``), three layers deep:

  * **Per-tenant token-bucket admission** (``serve_tenant_rate`` /
    ``serve_tenant_burst``): a submit finding its tenant's bucket empty
    is shed with the typed ``TenantThrottledError`` BEFORE the queue or
    the admission breaker — one tenant's burst spends its own bucket,
    not the shared queue (the weighted-fair pickup side lives in
    serve/queue.py).  Sheds emit ``tenant_shed`` trace events and count
    in ``serve/tenant_shed_total``.
  * **Bounded LRU summary cache** (``serve_cache_entries`` /
    ``serve_cache_bytes``), keyed ``(content_hash, tier,
    params_fingerprint)``: a hit resolves the future synchronously at
    submit — byte-identical to a fresh decode of the same key — without
    touching the queue.  INSERTS key on the fingerprint stamped on the
    ``DecodedResult`` at decode time and LOOKUPS on the decoder's
    current fingerprint, so a checkpoint hot-swap invalidates by
    construction: swapped params report a new fingerprint and the old
    entries simply stop matching (no flush walk, no stale window).
  * **In-flight coalescing** (``serve_coalesce``): submits whose
    ``(content_hash, tier)`` matches a resident computation attach to
    that ONE leader — every attached future resolves exactly once from
    the leader's result, re-stamped with the follower's own
    uuid/article/reference (identical decoded words).  A leader
    FAILURE fails all attached futures with the leader's typed cause —
    never hangs, never double-decodes; in the fleet path the leader is
    the router-level future, so replica kill/requeue and hedging
    resolve the followers transparently (a hedged twin is a replica
    attempt UNDER the leader, so it can neither defeat coalescing nor
    double-fill the cache — the fill hangs off the exactly-once
    caller-visible future).

Content hashing is normalized through ONE helper, ``article_key``:
bytes-level sha256 over the whitespace-split word stream TRUNCATED to
``max_enc_steps`` — the exact visible window ``SummaryExample.build``
tokenizes — so two articles identical in the visible window coalesce,
and a SocketSource-ingested article hashes identically to the same
article submitted directly (both paths funnel the decoded ``article``
string here).

Failure posture: the cache layer degrades to MISS-AND-DECODE — an
internal cache error (or the armed ``serve.cache_fault`` injection
point) turns lookups into misses and skips inserts, counted in
``serve/cache_errors_total``; it can never produce a wrong summary or
a hung future.

Import-light by design: no jax/numpy — follower/hit results are
shallow copies of the leader's ``DecodedResult`` (class-agnostic, so
stub decoders and the virtual-time SLO gate ride the same code).
"""

from __future__ import annotations

import copy
import hashlib
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.config import resolve_tenant_burst
from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs import locksan
from textsummarization_on_flink_tpu_torch.resilience import faultinject
from textsummarization_on_flink_tpu_torch.serve.errors import (
    TenantThrottledError,
)
from textsummarization_on_flink_tpu_torch.serve.queue import ServeFuture

log = logging.getLogger(__name__)

#: LRU bound on per-tenant token buckets: caller-supplied tenant names
#: must not grow the admission map without bound (a cold tenant's
#: bucket is just "full burst", which is exactly what re-creating it
#: yields, so eviction loses nothing but the partial-refill state)
MAX_TENANT_BUCKETS = 4096


def article_key(article: str, max_enc_steps: int) -> str:
    """The canonical content hash of one article's VISIBLE window.

    Bytes-level: sha256 over the utf-8 encoding of the whitespace-split
    word stream truncated to ``max_enc_steps`` words — exactly the
    window ``SummaryExample.build`` tokenizes (batching.py truncates
    BEFORE vocab mapping), so two articles that differ only past the
    window produce the same key and coalesce/cache together, and
    whitespace differences a transport may introduce (trailing newline
    from a socket line codec, double spaces) cannot split the key.
    The ONE helper: every submit path — direct, pipeline-driven,
    fleet-routed — hashes through here.
    """
    words = article.split()
    if len(words) > max_enc_steps:
        words = words[:max_enc_steps]
    h = hashlib.sha256(" ".join(words).encode("utf-8"))
    return h.hexdigest()[:16]


def _result_bytes(res: Any) -> int:
    """Approximate resident bytes of one cached DecodedResult: the
    decoded word payload plus any attention/p_gen arrays riding it
    (``nbytes`` duck-typed so this module never imports numpy)."""
    n = 64  # object overhead floor
    for w in getattr(res, "decoded_words", ()):
        n += len(w) + 1
    n += int(getattr(getattr(res, "attn_dists", None), "nbytes", 0) or 0)
    n += int(getattr(getattr(res, "p_gens", None), "nbytes", 0) or 0)
    return n


def _snapshot(res: Any) -> Any:
    """A defensive copy of `res` with its OWN decoded-word list: the
    cache must hold (and hand out) payloads no caller-side in-place
    mutation can reach — a consumer editing result.decoded_words must
    never edit the resident cache entry, or every later hit would
    serve the mutated, no-longer-byte-identical summary.  The attention
    arrays stay shared (large, and treated as immutable throughout the
    serve layer)."""
    out = copy.copy(res)
    out.decoded_words = list(getattr(res, "decoded_words", ()) or ())
    return out


def _restamp(res: Any, uuid: str, article: str, reference: str) -> Any:
    """A defensive copy of `res` carrying the FOLLOWER's identity
    columns (uuid/article/reference) over the leader's decoded payload
    — the class-agnostic synthesis both the coalescing and cache paths
    use, so a follower's row differs from the leader's only in the
    columns that are the follower's own (word list copied, see
    ``_snapshot``)."""
    out = _snapshot(res)
    out.uuid = uuid
    out.article = article
    out.reference = reference
    return out


class _TokenBucket:
    """One tenant's admission bucket: ``rate`` tokens/sec, capped at
    ``burst``; clock-injectable (the virtual-time SLO gate refills on
    virtual seconds).  Mutated only under the FrontDoor lock."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst  # a fresh tenant starts with a full burst
        self.t_last = now

    def take(self, now: float) -> bool:
        elapsed = max(0.0, now - self.t_last)
        self.t_last = now
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        if self.tokens < 1.0:
            return False
        self.tokens -= 1.0
        return True


class _CacheEntry:
    __slots__ = ("result", "nbytes", "t_insert")

    def __init__(self, result: Any, nbytes: int, t_insert: float):
        self.result = result
        self.nbytes = nbytes
        self.t_insert = t_insert


class SummaryCache:
    """Bounded LRU of DecodedResults keyed (content_hash, tier,
    params_fingerprint): ``max_entries`` entries and (optionally)
    ``max_bytes`` approximate payload bytes, LRU-evicted (counted in
    ``serve/cache_evictions_total``).  Thread-safe; get/put are O(1)
    OrderedDict moves.  Entry age at hit rides the
    ``serve/cache_entry_age_seconds`` histogram — a low hit age under a
    fast hot-swap cadence means the cache is churning, not serving."""

    def __init__(self, max_entries: int, max_bytes: int = 0,
                 registry: Optional[obs.Registry] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._clock = clock
        self._lock = locksan.make_lock("SummaryCache._lock")
        self._entries: "OrderedDict[Tuple[str, str, str], _CacheEntry]" = \
            OrderedDict()
        self._bytes = 0
        reg = registry if registry is not None else obs.registry()
        self._c_evictions = reg.counter("serve/cache_evictions_total")
        self._h_age = reg.histogram("serve/cache_entry_age_seconds")
        self._g_entries = reg.gauge("serve/cache_entries")
        self._g_bytes = reg.gauge("serve/cache_bytes")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, key: Tuple[str, str, str]) -> Optional[Any]:
        """The cached DecodedResult for `key` (LRU-touched), or None.
        The caller restamps identity columns; the returned object is the
        resident one — treat it as immutable."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._entries.move_to_end(key)
            self._h_age.observe(max(0.0, self._clock() - entry.t_insert))
            return entry.result

    def put(self, key: Tuple[str, str, str], result: Any) -> None:
        nbytes = _result_bytes(result)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = _CacheEntry(result, nbytes, self._clock())
            self._bytes += nbytes
            while len(self._entries) > self.max_entries or (
                    self.max_bytes and self._bytes > self.max_bytes
                    and len(self._entries) > 1):
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= evicted.nbytes
                self._c_evictions.inc()
            self._g_entries.set(len(self._entries))
            self._g_bytes.set(self._bytes)


class _Flight:
    """One in-flight coalesced computation: the (key, tier) it owns,
    the leader's future once committed, and the follower futures
    attached while it was resident.  All mutation happens under the
    owning FrontDoor's lock; the leader-done callback snapshots the
    follower list under that lock before resolving outside it."""

    __slots__ = ("key", "tier", "leader_uuid", "followers", "settled")

    def __init__(self, key: str, tier: str, leader_uuid: str):
        self.key = key
        self.tier = tier
        self.leader_uuid = leader_uuid
        #: [(uuid, article, reference, future)] attached so far
        self.followers: List[Tuple[str, str, str, ServeFuture]] = []
        self.settled = False


class FrontDoor:
    """The admission-side front door one serving ingress owns (a
    ``ServingServer`` or the ``FleetRouter`` — each builds its own, so
    the fleet path coalesces ACROSS replicas while a bare server
    coalesces its own traffic).

    ``fingerprint`` is a zero-arg callable returning the ACTIVE params
    fingerprint for cache lookups ("" when the decoder has none — stub
    decoders and the virtual-time gate cache consistently under "").
    Returning None skips the lookup entirely (the FleetRouter reports
    None mid-rolling-swap, when replicas disagree — a mixed fleet must
    not serve one snapshot's summary under another's key).

    Protocol (the submit path):

        door.admit_tenant(tenant, uuid)          # may raise typed shed
        kind, val = door.open(article, tier, uuid, reference)
        if kind in ("hit", "follower"): return val          # a future
        # kind == "leader" (or "pass" when nothing is armed)
        ... normal queue submit -> leader_future ...
        door.commit(val, leader_future)   # or door.abort(val, error)
    """

    def __init__(self, hps: Any, registry: Optional[obs.Registry] = None,
                 fingerprint: Optional[Callable[[], Optional[str]]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 faults: Optional[Any] = None):
        self._hps = hps
        self._reg = registry if registry is not None \
            else obs.registry_for(hps)
        self._fingerprint = fingerprint if fingerprint is not None \
            else (lambda: "")
        self._clock = clock
        self._faults = faults if faults is not None \
            else faultinject.plan_for(hps)
        self._max_enc = int(getattr(hps, "max_enc_steps", 400))
        self._coalesce = bool(getattr(hps, "serve_coalesce", False))
        cache_entries = int(getattr(hps, "serve_cache_entries", 0))
        self._cache: Optional[SummaryCache] = None
        if cache_entries > 0:
            self._cache = SummaryCache(
                cache_entries, int(getattr(hps, "serve_cache_bytes", 0)),
                registry=self._reg, clock=clock)
        self._rate = float(getattr(hps, "serve_tenant_rate", 0.0))
        self._burst = float(resolve_tenant_burst(hps)) if self._rate > 0 \
            else 0.0
        self._lock = locksan.make_lock("FrontDoor._lock")
        self._flights: Dict[Tuple[str, str], _Flight] = {}
        self._tenants: "OrderedDict[str, _TokenBucket]" = OrderedDict()
        # the submit hot path tests ONE bool when nothing is armed
        self.armed = bool(self._coalesce or self._cache is not None
                          or self._rate > 0)
        self._c_hits = self._reg.counter("serve/cache_hits_total")
        self._c_misses = self._reg.counter("serve/cache_misses_total")
        self._c_coalesced = self._reg.counter("serve/coalesced_total")
        self._c_tenant_shed = self._reg.counter("serve/tenant_shed_total")
        self._c_cache_errors = self._reg.counter("serve/cache_errors_total")
        # per-tenant cost accounting: decode tokens a tenant
        # did NOT pay for because the cache answered — the savings side
        # of serve/tenant_tokens_total, so the fairness story is
        # auditable per tenant on /fleet/snapshot
        self._c_tokens_saved = self._reg.counter(
            "serve/tenant_tokens_saved_total")

    # -- tenant admission --
    def admit_tenant(self, tenant: str, uuid: str = "") -> None:
        """Spend one token from `tenant`'s bucket or shed typed.  A
        no-op when no per-tenant rate is configured (today's behavior);
        the default "" tenant is a tenant like any other — a job that
        names no tenants runs one shared bucket, which at rate 0 means
        no bucket at all."""
        if self._rate <= 0:
            return
        now = self._clock()
        with self._lock:
            bucket = self._tenants.get(tenant)
            if bucket is None:
                bucket = _TokenBucket(self._rate, self._burst, now)
                self._tenants[tenant] = bucket
                # the tenant map is BOUNDED: LRU-evict cold buckets so
                # caller-supplied tenant strings cannot grow memory
                # without bound.  (An evicted-then-returning tenant
                # restarts with a full burst — which is also what a
                # brand-new tenant gets, so rotating tenant NAMES
                # already buys a full burst per name regardless; rate
                # limiting is only as strong as tenant authentication,
                # SERVING.md "Front door".)
                while len(self._tenants) > MAX_TENANT_BUCKETS:
                    self._tenants.popitem(last=False)
            else:
                self._tenants.move_to_end(tenant)
            ok = bucket.take(now)
        if not ok:
            # labeled child rolls up into the unlabeled total: WHO is
            # being throttled is the per-tenant fairness evidence
            self._c_tenant_shed.labels(tenant=tenant or "default").inc()
            obs.spans.request_event(self._reg, "tenant_shed", None, uuid,
                                    tenant=tenant)
            raise TenantThrottledError(
                f"tenant {tenant!r} over its admission rate "
                f"({self._rate:g} req/s, burst {self._burst:g}); request "
                f"{uuid!r} shed")

    # -- cache + coalescing --
    def _cache_get(self, key: Tuple[str, str, str]) -> Optional[Any]:
        """A lookup that can only ever degrade to a MISS: internal cache
        errors (and the armed ``serve.cache_fault`` injection point)
        are swallowed and counted — never a wrong summary, never a hung
        future."""
        if self._faults.fire("serve.cache_fault"):
            self._c_cache_errors.inc()
            return None
        try:
            return self._cache.get(key)  # type: ignore[union-attr]
        except Exception:
            self._c_cache_errors.inc()
            log.exception("summary-cache lookup failed; degrading to miss")
            return None

    def _cache_put(self, key: Tuple[str, str, str], result: Any) -> None:
        if self._faults.fire("serve.cache_fault"):
            self._c_cache_errors.inc()
            return
        try:
            self._cache.put(key, result)  # type: ignore[union-attr]
            flightrec.record(
                self._reg, "front_door", entries=len(self._cache),
                bytes=self._cache.nbytes,
                hits=int(self._c_hits.value),
                misses=int(self._c_misses.value))
        except Exception:
            self._c_cache_errors.inc()
            log.exception("summary-cache insert failed; entry dropped")

    def open(self, article: str, tier: str, uuid: str, reference: str,
             trace: Optional[Any] = None,
             tenant: str = "") -> Tuple[str, Any]:
        """Route one submit through the front door.  `trace` is the
        caller's externally-minted TraceContext, if any — a hit's or
        follower's events must land under the SAME trace the caller's
        route events use, not a fresh one.  `tenant` labels the
        hit/coalesce accounting (whose decode cost was
        avoided), never the cache key — summaries are shared across
        tenants by design.  Returns one of

          * ``("pass", None)`` — nothing armed; submit normally;
          * ``("hit", future)`` — summary cache hit: the future is
            already resolved (synchronously, queue untouched);
          * ``("follower", future)`` — attached to an in-flight leader;
            resolves when the leader does;
          * ``("leader", flight)`` — this submit leads a new
            computation: enqueue it, then ``commit(flight, future)``
            (or ``abort(flight, error)`` if admission raised).
        """
        if not self._coalesce and self._cache is None:
            return "pass", None
        key = article_key(article, self._max_enc)
        if self._cache is not None:
            fp = self._fingerprint()
            if fp is not None:
                cached = self._cache_get((key, tier, fp))
                if cached is not None:
                    self._c_hits.labels(tenant=tenant or "default").inc()
                    self._c_tokens_saved.labels(
                        tenant=tenant or "default").inc(
                        len(getattr(cached, "decoded_words", ()) or ()))
                    fut = self._make_future(uuid, trace)
                    fut.cache_hit = True
                    obs.spans.request_event(
                        self._reg, "cache_hit", fut.trace, uuid,
                        key=key, tier=tier)
                    fut._resolve(_restamp(cached, uuid, article, reference))
                    return "hit", fut
                # counted only when a lookup actually ran: a None
                # fingerprint (mixed fleet mid-swap) means the cache
                # was deliberately dark, and counting those as misses
                # would read as the cache failing to serve
                self._c_misses.inc()
        if not self._coalesce:
            # cache without coalescing: the submit still leads a
            # fill-only flight (UNREGISTERED — concurrent identical
            # submits each decode, exactly today's behavior) so its
            # resolution can file the cache entry
            return "leader", _Flight(key, tier, uuid)
        with self._lock:
            flight = self._flights.get((key, tier))
            if flight is None:
                flight = _Flight(key, tier, uuid)
                self._flights[(key, tier)] = flight
                return "leader", flight
            fut = self._make_future(uuid, trace)
            # root event BEFORE the attach, and under the lock: the
            # instant the follower joins the flight it may resolve on
            # the dispatch thread, and its resolve must never precede
            # its root in the stream (queue.py's enqueue-before-put
            # rule, follower edition — _leader_done's snapshot takes
            # this same lock, so resolution cannot interleave; emit is
            # a non-blocking queue put, cheap under the lock)
            obs.spans.request_event(
                self._reg, "coalesced", fut.trace, uuid,
                leader=flight.leader_uuid, key=key, tier=tier)
            flight.followers.append((uuid, article, reference, fut))
        self._c_coalesced.labels(tenant=tenant or "default").inc()
        return "follower", fut

    def _make_future(self, uuid: str,
                     trace: Optional[Any] = None) -> ServeFuture:
        fut = ServeFuture(uuid, registry=self._reg)
        if trace is not None:
            fut.trace = trace  # the caller's context wins
        elif self._reg.enabled:
            fut.trace = obs.TraceContext.new()
        return fut

    def disarm(self) -> None:
        """Turn the door off and RELEASE its cache (FleetRouter
        construction: replicas behind a router serve what they are
        routed, so N-1 resident caches would be dead weight).  In-flight
        flights keep settling — only new submits bypass."""
        self.armed = False
        self._cache = None

    def commit(self, flight: _Flight, leader_future: ServeFuture) -> None:
        """The leader was admitted: wire its future so resolution fills
        the cache and settles every attached follower exactly once
        (the callback runs on whichever thread resolves the leader —
        dispatch, evictor, drain, or the fleet's requeue path)."""
        leader_future.add_done_callback(
            lambda fut: self._leader_done(flight, fut))

    def abort(self, flight: _Flight, error: BaseException) -> None:
        """The leader's admission RAISED (queue full, closed): the
        flight never existed as far as the queue is concerned — drop it
        and fail any already-attached follower with the same typed
        cause (they asked for exactly the computation that was just
        refused)."""
        followers = self._close(flight)
        for _, _, _, fut in followers:
            fut._reject(error)

    def _close(self, flight: _Flight,
               ) -> List[Tuple[str, str, str, ServeFuture]]:
        """Retire `flight` from the in-flight map and snapshot its
        followers (under the lock, so a late attach either lands in the
        snapshot or finds no flight and becomes a new leader/hit)."""
        with self._lock:
            if flight.settled:
                return []
            flight.settled = True
            cur = self._flights.get((flight.key, flight.tier))
            if cur is flight:
                del self._flights[(flight.key, flight.tier)]
            followers, flight.followers = flight.followers, []
        return followers

    def _leader_done(self, flight: _Flight, fut: ServeFuture) -> None:
        followers = self._close(flight)
        err = fut.error
        if err is not None:
            # leader failure fails every attached future with the
            # leader's own typed cause — exactly once each, never a
            # hang.  (In the fleet path requeue/hedging already
            # happened UNDER this future, so a surviving replica's
            # result arrives here as a success.)
            for _, _, _, ffut in followers:
                ffut._reject(err)
            return
        res = fut._result
        if self._cache is not None and not getattr(res, "degraded", False):
            # keyed on the fingerprint stamped AT DECODE TIME (the
            # decoder's _make_result), not at submit: a hot-swap
            # landing between admit and dispatch must file the entry
            # under the params that actually produced it.  DEGRADED
            # results never cache: a beam request that fell to greedy
            # under deadline pressure is not byte-identical to a fresh
            # beam decode, and filing it under the beam key would
            # poison every later hit (followers still resolve from it
            # below — they SHARED the degraded computation, which is
            # the coalescing contract, not the cache's).  The entry is
            # a _snapshot: the leader's caller holds the live result
            # object, and its in-place edits must not reach the cache.
            self._cache_put(
                (flight.key, flight.tier,
                 str(getattr(res, "params_fingerprint", "") or "")),
                _snapshot(res))
        for uuid, article, reference, ffut in followers:
            ffut._resolve(_restamp(res, uuid, article, reference))

    # -- introspection --
    def inflight(self) -> int:
        with self._lock:
            return len(self._flights)

    @property
    def cache(self) -> Optional[SummaryCache]:
        return self._cache


__all__ = ["FrontDoor", "SummaryCache", "article_key"]
