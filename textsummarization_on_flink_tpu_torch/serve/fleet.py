"""FleetRouter: an elastic serving fleet over N ServingServer replicas
(SERVING.md "Elastic fleet").

A copy of the JAX package's serve/fleet.py (the port imports nothing of
that package).  The replicas are the port's ServingServers, so on the
card every replica decodes through the port's kernels; replicas that
share one card launch on its current stream, and the card runs their
work in turn — N replicas buy failover and upgrade independence, not N
times the decode rate of one card.

One ``ServingServer`` is one process; millions of users need N replicas
that can be drained, upgraded, and LOST mid-decode without losing a
single admitted request — the Flink job-topology story (PAPER.md: one
App, workers come and go under a coordinator) rebuilt on this repo's
own substrate.  The router fronts in-process replicas first (the
pipeline/io socket path is the named follow-on); each replica keeps its
own registry, queue, breaker, and dispatch loop — the router only ever
talks to the same surfaces an external router would scrape
(/healthz-shaped health, queue-depth/slots-free load, typed submit
errors).

Four capabilities, each fleet-level exactly-once:

  * **Least-loaded routing** (serve/router.py): submits go to the
    least-loaded IN-ROTATION replica; a replica with a stale heartbeat
    or an open admission breaker is removed from rotation (per-replica
    ``resilience/serve.replica.<id>/*`` breaker) and readmitted through
    that breaker's single-in-flight half-open probe.
  * **Request hedging**: once a routed request has been outstanding
    longer than ``serve_hedge_ms``, the router duplicates it to a
    second replica; the FIRST resolution wins through the router-level
    ``ServeFuture`` (the loser's result is discarded — never
    double-resolved).  A hedge is a PURCHASED duplicate (FastSeq:
    throughput comes from never doing redundant work), so wins and
    waste are both counted (``serve/hedges_total``,
    ``serve/hedge_wins_total``, ``serve/hedge_suppressed_total``) and
    spend is capped at ``serve_hedge_max_ratio`` of admissions.
  * **Rolling checkpoint hot-swap**: ``start_rolling_swap()`` walks the
    fleet replica-at-a-time — drain (stop routing to it, let its
    backlog finish) -> ``ServingServer.hot_swap()`` (the existing
    between-batch atomic reload, forced) -> readmit — so at most one
    replica is ever out for upgrade and no replica ever serves from a
    half-swapped (full, draft) pair (the per-replica params lock
    guarantees pair atomicity; the router guarantees one-at-a-time).
  * **Chaos-tested failover**: the ``serve.replica_kill`` fault point
    (or ``kill_replica()``) kills a replica mid-decode; its residents
    and prefill-queue entries reject typed through the server's
    ``fail_resident``/``fail_pending`` path and the router REQUEUES
    them on survivors (tagged with a ``requeued`` trace event), so
    every admitted request still resolves exactly once.  Replica death
    triggers a flight-recorder dump (``flight_replica_kill.jsonl``).

Exactly-once is held at the ROUTER future: every replica attempt
(primary, hedge, requeue) is an ordinary replica-level request whose
own future resolves exactly once; the router's ``_Routed`` bookkeeping
settles the caller-visible future on the first success (or the last
outstanding failure) and discards everything after.

Determinism hook: the router needs no thread — ``tick()`` advances
health refresh, the swap state machine, chaos, and the hedge scan one
round at a time, and replicas expose ``tick_once()`` — so the
virtual-time SLO gate (tests/test_serve_slo.py "fleet") drives the REAL
router + batchers single-threaded with an injected clock, no sleeps.
``start()`` runs the same ``tick()`` on a background thread for
production use.  Import-light: no torch.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs import http as obs_http
from textsummarization_on_flink_tpu_torch.obs import locksan
from textsummarization_on_flink_tpu_torch.obs import slo as slo_lib
from textsummarization_on_flink_tpu_torch.resilience import faultinject
from textsummarization_on_flink_tpu_torch.serve.errors import (
    ReplicaKilledError,
    ServeClosedError,
    ServeOverloadError,
)
from textsummarization_on_flink_tpu_torch.serve.frontdoor import FrontDoor
from textsummarization_on_flink_tpu_torch.serve.queue import (
    ServeFuture,
    track_rejection,
    track_request,
)
from textsummarization_on_flink_tpu_torch.serve.router import (
    ReplicaHandle,
    fleet_fingerprint,
    pick_replica,
    refresh_rotation,
)

log = logging.getLogger(__name__)


class _Routed:
    """One router-level request: the caller-visible future plus the
    attempt bookkeeping that makes first-wins exactly-once.

    ``_outstanding`` counts replica attempts whose futures have not yet
    reported back; a SUCCESS settles immediately (first wins), an ERROR
    settles only when it is the last attempt standing (a hedge twin or
    a requeued copy may still win)."""

    __slots__ = ("uuid", "article", "reference", "tier", "tenant",
                 "future", "ctx",
                 "submit_t", "hedged", "requeues", "tried", "_outstanding",
                 "_settled", "_last_error", "_lock")

    def __init__(self, uuid: str, article: str, reference: str, tier: str,
                 future: ServeFuture, ctx: Optional[obs.TraceContext],
                 submit_t: float, tenant: str = ""):
        self.uuid = uuid
        self.article = article
        self.reference = reference
        self.tier = tier
        self.tenant = tenant
        self.future = future
        self.ctx = ctx
        self.submit_t = submit_t
        self.hedged = False
        self.requeues = 0
        self.tried: set = set()  # replica ids this request ever ran on
        self._outstanding = 0
        self._settled = False
        self._last_error: Optional[BaseException] = None
        self._lock = locksan.make_lock("_Routed._lock")

    def add_outstanding(self) -> None:
        with self._lock:
            self._outstanding += 1

    def drop_outstanding(self) -> None:
        """Retire an attempt that was REPLACED (requeue).  Normally the
        replacement is still outstanding and this only decrements — but
        if the replacement ALREADY reported a deferred error in the
        window between its registration and this drop, the phantom
        slot being retired is what kept offer_error from settling, so
        settle here (otherwise the caller's future would hang)."""
        error: Optional[BaseException] = None
        with self._lock:
            self._outstanding -= 1
            if (self._outstanding <= 0 and not self._settled
                    and self._last_error is not None):
                self._settled = True
                error = self._last_error
        if error is not None:
            self.future._reject(error)

    def offer_result(self, result: Any) -> bool:
        """First success wins; later offers are discarded (False)."""
        with self._lock:
            self._outstanding -= 1
            if self._settled:
                return False
            self._settled = True
        self.future._resolve(result)
        return True

    def offer_error(self, error: BaseException) -> bool:
        """An attempt failed terminally.  Rejects the caller's future
        only when NO other attempt is still outstanding (a surviving
        hedge/requeue twin may yet win); returns True when it did."""
        with self._lock:
            self._outstanding -= 1
            if self._settled:
                return False
            self._last_error = error
            if self._outstanding > 0:
                return False
            self._settled = True
            error = self._last_error
        self.future._reject(error)
        return True

    def force(self, error: BaseException) -> bool:
        """Shutdown backstop: settle an unresolved future typed."""
        with self._lock:
            if self._settled:
                return False
            self._settled = True
        self.future._reject(error)
        return True


class _SwapState:
    """Rolling hot-swap progress: replica order + cursor (advanced one
    phase per router tick — drain, then swap+readmit)."""

    __slots__ = ("order", "idx")

    def __init__(self, order: List[str]):
        self.order = order
        self.idx = 0


class FleetRouter:
    """Health-aware router over N in-process ServingServer replicas.

        servers = [ServingServer(hps, vocab, ..., registry=Registry())
                   for _ in range(3)]
        router = FleetRouter(servers, hps)
        with router:                     # starts replicas + router tick
            fut = router.submit("article text .", uuid="u1")
            result = fut.result(timeout=30)
            router.rolling_swap()        # replica-at-a-time upgrade

    Replicas should be constructed with their OWN registries (each
    carries per-replica gauges — two replicas sharing one registry
    fight over ``serve/queue_depth``); the router shares its event sink
    into replica registries that lack one, so one ``events.jsonl``
    carries every request's full cross-replica lifecycle.  `clock` is
    injectable (virtual-time gates); `registry` defaults through
    ``obs.registry_for(hps)`` like every other component.
    """

    def __init__(self, replicas, hps: Any,
                 registry: Optional[obs.Registry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tick_secs: float = 0.005,
                 replica_reset_secs: float = 1.0,
                 faults: Optional[Any] = None):
        self._hps = hps
        self._clock = clock
        self._tick_secs = tick_secs
        self._reg = registry if registry is not None \
            else obs.registry_for(hps)
        if isinstance(replicas, Mapping):
            items = list(replicas.items())
        else:
            items = [(f"r{i}", s) for i, s in enumerate(replicas)]
        if not items:
            raise ValueError("a fleet needs at least one replica")
        self._handles: Dict[str, ReplicaHandle] = {}
        self._handle_list: List[ReplicaHandle] = []
        for rid, server in items:
            if isinstance(server, ReplicaHandle):
                # pre-built handle (the proc transport's
                # RemoteReplicaHandle carries its own scrape-cached
                # health/load reads): adopt it as-is — its id wins over
                # the positional default
                h = server
                rid = h.rid
                server = h.server
            else:
                h = ReplicaHandle(rid, server, registry=self._reg,
                                  clock=clock,
                                  reset_secs=replica_reset_secs)
            self._handles[rid] = h
            self._handle_list.append(h)
            # fleet identity: stamp the replica id
            # on each replica's registry so its request events and
            # flight-recorder frames/dump FILENAMES carry it — replica
            # 2's flight_serve_dispatch dump can never clobber or
            # shadow replica 0's in a shared log directory
            rreg = server.registry
            if rreg.enabled and rreg is not self._reg:
                flightrec.set_replica_id(rreg, rid)
            if hasattr(server, "disable_ingress_tracking"):
                # behind a router the ROUTER future is the one
                # caller-visible request: a replica also tracking each
                # routed/hedged/requeued attempt would double-count
                # serve/requests_total and the SLO burn windows
                # (directly on shared-registry wiring, or through the
                # /fleet/* merge on per-replica registries)
                server.disable_ingress_tracking()
        # hedging knobs, precomputed (the scan is a hot loop)
        self._hedge_s = max(0.0, float(
            getattr(hps, "serve_hedge_ms", 0.0))) / 1000.0
        self._hedge_ratio = float(
            getattr(hps, "serve_hedge_max_ratio", 0.1))
        self._max_requeues = max(1, len(items) - 1)
        self._faults = faults if faults is not None \
            else faultinject.plan_for(hps)
        # the fleet-level front door (SERVING.md "Front
        # door"): coalescing/caching dedup ACROSS replicas and tenant
        # tokens are charged once, here — so each replica's own door is
        # disarmed below.  Cache lookups key on the fleet's COMMON
        # fingerprint; mid-rolling-swap (replicas disagreeing) the
        # lookup side goes dark rather than serve one snapshot's
        # summary under another's key (inserts still file under the
        # decode-time fingerprint riding each result).
        self._door = FrontDoor(hps, registry=self._reg,
                               fingerprint=self._fleet_fingerprint,
                               clock=clock, faults=self._faults)
        for h in self._handle_list:
            if hasattr(h.server, "disable_front_door"):
                h.server.disable_front_door()
        self._lock = locksan.make_lock("FleetRouter._lock")
        self._inflight: List[_Routed] = []
        self._n_submitted = 0
        self._n_hedges = 0
        self._swap: Optional[_SwapState] = None
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # fleet telemetry (OBSERVABILITY.md; rotation breakers ride the
        # resilience/* wildcard family)
        self._c_submitted = self._reg.counter("serve/fleet_submitted_total")
        self._c_requests = self._reg.counter("serve/requests_total")
        self._c_hedges = self._reg.counter("serve/hedges_total")
        self._c_hedge_wins = self._reg.counter("serve/hedge_wins_total")
        self._c_hedge_suppressed = self._reg.counter(
            "serve/hedge_suppressed_total")
        self._c_requeued = self._reg.counter("serve/requeued_total")
        self._c_kills = self._reg.counter("serve/replica_kills_total")
        self._c_swaps = self._reg.counter("serve/fleet_swaps_total")
        self._g_rotation = self._reg.gauge("serve/replicas_in_rotation")
        self._g_rotation.set(len(self._handle_list))
        # failure flight recorder: replica death must leave the ticks
        # preceding it behind (same wiring rationale as ServingServer)
        if (self._reg.enabled and getattr(hps, "flight_frames", 0) > 0
                and getattr(hps, "log_root", "")):
            flightrec.install_flight_recorder(
                self._reg, os.path.join(hps.log_root,
                                        hps.exp_name or "exp"),
                capacity=hps.flight_frames)
        # one events.jsonl for the whole fleet: share the router's sink
        # into replica registries that have none, so a request's
        # replica-side lifecycle (enqueue/admit/slot/...) lands in the
        # same stream as the router's route/hedge/requeued events
        sink = self._reg.event_sink
        if sink is not None:
            for h in self._handle_list:
                rreg = h.server.registry
                if rreg.enabled and rreg.event_sink is None:
                    rreg.event_sink = sink
        # the fleet aggregation plane:
        # /fleet/metrics and /fleet/snapshot merge over this ordered
        # {replica_id: Registry} map — wired onto the router's registry
        # AND every replica's, so whichever registry happens to own the
        # process exposition port (obs_http.maybe_serve is first-caller
        # -wins and replicas construct before the router) can answer
        if self._reg.enabled:
            self._reg.fleet_sources = self._fleet_registries
            for h in self._handle_list:
                rreg = h.server.registry
                if rreg.enabled and rreg.fleet_sources is None:
                    rreg.fleet_sources = self._fleet_registries
            obs_http.maybe_serve(self._reg, hps)
        # per-tenant/per-tier SLO burn-rate engine at the FLEET ingress
        # (obs/slo.py): the router-level future is the caller-visible
        # exactly-once resolution, so latency/error classification
        # happens here, over the router's (possibly virtual) clock
        slo_lib.install_slo_engine(self._reg, clock=clock)

    # -- lifecycle --
    def start(self) -> "FleetRouter":
        if self._thread is not None:
            return self
        for h in self._handle_list:
            if not h.killed:
                h.server.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-router")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self._tick_secs)

    def stop(self, timeout: Optional[float] = 60.0) -> None:
        """Refuse new submits, stop the tick thread, drain every live
        replica (their stop() preserves exactly-once), then settle any
        future the drain somehow left behind — typed, never hung."""
        with self._lock:
            self._closed = True
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
            self._thread = None
        for h in self._handle_list:
            if not h.killed:
                h.server.stop(timeout=timeout)
        leftovers = 0
        with self._lock:
            routed, self._inflight = list(self._inflight), []
        for r in routed:
            if r.force(ServeClosedError(
                    "fleet stopped before this request resolved")):
                leftovers += 1
        if leftovers:  # pragma: no cover - defensive backstop
            log.warning("fleet stop settled %d unresolved request(s) "
                        "typed", leftovers)
        # retire the /fleet/* source map everywhere it was wired: a
        # stopped fleet must not pin its replicas (and their decoders)
        # in memory through a long-lived registry, nor keep answering
        # scrapes with a dead fleet's registries
        for reg in (self._reg, *(h.server.registry
                                 for h in self._handle_list)):
            # == not `is`: a bound method is minted per attribute
            # access, but compares equal on (func, self) — which is
            # exactly "wired by THIS router"
            if getattr(reg, "fleet_sources", None) == \
                    self._fleet_registries:
                reg.fleet_sources = None

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def _fleet_fingerprint(self) -> Optional[str]:
        """The fleet's cache-lookup fingerprint — the routing-policy
        helper ``router.fleet_fingerprint`` over this fleet's handles
        (None while live replicas disagree mid-swap: lookups go dark)."""
        return fleet_fingerprint(self._handle_list)

    def _fleet_registries(self) -> Dict[str, obs.Registry]:
        """The ordered {id: Registry} map the /fleet/* merge runs over
        (obs/registry.py merge_fleet_series).  The router's own
        registry rides first under ``router`` — in fleet mode the front
        door (and therefore the per-tenant hit/shed/hedge cost
        accounting) is router-owned, and a /fleet/snapshot audit that
        showed tenant spend but never tenant savings would lie.  Dead
        replicas stay listed: their counters are history the fleet view
        must keep summing, and their gauges stop updating honestly.
        Registries are deduplicated by IDENTITY: under shared-registry
        wiring (bench --serve-replicas shares ONE process registry
        across router and replicas) the merge must count each series
        once, not once per replica id."""
        out: Dict[str, obs.Registry] = {}
        seen = set()
        if self._reg.enabled:
            out["router"] = self._reg
            seen.add(id(self._reg))
        for h in self._handle_list:
            reg = h.server.registry
            if id(reg) in seen:
                continue
            seen.add(id(reg))
            out[h.rid] = reg
        return out

    def _track_request(self, fut: ServeFuture, tenant: str,
                       tier: str) -> ServeFuture:
        """Fleet-ingress accounting for one caller-visible future — the
        shared ``queue.track_request`` helper over the ROUTER future,
        so hedges/requeues resolve into one recorded outcome (replica
        ingress tracking is disabled at construction)."""
        track_request(self._reg, self._clock, fut, tenant, tier,
                      counter=self._c_requests)
        return fut

    # -- request API --
    def submit(self, article: str, uuid: str = "", reference: str = "",
               block: bool = False, timeout: Optional[float] = None,
               tier: str = "",
               trace: Optional[obs.TraceContext] = None,
               tenant: str = "") -> ServeFuture:
        """Route one request to the least-loaded in-rotation replica;
        returns the ROUTER-level future (resolves exactly once, from
        whichever replica attempt wins).  Raises the typed
        ``ServeOverloadError`` when no replica will take it (or
        ``TenantThrottledError`` when `tenant` is over its admission
        rate — charged once, here, never again per attempt).

        Front door: with caching/coalescing armed this is
        the fleet's ONE dedup point — a duplicate of an in-flight
        (content_hash, tier) attaches to the routed leader's
        exactly-once future, so hedging and kill-requeue happen UNDER
        the leader and every attached future resolves from whichever
        replica attempt finally wins; a cache hit resolves here without
        touching any replica.

        One TraceContext is minted here and threaded through every
        replica attempt, so the uuid's cross-replica lifecycle
        (enqueue -> route -> [kill -> requeued -> route] -> resolve)
        reconstructs from one events.jsonl (OBSERVABILITY.md).  An
        EXPLICIT ``trace`` wins over the mint: the
        hierarchical summarizer threads one PARENT context's children
        through every chunk sub-request, so a document's whole fan-out
        shares one trace_id across router and replicas alike."""
        with self._lock:
            if self._closed:
                raise ServeClosedError("fleet router is stopped")
        # normalize the tier BEFORE the door, exactly like
        # ServingServer.submit: "" and the explicit default must key
        # the same flight and the same cache entry, or identical
        # requests would split into separate decodes purely on how the
        # caller spelled the default
        tier = tier or getattr(self._hps, "serve_default_tier", "beam")
        flight = None
        if self._door.armed:
            try:
                self._door.admit_tenant(tenant, uuid)
            except ServeOverloadError:
                # a fleet-ingress shed is a BAD event for the SLO burn
                # windows, exactly like the standalone server's: the
                # router owns ingress tracking (replica tracking is
                # disabled), so without this a tenant-throttle outage
                # at the fleet front door reads as a healthy SLO
                track_rejection(self._reg, tenant, tier)
                raise
            kind, val = self._door.open(article, tier, uuid, reference,
                                        trace=trace, tenant=tenant)
            if kind in ("hit", "follower"):
                # hits and followers ARE fleet admissions (the counter's
                # documented meaning, and the hedge waste cap's
                # denominator — undercounting would suppress hedges far
                # below the committed ratio of real admitted traffic)
                with self._lock:
                    self._n_submitted += 1
                self._c_submitted.inc()
                return self._track_request(val, tenant, tier)
            if kind == "leader":
                flight = val
        ctx = trace if trace is not None else (
            obs.TraceContext.new() if self._reg.enabled else None)
        future = ServeFuture(uuid, registry=self._reg)
        future.trace = ctx
        future.scope = "fleet"  # the TERMINAL resolve in the trace
        routed = _Routed(uuid, article, reference, tier, future, ctx,
                         submit_t=self._clock(), tenant=tenant)
        try:
            last_error: Optional[BaseException] = None
            while True:
                with self._lock:
                    handle = pick_replica(self._handle_list,
                                          exclude=routed.tried)
                if handle is None:
                    if last_error is None:
                        last_error = ServeOverloadError(
                            f"no serving replica in rotation for request "
                            f"{uuid!r} ({len(self._handle_list)} "
                            f"configured)")
                    # surface the replicas' own typed verdict: a caller
                    # must be able to tell retryable overload from a
                    # terminal ServeClosedError (stopped replicas)
                    raise last_error
                err = self._attempt(routed, handle, block=block,
                                    timeout=timeout)
                if err is None:
                    break
                last_error = err
        except BaseException as e:
            # the leader never got routed — typed overload, or a
            # replica's own synchronous verdict (e.g. a tier the
            # replica cannot serve, which _attempt does NOT swallow):
            # the flight must die with it or every later duplicate
            # would attach to a leader that never existed and hang
            if flight is not None:
                self._door.abort(flight, e)
            if isinstance(e, ServeOverloadError):
                # every replica full (or a typed overload verdict): a
                # caller-visible shed, fed to the burn windows at the
                # ingress that owns this request's tracking
                track_rejection(self._reg, tenant, tier)
            raise
        with self._lock:
            self._inflight.append(routed)
            self._n_submitted += 1
        if flight is not None:
            self._door.commit(flight, future)
        self._c_submitted.inc()
        return self._track_request(future, tenant, tier)

    def _attempt(self, routed: _Routed, handle: ReplicaHandle,
                 hedge: bool = False, block: bool = False,
                 timeout: Optional[float] = None,
                 ) -> Optional[BaseException]:
        """One replica attempt: emit the route event, submit, wire the
        inner future into the router-level bookkeeping.  Returns None
        on success, the typed submit error on failure (the failure is
        also recorded against the replica's rotation breaker — a full
        or closed replica should shed load until its probe readmits
        it)."""
        obs.spans.request_event(
            self._reg, "route", routed.ctx, routed.uuid,
            replica=handle.rid, hedge=hedge)
        try:
            # tenant rides along only when named: the default ""
            # tenant keeps pre-tenant replica surfaces (external
            # routers' stubs) callable unchanged
            kw = {"tenant": routed.tenant} if routed.tenant else {}
            fut = handle.server.submit(
                routed.article, uuid=routed.uuid,
                reference=routed.reference, block=block, timeout=timeout,
                tier=routed.tier, trace=routed.ctx, **kw)
        except (ServeOverloadError, ServeClosedError) as e:
            handle.breaker.record_failure()
            return e
        routed.tried.add(handle.rid)
        routed.add_outstanding()
        fut.add_done_callback(
            lambda f: self._attempt_done(routed, handle, hedge, f))
        return None

    def _attempt_done(self, routed: _Routed, handle: ReplicaHandle,
                      hedge: bool, fut: ServeFuture) -> None:
        """A replica attempt reported back (any thread: a replica's
        dispatch thread, the kill path, a drain)."""
        err = fut.error
        if err is None:
            if routed.offer_result(fut.result()):
                if hedge:
                    self._c_hedge_wins.labels(
                        tenant=routed.tenant or "default").inc()
            return
        if isinstance(err, ReplicaKilledError) and self._requeue(
                routed, handle, err):
            return
        routed.offer_error(err)

    def _requeue(self, routed: _Routed, dead: ReplicaHandle,
                 err: BaseException) -> bool:
        """Re-enqueue a kill-orphaned request on a survivor (the
        failover path).  True when a new attempt is in flight; False
        falls through to normal error settlement."""
        if routed.future.done() or routed.requeues >= self._max_requeues:
            return False
        with self._lock:
            survivor = pick_replica(self._handle_list,
                                    exclude=routed.tried)
        if survivor is None:
            return False
        routed.requeues += 1
        self._c_requeued.inc()
        obs.spans.request_event(
            self._reg, "requeued", routed.ctx, routed.uuid,
            from_replica=dead.rid, to_replica=survivor.rid,
            cause=type(err).__name__)
        if self._attempt(routed, survivor) is not None:
            return False
        # the dead attempt is replaced, not reported: retire its
        # outstanding slot only AFTER the replacement registered, so
        # a concurrent twin's failure can never observe zero attempts
        routed.drop_outstanding()
        return True

    # -- fleet orchestration --
    def tick(self) -> None:
        """One router round: chaos -> rotation health refresh -> swap
        state machine -> hedge scan -> settled-request GC.  Driven by
        the router thread in production, or directly by deterministic
        harnesses (the fleet SLO gate) — same code either way."""
        self._maybe_chaos_kill()
        # burn-rate refresh once per router round: alert transitions
        # (and the slo_burn flight dump) fire on the router tick,
        # deterministically under the virtual-time gate
        slo_lib.evaluate(self._reg)
        for rid, what in refresh_rotation(self._handle_list):
            log.warning("replica %s %s rotation", rid,
                        "removed from" if what == "removed" else
                        "readmitted to")
        self._set_rotation_gauge()
        self._swap_step()
        self._hedge_scan(self._clock())
        with self._lock:
            n_inflight = len(self._inflight)
            swapping = self._swap is not None
            self._inflight = [r for r in self._inflight
                              if not r.future.done()]
        flightrec.record(
            self._reg, "fleet_tick",
            in_rotation=sum(h.in_rotation() for h in self._handle_list),
            inflight=n_inflight, swapping=swapping,
            hedges=self._n_hedges)

    def _set_rotation_gauge(self) -> None:
        self._g_rotation.set(
            sum(h.in_rotation() for h in self._handle_list))

    def _maybe_chaos_kill(self) -> None:
        """The ``serve.replica_kill`` injection point: when armed and
        firing, kill the most-loaded live replica (the one most likely
        to be mid-decode — that is the failover path worth testing),
        but never the last one standing."""
        if not self._faults.fire("serve.replica_kill"):
            return
        alive = [h for h in self._handle_list if not h.killed]
        if len(alive) <= 1:
            log.warning("serve.replica_kill fired with %d live replica(s);"
                        " refusing to kill the last one", len(alive))
            return
        victim = max(alive, key=lambda h: h.load())
        self.kill_replica(victim.rid)

    def kill_replica(self, rid: str,
                     error: Optional[BaseException] = None) -> int:
        """Kill one replica mid-decode (chaos, or surfacing a real
        death).  Its admitted requests reject typed through the
        server's fail paths and requeue on survivors via the router's
        attempt callbacks; returns the number the server rejected."""
        h = self._handles[rid]
        if h.killed:
            return 0
        h.killed = True
        self._c_kills.inc()
        # dump the ring BEFORE the rejection storm: the post-mortem
        # wants the fleet ticks strictly preceding the death
        flightrec.trigger(self._reg, "replica_kill", replica=rid,
                          load=h.server.load())
        err = error if error is not None else ReplicaKilledError(
            f"replica {rid!r} killed mid-decode")
        n = h.server.kill(err)
        self._set_rotation_gauge()
        log.warning("replica %s killed; %d request(s) rejected for "
                    "requeue on %d survivor(s)", rid, n,
                    sum(1 for x in self._handle_list if not x.killed))
        return n

    def start_rolling_swap(self) -> None:
        """Begin a replica-at-a-time checkpoint hot-swap: each tick
        advances drain -> swap -> readmit for one replica before moving
        to the next, so the fleet never has more than one replica out
        and every replica's (params, draft) pair swaps atomically
        behind its own lock."""
        with self._lock:
            if self._swap is not None:
                raise RuntimeError("rolling swap already in progress")
            order = [h.rid for h in self._handle_list if not h.killed]
            if not order:
                raise RuntimeError("no live replicas to swap")
            self._swap = _SwapState(order)

    def swap_active(self) -> bool:
        with self._lock:
            return self._swap is not None

    def rolling_swap(self, timeout: float = 120.0,
                     poll: float = 0.01) -> None:
        """Blocking convenience over ``start_rolling_swap``: returns
        when the whole fleet swapped.  Drives ticks itself when no
        router thread is running (replica dispatch threads still do
        the decoding)."""
        self.start_rolling_swap()
        end = time.monotonic() + timeout
        while self.swap_active():
            if self._thread is None:
                self.tick()
            if time.monotonic() > end:
                raise TimeoutError(
                    f"rolling swap did not finish in {timeout:.0f}s")
            time.sleep(poll)

    def _swap_step(self) -> None:
        """Advance the rolling-swap state machine one phase (tick-
        driven, no thread of its own): mark the cursor replica
        draining, wait for it to go idle, force its hot-swap, readmit,
        advance.  A swap FAILURE (e.g. an injected ckpt.load fault)
        leaves the replica serving its old snapshot and IN ROTATION —
        a bad checkpoint must degrade the upgrade, not the fleet."""
        with self._lock:
            sw = self._swap
        if sw is None:
            return
        handle: Optional[ReplicaHandle] = None
        while sw.idx < len(sw.order):
            h = self._handles[sw.order[sw.idx]]
            if h.killed:  # died while awaiting its turn: skip
                sw.idx += 1
                continue
            handle = h
            break
        if handle is None:
            with self._lock:
                self._swap = None
            log.info("rolling swap complete")
            return
        if not handle.draining:
            handle.draining = True  # routing skips it; backlog drains
            self._set_rotation_gauge()
            return
        if not handle.server.idle():
            return  # still draining; re-check next tick
        ok = handle.server.hot_swap()
        handle.draining = False
        self._set_rotation_gauge()
        self._c_swaps.inc()
        log.info("replica %s hot-swap %s; readmitted", handle.rid,
                 "succeeded" if ok else
                 "FAILED (serving on its previous snapshot)")
        sw.idx += 1

    def _hedge_scan(self, now: float) -> None:
        """Duplicate stragglers: any un-hedged, un-requeued in-flight
        request outstanding past ``serve_hedge_ms`` gets ONE twin on a
        different replica, budget permitting (the committed
        ``serve_hedge_max_ratio`` waste cap)."""
        if self._hedge_s <= 0.0:
            return
        with self._lock:
            due = [r for r in self._inflight
                   if not r.hedged and not r.requeues
                   and not r.future.done()
                   and now - r.submit_t >= self._hedge_s]
        for routed in due:
            with self._lock:
                allowed = (self._n_hedges + 1
                           <= self._hedge_ratio * self._n_submitted)
            if not allowed:
                self._c_hedge_suppressed.inc()
                continue
            with self._lock:
                twin = pick_replica(self._handle_list,
                                    exclude=routed.tried)
            if twin is None:
                continue  # nowhere to hedge to; the primary stands
            if self._attempt(routed, twin, hedge=True) is not None:
                continue  # twin refused the submit: the request keeps
                # its hedge eligibility for the next scan (marking it
                # hedged here would burn its only hedge on a failure)
            routed.hedged = True
            obs.spans.request_event(
                self._reg, "hedge", routed.ctx, routed.uuid,
                replica=twin.rid,
                waited_ms=round((now - routed.submit_t) * 1000.0, 3))
            with self._lock:
                self._n_hedges += 1
            # per-tenant hedge spend (cost accounting): waste
            # per tenant = hedges - hedge wins on these labeled children
            self._c_hedges.labels(tenant=routed.tenant or "default").inc()

    # -- introspection --
    def replicas(self) -> List[ReplicaHandle]:
        return list(self._handle_list)

    def handle(self, rid: str) -> ReplicaHandle:
        return self._handles[rid]

    def in_rotation(self) -> int:
        return sum(h.in_rotation() for h in self._handle_list)

    @property
    def registry(self) -> obs.Registry:
        return self._reg


__all__ = ["FleetRouter"]
