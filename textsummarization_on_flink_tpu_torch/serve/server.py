"""ServingServer: concurrent request serving over the decode path.

A copy of the JAX package's serve/server.py.  The server builds the
port's ``BeamSearchDecoder`` on ``hps.device``, so a dispatch runs the
beam search (and on the card the fused attention kernel) in eager
PyTorch; ``serve_mode="continuous"`` builds the decoder's slot engine
(decode/decoder.SlotDecodeEngine) unless a stub ``engine=`` is
injected.  It keeps the hooks a ``FleetRouter`` (serve/fleet.py) calls:
``kill``, ``hot_swap``, ``disable_front_door``,
``disable_ingress_tracking``, ``tick_once``, ``idle``, ``stats``,
``load`` and ``registry``.  Several replicas on one card each launch on
the device's current stream, so the card runs their decodes in turn.

The reference's whole point is *streaming* summarization (Kafka rows
through Flink into TF and back out, App.java inference job), but the
repo's decode loop was synchronous — one caller, one batch at a time
(decode/decoder.py ``decode()``).  This module turns the decoder into a
shared service:

    server = ServingServer(hps, vocab, train_dir=...)   # or params=
    with server:
        fut = server.submit("some article text .", uuid="u1")
        result = fut.result(timeout=30)                 # DecodedResult

Many callers submit concurrently; ONE dispatch thread consumes the
admission-controlled queue (serve/queue.py) through the engine
``hps.serve_mode`` selects:

  * ``microbatch`` (default/fallback) — coalesce into micro-batches
    (serve/batcher.MicroBatcher) and run each through
    ``BeamSearchDecoder.decode_batch``: independent requests share
    device dispatches (batch-fill > 1 under load), jit cache bounded by
    the shape buckets;
  * ``continuous`` — a persistent slotted decode loop
    (serve/batcher.ContinuousBatcher over decode/decoder.
    SlotDecodeEngine): queued requests run a bucketed PREFILL stage
    (encoder + cross-attention cache at the article's serve bucket) into a small ready queue, free slots refill from it at
    chunk boundaries, and resident decode is length-masked — per-chunk
    cost follows the longest active article's true length, not the
    padded shape; each future resolves the moment ITS sequence
    finishes — no dispatch-window straggler barrier (SERVING.md
    "Continuous batching" / "Prefill/decode disaggregation").

Contracts (both modes):
  * every admitted request resolves EXACTLY ONCE — with a
    ``DecodedResult`` or with the typed error that killed its batch
    (microbatch) / its residency (continuous);
  * per-request ``Deadline`` measured from enqueue, and a request whose
    budget died waiting in the queue is evicted with the typed
    ``DeadlineExceededError`` (counted in
    ``serve/deadline_evictions_total``) instead of burning a dispatch.
    Beyond that the modes differ: micro-batch requests carry a quality
    TIER (``submit(tier=...)`` — beam|greedy|spec|draft, SERVING.md
    "Quality tiers") and each group member whose budget cannot cover
    the full-beam estimate is re-tiered ALONE
    (beam->``serve_degrade_tier``, spec->draft; counted per request in
    ``serve/degraded_total`` and per requested tier) — the group then
    dispatches once per effective tier under each sub-group's tightest
    deadline; continuous mode never degrades (the slot state is
    fixed-beam, non-beam tiers are rejected at submit) — an expired
    RESIDENT is evicted typed at the next chunk boundary;
  * checkpoint hot-swap happens BETWEEN dispatches via the decoder's
    lock-guarded ``maybe_reload_checkpoint`` — between batches
    (microbatch) or ticks (continuous, where new params land at the
    next chunk boundary, so a resident article may finish under
    refreshed weights);
  * ``serve(source, sink)`` drives any pipeline/io.py Source/Sink pair
    through the queue with blocking-submit backpressure — the
    concurrency upgrade for ``pipeline/app.py:start_inference``.

Speculative tier (SERVING.md "Quality tiers"): spec-tier sub-batches
dispatch through the decoder's draft-then-verify engine; with
``hps.spec_k_adaptive`` the decoder's ONE SpecKController adapts the
draft length between cycles inside each dispatch and carries its
learned acceptance estimate across requests — this dispatch loop is
single-threaded, which is what makes the controller's unlocked
mutation safe (decode/speculative.py; the current pick is on the
``decode/spec_k_current`` gauge).

On a mesh (``dp * tp * sp > 1``: the decoder is sharded) every rank
builds the server; the chief ``start``s it and serves the requests, each
other rank calls ``follow`` (serve/mesh.py).  Both modes run there: a
micro-batch through the sharded beam search, or the slot engine with its
residents sharded over dp.  Only the beam tier is served: ``submit``
raises ``ValueError`` for another tier (JAX serve/server.py:566-570).
Only the dispatch thread issues collectives; a front-door hit, a shed,
an expired deadline or a refused tier issues none, a ``hot_swap`` runs
on the dispatch thread, and the dispatch thread's exit (``stop``,
``kill``) ends the followers' loop.

Observability (SERVING.md): serve/queue_depth, serve/time_in_queue_
seconds, serve/batch_fill, serve/e2e_latency_seconds, serve/shed_total,
serve/degraded_total, serve/errors_total, and the per-tier family
(serve/tier_*_total).  Chaos: injection point ``serve.dispatch`` fails
whole (sub-)batches deterministically.
"""

from __future__ import annotations

import logging
import os
import queue as queue_lib
import threading
import time
from typing import Any, List, Optional, Sequence

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs import http as obs_http
from textsummarization_on_flink_tpu_torch.obs import profile as profile_lib
from textsummarization_on_flink_tpu_torch.obs import slo as slo_lib
from textsummarization_on_flink_tpu_torch.config import (
    SERVE_TIERS,
    HParams,
    parse_fair_weights,
    resolve_refill_chunk,
    resolve_serve_slots,
)
from textsummarization_on_flink_tpu_torch.data.batching import SummaryExample
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.pipeline.io import (
    CollectionSink,
    SchemaProjectionError,
    Sink,
    Source,
)
from textsummarization_on_flink_tpu_torch.resilience import faultinject
from textsummarization_on_flink_tpu_torch.resilience.errors import (
    DeadlineExceededError,
)
from textsummarization_on_flink_tpu_torch.resilience.policy import Deadline
from textsummarization_on_flink_tpu_torch.serve.batcher import (
    ContinuousBatcher,
    MicroBatcher,
)
from textsummarization_on_flink_tpu_torch.serve.errors import (
    ReplicaKilledError,
    ServeClosedError,
    ServeOverloadError,
)
from textsummarization_on_flink_tpu_torch.serve.frontdoor import FrontDoor
from textsummarization_on_flink_tpu_torch.serve.queue import (
    RequestQueue,
    ServeFuture,
    ServeRequest,
    track_rejection,
    track_request,
)

log = logging.getLogger(__name__)

#: seconds a hot swap on a mesh waits for the dispatch thread to run it
#: (a dispatch in flight finishes first)
HOT_SWAP_WAIT_S = 600.0

#: columns the serving path consumes from a pipeline row (the
#: inference_selected_cols default, App.java:100)
SERVE_COLS = ("uuid", "article", "reference")


class ServingServer:
    """Thread-safe concurrent serving front-end for one decoder.

    Construct with ``params=`` (static weights) or ``train_dir=``
    (checkpoint dir: continuous mode hot-swaps the newest checkpoint
    between batches), or inject a prebuilt ``decoder=`` (tests, custom
    wiring).  ``start()`` launches the dispatch thread; ``stop()``
    drains the queue and joins (context-manager sugar does both).
    """

    def __init__(self, hps: HParams, vocab: Vocab,
                 params: Optional[Any] = None,
                 train_dir: Optional[str] = None,
                 decoder: Optional[Any] = None,
                 decode_root: Optional[str] = None,
                 engine: Optional[Any] = None,
                 registry: Optional[obs.Registry] = None,
                 clock: Any = time.monotonic):
        self._hps = hps
        self._vocab = vocab
        self._clock = clock
        self._reg = registry if registry is not None else obs.registry_for(hps)
        # the phase ledger (obs/profile.py): installed before the
        # batcher wiring so every phase timer shares THIS server's
        # clock (virtual in the deterministic gates); first install on
        # the registry wins, like the SLO engine below
        profile_lib.install_profiler(
            self._reg, clock=clock,
            divergence_factor=hps.profile_divergence_factor)
        self._mode = hps.serve_mode
        if decoder is None:
            # deferred: the decoder pulls in torch and the model; a server
            # built around an injected stub must not pay that import.  It
            # runs on hps.device (cuda unless the caller asks for cpu)
            from textsummarization_on_flink_tpu_torch.decode.decoder import (
                BeamSearchDecoder,
            )

            decoder = BeamSearchDecoder(
                hps.replace(single_pass=False), vocab, batcher=None,
                params=params, train_dir=train_dir, decode_root=decode_root)
        self._decoder = decoder
        # on a mesh (a sharded decoder, serve/mesh.py) the chief leads:
        # each dispatch sends its op to the followers, which run follow()
        self._mesh = bool(getattr(decoder, "sharded", False))
        if self._mesh:
            decoder.led = True
        # calls another thread hands to the dispatch thread (a mesh's
        # collectives are the dispatch thread's alone)
        self._calls: "queue_lib.Queue" = queue_lib.Queue()
        self._queue = RequestQueue(
            hps.serve_max_queue, registry=self._reg,
            fair_weights=parse_fair_weights(
                getattr(hps, "serve_fair_weights", "")))
        self._faults = faultinject.plan_for(hps)
        # the serving front door (SERVING.md "Front door"):
        # per-tenant token-bucket admission, the (content_hash, tier,
        # params_fingerprint) summary cache, and in-flight coalescing —
        # all between submit and the queue.  `clock` is injectable so
        # the virtual-time SLO gate refills tenant buckets on virtual
        # seconds.  Lookups key on THIS server's live fingerprint.
        self._door = FrontDoor(hps, registry=self._reg,
                               fingerprint=lambda: self.params_fingerprint,
                               clock=clock, faults=self._faults)
        self._batcher: Optional[MicroBatcher] = None
        self._cont: Optional[ContinuousBatcher] = None
        if self._mode == "continuous":
            # engine= injects a stub (tests); the real one drives the
            # decoder's slot functions on hps.device
            if engine is None:
                engine = self._decoder.slot_engine(
                    slots=resolve_serve_slots(hps),
                    chunk=resolve_refill_chunk(hps), registry=self._reg)
            self._cont = ContinuousBatcher(hps, self._queue, engine,
                                           registry=self._reg,
                                           faults=self._faults)
        else:
            self._batcher = MicroBatcher(hps, vocab, self._queue,
                                         registry=self._reg)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._killed = False  # abrupt death (kill()): no drain, no refill
        # micro-batch groups currently inside decode_batch (0 or 1 —
        # single dispatch thread): the router's drain detection must
        # not call a server idle while a group is mid-dispatch
        self._dispatching = 0
        # deterministic-driver clock for tick_once (the fleet SLO gate
        # drives rounds without a dispatch thread)
        self._tick_last = time.monotonic()
        # failure flight recorder (OBSERVABILITY.md "Flight recorder"):
        # per-tick/per-dispatch frames ring in memory; the serve-side
        # triggers (dispatch failure, breaker open, eviction storm) dump
        # them next to the decode output.  Needs a directory to land in:
        # the decoder's decode dir when it has one, else the job's log
        # root; stub wirings with neither run without a recorder.
        if self._reg.enabled and getattr(hps, "flight_frames", 0) > 0:
            flight_dir = getattr(decoder, "_decode_dir", None)
            if flight_dir is None and hps.log_root:
                flight_dir = os.path.join(hps.log_root,
                                          hps.exp_name or "exp")
            if flight_dir:
                flightrec.install_flight_recorder(
                    self._reg, flight_dir, capacity=hps.flight_frames)
        # live exposition plane (/metrics, /healthz, /snapshot, /spans):
        # off unless TS_OBS_HTTP / HParams(obs_http_port) says otherwise
        obs_http.maybe_serve(self._reg, hps)
        # the effective serve_mode rides /healthz beside the
        # queue-depth/slots-free gauges, with the ACTIVE params
        # fingerprint: an external cache tier keys on exactly what the
        # in-process summary cache keys on, and a checkpoint reload is
        # observable as the value changing.
        # the eager sha (one D2H + full-tree hash) is only worth paying
        # when something will read it: an enabled registry's /healthz,
        # or an armed door's cache lookups (which memoize through the
        # decoder anyway).  A dark job skips it entirely.
        self._published_fp = (self.params_fingerprint
                              if self._reg.enabled else "")
        obs_http.set_health_info(self._reg, serve_mode=self._mode,
                                 params_fingerprint=self._published_fp)
        self._h_queue_time = self._reg.histogram(
            "serve/time_in_queue_seconds")
        self._h_e2e = self._reg.histogram("serve/e2e_latency_seconds")
        self._c_done = self._reg.counter("serve/completed_total")
        self._c_degraded = self._reg.counter("serve/degraded_total")
        self._c_errors = self._reg.counter("serve/errors_total")
        self._c_rows_out = self._reg.counter("serve/sink_rows_total")
        self._c_evictions = self._reg.counter(
            "serve/deadline_evictions_total")
        # per-tier telemetry (SERVING.md "Quality tiers"): completions
        # by EFFECTIVE tier, and degradations by the tier the request
        # ASKED for — literal metric names (the obs doc-drift gate scans
        # for literals), looked up through these dicts
        self._c_tier_done = {
            "beam": self._reg.counter("serve/tier_beam_total"),
            "greedy": self._reg.counter("serve/tier_greedy_total"),
            "spec": self._reg.counter("serve/tier_spec_total"),
            "draft": self._reg.counter("serve/tier_draft_total"),
        }
        self._c_tier_degraded = {
            "beam": self._reg.counter("serve/tier_degraded_beam_total"),
            "spec": self._reg.counter("serve/tier_degraded_spec_total"),
        }
        # per-tenant cost accounting: decoded tokens charged to the
        # tenant that asked for them (the front door's savings
        # counterpart lives in serve/frontdoor.py)
        self._c_tenant_tokens = self._reg.counter(
            "serve/tenant_tokens_total")
        # the SLO burn-rate engine (obs/slo.py; SLO_POLICY.json at the
        # repo root): first install on this registry wins, the clock is
        # THIS server's (virtual in the committed gate) — request
        # resolutions feed it via queue.track_request, dispatch rounds
        # evaluate it.  _ingress_track gates the whole feed: a replica
        # BEHIND a FleetRouter must not double-count what the router
        # already tracks (the router-level future is the caller-visible
        # request; replica attempts are implementation detail)
        self._ingress_track = True
        self._c_requests = self._reg.counter("serve/requests_total")
        slo_lib.install_slo_engine(self._reg, clock=clock)

    # -- lifecycle --
    def start(self) -> "ServingServer":
        if self._thread is not None:
            return self
        if self._killed:
            raise ServeClosedError("cannot start a killed replica")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-dispatch")
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 60.0) -> None:
        """Refuse new submits, drain everything already admitted, join.

        Every admitted request still resolves (the exactly-once
        contract survives shutdown); only if the dispatcher fails to
        drain within `timeout` are leftovers rejected with the typed
        ``ServeClosedError``."""
        self._queue.close()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():  # pragma: no cover - defensive
                log.warning("serve dispatch thread still draining after "
                            "%.0fs; rejecting leftovers", timeout or 0)
        else:
            self._release_followers()  # no dispatch thread ever ran
        n = self._queue.drain_reject(
            ServeClosedError("server stopped before this request ran"))
        if n:
            self._c_errors.inc(n)
        if self._cont is not None:
            # shutdown backstop for the prefill queue: a
            # dispatch thread that died past its join timeout may leave
            # prefilled-but-unslotted requests behind; their futures
            # must resolve (fail_pending counts its own errors)
            self._cont.fail_pending(
                ServeClosedError("server stopped before this request ran"))
        self._thread = None
        # a stopped server's silence is not a failure: retire the beat
        # so /healthz reflects the components still running
        obs_http.retire_heartbeat(self._reg, "serve/dispatch")

    def kill(self, error: Optional[BaseException] = None) -> int:
        """Simulate (or surface) abrupt replica death: refuse new
        submits, abandon the dispatch thread WITHOUT draining, and
        reject every admitted request — residents and prefill-queue
        entries through the typed ``fail_resident``/``fail_pending``
        path, queued requests via ``drain_reject`` — with
        ``ReplicaKilledError`` (or `error`).  Returns the number of
        requests rejected.

        The exactly-once contract survives death: every rejected future
        resolves exactly once with the typed cause, which is what lets
        the FleetRouter requeue them on surviving replicas (SERVING.md
        "Elastic fleet").  Idempotent; a clean ``stop()`` is the
        graceful sibling."""
        if self._killed:
            return 0
        err = error if error is not None else ReplicaKilledError(
            "serving replica killed mid-decode")
        self._killed = True
        self._queue.close()
        self._stop.set()
        t = self._thread
        if t is not None:
            # the dispatch thread exits at its next loop-top _killed
            # check; join BEFORE failing residents so the kill path
            # never races a live tick over the engine state
            t.join(timeout=30.0)
            if t.is_alive():  # pragma: no cover - defensive
                log.warning("killed serve dispatch thread still inside a "
                            "dispatch; residents will fail under it")
            self._thread = None
        else:
            self._release_followers()  # no dispatch thread ever ran
        n = 0
        if self._cont is not None:
            n += self._cont.fail_resident(err)
            n += self._cont.fail_pending(err)
        drained = self._queue.drain_reject(err)
        if drained:
            self._c_errors.inc(drained)
        n += drained
        obs_http.retire_heartbeat(self._reg, "serve/dispatch")
        if n:
            log.warning("replica killed: %d admitted request(s) rejected "
                        "%s for requeue", n, type(err).__name__)
        return n

    @property
    def killed(self) -> bool:
        return self._killed

    def hot_swap(self) -> bool:
        """Router-orchestrated FORCED checkpoint swap (SERVING.md
        "Elastic fleet"): reload the newest checkpoint NOW — no 60s
        self-gate — between dispatches, while the router holds this
        replica drained.  Same failure tolerance as the between-batch
        path: a failed reload keeps the replica serving its CURRENT
        snapshot (counted in ``serve/ckpt_reload_errors_total``) and
        returns False; the router keeps it in rotation either way.  On a
        mesh whose dispatch thread runs, the swap runs on that thread
        between its rounds (the chief's path goes to every rank), and a
        swap not run within ``HOT_SWAP_WAIT_S`` returns False."""
        t = self._thread
        if (not self._mesh or t is None or not t.is_alive()
                or threading.current_thread() is t):
            return self._hot_swap_now()
        done = threading.Event()
        box: list = []
        self._calls.put((self._hot_swap_now, box, done))
        if not done.wait(HOT_SWAP_WAIT_S):
            log.warning("the dispatch thread did not run the hot swap "
                        "within %.0f s", HOT_SWAP_WAIT_S)
            return False
        return box[0]

    def _run_calls(self) -> None:
        """Run what other threads handed to the dispatch thread."""
        while True:
            try:
                fn, box, done = self._calls.get_nowait()
            except queue_lib.Empty:
                return
            try:
                box.append(fn())
            finally:
                done.set()

    def _release_followers(self) -> None:
        """A mesh chief's stop to its followers (once; serve/mesh.py)."""
        if self._mesh and hasattr(self._decoder, "release_followers"):
            self._decoder.release_followers()

    def follow(self) -> int:
        """A mesh follower's loop (serve/mesh.py): run the chief's ops
        until its stop; returns the number run.  Every rank builds the
        server; the chief starts it and takes the requests, each other
        rank calls this instead of ``start``."""
        from textsummarization_on_flink_tpu_torch.serve import mesh

        engine = self._cont._engine if self._cont is not None else None
        return mesh.follow(self._decoder, engine)

    def _hot_swap_now(self) -> bool:
        try:
            # -inf forces the cadence check; the decoder's params lock
            # still makes the (params, ckpt, draft) swap atomic
            self._decoder.maybe_reload_checkpoint(float("-inf"))
            self._publish_fingerprint()
            return True
        except Exception:
            self._reg.counter("serve/ckpt_reload_errors_total").inc()
            log.exception("router-orchestrated hot-swap failed; serving "
                          "on the current snapshot")
            return False

    def disable_front_door(self) -> None:
        """Disarm THIS server's front door (FleetRouter construction):
        behind a router, coalescing/caching must dedup ACROSS replicas
        and tenant tokens must be charged exactly once — so the router
        runs the one front door and replicas serve what they are
        routed.  (A hedged twin or a requeue would otherwise coalesce
        against its own primary, or double-spend a tenant's bucket.)
        Also releases this replica's now-dead cache."""
        self._door.disarm()

    @property
    def params_fingerprint(self) -> str:
        """The ACTIVE params fingerprint (the decoder's cached sha over
        its current ``_params_snapshot``; "" for decoders without the
        surface — stubs, the SLO gate's sims — which therefore cache
        consistently under the empty fingerprint).  The summary cache's
        lookup key (SERVING.md "Front door")."""
        fp = getattr(self._decoder, "params_fingerprint", "")
        return fp if isinstance(fp, str) else ""

    def _publish_fingerprint(self) -> None:
        """Refresh the /healthz fingerprint after a (possible) swap.
        Called once per dispatch loop / tick but gated on the CHANGE:
        the decoder's sha is memoized per params object, and the
        health-info dict update only runs when the value moved (at
        most once per actual reload, not per tick).  Dark registries
        skip even the memoized read — nothing would serve the value."""
        if not self._reg.enabled:
            return
        fp = self.params_fingerprint
        if fp != self._published_fp:
            self._published_fp = fp  # tslint: disable=TS009 — written only by whichever single loop (dispatch or tick_once) owns this server; roots never coexist
            obs_http.set_health_info(self._reg, params_fingerprint=fp)

    @property
    def serve_mode(self) -> str:
        return self._mode

    def idle(self) -> bool:
        """True when the server holds NO admitted work: queue empty, no
        group coalescing or mid-dispatch (the micro-batcher pops
        requests off the queue up to ``serve_max_wait_ms`` before the
        dispatch starts — those are admitted work the queue no longer
        shows), no residents, no prefilled entries — the router's
        drained predicate for rolling hot-swap."""
        if not self._queue.empty() or self._dispatching:
            return False
        if self._batcher is not None and self._batcher.in_flight:
            return False
        if self._cont is not None and (self._cont.busy()
                                       or self._cont.pending()):
            return False
        return True

    def stats(self) -> dict:
        """Live routing inputs (the in-process mirror of the /healthz
        body's ``serve`` section): queue depth, resident/free slots
        (continuous), prefilled count, effective serve_mode, and the
        LIVE admission-breaker state (the ``breaker_state`` gauge only
        refreshes on allow(), so a scraped OPEN may already be past its
        reset window — the state property re-evaluates)."""
        out = {
            "queue_depth": self._queue.qsize(),
            "serve_mode": self._mode,
            "admission": self._queue.breaker.state,
        }
        if self._cont is not None:
            active = self._cont.active()
            out["slots_active"] = active
            out["slots_free"] = self._cont.slots - active
            out["prefilled"] = self._cont.prefilled()
        return out

    def load(self) -> int:
        """Admitted-but-unresolved work count — the FleetRouter's
        least-loaded routing key (queued + coalescing/dispatching +
        resident + prefilled)."""
        n = self._queue.qsize()
        if self._batcher is not None:
            n += self._batcher.in_flight
        if self._cont is not None:
            n += self._cont.active() + self._cont.prefilled()
        return n

    @property
    def registry(self) -> obs.Registry:
        """This replica's obs registry — the router reads its /healthz
        payload (heartbeat staleness, breaker states) through it."""
        return self._reg

    @property
    def serve_mode(self) -> str:
        return self._mode

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def _track_request(self, fut: "ServeFuture", tenant: str,
                       tier: str) -> "ServeFuture":
        """Ingress accounting for one admitted future — the shared
        ``queue.track_request`` helper (labeled requests_total + SLO
        feed), gated off entirely behind a FleetRouter."""
        if self._ingress_track:
            track_request(self._reg, self._clock, fut, tenant, tier,
                          counter=self._c_requests)
        return fut

    def disable_ingress_tracking(self) -> None:
        """Stop counting this server's submits as caller-visible
        requests (FleetRouter construction, alongside
        ``disable_front_door``): the router tracks the one
        caller-visible future per request — a replica also counting
        each routed/hedged/requeued attempt would double-count
        ``serve/requests_total`` and the SLO burn windows."""
        self._ingress_track = False

    # -- request API --
    def submit(self, article: str, uuid: str = "", reference: str = "",
               block: bool = False, timeout: Optional[float] = None,
               tier: str = "",
               trace: Optional[obs.TraceContext] = None,
               tenant: str = "") -> ServeFuture:
        """Admit one request; returns its future.

        Non-blocking (default): full queue / open admission breaker
        raises ``ServeOverloadError`` immediately — the caller sheds or
        retries with backoff.  ``block=True`` waits up to `timeout` for
        queue space instead (pipeline backpressure mode).

        ``tier`` picks the request's quality tier
        (beam|greedy|spec|draft, SERVING.md "Quality tiers"; "" = the
        job's ``serve_default_tier``).  Tier problems are caller errors
        and fail HERE, synchronously: an unknown tier, a spec/draft ask
        against a decoder with no draft model, or a non-beam tier on a
        continuous-mode server (the persistent slot state is fixed-beam
        by construction).

        ``tenant`` names the request's fairness/admission tenant
        (SERVING.md "Front door"; "" = the default tenant, today's
        behavior).  With ``serve_tenant_rate`` armed, an over-rate
        tenant's submit sheds HERE with the typed
        ``TenantThrottledError``; with fair weights configured, pickup
        interleaves tenants by weight.

        Front door: with the summary cache armed a hit
        resolves the returned future SYNCHRONOUSLY (byte-identical to
        a fresh decode of the same (article, tier, fingerprint), queue
        untouched); with coalescing armed a duplicate of an in-flight
        (content_hash, tier) attaches to that one computation and
        resolves from its result.

        The per-request Deadline starts NOW (enqueue), so queue wait
        spends the ``decode_deadline_secs`` budget and an aged request
        degrades to greedy exactly like a slow one (RESILIENCE.md).

        ``trace`` injects an externally-minted TraceContext; None mints
        a fresh per-request root."""
        tier = tier or getattr(self._hps, "serve_default_tier", "beam")
        if tier not in SERVE_TIERS:
            raise ValueError(
                f"tier must be one of {SERVE_TIERS}, got {tier!r}")
        if self._mode == "continuous" and tier != "beam":
            raise ValueError(
                f"continuous serving decodes at the beam tier only (the "
                f"resident slot state is fixed-beam); got tier={tier!r} "
                f"— use serve_mode=microbatch for tiered requests")
        if tier != "beam" and getattr(self._decoder, "sharded", False):
            raise ValueError(
                f"sharded (mesh) serving decodes at the beam tier only "
                f"(the sharded search runs the beam tier); got "
                f"tier={tier!r}")
        if tier in ("spec", "draft") and not getattr(
                self._decoder, "has_draft", False):
            raise ValueError(
                f"tier={tier!r} needs a draft model: set hps.spec_draft "
                f"('map'/'fresh') or construct the decoder with "
                f"draft_params=")
        flight = None
        try:
            if self._door.armed:
                # a stopped/killed server refuses new submits — checked
                # BEFORE the door, or a cached article would keep
                # "succeeding" against a dead server while uncached ones
                # raise typed (the shutdown contract must not depend on
                # what happens to be cached)
                if self._queue.closed:
                    raise ServeClosedError("serving queue is closed")
                # tenant bucket FIRST (a throttled tenant must not probe
                # the cache), then cache/coalescing — both before the
                # queue, so a hit or a follower never spends queue depth
                self._door.admit_tenant(tenant, uuid)
                kind, val = self._door.open(article, tier, uuid, reference,
                                            trace=trace, tenant=tenant)
                if kind in ("hit", "follower"):
                    return self._track_request(val, tenant, tier)
                if kind == "leader":
                    flight = val
            try:
                example = SummaryExample.build(
                    article, [], self._vocab, self._hps,
                    uuid=uuid, reference=reference)
                req = ServeRequest(
                    uuid, article, reference, example,
                    deadline=Deadline.after(
                        getattr(self._hps, "decode_deadline_secs", 0.0)),
                    registry=self._reg, tier=tier, trace=trace,
                    tenant=tenant)
                self._queue.submit(req, block=block, timeout=timeout)
            except BaseException as e:
                if flight is not None:
                    # the leader died before admission completed —
                    # tokenization error, queue full, closed: any
                    # follower that attached in the window fails with
                    # the same typed cause (it asked for exactly this
                    # computation), and the flight is retired so later
                    # duplicates lead fresh
                    self._door.abort(flight, e)
                raise
        except ServeOverloadError:
            # a caller-visible shed (tenant throttle, open breaker,
            # full queue) is a BAD event for the SLO burn windows:
            # without this, total admission failure — the exact outage
            # the engine pages on — reads as a healthy SLO because only
            # admitted futures reach track_request's done-callback
            if self._ingress_track:
                track_rejection(self._reg, tenant, tier)
            raise
        if flight is not None:
            self._door.commit(flight, req.future)
        return self._track_request(req.future, tenant, tier)

    def pending(self) -> int:
        return self._queue.qsize()

    # -- pipeline driving --
    def serve(self, source: Source, sink: Optional[Sink] = None,
              cols: Sequence[str] = SERVE_COLS, max_count: int = 0,
              result_timeout: Optional[float] = 600.0) -> Sink:
        """Drive a pipeline Source through the queue into a Sink.

        Rows are projected to `cols` (uuid, article, reference) via the
        source's schema, submitted with BLOCKING backpressure (a full
        queue slows the feed instead of shedding pipeline rows), and
        each result row (uuid, article, summary, reference) is written
        to the sink the moment its future resolves — per-record
        immediacy, the Issue-6 contract, but now out-of-order under
        concurrency (rows are uuid-keyed by design).  Returns the sink
        after every submitted row resolved; the first request failure
        re-raises after the drain."""
        out = sink if sink is not None else CollectionSink()
        cols = list(cols)
        try:
            source.schema.select(cols)
        except ValueError as e:
            self._reg.counter("pipeline/feeder_errors_total").inc()
            raise SchemaProjectionError(
                f"source schema {source.schema!r} cannot provide serving "
                f"columns {cols}") from e

        def write_row(fut: ServeFuture) -> None:
            if fut.error is None:
                out.write(fut.result().as_row())
                self._c_rows_out.inc()

        futures: List[ServeFuture] = []
        n = 0
        for row in source.rows():
            try:
                uuid, article, reference = source.schema.project_row(
                    row, cols)
            except (IndexError, ValueError) as e:
                self._reg.counter("pipeline/feeder_errors_total").inc()
                raise SchemaProjectionError(
                    f"row {row!r} does not match schema "
                    f"{source.schema!r}") from e
            fut = self.submit(str(article), uuid=str(uuid),
                              reference=str(reference), block=True)
            fut.add_done_callback(write_row)
            futures.append(fut)
            n += 1
            if max_count and n >= max_count:
                break
        first_error: Optional[BaseException] = None
        for fut in futures:
            try:
                fut.result(timeout=result_timeout)
            except Exception as e:  # noqa: PERF203  # tslint: disable=TS005 — deferred re-raise: the first failure is raised after ALL futures drain; counting here would double serve/errors_total (the rejection site already counted)
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return out

    # -- dispatch loop --
    def _tightest_deadline(self, group: List[ServeRequest]) -> Deadline:
        """The batch runs under the most urgent member's budget: one
        dispatch serves them all, so the least headroom decides whether
        the whole batch degrades to greedy."""
        bounded = [r.deadline for r in group if r.deadline.bounded]
        if not bounded:
            return Deadline.never()
        return min(bounded, key=lambda d: d.remaining())

    def _beat(self) -> None:
        # one beat per dispatch-loop iteration; the shared
        # LOOP_HEARTBEAT_PERIOD carries the jit-compile-tolerance
        # rationale (obs/http.py) and keeps the trainer's and this
        # loop's /healthz semantics from drifting
        obs_http.heartbeat(self._reg, "serve/dispatch",
                           period=obs_http.LOOP_HEARTBEAT_PERIOD)

    def _run(self) -> None:
        try:
            if self._mode == "continuous":
                self._run_continuous()
            else:
                self._run_microbatch()
        finally:
            # a mesh's followers leave their loop with the dispatch thread
            self._release_followers()
            self._run_calls()

    def _run_microbatch(self) -> None:
        t_last = time.monotonic()
        while True:
            if self._killed:
                return  # abrupt death: no drain (kill() rejects leftovers)
            self._run_calls()
            self._beat()
            group = self._batcher.next_group()
            if group is None:
                if self._stop.is_set() and self._queue.empty():
                    return
                continue
            self._dispatching += 1
            try:
                self._dispatch(group)
            finally:
                self._dispatching -= 1
                # the group's futures are all settled: the coalesce/
                # dispatch in-flight window (opened inside next_group)
                # closes — idle()/load() stop counting it
                self._batcher.end_group()
            # burn-rate refresh once per dispatch round: the group's
            # resolutions just landed in the SLO windows, so alert
            # transitions (and the slo_burn flight dump) fire on the
            # dispatch thread, deterministically per round
            slo_lib.evaluate(self._reg)
            if self._stop.is_set() and self._queue.empty():
                return
            try:
                # hot-swap strictly BETWEEN batches; the decoder's param
                # lock makes the (params, ckpt_name) swap atomic even
                # against out-of-band decode_batch callers
                t_last = self._decoder.maybe_reload_checkpoint(t_last)
                self._publish_fingerprint()
            except Exception:
                # a failed reload must not kill the dispatch thread —
                # that would hang every queued and future request; the
                # decoder keeps serving its current params and the next
                # reload window retries
                self._reg.counter("serve/ckpt_reload_errors_total").inc()
                log.exception("between-batch checkpoint reload failed; "
                              "continuing on current params")
                t_last = time.monotonic()

    def _continuous_round(self, t_last: float, poll: float = 0.05) -> float:
        """ONE continuous-mode scheduler round (beat -> tick -> between-
        chunk hot-swap), shared by the dispatch thread's loop and the
        deterministic ``tick_once`` driver so the two can never drift.
        A failed tick — injected serve.dispatch fault, engine error —
        fails the RESIDENT requests only (each resolves exactly once
        with the typed cause) and the round returns normally, mirroring
        the micro-batch 'a failed dispatch fails its batch only'
        contract at slot granularity."""
        self._beat()
        try:
            self._cont.tick(poll)
        except Exception as e:  # tslint: disable=TS005 — every resident future is rejected with the typed cause and counted in serve/errors_total by fail_resident; the loop must outlive any one tick
            flightrec.trigger(self._reg, "serve_dispatch",
                              error=type(e).__name__)
            n = self._cont.fail_resident(e)
            log.exception("continuous dispatch tick failed; rejected "
                          "%d resident request(s)", n)
        # burn-rate refresh once per scheduler round (same rationale as
        # the micro-batch loop's per-dispatch evaluate)
        slo_lib.evaluate(self._reg)
        try:
            # same hot-swap cadence as the micro-batch loop (the
            # decoder self-gates at 60s); a resident article picks
            # up new params at its next chunk boundary (SERVING.md)
            t_next = self._decoder.maybe_reload_checkpoint(t_last)
            self._publish_fingerprint()
            return t_next
        except Exception:
            self._reg.counter("serve/ckpt_reload_errors_total").inc()
            log.exception("between-chunk checkpoint reload failed; "
                          "continuing on current params")
            return time.monotonic()

    def _run_continuous(self) -> None:
        """The continuous-mode dispatch loop: drive scheduler rounds
        until stopped AND drained (or killed — abrupt death skips the
        drain; kill() resolves the leftovers typed)."""
        t_last = time.monotonic()
        while True:
            if self._killed:
                return
            self._run_calls()
            t_last = self._continuous_round(t_last)
            # drain condition: queue empty AND no residents AND no
            # prefilled-but-unslotted requests (a tick can harvest every
            # resident right after the prefill stage drained the
            # queue's tail — those entries must pack on the next tick,
            # not be rejected by stop()'s backstop)
            if (self._stop.is_set() and self._queue.empty()
                    and not self._cont.busy()
                    and not self._cont.pending()):
                return

    def tick_once(self, poll: float = 0.0) -> None:
        """One continuous-mode scheduler round on the CALLER's thread.

        The deterministic-driver hook (SERVING.md "Elastic fleet"): the
        fleet virtual-time SLO gate and single-threaded harnesses drive
        the REAL dispatch path — the exact code the dispatch thread
        runs, including the tick-failure blast radius and the
        between-chunk hot-swap — one round at a time, with no threads
        and no sleeps.  Never call concurrently with a started
        dispatch thread (single consumer, like the thread itself)."""
        if self._cont is None:
            raise ValueError(
                "tick_once drives the continuous engine; this server is "
                f"serve_mode={self._mode!r} — start() it instead")
        self._tick_last = self._continuous_round(self._tick_last, poll)

    #: deadline-pressure re-tiering per REQUESTED tier: beam falls to
    #: the configured target, spec falls to its verify-free draft;
    #: greedy/draft are already the floor of their branch
    def _degrade_target(self, tier: str) -> Optional[str]:
        if tier == "beam":
            return self._hps.serve_degrade_tier
        if tier == "spec":
            return "draft"
        return None

    def _effective_tier(self, r: ServeRequest) -> tuple:
        """(effective tier, degraded?) for one request:
        degradation is decided PER REQUEST against its
        own deadline, not once for the whole micro-batch, so one
        tight-deadline member no longer drags its batchmates down to
        greedy with it."""
        tier = r.tier or getattr(self._hps, "serve_default_tier", "beam")
        target = self._degrade_target(tier)
        if target is None or not self._decoder.should_degrade(r.deadline):
            return tier, False
        if target in ("spec", "draft") and not getattr(
                self._decoder, "has_draft", False):
            target = "greedy"  # draftless jobs keep the legacy ladder
        return target, True

    def _dispatch(self, group: List[ServeRequest]) -> None:
        now = time.monotonic()
        # decoders without the tier surface (should_degrade — legacy
        # stubs, custom wirings) keep the pre-tier contract: one
        # whole-group dispatch, degradation decided inside decode_batch
        legacy = not hasattr(self._decoder, "should_degrade")
        #: effective tier -> [(request, degraded?)] — a mixed group
        #: dispatches once per tier (a dispatch runs ONE compiled
        #: program, so tiers cannot share a device batch)
        by_tier: dict = {}
        for r in group:
            queue_s = now - r.enqueue_t
            self._h_queue_time.observe(
                queue_s,
                trace_id=r.trace.trace_id if r.trace is not None else None)
            if r.deadline.expired():
                # micro-batch side of the eviction contract: a request whose
                # budget died in the queue is resolved typed instead of
                # burning a dispatch on an answer nobody is waiting for
                self._c_evictions.inc()
                obs.spans.request_event(self._reg, "evict", r.trace,
                                        r.uuid, where="queue")
                r.future._reject(DeadlineExceededError(
                    f"request {r.uuid!r} deadline expired while queued"))
                continue
            tattr = {"tenant": r.tenant} if r.tenant else {}
            if legacy:
                obs.spans.request_event(
                    self._reg, "admit", r.trace, r.uuid,
                    queue_ms=round(queue_s * 1e3, 3), **tattr)
                by_tier.setdefault(None, []).append((r, False))
                continue
            tier, degraded = self._effective_tier(r)
            obs.spans.request_event(
                self._reg, "admit", r.trace, r.uuid,
                queue_ms=round(queue_s * 1e3, 3), tier=tier, **tattr)
            by_tier.setdefault(tier, []).append((r, degraded))
        for tier, members in by_tier.items():
            self._dispatch_tier(tier, members)

    def _dispatch_tier(self, tier: Optional[str],
                       members: List[tuple]) -> None:
        """One device dispatch for one tier's sub-group (tier=None is
        the legacy whole-group path for tier-less decoders — the
        decoder decides its own degradation from the deadline)."""
        group = [r for r, _ in members]
        degraded_map = {id(r): d for r, d in members}
        # micro-batch flight frame (the per-dispatch analogue of the
        # continuous per-tick frame), recorded before the dispatch so a
        # failing batch leaves its own pre-failure frame behind
        flightrec.record(self._reg, "serve_dispatch", fill=len(group),
                         queue_depth=self._queue.qsize(),
                         tier=tier or "legacy")
        # per-tier micro-batch dispatch phase (obs/profile.py):
        # one labeled phase sample per device dispatch, keyed by
        # the effective tier so the /profile phase table splits beam
        # from greedy from spec wall time
        prof = profile_lib.profiler_for(self._reg)
        t0 = prof.start()
        try:
            with obs.spans.span(self._reg, "serve/dispatch",
                                fill=len(group), tier=tier or "legacy"):
                if self._faults.fire("serve.dispatch"):
                    raise RuntimeError("injected serve.dispatch fault")
                batch = self._batcher.build(group)
                deadline = self._tightest_deadline(group)
                if tier is None:
                    results = self._decoder.decode_batch(
                        batch, deadline=deadline)
                else:
                    results = self._decoder.decode_batch(
                        batch, deadline=deadline, tier=tier)
            dt = prof.end("serve/dispatch", t0)
            # a tier's shape has no price: the call returns at once
            prof.observe_dispatch(
                "serve/dispatch", f"tier_{tier or 'legacy'}", dt)
            if len(results) != len(group):
                raise RuntimeError(
                    f"decoder returned {len(results)} results for "
                    f"{len(group)} real rows (real_mask drift?)")
        except Exception as e:
            # a failed dispatch fails ITS tier sub-batch only — each
            # member resolves exactly once with the typed cause; the
            # server lives on to serve the next group
            flightrec.trigger(self._reg, "serve_dispatch",
                              error=type(e).__name__, tier=tier)
            self._c_errors.inc(len(group))
            log.exception("serve dispatch failed; rejecting %d request(s)",
                          len(group))
            for r in group:
                r.future._reject(e)
            return
        done_t = time.monotonic()
        for r, res in zip(group, results):
            degraded = degraded_map.get(id(r), False)
            res.degraded = bool(degraded or getattr(res, "degraded",
                                                    False))
            if tier is None:
                if res.degraded:  # legacy path: the decoder decided
                    self._c_degraded.inc()
            elif degraded:
                # counted HERE, on successful completion, so a failed
                # sub-dispatch can never report more degraded results
                # than completions (same semantics as the legacy path)
                asked = r.tier or getattr(self._hps, "serve_default_tier",
                                          "beam")
                self._c_degraded.inc()  # per REQUEST, not per batch
                if asked in self._c_tier_degraded:
                    self._c_tier_degraded[asked].inc()
            if tier in self._c_tier_done:
                self._c_tier_done[tier].inc()
            # the landing bucket's exemplar is THIS request's trace_id
            #: a fat p99 bucket on /metrics names a concrete
            # uuid to chase through trace_summary.py --request
            self._h_e2e.observe(
                done_t - r.enqueue_t,
                trace_id=r.trace.trace_id if r.trace is not None else None)
            self._c_tenant_tokens.labels(
                tenant=r.tenant or "default").inc(
                len(getattr(res, "decoded_words", ()) or ()))
            self._c_done.inc()
            obs.spans.request_event(
                self._reg, "finish", r.trace, r.uuid,
                tier=tier or "legacy", degraded=bool(res.degraded))
            r.future._resolve(res)


__all__ = ["ServingServer", "ServeFuture", "ServeOverloadError",
           "ServeClosedError", "SERVE_COLS"]
