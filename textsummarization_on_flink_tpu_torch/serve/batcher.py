"""Dynamic micro-batcher: coalesce queued requests into device batches.

The decode path dispatches ONE compiled program per batch
(decode/beam_search.py), so serving throughput is set by how full each
dispatch is and how few distinct shapes the jit cache must hold.  This
module owns both levers:

  * **Coalescing** — after the first request of a batch arrives, wait
    up to ``serve_max_wait_ms`` for neighbors, up to ``serve_max_batch``
    requests per dispatch (the FastSeq observation, PAPERS.md: most
    sequence-generation serving wins are batching/dispatch engineering
    around an unchanged model).
  * **Shape buckets** — pad the batch's encoder axis to the smallest
    ``serve_buckets`` entry covering its longest article (the
    ``Batch(..., enc_steps=bucket)`` hook from data/batching.py), so a
    short article never pays full ``max_enc_steps`` decode FLOPs and
    the jit cache stays bounded at len(buckets) shapes — hits/misses
    are visible in the existing ``decode/compile_cache_*_total``
    counters (decode/beam_search.py).

The device batch SHAPE is always ``hps.batch_size``: a short
micro-batch is padded with repeats of its last example tagged
``real_mask=False``, which the decoder already drops (the same
contract as data/batcher.py trickle padding).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs import profile as profile_lib
from textsummarization_on_flink_tpu_torch.config import (
    HParams,
    parse_bucket_spec,
)
from textsummarization_on_flink_tpu_torch.config import bucket_for as \
    config_bucket_for
from textsummarization_on_flink_tpu_torch.data.batching import Batch
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.resilience.errors import (
    ArenaExhaustedError,
    DeadlineExceededError,
)
from textsummarization_on_flink_tpu_torch.serve.queue import (
    RequestQueue,
    ServeRequest,
)


def resolve_buckets(hps: HParams) -> List[int]:
    """The ascending encoder-length bucket list for this job (the one
    parser lives in config.parse_bucket_spec; see its docstring)."""
    return parse_bucket_spec(hps.serve_buckets, hps.max_enc_steps)


class MicroBatcher:
    """Pull requests off a RequestQueue and pack them into Batches.

    ``next_group`` implements the time/size coalescing policy;
    ``build`` packs a group into a bucket-padded, static-shape Batch.
    Single consumer by design (the ServingServer dispatch thread);
    the queue itself is the thread-safe boundary.
    """

    def __init__(self, hps: HParams, vocab: Vocab, rqueue: RequestQueue,
                 registry: Optional[obs.Registry] = None):
        self._hps = hps
        self._vocab = vocab
        self._q = rqueue
        self.max_batch = min(hps.serve_max_batch or hps.batch_size,
                             hps.batch_size)
        self._window = max(hps.serve_max_wait_ms, 0.0) / 1000.0
        self.buckets = resolve_buckets(hps)
        #: requests popped off the queue into the group currently being
        #: coalesced or dispatched: from the moment next_group takes its
        #: first request until the server's dispatch loop calls
        #: end_group, these are ADMITTED work that the queue no longer
        #: shows — the fleet's idle()/load() surfaces must see them or a
        #: rolling swap could fire mid-coalesce.  Single writer (the
        #: dispatch thread); readers only need zero/non-zero.
        self.in_flight = 0
        reg = registry if registry is not None else obs.registry_for(hps)
        # fill is the headline batching metric: mean fill ~1 means the
        # window is too short (or traffic too thin) and every dispatch
        # pays full-batch device time for one article
        self._h_fill = reg.histogram(
            "serve/batch_fill",
            buckets=[float(i) for i in range(1, hps.batch_size + 1)])
        self._h_bucket = reg.histogram(
            "serve/batch_bucket_len", buckets=[float(b) for b in self.buckets])
        self._c_batches = reg.counter("serve/batches_total")
        self._c_pad_rows = reg.counter("serve/pad_rows_total")

    def bucket_for(self, enc_len: int) -> int:
        """Smallest bucket covering `enc_len` (SummaryExample.build has
        already truncated to max_enc_steps == buckets[-1]).  Routes
        through config.bucket_for — the continuous engine's prefill
        stage shares the same rule."""
        return config_bucket_for(self.buckets, enc_len)

    def next_group(self, poll: float = 0.05) -> Optional[List[ServeRequest]]:
        """The next micro-batch worth of requests, or None after an idle
        `poll` seconds (the caller's loop re-checks its stop flag).

        The window clock starts at the FIRST request of the group: a
        request never waits more than ``serve_max_wait_ms`` for
        neighbors on top of its own queue time."""
        first = self._q.get(timeout=poll)
        if first is None:
            return None
        group = [first]
        self.in_flight = 1
        window_ends = time.monotonic() + self._window
        while len(group) < self.max_batch:
            remaining = window_ends - time.monotonic()
            if remaining <= 0:
                # the window closed; grab whatever is ALREADY queued
                # (free fill — no extra waiting), then ship
                while len(group) < self.max_batch:
                    req = self._q.get_nowait()
                    if req is None:
                        break
                    group.append(req)
                    self.in_flight = len(group)
                break
            req = self._q.get(timeout=remaining)
            if req is None:
                break
            group.append(req)
            self.in_flight = len(group)
        return group

    def end_group(self) -> None:
        """The dispatch loop finished the current group (every member's
        future resolved or rejected): the in-flight window closes."""
        self.in_flight = 0

    def build(self, group: List[ServeRequest]) -> Batch:
        """Pack a group into one static-shape Batch: encoder axis padded
        to the group's bucket, batch axis padded to ``hps.batch_size``
        with real_mask=False repeats."""
        bucket = max(self.bucket_for(r.example.enc_len) for r in group)
        examples = [r.example for r in group]
        n_real = len(examples)
        pad = self._hps.batch_size - n_real
        if pad:
            examples = examples + [examples[-1]] * pad
            self._c_pad_rows.inc(pad)
        mask = [i < n_real for i in range(self._hps.batch_size)]
        self._h_fill.observe(n_real)
        self._h_bucket.observe(bucket)
        self._c_batches.inc()
        return Batch(examples, self._hps, self._vocab, enc_steps=bucket,
                     real_mask=mask)


class ContinuousBatcher:
    """Continuous batching: admit into free decode slots, step a chunk,
    harvest finished sequences — no dispatch-window barrier.

    Where the MicroBatcher waits for a GROUP and dispatches it
    all-or-nothing (one long article holds the whole batch hostage, new
    arrivals wait out the window), this scheduler keeps a persistent
    slotted decode loop running: every ``tick()``

      1. evicts residents whose Deadline expired (typed
         ``DeadlineExceededError``, ``serve/deadline_evictions_total``);
      2. PREFILLS queued requests through the engine's bucketed encoder
         stage into a small ready queue — encoder cost paid
         at the article's bucket shape, ``serve_prefill_depth`` entries
         ahead of the free slots so a freed slot refills from an
         already-encoded article (``serve/prefill_*`` metrics; engines
         without a ``prefill`` surface — stubs, the SLO gate's
         uniform-baseline sim — keep the direct-pack path);
      3. refills free slots from the prefill queue (or straight off the
         RequestQueue on legacy engines) — a request admitted
         mid-decode starts at the NEXT chunk boundary, not the next
         batch;
      4. advances every resident slot one chunk through the engine;
      5. harvests finished slots — each future resolves the moment ITS
         sequence completes, independent of its neighbors.

    The engine (decode/decoder.SlotDecodeEngine, or a test stub) owns
    the device state; this class owns request bookkeeping and obs.  It
    is jax-free by design — scheduling is testable (and the SLO gate
    drivable) without a device.  Single consumer, like MicroBatcher:
    only the server's dispatch thread calls ``tick``.

    Exactly-once: every request this scheduler accepts from the queue is
    either resident (``fail_resident`` covers engine faults), harvested
    (resolved with its result), or evicted (rejected typed) — the
    server-level contract survives the mode switch.
    """

    def __init__(self, hps: HParams, rqueue: RequestQueue, engine: Any,
                 registry: Optional[obs.Registry] = None,
                 faults: Optional[Any] = None):
        self._hps = hps
        self._q = rqueue
        self._engine = engine
        self._faults = faults
        self.slots = int(engine.slots)
        # the order free slots are filled in: the engine's (a mesh
        # engine interleaves its dp indices), else 0, 1, ..
        self._slot_order = list(getattr(engine, "slot_order",
                                        range(self.slots)))
        self._resident: List[Optional[ServeRequest]] = [None] * self.slots
        self._chunks = [0] * self.slots  # chunks each resident has seen
        # the prefill queue: requests whose bucketed encoder
        # pass already ran, awaiting a free slot.  Engines without a
        # prefill surface (stub engines, the SLO gate's uniform
        # baseline) keep the legacy direct-pack refill.
        self._supports_prefill = hasattr(engine, "prefill")
        self._prefilled: Deque[Tuple[ServeRequest, Any]] = deque()
        self._prefill_depth = max(0, int(hps.serve_prefill_depth))
        self._tick = 0  # scheduler rounds (the T of "refill at tick T")
        # per-tick activity, reset each tick for the flight-recorder
        # frame (obs/flightrec.py): post-mortems need the rounds BEFORE
        # a failure, not only the cumulative counters
        self._tick_evictions = 0
        self._tick_refills = 0
        reg = registry if registry is not None else obs.registry_for(hps)
        self._reg = reg
        # the phase ledger (obs/profile.py): every tick's
        # evict/prefill/pack/dispatch/harvest wall lands in labeled
        # phase histograms, bracketed by a per-tick wall so the
        # phases-sum-to-wall accounting check holds (dark registries
        # get the allocation-free null profiler)
        self._prof = profile_lib.profiler_for(reg)
        # the divergence sentinel's dispatch-shape key: the slot chunk is
        # the one decode program this batcher drives
        self._dispatch_key = f"slot_chunk{getattr(engine, 'chunk', 0)}"
        self._g_active = reg.gauge("serve/slots_active")
        # the /healthz-scrapeable routing input: the
        # FleetRouter's least-loaded pick wants free capacity, and
        # slots - slots_active is not derivable from gauges alone (the
        # slot COUNT is construction state, not a metric)
        self._g_free = reg.gauge("serve/slots_free")
        self._g_free.set(self.slots)
        # occupancy is the headline continuous metric: fraction of slots
        # doing useful work at each chunk step (mean ~1 under load means
        # refill keeps up; the microbatch analogue is fill/batch_size)
        self._h_occupancy = reg.histogram(
            "serve/slot_occupancy",
            buckets=[i / self.slots for i in range(1, self.slots + 1)])
        self._h_resident = reg.histogram(
            "serve/request_resident_chunks",
            buckets=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0])
        self._c_refills = reg.counter("serve/slot_refills_total")
        self._c_evictions = reg.counter("serve/deadline_evictions_total")
        # prefill-stage telemetry (SERVING.md "Prefill/decode
        # disaggregation"): volume, failures, and WHICH bucket each
        # article's encoder pass ran at — the disaggregation evidence
        # (a bucket histogram pinned at max_enc_steps means the stage
        # is not routing short articles to short shapes)
        self._c_prefills = reg.counter("serve/prefill_total")
        self._c_prefill_errors = reg.counter("serve/prefill_errors_total")
        # bucketed on the serve buckets themselves (length-scaled):
        # the default time-scaled bounds would dump every token-length
        # observation into +inf and blind the percentiles
        self._h_prefill_bucket = reg.histogram(
            "serve/prefill_bucket_len",
            buckets=[float(b) for b in resolve_buckets(hps)])
        self._g_prefill_ready = reg.gauge("serve/prefill_ready")
        self._h_queue_time = reg.histogram("serve/time_in_queue_seconds")
        self._h_e2e = reg.histogram("serve/e2e_latency_seconds")
        self._c_done = reg.counter("serve/completed_total")
        self._c_errors = reg.counter("serve/errors_total")
        # per-tenant cost accounting: decoded tokens charged
        # to the tenant whose request occupied the slot
        self._c_tenant_tokens = reg.counter("serve/tenant_tokens_total")
        # paged-resident-state telemetry: arena occupancy per
        # tick plus the allocation-failure backpressure count.  Emitted
        # HERE rather than in the engine so the jax-free sim engines the
        # SLO gate drives light the same series the real engine does —
        # an engine without an arena surface simply never updates them.
        self._supports_arena = bool(getattr(engine, "paged", False))
        self._arena_blocked = False  # rising-edge state for the trigger
        self._g_arena_pages = reg.gauge("serve/arena_pages_in_use")
        self._c_arena_fail = reg.counter("serve/arena_alloc_failures_total")
        self._h_arena_fill = reg.histogram(
            "serve/arena_fill",
            buckets=[0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 1.0])

    def active(self) -> int:
        """Resident (occupied) slot count right now — the FleetRouter's
        load input alongside the queue depth."""
        return sum(r is not None for r in self._resident)

    def prefilled(self) -> int:
        """Prefilled-but-unslotted request count (admitted work that is
        neither queued nor resident — the router's load math must not
        lose it)."""
        return len(self._prefilled)

    def busy(self) -> bool:
        return any(r is not None for r in self._resident)

    def pending(self) -> bool:
        """True while prefilled-but-unslotted requests await a slot —
        part of the drain condition: a tick can harvest EVERY resident
        after the prefill stage drained the queue's tail into the
        prefill queue, and those entries are admitted work the loop
        must keep ticking for (they pack on the next refill)."""
        return bool(self._prefilled)

    def _set_active_gauge(self) -> None:
        n = sum(r is not None for r in self._resident)
        self._g_active.set(n)
        self._g_free.set(self.slots - n)

    def _evict_expired(self) -> None:
        """Resident requests whose enqueue-measured Deadline ran out are
        evicted at the chunk boundary: a deadline
        is enforced while the request is RESIDENT, not only at admission
        (continuous mode has no dispatch to re-check it)."""
        evicted = 0
        for idx, req in enumerate(self._resident):
            if req is None or not req.deadline.expired():
                continue
            self._engine.release(idx)
            self._resident[idx] = None
            self._c_evictions.inc()
            evicted += 1
            obs.spans.request_event(
                self._reg, "evict", req.trace, req.uuid, where="resident",
                slot=idx, chunks=self._chunks[idx])
            req.future._reject(DeadlineExceededError(
                f"request {req.uuid!r} deadline expired after "
                f"{self._chunks[idx]} resident chunk(s)"))
        self._tick_evictions += evicted  # tslint: disable=TS009 — single-writer: only the dispatch thread ticks; the main root is the single-threaded virtual-time tests
        if evicted >= max(2, (self.slots + 1) // 2):
            # an eviction STORM (half the engine thrown away at one
            # boundary) is a latency incident, not routine aging: leave
            # the preceding ticks behind for the post-mortem.  The
            # 2-eviction noise floor means tiny engines (slots<=2)
            # trigger only on a FULL wipe, and a 1-slot engine never
            # does — losing its single resident is indistinguishable
            # from routine deadline aging (documented, OBSERVABILITY.md)
            flightrec.trigger(self._reg, "eviction_storm",
                              evicted=evicted, tick=self._tick)
        self._set_active_gauge()

    def _next_live(self, may_block: bool, poll: float,
                   ) -> Optional[ServeRequest]:
        """Pop the next LIVE request off the RequestQueue, resolving
        queue-expired ones typed on the way (the eviction site).
        Queue time is observed for EVERY dequeued request — including
        the expired ones, whose long waits are exactly the histogram
        tail that shows queue pressure — and the admit event fires only
        for live requests (a queue-expired request's timeline is
        enqueue -> evict -> resolve, never admit -> evict, so bench's
        admit-anchored resident split can't count eviction latency as
        decode time)."""
        while True:
            req = (self._q.get(timeout=poll) if may_block
                   else self._q.get_nowait())
            may_block = False
            if req is None:
                return None
            queue_s = time.monotonic() - req.enqueue_t
            self._h_queue_time.observe(queue_s)
            if req.deadline.expired():  # died waiting in the queue
                self._c_evictions.inc()
                self._tick_evictions += 1
                obs.spans.request_event(
                    self._reg, "evict", req.trace, req.uuid,
                    where="queue")
                req.future._reject(DeadlineExceededError(
                    f"request {req.uuid!r} deadline expired while "
                    f"queued"))
                continue
            # tenant rides the admit event when named: the
            # weighted-fair pickup's interleaving is reconstructable
            # per uuid from the same stream bench's queue split reads
            obs.spans.request_event(
                self._reg, "admit", req.trace, req.uuid,
                queue_ms=round(queue_s * 1e3, 3),
                **({"tenant": req.tenant} if req.tenant else {}))
            return req

    def _prefill_stage(self, poll: float) -> None:
        """Run the bucketed PREFILL stage: pop queued
        requests and push them through the engine's encoder pass at
        their bucket shape, up to free-slots + ``serve_prefill_depth``
        ready entries — the lookahead that overlaps next admissions'
        encoder work with resident decode.  Blocks at most once and
        only while the engine is fully idle.  A prefill failure rejects
        ITS request typed and re-raises so the server's tick handler
        applies the standard dispatch-failure blast radius
        (fail_resident) to the engine."""
        if not self._supports_prefill:
            return
        free = sum(r is None for r in self._resident)
        target = free + self._prefill_depth
        may_block = not self.busy() and not self._prefilled
        while len(self._prefilled) < target:
            req = self._next_live(may_block, poll)
            may_block = False
            if req is None:
                break
            t0 = self._prof.start()
            try:
                with obs.spans.span(self._reg, "serve/prefill"):
                    pre = self._engine.prefill(req.example)
            except Exception as e:
                # the request left the queue but never became resident:
                # resolve it HERE, then let the server's dispatch-
                # failure handling deal with the engine state
                self._c_prefill_errors.inc()
                self._c_errors.inc()
                req.future._reject(e)
                raise
            trace_id = req.trace.trace_id if req.trace is not None else None
            dt = self._prof.end("serve/prefill", t0, trace_id=trace_id)
            bucket = int(getattr(pre, "bucket", req.example.enc_len))
            self._prof.observe_dispatch("serve/prefill", bucket, dt,
                                        trace_id=trace_id)
            self._c_prefills.inc()
            self._h_prefill_bucket.observe(bucket)
            obs.spans.request_event(
                self._reg, "prefill", req.trace, req.uuid, bucket=bucket)
            self._prefilled.append((req, pre))
        self._g_prefill_ready.set(len(self._prefilled))

    def _refill(self, poll: float) -> None:
        """Admit requests into every free slot — from the prefill queue
        (disaggregated engines) or straight off the RequestQueue
        (legacy engines; blocks at most once, `poll` seconds, and only
        while the engine is idle — under load the queue is polled
        non-blocking so a refill never stalls resident decodes).
        Requests whose Deadline expired while awaiting a slot are
        resolved typed here instead of wasting one."""
        may_block = not self.busy()
        for idx in self._slot_order:
            if self._resident[idx] is not None:
                continue
            while True:
                if self._supports_prefill:
                    if not self._prefilled:
                        self._g_prefill_ready.set(0)
                        return
                    req, payload = self._prefilled.popleft()
                    if req.deadline.expired():  # aged out awaiting a slot
                        self._c_evictions.inc()
                        self._tick_evictions += 1
                        obs.spans.request_event(
                            self._reg, "evict", req.trace, req.uuid,
                            where="prefilled")
                        req.future._reject(DeadlineExceededError(
                            f"request {req.uuid!r} deadline expired "
                            f"awaiting a free slot (prefilled)"))
                        continue
                else:
                    req = self._next_live(may_block, poll)
                    may_block = False  # one blocking poll per tick
                    if req is None:
                        return
                    payload = req.example
                if self._supports_arena and self._supports_prefill:
                    # admit by FREE PAGES, not free slots:
                    # an admission that cannot get its pages goes BACK
                    # to the head of the prefill queue — requeued, never
                    # rejected — and this tick stops refilling (a later
                    # entry stealing the pages would starve the head)
                    need = self._engine.pages_needed(payload)
                    free_pages = self._engine.free_pages()
                    if need > free_pages:
                        self._prefilled.appendleft((req, payload))
                        self._arena_backpressure(need, free_pages)
                        return
                t0 = self._prof.start()
                try:
                    if (self._supports_arena and self._faults is not None
                            and self._faults.fire("serve.arena_full")):
                        raise ArenaExhaustedError(
                            "injected serve.arena_full fault",
                            needed=self._engine.pages_needed(payload),
                            free=0)
                    self._engine.pack(idx, payload)
                except ArenaExhaustedError as e:
                    # typed backpressure from the engine's own alloc
                    # (belt to the proactive check's suspenders, and the
                    # chaos sweep's injection path): same requeue-never-
                    # reject contract.  Only the prefill path holds a
                    # repackable payload; a legacy direct-pack engine
                    # with an arena would have to reject — the engine
                    # guarantees prefill support whenever paged.
                    if not self._supports_prefill:
                        self._c_errors.inc()
                        req.future._reject(e)
                        raise
                    self._prefilled.appendleft((req, payload))
                    self._arena_backpressure(e.needed, e.free)
                    return
                except Exception as e:
                    # the request left the queue but never became
                    # resident: resolve it HERE, then let the server's
                    # dispatch-failure handling deal with the engine
                    self._c_errors.inc()
                    req.future._reject(e)
                    raise
                if self._supports_arena and self._arena_blocked:
                    self._arena_blocked = False  # pages freed; edge re-arms
                self._prof.end("serve/pack", t0,
                               trace_id=req.trace.trace_id
                               if req.trace is not None else None)
                self._resident[idx] = req
                self._chunks[idx] = 0
                self._c_refills.inc()
                self._tick_refills += 1  # tslint: disable=TS009 — single-writer dispatch-thread invariant (see _tick_evictions)
                # the refill-into-slot lifecycle event: WHICH slot at
                # WHICH tick — the datum aggregate histograms cannot
                # answer ("why was uuid X slow?")
                obs.spans.request_event(
                    self._reg, "slot", req.trace, req.uuid, slot=idx,
                    tick=self._tick)
                break
        if self._supports_prefill:
            self._g_prefill_ready.set(len(self._prefilled))
        self._set_active_gauge()

    def _harvest(self, finished: List[int]) -> None:
        done_t = time.monotonic()
        for idx in finished:
            req = self._resident[idx]
            if req is None:  # pragma: no cover - defensive
                continue
            res = self._engine.unpack(idx, req.example)
            self._resident[idx] = None
            self._h_resident.observe(self._chunks[idx])
            # exemplar: the landing latency bucket remembers
            # THIS request's trace_id, so a fat p99 bucket on /metrics
            # names a concrete uuid to chase
            self._h_e2e.observe(
                done_t - req.enqueue_t,
                trace_id=req.trace.trace_id if req.trace is not None
                else None)
            self._c_tenant_tokens.labels(
                tenant=req.tenant or "default").inc(
                len(getattr(res, "decoded_words", ()) or ()))
            self._c_done.inc()
            obs.spans.request_event(
                self._reg, "finish", req.trace, req.uuid, slot=idx,
                chunks=self._chunks[idx])
            req.future._resolve(res)
        self._set_active_gauge()

    def _arena_backpressure(self, needed: int, free: int) -> None:
        """Account one admit-blocked-on-pages event: count it, and dump
        the flight ring on the RISING EDGE only (the first blocked tick
        of a full-arena episode is the post-mortem moment — dumping on
        every requeued retry would flood the ring dir with near-
        identical dumps of the same episode)."""
        self._c_arena_fail.inc()
        if not self._arena_blocked:
            self._arena_blocked = True  # tslint: disable=TS009 — single-writer dispatch-thread invariant (see _tick_evictions)
            flightrec.trigger(self._reg, "arena_exhausted",
                              needed=needed, free=free, tick=self._tick,
                              prefilled=len(self._prefilled))
        self._g_prefill_ready.set(len(self._prefilled))

    def _observe_arena(self) -> None:
        """Per-tick arena occupancy series: pages in use and
        the fill fraction — host counters off the engine's arena
        surface, no device sync."""
        if not self._supports_arena:
            return
        stats = self._engine.arena_stats()
        if not stats:
            return
        self._g_arena_pages.set(stats["in_use"])
        self._h_arena_fill.observe(stats["fill"])

    def _record_frame(self, occupancy: float) -> None:
        """One flight-recorder frame per scheduler round (the serve-tick
        analogue of the trainer's per-step frame): what the engine was
        doing on the rounds BEFORE a failure trigger fires."""
        extra = {}
        if self._supports_arena:
            extra["arena_free"] = self._engine.free_pages()
        flightrec.record(
            self._reg, "serve_tick", tick=self._tick,
            occupancy=round(occupancy, 4), queue_depth=self._q.qsize(),
            evictions=self._tick_evictions, refills=self._tick_refills,
            prefilled=len(self._prefilled), **extra)

    def tick(self, poll: float = 0.05) -> bool:
        """One scheduler round: evict -> refill -> step -> harvest.
        Returns False when the engine stayed idle (nothing resident and
        nothing arrived within `poll`) so the caller's loop can re-check
        its stop flag without spinning."""
        self._tick += 1  # tslint: disable=TS009 — single-writer dispatch-thread invariant (see _tick_evictions)
        self._tick_evictions = 0
        self._tick_refills = 0
        # the per-tick wall bracket (obs/profile.py) closes
        # only on busy ticks: an idle tick blocks up to `poll` seconds
        # inside the queue poll, and that wait is idleness, not an
        # attributable phase — counting it would sink the coverage
        # ratio without naming a phase to fix
        w0 = self._prof.start()
        t0 = self._prof.start()
        self._evict_expired()
        self._prof.end("serve/evict", t0)
        self._prefill_stage(poll)
        self._refill(poll)
        if not self.busy():
            return False
        # the frame lands BEFORE the chunk dispatch, so a failing tick
        # contributes its own pre-failure frame (refill/evict state) and
        # the dump holds everything strictly preceding the trigger
        n_active = sum(r is not None for r in self._resident)
        self._observe_arena()
        self._record_frame(n_active / self.slots)
        t0 = self._prof.start()
        with obs.spans.span(
                self._reg, "serve/dispatch",
                fill=n_active, tick=self._tick):
            if self._faults is not None and self._faults.fire(
                    "serve.dispatch"):
                raise RuntimeError("injected serve.dispatch fault")
            finished = self._engine.step()
        dt = self._prof.end("serve/dispatch", t0)
        # the sentinel: each chunk's achieved rate against the chunk's
        # price and its warm baseline
        self._prof.observe_dispatch("serve/dispatch", self._dispatch_key, dt)
        self._h_occupancy.observe(n_active / self.slots)
        for idx, req in enumerate(self._resident):
            if req is not None:
                self._chunks[idx] += 1
        t0 = self._prof.start()
        self._harvest(finished)
        self._prof.end("serve/harvest", t0)
        self._prof.end_wall("serve/tick", w0)
        return True

    def fail_resident(self, error: BaseException) -> int:
        """Reject EVERY resident request with `error` and free its slot
        (the continuous analogue of the micro-batch 'a failed dispatch
        fails its batch only'); returns the count rejected.  The engine
        keeps its (masked-out) state; the next pack overwrites it.
        Prefilled-but-unslotted requests are NOT part of the failing
        dispatch and stay queued for the next tick."""
        n = 0
        for idx, req in enumerate(self._resident):
            if req is None:
                continue
            self._engine.release(idx)
            self._resident[idx] = None
            req.future._reject(error)
            n += 1
        self._c_errors.inc(n)
        self._set_active_gauge()
        return n

    def fail_pending(self, error: BaseException) -> int:
        """Reject every PREFILLED-but-unslotted request with `error` —
        the shutdown backstop: if the dispatch thread dies with entries
        still in the prefill queue, their futures must not hang (the
        exactly-once contract).  Normal drains never get here: refill
        empties the prefill queue into free slots before the loop can
        observe an idle engine."""
        n = 0
        while self._prefilled:
            req, _ = self._prefilled.popleft()
            req.future._reject(error)
            n += 1
        if n:
            self._c_errors.inc(n)
            self._g_prefill_ready.set(0)
        return n
