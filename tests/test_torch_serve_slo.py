"""The SERVE_SLO.json fleet, front-door fleet, process-fleet and
hierarchical gates on the port.

The JAX package's gates (tests/test_serve_slo.py) drive the real router,
servers and summarizer single-threaded on a virtual clock, each replica
over a sim engine.  This file drives the port's the same way, with the
port's own copy of the sim engines and drivers below, and holds each
figure against the JAX package's on the same scenario (the steady and
rolling-swap p99, the hedge wins and rate, the kill's requeues, the
cross-replica dedup, the fan-out makespan, the append dedup, the frame
and scrape bytes) and against the thresholds committed in
SERVE_SLO.json, which stays as it is.
"""

import json
import os
import random

import pytest

import test_serve_slo as jax_slo
from textsummarization_on_flink_tpu import obs as jax_obs
from textsummarization_on_flink_tpu.obs import http as jax_http
from textsummarization_on_flink_tpu.resilience.policy import (
    CircuitBreaker as JaxCircuitBreaker,
)
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode.decoder import DecodedResult
from textsummarization_on_flink_tpu_torch.obs import Registry
from textsummarization_on_flink_tpu_torch.serve.server import ServingServer

SLO_PATH = os.path.join(os.path.dirname(__file__), "..", "SERVE_SLO.json")

WORDS = ["w"]


@pytest.fixture(scope="module")
def slo():
    with open(SLO_PATH) as f:
        return json.load(f)


# -- the port's copy of the virtual-time harness ---------------------------

def _steps_for(example, wl) -> int:
    """The virtual decode cost of one request, derived from its article
    length — the bimodal mix: short articles decode in few steps, long
    ones run to the horizon (the straggler)."""
    short = example.enc_len <= wl["short_words"]
    return wl["short_steps"] if short else wl["long_steps"]


class _NullDecoder:
    """Continuous mode drives the engine, not the decoder; only the
    between-chunk hot-swap hook is ever called."""

    def maybe_reload_checkpoint(self, last):
        return last


class SimEngine:
    """SlotDecodeEngine protocol over virtual time: each step() advances
    the shared clock by chunk * step_cost and every active slot by
    `chunk` steps.  Records each request's RESOLVE time on the virtual
    clock at unpack — enqueue is t=0 by construction (all requests are
    queued before the dispatch thread starts)."""

    def __init__(self, wl):
        self.slots = wl["slots"]
        self.chunk = wl["chunk"]
        self._wl = wl
        self._cost = wl["step_cost_ms"]
        self._remaining = [0] * self.slots
        self._active = [False] * self.slots
        self.vtime = 0.0
        self.vresolve = {}

    def pack(self, idx, example):
        assert not self._active[idx]
        self._active[idx] = True
        self._remaining[idx] = _steps_for(example, self._wl)

    def step(self):
        self.vtime += self.chunk * self._cost
        fin = []
        for i in range(self.slots):
            if self._active[i]:
                self._remaining[i] -= self.chunk
                if self._remaining[i] <= 0:
                    fin.append(i)
        return fin

    def unpack(self, idx, example):
        assert self._active[idx]
        self._active[idx] = False
        self.vresolve[example.uuid] = self.vtime
        return DecodedResult(
            uuid=example.uuid, article=example.original_article,
            decoded_words=["ok", "."], reference=example.reference,
            abstract_sents=[])

    def release(self, idx):
        self._active[idx] = False


def _articles(wl):
    """The seeded bimodal request mix: `requests` articles, every
    `long_every`-th one long, shuffled with the committed seed so the
    arrival order interleaves modes (a straggler lands in most
    micro-batches, like production traffic)."""
    arts = []
    for i in range(wl["requests"]):
        n = wl["long_words"] if i % wl["long_every"] == 0 \
            else wl["short_words"]
        arts.append(" ".join(["w"] * n))
    random.Random(wl["seed"]).shuffle(arts)
    return arts


def _p99(latencies):
    xs = sorted(latencies)
    return xs[min(len(xs) - 1, int(len(xs) * 0.99))]


class _VClock:
    """The fleet's shared virtual clock, advanced by the round driver
    (replicas run concurrently, so ONE advance per round, not one per
    replica tick)."""

    def __init__(self):
        self.ms = 0.0

    def now(self) -> float:  # seconds, the router's clock unit
        return self.ms / 1000.0


class FleetSimEngine:
    """SlotDecodeEngine-protocol sim over the SHARED fleet clock.
    ``speed`` < 1 models a degraded replica (the hedge scenario's
    straggler source): its residents advance speed * chunk steps per
    round while healthy neighbors advance the full chunk."""

    def __init__(self, wl, vclock, speed: float = 1.0):
        self.slots = wl["slots"]
        self.chunk = wl["chunk"]
        self.speed = speed
        self._wl = wl
        self._vclock = vclock
        self._remaining = [0.0] * self.slots
        self._active = [False] * self.slots
        self.vresolve = {}

    def pack(self, idx, example):
        assert not self._active[idx]
        self._active[idx] = True
        self._remaining[idx] = _steps_for(example, self._wl)

    def step(self):
        fin = []
        for i in range(self.slots):
            if self._active[i]:
                self._remaining[i] -= self.chunk * self.speed
                if self._remaining[i] <= 0:
                    fin.append(i)
        return fin

    def unpack(self, idx, example):
        assert self._active[idx]
        self._active[idx] = False
        # first-wins: a hedged uuid may unpack on two replicas; the
        # caller observed the EARLIER one
        prev = self.vresolve.get(example.uuid)
        if prev is None or self._vclock.ms < prev:
            self.vresolve[example.uuid] = self._vclock.ms
        return DecodedResult(
            uuid=example.uuid, article=example.original_article,
            decoded_words=["ok", "."], reference=example.reference,
            abstract_sents=[])

    def release(self, idx):
        self._active[idx] = False


def _run_fleet(slo, swap: bool = False, kill: bool = False,
               slow: bool = False):
    """Drive the committed fleet workload through the REAL router;
    returns (per-uuid virtual resolve times, fleet registry, captured
    request events, results)."""
    from textsummarization_on_flink_tpu_torch.obs.export import MemorySink
    from textsummarization_on_flink_tpu_torch.serve.fleet import FleetRouter

    wl = slo["fleet"]["workload"]
    vocab = Vocab(words=WORDS)
    vclock = _VClock()
    hps = HParams(
        device="cpu", mode="decode", batch_size=wl["slots"], vocab_size=vocab.size(),
        max_enc_steps=wl["long_words"], max_dec_steps=wl["long_steps"],
        beam_size=2, min_dec_steps=1, max_oov_buckets=4,
        serve_max_queue=max(4 * wl["requests"], 64),
        serve_mode="continuous", serve_slots=wl["slots"],
        serve_refill_chunk=wl["chunk"],
        serve_hedge_ms=wl["hedge_ms"],
        serve_hedge_max_ratio=wl["hedge_max_ratio"])
    fleet_reg = Registry()
    sink = MemorySink()
    fleet_reg.event_sink = sink
    servers, engines = [], []
    for r in range(wl["replicas"]):
        eng = FleetSimEngine(
            wl, vclock,
            speed=wl["slow_factor"] if (slow and r == 0) else 1.0)
        servers.append(ServingServer(
            hps, vocab, decoder=_NullDecoder(), engine=eng,
            registry=Registry()))
        engines.append(eng)
    router = FleetRouter(servers, hps, registry=fleet_reg,
                         clock=vclock.now)
    arts = _articles({**slo["workload"], **wl})
    futs, i, rounds = [], 0, 0
    while True:
        rounds += 1
        assert rounds < 5000, "fleet virtual run did not converge"
        for _ in range(wl["arrive_per_round"]):
            if i < len(arts):
                futs.append(router.submit(arts[i], uuid=f"u{i}"))
                i += 1
        if kill and rounds == wl["kill_round"]:
            alive = [h for h in router.replicas() if not h.killed]
            victim = max(alive, key=lambda h: h.load())
            assert victim.server.load() > 0, \
                "kill scenario must catch the victim mid-decode"
            router.kill_replica(victim.rid)
        if swap and rounds == wl["swap_start_round"] \
                and not router.swap_active() \
                and not fleet_reg.counter("serve/fleet_swaps_total").value:
            router.start_rolling_swap()
        router.tick()
        for srv, h in zip(servers, router.replicas()):
            if not h.killed:
                srv.tick_once(poll=0.0)
        vclock.ms += wl["chunk"] * wl["step_cost_ms"]
        if i >= len(arts) and all(f.done() for f in futs) \
                and not router.swap_active():
            break
    results = [f.result(timeout=0) for f in futs]
    router.stop()
    # exactly-once, fleet-level: one result per admitted uuid, in order
    assert [r.uuid for r in results] == \
        [f"u{k}" for k in range(wl["requests"])]
    resolve = {}
    for eng in engines:
        for u, t in eng.vresolve.items():
            resolve[u] = min(resolve.get(u, t), t)
    assert set(resolve) == {f"u{k}" for k in range(wl["requests"])}
    events = [r for r in sink.records() if r.get("kind") == "request"]
    return resolve, fleet_reg, events, results


def _zipf_indices(n: int, pool: int, s: float, seed: int):
    """Deterministic zipf-ish draw: p(k) ~ 1/(k+1)^s over `pool` ranks
    (inverse-CDF over a seeded uniform stream — no numpy, exactly
    replayable)."""
    weights = [1.0 / (k + 1) ** s for k in range(pool)]
    total = sum(weights)
    r = random.Random(seed)
    out = []
    for _ in range(n):
        x = r.random() * total
        acc = 0.0
        pick = pool - 1
        for k, w in enumerate(weights):
            acc += w
            if x <= acc:
                pick = k
                break
        out.append(pick)
    return out


def _door_articles(wl):
    """The zipf article pool: `pool` DISTINCT articles (distinct lead
    token -> distinct content hash), every long_every-th one long."""
    arts = []
    for k in range(wl["pool"]):
        n = wl["long_words"] if k % wl["long_every"] == 0 \
            else wl["short_words"]
        arts.append(f"a{k} " + " ".join(["w"] * (n - 1)))
    return arts


class CountingSimEngine(SimEngine):
    """SimEngine + the decode count the front-door ratio gates on
    (packs == decodes actually served by the engine)."""

    def __init__(self, wl):
        super().__init__(wl)
        self.pack_count = 0

    def pack(self, idx, example):
        super().pack(idx, example)
        self.pack_count += 1


class CountingFleetSimEngine(FleetSimEngine):
    """FleetSimEngine + pack counting for the fleet front-door ratio."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.pack_count = 0

    def pack(self, idx, example):
        super().pack(idx, example)
        self.pack_count += 1


def _run_fleet_door(slo, kill: bool):
    """The zipf mix through the REAL FleetRouter with the front door
    armed at the ROUTER (replica doors disarmed by construction) —
    coalescing dedups ACROSS replicas, and a replica killed mid-
    coalesced-flight requeues the LEADER while every attached follower
    still resolves exactly once from whichever replica wins."""
    from textsummarization_on_flink_tpu_torch.serve.fleet import FleetRouter

    wl = {**slo["fleet"]["workload"], **slo["front_door"]["fleet"]}
    vocab = Vocab(words=WORDS)
    vclock = _VClock()
    hps = HParams(
        device="cpu", mode="decode", batch_size=wl["slots"], vocab_size=vocab.size(),
        max_enc_steps=wl["long_words"], max_dec_steps=wl["long_steps"],
        beam_size=2, min_dec_steps=1, max_oov_buckets=4,
        serve_max_queue=max(4 * wl["requests"], 64),
        serve_mode="continuous", serve_slots=wl["slots"],
        serve_refill_chunk=wl["chunk"],
        serve_hedge_ms=wl["hedge_ms"],
        serve_hedge_max_ratio=wl["hedge_max_ratio"],
        serve_coalesce=True, serve_cache_entries=wl["cache_entries"])
    fleet_reg = Registry()
    servers, engines = [], []
    for _ in range(wl["replicas"]):
        eng = CountingFleetSimEngine(wl, vclock)
        servers.append(ServingServer(
            hps, vocab, decoder=_NullDecoder(), engine=eng,
            registry=Registry()))
        engines.append(eng)
    router = FleetRouter(servers, hps, registry=fleet_reg,
                         clock=vclock.now)
    arts = _door_articles(wl)
    order = _zipf_indices(wl["requests"], wl["pool"], wl["zipf_s"],
                          wl["seed"])
    futs, i, rounds = [], 0, 0
    while True:
        rounds += 1
        assert rounds < 5000, "fleet front-door run did not converge"
        for _ in range(wl["arrive_per_round"]):
            if i < len(order):
                futs.append(router.submit(arts[order[i]], uuid=f"u{i}"))
                i += 1
        if kill and rounds == wl["kill_round"]:
            alive = [h for h in router.replicas() if not h.killed]
            victim = max(alive, key=lambda h: h.load())
            assert victim.server.load() > 0, \
                "kill must catch the victim mid-decode"
            router.kill_replica(victim.rid)
        router.tick()
        for srv, h in zip(servers, router.replicas()):
            if not h.killed:
                srv.tick_once(poll=0.0)
        vclock.ms += wl["chunk"] * wl["step_cost_ms"]
        if i >= len(order) and all(f.done() for f in futs):
            break
    results = [f.result(timeout=0) for f in futs]
    router.stop()
    # fleet-level exactly-once: one RESULT per submitted uuid —
    # leaders, followers, and cache hits alike, kill or no kill
    assert [r.uuid for r in results] == \
        [f"u{k}" for k in range(wl["requests"])]
    decodes = sum(e.pack_count for e in engines)
    return results, fleet_reg, decodes, order


def _proc_fleet_requests(wl):
    def words(n, tag):
        return " ".join(f"{tag}{i}" for i in range(n)) + " ."

    reqs = []
    for i in range(wl["requests"]):
        long = (i % wl["long_every"]) == wl["long_every"] - 1
        art = words(wl["long_words"] if long else wl["short_words"], "w")
        reqs.append((f"uuid-{i:04d}", art, f"reference {i} ."))
    return reqs, words(wl["summary_words"], "s")


def _hier_workload(slo):
    return {**slo["workload"], **slo["hierarchical"]["workload"]}


def _hier_doc(wl):
    """One doc exactly doc_chunks wide whose words are all DISTINCT
    (w0, w1, ...): distinct chunk content -> distinct article_key per
    chunk, so nothing coalesces WITHIN the first pass and the append
    pins measure the front door's dedup, not accidental twins.  The doc
    ends exactly on a chunk boundary (len = chunk + (n-1)*stride), so
    appending leaves every pre-append chunk byte-identical."""
    stride = wl["chunk_words"] - wl["overlap_words"]
    n_words = wl["chunk_words"] + (wl["doc_chunks"] - 1) * stride
    doc = " ".join(f"w{i}" for i in range(n_words))
    tail = " ".join(f"w{n_words + i}"
                    for i in range(wl["append_chunks"] * stride))
    return doc, tail


def _run_hier(slo, slots: int, append: bool):
    """Fan one document through a real continuous server with `slots`
    slots (slots=1 is the sequential baseline); optionally append and
    re-summarize on the warm server.  Returns the measured scheduling
    facts."""
    from textsummarization_on_flink_tpu_torch.serve.hiersum import (
        DocumentSession,
        HierarchicalSummarizer,
    )

    wl = _hier_workload(slo)
    vocab = Vocab(words=WORDS)
    hps = HParams(
        device="cpu", mode="decode", batch_size=slots, vocab_size=vocab.size(),
        max_enc_steps=wl["chunk_words"], max_dec_steps=wl["long_steps"],
        beam_size=2, min_dec_steps=1, max_oov_buckets=4,
        serve_max_queue=256, serve_mode="continuous", serve_slots=slots,
        serve_refill_chunk=wl["chunk"], serve_coalesce=True,
        serve_cache_entries=wl["cache_entries"],
        hier_chunk_words=wl["chunk_words"],
        hier_overlap_words=wl["overlap_words"])
    doc, tail = _hier_doc(wl)
    out = {}
    with obs.use_registry(Registry()) as reg:
        sim = CountingSimEngine({**wl, "slots": slots})
        server = ServingServer(hps, vocab, decoder=_NullDecoder(),
                               engine=sim, registry=reg)
        hs = HierarchicalSummarizer(server, hps, registry=reg)
        sess = DocumentSession("doc", doc)
        marks = {}
        # enqueue the whole fan-out BEFORE the dispatch thread starts
        # (the committed discipline: slot assignment is pure FIFO)
        fut = hs.summarize("", session=sess)
        fut.add_done_callback(lambda f: marks.setdefault("fan", sim.vtime))
        server.start()
        res = fut.result(timeout=120)
        assert res.chunk_count == wl["doc_chunks"]
        out["fan_makespan"] = marks["fan"]
        out["fan_decodes"] = sim.pack_count
        if append:
            hits0 = reg.counter("serve/cache_hits_total").value
            packs0 = sim.pack_count
            t0 = sim.vtime  # idle ticks never step the engine
            sess.append(tail)
            fut2 = hs.summarize("", session=sess)
            fut2.add_done_callback(
                lambda f: marks.setdefault("app", sim.vtime))
            res2 = fut2.result(timeout=120)
            out["append_makespan"] = marks["app"] - t0
            out["append_hits"] = \
                reg.counter("serve/cache_hits_total").value - hits0
            out["append_decodes"] = sim.pack_count - packs0
            out["append_reused"] = res2.reused_chunks
            out["append_chunk_count"] = res2.chunk_count
            out["documents"] = \
                reg.counter("serve/hier_documents_total").value
            out["reduces"] = reg.counter("serve/hier_reduce_total").value
            out["partials"] = \
                reg.counter("serve/hier_partial_failures_total").value
        server.stop()
    return out


# -- the fleet --------------------------------------------------------------

FLEET_RUNS = {"steady": {}, "swap": {"swap": True}, "kill": {"kill": True},
              "hedge": {"slow": True}}
FLEET_COUNTERS = ("serve/fleet_submitted_total", "serve/hedges_total",
                  "serve/hedge_wins_total", "serve/hedge_suppressed_total",
                  "serve/requeued_total", "serve/replica_kills_total",
                  "serve/fleet_swaps_total")


def _fleet_figures(run):
    resolve, reg, events, results = run
    return dict(
        resolve=dict(resolve),
        counters={c: reg.counter(c).value for c in FLEET_COUNTERS},
        requeued=[(e["uuid"], e["attrs"]["from_replica"],
                   e["attrs"]["to_replica"], e["attrs"]["cause"])
                  for e in events if e.get("event") == "requeued"],
        uuids=[r.uuid for r in results])


@pytest.fixture(scope="module")
def fleet_runs(slo):
    return {name: (_fleet_figures(_run_fleet(slo, **kw)),
                   _fleet_figures(jax_slo._run_fleet(slo, **kw)))
            for name, kw in FLEET_RUNS.items()}


@pytest.mark.parametrize("name", sorted(FLEET_RUNS))
def test_fleet_figures_equal_jax(fleet_runs, name):
    """Every request's virtual resolve time, the fleet counters, the
    requeue tags and the result order are the JAX router's."""
    got, want = fleet_runs[name]
    assert got == want


def test_fleet_steady_p99_within_committed_ceiling(slo, fleet_runs):
    p99 = _p99(fleet_runs["steady"][0]["resolve"].values())
    assert p99 <= slo["fleet"]["steady_p99_virtual_ms_max"]


def test_fleet_rolling_swap_p99_within_committed_ratio(slo, fleet_runs):
    steady = _p99(fleet_runs["steady"][0]["resolve"].values())
    swap = _p99(fleet_runs["swap"][0]["resolve"].values())
    assert swap / steady <= slo["fleet"]["swap_p99_ratio_max"]
    assert fleet_runs["swap"][0]["counters"]["serve/fleet_swaps_total"] \
        == slo["fleet"]["swap_count_expected"]


def test_fleet_hedge_wins_counted_and_rate_capped(slo, fleet_runs):
    c = fleet_runs["hedge"][0]["counters"]
    wins, hedges = c["serve/hedge_wins_total"], c["serve/hedges_total"]
    assert wins >= slo["fleet"]["hedge_wins_min"]
    assert hedges >= wins
    assert hedges / c["serve/fleet_submitted_total"] <= \
        slo["fleet"]["hedge_rate_max"]


def test_fleet_replica_kill_exactly_once_with_requeue(slo, fleet_runs):
    got = fleet_runs["kill"][0]
    n = slo["fleet"]["workload"]["requests"]
    assert got["counters"]["serve/replica_kills_total"] == 1
    requeued = got["counters"]["serve/requeued_total"]
    assert requeued >= slo["fleet"]["kill_requeued_min"]
    assert len(got["requeued"]) == int(requeued)
    for _, src, dst, cause in got["requeued"]:
        assert src != dst and cause == "ReplicaKilledError"
    assert got["uuids"] == [f"u{k}" for k in range(n)]


# -- the front door at the router -------------------------------------------

@pytest.fixture(scope="module")
def fleet_door_runs(slo):
    out = {}
    for kill in (False, True):
        mine = _run_fleet_door(slo, kill=kill)
        theirs = jax_slo._run_fleet_door(slo, kill=kill)
        out[kill] = [
            dict(decodes=r[2], order=r[3],
                 uuids=[x.uuid for x in r[0]],
                 counters={c: r[1].counter(c).value for c in (
                     "serve/coalesced_total", "serve/cache_hits_total",
                     "serve/requeued_total", "serve/replica_kills_total")})
            for r in (mine, theirs)]
    return out


@pytest.mark.parametrize("kill", [False, True])
def test_fleet_front_door_figures_equal_jax(fleet_door_runs, kill):
    got, want = fleet_door_runs[kill]
    assert got == want


def test_fleet_front_door_dedups_across_replicas(slo, fleet_door_runs):
    m = fleet_door_runs[False][0]
    ratio = m["decodes"] / len(m["order"])
    assert ratio <= slo["front_door"]["fleet"]["decodes_per_submit_max"]
    c = m["counters"]
    assert c["serve/coalesced_total"] + c["serve/cache_hits_total"] >= \
        len(m["order"]) - m["decodes"]


def test_fleet_front_door_kill_keeps_followers_exactly_once(
        fleet_door_runs):
    m = fleet_door_runs[True][0]
    c = m["counters"]
    assert c["serve/replica_kills_total"] == 1
    assert c["serve/requeued_total"] >= 1
    assert c["serve/coalesced_total"] >= 1
    assert len(set(m["uuids"])) == len(m["order"])


# -- the process fleet's byte budgets ---------------------------------------

def _proc_frames(wl, Message, hub):
    reqs, summary = _proc_fleet_requests(wl)
    ingress = [len(Message(u, a, r).to_json().encode()) + 1
               for u, a, r in reqs]
    for u, a, r in reqs:
        hub.publish(Message(u, a, summary=summary, reference=r))
    hub.close()
    reply = [len(frame.encode()) + 1 for frame in hub.stream(0)]
    payload = [len(u) + len(a) + len(summary) + len(r) for u, a, r in reqs]
    return {"ingress": ingress, "reply": reply, "payload": payload}


@pytest.fixture(scope="module")
def proc_fleet_measured(slo):
    from textsummarization_on_flink_tpu.pipeline.io import Message as JMsg
    from textsummarization_on_flink_tpu.serve import procfleet as jpf
    from textsummarization_on_flink_tpu_torch.pipeline.io import Message
    from textsummarization_on_flink_tpu_torch.serve import procfleet

    wl = slo["process_fleet"]["workload"]
    return (_proc_frames(wl, Message, procfleet._ReplyHub()),
            _proc_frames(wl, JMsg, jpf._ReplyHub()))


def test_proc_fleet_frames_byte_equal_jax(proc_fleet_measured):
    got, want = proc_fleet_measured
    assert got == want


def test_proc_fleet_frame_bytes_under_ceilings(slo, proc_fleet_measured):
    sec, m = slo["process_fleet"], proc_fleet_measured[0]
    per_req = [i + r for i, r in zip(m["ingress"], m["reply"])]
    assert max(m["ingress"]) <= sec["ingress_frame_bytes_max"]
    assert max(m["reply"]) <= sec["reply_frame_bytes_max"]
    assert max(per_req) <= sec["wire_bytes_per_request_max"]
    envelope = [i + r - p for i, r, p in
                zip(m["ingress"], m["reply"], m["payload"])]
    assert max(envelope) <= sec["envelope_overhead_bytes_max"]


def _scrape_payload(reg, http, Breaker):
    reg.replica_id = "p0"
    for name in ("serve.admission", "serve.replica.p0", "io.source"):
        Breaker(threshold=2, name=name, registry=reg).allow()
    for comp in ("serve.engine", "serve.dispatch", "obs.flush"):
        http.heartbeat(reg, comp)
    reg.gauge("serve/queue_depth").set(3)
    return http.health(reg)


def test_proc_fleet_scrape_bandwidth_equals_jax_under_ceiling(slo):
    """The /healthz payload a supervisor scrapes, priced at the
    serve_scrape_interval_ms cadence: the port's is the JAX package's,
    key for key, but for the clock fields."""
    from textsummarization_on_flink_tpu_torch.obs import http as obs_http
    from textsummarization_on_flink_tpu_torch.resilience.policy import (
        CircuitBreaker,
    )

    got = _scrape_payload(Registry(), obs_http, CircuitBreaker)
    want = _scrape_payload(jax_obs.Registry(), jax_http, JaxCircuitBreaker)
    assert got["pid"] == os.getpid() and got["replica_id"] == "p0"
    assert got["start_time"] > 0
    # the process identity and the heartbeat ages are this process's
    # clock; every other field is the JAX payload's
    clock = ("start_time", "uptime_s", "time", "components")
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if k not in clock} == \
        {k: v for k, v in want.items() if k not in clock}
    assert sorted(got["components"]) == sorted(want["components"])
    wl = slo["process_fleet"]["workload"]
    kib_per_s = len(json.dumps(got).encode()) * (
        1000.0 / wl["scrape_interval_ms"]) / 1024.0
    assert kib_per_s <= slo["process_fleet"][
        "scrape_kib_per_replica_per_s_max"]


def test_proc_fleet_reply_ring_covers_inflight_capacity():
    from textsummarization_on_flink_tpu_torch.serve import procfleet

    hps = HParams(mode="decode", batch_size=4, vocab_size=8,
                  max_enc_steps=8, max_dec_steps=4, min_dec_steps=1,
                  beam_size=2, max_oov_buckets=2, serve_max_queue=256,
                  serve_slots=8, device="cpu")
    capacity = hps.serve_max_queue + max(hps.serve_slots,
                                         hps.serve_max_batch, 1)
    assert procfleet._ReplyHub().capacity >= capacity


# -- hierarchical summarization ---------------------------------------------

@pytest.fixture(scope="module")
def hier_runs(slo):
    wl = _hier_workload(slo)
    return {
        "port": {"fan": _run_hier(slo, slots=wl["slots"], append=True),
                 "seq": _run_hier(slo, slots=1, append=False)},
        "jax": {"fan": jax_slo._run_hier(slo, slots=wl["slots"],
                                         append=True),
                "seq": jax_slo._run_hier(slo, slots=1, append=False)},
    }


def test_hier_figures_equal_jax(hier_runs):
    assert hier_runs["port"] == hier_runs["jax"]


def test_hier_fanout_makespan_beats_sequential(slo, hier_runs):
    sec = slo["hierarchical"]
    fan = hier_runs["port"]["fan"]["fan_makespan"]
    seq = hier_runs["port"]["seq"]["fan_makespan"]
    assert fan <= sec["fanout_makespan_virtual_ms_max"]
    assert fan / seq <= sec["fanout_makespan_ratio_max"]


def test_hier_append_dedups_by_construction(slo, hier_runs):
    sec, wl = slo["hierarchical"], _hier_workload(slo)
    m = hier_runs["port"]["fan"]
    assert m["append_hits"] == sec["append_cache_hits_expected"]
    assert m["append_decodes"] == sec["append_decodes_expected"]
    assert m["append_reused"] == wl["doc_chunks"]
    assert m["append_chunk_count"] == wl["doc_chunks"] + wl["append_chunks"]
    assert m["append_makespan"] <= sec["append_makespan_virtual_ms_max"]
    assert (m["documents"], m["reduces"], m["partials"]) == (2, 2, 0)
