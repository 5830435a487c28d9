"""The port's serve layer on the CPU: the JAX package's serve contract
against stub decoders and engines (a copy of tests/test_serve.py's
queue, batcher, server, continuous-scheduler and tracing tests, run on
the port's modules), then the port's ServingServer over a real tiny
pointer-generator against the JAX package's: token-identical summaries
for a pinned group at the beam and greedy tiers, transform(serving=True)
rows, 32 concurrent requests, the front door, deadline degradation and
the refusals that name their ROADMAP items."""

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_parity import WORDS as PARITY_WORDS
from _torch_parity import article, decode_params, make_hps
from textsummarization_on_flink_tpu import config as jax_config
from textsummarization_on_flink_tpu import obs as jax_obs
from textsummarization_on_flink_tpu.checkpoint import (
    checkpointer as jax_ckpt,
)
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.pipeline import estimator as jax_est
from textsummarization_on_flink_tpu.pipeline import io as jax_io
from textsummarization_on_flink_tpu.serve.server import (
    ServingServer as JaxServingServer,
)
from textsummarization_on_flink_tpu.train import trainer as jax_trainer
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.config import HParams, parse_bucket_spec
from textsummarization_on_flink_tpu_torch.data.batching import SummaryExample
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import decoder as dec_lib
from textsummarization_on_flink_tpu_torch.decode.decoder import DecodedResult
from textsummarization_on_flink_tpu_torch.obs import Registry
from textsummarization_on_flink_tpu_torch.obs import profile as profile_lib
from textsummarization_on_flink_tpu_torch.pipeline import estimator as est
from textsummarization_on_flink_tpu_torch.pipeline import io as io_lib
from textsummarization_on_flink_tpu_torch.resilience.errors import (
    DeadlineExceededError,
)
from textsummarization_on_flink_tpu_torch.resilience.policy import (
    CircuitBreaker,
    Deadline,
)
from textsummarization_on_flink_tpu_torch.serve import (
    MicroBatcher,
    RequestQueue,
    ServeClosedError,
    ServeOverloadError,
    ServeRequest,
    resolve_buckets,
)
from textsummarization_on_flink_tpu_torch.serve.queue import ServeFuture
from textsummarization_on_flink_tpu_torch.serve.server import ServingServer

WORDS = ("the a cat dog sat ran mat home big small quick brown fox "
         "jumped over lazy it was day night").split()


@pytest.fixture(autouse=True)
def _isolated_obs():
    with obs.use_registry(Registry()) as reg:
        yield reg


def make_vocab():
    return Vocab(words=WORDS)


def tiny_hps(**kw):
    base = dict(mode="decode", batch_size=4, hidden_dim=8, emb_dim=6,
                vocab_size=24, max_enc_steps=16, max_dec_steps=6,
                beam_size=2, min_dec_steps=1, max_oov_buckets=4,
                serve_max_wait_ms=50.0, serve_max_queue=64, device="cpu")
    base.update(kw)
    return HParams(**base)


def make_request(hps, vocab, uuid="u0", article="the cat sat .", **kw):
    ex = SummaryExample.build(article, [], vocab, hps, uuid=uuid)
    return ServeRequest(uuid, article, "", ex, **kw)


class StubEngine:
    """SlotDecodeEngine-protocol stub (no device): per-request decode
    cost in CHUNKS derived from the example via `chunks_for`, optional
    per-chunk delay — scheduling semantics without a device."""

    def __init__(self, slots=2, chunk=2, chunks_for=None, delay=0.0):
        self.slots = slots
        self.chunk = chunk
        self.delay = delay
        self._chunks_for = chunks_for or (lambda ex: 1)
        self._remaining = [0] * slots
        self._active = [False] * slots
        self.packs = 0
        self.steps = 0

    def pack(self, idx, example):
        assert not self._active[idx], f"slot {idx} double-packed"
        self._active[idx] = True
        self._remaining[idx] = self._chunks_for(example)
        self.packs += 1

    def step(self):
        if self.delay:
            time.sleep(self.delay)
        self.steps += 1
        fin = []
        for i in range(self.slots):
            if self._active[i]:
                self._remaining[i] -= 1
                if self._remaining[i] <= 0:
                    fin.append(i)
        return fin

    def unpack(self, idx, example):
        assert self._active[idx]
        self._active[idx] = False
        return DecodedResult(
            uuid=example.uuid, article=example.original_article,
            decoded_words=["ok", "."], reference=example.reference,
            abstract_sents=[])

    def release(self, idx):
        self._active[idx] = False


class PrefillStubEngine(StubEngine):
    """StubEngine with the disaggregated prefill surface:
    the ContinuousBatcher routes requests through prefill() into its
    ready queue before pack().  `fail_for` injects a prefill failure
    for matching uuids (the blast-radius tests)."""

    class Handle:
        def __init__(self, example, bucket):
            self.example = example
            self.bucket = bucket

    def __init__(self, *args, fail_for=None, **kw):
        super().__init__(*args, **kw)
        self._fail_for = fail_for or (lambda ex: False)
        self.prefills = 0
        self.prefills_before_first_unpack = None
        self.unpacks = 0

    def prefill(self, example):
        if self._fail_for(example):
            raise RuntimeError(f"injected prefill failure for "
                               f"{example.uuid!r}")
        self.prefills += 1
        return self.Handle(example, bucket=example.enc_len)

    def pack(self, idx, handle):
        assert isinstance(handle, self.Handle), \
            "prefill engines must be packed from the prefill queue"
        super().pack(idx, handle.example)

    def unpack(self, idx, example):
        if self.unpacks == 0:
            self.prefills_before_first_unpack = self.prefills
        self.unpacks += 1
        return super().unpack(idx, example)


class StubDecoder:
    """decode_batch-compatible stub: optional per-batch delay, results
    echo the batch's real rows (one per real_mask=True slot).  Mirrors
    the real decoder's tier surface (should_degrade / has_draft /
    decode_batch(tier=)) so the server's per-request re-tiering is
    testable without a model."""

    def __init__(self, delay: float = 0.0, degrade_under: float = 0.0,
                 has_draft: bool = False):
        self.delay = delay
        self.degrade_under = degrade_under
        self.has_draft = has_draft
        self.batches = []
        self.tiers = []  # tier of each dispatched batch, in order
        self.reload_calls = 0

    def should_degrade(self, deadline):
        return bool(
            self.degrade_under and deadline is not None and deadline.bounded
            and deadline.remaining() < self.degrade_under)

    def decode_batch(self, batch, deadline=None, tier=None):
        time.sleep(self.delay)
        self.batches.append(batch)
        self.tiers.append(tier)
        degraded = tier is None and self.should_degrade(deadline)
        return [DecodedResult(
                    uuid=batch.uuids[b], article=batch.original_articles[b],
                    decoded_words=["ok", "."], reference=batch.references[b],
                    abstract_sents=[], degraded=degraded,
                    tier=tier or "beam")
                for b in range(len(batch.uuids)) if batch.real_mask[b]]

    def maybe_reload_checkpoint(self, last):
        self.reload_calls += 1
        return last


# -- buckets ---------------------------------------------------------------

class TestBuckets:
    def test_auto_buckets_reference_scale(self):
        assert parse_bucket_spec("", 400) == [100, 200, 400]

    def test_auto_buckets_tiny_drops_sub64(self):
        # tiny configs get ONE bucket — a 4-token bucket saves nothing
        # and costs a whole extra jit compile
        assert parse_bucket_spec("", 16) == [16]

    def test_explicit_spec_appends_max(self):
        assert parse_bucket_spec("8,4", 16) == [4, 8, 16]

    def test_bad_specs_raise(self):
        with pytest.raises(ValueError, match="not an integer"):
            parse_bucket_spec("8,x", 16)
        with pytest.raises(ValueError, match="exceeds max_enc_steps"):
            parse_bucket_spec("32", 16)
        with pytest.raises(ValueError, match=">= 1"):
            parse_bucket_spec("0", 16)

    def test_bucket_for_picks_smallest_cover(self, _isolated_obs):
        hps = tiny_hps(serve_buckets="4,8,16")
        q = RequestQueue(8)
        mb = MicroBatcher(hps, make_vocab(), q)
        assert mb.bucket_for(1) == 4
        assert mb.bucket_for(4) == 4
        assert mb.bucket_for(5) == 8
        assert mb.bucket_for(16) == 16

    def test_resolve_buckets_from_hps(self):
        assert resolve_buckets(tiny_hps(serve_buckets="8")) == [8, 16]


# -- futures ---------------------------------------------------------------

class TestServeFuture:
    def test_result_blocks_then_returns(self):
        fut = ServeFuture("u1")
        threading.Timer(0.05, lambda: fut._resolve("ok")).start()
        assert fut.result(timeout=5.0) == "ok"
        assert fut.done()

    def test_reject_reraises(self):
        fut = ServeFuture("u1")
        fut._reject(ValueError("boom"))
        with pytest.raises(ValueError, match="boom"):
            fut.result(timeout=0.1)
        assert fut.error is not None

    def test_resolves_exactly_once(self):
        fut = ServeFuture("u1")
        fut._resolve("ok")
        with pytest.raises(AssertionError, match="twice"):
            fut._resolve("again")
        with pytest.raises(AssertionError, match="twice"):
            fut._reject(ValueError("late"))

    def test_timeout_raises(self):
        with pytest.raises(TimeoutError):
            ServeFuture("u1").result(timeout=0.01)

    def test_callback_after_done_runs_immediately(self):
        fut = ServeFuture("u1")
        seen = []
        fut.add_done_callback(lambda f: seen.append(("pre", f.error)))
        fut._resolve("ok")
        fut.add_done_callback(lambda f: seen.append(("post", f.error)))
        assert seen == [("pre", None), ("post", None)]

    def test_callback_error_counted_not_fatal(self, _isolated_obs):
        fut = ServeFuture("u1", registry=_isolated_obs)

        def bad(_f):
            raise RuntimeError("sink died")

        fut.add_done_callback(bad)
        fut._resolve("ok")  # must not raise
        assert _isolated_obs.counter(
            "serve/callback_errors_total").value == 1


# -- queue / admission -----------------------------------------------------

class TestRequestQueue:
    def test_full_queue_rejects_typed(self, _isolated_obs):
        hps, vocab = tiny_hps(), make_vocab()
        q = RequestQueue(2, registry=_isolated_obs)
        q.submit(make_request(hps, vocab, "a"))
        q.submit(make_request(hps, vocab, "b"))
        with pytest.raises(ServeOverloadError, match="queue full"):
            q.submit(make_request(hps, vocab, "c"))
        assert _isolated_obs.counter("serve/shed_total").value == 1
        assert _isolated_obs.counter("serve/submitted_total").value == 2

    def test_breaker_opens_under_sustained_overload(self, _isolated_obs):
        hps, vocab = tiny_hps(), make_vocab()
        clock = [0.0]
        breaker = CircuitBreaker(threshold=3, reset_secs=30.0,
                                 name="serve.admission",
                                 clock=lambda: clock[0],
                                 registry=_isolated_obs)
        q = RequestQueue(1, breaker=breaker, registry=_isolated_obs)
        q.submit(make_request(hps, vocab, "a"))
        for i in range(3):  # 3 consecutive rejects trip the breaker
            with pytest.raises(ServeOverloadError):
                q.submit(make_request(hps, vocab, f"r{i}"))
        assert breaker.state == CircuitBreaker.OPEN
        # open breaker sheds BEFORE touching the queue — even though
        # space exists now
        assert q.get(timeout=0.1) is not None
        with pytest.raises(ServeOverloadError, match="breaker open"):
            q.submit(make_request(hps, vocab, "x"))
        # reset window elapses: the half-open probe admission heals it
        clock[0] = 31.0
        q.submit(make_request(hps, vocab, "y"))
        assert breaker.state == CircuitBreaker.CLOSED

    def test_blocking_submit_backpressures(self, _isolated_obs):
        hps, vocab = tiny_hps(), make_vocab()
        q = RequestQueue(1, registry=_isolated_obs)
        q.submit(make_request(hps, vocab, "a"))
        threading.Timer(0.05, q.get).start()
        t0 = time.monotonic()
        q.submit(make_request(hps, vocab, "b"), block=True, timeout=5.0)
        assert time.monotonic() - t0 < 5.0  # waited for space, not full 5s
        with pytest.raises(ServeOverloadError):
            q.submit(make_request(hps, vocab, "c"), block=True, timeout=0.05)

    def test_closed_queue_refuses(self, _isolated_obs):
        hps, vocab = tiny_hps(), make_vocab()
        q = RequestQueue(4, registry=_isolated_obs)
        q.close()
        with pytest.raises(ServeClosedError):
            q.submit(make_request(hps, vocab, "a"))

    def test_drain_reject_resolves_pending(self, _isolated_obs):
        hps, vocab = tiny_hps(), make_vocab()
        q = RequestQueue(4, registry=_isolated_obs)
        reqs = [make_request(hps, vocab, f"u{i}") for i in range(3)]
        for r in reqs:
            q.submit(r)
        assert q.drain_reject(ServeClosedError("stopping")) == 3
        for r in reqs:
            with pytest.raises(ServeClosedError):
                r.future.result(timeout=0.1)


# -- micro-batcher ---------------------------------------------------------

class TestMicroBatcher:
    def test_coalesces_up_to_max_batch(self, _isolated_obs):
        hps, vocab = tiny_hps(serve_max_wait_ms=200.0), make_vocab()
        q = RequestQueue(16, registry=_isolated_obs)
        for i in range(6):
            q.submit(make_request(hps, vocab, f"u{i}"))
        mb = MicroBatcher(hps, vocab, q, registry=_isolated_obs)
        g1 = mb.next_group()
        g2 = mb.next_group()
        assert [r.uuid for r in g1] == ["u0", "u1", "u2", "u3"]
        assert [r.uuid for r in g2] == ["u4", "u5"]
        assert mb.next_group(poll=0.01) is None  # idle

    def test_serve_max_batch_caps_below_batch_size(self, _isolated_obs):
        hps, vocab = tiny_hps(serve_max_batch=2), make_vocab()
        q = RequestQueue(16, registry=_isolated_obs)
        for i in range(4):
            q.submit(make_request(hps, vocab, f"u{i}"))
        mb = MicroBatcher(hps, vocab, q, registry=_isolated_obs)
        assert len(mb.next_group()) == 2

    def test_window_ships_partial_batch(self, _isolated_obs):
        hps, vocab = tiny_hps(serve_max_wait_ms=30.0), make_vocab()
        q = RequestQueue(16, registry=_isolated_obs)
        q.submit(make_request(hps, vocab, "only"))
        mb = MicroBatcher(hps, vocab, q, registry=_isolated_obs)
        t0 = time.monotonic()
        group = mb.next_group()
        dt = time.monotonic() - t0
        assert [r.uuid for r in group] == ["only"]
        assert dt < 5.0  # waited ~the window, not forever

    def test_build_pads_batch_and_bucket(self, _isolated_obs):
        hps, vocab = tiny_hps(serve_buckets="4,8,16"), make_vocab()
        q = RequestQueue(16, registry=_isolated_obs)
        mb = MicroBatcher(hps, vocab, q, registry=_isolated_obs)
        reqs = [make_request(hps, vocab, "a", article="the cat sat ."),
                make_request(hps, vocab, "b",
                             article="the quick brown fox ran over it")]
        batch = mb.build(reqs)
        # batch axis padded to batch_size, encoder axis to the 8-bucket
        # (longest article = 7 tokens)
        assert batch.enc_batch.shape == (4, 8)
        assert batch.real_mask == [True, True, False, False]
        assert batch.uuids[:2] == ["a", "b"]
        assert _isolated_obs.counter("serve/pad_rows_total").value == 2
        fill = _isolated_obs.histogram("serve/batch_fill")
        assert fill.count == 1 and fill.mean == 2.0


# -- server (stub decoder: queue/dispatch semantics, no model) ---------------

class TestServingServerStub:
    def test_requests_resolve_with_own_uuid(self, _isolated_obs):
        hps, vocab = tiny_hps(), make_vocab()
        server = ServingServer(hps, vocab, decoder=StubDecoder(0.01),
                               registry=_isolated_obs)
        with server:
            futs = [server.submit("the cat sat .", uuid=f"u{i}")
                    for i in range(10)]
            results = [f.result(timeout=30) for f in futs]
        assert [r.uuid for r in results] == [f"u{i}" for i in range(10)]
        assert _isolated_obs.counter("serve/completed_total").value == 10

    def test_each_dispatch_lands_in_the_phase_ledger(self, _isolated_obs):
        """One serve/dispatch phase per micro-batch dispatch, on
        /profile's table."""
        hps, vocab = tiny_hps(), make_vocab()
        decoder = StubDecoder(0.01)
        server = ServingServer(hps, vocab, decoder=decoder,
                               registry=_isolated_obs)
        with server:
            for f in [server.submit("the cat sat .", uuid=f"u{i}")
                      for i in range(6)]:
                f.result(timeout=30)
        body = profile_lib.profile_payload(_isolated_obs)
        assert body["installed"]
        row, = [p for p in body["phases"] if p["phase"] == "serve/dispatch"]
        assert row["count"] == len(decoder.batches) > 0
        assert row["max_s"] >= 0.01

    def test_submit_after_stop_raises_closed(self, _isolated_obs):
        hps, vocab = tiny_hps(), make_vocab()
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               registry=_isolated_obs)
        server.start()
        server.stop()
        with pytest.raises(ServeClosedError):
            server.submit("the cat .")

    def test_stop_drains_admitted_requests(self, _isolated_obs):
        hps, vocab = tiny_hps(serve_max_wait_ms=5.0), make_vocab()
        server = ServingServer(hps, vocab, decoder=StubDecoder(0.02),
                               registry=_isolated_obs)
        server.start()
        futs = [server.submit("the cat .", uuid=f"u{i}") for i in range(8)]
        server.stop()  # drain-then-join: every admitted request resolves
        assert all(f.done() for f in futs)
        assert [f.result(0.1).uuid for f in futs] == \
            [f"u{i}" for i in range(8)]

    def test_dispatch_failure_rejects_batch_only(self, _isolated_obs):
        hps, vocab = tiny_hps(serve_max_wait_ms=100.0,
                              faults="serve.dispatch:1.0:0:1"), make_vocab()
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               registry=_isolated_obs)
        with server:
            # batch 1 eats the injected fault and is rejected wholesale
            bad = [server.submit("the cat .", uuid=f"bad{i}")
                   for i in range(2)]
            for f in bad:
                with pytest.raises(RuntimeError, match="injected"):
                    f.result(timeout=30)
            # the server survives: batch 2 serves normally
            ok = server.submit("the dog ran .", uuid="ok")
            assert ok.result(timeout=30).uuid == "ok"
        assert _isolated_obs.counter("serve/errors_total").value == 2
        assert _isolated_obs.counter("serve/completed_total").value == 1

    def test_tightest_deadline_drives_degradation_tag(self, _isolated_obs):
        # stub degrades when the batch deadline budget is under 10s:
        # the per-request deadline (from enqueue) reaches the decoder
        hps, vocab = tiny_hps(decode_deadline_secs=5.0), make_vocab()
        server = ServingServer(hps, vocab,
                               decoder=StubDecoder(degrade_under=10.0),
                               registry=_isolated_obs)
        with server:
            res = server.submit("the cat .", uuid="d0").result(timeout=30)
        assert res.degraded
        assert _isolated_obs.counter("serve/degraded_total").value == 1
        assert _isolated_obs.counter(
            "serve/tier_degraded_beam_total").value == 1

    def test_degradation_is_per_request_not_per_batch(self, _isolated_obs):
        """One tight-deadline member does not drag its batchmates down
        to greedy — the group splits
        into per-tier sub-dispatches and only the pressed request
        degrades (counted per request AND per requested tier)."""

        class AlternatingDecoder(StubDecoder):
            # per-REQUEST predicate: degrade every second ask (the
            # server consults it once per group member)
            def __init__(self):
                super().__init__()
                self.asks = 0
                self.has_draft = False

            def should_degrade(self, deadline):
                self.asks += 1
                return self.asks % 2 == 0

        dec = AlternatingDecoder()
        hps, vocab = tiny_hps(serve_max_wait_ms=200.0,
                              decode_deadline_secs=30.0), make_vocab()
        server = ServingServer(hps, vocab, decoder=dec,
                               registry=_isolated_obs)
        server.start()
        # fill one coalescing window with 4 requests BEFORE dispatch
        futs = [server.submit("the cat .", uuid=f"m{i}") for i in range(4)]
        results = {f.result(timeout=30).uuid: f.result(timeout=30)
                   for f in futs}
        server.stop()
        degraded = sorted(u for u, r in results.items() if r.degraded)
        kept = sorted(u for u, r in results.items() if not r.degraded)
        assert len(degraded) == 2 and len(kept) == 2, results
        # the mixed group split into one beam and one greedy dispatch
        assert sorted(t for t in dec.tiers if t) == ["beam", "greedy"]
        by_tier = {t: b for t, b in zip(dec.tiers, dec.batches)}
        greedy_real = [u for u, m in zip(by_tier["greedy"].uuids,
                                         by_tier["greedy"].real_mask) if m]
        assert sorted(greedy_real) == degraded
        assert _isolated_obs.counter("serve/degraded_total").value == 2
        assert _isolated_obs.counter(
            "serve/tier_degraded_beam_total").value == 2
        assert _isolated_obs.counter("serve/tier_beam_total").value == 2
        assert _isolated_obs.counter("serve/tier_greedy_total").value == 2

    def test_expired_in_queue_evicted_typed_not_dispatched(
            self, _isolated_obs):
        """The eviction contract, micro-batch side: a request
        whose enqueue-measured Deadline died while it waited in the
        queue is resolved with the typed DeadlineExceededError at group
        pickup (and counted) instead of burning dispatch time."""
        hps, vocab = tiny_hps(serve_max_wait_ms=5.0,
                              decode_deadline_secs=0.15), make_vocab()
        server = ServingServer(hps, vocab, decoder=StubDecoder(delay=0.3),
                               registry=_isolated_obs)
        with server:
            fresh = server.submit("the cat .", uuid="fresh")
            time.sleep(0.05)  # let the first group dispatch alone
            # ages out behind the 0.3s dispatch: 0.25s queued > 0.15s
            stale = server.submit("the dog .", uuid="stale")
            assert fresh.result(timeout=30).uuid == "fresh"
            with pytest.raises(DeadlineExceededError, match="queued"):
                stale.result(timeout=30)
        assert _isolated_obs.counter(
            "serve/deadline_evictions_total").value == 1
        assert _isolated_obs.counter("serve/completed_total").value == 1
        assert _isolated_obs.counter("serve/errors_total").value == 0

    def test_serve_drives_source_to_sink(self, _isolated_obs):
        hps, vocab = tiny_hps(), make_vocab()
        rows = [(f"uuid-{i}", f"the cat sat {i} .", "", f"ref {i}")
                for i in range(8)]
        server = ServingServer(hps, vocab, decoder=StubDecoder(0.01),
                               registry=_isolated_obs)
        sink = io_lib.CollectionSink()
        with server:
            out = server.serve(io_lib.CollectionSource(rows), sink)
        assert out is sink
        assert {r[0] for r in sink.rows} == {f"uuid-{i}" for i in range(8)}
        # (uuid, article, summary, reference) row shape, per-record flush
        uuid, article, summary, reference = sink.rows[0]
        assert summary == "ok ."
        assert _isolated_obs.counter("serve/sink_rows_total").value == 8

    def test_reload_failure_does_not_kill_dispatcher(self, _isolated_obs):
        """A failed between-batch checkpoint reload is counted and the
        server keeps serving on its current params — it must never
        unwind the dispatch thread (which would hang every queued and
        future request)."""
        class ReloadBomb(StubDecoder):
            def maybe_reload_checkpoint(self, last):
                raise FileNotFoundError("checkpoint dir vanished")

        hps, vocab = tiny_hps(serve_max_wait_ms=5.0), make_vocab()
        server = ServingServer(hps, vocab, decoder=ReloadBomb(),
                               registry=_isolated_obs)
        with server:
            first = server.submit("the cat .", uuid="a").result(timeout=30)
            # the reload after batch 1 raised; batch 2 must still serve
            second = server.submit("the dog .", uuid="b").result(timeout=30)
        assert (first.uuid, second.uuid) == ("a", "b")
        assert _isolated_obs.counter(
            "serve/ckpt_reload_errors_total").value >= 1
        assert _isolated_obs.counter("serve/errors_total").value == 0

    def test_serve_max_count_bounds_unbounded_source(self, _isolated_obs):
        """serve(max_count=N) stops pulling after N rows — the bound
        transform(serving=True, max_batches=...) maps onto."""
        hps, vocab = tiny_hps(), make_vocab()

        def endless():
            i = 0
            while True:
                yield (f"uuid-{i}", "the cat .", "", "r")
                i += 1

        src = io_lib.IteratorSource(endless)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               registry=_isolated_obs)
        sink = io_lib.CollectionSink()
        with server:
            server.serve(src, sink, max_count=6)
        assert len(sink.rows) == 6

    def test_serve_dispatch_error_counts_once_per_request(
            self, _isolated_obs):
        """serve/errors_total is counted at the rejection site only:
        the serve() drain loop must not double-count failed futures."""
        hps, vocab = tiny_hps(serve_max_wait_ms=100.0,
                              faults="serve.dispatch:1.0:0"), make_vocab()
        rows = [(f"uuid-{i}", "the cat .", "", "r") for i in range(2)]
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               registry=_isolated_obs)
        with server:
            with pytest.raises(RuntimeError, match="injected"):
                server.serve(io_lib.CollectionSource(rows),
                             io_lib.CollectionSink())
        assert _isolated_obs.counter("serve/errors_total").value == 2

    def test_serve_rejects_schema_mismatch_typed(self, _isolated_obs):
        hps, vocab = tiny_hps(), make_vocab()
        src = io_lib.CollectionSource(
            [("only-two", "cols")],
            schema=io_lib.RowSchema(["uuid", "article"],
                                    [io_lib.DataTypes.STRING] * 2))
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               registry=_isolated_obs)
        with server:
            with pytest.raises(io_lib.SchemaProjectionError):
                server.serve(src, io_lib.CollectionSink())
        assert _isolated_obs.counter(
            "pipeline/feeder_errors_total").value == 1


# -- continuous batching (stub engine: scheduling semantics, no model) -------

def cont_hps(**kw):
    # the stub engines carry their own slot count and chunk (the slot
    # fields are the real engine's, ROADMAP.md queue 1, item 4)
    base = dict(serve_mode="continuous")
    base.update(kw)
    return tiny_hps(**base)


class TestContinuousServingStub:
    def test_requests_resolve_with_own_uuid(self, _isolated_obs):
        hps, vocab = cont_hps(), make_vocab()
        engine = StubEngine(slots=2, chunks_for=lambda ex: 2)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               engine=engine, registry=_isolated_obs)
        with server:
            futs = [server.submit("the cat sat .", uuid=f"u{i}")
                    for i in range(10)]
            results = [f.result(timeout=30) for f in futs]
        assert [r.uuid for r in results] == [f"u{i}" for i in range(10)]
        assert _isolated_obs.counter("serve/completed_total").value == 10
        assert _isolated_obs.counter("serve/slot_refills_total").value == 10
        # every request sat resident for exactly its 2 chunks
        resident = _isolated_obs.histogram("serve/request_resident_chunks")
        assert resident.count == 10 and resident.mean == 2.0
        # occupancy was observed once per chunk step
        assert _isolated_obs.histogram("serve/slot_occupancy").count > 0

    def test_refill_beats_the_batch_barrier(self, _isolated_obs):
        """The continuous claim at its smallest: one long request plus a
        stream of short ones.  The shorts keep flowing through the OTHER
        slot while the long one stays resident — so the long request
        sees more refills happen around it than any fixed batch would
        allow (a micro-batch would hold all of them hostage)."""
        hps, vocab = cont_hps(), make_vocab()
        engine = StubEngine(
            slots=2,
            chunks_for=lambda ex: 12 if "long" in ex.original_article else 1)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               engine=engine, registry=_isolated_obs)
        with server:
            futs = [server.submit("a long long ride .", uuid="long")]
            futs += [server.submit("the cat .", uuid=f"s{i}")
                     for i in range(6)]
            results = [f.result(timeout=30) for f in futs]
        assert {r.uuid for r in results} == {"long"} | {
            f"s{i}" for i in range(6)}
        # the long request resolved LAST even though it was admitted
        # first — neighbors never waited on it
        resident = _isolated_obs.histogram("serve/request_resident_chunks")
        assert resident.count == 7
        assert _isolated_obs.counter("serve/slot_refills_total").value == 7

    def test_dispatch_fault_fails_resident_only(self, _isolated_obs):
        hps, vocab = cont_hps(
            faults="serve.dispatch:1.0:0:1"), make_vocab()
        engine = StubEngine(slots=2, chunks_for=lambda ex: 1)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               engine=engine, registry=_isolated_obs)
        # enqueue BEFORE start so both are resident when the fault fires
        bad = [server.submit("the cat .", uuid=f"bad{i}") for i in range(2)]
        with server:
            for f in bad:
                with pytest.raises(RuntimeError, match="injected"):
                    f.result(timeout=30)
            # the server survives at slot granularity: next request ok
            ok = server.submit("the dog ran .", uuid="ok")
            assert ok.result(timeout=30).uuid == "ok"
        assert _isolated_obs.counter("serve/errors_total").value == 2
        assert _isolated_obs.counter("serve/completed_total").value == 1

    def test_deadline_evicts_queued_and_resident(self, _isolated_obs):
        """The eviction contract, both sites: a resident request
        whose budget runs out is evicted at a chunk boundary; a request
        whose budget died while QUEUED is resolved typed at refill —
        each with DeadlineExceededError, both counted."""
        hps, vocab = cont_hps(decode_deadline_secs=0.1), make_vocab()
        engine = StubEngine(
            slots=1, delay=0.06,
            chunks_for=lambda ex: 50 if "long" in ex.original_article else 1)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               engine=engine, registry=_isolated_obs)
        long_f = server.submit("a long long ride .", uuid="long")
        short_f = server.submit("the cat .", uuid="short")
        with server:
            # the long request occupies the ONLY slot past its budget ->
            # evicted resident; the short one ages out in the queue
            # behind it -> evicted at refill
            with pytest.raises(DeadlineExceededError, match="resident"):
                long_f.result(timeout=30)
            with pytest.raises(DeadlineExceededError, match="queued"):
                short_f.result(timeout=30)
            # a fresh request (fresh budget) still serves
            ok = server.submit("the dog ran .", uuid="ok")
            assert ok.result(timeout=30).uuid == "ok"
        assert _isolated_obs.counter(
            "serve/deadline_evictions_total").value == 2
        assert _isolated_obs.counter("serve/completed_total").value == 1
        # evictions are deadline OUTCOMES, not server errors
        assert _isolated_obs.counter("serve/errors_total").value == 0

    def test_stop_drains_admitted_requests(self, _isolated_obs):
        hps, vocab = cont_hps(), make_vocab()
        engine = StubEngine(slots=2, chunks_for=lambda ex: 2, delay=0.01)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               engine=engine, registry=_isolated_obs)
        server.start()
        futs = [server.submit("the cat .", uuid=f"u{i}") for i in range(6)]
        server.stop()  # drain-then-join: every admitted request resolves
        assert all(f.done() for f in futs)
        assert [f.result(0.1).uuid for f in futs] == \
            [f"u{i}" for i in range(6)]


class TestContinuousPrefillStub:
    """The ContinuousBatcher prefill queue, stub engine:
    routing, telemetry, lookahead, and failure blast radius — no model."""

    def test_requests_route_through_prefill_exactly_once(
            self, _isolated_obs):
        hps, vocab = cont_hps(), make_vocab()
        engine = PrefillStubEngine(slots=2, chunks_for=lambda ex: 2)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               engine=engine, registry=_isolated_obs)
        with server:
            futs = [server.submit("the cat sat .", uuid=f"u{i}")
                    for i in range(8)]
            results = [f.result(timeout=30) for f in futs]
        assert [r.uuid for r in results] == [f"u{i}" for i in range(8)]
        assert engine.prefills == 8
        assert _isolated_obs.counter("serve/prefill_total").value == 8
        assert _isolated_obs.counter("serve/prefill_errors_total").value == 0
        bucket_h = _isolated_obs.histogram("serve/prefill_bucket_len")
        assert bucket_h.count == 8

    def test_prefill_lookahead_runs_ahead_of_free_slots(
            self, _isolated_obs):
        """serve_prefill_depth 2 (its JAX default; the field is the slot
        engine's) on a 1-slot engine: the first tick
        packs one request and prefills TWO more ahead of it, so a freed
        slot refills from an already-encoded article."""
        hps, vocab = cont_hps(), make_vocab()
        engine = PrefillStubEngine(slots=1, chunks_for=lambda ex: 3)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               engine=engine, registry=_isolated_obs)
        # everything enqueued BEFORE the dispatch thread exists, so the
        # first tick's prefill target (1 free + depth 2) is deterministic
        futs = [server.submit("the cat sat .", uuid=f"u{i}")
                for i in range(4)]
        with server:
            results = [f.result(timeout=30) for f in futs]
        assert [r.uuid for r in results] == [f"u{i}" for i in range(4)]
        assert engine.prefills_before_first_unpack == 3

    def test_prefill_failure_rejects_its_request_only(self, _isolated_obs):
        """A prefill failure resolves ITS request typed and rides the
        standard dispatch-failure path (fail_resident blast radius);
        the server lives on and later requests serve normally."""
        hps, vocab = cont_hps(), make_vocab()
        engine = PrefillStubEngine(
            slots=2, chunks_for=lambda ex: 1,
            fail_for=lambda ex: ex.uuid == "boom")
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               engine=engine, registry=_isolated_obs)
        with server:
            bad = server.submit("the cat sat .", uuid="boom")
            with pytest.raises(RuntimeError, match="injected prefill"):
                bad.result(timeout=30)
            ok = server.submit("the dog ran .", uuid="ok")
            assert ok.result(timeout=30).uuid == "ok"
        assert _isolated_obs.counter("serve/prefill_errors_total").value \
            == 1
        assert _isolated_obs.counter("serve/completed_total").value == 1

    def test_drain_waits_for_prefilled_backlog(self, _isolated_obs):
        """The drain-condition regression: a tick can harvest EVERY
        resident right after the prefill stage drained the queue's tail
        into the prefill queue — the loop must keep ticking for those
        admitted-but-unslotted requests (busy() is false, pending() is
        true), not let stop() reject them."""
        from textsummarization_on_flink_tpu_torch.serve.batcher import (
            ContinuousBatcher,
        )

        hps, vocab = cont_hps(), make_vocab()
        engine = PrefillStubEngine(slots=1, chunks_for=lambda ex: 1)
        q = RequestQueue(8, registry=_isolated_obs)
        cont = ContinuousBatcher(hps, q, engine, registry=_isolated_obs)
        reqs = [make_request(hps, vocab, uuid=f"u{i}") for i in range(3)]
        for r in reqs:
            q.submit(r)
        # tick 1: prefill pops ALL THREE (1 free + depth 2), packs one,
        # its single chunk finishes and harvests -> no residents, empty
        # queue, but two prefilled entries pending
        assert cont.tick(poll=0.01)
        assert q.empty() and not cont.busy()
        assert cont.pending()  # the server's drain condition keys on this
        assert cont.tick(poll=0.01)
        assert cont.tick(poll=0.01)
        assert not cont.pending()
        for r in reqs:
            assert r.future.result(timeout=1).uuid == r.uuid

    def test_stop_drains_prefilled_backlog_through_server(
            self, _isolated_obs):
        """Server-level: stop() right after submit must still resolve
        every admitted request with a RESULT (the exactly-once drain
        contract), including ones sitting in the prefill queue when the
        stop flag lands."""
        hps, vocab = cont_hps(), make_vocab()
        engine = PrefillStubEngine(slots=1, chunks_for=lambda ex: 1)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               engine=engine, registry=_isolated_obs)
        server.start()
        futs = [server.submit("the cat .", uuid=f"u{i}") for i in range(5)]
        server.stop()
        assert [f.result(0.1).uuid for f in futs] == \
            [f"u{i}" for i in range(5)]

    def test_fail_pending_resolves_prefilled_backlog(self, _isolated_obs):
        """The shutdown backstop: prefilled-but-unslotted entries must
        resolve exactly once if the loop dies with them queued."""
        from textsummarization_on_flink_tpu_torch.serve.batcher import (
            ContinuousBatcher,
        )

        hps, vocab = cont_hps(), make_vocab()
        engine = PrefillStubEngine(slots=1)
        cont = ContinuousBatcher(hps, RequestQueue(8,
                                                   registry=_isolated_obs),
                                 engine, registry=_isolated_obs)
        req = make_request(hps, vocab, uuid="stranded")
        cont._prefilled.append((req, engine.prefill(req.example)))
        n = cont.fail_pending(ServeClosedError("stopped"))
        assert n == 1
        with pytest.raises(ServeClosedError):
            req.future.result(timeout=1)

    def test_prefill_trace_event_carries_bucket(self, tmp_path,
                                                _isolated_obs):
        import json

        reg = _isolated_obs
        sink = obs.install_event_sink(str(tmp_path), flush_secs=0.05,
                                      reg=reg)
        hps, vocab = cont_hps(), make_vocab()
        engine = PrefillStubEngine(slots=2, chunks_for=lambda ex: 1)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               engine=engine, registry=reg)
        with server:
            server.submit("the cat sat .", uuid="u0").result(timeout=30)
        sink.close()
        recs = [json.loads(ln)
                for ln in open(tmp_path / "events.jsonl",
                               encoding="utf-8")]
        events = [r for r in recs if r.get("kind") == "request"
                  and r["uuid"] == "u0"]
        stages = [e["event"] for e in events]
        # the disaggregated lifecycle, in order, one connected trace
        assert stages[0] == "enqueue" and stages[-1] == "resolve"
        for required in ("admit", "prefill", "slot", "finish"):
            assert required in stages, stages
        assert stages.index("prefill") < stages.index("slot")
        pre = next(e for e in events if e["event"] == "prefill")
        assert pre["attrs"]["bucket"] >= 1
        assert len({e["trace_id"] for e in events}) == 1



class TestRequestTracing:
    """Acceptance: in a 32-concurrent-request run, every admitted uuid's
    events in events.jsonl form ONE connected trace (enqueue->resolve,
    one trace_id, no orphans) — in BOTH serve modes."""

    N = 32

    def _run_server(self, tmp_path, reg, hps, **server_kw):
        import json

        sink = obs.install_event_sink(str(tmp_path), flush_secs=0.05,
                                      reg=reg)
        server = ServingServer(hps, make_vocab(), registry=reg,
                               **server_kw)
        with server:
            with ThreadPoolExecutor(max_workers=8) as ex:
                futs = list(ex.map(
                    lambda i: server.submit("the cat sat .", uuid=f"u{i}",
                                            block=True),
                    range(self.N)))
            results = [f.result(timeout=60) for f in futs]
        sink.close()
        assert sorted(r.uuid for r in results) == sorted(
            f"u{i}" for i in range(self.N))
        recs = [json.loads(ln)
                for ln in open(tmp_path / "events.jsonl", encoding="utf-8")]
        by_uuid = {}
        for r in recs:
            if r.get("kind") == "request":
                by_uuid.setdefault(r["uuid"], []).append(r)
        return recs, by_uuid

    def _assert_connected(self, by_uuid, required):
        assert sorted(by_uuid) == sorted(f"u{i}" for i in range(self.N))
        trace_ids = {}
        for uuid, events in by_uuid.items():
            stages = [e["event"] for e in events]
            assert required <= set(stages), (uuid, stages)
            # connected: ONE trace_id and ONE root span_id across every
            # event of the request — no orphan fragments
            assert len({e["trace_id"] for e in events}) == 1, uuid
            assert len({e["span_id"] for e in events}) == 1, uuid
            # ordered: lifecycle timestamps never run backwards
            ts = [e["ts_us"] for e in events]
            assert ts == sorted(ts), uuid
            assert stages[0] == "enqueue" and stages[-1] == "resolve", uuid
            trace_ids[uuid] = events[0]["trace_id"]
        # distinct requests never share a trace
        assert len(set(trace_ids.values())) == self.N

    def test_microbatch_traces_connected(self, tmp_path, _isolated_obs):
        reg = _isolated_obs
        hps = tiny_hps(serve_max_wait_ms=5.0)
        _, by_uuid = self._run_server(tmp_path, reg, hps,
                                      decoder=StubDecoder())
        self._assert_connected(
            by_uuid, {"enqueue", "admit", "finish", "resolve"})

    def test_continuous_traces_connected_with_slot_events(
            self, tmp_path, _isolated_obs):
        reg = _isolated_obs
        hps = tiny_hps(serve_mode="continuous")
        engine = StubEngine(slots=4, chunk=2,
                            chunks_for=lambda ex: 2)
        _, by_uuid = self._run_server(tmp_path, reg, hps,
                                      decoder=StubDecoder(), engine=engine)
        self._assert_connected(
            by_uuid, {"enqueue", "admit", "slot", "finish", "resolve"})
        # the slot event carries the physical placement (slot @ tick)
        for uuid, events in by_uuid.items():
            slot_ev = next(e for e in events if e["event"] == "slot")
            assert 0 <= slot_ev["attrs"]["slot"] < 4
            assert slot_ev["attrs"]["tick"] >= 1
            fin = next(e for e in events if e["event"] == "finish")
            assert fin["attrs"]["chunks"] >= 1

    def test_eviction_still_closes_the_trace(self, tmp_path, _isolated_obs):
        """A queue-expired request's trace still ends in resolve (with
        the typed error) — evictions cannot orphan a trace."""
        import json

        reg = _isolated_obs
        sink = obs.install_event_sink(str(tmp_path), flush_secs=0.05,
                                      reg=reg)
        hps = tiny_hps(serve_mode="continuous")
        engine = StubEngine(slots=2, chunk=2)
        server = ServingServer(hps, make_vocab(), decoder=StubDecoder(),
                               engine=engine, registry=reg)
        # expired before the server ever starts: refill evicts it typed
        req = make_request(hps, make_vocab(), uuid="late",
                           deadline=Deadline(time.monotonic() - 1.0),
                           registry=reg)
        server._queue.submit(req)
        with server:
            ok = server.submit("the dog ran .", uuid="ok")
            assert ok.result(timeout=30).uuid == "ok"
        with pytest.raises(DeadlineExceededError):
            req.future.result(timeout=1)
        sink.close()
        recs = [json.loads(ln)
                for ln in open(tmp_path / "events.jsonl", encoding="utf-8")]
        late = [r for r in recs if r.get("kind") == "request"
                and r["uuid"] == "late"]
        stages = [e["event"] for e in late]
        assert stages[0] == "enqueue" and stages[-1] == "resolve"
        assert "evict" in stages
        resolve = late[-1]
        assert resolve["attrs"]["error"] == "DeadlineExceededError"
        assert len({e["trace_id"] for e in late}) == 1

    def test_shed_request_emits_shed_event(self, tmp_path, _isolated_obs):
        reg = _isolated_obs
        sink = obs.install_event_sink(str(tmp_path), flush_secs=0.05,
                                      reg=reg)
        q = RequestQueue(1, registry=reg)
        q.submit(make_request(tiny_hps(), make_vocab(), uuid="first"))
        with pytest.raises(ServeOverloadError):
            q.submit(make_request(tiny_hps(), make_vocab(), uuid="second"))
        sink.close()
        import json

        recs = [json.loads(ln)
                for ln in open(tmp_path / "events.jsonl", encoding="utf-8")]
        second = [r for r in recs if r.get("kind") == "request"
                  and r["uuid"] == "second"]
        # an honest timeline: the request reached the queue and bounced
        assert [r["event"] for r in second] == ["enqueue", "shed"]
        assert second[1]["attrs"]["cause"] == "queue_full"


class TestDarkJobTracing:
    def test_disabled_registry_skips_the_trace_mint(self):
        """A dark job (obs=False / TS_OBS=0) must not pay the urandom
        mint per request: no consumer could ever read the ids."""
        from textsummarization_on_flink_tpu_torch.obs import Registry as _Reg

        dark = _Reg(enabled=False)
        req = make_request(tiny_hps(), make_vocab(), uuid="dark",
                           registry=dark)
        assert req.trace is None and req.future.trace is None
        # and resolution still works without a trace
        req.future._resolve("ok")
        assert req.future.result(timeout=1) == "ok"


# -- the port's server over a real tiny pointer-generator, against JAX ------

#: the pinned group: as many articles as one device batch, one bucket at
#: max_enc_steps, submitted before start() so the first dispatch takes
#: them all
PIN = dict(coverage=True, batch_size=4, serve_buckets="24",
           serve_max_wait_ms=200.0)
N_PIN = 4


def _pinned_summaries(server, tier):
    """Submit the pinned group, start, and return {uuid: words}."""
    futs = [server.submit(article(i), uuid=f"p{i}", tier=tier)
            for i in range(N_PIN)]
    with server:
        res = [f.result(timeout=120) for f in futs]
    return {r.uuid: r.decoded_words for r in res}


@pytest.fixture(scope="class")
def pinned(tmp_path_factory):
    """The JAX package's and the port's servers over one numpy params
    tree, once per tier; each in a registry of its own."""
    jhps, thps = make_hps(**PIN)
    p = decode_params(thps, len(PARITY_WORDS) + 4, seed=17)
    out = {}
    for tier in ("beam", "greedy"):
        root = tmp_path_factory.mktemp(f"pin_{tier}")
        jreg = jax_obs.Registry()
        jserver = JaxServingServer(jhps, JaxVocab(words=PARITY_WORDS),
                                   params=p, decode_root=str(root / "j"),
                                   registry=jreg)
        treg = Registry()
        tserver = ServingServer(thps, Vocab(words=PARITY_WORDS), params=p,
                                decode_root=str(root / "t"), registry=treg)
        out[tier] = dict(jax=_pinned_summaries(jserver, tier),
                         port=_pinned_summaries(tserver, tier),
                         jreg=jreg, treg=treg)
    return dict(out, params=p, thps=thps)


class TestServeParity:
    @pytest.mark.parametrize("tier", ["beam", "greedy"])
    def test_pinned_group_tokens_equal_jax(self, pinned, tier):
        got, want = pinned[tier]["port"], pinned[tier]["jax"]
        assert sorted(got) == [f"p{i}" for i in range(N_PIN)]
        assert got == want
        assert any(got.values())

    @pytest.mark.parametrize("tier", ["beam", "greedy"])
    def test_pinned_group_is_one_dispatch(self, pinned, tier):
        """Both servers took the four articles in one full batch."""
        for reg in (pinned[tier]["treg"], pinned[tier]["jreg"]):
            fill = reg.histogram("serve/batch_fill")
            assert (fill.count, fill.sum) == (1, float(N_PIN))
            assert reg.counter(f"serve/tier_{tier}_total").value == N_PIN

    def test_beam_and_greedy_differ(self, pinned):
        """The parity above is only as strong as its batches."""
        assert pinned["beam"]["port"] != pinned["greedy"]["port"]

    def test_a_spec_tier_names_item_5(self, pinned, tmp_path):
        """Item 5 landed: without a draft model the spec and draft tiers
        are refused at submit, as the JAX server refuses them; with
        ``spec_draft=fresh`` the pinned group's spec summaries are the
        greedy tier's."""
        server = ServingServer(pinned["thps"], Vocab(words=PARITY_WORDS),
                               params=pinned["params"],
                               decode_root=str(tmp_path), registry=Registry())
        for tier in ("spec", "draft"):
            with pytest.raises(ValueError, match="draft model"):
                server.submit("the cat .", tier=tier)
        with pytest.raises(ValueError, match="tier must be one of"):
            server.submit("the cat .", tier="nope")
        treg = Registry()
        spec = ServingServer(pinned["thps"].replace(spec_draft="fresh"),
                             Vocab(words=PARITY_WORDS),
                             params=pinned["params"],
                             decode_root=str(tmp_path / "spec"),
                             registry=treg)
        assert _pinned_summaries(spec, "spec") == pinned["greedy"]["port"]
        assert treg.counter("serve/tier_spec_total").value == N_PIN

    def test_continuous_without_an_engine_names_item_4(self, pinned,
                                                       tmp_path):
        """Item 4 landed: with no engine injected, a continuous server
        builds the decoder's slot engine (serve_slots, or batch_size
        when 0; the resolved refill chunk) and serves the pinned group's
        summaries."""
        from textsummarization_on_flink_tpu_torch.decode.decoder import (
            SlotDecodeEngine,
        )

        hps = pinned["thps"].replace(serve_mode="continuous",
                                     serve_refill_chunk=3)
        server = ServingServer(hps, Vocab(words=PARITY_WORDS),
                               params=pinned["params"],
                               decode_root=str(tmp_path), registry=Registry())
        engine = server._cont._engine
        assert isinstance(engine, SlotDecodeEngine)
        assert (engine.slots, engine.chunk) == (hps.batch_size, 3)
        assert not engine.paged
        assert _pinned_summaries(server, "beam") == pinned["beam"]["port"]

    def test_32_concurrent_requests_coalesce_and_resolve_once(
            self, pinned, tmp_path):
        reg = Registry()
        server = ServingServer(pinned["thps"].replace(serve_max_wait_ms=50.0),
                               Vocab(words=PARITY_WORDS),
                               params=pinned["params"],
                               decode_root=str(tmp_path), registry=reg)
        resolved, lock = [], threading.Lock()

        def count(fut):
            with lock:
                resolved.append(fut.uuid)

        with server:
            with ThreadPoolExecutor(max_workers=8) as ex:
                futs = list(ex.map(lambda i: server.submit(
                    article(i % 6), uuid=f"u{i}"), range(32)))
            for f in futs:
                f.add_done_callback(count)
            results = [f.result(timeout=300) for f in futs]
        assert [r.uuid for r in results] == [f"u{i}" for i in range(32)]
        assert sorted(resolved) == sorted(f"u{i}" for i in range(32))
        fill = reg.histogram("serve/batch_fill")
        assert fill.sum == 32 and fill.mean > 1.0
        assert reg.counter("serve/completed_total").value == 32
        # the same article gives the same summary in any batch
        by_article = {}
        for i, r in enumerate(results):
            by_article.setdefault(i % 6, set()).add(r.summary)
        assert all(len(s) == 1 for s in by_article.values())

    def test_front_door_cache_hit_and_coalescing(self, pinned, tmp_path):
        reg = Registry()
        hps = pinned["thps"].replace(serve_cache_entries=8,
                                     serve_coalesce=True)
        server = ServingServer(hps, Vocab(words=PARITY_WORDS),
                               params=pinned["params"],
                               decode_root=str(tmp_path), registry=reg)
        # two of the same article before start(): one leader, one follower
        lead = server.submit(article(1), uuid="lead")
        follow = server.submit(article(1), uuid="follow")
        with server:
            first = lead.result(timeout=120)
            assert follow.result(timeout=120).summary == first.summary
            hit = server.submit(article(1), uuid="again")
            assert hit.done()  # a hit resolves at submit, queue untouched
            assert hit.result(timeout=1).summary == first.summary
        assert reg.counter("serve/coalesced_total").value == 1
        assert reg.counter("serve/cache_hits_total").value == 1
        assert reg.histogram("serve/batch_fill").sum == 1  # one decode

    def test_a_short_deadline_degrades_its_request_to_greedy(
            self, pinned, tmp_path):
        """After warm full-beam dispatches the decoder has a latency
        estimate; a request whose budget is below it is re-tiered to
        greedy alone and gives decode_batch(tier="greedy")'s summary.
        The estimate is set to 60 s, as a slow device's would be, so the
        30 s budget is short of it however loaded this machine is."""
        hps = pinned["thps"].replace(serve_max_wait_ms=0.0)
        vocab = Vocab(words=PARITY_WORDS)
        dec = dec_lib.BeamSearchDecoder(hps, vocab, None,
                                        params=pinned["params"],
                                        decode_root=str(tmp_path))
        reg = Registry()
        warm = ServingServer(hps, vocab, decoder=dec, registry=reg)
        with warm:
            for i in range(2):
                warm.submit(article(i), uuid=f"w{i}").result(timeout=120)
        assert dec._beam_secs is not None  # the second dispatch's sample
        dec._beam_secs = 60.0
        tight = ServingServer(hps.replace(decode_deadline_secs=30.0), vocab,
                              decoder=dec, registry=reg)
        with tight:
            res = tight.submit(article(2), uuid="late").result(timeout=120)
        assert res.degraded and res.tier == "greedy"
        assert reg.counter("serve/degraded_total").value == 1
        ex = SummaryExample.build(article(2), [], vocab, hps, uuid="late")
        mb = MicroBatcher(hps, vocab, RequestQueue(4), registry=Registry())
        want = dec.decode_batch(mb.build([ServeRequest("late", article(2),
                                                       "", ex)]),
                                tier="greedy")
        assert res.decoded_words == want[0].decoded_words

    def test_decode_batch_degrades_on_its_own_deadline(self, pinned,
                                                       tmp_path):
        """tier=None: the decoder's own ladder (JAX decode_batch)."""
        hps = pinned["thps"]
        vocab = Vocab(words=PARITY_WORDS)
        dec = dec_lib.BeamSearchDecoder(hps, vocab, None,
                                        params=pinned["params"],
                                        decode_root=str(tmp_path))
        ex = SummaryExample.build(article(3), [], vocab, hps, uuid="d")
        mb = MicroBatcher(hps, vocab, RequestQueue(4), registry=Registry())
        batch = mb.build([ServeRequest("d", article(3), "", ex)])
        first = dec.decode_batch(batch, deadline=Deadline.after(30.0))
        assert not first[0].degraded and dec._beam_secs is None
        dec.decode_batch(batch)  # the second full-beam dispatch: sampled
        assert dec._beam_secs is not None
        assert not dec.should_degrade(Deadline.never())
        dec._beam_secs = 60.0
        late = dec.decode_batch(batch, deadline=Deadline.after(30.0))
        assert late[0].degraded and late[0].tier == "greedy"
        assert late[0].decoded_words == \
            dec.decode_batch(batch, tier="greedy")[0].decoded_words


# -- transform(serving=True) against the JAX package's ----------------------

SERVE_FIELDS = dict(batch_size=4, hidden_dim=8, emb_dim=6, max_enc_steps=12,
                    max_dec_steps=6, beam_size=2, min_dec_steps=1,
                    max_oov_buckets=4, exp_name="exp", mode="decode")
ROW_WORDS = ("article reference the a quick brown fox jumped over lazy dog "
             "0 1 2 3 4 5 6 7").split()


def _rows(n):
    out = []
    for i in range(n):
        rng = np.random.RandomState(i)
        words = [ROW_WORDS[j] if rng.rand() < 0.7 else f"zz{j % 4}"
                 for j in rng.randint(0, len(ROW_WORDS), rng.randint(6, 16))]
        out.append((f"uuid-{i}", " ".join(words) + " .", "",
                    " ".join(words[:4]) + " ."))
    return out


def _serving_model(pkg, root):
    vsize = len(ROW_WORDS) + 4
    if pkg == "jax":
        m, hps = jax_est, jax_config.HParams(log_root=str(root),
                                          vocab_size=vsize, **SERVE_FIELDS)
        vocab = JaxVocab(words=ROW_WORDS)
    else:
        m, hps = est, HParams(log_root=str(root), vocab_size=vsize,
                                   device="cpu", **SERVE_FIELDS)
        vocab = Vocab(words=ROW_WORDS)
    model = m.SummarizationModel()
    (model.set_inference_selected_cols(["uuid", "article", "reference"])
     .set_inference_output_cols(["uuid", "article", "summary", "reference"]))
    model.set_inference_hyper_params(hps.to_argv().split())
    return model.with_vocab(vocab), hps


def test_transform_serving_gives_the_jax_rows(tmp_path):
    """One checkpoint, written by the JAX package, read by both."""
    rows = _rows(10)
    out = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        model, hps = _serving_model(pkg, root)
        p = decode_params(make_hps(**{k: v for k, v in SERVE_FIELDS.items()
                                      if k != "exp_name"},
                                   vocab_size=len(ROW_WORDS) + 4)[1],
                          len(ROW_WORDS) + 4, seed=5, stop_bias=1.0)
        jhps = jax_config.HParams(vocab_size=len(ROW_WORDS) + 4,
                               **SERVE_FIELDS)
        state = jax_trainer.init_train_state(jhps, len(ROW_WORDS) + 4,
                                             params=p)
        jax_ckpt.Checkpointer(os.path.join(str(root), "exp", "train"),
                              hps=jhps).save(state)
        io_mod = jax_io if pkg == "jax" else io_lib
        reg = jax_obs.Registry() if pkg == "jax" else Registry()
        use = jax_obs.use_registry if pkg == "jax" else obs.use_registry
        with use(reg):
            sink = model.transform(io_mod.CollectionSource(rows),
                                   serving=True, max_batches=2)
        out[pkg] = (sorted(sink.rows), reg)
    got, want = out["port"][0], out["jax"][0]
    assert len(got) == 8  # max_batches * batch_size rows of the 10
    assert got == want
    assert any(r[2] for r in got)
    reg = out["port"][1]
    assert reg.counter("pipeline/rows_out_total").value == 8
    assert sum(r.name == "pipeline/transform_serving"
               for r in obs.tracer_for(reg).finished()) == 1
