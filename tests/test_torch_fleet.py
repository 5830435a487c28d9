"""The port's fleet layer (serve/router.py, serve/fleet.py) on the CPU.

Three parts:

  * a scripted router scenario run through the JAX package's
    ``FleetRouter`` and the port's, each over its own fake replica
    servers (a copy of the one of tests/test_fleet.py) on one injected
    clock: loads, health flips, a kill, hedges under the ratio cap and a
    rolling swap whose hot-swap fails on one replica.  The routes
    (uuid -> replica), the hedge, requeue, kill and swap counters and
    the rotation gauge are equal tick by tick;
  * the JAX package's router unit tests (tests/test_fleet.py) against
    the port's classes;
  * the router over real servers: the port's and the JAX package's
    ServingServers at a tiny pointer-generator width on the CPU, over
    one numpy params tree.  The fleet's summaries equal the JAX fleet's
    and a single port server's, in micro-batch mode and after a kill in
    continuous mode.
"""

import glob
import os
import threading
import types

import pytest

from _torch_parity import WORDS as PARITY_WORDS
from _torch_parity import article, decode_params, make_hps
from textsummarization_on_flink_tpu import obs as jax_obs
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.serve import errors as jax_errors
from textsummarization_on_flink_tpu.serve import fleet as jax_fleet
from textsummarization_on_flink_tpu.serve.queue import (
    ServeFuture as JaxServeFuture,
)
from textsummarization_on_flink_tpu.serve.server import (
    ServingServer as JaxServingServer,
)
from textsummarization_on_flink_tpu import config as jax_config
from textsummarization_on_flink_tpu_torch import config as torch_config
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.obs import Registry, flightrec
from textsummarization_on_flink_tpu_torch.obs import http as obs_http
from textsummarization_on_flink_tpu_torch.resilience.policy import CircuitBreaker
from textsummarization_on_flink_tpu_torch.serve import errors as torch_errors
from textsummarization_on_flink_tpu_torch.serve import fleet as torch_fleet
from textsummarization_on_flink_tpu_torch.serve.errors import (
    ReplicaKilledError,
    ServeClosedError,
    ServeOverloadError,
)
from textsummarization_on_flink_tpu_torch.serve.fleet import FleetRouter, _Routed
from textsummarization_on_flink_tpu_torch.serve.queue import ServeFuture
from textsummarization_on_flink_tpu_torch.serve.router import pick_replica
from textsummarization_on_flink_tpu_torch.serve.server import ServingServer

WORDS = ["the", "cat", "sat", "on", "mat", "."]


def HParams(**kw):
    """The port's HParams on the CPU (the stub replicas touch no device;
    the real ones decode on the CPU)."""
    kw.setdefault("device", "cpu")
    return torch_config.HParams(**kw)


class _Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def now(self) -> float:
        return self.t


class FakeReplicaServer:
    """ServingServer surface the router consumes, with MANUALLY
    resolvable futures — hedge/requeue interleavings become exact."""

    def __init__(self, registry=None, load=0, admission="closed"):
        self.registry = registry if registry is not None else Registry()
        self._load = load
        self.admission = admission
        self.submits = []  # [(uuid, future)]
        self.killed = False
        self.started = False
        self.swaps = 0

    # -- router surface --
    def stats(self):
        return {"queue_depth": self._load, "serve_mode": "continuous",
                "admission": self.admission}

    def load(self):
        return self._load + len([f for _, f in self.submits
                                 if not f.done()])

    def submit(self, article, uuid="", reference="", block=False,
               timeout=None, tier="", trace=None, tenant=""):
        if self.killed:
            raise ServeClosedError("killed")
        fut = ServeFuture(uuid, registry=self.registry)
        fut.trace = trace
        self.submits.append((uuid, fut))
        return fut

    def kill(self, error=None):
        self.killed = True
        err = error or ReplicaKilledError("killed")
        n = 0
        for _, f in self.submits:
            if not f.done():
                f._reject(err)
                n += 1
        return n

    def start(self):
        self.started = True
        return self

    def stop(self, timeout=None):
        for _, f in self.submits:
            if not f.done():
                f._reject(ServeClosedError("stopped"))

    def idle(self):
        return all(f.done() for _, f in self.submits)

    def hot_swap(self):
        self.swaps += 1
        return True

    # test sugar
    def resolve(self, uuid, result="ok"):
        for u, f in self.submits:
            if u == uuid and not f.done():
                f._resolve(result)
                return
        raise AssertionError(f"no pending submit {uuid!r}")


def make_fleet(n=3, hedge_ms=0.0, ratio=0.5, clock=None, registry=None,
               reset_secs=1.0, faults=None, **hps_kw):
    clock = clock or _Clock()
    hps = HParams(serve_hedge_ms=hedge_ms, serve_hedge_max_ratio=ratio,
                  serve_replicas=n, **hps_kw)
    servers = [FakeReplicaServer() for _ in range(n)]
    router = FleetRouter(servers, hps,
                         registry=registry or Registry(),
                         clock=clock.now, replica_reset_secs=reset_secs,
                         faults=faults)
    return router, servers, clock


class TestRouting:
    def test_least_loaded_pick_is_stable(self):
        router, servers, _ = make_fleet(3)
        servers[0]._load, servers[1]._load, servers[2]._load = 2, 0, 0
        h = pick_replica(router.replicas())
        assert h.rid == "r1"  # least loaded; earliest wins the tie

    def test_submit_routes_and_resolves_through_router_future(self):
        router, servers, _ = make_fleet(2)
        fut = router.submit("a b", uuid="u0")
        assert not fut.done()
        sub = [s for s in servers if s.submits]
        assert len(sub) == 1
        sub[0].resolve("u0", result="res")
        assert fut.result(timeout=1) == "res"
        assert router.registry.counter(
            "serve/fleet_submitted_total").value == 1

    def test_no_replica_in_rotation_sheds_typed(self):
        router, servers, _ = make_fleet(2)
        for h in router.replicas():
            h.killed = True
        with pytest.raises(ServeOverloadError):
            router.submit("a", uuid="u0")

    def test_all_replicas_closed_surfaces_closed_not_overload(self):
        """A terminal ServeClosedError from the replicas must reach the
        caller AS closed (stop submitting), not be masked as retryable
        overload."""
        router, servers, _ = make_fleet(2)
        for s in servers:
            s.killed = True  # submit raises ServeClosedError
        with pytest.raises(ServeClosedError):
            router.submit("a", uuid="u0")

    def test_draining_replica_receives_no_new_requests(self):
        router, servers, _ = make_fleet(2)
        router.handle("r0").draining = True
        for i in range(4):
            router.submit("a", uuid=f"u{i}")
        assert not servers[0].submits
        assert len(servers[1].submits) == 4

    def test_overloaded_replica_leaves_rotation_and_request_reroutes(self):
        router, servers, _ = make_fleet(2)

        class Full(FakeReplicaServer):
            def submit(self, *a, **kw):
                raise ServeOverloadError("queue full")

        full = Full()
        router.replicas()[0].server = full
        servers[0] = full
        full._load = -10  # force it to be picked first
        fut = router.submit("a", uuid="u0")
        # the full replica recorded a rotation-breaker failure and the
        # request landed on the healthy one
        assert router.handle("r0").breaker.state == CircuitBreaker.OPEN
        assert len(servers[1].submits) == 1
        servers[1].resolve("u0")
        assert fut.result(timeout=1) == "ok"


class TestRotationHealth:
    def _stale_board(self, reg, clock):
        board = obs_http.HeartbeatBoard(clock=clock.now)
        reg.heartbeats = board
        return board

    def test_stale_heartbeat_removes_then_probe_readmits(self):
        clock = _Clock()
        router, servers, _ = make_fleet(2, clock=clock, reset_secs=5.0)
        board = self._stale_board(servers[0].registry, clock)
        board.beat("serve/dispatch", period=1.0)
        router.tick()
        assert router.handle("r0").in_rotation()
        # the heartbeat goes stale (> 3x its declared period)
        clock.t = 10.0
        router.tick()
        assert not router.handle("r0").in_rotation()
        assert router.in_rotation() == 1
        # fresh beats alone do not readmit before the breaker reset
        board.beat("serve/dispatch", period=1.0)
        router.tick()
        assert not router.handle("r0").in_rotation()
        # past reset_secs the HALF_OPEN health probe readmits
        clock.t = 16.0
        board.beat("serve/dispatch", period=1.0)
        router.tick()
        assert router.handle("r0").in_rotation()
        assert router.in_rotation() == 2

    def test_still_stale_probe_reopens(self):
        clock = _Clock()
        router, servers, _ = make_fleet(2, clock=clock, reset_secs=5.0)
        board = self._stale_board(servers[0].registry, clock)
        board.beat("serve/dispatch", period=1.0)
        clock.t = 10.0
        router.tick()  # removed
        clock.t = 16.0  # probe window, but the heartbeat is STILL stale
        router.tick()
        assert not router.handle("r0").in_rotation()
        assert router.handle("r0").breaker.state == CircuitBreaker.OPEN

    def test_open_admission_breaker_is_unhealthy(self):
        router, servers, _ = make_fleet(2)
        servers[0].admission = "open"
        router.tick()
        assert not router.handle("r0").in_rotation()


class TestHedging:
    def test_hedge_first_wins_and_loser_is_discarded(self):
        clock = _Clock()
        router, servers, _ = make_fleet(2, hedge_ms=50.0, ratio=1.0,
                                        clock=clock)
        fut = router.submit("a", uuid="u0")
        primary = [s for s in servers if s.submits][0]
        loser = primary
        clock.t = 0.1  # 100 ms > the 50 ms budget
        router.tick()
        reg = router.registry
        assert reg.counter("serve/hedges_total").value == 1
        twin = [s for s in servers if s.submits and s is not primary][0]
        # the twin resolves first: the router future resolves ONCE with
        # its result and counts the win
        twin.resolve("u0", result="twin")
        assert fut.result(timeout=1) == "twin"
        assert reg.counter("serve/hedge_wins_total").value == 1
        # the straggling primary finishing later is discarded, not a
        # double resolution
        loser.resolve("u0", result="late")
        assert fut.result(timeout=1) == "twin"

    def test_primary_win_is_not_a_hedge_win(self):
        clock = _Clock()
        router, servers, _ = make_fleet(2, hedge_ms=50.0, ratio=1.0,
                                        clock=clock)
        fut = router.submit("a", uuid="u0")
        primary = [s for s in servers if s.submits][0]
        clock.t = 0.1
        router.tick()
        primary.resolve("u0", result="primary")
        assert fut.result(timeout=1) == "primary"
        assert router.registry.counter("serve/hedge_wins_total").value == 0
        assert router.registry.counter("serve/hedges_total").value == 1

    def test_hedge_rate_ceiling_suppresses(self):
        clock = _Clock()
        # ratio 0.5 over 2 submissions = at most 1 hedge
        router, servers, _ = make_fleet(3, hedge_ms=50.0, ratio=0.5,
                                        clock=clock)
        f0 = router.submit("a", uuid="u0")
        f1 = router.submit("a", uuid="u1")
        clock.t = 0.1
        router.tick()
        reg = router.registry
        assert reg.counter("serve/hedges_total").value == 1
        assert reg.counter("serve/hedge_suppressed_total").value == 1
        for s in servers:
            for u, f in list(s.submits):
                if not f.done():
                    s.resolve(u)
        assert f0.result(timeout=1) and f1.result(timeout=1)

    def test_failed_hedge_submit_does_not_burn_the_hedge(self):
        """A twin that refuses the hedge submit (queue full) must leave
        the request hedge-ELIGIBLE: once the twin's rotation probe
        readmits it, the next scan buys the hedge that failed before."""
        clock = _Clock()
        router, servers, _ = make_fleet(2, hedge_ms=50.0, ratio=1.0,
                                        clock=clock, reset_secs=5.0)

        class Moody(FakeReplicaServer):
            reject = True

            def submit(self, *a, **kw):
                if self.reject:
                    raise ServeOverloadError("queue full")
                return super().submit(*a, **kw)

        moody = Moody()
        router.replicas()[1].server = moody
        servers[1] = moody
        fut = router.submit("a", uuid="u0")
        assert servers[0].submits  # primary landed on the good replica
        clock.t = 0.1
        router.tick()  # hedge attempt fails: twin refuses the submit
        reg = router.registry
        assert reg.counter("serve/hedges_total").value == 0
        # the twin's refusal also took it out of rotation; readmit it
        moody.reject = False
        clock.t = 6.0  # past the rotation breaker's reset window
        router.tick()  # health probe readmits + the scan re-hedges
        assert reg.counter("serve/hedges_total").value == 1
        assert len(moody.submits) == 1
        moody.resolve("u0", result="twin")
        assert fut.result(timeout=1) == "twin"
        assert reg.counter("serve/hedge_wins_total").value == 1

    def test_hedging_off_by_default(self):
        clock = _Clock()
        router, servers, _ = make_fleet(2, hedge_ms=0.0, clock=clock)
        router.submit("a", uuid="u0")
        clock.t = 99.0
        router.tick()
        assert router.registry.counter("serve/hedges_total").value == 0


class TestKillAndRequeue:
    def test_kill_requeues_on_survivor_exactly_once(self):
        router, servers, _ = make_fleet(2, registry=Registry())
        fut = router.submit("a", uuid="u0")
        primary = [s for s in servers if s.submits][0]
        survivor = [s for s in servers if s is not primary][0]
        rid = [h.rid for h in router.replicas()
               if h.server is primary][0]
        router.kill_replica(rid)
        reg = router.registry
        assert reg.counter("serve/replica_kills_total").value == 1
        assert reg.counter("serve/requeued_total").value == 1
        assert len(survivor.submits) == 1
        survivor.resolve("u0", result="requeued-res")
        assert fut.result(timeout=1) == "requeued-res"

    def test_whole_fleet_dead_rejects_typed(self):
        router, servers, _ = make_fleet(2)
        fut = router.submit("a", uuid="u0")
        for h in router.replicas():
            router.kill_replica(h.rid)
        with pytest.raises(ReplicaKilledError):
            fut.result(timeout=1)

    def test_kill_is_idempotent_and_never_kills_twice(self):
        router, servers, _ = make_fleet(2)
        router.kill_replica("r0")
        assert router.kill_replica("r0") == 0
        assert router.registry.counter(
            "serve/replica_kills_total").value == 1

    def test_chaos_point_kills_most_loaded_but_never_last(self):
        from textsummarization_on_flink_tpu_torch.resilience import faultinject

        plan = faultinject.FaultPlan(
            faultinject.parse("serve.replica_kill:1.0:0:3"),
            registry=Registry())
        router, servers, _ = make_fleet(2, faults=plan)
        servers[1]._load = 5
        router.tick()  # fire 1: kills the loaded r1
        assert router.handle("r1").killed
        assert not router.handle("r0").killed
        router.tick()  # fire 2: refuses to kill the last replica
        router.tick()  # fire 3: same
        assert not router.handle("r0").killed
        assert router.registry.counter(
            "serve/replica_kills_total").value == 1

    def test_replica_kill_triggers_flight_dump(self, tmp_path):
        reg = Registry()
        flightrec.install_flight_recorder(reg, str(tmp_path), capacity=8)
        router, servers, _ = make_fleet(2, registry=reg)
        router.tick()  # leave at least one fleet_tick frame behind
        router.kill_replica("r0")
        dumps = glob.glob(str(tmp_path / "flight_replica_kill*.jsonl"))
        assert len(dumps) == 1


class TestRoutedExactlyOnce:
    def _routed(self, uuid="u0"):
        return _Routed(uuid, "a", "", "", ServeFuture(uuid, Registry()),
                       None, submit_t=0.0)

    def test_error_defers_while_a_twin_is_outstanding(self):
        r = self._routed()
        r.add_outstanding()
        r.add_outstanding()
        assert not r.offer_error(RuntimeError("primary died"))
        assert not r.future.done()
        assert r.offer_result("twin")
        assert r.future.result(timeout=1) == "twin"

    def test_last_error_standing_rejects_once(self):
        r = self._routed()
        r.add_outstanding()
        r.add_outstanding()
        r.offer_error(RuntimeError("one"))
        assert r.offer_error(RuntimeError("two"))
        with pytest.raises(RuntimeError, match="two"):
            r.future.result(timeout=1)

    def test_second_success_is_discarded(self):
        r = self._routed()
        r.add_outstanding()
        r.add_outstanding()
        assert r.offer_result("first")
        assert not r.offer_result("second")
        assert r.future.result(timeout=1) == "first"

    def test_drop_after_deferred_error_settles_instead_of_hanging(self):
        """The requeue race: a replacement attempt that errors in the
        window between its registration and the dead attempt's
        drop_outstanding left a phantom slot deferring the error — the
        drop must settle the future, never leave it hanging."""
        r = self._routed()
        r.add_outstanding()      # the dead attempt (kill in flight)
        r.add_outstanding()      # its requeued replacement
        # the replacement fails BEFORE the dead slot is retired: the
        # error defers against the phantom outstanding attempt
        assert not r.offer_error(RuntimeError("survivor rejected it"))
        assert not r.future.done()
        r.drop_outstanding()     # retiring the phantom must settle
        assert r.future.done()
        with pytest.raises(RuntimeError, match="survivor rejected"):
            r.future.result(timeout=1)

    def test_concurrent_offers_resolve_exactly_once(self):
        r = self._routed()
        wins = []
        n = 8
        for _ in range(n):
            r.add_outstanding()
        barrier = threading.Barrier(n)

        def offer(i):
            barrier.wait()
            if r.offer_result(f"res{i}"):
                wins.append(i)

        threads = [threading.Thread(target=offer, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(wins) == 1
        assert r.future.result(timeout=1) == f"res{wins[0]}"


class TestMicrobatchDrainAccounting:
    def test_coalescing_group_counts_as_in_flight(self):
        """The rolling-swap drain predicate must see requests the
        micro-batcher already popped off the queue but has not yet
        dispatched (the coalescing window): queue-empty alone is a
        false idle."""
        from test_torch_serve import StubDecoder
        from textsummarization_on_flink_tpu_torch.serve.server import ServingServer

        vocab = Vocab(words=WORDS)
        hps = HParams(mode="decode", batch_size=4, vocab_size=vocab.size(),
                      max_enc_steps=8, max_dec_steps=4, beam_size=2,
                      min_dec_steps=1, max_oov_buckets=4,
                      serve_max_wait_ms=0.0, serve_max_queue=8)
        server = ServingServer(hps, vocab, decoder=StubDecoder(),
                               registry=Registry())
        assert server.idle()
        server.submit("the cat .", uuid="u0")
        server.submit("the mat .", uuid="u1")
        assert not server.idle() and server.load() == 2
        group = server._batcher.next_group(poll=0.01)
        assert len(group) == 2
        # the queue is empty now, but the popped group is ADMITTED work
        assert server.pending() == 0
        assert not server.idle(), "coalesced group invisible to idle()"
        assert server.load() == 2
        server._batcher.end_group()
        assert server.idle()


class TestRollingSwap:
    def test_swap_visits_every_replica_one_at_a_time(self):
        router, servers, _ = make_fleet(3)
        router.start_rolling_swap()
        seen_out = []
        for _ in range(12):
            if router.swap_active():
                out = [h.rid for h in router.replicas() if h.draining]
                assert len(out) <= 1, "rolling swap drained two at once"
                seen_out.extend(out)
            router.tick()
        assert not router.swap_active()
        assert [s.swaps for s in servers] == [1, 1, 1]
        assert router.in_rotation() == 3
        assert router.registry.counter(
            "serve/fleet_swaps_total").value == 3

    def test_swap_waits_for_drain(self):
        router, servers, _ = make_fleet(2)
        fut = router.submit("a", uuid="u0")
        primary = [s for s in servers if s.submits][0]
        router.start_rolling_swap()
        for _ in range(4):
            router.tick()
        # r0 first in order; if it holds the request it cannot swap yet
        if primary is servers[0]:
            assert servers[0].swaps == 0
            primary.resolve("u0")
            for _ in range(6):
                router.tick()
        else:
            primary.resolve("u0")
            for _ in range(6):
                router.tick()
        assert not router.swap_active()
        assert [s.swaps for s in servers] == [1, 1]
        assert fut.done()

    def test_double_start_raises(self):
        router, _, _ = make_fleet(2)
        router.start_rolling_swap()
        with pytest.raises(RuntimeError, match="already in progress"):
            router.start_rolling_swap()

    def test_killed_replica_is_skipped_mid_swap(self):
        router, servers, _ = make_fleet(3)
        router.start_rolling_swap()
        router.kill_replica("r1")
        for _ in range(12):
            router.tick()
        assert not router.swap_active()
        assert servers[0].swaps == 1 and servers[2].swaps == 1
        assert servers[1].swaps == 0


class TestHotSwapFailureMidServe:
    """Inject a ``ckpt.load`` fault during a
    router-orchestrated swap — the replica must keep serving on its old
    snapshot, count ``serve/ckpt_reload_errors_total``, and STAY IN
    ROTATION."""

    def test_injected_ckpt_fault_keeps_replica_serving_old_snapshot(
            self, tmp_path):
        from textsummarization_on_flink_tpu_torch.checkpoint import (
            checkpointer as ckpt_lib,
        )
        from textsummarization_on_flink_tpu_torch.decode.decoder import (
            BeamSearchDecoder,
        )
        from textsummarization_on_flink_tpu_torch.resilience import faultinject
        from textsummarization_on_flink_tpu_torch.serve.server import ServingServer
        from textsummarization_on_flink_tpu_torch.train import trainer as t_lib

        vocab = Vocab(words=WORDS)
        hps = HParams(mode="decode", batch_size=2, hidden_dim=8, emb_dim=6,
                      vocab_size=vocab.size(), max_enc_steps=8,
                      max_dec_steps=4, beam_size=2, min_dec_steps=1,
                      max_oov_buckets=4, serve_max_wait_ms=5.0,
                      serve_max_queue=16, serve_buckets="8", device="cpu")
        train_dir = str(tmp_path / "train")
        ck = ckpt_lib.Checkpointer(train_dir, hps=hps)
        state = t_lib.init_train_state(hps, vocab.size())
        ck.save(state)
        reg = Registry()
        with obs.use_registry(reg):
            decoder = BeamSearchDecoder(
                hps, vocab, batcher=None, train_dir=train_dir,
                decode_root=str(tmp_path / "dec"), max_ckpt_retries=0)
            server = ServingServer(hps, vocab, decoder=decoder,
                                   registry=reg)
            router = FleetRouter([server], hps, registry=Registry())
            router.start()
            try:
                assert router.submit(
                    "the cat sat .", uuid="u0").result(timeout=120)
                ckpt_before = decoder._params_snapshot()[1]
                # a NEWER checkpoint lands; its load is chaos-killed
                ck.save(state._replace(step=state.step + 5))
                plan = faultinject.FaultPlan(
                    faultinject.parse("ckpt.load:1.0:0:8"), registry=reg)
                with faultinject.use_plan(plan):
                    router.rolling_swap(timeout=60.0)
                # the swap failed but degraded the UPGRADE, not the fleet
                assert reg.counter(
                    "serve/ckpt_reload_errors_total").value == 1
                assert decoder._params_snapshot()[1] == ckpt_before
                assert router.handle("r0").in_rotation()
                assert router.submit(
                    "the mat .", uuid="u1").result(timeout=120)
                # with the chaos unarmed, the next swap picks up the
                # new checkpoint (the failure was the fault, not the
                # orchestration)
                router.rolling_swap(timeout=60.0)
                assert decoder._params_snapshot()[1] != ckpt_before
            finally:
                router.stop()


class TestCrossReplicaTrace:
    """One request's cross-replica timeline
    (enqueue -> route -> kill -> requeued -> route -> ... -> resolve)
    reconstructs from the unified events.jsonl via
    scripts/trace_summary.py --request."""

    def test_requeued_request_timeline_reconstructs(self, tmp_path):
        import importlib
        import sys

        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "scripts"))
        trace_summary = importlib.import_module("trace_summary")

        from textsummarization_on_flink_tpu_torch.obs.export import (
            install_event_sink,
        )
        from test_torch_serve import StubEngine
        from textsummarization_on_flink_tpu_torch.serve.server import ServingServer

        vocab = Vocab(words=WORDS)
        hps = HParams(mode="decode", batch_size=2, hidden_dim=8, emb_dim=6,
                      vocab_size=vocab.size(), max_enc_steps=8,
                      max_dec_steps=4, beam_size=2, min_dec_steps=1,
                      max_oov_buckets=4, serve_max_queue=16,
                      serve_mode="continuous", serve_slots=1,
                      serve_refill_chunk=1)
        fleet_reg = Registry()
        sink = install_event_sink(fleet_reg, str(tmp_path))
        servers = [
            ServingServer(hps, vocab, decoder=_NullD(),
                          engine=StubEngine(slots=1,
                                            chunks_for=lambda ex: 3),
                          registry=Registry())
            for _ in range(2)]
        router = FleetRouter(servers, hps, registry=fleet_reg)
        fut = router.submit("the cat sat .", uuid="u7")
        primary = next(s for s in servers if s.pending())
        rid = [h.rid for h in router.replicas()
               if h.server is primary][0]
        # one tick makes it RESIDENT (mid-decode), then the kill
        primary.tick_once(poll=0.0)
        router.kill_replica(rid)
        survivor = [s for s in servers if s is not primary][0]
        for _ in range(8):
            if fut.done():
                break
            survivor.tick_once(poll=0.0)
        assert fut.result(timeout=1).uuid == "u7"
        router.stop()
        sink.close()
        path = os.path.join(str(tmp_path), "events.jsonl")
        tl = trace_summary.request_timeline([path], "u7")
        names = [e["event"] for e in tl["events"]]
        # the cross-replica story, in order: routed to the victim,
        # admitted, died typed, requeued to the survivor, re-routed,
        # re-admitted, finished, and resolved EXACTLY ONCE at the end
        assert names[0] == "route"
        assert "requeued" in names
        i_requeue = names.index("requeued")
        assert "admit" in names[:i_requeue], "victim never admitted it"
        assert "route" in names[i_requeue:], "no re-route after requeue"
        assert "finish" in names[i_requeue:]
        assert names[-1] == "resolve"
        # ONE trace id stitches the whole cross-replica lifecycle
        assert len(tl["trace_ids"]) == 1
        # phases close: total runs enqueue -> the TERMINAL resolve
        assert tl["phases"]["total_ms"] >= 0.0


class _NullD:
    def maybe_reload_checkpoint(self, last):
        return last


class TestFleetTelemetryPlane:
    """Replica identity threading and the /fleet/* source map the
    router wires at construction."""

    def test_replica_ids_threaded_to_replica_registries(self):
        router, servers, _ = make_fleet(n=3)
        for i, s in enumerate(servers):
            assert s.registry.replica_id == f"r{i}"
        # the router's own registry is the fleet view, not a replica
        assert router.registry.replica_id == ""

    def test_fleet_sources_wired_on_router_and_replicas(self):
        router, servers, _ = make_fleet(n=2)
        srcs = router.registry.fleet_sources()
        # the router's own registry rides first: the fleet-level cost
        # accounting (door hits/sheds, hedges) lives there
        assert list(srcs) == ["router", "r0", "r1"]
        assert srcs["router"] is router.registry
        assert srcs["r0"] is servers[0].registry
        # replicas can answer /fleet/* too (whoever owns the http port)
        assert servers[1].registry.fleet_sources() == srcs

    def test_fleet_sources_dedupe_shared_registry(self):
        """bench --serve-replicas wiring: router and replicas sharing
        ONE registry must merge as one source, not N copies (a /fleet
        scrape would otherwise report every counter at Nx truth)."""
        shared = Registry()
        servers = [FakeReplicaServer(registry=shared) for _ in range(3)]
        router = FleetRouter(servers, HParams(serve_replicas=3),
                             registry=shared, clock=_Clock().now)
        shared.counter("serve/completed_total").inc(5)
        srcs = router.registry.fleet_sources()
        assert list(srcs) == ["router"]
        from textsummarization_on_flink_tpu_torch.obs.registry import (
            merge_fleet_snapshot,
        )

        snap = merge_fleet_snapshot(srcs)
        assert snap["metrics"]["serve/completed_total"]["value"] == 5.0

    def test_request_events_carry_replica_tag(self):
        from textsummarization_on_flink_tpu_torch.obs.export import MemorySink

        _, servers, _ = make_fleet(n=2)
        reg = servers[0].registry
        sink = MemorySink()
        reg.event_sink = sink
        obs.spans.request_event(reg, "enqueue", None, "u1")
        (rec,) = sink.records()
        assert rec["replica"] == "r0"

    def test_fleet_metrics_merge_sums_replica_counters(self):
        router, servers, _ = make_fleet(n=2)
        servers[0].registry.counter("serve/completed_total").inc(2)
        servers[1].registry.counter("serve/completed_total").inc(5)
        from textsummarization_on_flink_tpu_torch.obs.registry import (
            merge_fleet_snapshot,
        )

        snap = merge_fleet_snapshot(router.registry.fleet_sources())
        assert snap["metrics"]["serve/completed_total"]["value"] == 7.0

    def test_hedge_spend_labeled_by_tenant(self):
        clock = _Clock()
        router, servers, _ = make_fleet(2, hedge_ms=50.0, ratio=1.0,
                                        clock=clock)
        fut = router.submit("a", uuid="u0", tenant="acme")
        clock.t = 0.1
        router.tick()
        reg = router.registry
        assert reg.counter("serve/hedges_total").labels(
            tenant="acme").value == 1
        twin = [s for s in servers if s.submits][-1]
        twin.resolve("u0", result="twin")
        assert fut.result(timeout=1) == "twin"
        assert reg.counter("serve/hedge_wins_total").labels(
            tenant="acme").value == 1
        # the unlabeled totals keep their historical meaning (roll-up)
        assert reg.counter("serve/hedges_total").value == 1

    def test_fleet_requests_total_labeled(self):
        router, servers, _ = make_fleet(n=2)
        router.submit("a", uuid="u0", tenant="acme", tier="greedy")
        c = router.registry.counter("serve/requests_total")
        assert c.labels(tenant="acme", tier="greedy").value == 1
        assert c.value == 1

    def test_fleet_shed_feeds_slo_burn_windows(self):
        """A fleet-ingress shed (tenant throttle, every replica full)
        is a BAD event for the SLO burn windows.  The router owns the
        fleet's ingress tracking (replica tracking is disabled), so
        without this a total admission outage at the fleet front door
        — the exact outage the engine pages on — would read as a
        healthy SLO."""
        from textsummarization_on_flink_tpu_torch.obs import slo as slo_lib
        from textsummarization_on_flink_tpu_torch.serve.errors import (
            TenantThrottledError,
        )

        clock = _Clock()
        reg = Registry()
        pol = {"windows": {"fast_secs": 10.0, "slow_secs": 100.0},
               "objectives": [{"name": "lat", "signal": "latency",
                               "by": "tenant",
                               "latency_threshold_ms": 1000.0,
                               "target": 0.9}]}
        slo_lib.install_slo_engine(reg, policy=pol, clock=clock.now)
        router, servers, _ = make_fleet(2, clock=clock, registry=reg,
                                        serve_tenant_rate=1.0,
                                        serve_tenant_burst=1)
        bad = reg.counter("slo/bad_total")
        router.submit("a", uuid="u0", tenant="evil")  # spends the burst
        with pytest.raises(TenantThrottledError):
            router.submit("a", uuid="u1", tenant="evil")
        assert bad.labels(objective="lat", key="evil").value == 1
        for h in router.replicas():  # fleet-wide overload: no rotation
            h.killed = True
        with pytest.raises(ServeOverloadError):
            router.submit("b", uuid="u2", tenant="evil")
        assert bad.labels(objective="lat", key="evil").value == 2

    def test_stop_retires_fleet_sources_everywhere(self):
        """A stopped fleet must not pin its replicas in memory through
        a long-lived registry nor keep answering /fleet/* with a dead
        fleet's registries."""
        router, servers, _ = make_fleet(n=2)
        assert router.registry.fleet_sources is not None
        router.stop()
        assert router.registry.fleet_sources is None
        assert all(s.registry.fleet_sources is None for s in servers)


# -- the scripted router scenario, JAX against the port ---------------------

PKGS = {
    "jax": types.SimpleNamespace(
        FleetRouter=jax_fleet.FleetRouter, Registry=jax_obs.Registry,
        ServeFuture=JaxServeFuture, errors=jax_errors,
        HParams=jax_config.HParams),
    "port": types.SimpleNamespace(
        FleetRouter=torch_fleet.FleetRouter, Registry=Registry,
        ServeFuture=ServeFuture, errors=torch_errors, HParams=HParams),
}

COUNTERS = ("serve/fleet_submitted_total", "serve/hedges_total",
            "serve/hedge_wins_total", "serve/hedge_suppressed_total",
            "serve/requeued_total", "serve/replica_kills_total",
            "serve/fleet_swaps_total")


def _fake_server_class(P):
    """The fake replica server of tests/test_fleet.py over package P's
    futures and errors, logging every routed submit."""

    class Fake:
        def __init__(self, name, routes):
            self.name = name
            self.routes = routes
            self.registry = P.Registry()
            self.base_load = 0
            self.admission = "closed"
            self.submits = []  # [(uuid, future)]
            self.killed = False
            self.swap_ok = True
            self.swaps = 0

        def stats(self):
            return {"queue_depth": self.base_load,
                    "serve_mode": "continuous", "admission": self.admission}

        def load(self):
            return self.base_load + len(self.pending())

        def pending(self):
            return [(u, f) for u, f in self.submits if not f.done()]

        def submit(self, article, uuid="", reference="", block=False,
                   timeout=None, tier="", trace=None, tenant=""):
            if self.killed:
                raise P.errors.ServeClosedError("killed")
            fut = P.ServeFuture(uuid, registry=self.registry)
            fut.trace = trace
            self.submits.append((uuid, fut))
            self.routes.append((uuid, self.name))
            return fut

        def kill(self, error=None):
            self.killed = True
            err = error or P.errors.ReplicaKilledError("killed")
            n = 0
            for _, f in self.pending():
                f._reject(err)
                n += 1
            return n

        def start(self):
            return self

        def stop(self, timeout=None):
            for _, f in self.pending():
                f._reject(P.errors.ServeClosedError("stopped"))

        def idle(self):
            return not self.pending()

        def hot_swap(self):
            self.swaps += 1
            return self.swap_ok

        def resolve_pending(self, n=None):
            for u, f in self.pending()[:n]:
                f._resolve(f"{self.name}:{u}")

    return Fake


#: (hedge_ms, hedge_max_ratio, replica_reset_secs) of each scripted run
SCENARIOS = [(50.0, 0.3, 2.0), (50.0, 1.0, 0.5), (20.0, 0.1, 1.0)]


def _scripted_run(P, hedge_ms, ratio, reset_secs):
    """Drive package P's router through the script; returns the
    per-tick record, the results and the done-callback counts."""
    clock = _Clock()
    routes = []
    Fake = _fake_server_class(P)
    servers = [Fake(f"s{i}", routes) for i in range(3)]
    reg = P.Registry()
    router = P.FleetRouter(
        servers, P.HParams(serve_hedge_ms=hedge_ms,
                           serve_hedge_max_ratio=ratio, serve_replicas=3),
        registry=reg, clock=clock.now, replica_reset_secs=reset_secs)
    futs, calls, trace = {}, {}, []

    def submit(lo, hi):
        for i in range(lo, hi):
            u = f"u{i}"
            futs[u] = router.submit("the cat sat .", uuid=u)
            futs[u].add_done_callback(
                lambda f, u=u: calls.__setitem__(u, calls.get(u, 0) + 1))

    def tick(label):
        router.tick()
        trace.append((
            label, clock.t,
            reg.gauge("serve/replicas_in_rotation").value,
            tuple(reg.counter(c).value for c in COUNTERS),
            tuple(h.rid for h in router.replicas() if h.draining),
            tuple(routes)))

    servers[0].base_load = 1
    submit(0, 6)
    tick("routed")
    clock.t = 0.01
    servers[1].admission = "open"  # r1 leaves rotation
    tick("r1 unhealthy")
    submit(6, 9)
    clock.t = 0.08  # u0..u5 are past the hedge budget
    tick("hedge scan")
    servers[0].resolve_pending(2)
    tick("r0 resolved two")
    router.kill_replica("r2")  # its requests requeue on the survivors
    tick("r2 killed")
    clock.t = 0.2
    tick("second hedge scan")
    clock.t = 3.0
    servers[1].admission = "closed"  # the half-open probe readmits r1
    tick("r1 probed")
    submit(9, 12)
    servers[0].swap_ok = False  # r0's reload fails: it keeps serving
    router.start_rolling_swap()
    for k in range(12):
        for h in router.replicas():
            if h.draining:
                h.server.resolve_pending()
        tick(f"swap {k}")
        if not router.swap_active():
            break
    for s in servers:
        s.resolve_pending()
    tick("drained")
    router.stop()
    results = {u: f.result(timeout=0) for u, f in futs.items()}
    return dict(trace=trace, results=results, calls=calls,
                swaps=[s.swaps for s in servers])


@pytest.mark.parametrize("hedge_ms,ratio,reset_secs", SCENARIOS)
def test_scripted_router_scenario_equals_jax(hedge_ms, ratio, reset_secs):
    """Routes, counters, rotation and drains tick by tick, the winning
    replica of every request, and the swaps are the JAX router's."""
    want = _scripted_run(PKGS["jax"], hedge_ms, ratio, reset_secs)
    got = _scripted_run(PKGS["port"], hedge_ms, ratio, reset_secs)
    for g, w in zip(got["trace"], want["trace"]):
        assert g == w
    assert len(got["trace"]) == len(want["trace"])
    assert got["results"] == want["results"]
    assert got["swaps"] == want["swaps"]


@pytest.mark.parametrize("hedge_ms,ratio,reset_secs", SCENARIOS)
def test_scripted_router_scenario_resolves_every_request_once(
        hedge_ms, ratio, reset_secs):
    """Under hedges, a kill and a failing swap: every router future
    resolves exactly once, hedges stay under the cap, at most one
    replica is out for the swap at any tick, and the killed replica is
    never swapped."""
    got = _scripted_run(PKGS["port"], hedge_ms, ratio, reset_secs)
    assert got["calls"] == {f"u{i}": 1 for i in range(12)}
    last = dict(zip(COUNTERS, got["trace"][-1][3]))
    assert last["serve/fleet_submitted_total"] == 12
    assert last["serve/hedges_total"] >= 1
    assert last["serve/hedges_total"] <= ratio * 12
    assert last["serve/requeued_total"] >= 1
    assert last["serve/replica_kills_total"] == 1
    assert last["serve/fleet_swaps_total"] == 2
    assert got["swaps"] == [1, 1, 0]
    assert all(len(rec[4]) <= 1 for rec in got["trace"])
    # the rotation gauge saw r1 leave and come back
    gauges = [rec[2] for rec in got["trace"]]
    assert gauges[1] == 2 and max(gauges[6:]) == 2


# -- the router over real servers -------------------------------------------

FLEET = dict(coverage=True, batch_size=4, serve_buckets="24",
             serve_max_wait_ms=20.0, serve_slots=4, serve_refill_chunk=2)
N_FLEET = 8


@pytest.fixture(scope="module")
def fleet_params():
    _, thps = make_hps(**FLEET)
    return decode_params(thps, len(PARITY_WORDS) + 4, seed=17)


def _server(pkg, hps, params, root):
    if pkg == "jax":
        return JaxServingServer(hps, JaxVocab(words=PARITY_WORDS),
                                params=params, decode_root=str(root),
                                registry=jax_obs.Registry())
    return ServingServer(hps, Vocab(words=PARITY_WORDS), params=params,
                         decode_root=str(root), registry=Registry())


def _hps(pkg, mode):
    jhps, thps = make_hps(serve_mode=mode, serve_replicas=2, **FLEET)
    return jhps if pkg == "jax" else thps


def _fleet_run(pkg, mode, params, root, kill_round=0):
    """N_FLEET articles through a 2-replica fleet of package `pkg`:
    threads in micro-batch mode; in continuous mode the router and the
    replicas' scheduler rounds driven on this thread, replica r-max
    killed at `kill_round`.  Returns ({uuid: words}, done calls, reg)."""
    P = PKGS[pkg]
    hps = _hps(pkg, mode)
    servers = [_server(pkg, hps, params, root / f"r{i}") for i in range(2)]
    reg = P.Registry()
    router = P.FleetRouter(servers, hps, registry=reg)
    calls = {}
    futs = []
    if mode == "microbatch":
        router.start()
    for i in range(N_FLEET):
        f = router.submit(article(i), uuid=f"a{i}")
        f.add_done_callback(
            lambda f: calls.__setitem__(f.uuid, calls.get(f.uuid, 0) + 1))
        futs.append(f)
    if mode == "continuous":
        rounds = 0
        while not all(f.done() for f in futs):
            rounds += 1
            assert rounds < 500, "the fleet did not converge"
            if rounds == kill_round:
                alive = [h for h in router.replicas() if not h.killed]
                victim = max(alive, key=lambda h: h.load())
                assert victim.server.load() > 0
                router.kill_replica(victim.rid)
            router.tick()
            for srv, h in zip(servers, router.replicas()):
                if not h.killed:
                    srv.tick_once(poll=0.0)
    res = [f.result(timeout=120) for f in futs]
    router.stop()
    return {r.uuid: r.decoded_words for r in res}, calls, reg


def _single_run(mode, params, root):
    hps = _hps("port", mode)
    server = _server("port", hps, params, root)
    futs = [server.submit(article(i), uuid=f"a{i}") for i in range(N_FLEET)]
    with server:
        return {f.result(timeout=120).uuid: f.result().decoded_words
                for f in futs}


@pytest.mark.parametrize("mode,kill_round", [("microbatch", 0),
                                             ("continuous", 2)])
def test_fleet_summaries_equal_jax_fleet_and_one_server(
        fleet_params, tmp_path, mode, kill_round):
    got, calls, reg = _fleet_run("port", mode, fleet_params,
                                 tmp_path / "port", kill_round)
    want, _, jreg = _fleet_run("jax", mode, fleet_params, tmp_path / "jax",
                               kill_round)
    single = _single_run(mode, fleet_params, tmp_path / "single")
    assert sorted(got) == [f"a{i}" for i in range(N_FLEET)]
    assert got == want == single
    assert any(got.values())
    assert calls == {f"a{i}": 1 for i in range(N_FLEET)}
    if kill_round:
        for r in (reg, jreg):
            assert r.counter("serve/replica_kills_total").value == 1
            assert r.counter("serve/requeued_total").value >= 1
        assert reg.counter("serve/requeued_total").value == \
            jreg.counter("serve/requeued_total").value
