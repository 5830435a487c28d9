"""The port's process fleet (serve/procfleet.py) on the CPU.

The JAX package's process-fleet cases (tests/test_procfleet.py) against
the port's classes: the scrape timeout, the stale portfile, the ring
replay deduplicated on (uuid, seq), the orphan frame, the error frame,
the crash-loop breaker, the half-open readmission, the fleet serving
around a crash-looping replica, and the lock discipline of the scrape
and ingress paths.  Then two fleets of real port children
(``python -m textsummarization_on_flink_tpu_torch.cli serve-replica``):
two stub children, one SIGKILLed mid-request (the requeue, the restart
and exactly-once), and one child over a tiny real model on the CPU whose
summaries equal an in-process port server's.
"""

import glob
import json
import os
import socket
import sys
import threading
import time

import pytest

from _torch_parity import WORDS as PARITY_WORDS
from _torch_parity import article, decode_params, make_hps
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab as PortVocab
from textsummarization_on_flink_tpu_torch.obs import Registry
from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs import http as obs_http
from textsummarization_on_flink_tpu_torch.pipeline.io import Message, \
    ResilientSource
from textsummarization_on_flink_tpu_torch.resilience.policy import CircuitBreaker
from textsummarization_on_flink_tpu_torch.serve import procfleet
from textsummarization_on_flink_tpu_torch.serve.errors import ServeOverloadError
from textsummarization_on_flink_tpu_torch.serve.queue import ServeFuture
from textsummarization_on_flink_tpu_torch.serve.server import (
    ServingServer as PortServingServer,
)
from textsummarization_on_flink_tpu_torch.train import trainer as port_trainer

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

CRASH_CMD = [sys.executable, "-c", "raise SystemExit(13)"]
SLEEP_CMD = [sys.executable, "-c", "import time; time.sleep(600)"]


def _hps(**overrides):
    base = dict(mode="decode", batch_size=2, vocab_size=8, max_enc_steps=8,
                max_dec_steps=4, min_dec_steps=1, beam_size=2,
                max_oov_buckets=2, serve_max_queue=8, serve_slots=2,
                device="cpu")
    base.update(overrides)
    return HParams(**base)


class _FakeProc:
    """The ReplicaProcess surface RemoteReplica reads, without an OS
    child: tests point ``ports`` at their own sockets."""

    def __init__(self, ports=None, pid=-1):
        self.rid = "r0"
        self._ports = ports
        self._pid = pid

    def ports(self):
        return self._ports

    def pid(self):
        return self._pid

    def ready(self):
        return True

    def start(self):
        pass


# -- explicit scrape timeouts ----------------------------------------------

class TestScrapeTimeout:
    @pytest.fixture
    def hung_port(self):
        """A listener that accepts and then never speaks: the wedged
        child's /healthz."""
        srv = socket.create_server(("127.0.0.1", 0))
        held = []
        stop = threading.Event()

        def accept_loop():
            srv.settimeout(0.2)
            while not stop.is_set():
                try:
                    conn, _ = srv.accept()
                    held.append(conn)  # keep it open, say nothing
                except OSError:
                    continue

        t = threading.Thread(target=accept_loop, daemon=True)
        t.start()
        yield srv.getsockname()[1]
        stop.set()
        t.join(timeout=2.0)
        for c in held:
            c.close()
        srv.close()

    def test_hung_healthz_costs_one_timeout_not_a_frozen_router(
            self, hung_port):
        """A child whose /healthz
        hangs must cost the router ONE serve_scrape_timeout_ms wait per
        scrape window — the failure is cached, so the tick loop (which
        calls healthy() every rotation refresh) never blocks again
        until the window rolls."""
        hps = _hps(serve_scrape_timeout_ms=150.0,
                   serve_scrape_interval_ms=60_000.0)
        reg = Registry()
        remote = procfleet.RemoteReplica(
            "r0", _FakeProc(ports={"obs_port": hung_port}, pid=4242),
            hps, registry=reg)
        handle = procfleet.RemoteReplicaHandle("r0", remote, registry=reg)

        t0 = time.monotonic()
        assert remote.scrape_healthz() is None
        first = time.monotonic() - t0
        assert 0.1 <= first < 2.0, (
            f"scrape took {first:.3f}s — the timeout is not bounding it")
        errors = reg.counter(
            "serve/replica_scrape_errors_total").labels(replica="r0")
        assert errors.value == 1

        # 50 rotation refreshes against the wedged child: all served
        # from the (negative) cache — no further timeout waits, no
        # further error counts, and the handle reads unhealthy
        t0 = time.monotonic()
        for _ in range(50):
            assert not handle.healthy()
        assert time.monotonic() - t0 < 0.1, (
            "cached scrape failures are re-scraping inside the window")
        assert errors.value == 1

    def test_scrape_recovers_when_child_answers(self):
        """The same path against a LIVE /healthz: payload lands, the
        fingerprint is cached, the handle turns healthy only when the
        pid matches the supervisor's incarnation view."""
        reg_child = Registry()
        reg_child.replica_id = "r0"
        with obs_http.ObsHttpServer(reg_child, port=0).start() as srv:
            hps = _hps(serve_scrape_interval_ms=0.0)
            reg = Registry()
            remote = procfleet.RemoteReplica(
                "r0", _FakeProc(ports={"obs_port": srv.port},
                                pid=os.getpid()),
                hps, registry=reg)
            handle = procfleet.RemoteReplicaHandle("r0", remote,
                                                   registry=reg)
            payload = remote.scrape_healthz()
            assert payload is not None and payload["status"] == "ok"
            assert payload["pid"] == os.getpid()
            assert handle.healthy()
            # wrong incarnation: same port answering, different pid
            remote2 = procfleet.RemoteReplica(
                "r0", _FakeProc(ports={"obs_port": srv.port}, pid=99999),
                hps, registry=Registry())
            handle2 = procfleet.RemoteReplicaHandle(
                "r0", remote2, registry=Registry())
            assert not handle2.healthy()


# -- portfile handshake ----------------------------------------------------

class TestPortfileHandshake:
    def test_stale_portfile_never_resolves(self, tmp_path):
        """ports() pid-checks the portfile: a file written by a
        previous (or foreign) incarnation is invisible — readiness can
        only pass against OUR child's published ports."""
        proc = procfleet.ReplicaProcess(
            "r0", SLEEP_CMD, dict(os.environ), str(tmp_path),
            registry=Registry())
        proc.start()
        try:
            assert proc.ports() is None  # child never writes one
            stale = {"pid": proc.pid() + 12345, "obs_port": 1,
                     "ingress_port": 2, "reply_port": 3}
            with open(proc.portfile, "w", encoding="utf-8") as f:
                json.dump(stale, f)
            assert proc.ports() is None, (
                "a portfile with a foreign pid resolved — stale "
                "incarnations can pass readiness")
            good = dict(stale, pid=proc.pid())
            with open(proc.portfile, "w", encoding="utf-8") as f:
                json.dump(good, f)
            assert proc.ports() == good
        finally:
            proc.halt()

    def test_spawn_unlinks_previous_portfile(self, tmp_path):
        """A restart must not race against the corpse's portfile: the
        fresh spawn removes it before the child can be probed."""
        proc = procfleet.ReplicaProcess(
            "r0", SLEEP_CMD, dict(os.environ), str(tmp_path),
            registry=Registry(), restart_base_delay=0.01,
            restart_max_delay=0.02)
        proc.start()
        try:
            with open(proc.portfile, "w", encoding="utf-8") as f:
                json.dump({"pid": proc.pid(), "obs_port": 1,
                           "ingress_port": 2, "reply_port": 3}, f)
            assert proc.ports() is not None
            proc.restart_for_swap()
            assert not os.path.exists(proc.portfile)
            assert proc.ports() is None
            assert proc.incarnation == 2
        finally:
            proc.halt()


# -- exactly-once reply transport ------------------------------------------

class _ReplayServer:
    """A fake child reply port that DIES once: connection 1 streams its
    frames then drops (the restart); connection 2 REPLAYS the ring from
    the start plus the post-restart frames — the at-least-once behavior
    _ReplyHub really has."""

    def __init__(self, first, second):
        self._payloads = [first, second]
        self.done = threading.Event()
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        for i, frames in enumerate(self._payloads):
            conn, _ = self._srv.accept()
            for frame in frames:
                conn.sendall((frame + "\n").encode("utf-8"))
            if i == len(self._payloads) - 1:
                self.done.set()
            conn.close()
        self._srv.close()


def _frame(uuid, seq, summary="s ."):
    d = json.loads(Message(uuid, f"article {uuid}", summary=summary,
                           reference="r").to_json())
    d["seq"] = seq
    return json.dumps(d, sort_keys=True)


class TestReplyExactlyOnce:
    def test_ring_replay_across_restart_dedups_on_uuid_seq(self):
        """Ring replay end to end at the transport layer:
        uuid X delivered, the stream dies, the reconnect replays X
        (same seq) before the new frame Y — the ResilientSource LRU
        collapses the replay, while a RE-submitted X under a fresh seq
        (a router requeue landing back here) passes."""
        srv = _ReplayServer(
            first=[_frame("X", 0)],
            second=[_frame("X", 0), _frame("Y", 1), _frame("X", 7)])

        def ports_fn():
            if srv.done.is_set():
                raise procfleet._ReaderStopped()
            return {"reply_port": srv.port}

        seen = []
        source = ResilientSource(
            lambda: procfleet._ReplySource(
                ports_fn, 5.0, lambda s: None,
                Registry().counter("x").labels(replica="r0")),
            max_reconnects=1_000_000, base_delay=0.001, max_delay=0.001,
            seed=0, dedup=True, dedup_window=65536,
            schema=procfleet._REPLY_SCHEMA, sleep=lambda d: None)
        with pytest.raises(procfleet._ReaderStopped):
            for key, msg in source.rows():
                seen.append((msg.uuid, key[1]))
        assert seen == [("X", 0), ("Y", 1), ("X", 7)], (
            f"replayed frames leaked through the dedup window: {seen}")

    def test_orphan_reply_frame_is_dropped_not_double_resolved(self):
        """Above the transport: _on_reply settles the FIFO pending
        entry exactly once; a second frame for the same uuid (a replay
        that outran the dedup window, or a reply racing the death path)
        finds no pending entry and is dropped."""
        remote = procfleet.RemoteReplica("r0", _FakeProc(), _hps(),
                                         registry=Registry())
        fut = ServeFuture("X")
        remote._pending["X"] = [(fut, "article X", "ref", "")]
        remote._on_reply(Message("X", "article X", summary="ok .",
                                 reference="ref"))
        res = fut.result(timeout=1)
        assert (res.summary, res.reference) == ("ok .", "ref")
        assert remote.load() == 0
        # the replay: no pending entry -> dropped, result unchanged
        remote._on_reply(Message("X", "article X", summary="DIFFERENT",
                                 reference="ref"))
        assert fut.result(timeout=1).summary == "ok ."

    def test_error_frame_rejects_typed(self):
        """A child-side shed crosses the wire as ``error`` and rejects
        the local future with the SAME exception type the in-process
        server would have raised — the router's shed accounting cannot
        tell the transports apart."""
        remote = procfleet.RemoteReplica("r0", _FakeProc(), _hps(),
                                         registry=Registry())
        fut = ServeFuture("Y")
        remote._pending["Y"] = [(fut, "a", "r", "")]
        remote._on_reply(Message("Y", "a",
                                 error="ServeOverloadError: queue full"))
        with pytest.raises(ServeOverloadError, match="queue full"):
            fut.result(timeout=1)


# -- crash-loop containment ------------------------------------------------

class TestCrashLoop:
    def _drive_to_containment(self, proc, deadline_s=30.0):
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            proc.tick()
            if proc.breaker.state == CircuitBreaker.OPEN:
                return
            time.sleep(0.01)
        pytest.fail(f"crash-loop breaker never tripped "
                    f"(deaths={proc.deaths}, state={proc.state})")

    def test_crashloop_trips_breaker_dumps_flight_files_incident(
            self, tmp_path):
        """The containment gate: a child dying K consecutive times
        trips the breaker, counts the crashloop, dumps the flight ring,
        files the /alerts incident — and restarts STOP (no spawn storm)
        until the half-open probe window."""
        reg = Registry()
        flightrec.install_flight_recorder(reg, str(tmp_path))
        proc = procfleet.ReplicaProcess(
            "p0", CRASH_CMD, dict(os.environ), str(tmp_path),
            registry=reg, restart_base_delay=0.01, restart_max_delay=0.02,
            crashloop_threshold=2, crashloop_window=600.0)
        proc.start()
        self._drive_to_containment(proc)
        proc.halt()

        assert proc.deaths >= 2
        assert proc.last_exit_code == 13
        spawned = proc.incarnation
        assert spawned <= 3, (
            f"{spawned} spawns before containment — the breaker is not "
            f"bounding the restart storm")
        # OPEN sheds every restart: ticks do not spawn incarnations
        for _ in range(25):
            proc.tick()
        assert proc.incarnation == spawned
        crashloops = reg.counter(
            "serve/replica_crashloops_total").labels(replica="p0")
        assert crashloops.value == 1
        deaths = reg.counter(
            "serve/replica_deaths_total").labels(replica="p0")
        assert deaths.value == proc.deaths
        dumps = glob.glob(str(tmp_path / "flight_replica_crashloop*.jsonl"))
        assert dumps, "containment did not dump the flight ring"
        with open(dumps[0], "r", encoding="utf-8") as f:
            header = json.loads(f.readline())
        assert header["reason"] == "replica_crashloop"
        kinds = [i["kind"] for i in obs_http.incidents(reg)]
        assert "replica_crashloop" in kinds, (
            "the crashloop never reached the /alerts incident feed")

    def test_half_open_probe_readmits_a_recovered_child(self, tmp_path):
        """After the hold-out window the breaker hands out ONE probe
        spawn; a child that stays up closes the breaker and clears
        containment (driven on an injected clock — no wall-clock
        waits on the window)."""
        clock = [100.0]
        reg = Registry()
        proc = procfleet.ReplicaProcess(
            "p0", SLEEP_CMD, dict(os.environ), str(tmp_path),
            registry=reg, clock=lambda: clock[0],
            restart_base_delay=0.01, restart_max_delay=0.02,
            crashloop_threshold=1, crashloop_window=30.0)
        # one death trips the threshold-1 breaker
        proc.state = proc.BACKOFF
        proc.incarnation = 1
        proc._on_exit(13)
        assert proc.breaker.state == CircuitBreaker.OPEN
        assert proc._contained
        clock[0] += 0.05
        proc.tick()  # inside the hold-out: OPEN sheds the restart
        assert proc.proc is None and proc.incarnation == 1
        clock[0] += 31.0  # the window rolls -> half-open probe spawn
        proc.tick()
        try:
            assert proc.state == proc.STARTING and proc.incarnation == 2
            # fake the probe reaching readiness (the sleep child has no
            # obs plane): _mark_ready closes the breaker + uncontains
            proc._mark_ready()
            assert proc.breaker.state == CircuitBreaker.CLOSED
            assert not proc._contained
        finally:
            proc.halt()

    def test_fleet_keeps_serving_around_a_crashlooping_replica(
            self, tmp_path):
        """The acceptance clause: one replica crash-looping into
        containment must not take the fleet down — its handle leaves
        rotation on the first detected death and every request resolves
        on the healthy replica."""
        from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
        from textsummarization_on_flink_tpu_torch.decode.decoder import \
            DecodedResult
        from textsummarization_on_flink_tpu_torch.serve.fleet import FleetRouter
        from textsummarization_on_flink_tpu_torch.serve.server import \
            ServingServer

        class _NullDecoder:
            def maybe_reload_checkpoint(self, last):
                return last

        class _OkEngine:
            """2-slot, 2-chunk-per-request sim engine (no device)."""

            def __init__(self):
                self.slots, self.chunk = 2, 1
                self._rem = [0, 0]

            def pack(self, idx, ex):
                self._rem[idx] = 2
                self._ex = getattr(self, "_ex", {})
                self._ex[idx] = ex

            def step(self):
                fin = []
                for i in range(self.slots):
                    if self._rem[i] > 0:
                        self._rem[i] -= 1
                        if self._rem[i] == 0:
                            fin.append(i)
                return fin

            def unpack(self, idx, ex):
                return DecodedResult(
                    uuid=ex.uuid, article=ex.original_article,
                    decoded_words=["ok", "."], reference=ex.reference,
                    abstract_sents=[])

            def release(self, idx):
                self._rem[idx] = 0

        reg = Registry()
        vocab = Vocab(words=["w"])
        hps = _hps(serve_mode="continuous", serve_refill_chunk=1,
                   serve_replicas=2, vocab_size=vocab.size())
        good = ServingServer(hps, vocab, decoder=_NullDecoder(),
                             engine=_OkEngine(), registry=Registry())

        proc = procfleet.ReplicaProcess(
            "bad", CRASH_CMD, dict(os.environ), str(tmp_path),
            registry=reg, restart_base_delay=0.01, restart_max_delay=0.02,
            crashloop_threshold=2, crashloop_window=600.0)
        remote = procfleet.RemoteReplica("bad", proc, hps, registry=reg)
        bad = procfleet.RemoteReplicaHandle("bad", remote, registry=reg)
        remote.handle = bad
        proc.on_death = remote.on_child_death

        router = FleetRouter({"good": good, "bad": bad}, hps, registry=reg)
        proc.start()
        self._drive_to_containment(proc)
        assert not bad.in_rotation(), (
            "a crash-looping replica is still in routing rotation")

        futs = [router.submit("w w .", uuid=f"u{i}") for i in range(4)]
        rounds = 0
        while not all(f.done() for f in futs):
            rounds += 1
            assert rounds < 500, "fleet did not drain around the corpse"
            router.tick()
            good.tick_once(poll=0.0)
        assert [f.result(timeout=1).uuid for f in futs] == \
            [f"u{i}" for i in range(4)]
        router.stop()
        proc.halt()


# -- lock discipline on the scrape and ingress paths -----------------------

class TestScrapeLockDiscipline:
    """The scrape cache is
    lock-protected, but the HTTP probe itself must run with NO lock
    held — a wedged child costs the scraping thread one timeout, never
    every reader queued behind the scrape lock."""

    def _remote(self, payloads):
        hps = HParams(serve_scrape_timeout_ms=150.0,
                      serve_scrape_interval_ms=60_000.0, device="cpu")
        remote = procfleet.RemoteReplica(
            "r0", _FakeProc(ports={"obs_port": 1}), hps,
            registry=Registry())
        return remote

    def test_http_probe_runs_outside_the_scrape_lock(self, monkeypatch):
        remote = self._remote(None)
        held_during_http = []

        def fake_healthz(port, timeout_s):
            held_during_http.append(remote._scrape_lock.locked())
            return {"serve": {"params_fingerprint": "fp0"}}

        monkeypatch.setattr(procfleet, "_http_healthz", fake_healthz)
        assert remote.scrape_healthz() is not None
        assert held_during_http == [False], (
            "the HTTP scrape ran WITH the scrape lock held — a wedged "
            "child would stall every cache reader for the timeout")
        assert remote.params_fingerprint == "fp0"
        # cache hit: no second probe inside the window
        assert remote.scrape_healthz() is not None
        assert len(held_during_http) == 1

    def test_supervisor_invalidation_races_cleanly_with_a_scrape(
            self, monkeypatch):
        """on_child_ready/on_child_death clear the cache under the same
        lock the scraper writes through: an invalidation landing MID
        scrape must neither crash nor be silently lost forever — the
        next read re-probes within one window."""
        remote = self._remote(None)
        in_http = threading.Event()
        release_http = threading.Event()

        def fake_healthz(port, timeout_s):
            in_http.set()
            release_http.wait(timeout=5.0)
            return {"serve": {}}

        monkeypatch.setattr(procfleet, "_http_healthz", fake_healthz)
        t = threading.Thread(target=remote.scrape_healthz)
        t.start()
        assert in_http.wait(timeout=5.0)
        remote.on_child_death(exit_code=9)  # must not block on the probe
        release_http.set()
        t.join(timeout=5.0)
        assert not t.is_alive()
        # last-write-wins is allowed; what is NOT allowed is a wedge or
        # an exception — and a fresh scrape still works afterward
        remote.on_child_ready(remote._proc)
        assert remote.scrape_healthz() is not None


class TestIngressLockDiscipline:
    """Connection ESTABLISHMENT happens with the
    ingress lock dropped (a refusing/slow child stalls one connector,
    not every sender); only the sendall stays serialized."""

    def _remote(self, port):
        hps = HParams(serve_scrape_timeout_ms=200.0, device="cpu")
        return procfleet.RemoteReplica(
            "r0", _FakeProc(ports={"ingress_port": port, "obs_port": 1}),
            hps, registry=Registry())

    def test_connect_runs_outside_the_ingress_lock(self, monkeypatch):
        srv = socket.create_server(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        remote = self._remote(port)
        held_during_connect = []
        real_connect = socket.create_connection

        def spy_connect(addr, timeout=None):
            held_during_connect.append(remote._ingress_lock.locked())
            return real_connect(addr, timeout=timeout)

        monkeypatch.setattr(procfleet.socket, "create_connection",
                            spy_connect)
        try:
            remote._send_ingress("hello")
            conn, _ = srv.accept()
            conn.settimeout(2.0)
            assert conn.recv(64) == b"hello\n"
            conn.close()
        finally:
            remote._close_ingress()
            srv.close()
        assert held_during_connect == [False], (
            "socket.create_connection ran WITH _ingress_lock held — "
            "every sender stalls for the connect timeout")

    def test_refused_connect_still_raises_after_retry(self, monkeypatch):
        # a dead port: both attempts fail, the typed OSError surfaces,
        # and the lock is left unheld for the next submit
        srv = socket.create_server(("127.0.0.1", 0))
        port = srv.getsockname()[1]
        srv.close()  # nothing listens here any more
        remote = self._remote(port)
        attempts = []
        real_connect = socket.create_connection

        def spy_connect(addr, timeout=None):
            attempts.append(remote._ingress_lock.locked())
            return real_connect(addr, timeout=timeout)

        monkeypatch.setattr(procfleet.socket, "create_connection",
                            spy_connect)
        with pytest.raises(OSError):
            remote._send_ingress("hello")
        assert attempts == [False, False]
        assert not remote._ingress_lock.locked()


# -- real port children ----------------------------------------------------

def _child_env(**extra):
    """The children run ``python -m textsummarization_on_flink_tpu_torch.cli
    serve-replica`` from this checkout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update(extra)
    return env


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    pytest.fail(f"timed out waiting for {what}")


def test_child_argv_is_the_port_cli():
    fleet = procfleet.ProcFleet(_hps(serve_replicas=1), registry=Registry(),
                                stub=True)
    assert fleet.procs[0].cmd[1:] == [
        "-m", "textsummarization_on_flink_tpu_torch.cli", "serve-replica"]
    assert json.loads(fleet.procs[0]._env[procfleet.ENV_HPS])["device"] == \
        "cpu"


def test_sigkilled_stub_child_requeues_restarts_and_resolves_once(
        tmp_path):
    """Two stub children; the one holding requests is SIGKILLed
    mid-request: its requests requeue on the survivor, every router
    future resolves exactly once, and the victim comes back as
    incarnation 2 through the half-open probe."""
    hps = _hps(serve_mode="continuous", serve_refill_chunk=1,
               serve_replicas=2, log_root=str(tmp_path), exp_name="exp")
    reg = Registry()
    os.makedirs(tmp_path / "state")
    fleet = procfleet.ProcFleet(
        hps, registry=reg, stub=True, state_dir=str(tmp_path / "state"),
        child_env=_child_env(**{procfleet.ENV_STUB_STEP_MS: "150"}),
        ready_timeout=60.0, replica_reset_secs=0.2)
    fleet.start()
    try:
        assert fleet.wait_ready(timeout=60.0)
        pids = [p.pid() for p in fleet.procs]
        calls = {}
        futs = []
        for i in range(6):
            f = fleet.router.submit("w w .", uuid=f"u{i}")
            f.add_done_callback(lambda f: calls.__setitem__(
                f.uuid, calls.get(f.uuid, 0) + 1))
            futs.append(f)
        victim = max(fleet.remotes, key=lambda r: r.load())
        assert victim.load() > 0
        proc = fleet.procs[fleet.remotes.index(victim)]
        assert proc.kill_now()
        res = [f.result(timeout=60) for f in futs]
        assert [r.uuid for r in res] == [f"u{i}" for i in range(6)]
        assert all(r.summary == "ok ." for r in res)
        assert calls == {f"u{i}": 1 for i in range(6)}
        assert reg.counter("serve/requeued_total").value >= 1
        _wait(lambda: proc.incarnation == 2 and proc.ready(), 60,
              "the victim's restart")
        assert fleet.wait_ready(timeout=30.0)
        assert proc.pid() not in pids
        assert reg.counter("serve/replica_restarts_total").labels(
            replica=proc.rid).value == 1
        # the readmitted child serves again
        again = fleet.router.submit("w .", uuid="again").result(timeout=30)
        assert again.uuid == "again"
    finally:
        fleet.stop(timeout=10.0)
    assert all(p.proc.poll() is not None for p in fleet.procs)


def test_cpu_child_over_a_real_model_equals_an_in_process_server(tmp_path):
    """One child on device="cpu" over a tiny pointer-generator
    checkpoint: its summaries are the in-process port server's."""
    _, thps = make_hps(coverage=True, batch_size=4, serve_buckets="24",
                       serve_max_wait_ms=20.0)
    vsize = len(PARITY_WORDS) + 4
    with open(tmp_path / "vocab", "w", encoding="utf-8") as f:
        f.writelines(f"{w} 1\n" for w in PARITY_WORDS)
    hps = thps.replace(vocab_path=str(tmp_path / "vocab"), vocab_size=vsize,
                       log_root=str(tmp_path), exp_name="exp",
                       serve_replicas=1)
    train_dir = str(tmp_path / "exp" / "train")
    state = port_trainer.init_train_state(
        hps, vsize, params=decode_params(thps, vsize, seed=17))
    ckpt_lib.Checkpointer(train_dir, hps=hps).save(state)
    server = PortServingServer(hps, PortVocab(hps.vocab_path, vsize),
                               train_dir=train_dir,
                               decode_root=str(tmp_path / "dec"),
                               registry=Registry())
    futs = [server.submit(article(i), uuid=f"a{i}") for i in range(6)]
    with server:
        want = {f.result(timeout=120).uuid: f.result().summary
                for f in futs}
    os.makedirs(tmp_path / "state")
    fleet = procfleet.ProcFleet(hps, registry=Registry(),
                                state_dir=str(tmp_path / "state"),
                                # a CPU child beside the test workers:
                                # few threads, or they oversubscribe
                                child_env=_child_env(OMP_NUM_THREADS="2"),
                                ready_timeout=90.0)
    fleet.start()
    try:
        assert fleet.wait_ready(timeout=90.0)
        futs = [fleet.router.submit(article(i), uuid=f"a{i}")
                for i in range(6)]
        got = {f.result(timeout=120).uuid: f.result().summary
               for f in futs}
    finally:
        fleet.stop(timeout=10.0)
    assert got == want
    assert any(want.values())
    assert fleet.procs[0].proc.poll() is not None
