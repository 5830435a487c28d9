"""Supervised OS-process replicas + socket transport (SERVING.md
"Process fleet", RESILIENCE.md "Process-grain failover").

A copy of the JAX package's serve/procfleet.py (the port imports nothing
of that package).  Each child is the port's ``serve-replica`` entry
point: it builds its ServingServer on ``hps.device`` (which travels in
``TS_HPS_JSON``), so a child on the card makes its own CUDA context and
loads the kernels the first launch builds (kernels/build.py renames each
library into place, so children never load a half-written one), and a
child without a card raises unless its HParams ask for the CPU.

The in-process fleet (serve/fleet.py) shares one address space: a
replica "kill" is a cooperative method call, and a wedged replica can
still take the whole process down with it.  This module breaks the
process boundary — each replica runs as its OWN supervised OS child
(``cli.py serve-replica``), so the failure unit the chaos suite
SIGKILLs is a real pid and the blast radius of a crash is one process:

  * ``ReplicaProcess``   — the supervisor for ONE child: spawn (HParams
    over the ``TS_HPS_JSON`` env), readiness handshake (the child
    publishes its bound ports through an atomically-renamed portfile,
    then must answer ``/healthz`` with status "ok" AND its own pid —
    a stale portfile left by a previous incarnation can never pass),
    restart-on-death under ``RetryPolicy`` decorrelated-jitter backoff,
    and crash-loop containment: a child that dies ``threshold``
    consecutive times without a stable run trips a ``CircuitBreaker``
    — held out of rotation for the reset window, flight-dumped
    (``flight_replica_crashloop.<rid>.jsonl``), surfaced on ``/alerts``
    as an incident, and thereafter restarted only at the breaker's
    half-open probe cadence, never spun forever.
  * ``RemoteReplica``    — the wire-side ``ServingServer`` surface the
    router drives: submits travel one persistent ingress socket as
    newline-delimited ``pipeline.io.Message`` JSON frames; results
    stream back over a reply socket read through ``ResilientSource``
    (reconnect + bounded-LRU dedup on ``(uuid, seq)`` — the child
    replays its retained reply ring on every reconnect, so replays are
    expected and deduped, while a RE-submitted uuid carries a fresh
    seq and passes).  A child death fails every in-flight future with
    the typed ``ReplicaKilledError`` the router's requeue path already
    understands — reconstructed purely from the supervisor's view
    (socket EOF + process exit), because a SIGKILLed child writes
    nothing on its way out.
  * ``RemoteReplicaHandle`` — the rotation view: ``healthy()`` scrapes
    the child's real ``/healthz`` (timeout-bounded, interval-cached so
    a wedged child costs ONE timeout per cache window, never a frozen
    router tick) and enforces pid incarnation.
  * ``ProcFleet``        — assembles N (supervisor, remote, handle)
    triples under one ``FleetRouter`` plus a supervision thread that
    ticks restarts and fires the ``serve.proc_kill`` chaos point
    (SIGKILL the most-loaded live child, never the last one standing).
  * ``replica_child_main`` — the child entry point behind
    ``python -m textsummarization_on_flink_tpu_torch.cli serve-replica``.

Exactly-once over flaky transport, end to end: the child's reply hub
assigns every outcome frame a monotonic ``seq`` and retains a bounded
ring; the supervisor's reader dedups ``(uuid, seq)``; the router-level
``_Routed`` future settles first-wins.  At-least-once delivery + dedup
+ single-settle = exactly-once, the same ledger the in-process fleet
proves, now across a process boundary.

The in-process fleet stays the default fast path and test substrate
(``serve_fleet_transport=inproc``); ``proc`` opts into real processes.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.obs import export as obs_export
from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs import http as obs_http
from textsummarization_on_flink_tpu_torch.obs import locksan
from textsummarization_on_flink_tpu_torch.pipeline.io import Message, ResilientSource
from textsummarization_on_flink_tpu_torch.resilience import faultinject
from textsummarization_on_flink_tpu_torch.resilience.policy import (
    CircuitBreaker,
    RetryPolicy,
)
from textsummarization_on_flink_tpu_torch.serve.errors import (
    ReplicaKilledError,
    ServeClosedError,
    ServeError,
    ServeOverloadError,
    TenantThrottledError,
)
from textsummarization_on_flink_tpu_torch.serve.queue import ServeFuture
from textsummarization_on_flink_tpu_torch.serve.router import ReplicaHandle

log = logging.getLogger(__name__)

LOOPBACK = "127.0.0.1"

# env contract between supervisor and child (all strings)
ENV_HPS = "TS_HPS_JSON"          # HParams.to_json() — the child's config
ENV_REPLICA_ID = "TS_REPLICA_ID"  # stamps events/flight dumps
ENV_PORTFILE = "TS_PORTFILE"     # where the child publishes bound ports
ENV_IN_FLEET = "TS_REPLICA_IN_FLEET"  # "1": disarm door + ingress count
ENV_STUB = "TS_REPLICA_STUB"     # "1": stub engine (process-machinery tests)
ENV_STUB_STEP_MS = "TS_REPLICA_STUB_STEP_MS"  # stub per-chunk wall cost

# the reply wire row: dedup key first (ResilientSource dedups row[0])
_REPLY_SCHEMA = ("dedup_key", "message")

# wire error name -> typed exception the router's requeue/shed logic
# already dispatches on; anything else arrives as plain ServeError
_WIRE_ERRORS: Dict[str, type] = {
    "ReplicaKilledError": ReplicaKilledError,
    "ServeClosedError": ServeClosedError,
    "ServeOverloadError": ServeOverloadError,
    "TenantThrottledError": TenantThrottledError,
    "ValueError": ValueError,
}


def _error_from_wire(wire: str) -> Exception:
    """``"ExcType: message"`` -> a typed exception (ServeError default)."""
    name, _, detail = wire.partition(":")
    cls = _WIRE_ERRORS.get(name.strip(), ServeError)
    return cls(detail.strip() or wire)


def _http_healthz(port: int, timeout_s: float) -> Optional[Dict[str, Any]]:
    """One timeout-bounded ``/healthz`` scrape -> payload dict or None.

    A 503 still carries the full payload (the "degraded" body), so it
    parses rather than erroring; only transport/parse failures are None.
    """
    url = f"http://{LOOPBACK}:{port}/healthz"
    try:
        try:
            with urllib.request.urlopen(url, timeout=timeout_s) as resp:
                body = resp.read()
        except urllib.error.HTTPError as e:
            body = e.read()
        payload = json.loads(body.decode("utf-8"))
        return payload if isinstance(payload, dict) else None
    except (OSError, ValueError):
        return None


# --------------------------------------------------------------------------
# Supervisor: one child process
# --------------------------------------------------------------------------

class ReplicaProcess:
    """Lifecycle supervisor for ONE replica child process.

    State machine (all transitions inside ``tick()``, driven by the
    fleet's supervision thread against an injectable clock):

        idle -> starting -> ready -> backoff -> starting -> ...
                                  \\-> stopped (graceful or halt)

    * starting: spawned, waiting for the portfile + a pid-matching
      ``/healthz`` "ok" within ``ready_timeout`` (miss = SIGKILL, death).
    * ready: serving; a poll() that returns is a death.
    * backoff: dead, next spawn gated by the RetryPolicy delay AND the
      crash-loop breaker — OPEN holds the replica out entirely;
      HALF_OPEN admits exactly one probe spawn, whose readiness (not
      mere survival) records the success that re-closes.
    * stopped: terminal; ``stop()`` walks the SIGTERM -> wait(term_grace)
      -> SIGKILL escalation ladder, ``halt()`` goes straight to SIGKILL.

    Crash-loop containment: ``threshold`` consecutive deaths without a
    ``crashloop_window``-long stable run trip the breaker; the first
    trip flight-dumps ``replica_crashloop`` and files an ``/alerts``
    incident.  A stable run records one success first, so the
    consecutive-death count measures a LOOP, not lifetime bad luck.
    """

    IDLE, STARTING, READY, BACKOFF, STOPPED = (
        "idle", "starting", "ready", "backoff", "stopped")

    def __init__(self, rid: str, cmd: List[str], env: Dict[str, str],
                 state_dir: str,
                 registry: Optional[obs.Registry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 ready_timeout: float = 60.0,
                 term_grace: float = 5.0,
                 restart_base_delay: float = 0.05,
                 restart_max_delay: float = 2.0,
                 seed: int = 0,
                 crashloop_threshold: int = 3,
                 crashloop_window: float = 30.0,
                 scrape_timeout: float = 0.25,
                 on_death: Optional[Callable[[Optional[int]], None]] = None,
                 on_ready: Optional[Callable[["ReplicaProcess"], None]] = None):
        self.rid = rid
        self.cmd = list(cmd)
        self.portfile = os.path.join(state_dir, f"replica-{rid}.ports.json")
        self._env = dict(env)
        self._env[ENV_REPLICA_ID] = rid
        self._env[ENV_PORTFILE] = self.portfile
        self._reg = registry if registry is not None else obs.registry()
        self._clock = clock
        self.ready_timeout = ready_timeout
        self.term_grace = term_grace
        self.crashloop_window = crashloop_window
        self._scrape_timeout = scrape_timeout
        self.on_death = on_death
        self.on_ready = on_ready
        # the crash-loop breaker IS the containment policy: consecutive
        # deaths trip it, reset_secs is the hold-out window, half-open
        # admits the single probe spawn
        self.breaker = CircuitBreaker(
            threshold=crashloop_threshold, reset_secs=crashloop_window,
            name=f"serve.replica.{rid}.crashloop", clock=clock,
            registry=self._reg)
        self._policy = RetryPolicy(
            base_delay=restart_base_delay, max_delay=restart_max_delay,
            seed=seed, name=f"serve.replica.{rid}.restart",
            registry=self._reg)
        self._c_deaths = self._reg.counter(
            "serve/replica_deaths_total").labels(replica=rid)
        self._c_restarts = self._reg.counter(
            "serve/replica_restarts_total").labels(replica=rid)
        self._c_crashloops = self._reg.counter(
            "serve/replica_crashloops_total").labels(replica=rid)
        self._lock = locksan.make_rlock("ReplicaProcess._lock")
        self.state = self.IDLE
        self.proc: Optional[subprocess.Popen] = None
        self.incarnation = 0
        self.deaths = 0
        self.last_exit_code: Optional[int] = None
        self._ports: Optional[Dict[str, Any]] = None
        self._ready_deadline = 0.0
        self._ready_at: Optional[float] = None
        self._next_restart_t = 0.0
        self._contained = False

    # -- queries --

    def ready(self) -> bool:
        with self._lock:
            return (self.state == self.READY and self.proc is not None
                    and self.proc.poll() is None)

    def pid(self) -> int:
        with self._lock:
            return self.proc.pid if self.proc is not None else -1

    def ports(self) -> Optional[Dict[str, Any]]:
        """The child's published port map, or None until the CURRENT
        incarnation has written it.  The portfile's own pid field is the
        staleness defense: a file left by a previous (or foreign)
        incarnation never resolves."""
        with self._lock:
            if self._ports is not None:
                return self._ports
            if self.proc is None:
                return None
            pid = self.proc.pid
        try:
            with open(self.portfile, "r", encoding="utf-8") as f:
                d = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(d, dict) or d.get("pid") != pid:
            return None  # stale incarnation — not OUR child's ports
        with self._lock:
            if self.proc is not None and self.proc.pid == pid:
                self._ports = d
        return d

    # -- lifecycle --

    def start(self) -> None:
        """Spawn the first incarnation (idempotent; terminal after
        stop/halt)."""
        with self._lock:
            if self.state == self.STOPPED:
                raise ServeClosedError(f"replica {self.rid} is stopped")
            if self.state == self.IDLE:
                self._spawn()

    def tick(self) -> None:
        """One supervision step: readiness probe, death detection,
        backoff-gated restart.  Never blocks past one scrape timeout."""
        with self._lock:
            state = self.state
            proc = self.proc
        if state == self.STARTING:
            assert proc is not None
            code = proc.poll()
            if code is not None:
                self._on_exit(code)
                return
            if self._check_ready():
                self._mark_ready()
                return
            if self._clock() >= self._ready_deadline:
                # wedged before ever answering /healthz: a hung child is
                # a dead child with worse manners — SIGKILL and account
                # it as a death (feeds the crash-loop breaker too)
                log.error("replica %s: not ready after %.1fs; killing",
                          self.rid, self.ready_timeout)
                self._signal(signal.SIGKILL)
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass
                self._on_exit(proc.poll())
            return
        if state == self.READY:
            assert proc is not None
            code = proc.poll()
            if code is not None:
                self._on_exit(code)
            return
        if state == self.BACKOFF:
            if self._clock() < self._next_restart_t:
                return
            # the containment gate: OPEN sheds the restart entirely;
            # HALF_OPEN hands out the single probe spawn
            if not self.breaker.allow():
                return
            with self._lock:
                if self.state == self.BACKOFF:
                    self._spawn()

    def kill_now(self) -> bool:
        """SIGKILL the live child (the ``serve.proc_kill`` chaos action
        and the smoke's mid-decode kill).  Supervision continues — the
        next tick detects the death and schedules the restart."""
        with self._lock:
            proc = self.proc
        if proc is not None and proc.poll() is None:
            self._signal(signal.SIGKILL)
            return True
        return False

    def halt(self) -> None:
        """Permanent SIGKILL-now stop (router ``kill_replica``
        semantics: the replica never rejoins)."""
        with self._lock:
            self.state = self.STOPPED
            proc = self.proc
        if proc is not None and proc.poll() is None:
            self._signal(signal.SIGKILL)
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass

    def stop(self) -> None:
        """Graceful stop: SIGTERM -> wait(term_grace) -> SIGKILL ->
        wait.  Terminal."""
        with self._lock:
            self.state = self.STOPPED
            proc = self.proc
        if proc is None or proc.poll() is not None:
            return
        self._signal(signal.SIGTERM)
        try:
            proc.wait(timeout=self.term_grace)
        except subprocess.TimeoutExpired:
            log.warning("replica %s: SIGTERM grace %.1fs expired; "
                        "escalating to SIGKILL", self.rid, self.term_grace)
            self._signal(signal.SIGKILL)
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass

    def restart_for_swap(self) -> None:
        """Rolling-swap restart: graceful ladder down, immediate fresh
        spawn (no backoff — this death was ASKED for, it must not feed
        the crash-loop count either)."""
        self.stop()
        with self._lock:
            self.state = self.IDLE
            self._spawn()

    # -- internals --

    def _spawn(self) -> None:
        # caller holds the lock
        try:
            os.unlink(self.portfile)
        except OSError:
            pass
        self._ports = None
        self._ready_at = None
        self.incarnation += 1
        if self.incarnation > 1:
            self._c_restarts.inc()
        self.proc = subprocess.Popen(self.cmd, env=self._env)
        self.state = self.STARTING
        self._ready_deadline = self._clock() + self.ready_timeout
        log.info("replica %s: spawned incarnation %d (pid %d)",
                 self.rid, self.incarnation, self.proc.pid)

    def _check_ready(self) -> bool:
        ports = self.ports()
        if ports is None:
            return False
        payload = _http_healthz(int(ports["obs_port"]), self._scrape_timeout)
        if payload is None:
            return False
        # incarnation identity: the scraped process must be the child we
        # spawned, not a survivor of a previous run squatting the port
        if payload.get("pid") != self.pid():
            return False
        return payload.get("status") == "ok"

    def _mark_ready(self) -> None:
        with self._lock:
            if self.breaker.state == CircuitBreaker.HALF_OPEN:
                # the probe spawn reached readiness: the loop is broken
                self.breaker.record_success()
                self._contained = False
            self.state = self.READY
            self._ready_at = self._clock()
        log.info("replica %s: ready (incarnation %d)",
                 self.rid, self.incarnation)
        if self.on_ready is not None:
            self.on_ready(self)

    def _on_exit(self, code: Optional[int]) -> None:
        now = self._clock()
        with self._lock:
            self.deaths += 1
            self.last_exit_code = code
            self._c_deaths.inc()
            # a crashloop_window-long stable run resets the CONSECUTIVE
            # death count — the breaker measures a loop, not a lifetime
            if (self._ready_at is not None
                    and now - self._ready_at >= self.crashloop_window):
                self.breaker.record_success()
            self.breaker.record_failure()
            tripped = (self.breaker.state == CircuitBreaker.OPEN
                       and not self._contained)
            if tripped:
                self._contained = True
            self._ports = None
            self._next_restart_t = now + self._policy.next_delay()
            if self.state != self.STOPPED:
                self.state = self.BACKOFF
        log.warning("replica %s: child died (exit %s, death %d)",
                    self.rid, code, self.deaths)
        if tripped:
            self._contain(code)
        if self.on_death is not None:
            self.on_death(code)

    def _contain(self, code: Optional[int]) -> None:
        """First breaker trip: count, flight-dump, file the incident.
        Restarts from here on happen only at half-open probe cadence."""
        self._c_crashloops.inc()
        log.error("replica %s: crash loop contained after %d deaths "
                  "(window %.1fs); held out of rotation",
                  self.rid, self.deaths, self.crashloop_window)
        flightrec.trigger(self._reg, "replica_crashloop",
                          replica=self.rid, exit_code=code,
                          deaths=self.deaths,
                          window_s=self.crashloop_window)
        obs_http.add_incident(self._reg, "replica_crashloop",
                              replica=self.rid, exit_code=code,
                              deaths=self.deaths,
                              window_s=self.crashloop_window)

    def _signal(self, sig: int) -> None:
        with self._lock:
            proc = self.proc
        if proc is None:
            return
        try:
            os.kill(proc.pid, sig)
        except (ProcessLookupError, PermissionError, OSError):
            pass


# --------------------------------------------------------------------------
# Supervisor: the wire-side server surface
# --------------------------------------------------------------------------

class _ReaderStopped(Exception):
    """Raised inside the reply factory to end the reader thread; NOT an
    OSError, so ResilientSource surfaces it instead of reconnecting."""


class _RemoteResult:
    """The resolved value of one remote decode: the DecodedResult
    surface downstream consumers read (summary/tier/fingerprint for the
    router's cache insert, ``as_row`` for sinks) rebuilt from the reply
    frame plus the submit-time registration."""

    __slots__ = ("uuid", "article", "summary", "reference", "tier",
                 "degraded", "params_fingerprint", "decoded_words")

    def __init__(self, uuid: str, article: str, summary: str,
                 reference: str, tier: str, params_fingerprint: str = ""):
        self.uuid = uuid
        self.article = article
        self.summary = summary
        self.reference = reference
        self.tier = tier
        self.degraded = False
        self.params_fingerprint = params_fingerprint
        self.decoded_words = summary.split()

    def as_row(self) -> Tuple[str, str, str, str]:
        return (self.uuid, self.article, self.summary, self.reference)


class _ReplySource:
    """pipeline.io Source over the child's reply socket.

    Yields ``((uuid, seq), Message)`` rows — the composite dedup key is
    what makes ring REPLAY (same uuid, same seq) collapse under
    ResilientSource's LRU while a router RE-submit of the same uuid
    (fresh seq) passes.  Port resolution happens inside ``rows()``: the
    wrapping ResilientSource constructs sources outside its retry
    window, so every fallible step must live in the iterator.

    EOF is NOT a clean end here: the child closing the stream means it
    died or restarted, so ``rows()`` raises ConnectionResetError to
    force the reconnect path (ResilientSource treats a clean return as
    stream-complete and would end supervision of a live fleet).
    """

    schema = _REPLY_SCHEMA

    def __init__(self, ports_fn: Callable[[], Optional[Dict[str, Any]]],
                 connect_timeout: float,
                 on_socket: Callable[[Optional[socket.socket]], None],
                 malformed_counter: Any):
        self._ports_fn = ports_fn
        self._timeout = connect_timeout
        self._on_socket = on_socket
        self._c_malformed = malformed_counter

    def rows(self):
        ports = self._ports_fn()  # raises _ReaderStopped on shutdown
        if ports is None:
            raise ConnectionRefusedError("reply port not published yet")
        sock = socket.create_connection(
            (LOOPBACK, int(ports["reply_port"])), timeout=self._timeout)
        self._on_socket(sock)
        try:
            sock.settimeout(None)  # stream reads block until EOF/close
            with sock.makefile("r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        d = json.loads(line)
                        seq = int(d.get("seq", -1))
                        msg = Message(uuid=d.get("uuid", ""),
                                      article=d.get("article", ""),
                                      summary=d.get("summary", ""),
                                      reference=d.get("reference", ""),
                                      tier=d.get("tier", ""),
                                      error=d.get("error", ""))
                    except (ValueError, TypeError, AttributeError):
                        self._c_malformed.inc()
                        log.warning("dropping malformed reply frame: %.120r",
                                    line)
                        continue
                    yield ((msg.uuid, seq), msg)
        finally:
            self._on_socket(None)
            try:
                sock.close()
            except OSError:
                pass
        raise ConnectionResetError(
            "reply stream EOF (child died or restarted)")


class RemoteReplica:
    """The ``ServingServer`` surface of one CHILD PROCESS, as the
    FleetRouter drives it: ``submit`` frames the request onto the
    ingress socket and returns a local ServeFuture; the reply-reader
    thread settles it from the child's outcome frame; a child death
    fails everything in flight with ``ReplicaKilledError`` so the
    router's existing requeue path replays orphans on survivors."""

    def __init__(self, rid: str, proc: ReplicaProcess, hps: Any,
                 registry: Optional[obs.Registry] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rid = rid
        self._proc = proc
        self._hps = hps
        self._router_reg = registry if registry is not None else obs.registry()
        # the identity registry the FleetRouter stamps (flight dumps,
        # /fleet source map); supervisor-side, so near-empty — the
        # child's real telemetry lives in ITS process
        self.registry = obs.Registry()
        self._clock = clock
        #: back-reference to the rotation handle (set by ProcFleet) so a
        #: detected death removes the replica from rotation immediately
        self.handle: Optional[ReplicaHandle] = None
        timeout_ms = getattr(hps, "serve_scrape_timeout_ms", 250.0)
        self._timeout_s = max(0.001, timeout_ms / 1000.0)
        interval_ms = getattr(hps, "serve_scrape_interval_ms", 50.0)
        self._scrape_interval_s = max(0.0, interval_ms / 1000.0)
        self._capacity = (int(getattr(hps, "serve_max_queue", 64))
                          + max(int(getattr(hps, "serve_slots", 0)),
                                int(getattr(hps, "serve_max_batch", 1)), 1))
        self._c_scrape_errors = self._router_reg.counter(
            "serve/replica_scrape_errors_total").labels(replica=rid)
        self._c_malformed = self._router_reg.counter(
            "serve/replica_reply_malformed_total").labels(replica=rid)
        self._lock = locksan.make_lock("RemoteReplica._lock")
        self._pending: Dict[str, List[Tuple[ServeFuture, str, str, str]]] = {}
        self._killed = False
        self._closed = False
        self._ingress_lock = locksan.make_lock("RemoteReplica._ingress_lock")
        self._ingress_sock: Optional[socket.socket] = None
        # guards the scrape cache + fingerprint (written by the router
        # thread AND the supervisor callbacks); the HTTP scrape itself
        # runs OUTSIDE it — a wedged child must not stall cache readers
        self._scrape_lock = locksan.make_lock("RemoteReplica._scrape_lock")
        self._reader: Optional[threading.Thread] = None
        self._reader_stop = threading.Event()
        self._reply_sock: Optional[socket.socket] = None
        self._scrape_cache: Optional[Dict[str, Any]] = None
        self._scrape_cache_t = -1.0
        self._fingerprint = ""

    # -- ServingServer surface --

    @property
    def killed(self) -> bool:
        return self._killed

    @property
    def params_fingerprint(self) -> str:
        """The child's last-scraped active fingerprint (rolling-swap
        bookkeeping; "" until a successful scrape reports one)."""
        return self._fingerprint

    def submit(self, article: str, uuid: str = "", reference: str = "",
               block: bool = False, timeout: Optional[float] = None,
               tier: str = "", trace: Optional[Any] = None,
               tenant: str = "") -> ServeFuture:
        """Frame one request onto the child's ingress socket.

        Typed shed semantics match the in-process server: closed/killed
        raises ``ServeClosedError``; a not-ready child, a full pending
        window, or a transport failure raise ``ServeOverloadError`` (a
        router-visible failure that trips the rotation breaker without
        burning the request)."""
        if self._killed or self._closed:
            raise ServeClosedError(f"replica {self.rid} is closed")
        if not self._proc.ready():
            raise ServeOverloadError(
                f"replica {self.rid} process is not ready")
        fut = ServeFuture(uuid, registry=self._router_reg)
        fut.trace = trace
        fut.scope = "replica"
        with self._lock:
            n = sum(len(v) for v in self._pending.values())
            if n >= self._capacity:
                raise ServeOverloadError(
                    f"replica {self.rid} pending window full "
                    f"({n}/{self._capacity})")
            # register BEFORE the send: the reply can race the return
            self._pending.setdefault(uuid, []).append(
                (fut, article, reference, tier))
        line = Message(uuid=uuid, article=article, reference=reference,
                       tier=tier).to_json()
        try:
            self._send_ingress(line)
        except OSError as e:
            with self._lock:
                entries = self._pending.get(uuid)
                if entries:
                    entries[:] = [t for t in entries if t[0] is not fut]
                    if not entries:
                        del self._pending[uuid]
            raise ServeOverloadError(
                f"replica {self.rid} ingress send failed: {e}") from e
        if block:
            fut.result(timeout)
        return fut

    def load(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    def stats(self) -> Dict[str, Any]:
        """The router-facing stats view, off the scrape cache (the
        child's admission breaker arrives via /healthz's breakers map —
        a remote can only ever see the scraped state)."""
        payload = self.scrape_healthz()
        breakers = (payload or {}).get("breakers", {})
        return {
            "queue_depth": self.load(),
            "serve_mode": getattr(self._hps, "serve_mode", ""),
            "admission": breakers.get("serve.admission",
                                      CircuitBreaker.CLOSED),
        }

    def start(self) -> None:
        self._proc.start()
        if self._reader is None or not self._reader.is_alive():
            self._reader_stop.clear()
            self._reader = threading.Thread(
                target=self._reader_main,
                name=f"ts-reply-reader-{self.rid}", daemon=True)
            self._reader.start()

    def idle(self) -> bool:
        """Drained: nothing pending HERE and the child reports an empty
        queue (rolling-swap gate)."""
        if self.load() > 0:
            return False
        payload = self.scrape_healthz()
        if payload is None:
            return False
        serve = payload.get("serve", {})
        return not serve.get("queue_depth", 0)

    def hot_swap(self) -> bool:
        """Rolling swap at process grain: restart the child, which
        reloads the newest checkpoint on boot.  Readmission happens via
        the rotation breaker's half-open probe once the fresh
        incarnation scrapes healthy."""
        try:
            self._proc.restart_for_swap()
            return True
        except Exception:  # tslint: disable=TS005 — logged and reported as a failed swap; the router counts it in serve/swaps_failed_total and keeps the old incarnation serving
            log.exception("replica %s: swap restart failed", self.rid)
            return False

    def kill(self, error: Optional[BaseException] = None) -> int:
        """Permanent kill (router ``kill_replica``): SIGKILL the child,
        stop supervising it, fail everything in flight."""
        err = error if error is not None else ReplicaKilledError(
            f"replica {self.rid} killed")
        self._killed = True
        self._proc.halt()
        n = self._fail_pending(err)
        self._close_ingress()
        return n

    def stop(self, timeout: float = 60.0) -> None:
        """Graceful stop: drain in-flight replies, walk the child down
        the SIGTERM escalation ladder, fail any leftovers typed."""
        self._closed = True
        deadline = time.monotonic() + max(0.0, timeout)
        while self.load() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        self._proc.stop()
        self._stop_reader()
        self._fail_pending(ServeClosedError(
            f"replica {self.rid} stopped with requests in flight"))
        self._close_ingress()

    def disable_ingress_tracking(self) -> None:
        pass  # the CHILD disarms its own counting (TS_REPLICA_IN_FLEET)

    def disable_front_door(self) -> None:
        pass  # likewise — router-level door is the only armed one

    # -- scrape path (RemoteReplicaHandle.healthy reads through this) --

    def scrape_healthz(self) -> Optional[Dict[str, Any]]:
        """Timeout-bounded, interval-cached ``/healthz`` scrape.

        The cache holds FAILURES too: a wedged child costs one
        ``serve_scrape_timeout_ms`` wait per ``serve_scrape_interval_ms``
        window, never a timeout per router tick."""
        now = self._clock()
        with self._scrape_lock:
            if (self._scrape_cache_t >= 0.0
                    and now - self._scrape_cache_t < self._scrape_interval_s):
                return self._scrape_cache
        # cache miss: scrape with NO lock held (two racing misses cost
        # one duplicate probe, last-write-wins — cheaper than every
        # reader waiting out a wedged child's timeout behind the lock)
        payload = None
        ports = self._proc.ports()
        if ports is not None:
            payload = _http_healthz(int(ports["obs_port"]), self._timeout_s)
        if payload is None:
            self._c_scrape_errors.inc()
        with self._scrape_lock:
            if payload is not None:
                fp = payload.get("serve", {}).get("params_fingerprint", "")
                if fp:
                    self._fingerprint = fp
            self._scrape_cache = payload
            self._scrape_cache_t = now
        return payload

    @property
    def pid(self) -> int:
        return self._proc.pid()

    # -- death / transport internals --

    def on_child_ready(self, proc: ReplicaProcess) -> None:
        """Supervisor readiness notification: drop the (negative) scrape
        cache so the router's next health probe sees the fresh
        incarnation instead of waiting out the cache window."""
        with self._scrape_lock:
            self._scrape_cache = None
            self._scrape_cache_t = -1.0

    def on_child_death(self, exit_code: Optional[int]) -> None:
        """Supervisor death notification: every in-flight future fails
        with the typed ``ReplicaKilledError`` the router requeues on —
        reconstructed purely from the supervisor's view (process exit +
        reply-socket EOF); a SIGKILLed child wrote nothing."""
        n = self._fail_pending(ReplicaKilledError(
            f"replica {self.rid} process died (exit {exit_code}) "
            f"with the request in flight"))
        if n:
            log.warning("replica %s: failed %d in-flight request(s) on "
                        "child death", self.rid, n)
        self._close_ingress()
        with self._scrape_lock:
            self._scrape_cache = None
            self._scrape_cache_t = -1.0  # next health read scrapes fresh
        h = self.handle
        if (h is not None and not h.killed
                and h.breaker.state == CircuitBreaker.CLOSED):
            # out of rotation NOW — don't wait for the next failed scrape
            h.breaker.record_failure()

    def _fail_pending(self, err: BaseException) -> int:
        with self._lock:
            pending = self._pending
            self._pending = {}
        n = 0
        for entries in pending.values():
            for fut, _, _, _ in entries:
                try:
                    fut._reject(err)
                    n += 1
                except Exception:  # tslint: disable=TS005 — a poisoned callback on one future must not strand its siblings unsettled; the rejection itself is the typed failure path
                    log.exception("replica %s: failed settling a future",
                                  self.rid)
        return n

    def _send_ingress(self, line: str) -> None:
        data = (line + "\n").encode("utf-8")
        for attempt in (0, 1):
            try:
                with self._ingress_lock:
                    sock = self._ingress_sock
                if sock is None:
                    # connect with NO lock held: a slow or refusing
                    # child costs the connecting thread one timeout,
                    # not every sender queued behind the lock (TS008)
                    ports = self._proc.ports()
                    if ports is None:
                        raise ConnectionRefusedError(
                            "ingress port not published")
                    fresh = socket.create_connection(
                        (LOOPBACK, int(ports["ingress_port"])),
                        timeout=self._timeout_s)
                    fresh.settimeout(self._timeout_s)
                    with self._ingress_lock:
                        if self._ingress_sock is None:
                            self._ingress_sock = fresh
                        else:
                            fresh.close()  # racing connector won
                with self._ingress_lock:
                    sock = self._ingress_sock
                    if sock is None:
                        raise OSError("ingress socket closed mid-send")
                    sock.sendall(data)  # tslint: disable=TS008 — one socket, interleaving-free framing REQUIRES serializing writers; bounded by settimeout(_timeout_s) above
                return
            except OSError:
                with self._ingress_lock:
                    self._close_ingress_locked()
                if attempt:
                    raise

    def _close_ingress(self) -> None:
        with self._ingress_lock:
            self._close_ingress_locked()

    def _close_ingress_locked(self) -> None:
        if self._ingress_sock is not None:
            try:
                self._ingress_sock.close()
            except OSError:
                pass
            self._ingress_sock = None

    def _stop_reader(self) -> None:
        self._reader_stop.set()
        sock = self._reply_sock
        if sock is not None:
            try:
                sock.close()  # unblocks the stream read with an OSError
            except OSError:
                pass
        reader = self._reader
        if reader is not None and reader.is_alive():
            reader.join(timeout=5.0)

    def _register_reply_sock(self, sock: Optional[socket.socket]) -> None:
        self._reply_sock = sock

    def _reply_factory(self) -> _ReplySource:
        return _ReplySource(self._reader_ports, self._timeout_s,
                            self._register_reply_sock, self._c_malformed)

    def _reader_ports(self) -> Optional[Dict[str, Any]]:
        if self._reader_stop.is_set():
            raise _ReaderStopped()
        return self._proc.ports()

    def _reader_sleep(self, delay: float) -> None:
        # interruptible backoff: shutdown never waits out a full delay
        if self._reader_stop.wait(delay):
            raise _ReaderStopped()

    def _reader_main(self) -> None:
        # ResilientSource IS the exactly-once reply transport: reconnect
        # with backoff across child restarts, LRU-dedup on (uuid, seq)
        # so ring replay collapses while re-submitted uuids pass
        src = ResilientSource(
            self._reply_factory, max_reconnects=1_000_000,
            base_delay=0.02, max_delay=0.5, seed=0,
            dedup=True, dedup_window=65536, schema=_REPLY_SCHEMA,
            sleep=self._reader_sleep)
        try:
            for _, msg in src.rows():
                self._on_reply(msg)
        except _ReaderStopped:
            pass
        except Exception:  # tslint: disable=TS005 — terminal reader failure: logged loudly; in-flight futures still fail typed via the death path, never silently hang
            if not self._reader_stop.is_set():
                log.exception("replica %s: reply reader died", self.rid)

    def _on_reply(self, msg: Message) -> None:
        with self._lock:
            entries = self._pending.get(msg.uuid)
            if not entries:
                # orphan frame: the future already settled (death path
                # beat the reply, or a replay outran the dedup window).
                # Dropping it is what keeps resolution exactly-once.
                return
            fut, article, reference, tier = entries.pop(0)
            if not entries:
                del self._pending[msg.uuid]
        try:
            if msg.error:
                fut._reject(_error_from_wire(msg.error))
            else:
                fut._resolve(_RemoteResult(
                    uuid=msg.uuid, article=article, summary=msg.summary,
                    reference=reference, tier=msg.tier or tier,
                    params_fingerprint=self._fingerprint))
        except Exception:  # tslint: disable=TS005 — a poisoned done-callback must not kill the reader thread that settles every OTHER reply
            log.exception("replica %s: failed settling reply %s",
                          self.rid, msg.uuid)


class RemoteReplicaHandle(ReplicaHandle):
    """Rotation state for a process replica: health comes from a REAL
    ``/healthz`` scrape of the child (timeout-bounded + interval-cached
    in RemoteReplica), gated on pid incarnation — a handle can never
    call a previous incarnation healthy."""

    def __init__(self, rid: str, remote: RemoteReplica,
                 registry: Optional[obs.Registry],
                 clock: Callable[[], float] = time.monotonic,
                 reset_secs: float = 1.0):
        super().__init__(rid, remote, registry=registry, clock=clock,
                         reset_secs=reset_secs)
        self.remote = remote

    def healthy(self) -> bool:
        payload = self.remote.scrape_healthz()
        if payload is None:
            return False  # unreachable/timed out/not started == unhealthy
        if payload.get("pid") != self.remote.pid:
            return False  # stale incarnation answering on a reused port
        return payload.get("status") == "ok"

    def load(self) -> int:
        return self.remote.load()


# --------------------------------------------------------------------------
# The assembled process fleet
# --------------------------------------------------------------------------

class ProcFleet:
    """N supervised child replicas behind one FleetRouter.

        fleet = ProcFleet(hps, registry=reg)
        fleet.start()
        fleet.wait_ready(timeout=60)
        fut = fleet.router.submit(article, uuid="u1")
        ...
        fleet.stop()

    The supervision thread ticks every child's restart state machine
    (~20 Hz) and fires the ``serve.proc_kill`` chaos point: SIGKILL the
    most-loaded live child, never the last one standing.  The router is
    the stock serve/fleet.py one — it adopts the pre-built
    RemoteReplicaHandles, so routing, requeue, hedging, and rolling
    swap are EXACTLY the in-process code paths over the wire surface.
    """

    SUPERVISE_PERIOD_S = 0.05

    def __init__(self, hps: Any,
                 registry: Optional[obs.Registry] = None,
                 state_dir: Optional[str] = None,
                 child_argv: Optional[List[str]] = None,
                 child_env: Optional[Dict[str, str]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 stub: bool = False,
                 replicas: Optional[int] = None,
                 ready_timeout: float = 60.0,
                 term_grace: float = 5.0,
                 crashloop_threshold: int = 3,
                 crashloop_window: float = 30.0,
                 restart_base_delay: float = 0.05,
                 restart_max_delay: float = 2.0,
                 replica_reset_secs: float = 1.0,
                 faults: Optional[Any] = None):
        n = replicas if replicas is not None \
            else int(getattr(hps, "serve_replicas", 1))
        if n < 1:
            raise ValueError(f"a process fleet needs >= 1 replica, got {n}")
        self._hps = hps
        self._reg = registry if registry is not None \
            else obs.registry_for(hps)
        self.state_dir = state_dir or tempfile.mkdtemp(prefix="ts-procfleet-")
        argv = list(child_argv) if child_argv is not None else [
            sys.executable, "-m", "textsummarization_on_flink_tpu_torch.cli",
            "serve-replica"]
        base_env = dict(os.environ if child_env is None else child_env)
        base_env[ENV_HPS] = hps.to_json()
        base_env[ENV_IN_FLEET] = "1"
        if stub:
            base_env[ENV_STUB] = "1"
        scrape_timeout_s = max(
            0.001, getattr(hps, "serve_scrape_timeout_ms", 250.0) / 1000.0)
        self.procs: List[ReplicaProcess] = []
        self.remotes: List[RemoteReplica] = []
        self.handles: List[RemoteReplicaHandle] = []
        handle_map: Dict[str, RemoteReplicaHandle] = {}
        for i in range(n):
            rid = f"p{i}"
            proc = ReplicaProcess(
                rid, argv, dict(base_env), self.state_dir,
                registry=self._reg, clock=clock,
                ready_timeout=ready_timeout, term_grace=term_grace,
                restart_base_delay=restart_base_delay,
                restart_max_delay=restart_max_delay, seed=i,
                crashloop_threshold=crashloop_threshold,
                crashloop_window=crashloop_window,
                scrape_timeout=scrape_timeout_s)
            remote = RemoteReplica(rid, proc, hps, registry=self._reg,
                                   clock=clock)
            handle = RemoteReplicaHandle(rid, remote, registry=self._reg,
                                         clock=clock,
                                         reset_secs=replica_reset_secs)
            remote.handle = handle
            proc.on_death = remote.on_child_death
            proc.on_ready = remote.on_child_ready
            self.procs.append(proc)
            self.remotes.append(remote)
            self.handles.append(handle)
            handle_map[rid] = handle
        self._faults = faults if faults is not None \
            else faultinject.plan_for(hps)
        # import here, not at module top: fleet.py imports router/obs
        # back and the lazy serve/__init__ hook keeps the cycle shallow
        from textsummarization_on_flink_tpu_torch.serve.fleet import FleetRouter

        self.router = FleetRouter(handle_map, hps, registry=self._reg,
                                  clock=clock, faults=self._faults)
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ProcFleet":
        """Spawn every child + reader, start routing + supervision."""
        self.router.start()  # calls RemoteReplica.start() per replica
        if self._thread is None or not self._thread.is_alive():
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._supervise_loop, name="ts-procfleet-supervise",
                daemon=True)
            self._thread.start()
        return self

    def wait_ready(self, timeout: float = 60.0) -> bool:
        """Block until every non-stopped child is ready AND its handle
        is back in routing rotation (True), or the deadline passes
        (False).  Rotation matters: a requeue can only land on an
        IN-ROTATION survivor, so callers that start killing before the
        rotation warmed up would see typed failures instead of
        failover."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            live = [p for p in self.procs if p.state != ReplicaProcess.STOPPED]
            if (live and all(p.ready() for p in live)
                    and all(h.in_rotation() for h in self.handles
                            if not h.killed)):
                return True
            time.sleep(0.02)
        return False

    def supervise_once(self) -> None:
        """One supervision pass (the thread's body; tests drive it
        directly for determinism)."""
        self._maybe_chaos_kill()
        for p in self.procs:
            try:
                p.tick()
            except Exception:  # tslint: disable=TS005 — one replica's broken state machine must not stop supervision of the others; the failure is logged every tick until fixed
                log.exception("supervision tick failed for replica %s",
                              p.rid)

    def stop(self, timeout: float = 60.0) -> None:
        """Supervision down FIRST (no restarts racing the shutdown),
        then the router's drain-and-stop walks each child down the
        SIGTERM escalation ladder."""
        self._stop_evt.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        self.router.stop(timeout=timeout)

    # -- internals --

    def _supervise_loop(self) -> None:
        while not self._stop_evt.wait(self.SUPERVISE_PERIOD_S):
            self.supervise_once()

    def _maybe_chaos_kill(self) -> None:
        if not self._faults.armed("serve.proc_kill"):
            return
        live = [p for p in self.procs if p.ready()]
        if len(live) < 2:
            return  # never orphan the whole fleet
        if not any(r.load() for r in self.remotes):
            return  # save the fire budget for a mid-decode kill
        if not self._faults.fire("serve.proc_kill"):
            return
        victim = max(live, key=lambda p: self._load_of(p.rid))
        log.warning("chaos: SIGKILLing replica %s (pid %d) mid-decode",
                    victim.rid, victim.pid())
        victim.kill_now()

    def _load_of(self, rid: str) -> int:
        for r in self.remotes:
            if r.rid == rid:
                return r.load()
        return 0


# --------------------------------------------------------------------------
# The child process
# --------------------------------------------------------------------------

class _ReplyHub:
    """The child's outcome-frame ledger: every settled request becomes
    one JSON frame stamped with a monotonic ``seq``, retained in a
    bounded ring.  Each reply connection REPLAYS the retained ring from
    the start before streaming new frames — at-least-once delivery; the
    supervisor's (uuid, seq) dedup makes it exactly-once."""

    def __init__(self, capacity: int = 65536):
        self._capacity = capacity
        self._cv = locksan.make_condition("_ReplyHub._cv")
        self._frames: List[str] = []
        self._base = 0  # absolute seq of _frames[0]
        self._next_seq = 0
        self._closed = False

    @property
    def capacity(self) -> int:
        """Ring size — must dominate one replica's in-flight capacity
        (SERVE_SLO.json process_fleet pins this) or a reconnect could
        replay past live work."""
        return self._capacity

    def publish(self, msg: Message) -> None:
        d = json.loads(msg.to_json())
        with self._cv:
            d["seq"] = self._next_seq
            self._next_seq += 1
            self._frames.append(json.dumps(d, sort_keys=True))
            overflow = len(self._frames) - self._capacity
            if overflow > 0:
                del self._frames[:overflow]
                self._base += overflow
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def stream(self, start: int = 0):
        """Yield frames from absolute seq `start` (oldest retained if
        the ring already dropped it), blocking for new ones until
        close()."""
        idx = start
        while True:
            with self._cv:
                if idx < self._base:
                    idx = self._base
                while (not self._closed
                       and idx >= self._base + len(self._frames)):
                    self._cv.wait(0.5)
                if idx < self._base + len(self._frames):
                    frame = self._frames[idx - self._base]
                    idx += 1
                else:
                    return  # closed and drained
            yield frame


class _StubDecoder:
    """Continuous mode drives the engine; only the between-chunk
    hot-swap hook is ever consulted."""

    params_fingerprint = "stub"

    def maybe_reload_checkpoint(self, last: float) -> float:
        return last


class _StubEngine:
    """SlotDecodeEngine over wall-clock sleeps: each request occupies a
    slot for a couple of chunks so a SIGKILL mid-decode really orphans
    in-flight work.  Process-machinery tests only (TS_REPLICA_STUB) —
    no params, no device dispatch, deterministic output."""

    CHUNKS_PER_REQUEST = 2

    def __init__(self, hps: Any, step_ms: float = 5.0):
        self.slots = int(getattr(hps, "serve_slots", 2))
        self.chunk = max(1, int(getattr(hps, "serve_refill_chunk", 1)))
        self._step_s = max(0.0, step_ms) / 1000.0
        self._remaining = [0] * self.slots
        self._active = [False] * self.slots

    def pack(self, idx: int, example: Any) -> None:
        self._active[idx] = True
        self._remaining[idx] = self.CHUNKS_PER_REQUEST

    def step(self) -> List[int]:
        time.sleep(self._step_s)
        fin = []
        for i in range(self.slots):
            if self._active[i]:
                self._remaining[i] -= 1
                if self._remaining[i] <= 0:
                    fin.append(i)
        return fin

    def unpack(self, idx: int, example: Any):
        from textsummarization_on_flink_tpu_torch.decode.decoder import DecodedResult

        self._active[idx] = False
        return DecodedResult(
            uuid=example.uuid, article=example.original_article,
            decoded_words=["ok", "."], reference=example.reference,
            abstract_sents=[])

    def release(self, idx: int) -> None:
        self._active[idx] = False


def _build_child_server(hps: HParams, reg: obs.Registry, rid: str):
    """The child's ServingServer: stub engine for process-machinery
    tests, otherwise the real decoder over seed-deterministic params (or
    the newest checkpoint when a train_dir exists)."""
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.serve.server import ServingServer

    if hps.vocab_path:
        vocab = Vocab(hps.vocab_path, hps.vocab_size)
    else:
        vocab = Vocab(words=[f"w{i}" for i in range(32)])
    decode_root = tempfile.mkdtemp(prefix=f"ts-replica-{rid}-decode-")
    if os.environ.get(ENV_STUB):
        step_ms = float(os.environ.get(ENV_STUB_STEP_MS, "5"))
        return ServingServer(hps, vocab, decoder=_StubDecoder(),
                             engine=_StubEngine(hps, step_ms=step_ms),
                             registry=reg, decode_root=decode_root)
    train_dir = os.path.join(hps.log_root or ".", hps.exp_name or "exp",
                             "train")
    if hps.log_root and os.path.isdir(train_dir):
        return ServingServer(hps, vocab, train_dir=train_dir,
                             registry=reg, decode_root=decode_root)
    from textsummarization_on_flink_tpu_torch.params import tree_map
    from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib

    # seed-deterministic init on hps.device: every replica (and the
    # parent's solo baseline) materializes the SAME params from the
    # same seed
    params = tree_map(lambda t: t.detach(), trainer_lib.init_train_state(
        hps, vocab.size()).params)
    return ServingServer(hps, vocab, params=params, registry=reg,
                         decode_root=decode_root)


def _child_submit(server: Any, hub: _ReplyHub, msg: Message) -> None:
    """Admit one ingress frame; every outcome (sync shed included)
    becomes exactly one reply frame."""
    try:
        fut = server.submit(msg.article, uuid=msg.uuid,
                            reference=msg.reference, tier=msg.tier,
                            block=False)
    except Exception as e:  # tslint: disable=TS005 — the catch IS the wire error path: the type+message cross back as an error frame and re-raise typed in the supervisor
        hub.publish(Message(uuid=msg.uuid, reference=msg.reference,
                            tier=msg.tier,
                            error=f"{type(e).__name__}: {e}"))
        return
    ref, tier = msg.reference, msg.tier

    def _done(f: Any) -> None:
        err = f.error
        if err is not None:
            hub.publish(Message(uuid=msg.uuid, reference=ref, tier=tier,
                                error=f"{type(err).__name__}: {err}"))
            return
        res = f.result()
        hub.publish(Message(uuid=msg.uuid, summary=res.summary,
                            reference=ref,
                            tier=getattr(res, "tier", tier) or tier))

    fut.add_done_callback(_done)


def _ingress_conn(conn: socket.socket, server: Any, hub: _ReplyHub) -> None:
    try:
        with conn, conn.makefile("r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = Message.from_json(line)
                except (ValueError, TypeError, KeyError):
                    log.warning("dropping malformed ingress frame: %.120r",
                                line)
                    continue
                _child_submit(server, hub, msg)
    except OSError:
        pass


def _reply_conn(conn: socket.socket, hub: _ReplyHub) -> None:
    try:
        with conn:
            # replay-from-start of the retained ring: at-least-once; the
            # supervisor's (uuid, seq) dedup collapses the replays
            for frame in hub.stream(0):
                conn.sendall((frame + "\n").encode("utf-8"))
    except OSError:
        pass


def _accept_loop(listener: socket.socket, stop_evt: threading.Event,
                 handler: Callable[[socket.socket], None],
                 name: str) -> None:
    while not stop_evt.is_set():
        try:
            conn, _ = listener.accept()
        except OSError:
            return  # listener closed at shutdown
        t = threading.Thread(target=handler, args=(conn,),
                             name=name, daemon=True)
        t.start()


def _publish_launches(child_dir: Optional[str],
                      last: Optional[Dict[str, int]],
                      ) -> Optional[Dict[str, int]]:
    """Write this child's kernel launch counts (ops.launch_counts) to
    ``<child_dir>/kernel_launches.<pid>.json`` when they changed since
    ``last`` (atomically: a SIGKILL leaves the last whole write, at most
    one poll old), so the supervisor's caller can add the launches made
    in the children to its own.  Returns the counts written."""
    if child_dir is None:
        return last
    from textsummarization_on_flink_tpu_torch import ops

    counts = ops.launch_counts()
    if counts == last:
        return last
    path = os.path.join(child_dir, f"kernel_launches.{os.getpid()}.json")
    with open(path + ".tmp", "w", encoding="utf-8") as f:
        json.dump(counts, f)
    os.replace(path + ".tmp", path)
    return counts


def replica_child_main(argv: Optional[List[str]] = None) -> int:
    """The ``cli.py serve-replica`` entry point: build the ServingServer
    from TS_HPS_JSON, bind obs-HTTP + ingress + reply sockets on
    ephemeral ports, publish them through the portfile handshake, serve
    until SIGTERM."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    argv = list(argv or [])
    rid = os.environ.get(ENV_REPLICA_ID, "p0")
    hps_json = os.environ.get(ENV_HPS, "")
    hps = HParams.from_json(hps_json) if hps_json \
        else HParams.from_argv(argv)
    hps.validate()
    reg = obs.Registry()
    flightrec.set_replica_id(reg, rid)  # before any frame is recorded
    child_dir = None
    if hps.log_root:
        child_dir = os.path.join(hps.log_root, hps.exp_name or "exp",
                                 f"replica-{rid}")
        os.makedirs(child_dir, exist_ok=True)
        obs_export.install_event_sink(reg, child_dir)
        flightrec.install_flight_recorder(reg, child_dir)
    server = _build_child_server(hps, reg, rid)
    if os.environ.get(ENV_IN_FLEET):
        # behind a router the ROUTER owns the caller-visible request
        # count and the front door; mirror serve/fleet.py's disarm
        server.disable_ingress_tracking()
        server.disable_front_door()
    stop_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda s, f: stop_evt.set())
    signal.signal(signal.SIGINT, lambda s, f: stop_evt.set())

    obs_srv = obs_http.ObsHttpServer(reg, port=0).start()
    hub = _ReplyHub()
    ingress = socket.create_server((LOOPBACK, 0))
    reply = socket.create_server((LOOPBACK, 0))
    server.start()
    threading.Thread(
        target=_accept_loop,
        args=(ingress, stop_evt,
              lambda c: _ingress_conn(c, server, hub), "ts-ingress"),
        name="ts-ingress-accept", daemon=True).start()
    threading.Thread(
        target=_accept_loop,
        args=(reply, stop_evt, lambda c: _reply_conn(c, hub), "ts-reply"),
        name="ts-reply-accept", daemon=True).start()

    # the readiness handshake: ports land in the portfile ATOMICALLY
    # (tmp + rename — the supervisor never reads a torn write) once the
    # server is actually accepting; pid stamps the incarnation
    ports = {
        "pid": os.getpid(),
        "start_time": time.time(),
        "replica_id": rid,
        "obs_port": obs_srv.port,
        "ingress_port": ingress.getsockname()[1],
        "reply_port": reply.getsockname()[1],
    }
    portfile = os.environ.get(ENV_PORTFILE, "")
    if portfile:
        tmp = portfile + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(ports, f, sort_keys=True)
        os.replace(tmp, portfile)
    print(json.dumps(ports, sort_keys=True), flush=True)
    log.info("replica %s serving (pid %d, obs=%d ingress=%d reply=%d)",
             rid, ports["pid"], ports["obs_port"], ports["ingress_port"],
             ports["reply_port"])

    published = None
    while not stop_evt.wait(0.2):
        published = _publish_launches(child_dir, published)
    log.info("replica %s: SIGTERM — draining and stopping", rid)
    try:
        server.stop(timeout=10.0)
        _publish_launches(child_dir, published)
    finally:
        sink = reg.event_sink
        if sink is not None:
            # a SIGTERM'd survivor is the chaos gate's WITNESS: its
            # events.jsonl must carry every buffered lifecycle record
            try:
                sink.close()
            except Exception:  # tslint: disable=TS005 — best-effort flush on the shutdown path; a sink failure must not block the child's exit ladder
                log.exception("event sink close failed")
        hub.close()
        for s in (ingress, reply):
            try:
                s.close()
            except OSError:
                pass
        obs_srv.close()
    return 0


__all__ = [
    "ProcFleet", "RemoteReplica", "RemoteReplicaHandle", "ReplicaProcess",
    "replica_child_main",
]
