"""Live telemetry exposition plane (piece 2).

``obs.render_text()`` has promised a Prometheus scrape surface since
the start ("text exposition is Prometheus-style so a scrape endpoint can
be bolted on without touching call sites"); this module bolts it on.
One stdlib ``ThreadingHTTPServer`` — no new dependencies — bound to
**localhost only** (the plane exposes internal state; anything wider is
a reverse proxy's job), OFF by default and enabled per process via
``TS_OBS_HTTP=<port>`` or per job via ``HParams(obs_http_port=...)``.

Endpoints (all GET, all read-only):

  * ``/metrics``  — ``registry.render_text()`` verbatim (text/plain):
    what Prometheus scrapes is byte-identical to what the in-process
    exposition renders, asserted by test;
  * ``/healthz``  — component liveness: heartbeats registered by the
    trainer loop / serve dispatch thread / EventSink flusher
    (``obs.heartbeat(name, period)``) plus every circuit breaker's
    state; any STALE HEARTBEAT flips the JSON status to "degraded" and
    the HTTP status to 503 (load balancers understand).  Breaker states
    are reported but informational — see health() for why 503-ing an
    open admission breaker would pin it open;
  * ``/snapshot`` — ``registry.snapshot(compact=True)`` as JSON, plus
    the registry's ``health_info`` facts under a ``health_info`` key
    (one scrape carries metrics + health context);
  * ``/spans``    — the newest buffered spans as unified event records
    (``?n=<count>``, default 200);
  * ``/alerts``   — the SLO burn-rate engine's per-objective states as
    of the last dispatch-tick evaluation (obs/slo.py ``alerts_payload``
    — read-only like every route here; a quiet ok when none is
    installed);
  * ``/exemplars`` — every histogram's stamped per-bucket trace
    exemplars as JSON (the ``--request <trace_id>`` jump-off point);
  * ``/fleet/metrics`` + ``/fleet/snapshot`` — the merged fleet view
    over the registries ``registry.fleet_sources`` names (wired by the
    FleetRouter; 404 with a hint on a fleetless registry): counters
    summed, gauges ``replica=``-labeled, histograms bucket-merged
    (obs/registry.py ``render_fleet_text`` / ``merge_fleet_snapshot``).

Staleness is computed from each component's own declared period (stale
= age > STALE_FACTOR * period) on the injectable monotonic clock, so
tests flip /healthz without sleeping.
"""

from __future__ import annotations

import http.server
import json
import logging
import os
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, Optional, Tuple

from textsummarization_on_flink_tpu_torch.obs import profile as profile_lib
from textsummarization_on_flink_tpu_torch.obs import slo as slo_lib
from textsummarization_on_flink_tpu_torch.obs import spans as spans_lib
from textsummarization_on_flink_tpu_torch.obs.registry import (
    Registry,
    _series_key,
    merge_fleet_snapshot,
    render_fleet_text,
)

log = logging.getLogger(__name__)

#: a heartbeat is stale once its age exceeds this many of its own
#: declared periods (3x tolerates one missed beat plus scheduling slop
#: without masking a genuinely wedged component)
STALE_FACTOR = 3.0

#: the declared period for the train/serve LOOP heartbeats (one beat
#: per iteration): deliberately generous — a single iteration
#: legitimately blocks for a first-call jit compile, a checkpoint
#: save, or the windowed metrics D2H, and none of those may 503 a
#: healthy process; steady-state wedges still surface within
#: STALE_FACTOR * this (~6 minutes).  ONE constant so the two loops'
#: /healthz semantics can never drift.
LOOP_HEARTBEAT_PERIOD = 120.0

_BREAKER_STATES = {0: "closed", 1: "half_open", 2: "open"}

#: wall-clock start of THIS process, captured at import: with the pid
#: it forms the /healthz incarnation identity — a replica
#: supervisor distinguishes a restarted child (new pid/start_time) from
#: a wedged old one answering on a stale port
_PROCESS_START_TIME = time.time()


class HeartbeatBoard:
    """Component liveness: name -> (last beat, declared period).

    ``beat()`` is the hot-path side (one dict store under a lock per
    loop iteration); ``status()`` is the scrape side.  The clock is
    injectable so staleness tests never sleep.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._beats: Dict[str, Tuple[float, float]] = {}

    def beat(self, name: str, period: float = 10.0) -> None:
        with self._lock:
            self._beats[name] = (self._clock(), float(period))

    def retire(self, name: str) -> None:
        """Deregister a component that legitimately finished (a trainer
        that completed, a server that stopped): its silence is not a
        failure and must not hold /healthz at 503 for the rest of the
        process."""
        with self._lock:
            self._beats.pop(name, None)

    def status(self, stale_factor: float = STALE_FACTOR,
               ) -> Dict[str, Dict[str, Any]]:
        """{name: {age_seconds, period_seconds, ok}} — ok=False once the
        age exceeds stale_factor x the component's own period."""
        now = self._clock()
        with self._lock:
            beats = dict(self._beats)
        return {
            name: {
                "age_seconds": round(now - last, 3),
                "period_seconds": period,
                "ok": (now - last) <= stale_factor * period,
            }
            for name, (last, period) in sorted(beats.items())
        }


_board_init_lock = threading.Lock()


def board_for(registry: Registry) -> HeartbeatBoard:
    """The registry's heartbeat board, created on first use (same
    double-checked pattern as spans.tracer_for)."""
    b = registry.heartbeats
    if b is None:
        with _board_init_lock:
            b = registry.heartbeats
            if b is None:
                b = HeartbeatBoard()
                registry.heartbeats = b
    return b


def heartbeat(registry: Registry, name: str, period: float = 10.0) -> None:
    """Record one liveness beat for `name` (no-op when disabled)."""
    if not registry.enabled:
        return
    board_for(registry).beat(name, period=period)


def retire_heartbeat(registry: Registry, name: str) -> None:
    """Deregister `name` from `registry`'s board (component finished
    cleanly); no-op when disabled or never registered."""
    if not registry.enabled or registry.heartbeats is None:
        return
    registry.heartbeats.retire(name)


def set_health_info(registry: Registry, **info: Any) -> None:
    """Publish non-numeric health facts (e.g. the serving layer's
    effective ``serve_mode``) into `registry`'s /healthz payload.
    No-op when the registry is disabled."""
    if not registry.enabled:
        return
    current = getattr(registry, "health_info", None)
    if current is None:
        registry.health_info = dict(info)
    else:
        current.update(info)


#: ceiling on retained incidents per registry: incidents are rare,
#: page-worthy state transitions (a crash-looping replica), not an
#: event stream — a bounded deque-style list keeps /alerts small
_MAX_INCIDENTS = 64


def add_incident(registry: Registry, kind: str, **fields: Any) -> None:
    """File one page-worthy incident (e.g. ``replica_crashloop``) onto
    `registry`'s /alerts payload.  Incidents are the
    non-SLO alert channel: the burn-rate engine prices request
    outcomes, while an incident records a STATE the operator must act
    on (a replica held out of rotation).  No-op when disabled."""
    if not registry.enabled:
        return
    row = {"kind": kind, **fields}
    current = getattr(registry, "incidents", None)
    if current is None:
        registry.incidents = [row]
    else:
        current.append(row)
        del current[:-_MAX_INCIDENTS]


def incidents(registry: Registry) -> list:
    """The registry's filed incidents, newest last ([] when none)."""
    return list(getattr(registry, "incidents", None) or ())


#: gauges the /healthz body surfaces as routing inputs (the
#: FleetRouter's least-loaded pick reads queue depth and free slots off
#: each replica's health plane — they must be scrapeable, not in-process
#: only).  Reported only when the gauge exists on the registry.
_SERVE_HEALTH_GAUGES = (
    ("queue_depth", "serve/queue_depth"),
    ("slots_free", "serve/slots_free"),
)


def health(registry: Registry,
           stale_factor: float = STALE_FACTOR) -> Dict[str, Any]:
    """The /healthz payload: heartbeat statuses + breaker states.

    Only a STALE HEARTBEAT degrades ("stale-heartbeat ->
    degraded").  Breaker states are reported but informational, for two
    reasons: the ``*/breaker_state`` gauge only refreshes on the next
    ``allow()`` call, so an OPEN reading may already be past its reset
    window; and 503-ing on an open ADMISSION breaker is a
    self-sustaining trap — the load balancer drains the instance, no
    traffic arrives, no half-open probe ever runs, and the breaker can
    never close again.  Scrapers that want to alert on breakers read
    the ``breakers`` map (or /metrics) directly."""
    components = (board_for(registry).status(stale_factor)
                  if registry.enabled else {})
    breakers: Dict[str, str] = {}
    for name in registry.names():
        if not name.endswith("/breaker_state"):
            continue
        metric = registry.get(name)
        code = int(getattr(metric, "value", 0))
        # resilience/<name>/breaker_state -> <name>
        short = name[len("resilience/"):-len("/breaker_state")] \
            if name.startswith("resilience/") else name
        breakers[short] = _BREAKER_STATES.get(code, str(code))
    # serving routing inputs: queue depth / free slots off
    # the existing gauges plus any published facts (effective
    # serve_mode).  Informational like the breakers — they never flip
    # the 503; the FleetRouter (and any external LB) reads them to pick
    # the least-loaded replica without a second endpoint.
    serve: Dict[str, Any] = {}
    names = set(registry.names())
    for key, metric in _SERVE_HEALTH_GAUGES:
        if metric in names:
            serve[key] = getattr(registry.get(metric), "value", 0)
    info = getattr(registry, "health_info", None)
    if info:
        serve.update(info)
    degraded = any(not c["ok"] for c in components.values())
    payload: Dict[str, Any] = {
        "status": "degraded" if degraded else "ok",
        "components": components,
        "breakers": breakers,
        # incarnation identity: pid + process start time +
        # stamped replica id let a process supervisor verify WHICH
        # incarnation answered — a stale portfile pointing at a
        # previous (or foreign) pid must not pass readiness
        "pid": os.getpid(),
        "start_time": _PROCESS_START_TIME,
        "replica_id": getattr(registry, "replica_id", "") or "",
    }
    if serve:
        payload["serve"] = serve
    return payload


def exemplars(registry: Registry) -> list:
    """The /exemplars payload: every histogram series' stamped
    per-bucket trace exemplars — [{metric, le, trace_id, value}], the
    machine-readable side of the OpenMetrics ``# {trace_id=...}``
    annotations /metrics renders (``scripts/trace_summary.py
    --request <trace_id>`` turns any row into a full request
    timeline)."""
    return [{"metric": _series_key(name, labels_kv), **ex}
            for name, labels_kv, kind, payload in registry.series()
            if kind == "histogram"
            for ex in payload["exemplars"]]


class _Handler(http.server.BaseHTTPRequestHandler):
    """Routes the four endpoints over the registry the server wraps."""

    server_version = "ts-obs/1"
    registry: Registry = None  # type: ignore[assignment] # set per server

    # -- plumbing --
    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("obs-http %s", fmt % args)  # never spam stderr

    def _send(self, code: int, body: bytes,
              content_type: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-write; nothing to recover

    def _send_json(self, code: int, payload: Any) -> None:
        self._send(code, (json.dumps(payload) + "\n").encode("utf-8"))

    # -- routes --
    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        parsed = urllib.parse.urlparse(self.path)
        route = parsed.path.rstrip("/") or "/"
        reg = self.registry
        try:
            if route == "/metrics":
                # exemplar annotations are OPENMETRICS syntax — a
                # Prometheus text-format (0.0.4) parser rejects the
                # trailing `# {...}` as an invalid timestamp and fails
                # the whole scrape, so the annotated body is served
                # only to scrapers whose Accept header negotiates it
                # (/exemplars carries the same data as JSON regardless)
                openmetrics = "openmetrics" in (
                    self.headers.get("Accept") or "")
                self._send(
                    200,
                    reg.render_text(exemplars=openmetrics,
                                    openmetrics=openmetrics).encode("utf-8"),
                    content_type=(
                        "application/openmetrics-text; version=1.0.0; "
                        "charset=utf-8" if openmetrics
                        else "text/plain; version=0.0.4"))
            elif route == "/healthz":
                payload = health(reg)
                self._send_json(200 if payload["status"] == "ok" else 503,
                                payload)
            elif route == "/snapshot":
                snap: Dict[str, Any] = reg.snapshot(compact=True)
                # the fleet routing inputs
                # (serve_mode, params_fingerprint, replica, ...) ride
                # the snapshot so one scrape carries metrics + health
                # context together
                info = getattr(reg, "health_info", None)
                if info:
                    snap["health_info"] = dict(info)
                self._send_json(200, snap)
            elif route == "/spans":
                qs = urllib.parse.parse_qs(parsed.query)
                try:
                    n = max(1, int(qs.get("n", ["200"])[0]))
                except ValueError:
                    n = 200
                recs = spans_lib.tracer_for(reg).finished() if reg.enabled \
                    else []
                self._send_json(200, [r.as_event() for r in recs[-n:]])
            elif route == "/alerts":
                payload = slo_lib.alerts_payload(reg)
                # the profiler's cached divergence state rides the same
                # scrape — read-only, like the SLO rows
                payload["profile"] = profile_lib.profile_alerts(reg)
                # filed incidents: non-SLO page-worthy
                # states — a crash-looping replica held out of rotation
                payload["incidents"] = incidents(reg)
                self._send_json(200, payload)
            elif route == "/profile":
                # performance attribution plane (obs/profile.py):
                # phase table, walls, divergence table, top-k slowest
                # dispatches, notes.  Served from state cached on
                # the record side — a scrape never mutates the ledgers.
                self._send_json(200, profile_lib.profile_payload(reg))
            elif route == "/exemplars":
                self._send_json(200, exemplars(reg))
            elif route in ("/fleet/metrics", "/fleet/snapshot"):
                sources = getattr(reg, "fleet_sources", None)
                if sources is None:
                    self._send_json(404, {
                        "error": "no fleet behind this registry (the "
                                 "FleetRouter wires registry."
                                 "fleet_sources)"})
                elif route == "/fleet/metrics":
                    self._send(200,
                               render_fleet_text(sources()).encode("utf-8"),
                               content_type="text/plain; version=0.0.4")
                else:
                    self._send_json(200, merge_fleet_snapshot(sources()))
            else:
                self._send_json(404, {"error": f"no route {route!r}",
                                      "routes": ["/metrics", "/healthz",
                                                 "/snapshot", "/spans",
                                                 "/alerts", "/profile",
                                                 "/exemplars",
                                                 "/fleet/metrics",
                                                 "/fleet/snapshot"]})
        except Exception:  # tslint: disable=TS005 — exposition must never kill the scrape thread; failures are counted and answered with a 500
            reg.counter("obs/http_errors_total").inc()
            log.exception("obs-http handler failed for %s", self.path)
            try:
                self._send_json(500, {"error": "internal"})
            except Exception:  # tslint: disable=TS005 — socket already gone; the error counter above recorded the failure
                pass


class ObsHttpServer:
    """The exposition plane over one registry: localhost-only
    ThreadingHTTPServer on a daemon thread.

        srv = ObsHttpServer(registry, port=9464).start()
        ... GET http://127.0.0.1:{srv.port}/metrics ...
        srv.close()

    ``port=0`` binds an OS-assigned ephemeral port (tests); the bound
    port is always on ``.port``.
    """

    def __init__(self, registry: Registry, port: int = 0,
                 host: str = "127.0.0.1"):
        handler = type("_BoundHandler", (_Handler,), {"registry": registry})
        self._httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._registry = registry

    def start(self) -> "ObsHttpServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="obs-http")
            self._thread.start()
            log.info("obs exposition plane listening on http://%s:%d "
                     "(/metrics /healthz /snapshot /spans)",
                     self.host, self.port)
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "ObsHttpServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


_default_server: Optional[ObsHttpServer] = None
_default_server_lock = threading.Lock()


def resolve_http_port(hps: Any = None) -> int:
    """The exposition port for this job: ``HParams.obs_http_port`` when
    set (> 0), else ``TS_OBS_HTTP=<port>``, else 0 (off)."""
    if hps is not None and getattr(hps, "obs_http_port", 0):
        return int(hps.obs_http_port)
    raw = os.environ.get("TS_OBS_HTTP", "").strip()
    if not raw:
        return 0
    try:
        port = int(raw)
    except ValueError:
        port = -1
    if not 0 < port <= 65535:
        # the env contract is log-and-stay-off, NEVER crash the job: an
        # out-of-range port would raise OverflowError at bind, past
        # maybe_serve's OSError net, killing Trainer/ServingServer init
        log.warning("TS_OBS_HTTP=%r is not a valid port (1-65535); "
                    "exposition plane stays off", raw)
        return 0
    return port


def maybe_serve(registry: Registry, hps: Any = None,
                ) -> Optional[ObsHttpServer]:
    """Start the process-wide exposition plane when configured (one
    server per process — the first enabler wins; later calls return the
    running instance).  None when off (the default) or disabled."""
    global _default_server
    if not registry.enabled:
        return None
    port = resolve_http_port(hps)
    if port <= 0:
        return None
    with _default_server_lock:
        if _default_server is None:
            try:
                _default_server = ObsHttpServer(registry, port=port).start()
            except OSError as e:
                log.warning("obs exposition plane failed to bind port %d: "
                            "%s", port, e)
                return None
        return _default_server
