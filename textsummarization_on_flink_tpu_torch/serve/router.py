"""Replica handles + routing policy for the elastic serving fleet
(SERVING.md "Elastic fleet").

A copy of the JAX package's serve/router.py (the port imports nothing of
that package); it is host bookkeeping, the same in both packages.

The ``FleetRouter`` (serve/fleet.py) owns request lifecycles; this
module owns the PER-REPLICA view it routes over:

  * ``ReplicaHandle`` — one ServingServer replica plus its rotation
    state: a ``CircuitBreaker`` (``resilience/serve.replica.<id>/*``)
    that takes the replica OUT of rotation on a health failure or a
    typed submit failure and readmits it through the breaker's
    single-in-flight half-open probe (resilience/policy.py, whose
    probe semantics this leans on);
  * ``healthy()`` — the routing health predicate, read off the SAME
    facts /healthz serves — heartbeat staleness straight from the
    replica registry's HeartbeatBoard (the exact board and STALE_FACTOR
    rule obs/http.health renders; reading it directly skips health()'s
    full-registry breaker-gauge sweep, which at the router's tick rate
    would be N registry scans per 5 ms) — plus the replica's LIVE
    admission-breaker state (the scraped ``breaker_state`` gauge only
    refreshes on allow(), so an external router would read /healthz's
    ``breakers`` map; in-process we can re-evaluate and never act on a
    stale OPEN);
  * ``pick_replica`` — least-loaded selection over the in-rotation
    handles (load = queued + mid-dispatch + resident + prefilled, the
    ``ServingServer.load()`` surface whose inputs are the
    queue-depth/slots-free gauges /healthz exposes).

Health policy, in rotation terms:

  * STALE HEARTBEAT (the /healthz "degraded" signal) or OPEN admission
    breaker -> ``record_failure`` on the rotation breaker (threshold 1:
    one observed failure removes the replica — the fleet has spares;
    readmission is cheap);
  * a typed submit failure (``ServeOverloadError``/``ServeClosedError``)
    -> the same, from the routing path itself;
  * readmission: after ``reset_secs`` the rotation breaker goes
    HALF_OPEN and the router's next health refresh takes the ONE probe
    (``breaker.allow()``); a healthy scrape records success (back in
    rotation), an unhealthy one re-opens.  No user request is ever
    spent as the probe.

Import-light: no torch; everything here is host-side bookkeeping.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.resilience.policy import CircuitBreaker


class ReplicaHandle:
    """One fleet replica: the server, its id, and its rotation state."""

    def __init__(self, rid: str, server, registry: Optional[obs.Registry],
                 clock: Callable[[], float] = time.monotonic,
                 reset_secs: float = 1.0):
        self.rid = rid
        self.server = server
        #: permanently dead (killed mid-decode); never rejoins rotation
        self.killed = False
        #: rolling hot-swap drain: temporarily receives no NEW requests
        self.draining = False
        # the rotation breaker: OPEN = out of rotation; its half-open
        # probe (capped to ONE in flight) is the readmission gate.
        # threshold=1 — with spare replicas, eagerly shifting load off
        # a sick one beats giving it the benefit of the doubt
        self.breaker = CircuitBreaker(
            threshold=1, reset_secs=reset_secs,
            name=f"serve.replica.{rid}", clock=clock, registry=registry)

    def healthy(self) -> bool:
        """The routing health predicate: fresh heartbeats (the /healthz
        staleness rule, read off the same HeartbeatBoard) and an
        admission breaker that is not OPEN (live-read, see module
        docstring)."""
        board = self.server.registry.heartbeats
        if board is not None and any(
                not c["ok"] for c in board.status().values()):
            return False  # a stale component == /healthz "degraded"
        return self.server.stats()["admission"] != CircuitBreaker.OPEN

    def load(self) -> int:
        return self.server.load()

    def in_rotation(self) -> bool:
        """Routable RIGHT NOW: alive, not draining, rotation breaker
        closed.  (HALF_OPEN replicas are readmitted by the router's
        health probe, not by routing user requests at them.)"""
        return (not self.killed and not self.draining
                and self.breaker.state == CircuitBreaker.CLOSED)


def pick_replica(handles: Sequence[ReplicaHandle],
                 exclude: Sequence[str] = (),
                 ) -> Optional[ReplicaHandle]:
    """The least-loaded in-rotation replica (stable on ties: earliest
    handle wins, so a single-threaded driver is fully deterministic);
    None when the rotation is empty.  `exclude` names replica ids that
    must not be picked (a hedge needs a DIFFERENT replica; a requeue
    must avoid the corpse it came from)."""
    best: Optional[ReplicaHandle] = None
    best_load = -1
    for h in handles:
        if h.rid in exclude or not h.in_rotation():
            continue
        hl = h.load()
        if best is None or hl < best_load:
            best, best_load = h, hl
    return best


def fleet_fingerprint(handles: Sequence[ReplicaHandle],
                      ) -> Optional[str]:
    """The fleet's COMMON active-params fingerprint (the FleetRouter's
    summary-cache lookup key, SERVING.md "Front door"): the one
    fingerprint every live replica reports, or None while they
    disagree — mid-rolling-swap, which snapshot serves the next decode
    depends on routing, so a mixed fleet must not answer cache lookups
    (inserts still file under the decode-time fingerprint each result
    carries, so no entry is ever mis-keyed)."""
    fps = set()
    for h in handles:
        if h.killed:
            continue
        fps.add(getattr(h.server, "params_fingerprint", "") or "")
        if len(fps) > 1:
            return None
    return next(iter(fps)) if fps else ""


def refresh_rotation(handles: Sequence[ReplicaHandle],
                     ) -> List[Tuple[str, str]]:
    """One health sweep over the fleet (the router tick's rotation
    step); returns [(rid, transition)] for replicas that changed state
    ("removed" — now out of rotation; "readmitted" — probe succeeded).

    CLOSED + unhealthy -> record_failure (threshold 1 opens: removed).
    HALF_OPEN -> take the single probe (breaker.allow()); a healthy
    scrape re-closes (readmitted), an unhealthy one re-opens.  OPEN
    inside its reset window -> untouched (still cooling off)."""
    events: List[Tuple[str, str]] = []
    for h in handles:
        if h.killed:
            continue
        state = h.breaker.state
        if state == CircuitBreaker.CLOSED:
            if not h.healthy():
                h.breaker.record_failure()
                events.append((h.rid, "removed"))
        elif state == CircuitBreaker.HALF_OPEN and h.breaker.allow():
            # the ONE half-open probe: scrape health, report the verdict
            if h.healthy():
                h.breaker.record_success()
                events.append((h.rid, "readmitted"))
            else:
                h.breaker.record_failure()
    return events


__all__ = ["ReplicaHandle", "fleet_fingerprint", "pick_replica",
           "refresh_rotation"]
