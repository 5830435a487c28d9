"""Deterministic, seeded fault injection.

A copy of the JAX package's resilience/faultinject.py (the port imports
nothing of that package): the same spec syntax, the same known points
and a seeded ``random.Random`` per point, so one spec fires on the same
call indices in both packages.  The port wires ``train.step_nan``
(train/trainer.py), ``ckpt.load`` (checkpoint/checkpointer.py),
``etl.worker`` (data/batcher.py), ``io.connect`` / ``io.read`` /
``io.write`` (pipeline/io.py) and ``serve.dispatch``,
``serve.cache_fault`` and ``serve.arena_full`` (serve/); the other points
get their call sites with the modules that hold them.

Chaos tests (and staging soaks) drive the recovery paths through *named
injection points* compiled into the production code:

  ==================  =====================================================
  point               where it fires
  ==================  =====================================================
  ``io.connect``      pipeline/io.py — source/sink socket connect
  ``io.read``         pipeline/io.py — per-record stream read
  ``io.write``        pipeline/io.py — per-record sink write
  ``ckpt.load``       checkpoint/checkpointer.py — checksum-verified load
  ``train.step_nan``  train/trainer.py — per-dispatch divergence watchdog
  ``etl.worker``      data/batcher.py — example-producer worker loop
  ``serve.dispatch``  serve/server.py — per-(sub-)batch / per-tick dispatch
  ``serve.replica_kill``  serve/fleet.py — kills one fleet replica
                      mid-decode (residents/queued requeue on survivors)
  ``serve.cache_fault``  serve/frontdoor.py — summary-cache layer
                      failure (lookups degrade to miss-and-decode,
                      inserts drop; never a wrong summary or a hang)
  ``serve.proc_kill``  serve/procfleet.py — SIGKILLs one live replica
                      CHILD PROCESS mid-decode (the supervisor detects
                      the death, orphans requeue on survivors, the
                      child restarts under backoff)
  ``serve.arena_full``  serve/batcher.py — page-arena allocation failure
                      at slot refill (the admission REQUEUES under typed
                      ArenaExhaustedError backpressure until a harvest
                      frees pages; never a wrong decode, never a drop)
  ==================  =====================================================

Arming — either source, same ``point:prob:seed[:max]`` syntax, comma-
separated::

    TS_FAULTS="io.read:0.2:42,train.step_nan:1.0:7:3"   # environment
    HParams(faults="ckpt.load:1.0:0:1")                 # per-job

``prob`` is the per-call fire probability, ``seed`` pins the point's own
``random.Random`` stream (every run fires on the same call indices — the
chaos suite asserts exact recovery sequences), and the optional ``max``
caps total fires (so ``prob=1.0`` can model "this dependency fails
exactly N times then heals").

Call sites do ``plan.fire("io.read")`` and raise their own natural error
type when it returns True — the registry never fabricates exceptions, so
an injected fault exercises the SAME except-clauses a real one would.

Disabled mode: with nothing armed, call sites hold the shared
``NULL_PLAN`` whose ``fire()`` is a constant ``return False`` — one
attribute call on the hot path.  Import-light: no torch, no numpy.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import Any, Dict, List, NamedTuple, Optional

from textsummarization_on_flink_tpu_torch import obs

log = logging.getLogger(__name__)

ENV_VAR = "TS_FAULTS"

# the compiled-in injection points; parse rejects unknown names so a
# typo'd TS_FAULTS fails loudly instead of silently injecting nothing
KNOWN_POINTS = (
    "io.connect", "io.read", "io.write",
    "ckpt.load", "train.step_nan", "etl.worker",
    "serve.dispatch", "serve.replica_kill", "serve.cache_fault",
    "serve.proc_kill", "serve.arena_full",
)


class FaultSpec(NamedTuple):
    point: str
    prob: float
    seed: int
    max_fires: int  # 0 = unbounded


def parse_spec(token: str) -> FaultSpec:
    """One ``point:prob:seed[:max]`` token -> FaultSpec (validated)."""
    parts = token.strip().split(":")
    if len(parts) not in (3, 4):
        raise ValueError(
            f"bad fault spec {token!r}: want point:prob:seed[:max]")
    point = parts[0].strip()
    if point not in KNOWN_POINTS:
        raise ValueError(f"unknown fault point {point!r}; known: "
                         f"{', '.join(KNOWN_POINTS)}")
    prob = float(parts[1])
    if not 0.0 <= prob <= 1.0:
        raise ValueError(f"fault prob must be in [0, 1], got {prob}")
    seed = int(parts[2])
    max_fires = int(parts[3]) if len(parts) == 4 else 0
    if max_fires < 0:
        raise ValueError(f"fault max_fires must be >= 0, got {max_fires}")
    return FaultSpec(point, prob, seed, max_fires)


def parse(spec: str) -> List[FaultSpec]:
    """A full ``TS_FAULTS`` string -> list of FaultSpecs ('' -> [])."""
    spec = (spec or "").strip()
    if not spec:
        return []
    return [parse_spec(tok) for tok in spec.split(",") if tok.strip()]


class _Point:
    """One armed injection point: its own seeded RNG + fire budget."""

    __slots__ = ("spec", "rng", "calls", "fires", "lock", "counter")

    def __init__(self, spec: FaultSpec, registry: obs.Registry):
        self.spec = spec
        self.rng = random.Random(spec.seed)
        self.calls = 0
        self.fires = 0
        self.lock = threading.Lock()
        self.counter = registry.counter(f"resilience/fault/{spec.point}")


class FaultPlan:
    """The armed set of injection points.

    ``fire(point)`` returns True when the point's seeded RNG decides this
    call fails (and the fire budget allows).  Unarmed points return False
    at the cost of one dict miss.  Thread-safe per point (batcher worker
    threads share a plan).
    """

    enabled = True

    def __init__(self, specs: List[FaultSpec],
                 registry: Optional[obs.Registry] = None):
        reg = registry if registry is not None else obs.registry()
        self._points: Dict[str, _Point] = {
            s.point: _Point(s, reg) for s in specs}
        self._c_total = reg.counter("resilience/faults_fired_total")
        if self._points:
            log.info("fault injection armed: %s",
                     ", ".join(f"{s.point}(p={s.prob},seed={s.seed}"
                               + (f",max={s.max_fires}" if s.max_fires else "")
                               + ")"
                               for s in (p.spec for p in
                                         self._points.values())))

    def fire(self, point: str) -> bool:
        p = self._points.get(point)
        if p is None:
            return False
        with p.lock:
            p.calls += 1
            if p.spec.max_fires and p.fires >= p.spec.max_fires:
                return False
            if p.rng.random() >= p.spec.prob:
                return False
            p.fires += 1
        p.counter.inc()
        self._c_total.inc()
        log.warning("fault injected at %s (fire %d, call %d)",
                    point, p.fires, p.calls)
        return True

    def armed(self, point: str) -> bool:
        return point in self._points

    def stats(self) -> Dict[str, Dict[str, int]]:
        """{point: {calls, fires}} — chaos-test introspection."""
        return {name: {"calls": p.calls, "fires": p.fires}
                for name, p in self._points.items()}


class _NullPlan:
    """Disabled-mode singleton: fire() is a constant False."""

    enabled = False

    def fire(self, point: str) -> bool:
        return False

    def armed(self, point: str) -> bool:
        return False

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {}


NULL_PLAN = _NullPlan()

_default: Optional[Any] = None
_default_lock = threading.Lock()


def plan() -> Any:
    """The process-wide plan, resolved from TS_FAULTS on first use
    (NULL_PLAN when unset/empty — the fast path)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                specs = parse(os.environ.get(ENV_VAR, ""))
                _default = FaultPlan(specs) if specs else NULL_PLAN
    return _default


def set_default_plan(p: Optional[Any]) -> None:
    """Swap the process default (None re-resolves TS_FAULTS on next use)."""
    global _default
    with _default_lock:
        _default = p


class use_plan:
    """Context manager: route ``plan()`` through `p` (chaos tests)."""

    def __init__(self, p: Any):
        self._p = p
        self._prev: Optional[Any] = None

    def __enter__(self) -> Any:
        global _default
        with _default_lock:
            self._prev = _default
            _default = self._p
        return self._p

    def __exit__(self, exc_type, exc, tb) -> None:
        global _default
        with _default_lock:
            _default = self._prev


def plan_for(hps: Any) -> Any:
    """The plan a component should consult: a per-job plan when the
    HParams carry a non-empty ``faults`` spec, else the process default
    (TS_FAULTS).  Mirrors obs.registry_for gating."""
    spec = getattr(hps, "faults", "") if hps is not None else ""
    if spec:
        return FaultPlan(parse(spec), registry=obs.registry_for(hps))
    return plan()
