"""Performance attribution plane (OBSERVABILITY.md
"Performance attribution").

The JAX package's obs/profile.py, copied, in two ledgers behind one
per-registry ``Profiler`` (attached at ``registry.profile``,
first-install-wins like the SLO engine):

  * **phase ledger** — dispatch-boundary timers around the serve and
    train hot paths (prefill / pack / dispatch / harvest / evict in the
    continuous path, the per-tier micro-batch dispatch, the train loop's
    host-wait / step-dispatch / metrics-flush / checkpoint sub-phases,
    the decode batch and speculative cycle), aggregated into the labeled
    ``profile/phase_seconds`` histogram plus a phases-sum-to-wall
    accounting check (``profile/phase_coverage_ratio``).  The clock is
    injectable so a test drives it in virtual time.
  * **divergence sentinel** — per dispatch shape, an analytic cost
    (``obs/cost.py``: ``train_step_cost`` / ``decode_step_cost`` /
    ``prefill_cost``, the port's closed-form count of its own
    dispatches) is priced ONCE off the hot path on a daemon thread
    (``hps.profile_analytic`` gates it); each dispatch then publishes
    achieved bytes/s and FLOPs/s gauges and fires a ``perf_divergence``
    flight dump when throughput drops below the warm per-shape baseline
    by more than ``hps.profile_divergence_factor``.

Left out of the copy: the JAX compile ledger (``compiled_call`` diffs a
jitted callable's private ``_cache_size``; eager PyTorch has no jit
cache to diff, so there is no compile event to count).  The /profile
body's ``compile_ledger`` and the /alerts ``compile_storm`` keep the
JAX shape with nothing in it, so both packages' endpoints carry the
same keys.

Exposition: ``profile_payload(registry)`` backs the read-only
``/profile`` endpoint (phase table, walls, coverage, divergence table,
top-k slowest dispatches with trace exemplar ids, ledger notes);
``profile_alerts(registry)`` rides the /alerts scrape.  Both serve
state cached on the record side — a scrape never mutates or pays dump
I/O.

Null path: a dark registry (``hps.obs=False``) gets the shared
``NULL_PROFILER`` whose methods return constants — no per-dispatch
allocation.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs.registry import Registry

#: bounded ring of recent phase records — feeds the /profile top-k
#: slowest-dispatch table and the windowed coverage check in tests
RECENT_PHASES_CAP = 512
#: ledger notes (profiler captures) kept
NOTES_CAP = 64
#: dispatches that establish a shape's warm throughput baseline before
#: the divergence sentinel starts judging (the first dispatch carries
#: the kernel builds and allocator warm-up, so the baseline is the BEST
#: of the first N, not the first)
BASELINE_SAMPLES = 3
#: default measured-vs-baseline wall inflation that fires the
#: ``perf_divergence`` dump (overridden by hps.profile_divergence_factor)
DEFAULT_DIVERGENCE_FACTOR = 5.0


def _empty_compile_ledger() -> Dict[str, Any]:
    """The JAX compile ledger's /profile shape, empty (no jit cache
    here); a fresh dict per call, since a scrape hands it out."""
    return {"warm_set": 0, "sites": {}, "events": [], "storm": None}


class _NullProfiler:
    """Shared do-nothing profiler for dark registries: every method
    returns a preexisting constant, so the ``obs=False`` path adds no
    per-dispatch allocation (the null-object contract of
    NULL_COUNTER/NULL_GAUGE)."""

    __slots__ = ()

    def start(self) -> float:
        return 0.0

    def end(self, phase, t0, trace_id=None) -> float:
        return 0.0

    def end_wall(self, name, t0) -> float:
        return 0.0

    def register_cost(self, site, key, provider) -> None:
        pass

    def prime_cost(self, site, key, flops, bytes_) -> None:
        pass

    def observe_dispatch(self, site, key, wall_s, trace_id=None) -> None:
        pass

    def note(self, kind, **fields) -> None:
        pass

    def phase_stats(self) -> Dict[str, Tuple[int, float, float]]:
        return {}

    def coverage(self) -> float:
        return 0.0


NULL_PROFILER = _NullProfiler()


class Profiler:
    """Per-registry performance attribution state (phase ledger +
    divergence sentinel).  All record paths run on dispatch threads, so
    they take one short lock, touch no device values, and never raise
    past telemetry."""

    def __init__(self, registry: Registry,
                 clock: Callable[[], float] = time.perf_counter,
                 divergence_factor: float = DEFAULT_DIVERGENCE_FACTOR):
        self._reg = registry
        self._clock = clock
        self._div_factor = max(float(divergence_factor), 1.0)
        self._lock = threading.Lock()
        # phase ledger: name -> [count, total_s, max_s]; walls likewise
        self._phases: Dict[str, List[float]] = {}
        self._walls: Dict[str, List[float]] = {}
        self._recent: List[Tuple[int, str, float, Optional[str]]] = []
        # divergence sentinel: (site, key) -> cost/baseline state
        self._costs: Dict[Tuple[str, Any], Dict[str, float]] = {}
        self._pricing: set = set()
        self._div: Dict[Tuple[str, Any], Dict[str, float]] = {}
        self._notes: List[Dict[str, Any]] = []
        # metric families (literal names — the doc-drift gate reads the
        # source): children are created per label value at record time
        self._h_phase = registry.histogram("profile/phase_seconds")
        self._h_wall = registry.histogram("profile/wall_seconds")
        self._g_coverage = registry.gauge("profile/phase_coverage_ratio")
        self._g_bps = registry.gauge("profile/achieved_bytes_per_second")
        self._g_fps = registry.gauge("profile/achieved_flops_per_second")
        self._c_div = registry.counter("profile/divergence_dumps_total")

    # -- phase ledger ---------------------------------------------------
    def start(self) -> float:
        """A phase/wall start token (the injected clock's now)."""
        return self._clock()

    def end(self, phase: str, t0: float,
            trace_id: Optional[str] = None) -> float:
        """Close one phase opened by start(); returns its duration."""
        dt = self._clock() - t0
        ts_us = int(time.time() * 1e6)  # serialized epoch stamp only
        with self._lock:
            agg = self._phases.get(phase)
            if agg is None:
                agg = self._phases[phase] = [0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += dt
            if dt > agg[2]:
                agg[2] = dt
            self._recent.append((ts_us, phase, dt, trace_id))
            if len(self._recent) > RECENT_PHASES_CAP:
                del self._recent[:len(self._recent) - RECENT_PHASES_CAP]
        self._h_phase.labels(phase=phase).observe(dt, trace_id=trace_id)
        return dt

    def end_wall(self, name: str, t0: float) -> float:
        """Close one WALL unit (a serve tick, a train round) — the
        denominator of the phases-sum-to-wall accounting check."""
        dt = self._clock() - t0
        with self._lock:
            agg = self._walls.get(name)
            if agg is None:
                agg = self._walls[name] = [0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += dt
            if dt > agg[2]:
                agg[2] = dt
            cov = self._coverage_locked()
        self._h_wall.labels(wall=name).observe(dt)
        self._g_coverage.set(cov)
        return dt

    def _coverage_locked(self) -> float:
        wall = sum(w[1] for w in self._walls.values())
        if wall <= 0.0:
            return 0.0
        return sum(p[1] for p in self._phases.values()) / wall

    def coverage(self) -> float:
        """sum(phase time) / sum(wall time) — the accounting check."""
        with self._lock:
            return self._coverage_locked()

    def phase_stats(self) -> Dict[str, Tuple[int, float, float]]:
        """{phase: (count, total_s, max_s)} snapshot (bench evidence
        fields diff this across the timed window)."""
        with self._lock:
            return {k: (int(v[0]), v[1], v[2])
                    for k, v in self._phases.items()}

    def recent_phases(self) -> List[Tuple[int, str, float, Optional[str]]]:
        """Copy of the bounded (ts_us, phase, dur_s, trace_id) ring."""
        with self._lock:
            return list(self._recent)

    # -- divergence sentinel --------------------------------------------
    def prime_cost(self, site: str, key: Any, flops: float,
                   bytes_: float) -> None:
        """Install one shape's analytic cost synchronously (tests and
        callers that already hold the numbers)."""
        with self._lock:
            self._costs[(site, key)] = {"flops": float(flops),
                                        "bytes": float(bytes_)}

    def register_cost(self, site: str, key: Any,
                      provider: Callable[[], Dict[str, float]]) -> None:
        """Price one dispatch shape ONCE, off the hot path: `provider`
        (an ``obs/cost.py`` closure) runs on a daemon thread; until it
        lands the sentinel simply stays quiet for that shape.  A failing
        provider leaves the shape unpriced — pricing must never break
        serving or training."""
        with self._lock:
            ck = (site, key)
            if ck in self._costs or ck in self._pricing:
                return
            self._pricing.add(ck)

        def _price() -> None:
            try:
                cost = provider()
                flops = float(cost.get("flops", 0.0))
                bytes_ = float(cost.get("bytes", 0.0))
            except Exception:  # tslint: disable=TS005 — analytic pricing is best-effort telemetry; a failing provider must not surface
                flops = bytes_ = 0.0
            with self._lock:
                self._pricing.discard(ck)
                if flops > 0.0 or bytes_ > 0.0:
                    self._costs[ck] = {"flops": flops, "bytes": bytes_}

        threading.Thread(target=_price, daemon=True,
                         name=f"profile-pricer-{site}").start()

    def observe_dispatch(self, site: str, key: Any, wall_s: float,
                         trace_id: Optional[str] = None) -> None:
        """One measured dispatch of a priced shape: publish achieved
        throughput (analytic cost / measured wall) and fire the
        ``perf_divergence`` dump when it falls below the warm baseline
        by more than the committed factor."""
        if wall_s <= 0.0:
            return
        fire: Optional[Dict[str, Any]] = None
        with self._lock:
            cost = self._costs.get((site, key))
            if cost is None:
                return
            bps = cost["bytes"] / wall_s
            fps = cost["flops"] / wall_s
            st = self._div.get((site, key))
            if st is None:
                st = self._div[(site, key)] = {"samples": 0,
                                               "baseline_bps": 0.0,
                                               "drift": 1.0}
            st["samples"] += 1
            st["bps"] = bps
            st["fps"] = fps
            st["wall_s"] = wall_s
            if st["samples"] <= BASELINE_SAMPLES:
                # warmup window: the first dispatch carries the kernel
                # builds, so the baseline is the BEST throughput seen
                if bps > st["baseline_bps"]:
                    st["baseline_bps"] = bps
            elif bps * self._div_factor < st["baseline_bps"]:
                st["drift"] = st["baseline_bps"] / max(bps, 1e-12)
                fire = {"site": site, "key": str(key),
                        "wall_s": round(wall_s, 6),
                        "achieved_bytes_per_s": round(bps, 3),
                        "baseline_bytes_per_s": round(st["baseline_bps"], 3),
                        "drift": round(st["drift"], 3),
                        "trace_id": trace_id}
            else:
                st["drift"] = st["baseline_bps"] / max(bps, 1e-12)
        self._g_bps.labels(site=site).set(bps)
        self._g_fps.labels(site=site).set(fps)
        if fire is not None:
            # trigger OUTSIDE the lock: the dump walks the flight ring
            self._c_div.inc()
            flightrec.trigger(self._reg, "perf_divergence", **fire)

    # -- ledger notes ---------------------------------------------------
    def note(self, kind: str, **fields: Any) -> None:
        """A non-metric ledger event (e.g. a torch.profiler capture
        window), kept in a bounded ring for /profile."""
        rec = {"note": kind, "ts_us": int(time.time() * 1e6), **fields}
        with self._lock:
            self._notes.append(rec)
            if len(self._notes) > NOTES_CAP:
                del self._notes[:len(self._notes) - NOTES_CAP]
        # the frame kind is the ring's discriminator; the note's own
        # kind rides as the `note` field
        flightrec.record(self._reg, "profile_note", **rec)

    # -- exposition (read-only snapshots) -------------------------------
    def payload(self, top_k: int = 8) -> Dict[str, Any]:
        """The /profile body: phase table, wall/coverage accounting, the
        (empty) compile ledger, divergence table, top-k slowest
        dispatches (with trace exemplar ids), and ledger notes.  Pure
        read under one lock."""
        with self._lock:
            phases = [{"phase": k, "count": int(v[0]),
                       "total_s": round(v[1], 6), "max_s": round(v[2], 6),
                       "mean_ms": round(1e3 * v[1] / v[0], 3) if v[0]
                       else 0.0}
                      for k, v in sorted(self._phases.items())]
            walls = [{"wall": k, "count": int(v[0]),
                      "total_s": round(v[1], 6), "max_s": round(v[2], 6)}
                     for k, v in sorted(self._walls.items())]
            coverage = self._coverage_locked()
            divergence = [{"site": site, "key": str(key),
                           "flops": self._costs[(site, key)]["flops"],
                           "bytes": self._costs[(site, key)]["bytes"],
                           "samples": int(st.get("samples", 0)),
                           "achieved_bytes_per_s": round(
                               st.get("bps", 0.0), 3),
                           "achieved_flops_per_s": round(
                               st.get("fps", 0.0), 3),
                           "baseline_bytes_per_s": round(
                               st.get("baseline_bps", 0.0), 3),
                           "drift": round(st.get("drift", 1.0), 3)}
                          for (site, key), st in sorted(
                              self._div.items(), key=lambda kv: str(kv[0]))]
            slowest = sorted(self._recent, key=lambda r: -r[2])[:top_k]
            notes = list(self._notes)
        return {
            "phases": phases,
            "walls": walls,
            "coverage": round(coverage, 4),
            "compile_ledger": _empty_compile_ledger(),
            "divergence": divergence,
            "slowest": [{"phase": p, "dur_s": round(d, 6),
                         "trace_id": t, "ts_us": ts}
                        for ts, p, d, t in slowest],
            "notes": notes,
        }

    def alerts(self) -> Dict[str, Any]:
        """The /alerts contribution: cached divergence state (and the
        JAX key for a compile storm, always None here), served without
        touching the record path (read-only scrape)."""
        with self._lock:
            diverged = [{"site": site, "key": str(key),
                         "drift": round(st.get("drift", 1.0), 3)}
                        for (site, key), st in self._div.items()
                        if st.get("drift", 1.0) > self._div_factor]
        return {"installed": True, "compile_storm": None,
                "divergence": diverged}


_INSTALL_LOCK = threading.Lock()


def install_profiler(registry: Registry,
                     clock: Callable[[], float] = time.perf_counter,
                     divergence_factor: float = DEFAULT_DIVERGENCE_FACTOR,
                     ):
    """Attach a Profiler to `registry` (first install wins, like
    install_slo_engine); returns the installed profiler.  A disabled
    registry gets the shared NULL_PROFILER."""
    if registry is None or not registry.enabled:
        return NULL_PROFILER
    prof = getattr(registry, "profile", None)
    if prof is None:
        with _INSTALL_LOCK:
            prof = getattr(registry, "profile", None)
            if prof is None:
                prof = Profiler(registry, clock=clock,
                                divergence_factor=divergence_factor)
                registry.profile = prof
    return prof


def profiler_for(registry: Optional[Registry]):
    """The registry's profiler (installing one with the default clock
    on first use), or NULL_PROFILER for a dark/absent registry."""
    if registry is None or not registry.enabled:
        return NULL_PROFILER
    prof = getattr(registry, "profile", None)
    if prof is not None:
        return prof
    return install_profiler(registry)


def profile_payload(registry: Optional[Registry]) -> Dict[str, Any]:
    """The /profile endpoint body.  Quiet {installed: False} when no
    profiler has recorded on this registry."""
    prof = getattr(registry, "profile", None) if registry is not None \
        else None
    if prof is None or prof is NULL_PROFILER:
        return {"installed": False, "phases": [], "walls": [],
                "coverage": 0.0,
                "compile_ledger": _empty_compile_ledger(),
                "divergence": [], "slowest": [], "notes": []}
    return {"installed": True, **prof.payload()}


def profile_alerts(registry: Optional[Registry]) -> Dict[str, Any]:
    """The profiler's /alerts contribution (merged by obs/http.py under
    the "profile" key).  Read-only; quiet when not installed."""
    prof = getattr(registry, "profile", None) if registry is not None \
        else None
    if prof is None or prof is NULL_PROFILER:
        return {"installed": False, "compile_storm": None,
                "divergence": []}
    return prof.alerts()
