"""Performance attribution plane (OBSERVABILITY.md
"Performance attribution").

The phase ledger of the JAX package's obs/profile.py, copied: one
per-registry ``Profiler`` (attached at ``registry.profile``,
first-install-wins like the SLO engine) times dispatch-boundary phases
around the serve hot paths (prefill / pack / dispatch / harvest / evict
in the continuous path, the per-tier micro-batch dispatch), aggregated
into the labeled ``profile/phase_seconds`` histogram plus a
phases-sum-to-wall accounting check (``profile/phase_coverage_ratio``).
The clock is injectable so a test drives it in virtual time.

Left out of the copy, with nothing in the port to feed them: the
compile ledger (``compiled_call`` diffs a jitted callable's private
``_cache_size``; eager PyTorch has no jit cache) and the divergence
sentinel (it prices each dispatch shape with the JAX package's
analytic cost model, which the port does not have), and with them
the ledger notes of ``jax.profiler`` captures.  The fields that
steer them, ``profile_analytic`` and ``profile_divergence_factor``,
stay in ``config.JAX_ONLY_FIELDS`` (ROADMAP.md queue 1, item 2h).

Exposition: ``profile_payload(registry)`` backs the read-only
``/profile`` endpoint (phase table, walls, coverage, top-k slowest
dispatches with trace exemplar ids), served from state cached on the
record side.

Null path: a dark registry (``hps.obs=False``) gets the shared
``NULL_PROFILER`` whose methods return constants — no per-dispatch
allocation.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch.obs.registry import Registry

#: bounded ring of recent phase records — feeds the /profile top-k
#: slowest-dispatch table and the windowed coverage check in tests
RECENT_PHASES_CAP = 512


class _NullProfiler:
    """Shared do-nothing profiler for dark registries: every method
    returns a preexisting constant, so the ``obs=False`` path adds no
    per-dispatch allocation (the null-object contract of
    NULL_COUNTER/NULL_GAUGE — pinned by test_profile)."""

    __slots__ = ()

    def start(self) -> float:
        return 0.0

    def end(self, phase, t0, trace_id=None) -> float:
        return 0.0

    def end_wall(self, name, t0) -> float:
        return 0.0

    def phase_stats(self) -> Dict[str, Tuple[int, float, float]]:
        return {}

    def coverage(self) -> float:
        return 0.0


NULL_PROFILER = _NullProfiler()


class Profiler:
    """Per-registry phase ledger.  All record paths run on dispatch
    threads, so they take one short lock, touch no device values, and
    never raise past telemetry."""

    def __init__(self, registry: Registry,
                 clock: Callable[[], float] = time.perf_counter):
        self._reg = registry
        self._clock = clock
        self._lock = threading.Lock()
        # phase ledger: name -> [count, total_s, max_s]; walls likewise
        self._phases: Dict[str, List[float]] = {}
        self._walls: Dict[str, List[float]] = {}
        self._recent: List[Tuple[int, str, float, Optional[str]]] = []
        # metric families (literal names — the doc-drift gate reads the
        # source): children are created per label value at record time
        self._h_phase = registry.histogram("profile/phase_seconds")
        self._h_wall = registry.histogram("profile/wall_seconds")
        self._g_coverage = registry.gauge("profile/phase_coverage_ratio")

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

    # -- exposition (read-only snapshots) -------------------------------
    def payload(self, top_k: int = 8) -> Dict[str, Any]:
        """The /profile body: phase table, wall/coverage accounting,
        top-k slowest dispatches (with trace exemplar ids that paste
        into scripts/trace_summary.py --request).  Pure read under one
        lock."""
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
            slowest = sorted(self._recent, key=lambda r: -r[2])[:top_k]
        return {
            "phases": phases,
            "walls": walls,
            "coverage": round(coverage, 4),
            "slowest": [{"phase": p, "dur_s": round(d, 6),
                         "trace_id": t, "ts_us": ts}
                        for ts, p, d, t in slowest],
        }


_INSTALL_LOCK = threading.Lock()


def install_profiler(registry: Registry,
                     clock: Callable[[], float] = time.perf_counter):
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
                prof = Profiler(registry, clock=clock)
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
                "coverage": 0.0, "slowest": []}
    return {"installed": True, **prof.payload()}
