"""Per-tenant / per-tier SLO burn-rate engine (piece 2).

The front door made the serving plane multi-tenant and the fleet made it
multi-replica, but "are we meeting our latency promise to tenant X"
still required a human staring at histograms.  This module commits the
promise: declarative OBJECTIVES (``SLO_POLICY.json`` at the repo root —
a latency threshold classifying each request good/bad, or an error-rate
signal, grouped per tenant or per tier), evaluated over FAST and SLOW
sliding windows on an injectable clock, in the multi-window burn-rate
shape the SRE workbook standardised:

    burn rate = (bad fraction over the window) / (1 - target)

A burn rate of 1.0 spends the error budget exactly at the rate the
target allows; the committed thresholds page long before the budget is
gone.  Alert state per series (``ok | warn | page``) takes the MIN of
the two windows' burn rates — the fast window makes paging prompt, the
slow window keeps a brief blip from paging, and recovery is symmetric
(the fast window going clean clears the page).  Transitions INTO
``page`` fire an ``slo_burn`` flight-recorder dump (obs/flightrec.py),
so the ring of serve ticks strictly preceding the breach survives for
the post-mortem, exactly like ``train_nan``.

Wiring: ``install_slo_engine(registry, clock=...)`` attaches one engine
per registry (first install wins, like the EventSink); the serving
layer feeds it from the request lifecycle — ``ServingServer.submit``
and ``FleetRouter.submit`` attach a done-callback recording (tenant,
tier, latency, error) on each future's exactly-once resolution — and
evaluates it once per dispatch round.  ``/alerts`` (obs/http.py) serves
``alerts_payload``.  Virtual time: clock injection means the committed
gate (tests/test_slo_burn.py) drives breach and recovery as exact
scheduling facts, no sleeps.

Telemetry (labeled children, OBSERVABILITY.md): ``slo/burn_rate_fast``
/ ``slo/burn_rate_slow`` / ``slo/alert_state`` gauges and
``slo/good_total`` / ``slo/bad_total`` counters per (objective, key);
series are LRU-bounded (``slo/series_evictions_total``) so hostile
tenant names cannot grow the engine.  Import-light: no jax/numpy.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs.registry import Registry

log = logging.getLogger(__name__)

#: alert states, in escalation order (the alert_state gauge's encoding)
STATES = ("ok", "warn", "page")
_STATE_CODE = {s: i for i, s in enumerate(STATES)}

#: bound on live (objective, key) series: past this, the
#: least-recently-updated series is dropped (counted in
#: slo/series_evictions_total) — same hostile-tenant-name posture as
#: the registry's label LRU
MAX_SLO_SERIES = 512

#: policy path resolution: env override, else the committed repo-root
#: file two levels above this package
ENV_POLICY = "TS_SLO_POLICY"
DEFAULT_POLICY_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "SLO_POLICY.json")


def resolve_policy_path() -> str:
    return os.environ.get(ENV_POLICY, "").strip() or DEFAULT_POLICY_PATH


def load_policy(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The parsed SLO policy, or None when the file is absent/invalid
    (an unreadable policy must never crash a serving job — it logs and
    the engine simply stays uninstalled)."""
    p = path or resolve_policy_path()
    try:
        with open(p, encoding="utf-8") as f:
            policy = json.load(f)
    except OSError:
        return None
    except ValueError:
        log.warning("SLO policy %s is not valid JSON; burn-rate engine "
                    "stays off", p)
        return None
    if not isinstance(policy, dict) or "objectives" not in policy:
        log.warning("SLO policy %s has no objectives; burn-rate engine "
                    "stays off", p)
        return None
    return policy


class Objective:
    """One declarative objective row of SLO_POLICY.json."""

    __slots__ = ("name", "signal", "by", "target", "latency_threshold_s")

    def __init__(self, spec: Dict[str, Any]):
        self.name = str(spec["name"])
        self.signal = str(spec.get("signal", "latency"))
        if self.signal not in ("latency", "error"):
            raise ValueError(
                f"objective {self.name!r}: signal must be latency|error, "
                f"got {self.signal!r}")
        self.by = str(spec.get("by", "tenant"))
        if self.by not in ("tenant", "tier"):
            raise ValueError(
                f"objective {self.name!r}: by must be tenant|tier, got "
                f"{self.by!r}")
        self.target = float(spec.get("target", 0.99))
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"objective {self.name!r}: target must be in (0, 1), got "
                f"{self.target}")
        self.latency_threshold_s = float(
            spec.get("latency_threshold_ms", 0.0)) / 1000.0
        if self.signal == "latency" and self.latency_threshold_s <= 0:
            raise ValueError(
                f"objective {self.name!r}: latency signal needs "
                f"latency_threshold_ms > 0")

    def classify(self, latency_s: float, error: bool) -> bool:
        """True when the request was GOOD under this objective."""
        if error:
            return False
        if self.signal == "latency":
            return latency_s <= self.latency_threshold_s
        return True


class _Series:
    """One (objective, key) sliding-window series: good/bad counts in
    fixed-width time buckets keyed ``int(t / bucket_secs)``, pruned past
    the slow window.  Mutated only under the engine lock."""

    __slots__ = ("buckets", "state", "last_t")

    def __init__(self) -> None:
        self.buckets: Dict[int, List[int]] = {}
        self.state = "ok"
        self.last_t = 0.0

    def push(self, idx: int, good: bool, keep_from: int) -> None:
        cell = self.buckets.get(idx)
        if cell is None:
            cell = self.buckets[idx] = [0, 0]
            # prune opportunistically on the same write path: the
            # per-series map stays O(slow window / bucket_secs)
            for old in [i for i in self.buckets if i < keep_from]:
                del self.buckets[old]
        cell[0 if good else 1] += 1

    def frac_bad(self, from_idx: int) -> Tuple[float, int]:
        """(bad fraction, event count) over buckets >= from_idx."""
        good = bad = 0
        for idx, (g, b) in self.buckets.items():
            if idx >= from_idx:
                good += g
                bad += b
        total = good + bad
        return (bad / total if total else 0.0), total


class SloEngine:
    """The per-registry burn-rate evaluator.

    ``record`` is the hot-path side (one dict update per request
    resolution, under one lock — declared a TS002 hot function: it runs
    inside every future's resolve fan-out); ``evaluate`` is the scrape/
    tick side (burn gauges + alert transitions + the slo_burn trigger).
    """

    def __init__(self, policy: Dict[str, Any], registry: Registry,
                 clock: Callable[[], float] = time.monotonic):
        self._reg = registry
        self._clock = clock
        self.objectives = [Objective(o) for o in policy["objectives"]]
        windows = policy.get("windows", {})
        self.fast_secs = float(windows.get("fast_secs", 300.0))
        self.slow_secs = float(windows.get("slow_secs", 3600.0))
        if not 0 < self.fast_secs <= self.slow_secs:
            raise ValueError("need 0 < fast_secs <= slow_secs")
        self.bucket_secs = float(
            windows.get("bucket_secs", max(self.fast_secs / 12.0, 1e-9)))
        thresholds = policy.get("thresholds", {})
        self.warn = float(thresholds.get("warn", 2.0))
        self.page = float(thresholds.get("page", 10.0))
        self._lock = threading.Lock()
        self._series: "OrderedDict[Tuple[str, str], _Series]" = OrderedDict()
        self._last_rows: List[Dict[str, Any]] = []
        self._by_obj = {o.name: o for o in self.objectives}
        self._g_fast = registry.gauge("slo/burn_rate_fast")
        self._g_slow = registry.gauge("slo/burn_rate_slow")
        self._g_state = registry.gauge("slo/alert_state")
        self._c_good = registry.counter("slo/good_total")
        self._c_bad = registry.counter("slo/bad_total")
        self._c_evicted = registry.counter("slo/series_evictions_total")
        # the slo/* metrics' label surface must hold one child per live
        # engine series, or every evaluate() tick would LRU-thrash the
        # gauge children past the registry's default 128 cap and an
        # engine-side paging series could be absent from the scraped
        # exposition — widen these (and only these) to the engine bound
        for m in (self._g_fast, self._g_slow, self._g_state,
                  self._c_good, self._c_bad):
            if hasattr(m, "_max_label_sets"):  # null metrics have none
                m._max_label_sets = max(m._max_label_sets,
                                        MAX_SLO_SERIES)

    # -- hot path --
    def record(self, tenant: str, tier: str, latency_s: float,
               error: bool = False) -> None:
        """Classify one finished request under every objective and land
        it in the matching series' current window bucket."""
        now = self._clock()
        idx = int(now / self.bucket_secs)
        keep_from = idx - int(math.ceil(self.slow_secs / self.bucket_secs))
        evicted = 0
        with self._lock:
            for obj in self.objectives:
                key = (tenant or "default") if obj.by == "tenant" \
                    else (tier or "default")
                skey = (obj.name, key)
                series = self._series.get(skey)
                if series is None:
                    series = self._series[skey] = _Series()
                    while len(self._series) > MAX_SLO_SERIES:
                        (ev_obj, ev_key), _ = self._series.popitem(
                            last=False)
                        # retire the evicted series' GAUGE children with
                        # it: a frozen slo/alert_state stuck at `page`
                        # would render on every scrape forever with no
                        # engine row left to ever update it (the
                        # good/bad COUNTERS stay — a stale monotonic
                        # total is honest, a stale gauge lies)
                        for m in (self._g_fast, self._g_slow,
                                  self._g_state):
                            m.remove_labels(objective=ev_obj, key=ev_key)
                        evicted += 1
                else:
                    self._series.move_to_end(skey)
                good = obj.classify(latency_s, error)
                series.push(idx, good, keep_from)
                series.last_t = now
                (self._c_good if good else self._c_bad).labels(
                    objective=obj.name, key=key).inc()
        if evicted:
            self._c_evicted.inc(evicted)

    # -- scrape/tick side --
    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Recompute every series' burn rates and alert state; returns
        the /alerts objective rows.  A transition INTO page dumps the
        flight-recorder ring (reason ``slo_burn``) — the frames strictly
        preceding the breach."""
        t = self._clock() if now is None else now
        idx = int(t / self.bucket_secs)
        fast_from = idx - int(math.ceil(self.fast_secs / self.bucket_secs)) + 1
        slow_from = idx - int(math.ceil(self.slow_secs / self.bucket_secs)) + 1
        rows: List[Dict[str, Any]] = []
        paged: List[Tuple[str, str, float]] = []
        with self._lock:
            for (oname, key), series in self._series.items():
                obj = self._by_obj.get(oname)
                if obj is None:  # objective removed by a policy reload
                    continue
                budget = max(1.0 - obj.target, 1e-9)
                frac_fast, n_fast = series.frac_bad(fast_from)
                frac_slow, n_slow = series.frac_bad(slow_from)
                burn_fast = frac_fast / budget
                burn_slow = frac_slow / budget
                # multi-window rule: both windows must burn for an
                # alert (fast alone = a blip; slow alone = an old
                # breach the fast window already proved is over)
                effective = min(burn_fast, burn_slow)
                state = ("page" if effective >= self.page
                         else "warn" if effective >= self.warn else "ok")
                if state == "page" and series.state != "page":
                    paged.append((oname, key, burn_fast))
                series.state = state
                rows.append({
                    "objective": oname, "by": obj.by, "key": key,
                    "signal": obj.signal, "target": obj.target,
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "events_fast": n_fast, "events_slow": n_slow,
                    "state": state,
                })
            self._last_rows = rows
            # gauge writes stay UNDER the engine lock: a concurrent
            # record() evicting a series also removes its gauge
            # children, and an unlocked write here could resurrect one
            # AFTER that removal — a frozen slo/alert_state child no
            # engine row would ever update again (metric locks never
            # take the engine lock, so the nesting is deadlock-free and
            # is already record()'s own pattern)
            for row in rows:
                labels = {"objective": row["objective"], "key": row["key"]}
                self._g_fast.labels(**labels).set(row["burn_fast"])
                self._g_slow.labels(**labels).set(row["burn_slow"])
                self._g_state.labels(**labels).set(
                    _STATE_CODE[row["state"]])
        for oname, key, burn in paged:
            # the dump lands BEFORE anything else reacts: the ring holds
            # exactly the frames recorded up to the breach evaluation
            flightrec.trigger(self._reg, "slo_burn", objective=oname,
                              key=key, burn_fast=round(burn, 4))
            log.warning("SLO burn PAGE: objective %s key %s fast-window "
                        "burn %.2f", oname, key, burn)
        return rows

    def states(self) -> Dict[Tuple[str, str], str]:
        """{(objective, key): alert state} as of the last evaluate."""
        with self._lock:
            return {k: s.state for k, s in self._series.items()}

    def last_rows(self) -> List[Dict[str, Any]]:
        """The /alerts objective rows computed by the LAST ``evaluate``
        tick (empty before the first).  Read-only: scraping /alerts
        must never consume an alert transition or pay the slo_burn
        flight-dump I/O on the HTTP handler thread — transitions belong
        to the dispatch/router tick that evaluates once per round."""
        return self._last_rows


_install_lock = threading.Lock()


def install_slo_engine(registry: Registry,
                       clock: Callable[[], float] = time.monotonic,
                       policy: Optional[Dict[str, Any]] = None,
                       ) -> Optional[SloEngine]:
    """Attach an SloEngine to `registry` (first install wins, like the
    EventSink/flight recorder).  `policy` defaults to the committed
    SLO_POLICY.json (TS_SLO_POLICY overrides the path); returns None —
    and installs nothing — on a disabled registry or a missing policy.
    """
    if not registry.enabled:
        return None
    if registry.slo is None:
        pol = policy if policy is not None else load_policy()
        if pol is None:
            return None
        with _install_lock:
            if registry.slo is None:
                try:
                    registry.slo = SloEngine(pol, registry, clock=clock)
                except (KeyError, TypeError, ValueError):
                    log.exception("invalid SLO policy; burn-rate engine "
                                  "stays off")
                    return None
    return registry.slo


def record_request(registry: Registry, tenant: str, tier: str,
                   latency_s: float, error: bool = False) -> None:
    """Feed one finished request into `registry`'s engine; no-op when
    none is installed (the unarmed fast path is one attribute test)."""
    eng = registry.slo
    if eng is not None:
        eng.record(tenant, tier, latency_s, error=error)


def evaluate(registry: Registry) -> None:
    """Tick-side refresh of `registry`'s burn gauges/alert states;
    no-op when no engine is installed."""
    eng = registry.slo
    if eng is not None:
        eng.evaluate()


def alerts_payload(registry: Registry) -> Dict[str, Any]:
    """The /alerts JSON body: overall status (the worst series state)
    plus per-series rows; an engineless registry reports a quiet ok.
    READ-ONLY (the module's all-GET contract): serves the rows cached
    by the last tick-side ``evaluate`` — a scrape never mutates alert
    state or fires the slo_burn dump from the HTTP handler thread."""
    eng = registry.slo
    if eng is None:
        return {"status": "ok", "installed": False, "objectives": []}
    rows = eng.last_rows()
    worst = max((r["state"] for r in rows), key=lambda s: _STATE_CODE[s],
                default="ok")
    return {
        "status": worst,
        "installed": True,
        "windows": {"fast_secs": eng.fast_secs, "slow_secs": eng.slow_secs},
        "thresholds": {"warn": eng.warn, "page": eng.page},
        "objectives": rows,
    }


__all__ = ["SloEngine", "Objective", "install_slo_engine",
           "record_request", "evaluate", "alerts_payload", "load_policy",
           "resolve_policy_path"]
