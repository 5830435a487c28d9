"""Process-wide metrics registry: counters, gauges, histograms.

The reference system had no runtime telemetry beyond per-step loss
prints (run_summarization.py:223-226); this registry is the substrate
every layer of the rebuild reports through (OBSERVABILITY.md).

Design constraints:
  * thread-safe — producer threads (batcher, prefetcher, bridge feeders)
    and the train loop all hit the same metrics;
  * near-zero-cost when disabled — a disabled registry hands out shared
    null singletons whose mutators are empty methods, so instrumented
    hot paths pay one attribute call and nothing else;
  * histograms are fixed-bucket and percentile-queryable (numpy-checked
    in tests/test_obs.py) — no unbounded sample retention;
  * text exposition (`render_text`) is Prometheus-style so a scrape
    endpoint can be bolted on without touching call sites.

Labeled metrics: every metric can hand out labeled
CHILD series via ``metric.labels(tenant=..., tier=...)`` — same class,
same API, rendered ``name{tenant="...",tier="..."}`` by
``render_text``.  The label surface is BOUNDED: each parent keeps at
most ``max_label_sets`` children in an LRU (a hostile tenant name
cannot grow the registry without end); evictions are counted in
``obs/label_evictions_total``.  Counter and histogram children ROLL UP
into their parent (the unlabeled series stays the total, so an evicted
child loses only its per-label split, never aggregate truth); gauges
are last-write-wins per series and do not roll up.

Trace exemplars: ``Histogram.observe(v, trace_id=...)``
stamps the landing bucket's last-seen trace id, so a fat p99 bucket
carries a concrete request to chase — ``scripts/trace_summary.py
--request <trace_id>`` reconstructs its full timeline.  Exemplars ride
``render_text`` in OpenMetrics ``# {trace_id="..."} v`` syntax and the
``/exemplars`` JSON endpoint (obs/http.py).

Fleet aggregation: ``Registry.series()`` flattens a registry
into (name, labels, kind, payload) rows, and ``merge_fleet_series`` /
``render_fleet_text`` / ``merge_fleet_snapshot`` combine N replica
registries into one view — counters summed, gauges labeled
``{replica="..."}``, histograms bucket-merged (a bucket-layout mismatch
falls back to per-replica labeled series rather than a wrong sum).

Metric names follow ``<layer>/<name>`` (train/step_time_seconds,
decode/request_latency_seconds, ...); rendering flattens ``/`` and
``-`` to ``_`` for exposition compatibility.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple


def exponential_buckets(start: float, factor: float, count: int,
                        ) -> Tuple[float, ...]:
    """`count` ascending bucket upper bounds: start * factor**i."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# 1e-5 s .. ~168 s in x2 steps — covers a microsecond span probe through
# a multi-minute checkpoint save with <=2x relative bucket error
DEFAULT_TIME_BUCKETS = exponential_buckets(1e-5, 2.0, 24)

#: per-parent bound on labeled child series (LRU-evicted past this;
#: evictions counted in obs/label_evictions_total).  128 covers every
#: sane tenant/tier population while keeping a hostile tenant-name
#: stream from growing the registry — and render_text — without bound.
DEFAULT_MAX_LABEL_SETS = 128

#: labels-dict type: tuple of sorted (key, value) string pairs — the
#: canonical child identity (dict-order-insensitive, hashable)
LabelsKV = Tuple[Tuple[str, str], ...]


def _label_key(kv: Dict[str, Any]) -> LabelsKV:
    return tuple(sorted((str(k), str(v)) for k, v in kv.items()))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_suffix(kv: LabelsKV, extra: str = "") -> str:
    """``{k="v",...}`` exposition suffix ("" for the unlabeled series
    unless `extra` — e.g. a histogram's ``le="..."`` — needs braces)."""
    parts = [f'{k}="{_escape_label(v)}"' for k, v in kv]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _get_label_child(parent, make, kv: Dict[str, Any]):
    """Get-or-create `parent`'s labeled child for `kv` (LRU-bounded;
    evictions fire the parent's eviction callback).  Shared by all three
    metric classes."""
    if not kv:
        return parent
    if parent._parent is not None:
        raise ValueError(
            f"labels() on the already-labeled series {parent.name!r}"
            f"{_label_suffix(parent.labels_kv)}")
    key = _label_key(kv)
    evicted = 0
    with parent._lock:
        children = parent._children
        if children is None:
            children = parent._children = OrderedDict()
        child = children.get(key)
        if child is None:
            child = make()
            child._parent = parent
            child.labels_kv = key
            children[key] = child
            while len(children) > parent._max_label_sets:
                children.popitem(last=False)
                evicted += 1
        else:
            children.move_to_end(key)
    if evicted and parent._evict_cb is not None:
        parent._evict_cb(evicted)
    return child


class _LabeledMixin:
    """The label-family surface every metric class shares (children map,
    bound, eviction callback).  Slots live on the concrete classes —
    the empty declaration here keeps the mixin from silently handing
    every metric (and every LRU-bounded labeled child) a __dict__."""

    __slots__ = ()

    def _init_labels(self) -> None:
        self.labels_kv: LabelsKV = ()
        self._parent = None
        self._children: Optional["OrderedDict"] = None
        self._max_label_sets = DEFAULT_MAX_LABEL_SETS
        self._evict_cb: Optional[Callable[[int], None]] = None

    def label_children(self) -> Tuple:
        """The live labeled children (snapshot; LRU order)."""
        if self._children is None:
            return ()
        with self._lock:
            return tuple(self._children.values())

    def remove_labels(self, **kv: Any) -> bool:
        """Drop the labeled child for `kv` from the family (True when
        one existed).  For series whose OWNER retires them — e.g. the
        SLO engine evicting a (objective, key) series must also retire
        its alert-state gauge child, or a stale ``page`` would render
        on every scrape forever.  Counter children are normally left in
        place instead (a stale monotonic total is honest; a stale gauge
        lies)."""
        if self._children is None:
            return False
        with self._lock:
            return self._children.pop(_label_key(kv), None) is not None


class Counter(_LabeledMixin):
    """Monotonic float counter.  Labeled children (``labels(...)``)
    ROLL UP: a child inc also incs the parent, so the unlabeled series
    is always the total across labels (eviction-proof aggregate)."""

    __slots__ = ("name", "_value", "_lock", "labels_kv", "_parent",
                 "_children", "_max_label_sets", "_evict_cb")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()
        self._init_labels()

    def labels(self, **kv: Any) -> "Counter":
        return _get_label_child(self, lambda: Counter(self.name), kv)

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += n
        p = self._parent
        if p is not None:
            with p._lock:
                p._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict:
        return {"type": "counter", "value": self._value}


class Gauge(_LabeledMixin):
    """Last-write-wins instantaneous value.

    Tracks whether it was ever written: a sampled gauge sitting at 0.0
    (e.g. a starved queue-depth) is a real observation and must survive
    a compact snapshot, unlike a gauge nothing ever touched.  Labeled
    children are independent series (no roll-up: summing last-write
    gauges would be meaningless)."""

    __slots__ = ("name", "_value", "_lock", "touched", "labels_kv",
                 "_parent", "_children", "_max_label_sets", "_evict_cb")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()
        self.touched = False
        self._init_labels()

    def labels(self, **kv: Any) -> "Gauge":
        return _get_label_child(self, lambda: Gauge(self.name), kv)

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self.touched = True

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n
            self.touched = True

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n
            self.touched = True

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict:
        return {"type": "gauge", "value": self._value}


class Histogram(_LabeledMixin):
    """Fixed-bucket histogram with percentile queries.

    `buckets` are ascending upper bounds; an implicit +inf bucket
    catches the overflow.  `percentile(q)` linearly interpolates within
    the winning bucket (the overflow bucket reports the observed max),
    which tests pin against numpy within bucket resolution.

    Trace exemplars: ``observe(v, trace_id=...)`` stamps the
    landing bucket's last exemplar — (trace_id, value) — so a scrape of
    a fat latency bucket names a concrete request to chase.  Labeled
    children share the parent's bucket layout and ROLL UP observations
    (value and exemplar) into it."""

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count",
                 "_min", "_max", "_lock", "_exemplars", "labels_kv",
                 "_parent", "_children", "_max_label_sets", "_evict_cb")

    def __init__(self, name: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        bs = tuple(buckets if buckets is not None else DEFAULT_TIME_BUCKETS)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(
                f"histogram {name} needs ascending non-empty buckets")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # +1 overflow
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()
        #: per-bucket last exemplar: (trace_id, value) or None
        self._exemplars: List[Optional[Tuple[str, float]]] = \
            [None] * (len(bs) + 1)
        self._init_labels()

    def labels(self, **kv: Any) -> "Histogram":
        return _get_label_child(
            self, lambda: Histogram(self.name, self.buckets), kv)

    def _bucket_index(self, v: float) -> int:
        # bisect over a tuple of <=~30 bounds; branchless enough
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, v: float, n: int = 1,
                trace_id: Optional[str] = None) -> None:
        """Record `v`, optionally `n` times in one lock acquisition —
        for call sites that already hold aggregated per-value counts
        (e.g. the spec tier's device-side accept-length histogram);
        identical to n separate observes.  `trace_id` stamps the
        landing bucket's exemplar (the active request's TraceContext
        id — OBSERVABILITY.md "Labeled metrics & exemplars")."""
        v = float(v)
        if n < 1:
            return
        i = self._bucket_index(v)
        with self._lock:
            self._counts[i] += n
            self._sum += v * n
            self._count += n
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if trace_id is not None:
                self._exemplars[i] = (str(trace_id), v)
        p = self._parent
        if p is not None:
            p.observe(v, n, trace_id)

    def exemplars(self) -> List[Dict[str, Any]]:
        """The stamped bucket exemplars: [{"le", "trace_id", "value"}]
        (only buckets that ever saw a traced observation)."""
        with self._lock:
            exs = list(self._exemplars)
        out: List[Dict[str, Any]] = []
        for i, e in enumerate(exs):
            if e is None:
                continue
            le = (f"{self.buckets[i]:g}" if i < len(self.buckets)
                  else "+Inf")
            out.append({"le": le, "trace_id": e[0], "value": e[1]})
        return out

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Value at quantile q in [0, 100], interpolated within the
        bucket; 0.0 when empty."""
        if not 0 <= q <= 100:
            raise ValueError(f"q must be in [0, 100], got {q}")
        with self._lock:
            counts = list(self._counts)
            total = self._count
            vmin, vmax = self._min, self._max
        if total == 0:
            return 0.0
        rank = q / 100.0 * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            prev_cum = cum
            cum += c
            if cum >= rank:
                lo = self.buckets[i - 1] if i > 0 else min(vmin, 0.0)
                hi = self.buckets[i] if i < len(self.buckets) else vmax
                # clamp the bucket edges to what was actually observed
                lo = max(lo, vmin) if vmin != math.inf else lo
                hi = min(hi, vmax) if vmax != -math.inf else hi
                if hi <= lo or c == 0:
                    return hi
                frac = (rank - prev_cum) / c
                return lo + frac * (hi - lo)
        return vmax  # q == 100 falls through on float fuzz

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "type": "histogram",
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "p50": None, "p99": None,  # filled below, outside the lock
            }

    def snapshot_with_percentiles(self) -> Dict:
        s = self.snapshot()
        s["p50"] = self.percentile(50)
        s["p99"] = self.percentile(99)
        return s


# --------------------------------------------------------------------------
# Null objects — the disabled fast path
# --------------------------------------------------------------------------

class _NullCounter:
    __slots__ = ()
    name = "<null>"
    value = 0.0
    labels_kv = ()

    def labels(self, **kv: Any) -> "_NullCounter":
        return self

    def label_children(self) -> Tuple:
        return ()

    def remove_labels(self, **kv: Any) -> bool:
        return False

    def inc(self, n: float = 1.0) -> None:
        pass

    def snapshot(self) -> Dict:
        return {"type": "counter", "value": 0.0}


class _NullGauge:
    __slots__ = ()
    name = "<null>"
    value = 0.0
    labels_kv = ()

    def labels(self, **kv: Any) -> "_NullGauge":
        return self

    def label_children(self) -> Tuple:
        return ()

    def remove_labels(self, **kv: Any) -> bool:
        return False

    def set(self, v: float) -> None:
        pass

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def snapshot(self) -> Dict:
        return {"type": "gauge", "value": 0.0}


class _NullHistogram:
    __slots__ = ()
    name = "<null>"
    count = 0
    sum = 0.0
    mean = 0.0
    buckets = ()
    labels_kv = ()

    def labels(self, **kv: Any) -> "_NullHistogram":
        return self

    def label_children(self) -> Tuple:
        return ()

    def remove_labels(self, **kv: Any) -> bool:
        return False

    def observe(self, v: float, n: int = 1,
                trace_id: Optional[str] = None) -> None:
        pass

    def exemplars(self) -> List[Dict[str, Any]]:
        return []

    def percentile(self, q: float) -> float:
        return 0.0

    def snapshot(self) -> Dict:
        return {"type": "histogram", "count": 0, "sum": 0.0}

    snapshot_with_percentiles = snapshot


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

def _expo_name(name: str) -> str:
    """`train/step_time_seconds` -> `train_step_time_seconds` (Prometheus
    text exposition allows [a-zA-Z0-9_:] only)."""
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch in "_:") else "_")
    return "".join(out)


def _series_key(name: str, kv: LabelsKV) -> str:
    """The JSON-snapshot key of one labeled series: the raw metric name
    plus the exposition label suffix (``serve/queue_depth{replica="r0"}``)."""
    return name + _label_suffix(kv)


class Registry:
    """Get-or-create metric namespace.  One instance is the process-wide
    default (obs.registry()); tests construct their own for isolation."""

    def __init__(self, enabled: bool = True,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        self.enabled = enabled
        self.max_label_sets = max_label_sets
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()
        # span machinery lives here so swapping registries isolates it
        # (wired by obs.spans.Tracer at first span())
        self.tracer = None  # type: ignore[assignment]
        self.event_sink = None  # obs.export.EventSink, when installed
        # the live telemetry plane's per-registry state:
        # component heartbeats (obs.http.board_for) and the failure
        # flight recorder (obs.flightrec.install_flight_recorder)
        self.heartbeats = None  # obs.http.HeartbeatBoard
        self.flight = None  # obs.flightrec.FlightRecorder
        # non-numeric health facts a component wants on /healthz (e.g.
        # the serving layer's effective serve_mode — the
        # router's routing inputs must be scrapeable); set through
        # obs.http.set_health_info, read by obs.http.health AND /snapshot
        self.health_info = None  # Optional[Dict[str, Any]]
        # fleet identity + aggregation plane: replica_id tags
        # this registry's request events and flight dumps; fleet_sources
        # (set by the FleetRouter) is a zero-arg callable returning the
        # ordered {replica_id: Registry} map /fleet/* merges over
        self.replica_id = ""
        self.fleet_sources = None  # Optional[Callable[[], Dict[str, Registry]]]
        # the SLO burn-rate engine (obs/slo.py), when installed
        self.slo = None
        # the performance attribution plane (obs/profile.py):
        # phase ledger + divergence sentinel, attached
        # first-install-wins by profile.install_profiler
        self.profile = None

    def _note_label_evictions(self, n: int) -> None:
        self.counter("obs/label_evictions_total").inc(n)

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                # wire the label-cardinality bound + eviction counter
                # (harmless on the eviction counter itself: it never
                # hands out labeled children)
                m._max_label_sets = self.max_label_sets
                m._evict_cb = self._note_label_evictions
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return NULL_COUNTER  # type: ignore[return-value]
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return NULL_GAUGE  # type: ignore[return-value]
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        if not self.enabled:
            return NULL_HISTOGRAM  # type: ignore[return-value]
        return self._get_or_create(name, Histogram, buckets)

    def get(self, name: str):
        """The metric registered under `name`, or None."""
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self, compact: bool = False) -> Dict[str, Dict]:
        """{name: metric snapshot}.  compact=True drops metrics that were
        never touched (zero counters, empty histograms, never-written
        gauges) — the form BENCH rows embed (bench.py --obs-snapshot).
        Labeled children ride along keyed ``name{k="v",...}`` (same
        compaction rule per series)."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Dict] = {}
        for name, m in sorted(items):
            for metric in (m, *m.label_children()):
                if isinstance(metric, Histogram):
                    s = metric.snapshot_with_percentiles()
                    # bucket arrays are exposition detail, not snapshot
                    # payload
                    s.pop("buckets", None)
                    s.pop("counts", None)
                else:
                    s = metric.snapshot()
                if compact:
                    if s["type"] == "histogram" and not s.get("count"):
                        continue
                    if s["type"] == "counter" and not s.get("value"):
                        continue
                    # a gauge legitimately at 0.0 (starved queue depth)
                    # is an observation, not an untouched metric — keep
                    if s["type"] == "gauge" and not metric.touched:
                        continue
                out[_series_key(name, metric.labels_kv)] = s
        return out

    def series(self) -> List[Tuple[str, LabelsKV, str, Any]]:
        """Flat per-series rows: (name, labels, kind, payload) for every
        parent metric and labeled child — the fleet aggregation plane's
        input (``merge_fleet_series``).  Payloads: counter -> value;
        gauge -> (value, touched); histogram -> its ``snapshot()`` dict
        plus an ``"exemplars"`` list."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: List[Tuple[str, LabelsKV, str, Any]] = []
        for name, m in items:
            for metric in (m, *m.label_children()):
                if isinstance(m, Counter):
                    out.append((name, metric.labels_kv, "counter",
                                metric.value))
                elif isinstance(m, Gauge):
                    out.append((name, metric.labels_kv, "gauge",
                                (metric.value, metric.touched)))
                elif isinstance(m, Histogram):
                    snap = metric.snapshot()
                    snap["exemplars"] = metric.exemplars()
                    out.append((name, metric.labels_kv, "histogram", snap))
        return out

    def _render_histogram_series(self, lines: List[str], ename: str,
                                 h: Histogram, kv: LabelsKV,
                                 exemplars: bool = True) -> None:
        snap = h.snapshot()
        ex_by_le = {e["le"]: e for e in h.exemplars()} if exemplars \
            else {}
        cum = 0
        for bound, c in zip(snap["buckets"], snap["counts"]):
            cum += c
            le = f"{bound:g}"
            suffix = _label_suffix(kv, 'le="%s"' % le)
            line = f"{ename}_bucket{suffix} {cum}"
            ex = ex_by_le.get(le)
            if ex is not None:
                # OpenMetrics exemplar syntax: the bucket's last traced
                # observation (OBSERVABILITY.md "Labeled metrics &
                # exemplars")
                line += (' # {trace_id="%s"} %g'
                         % (_escape_label(ex["trace_id"]), ex["value"]))
            lines.append(line)
        cum += snap["counts"][-1]
        suffix = _label_suffix(kv, 'le="+Inf"')
        line = f"{ename}_bucket{suffix} {cum}"
        ex = ex_by_le.get("+Inf")
        if ex is not None:
            line += (' # {trace_id="%s"} %g'
                     % (_escape_label(ex["trace_id"]), ex["value"]))
        lines.append(line)
        lines.append(f"{ename}_sum{_label_suffix(kv)} {snap['sum']:g}")
        lines.append(f"{ename}_count{_label_suffix(kv)} {snap['count']}")

    def render_text(self, exemplars: Optional[bool] = None,
                    openmetrics: bool = False) -> str:
        """Prometheus-style text exposition of every metric series —
        unlabeled parents and labeled children alike; histogram buckets
        carry their OpenMetrics trace exemplars when stamped.

        ``exemplars`` defaults to `openmetrics`: the ``# {trace_id=...}``
        annotation is OpenMetrics syntax and a Prometheus-0.0.4 parser
        rejects it as a trailing timestamp token, so the default render
        is always a VALID exposition in whichever format was asked for
        — strict 0.0.4 without negotiation, annotated OpenMetrics with.
        ``exemplars=True`` forces the annotations into a 0.0.4 body for
        callers that want the hybrid (debug dumps).

        ``openmetrics=True`` makes the body a VALID OpenMetrics 1.0
        exposition, not just exemplar-annotated text: counter families
        are typed under their ``_total``-stripped name with samples
        keeping the ``_total`` suffix (the OpenMetrics sample-suffix
        rule), and the mandatory ``# EOF`` terminator is appended — a
        negotiating Prometheus server rejects the whole scrape without
        either ('data does not end with # EOF')."""
        if exemplars is None:
            exemplars = openmetrics
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in items:
            ename = _expo_name(name)
            if isinstance(m, Counter):
                if openmetrics:
                    fam = ename[:-len("_total")] \
                        if ename.endswith("_total") else ename
                    sample = fam + "_total"
                else:
                    fam = sample = ename
                lines.append(f"# TYPE {fam} counter")
                lines.append(f"{sample} {m.value:g}")
                for child in m.label_children():
                    lines.append(f"{sample}{_label_suffix(child.labels_kv)}"
                                 f" {child.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {ename} gauge")
                lines.append(f"{ename} {m.value:g}")
                for child in m.label_children():
                    lines.append(f"{ename}{_label_suffix(child.labels_kv)}"
                                 f" {child.value:g}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {ename} histogram")
                self._render_histogram_series(lines, ename, m, (),
                                              exemplars=exemplars)
                for child in m.label_children():
                    self._render_histogram_series(lines, ename, child,
                                                  child.labels_kv,
                                                  exemplars=exemplars)
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every metric (tests)."""
        with self._lock:
            self._metrics.clear()


NULL_REGISTRY = Registry(enabled=False)


# --------------------------------------------------------------------------
# Fleet aggregation (piece 3)
# --------------------------------------------------------------------------

def _merged_histogram(name: str, buckets: Sequence[float],
                      snaps: Iterable[Dict]) -> Dict:
    """Bucket-wise merge of same-layout histogram snapshots: counts sum
    per bucket, sum/count sum, min/max fold — the merged exposition is
    exactly what one registry observing every replica's stream would
    render (pinned by tests/test_obs_labels.py)."""
    counts = [0] * (len(buckets) + 1)
    total, vsum = 0, 0.0
    vmin, vmax = math.inf, -math.inf
    for s in snaps:
        for i, c in enumerate(s["counts"]):
            counts[i] += c
        total += s["count"]
        vsum += s["sum"]
        if s["count"]:
            vmin = min(vmin, s["min"])
            vmax = max(vmax, s["max"])
    return {"type": "histogram", "count": total, "sum": vsum,
            "min": vmin if total else None, "max": vmax if total else None,
            "buckets": list(buckets), "counts": counts}


def merge_fleet_series(named: Dict[str, "Registry"],
                       ) -> List[Tuple[str, LabelsKV, str, Any]]:
    """Merge N registries' series into one fleet view:

      * counters — summed per (name, labels) across registries;
      * gauges — one series per replica, labels extended with
        ``replica=<id>`` (summing last-write-wins values would lie);
      * histograms — bucket-wise merged when every replica agrees on
        the bucket layout; a layout mismatch falls back to per-replica
        ``replica=``-labeled series (never a wrong sum).

    Returns the same row shape as ``Registry.series()`` (histogram
    payloads carry ``counts``/``buckets`` for exposition).  Declared a
    TS002 hot function: /fleet/metrics is scraped on a cadence and a
    stray device sync here would stall every replica's scrape at once.
    """
    counters: "OrderedDict[Tuple[str, LabelsKV], float]" = OrderedDict()
    gauges: List[Tuple[str, LabelsKV, float]] = []
    hists: "OrderedDict[Tuple[str, LabelsKV], List[Tuple[str, Dict]]]" = \
        OrderedDict()
    for rid, reg in named.items():
        for name, kv, kind, payload in reg.series():
            if kind == "counter":
                key = (name, kv)
                counters[key] = counters.get(key, 0.0) + payload
            elif kind == "gauge":
                value, touched = payload
                if touched or value:
                    tag = () if any(k == "replica" for k, _ in kv) \
                        else (("replica", rid),)
                    gauges.append((name, kv + tag, value))
            elif kind == "histogram":
                hists.setdefault((name, kv), []).append((rid, payload))
    out: List[Tuple[str, LabelsKV, str, Any]] = []
    for (name, kv), value in counters.items():
        out.append((name, kv, "counter", value))
    for name, kv, value in gauges:
        out.append((name, kv, "gauge", value))
    for (name, kv), snaps in hists.items():
        layouts = {tuple(s["buckets"]) for _, s in snaps}
        if len(layouts) == 1:
            out.append((name, kv, "histogram", _merged_histogram(
                name, next(iter(layouts)), (s for _, s in snaps))))
        else:  # layout mismatch: honest per-replica series, never a
            # cross-layout "sum"
            for rid, s in snaps:
                out.append((name, kv + (("replica", rid),),
                            "histogram", s))
    out.sort(key=lambda row: (row[0], row[1]))
    return out


def render_fleet_text(named: Dict[str, "Registry"]) -> str:
    """The merged fleet exposition (/fleet/metrics): Prometheus text
    over ``merge_fleet_series`` rows."""
    rows = merge_fleet_series(named)
    lines: List[str] = []
    last_typed = None
    for name, kv, kind, payload in rows:
        ename = _expo_name(name)
        if (ename, kind) != last_typed:
            lines.append(f"# TYPE {ename} "
                         f"{'histogram' if kind == 'histogram' else kind}")
            last_typed = (ename, kind)
        if kind in ("counter", "gauge"):
            lines.append(f"{ename}{_label_suffix(kv)} {payload:g}")
            continue
        cum = 0
        for bound, c in zip(payload["buckets"], payload["counts"]):
            cum += c
            suffix = _label_suffix(kv, 'le="%g"' % bound)
            lines.append(f"{ename}_bucket{suffix} {cum}")
        cum += payload["counts"][-1]
        suffix = _label_suffix(kv, 'le="+Inf"')
        lines.append(f"{ename}_bucket{suffix} {cum}")
        lines.append(f"{ename}_sum{_label_suffix(kv)} {payload['sum']:g}")
        lines.append(f"{ename}_count{_label_suffix(kv)} {payload['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def merge_fleet_snapshot(named: Dict[str, "Registry"]) -> Dict[str, Any]:
    """The merged fleet snapshot (/fleet/snapshot): JSON-shaped
    ``{"replicas": [...], "metrics": {series-key: snapshot}, "health":
    {replica: health_info}}``.  Histogram entries carry merged
    count/sum/min/max plus p50/p99 recomputed over the merged buckets.
    """
    metrics: Dict[str, Dict] = {}
    for name, kv, kind, payload in merge_fleet_series(named):
        key = _series_key(name, kv)
        if kind == "counter":
            metrics[key] = {"type": "counter", "value": payload}
        elif kind == "gauge":
            metrics[key] = {"type": "gauge", "value": payload}
        else:
            h = Histogram(name, payload["buckets"])
            h._counts = list(payload["counts"])
            h._count = payload["count"]
            h._sum = payload["sum"]
            h._min = payload["min"] if payload["min"] is not None \
                else math.inf
            h._max = payload["max"] if payload["max"] is not None \
                else -math.inf
            metrics[key] = {
                "type": "histogram", "count": payload["count"],
                "sum": payload["sum"], "min": payload["min"],
                "max": payload["max"], "p50": h.percentile(50),
                "p99": h.percentile(99),
            }
    health = {rid: reg.health_info for rid, reg in named.items()
              if getattr(reg, "health_info", None)}
    return {"replicas": list(named), "metrics": metrics, "health": health}
