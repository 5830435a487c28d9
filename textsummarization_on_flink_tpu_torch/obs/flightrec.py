"""Failure flight recorder: a bounded ring of structured frames dumped
to disk when a typed failure trigger fires (piece 3).

The recovery paths in ``resilience/`` (NaN rollback, serve dispatch
failure, breaker trips, deadline-eviction storms) each leave a COUNTER
behind today; post-mortem questions — "what did the last 50 steps look
like before the rollback?" — need the frames themselves.  Hot loops
call ``record(kind, **fields)`` with a tiny dict per train step / serve
tick; the ring (``collections.deque(maxlen=capacity)``) keeps only the
newest ``capacity`` frames, so a week-long run costs the same memory as
a minute-long one.  When a trigger fires, ``trigger(registry, reason)``
dumps the ring to ``flight_<reason>.jsonl`` in the recorder's directory
— the N frames *strictly preceding* the trigger, plus one header record
naming the reason.

Wiring (first install wins per registry, like the EventSink):

    rec = flightrec.install_flight_recorder(registry, train_dir,
                                            capacity=hps.flight_frames)
    flightrec.record(registry, "train_step", step=i, loss=..., ...)
    flightrec.trigger(registry, "train_nan")   # -> flight_train_nan.jsonl

Frame producers: train/trainer.py (per-step loss, grad-norm, step time,
prefetch depth), serve/batcher.py + serve/server.py (per-tick occupancy,
queue depth, evictions, refills / per-dispatch fill), the profiler's
notes.  Trigger sites: the trainer NaN watchdog + divergence recovery,
the profiler's divergence sentinel, both serve dispatch failure paths,
CircuitBreaker open transitions (resilience/policy.py), and
continuous-mode eviction storms.  All CPU-verifiable: the chaos
tests drive each trigger through the existing TS_FAULTS points.

Storm-proof by design: at most ``max_dumps_per_reason`` files per
reason (later triggers counted in ``obs/flight_dumps_dropped_total``,
never written), and a dump failure increments
``obs/flight_dump_errors_total`` instead of raising into the recovery
path that triggered it.  Import-light: no jax/numpy.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

from textsummarization_on_flink_tpu_torch.obs.registry import Registry

DEFAULT_CAPACITY = 64
DEFAULT_MAX_DUMPS_PER_REASON = 5


def _safe_reason(reason: str) -> str:
    """`reason` as a filename fragment ([A-Za-z0-9._-] survives)."""
    return "".join(ch if (ch.isalnum() or ch in "._-") else "_"
                   for ch in reason) or "unknown"


def _json_safe(obj: Any) -> Any:
    """`obj` with non-finite floats stringified ("nan"/"inf"/"-inf").

    The train_nan dump's whole point is the non-finite loss frame, and
    Python's default ``json.dumps`` would write it as a bare ``NaN``
    token — which json.loads tolerates but jq / JSON.parse / strict
    JSONL tooling reject.  Strings keep the fact visible AND the file
    parseable everywhere."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else repr(obj)  # "nan"/"inf"
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def _dumps(rec: Dict[str, Any]) -> str:
    return json.dumps(_json_safe(rec), allow_nan=False, default=str)


class FlightRecorder:
    """Bounded ring of structured frames + triggered JSONL dumps.

    ``replica_id`` tags every frame and dump
    filename when set — fleet replicas sharing one log directory write
    ``flight_<reason>.<replica>.jsonl``, so replica 2's serve-dispatch
    dump can never clobber or shadow replica 0's.  Threaded from
    FleetRouter replica construction via ``set_replica_id``."""

    def __init__(self, directory: str, capacity: int = DEFAULT_CAPACITY,
                 registry: Optional[Registry] = None,
                 max_dumps_per_reason: int = DEFAULT_MAX_DUMPS_PER_REASON,
                 replica_id: str = ""):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.directory = directory
        self.capacity = capacity
        self.replica_id = _safe_reason(replica_id) if replica_id else ""
        self._frames: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        # per reason: attempts drive file NAMING (monotonic, so a retry
        # after a failed write can never overwrite an earlier success);
        # successes drive the BUDGET (a transiently unwritable disk must
        # not burn the post-mortem allowance without leaving a file)
        self._dump_attempts: Dict[str, int] = {}
        self._dumps: Dict[str, int] = {}  # reason -> dumps WRITTEN
        self._max_dumps = max(max_dumps_per_reason, 1)
        reg = registry if registry is not None else Registry(enabled=True)
        self._c_dumps = reg.counter("obs/flight_dumps_total")
        self._c_dropped = reg.counter("obs/flight_dumps_dropped_total")
        self._c_errors = reg.counter("obs/flight_dump_errors_total")

    def record(self, kind: str, **fields: Any) -> None:
        """Append one frame (hot path: one small dict + deque append
        under a lock; the ring evicts the oldest frame itself)."""
        with self._lock:
            self._seq += 1
            frame = {"seq": self._seq, "kind": kind,
                     # serialized epoch timestamp, same dialect as span
                     # ts_us (the sanctioned time.time() use, spans.py)
                     "ts_us": int(time.time() * 1e6)}
            if self.replica_id:
                frame["replica"] = self.replica_id
            frame.update(fields)
            self._frames.append(frame)

    def frames(self) -> List[dict]:
        with self._lock:
            return list(self._frames)

    def dump(self, reason: str, **context: Any) -> Optional[str]:
        """Write the ring to ``flight_<reason>.jsonl`` (``-2``, ``-3``
        suffixes on repeat triggers); returns the path, or None when
        the per-reason dump budget is spent / the write failed.  The
        recovery path that triggered the dump NEVER sees an exception
        from here."""
        reason = _safe_reason(reason)
        with self._lock:
            frames = list(self._frames)
            if self._dumps.get(reason, 0) >= self._max_dumps:
                self._c_dropped.inc()
                return None
            n = self._dump_attempts.get(reason, 0) + 1
            self._dump_attempts[reason] = n
        # the replica tag keeps fleet replicas sharing one directory
        # from clobbering/shadowing each other's dumps
        stem = (f"flight_{reason}.{self.replica_id}" if self.replica_id
                else f"flight_{reason}")
        name = f"{stem}.jsonl" if n == 1 else f"{stem}-{n}.jsonl"
        path = os.path.join(self.directory, name)
        header: Dict[str, Any] = {
            "kind": "flight", "reason": reason, "dump": n,
            "ts_us": int(time.time() * 1e6), "frames": len(frames),
            "capacity": self.capacity,
        }
        if self.replica_id:
            header["replica"] = self.replica_id
        if context:
            header["context"] = context
        try:
            os.makedirs(self.directory, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                f.write(_dumps(header) + "\n")
                for frame in frames:
                    f.write(_dumps(frame) + "\n")
        except (OSError, ValueError, TypeError):
            self._c_errors.inc()
            return None
        with self._lock:
            self._dumps[reason] = self._dumps.get(reason, 0) + 1
        self._c_dumps.inc()
        return path


_install_lock = threading.Lock()


def install_flight_recorder(registry: Registry, directory: str,
                            capacity: int = DEFAULT_CAPACITY,
                            ) -> Optional[FlightRecorder]:
    """Attach a FlightRecorder to `registry` (first install wins — a
    trainer and a server sharing one registry share one ring; the
    double-checked lock mirrors spans.tracer_for so two components
    constructed concurrently can never race two rings into existence).
    No-op (None) on a disabled registry."""
    if not registry.enabled:
        return None
    if registry.flight is None:
        with _install_lock:
            if registry.flight is None:
                registry.flight = FlightRecorder(
                    directory, capacity=capacity, registry=registry,
                    replica_id=getattr(registry, "replica_id", ""))
    return registry.flight


def set_replica_id(registry: Registry, replica_id: str) -> None:
    """Stamp `registry` (and any already-installed recorder) with the
    fleet replica id its frames/dumps — and request events — should
    carry (threaded from FleetRouter replica construction)."""
    registry.replica_id = replica_id
    rec = registry.flight
    if rec is not None:
        rec.replica_id = _safe_reason(replica_id) if replica_id else ""


def record(registry: Registry, kind: str, **fields: Any) -> None:
    """Append a frame to `registry`'s recorder; no-op when none is
    installed (the unarmed fast path is one attribute test)."""
    rec = registry.flight
    if rec is not None:
        rec.record(kind, **fields)


def trigger(registry: Registry, reason: str, **context: Any,
            ) -> Optional[str]:
    """Dump `registry`'s ring for `reason`; returns the dump path (None
    when no recorder is installed, budget spent, or the write failed)."""
    rec = registry.flight
    if rec is None:
        return None
    return rec.dump(reason, **context)
