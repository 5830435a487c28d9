"""Telemetry exporters: unified JSONL event sink + Chrome-trace dump.

The EventSink is the only writer that may sit on a hot path, so it is
built to never block or crash the caller:

  * `emit()` is a bounded-queue put_nowait — a full queue increments
    ``obs/events_dropped_total`` and drops the record (telemetry must
    never stall a train step);
  * a daemon flusher thread batches queued records to disk every
    `flush_secs`;
  * a deleted/rotated target directory is recreated and the file
    reopened; a persistent write failure increments
    ``obs/sink_write_errors_total`` and drops the batch (same contract
    as SummaryWriter.scalars).

File format: one JSON object per line under
``<log_root>/<exp>/<job>/events.jsonl`` — the SAME file family
SummaryWriter uses for scalars (`{"step": N, ...}`); obs records carry a
``"kind"`` discriminator ({"kind": "span" | "snapshot"}), so one reader
(scripts/trace_summary.py) summarizes both.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, List, Optional

from textsummarization_on_flink_tpu_torch.obs import spans as spans_lib
from textsummarization_on_flink_tpu_torch.obs.registry import Registry

EVENTS_FILENAME = "events.jsonl"


class EventSink:
    """Bounded-queue background JSONL writer."""

    def __init__(self, directory: str, filename: str = EVENTS_FILENAME,
                 flush_secs: float = 2.0, max_queue: int = 4096,
                 registry: Optional[Registry] = None):
        self.directory = directory
        self.path = os.path.join(directory, filename)
        self._flush_secs = max(flush_secs, 0.05)
        self._q: "queue.Queue[Optional[dict]]" = queue.Queue(maxsize=max_queue)
        reg = registry if registry is not None else Registry(enabled=True)
        self._dropped = reg.counter("obs/events_dropped_total")
        self._write_errors = reg.counter("obs/sink_write_errors_total")
        # gap annotation: drops since the last flush
        # cycle, folded into the stream as one {"kind": "drops"} record
        # so a hole in events.jsonl is visible IN the file, not only in
        # the counter.  Own lock: touched only on the (already
        # overloaded) drop path and once per flush cycle.
        self._drop_note_lock = threading.Lock()
        self._pending_drops = 0
        self._registry = reg
        self._f = None
        self._closed = threading.Event()
        self._kick = threading.Event()  # close()/flush() fast-forward
        # flush-cycle generation: bumped by the flusher after each
        # drain+write completes, so flush() can wait for a write that
        # STARTED after it was called instead of sleeping and hoping
        self._gen = 0
        self._gen_cv = threading.Condition()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-event-sink")
        self._thread.start()

    # -- producer side (any thread, never blocks) --
    def emit(self, record: Dict[str, Any]) -> bool:
        """Queue one record; False (+ drop counter) when the queue is
        full or the sink is closed."""
        if self._closed.is_set():
            self._dropped.inc()
            self._note_drop()
            return False
        try:
            self._q.put_nowait(record)
            return True
        except queue.Full:
            self._dropped.inc()
            self._note_drop()
            return False

    def _note_drop(self) -> None:
        with self._drop_note_lock:
            self._pending_drops += 1

    # -- flusher --
    def _open(self) -> bool:
        try:
            os.makedirs(self.directory, exist_ok=True)
            self._f = open(self.path, "a", encoding="utf-8")
            return True
        except OSError:
            self._f = None
            return False

    def _write_batch(self, batch: List[dict]) -> None:
        if not batch:
            return
        payload = "".join(json.dumps(r) + "\n" for r in batch)
        # a rotated/deleted directory does NOT fail writes on POSIX (the
        # unlinked inode absorbs them) — detect it by path and reopen.
        # One stat per flush batch, never on the emit hot path.
        if self._f is not None and not os.path.exists(self.path):
            try:
                self._f.close()
            except (OSError, ValueError):  # double-close on a dead handle
                pass
            self._f = None
        for attempt in (0, 1):
            if self._f is None and not self._open():
                continue
            try:
                self._f.write(payload)
                self._f.flush()
                return
            except (OSError, ValueError):  # ValueError: closed file
                try:
                    self._f.close()
                except (OSError, ValueError):
                    pass
                self._f = None
        # both attempts failed: count the loss, drop the batch
        self._write_errors.inc(len(batch))

    def _drain(self) -> List[dict]:
        batch: List[dict] = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return batch
            if item is not None:
                batch.append(item)

    def _bump_gen(self) -> None:
        with self._gen_cv:
            self._gen += 1
            self._gen_cv.notify_all()

    def _annotated(self, batch: List[dict]) -> List[dict]:
        """Fold any drop episode since the last cycle into the stream as
        one ``{"kind": "drops", "count": N}`` record.  The drops
        happened because the queue was full of exactly the records being
        drained now, so the hole sits AFTER them in file order (a
        best-effort position — racing emits may interleave)."""
        with self._drop_note_lock:
            n, self._pending_drops = self._pending_drops, 0
        if n:
            import time as _t

            batch.append({"kind": "drops", "count": n,
                          "ts_us": int(_t.time() * 1e6)})
        return batch

    def _run(self) -> None:
        from textsummarization_on_flink_tpu_torch.obs import http as http_mod

        period = max(self._flush_secs, 1.0)
        while not self._closed.is_set():
            # the flusher is a component of the live plane: its own
            # heartbeat makes a wedged sink visible on /healthz
            http_mod.heartbeat(self._registry, "obs/event_sink",
                               period=period)
            self._kick.wait(self._flush_secs)
            self._kick.clear()
            self._write_batch(self._annotated(self._drain()))
            self._bump_gen()
        self._write_batch(self._annotated(self._drain()))  # final flush
        self._bump_gen()
        # clean shutdown: a closed sink must not hold /healthz degraded
        http_mod.retire_heartbeat(self._registry, "obs/event_sink")
        if self._f is not None:
            try:
                self._f.close()
            except (OSError, ValueError):  # flusher exit: best-effort close
                pass

    def flush(self, timeout: float = 5.0) -> None:
        """Wait (bounded) until a drain+write cycle that STARTED after
        this call has completed — everything emitted before the call is
        then on disk (or counted dropped), not merely dequeued."""
        import time as _t

        deadline = _t.monotonic() + timeout
        with self._gen_cv:
            # +2: the current cycle may have drained the queue before our
            # caller's records were enqueued; two completions guarantee a
            # full cycle ran start-to-finish after this point
            target = self._gen + 2
            while self._gen < target and self._thread.is_alive():
                remaining = deadline - _t.monotonic()
                if remaining <= 0:
                    break
                self._kick.set()
                self._gen_cv.wait(min(remaining, 0.05))

    def close(self, timeout: float = 5.0) -> None:
        if self._closed.is_set():
            return
        self.flush(timeout)
        self._closed.set()
        self._kick.set()
        self._thread.join(timeout=timeout)


class MemorySink:
    """In-memory EventSink stand-in (same ``emit`` contract): records
    land in a bounded list instead of a file.  For tests and for
    bench.py's trace-derived per-request breakdown, where spinning a
    flusher thread and parsing JSONL back would only add noise."""

    def __init__(self, max_records: int = 100_000):
        self._lock = threading.Lock()
        self._records: List[dict] = []
        self._max = max_records

    def emit(self, record: Dict[str, Any]) -> bool:
        with self._lock:
            if len(self._records) >= self._max:
                return False
            self._records.append(record)
            return True

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    def flush(self, timeout: float = 0.0) -> None:
        pass  # synchronous by construction

    def close(self, timeout: float = 0.0) -> None:
        pass


def install_event_sink(registry: Registry, directory: str,
                       flush_secs: float = 2.0,
                       max_queue: int = 4096) -> Optional[EventSink]:
    """Attach an EventSink to `registry` so finished spans stream to
    `<directory>/events.jsonl`.  No-op (None) on a disabled registry."""
    if not registry.enabled:
        return None
    sink = EventSink(directory, flush_secs=flush_secs, max_queue=max_queue,
                     registry=registry)
    registry.event_sink = sink
    return sink


def write_chrome_trace(registry: Registry, path: str) -> int:
    """Dump the registry's buffered spans as a Chrome-trace JSON file
    (`{"traceEvents": [...]}`) — the dialect scripts/trace_summary.py
    already summarizes.  Returns the number of span events written."""
    tracer = spans_lib.tracer_for(registry)
    events = tracer.chrome_trace_events()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events}, f)
    return sum(1 for e in events if e.get("ph") == "X")


def snapshot_event(registry: Registry, compact: bool = True,
                   ) -> Dict[str, Any]:
    """A `{"kind": "snapshot", "metrics": {...}}` record for the unified
    events.jsonl (periodic registry dumps alongside spans/scalars)."""
    return {"kind": "snapshot", "metrics": registry.snapshot(compact=compact)}
