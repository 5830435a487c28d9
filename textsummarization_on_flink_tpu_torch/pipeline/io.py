"""Row schemas, wire types, sources and sinks, and the message codec.

The port's copy of the JAX package's pipeline/io.py, the reference's
streaming I/O surface without the Flink runtime:

  * ``DataTypes``/``RowSchema``: the supported wire types and the schema
    of CodingUtils.java:25-129 (STRING, BOOL, INT8/16/32/64, FLOAT32/64,
    UINT16, FLOAT32_ARRAY; anything else raises);
  * ``Message``: the Kafka JSON payload (uuid, article, summary,
    reference) of me/littlebo/Message.java:1-71;
  * sources: collection (TensorFlowTest.java:204-217), iterator, socket
    (testInferenceFromSocket, TensorFlowTest.java:123-140) with an idle
    timeout that raises ``StreamIdleError``, and Kafka (App.java:134-152;
    needs ``kafka-python``, which is imported only when a Kafka source
    or sink is used), each with the bounded-stream ``max_count`` of
    MessageDeserializationSchema.java:34-40;
  * sinks: collection, print (App.java:100), socket, Kafka and queue,
    each flushed per record (the reference's bridge surfaced a result
    only when the NEXT record arrived, Integration Report:879-941).

Resilience (RESILIENCE.md):
  * ``ResilientSource`` wraps any source factory (socket, Kafka,
    iterator) with reconnect-with-backoff and uuid-keyed dedup, so a
    flapping peer delivers every row exactly once downstream;
  * ``BreakerSink`` wraps any sink with a circuit breaker: a down broker
    sheds rows (counted) instead of blocking the pipeline;
  * the fault points ``io.connect`` / ``io.read`` (socket and Kafka
    sources) and ``io.write`` (``BreakerSink``) drive these paths
    deterministically (resilience/faultinject.py).
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import socket as socket_lib
import threading
import time
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.resilience import faultinject
from textsummarization_on_flink_tpu_torch.resilience.errors import (
    StreamIdleError,
)
from textsummarization_on_flink_tpu_torch.resilience.policy import (
    CircuitBreaker,
    RetryPolicy,
)

log = logging.getLogger(__name__)

# the failure classes a reconnect can fix: connection/socket errors, the
# typed idle timeout, and (when kafka-python is present) KafkaError,
# which subclasses RuntimeError rather than OSError
try:  # pragma: no cover - optional dependency
    from kafka.errors import KafkaError as _KafkaError

    _RECONNECT_ERRORS: Tuple[type, ...] = (
        OSError, StreamIdleError, _KafkaError)
except ImportError:
    _RECONNECT_ERRORS = (OSError, StreamIdleError)

Row = Tuple[Any, ...]


class SchemaProjectionError(ValueError):
    """A wire row cannot be projected onto the consumer's schema (wrong
    arity, non-object payload, missing columns).

    Distinct from a *malformed* line (bad JSON — dropped and counted in
    ``pipeline/codec_errors_total``: a lossy producer must not kill a
    long-lived stream): a row that PARSES but cannot match the declared
    schema means the producer and consumer disagree about the contract,
    and silently stopping (or dropping) would truncate the dataset with
    no signal.  Typed so stream supervisors can route on it; every
    raise is counted in ``pipeline/feeder_errors_total``."""


def _count_source_row() -> None:
    obs.counter("pipeline/source_rows_total").inc()


def _count_sink_row() -> None:
    obs.counter("pipeline/sink_rows_total").inc()


# --------------------------------------------------------------------------
# Wire types (CodingUtils.java:25-129 support matrix)
# --------------------------------------------------------------------------

class DataTypes:
    STRING = "STRING"
    BOOL = "BOOL"
    INT_8 = "INT_8"
    INT_16 = "INT_16"
    INT_32 = "INT_32"
    INT_64 = "INT_64"
    UINT_16 = "UINT_16"
    FLOAT_32 = "FLOAT_32"
    FLOAT_64 = "FLOAT_64"
    FLOAT_32_ARRAY = "FLOAT_32_ARRAY"

    _ALL = (STRING, BOOL, INT_8, INT_16, INT_32, INT_64, UINT_16,
            FLOAT_32, FLOAT_64, FLOAT_32_ARRAY)
    _INTS = (INT_8, INT_16, INT_32, INT_64, UINT_16, BOOL)
    _FLOATS = (FLOAT_32, FLOAT_64)

    @classmethod
    def validate(cls, name: str) -> str:
        if name not in cls._ALL:
            # CodingUtils throws RuntimeException("Unsupported data type")
            raise ValueError(f"Unsupported data type for example coding: {name}")
        return name


class RowSchema:
    """Named, typed columns (TableSchema parity, CodingUtils.java:147-194)."""

    def __init__(self, names: Sequence[str], types: Sequence[str]):
        if len(names) != len(types):
            raise ValueError("names/types length mismatch")
        self.names = list(names)
        self.types = [DataTypes.validate(t) for t in types]

    def __len__(self) -> int:
        return len(self.names)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, RowSchema) and self.names == other.names
                and self.types == other.types)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{t}" for n, t in zip(self.names, self.types))
        return f"RowSchema({cols})"

    def select(self, cols: Sequence[str]) -> "RowSchema":
        idx = [self.names.index(c) for c in cols]
        return RowSchema([self.names[i] for i in idx],
                         [self.types[i] for i in idx])

    def project_row(self, row: Row, cols: Sequence[str]) -> Row:
        idx = [self.names.index(c) for c in cols]
        return tuple(row[i] for i in idx)


# The article-summarization row schemas (App.java:94,158-159)
ARTICLE_INPUT_SCHEMA = RowSchema(
    ["uuid", "article", "summary", "reference"], [DataTypes.STRING] * 4)
ARTICLE_OUTPUT_SCHEMA = RowSchema(
    ["uuid", "article", "summary", "reference"], [DataTypes.STRING] * 4)


# --------------------------------------------------------------------------
# Message codec (me/littlebo/Message.java + JSON schemas)
# --------------------------------------------------------------------------

class Message:
    """Kafka JSON payload <-> Row(uuid, article, summary, reference).

    ``tier``/``error`` extend the frame for the
    multi-process serving transport: a request frame carries its
    quality tier, a reply frame carries a typed submit failure as
    ``"ExcType: message"``.  Both serialize ONLY when non-empty, so the
    classic 4-field wire format (and its committed byte accounting) is
    unchanged for every pre-existing producer; ``from_json`` ignores
    unknown keys as before, so mixed-version peers interoperate.
    ``to_row``/``from_row`` stay 4 columns — the extras are transport
    envelope, not schema columns."""

    def __init__(self, uuid: str = "", article: str = "", summary: str = "",
                 reference: str = "", tier: str = "", error: str = ""):
        self.uuid = uuid
        self.article = article
        self.summary = summary
        self.reference = reference
        self.tier = tier
        self.error = error

    def to_row(self) -> Row:
        return (self.uuid, self.article, self.summary, self.reference)

    @classmethod
    def from_row(cls, row: Row) -> "Message":
        return cls(*[str(v) for v in row])

    def to_json(self) -> str:
        d = {"uuid": self.uuid, "article": self.article,
             "summary": self.summary, "reference": self.reference}
        if self.tier:
            d["tier"] = self.tier
        if self.error:
            d["error"] = self.error
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Message":
        d = json.loads(s)
        return cls(uuid=d.get("uuid", ""), article=d.get("article", ""),
                   summary=d.get("summary", ""),
                   reference=d.get("reference", ""),
                   tier=d.get("tier", ""), error=d.get("error", ""))


# --------------------------------------------------------------------------
# Sources
# --------------------------------------------------------------------------

class Source:
    """A bounded or unbounded row stream."""

    schema: RowSchema

    def rows(self) -> Iterator[Row]:
        raise NotImplementedError


class CollectionSource(Source):
    """In-memory rows (the 8-row synthetic tables of
    TensorFlowTest.createArticleData, :204-217)."""

    def __init__(self, rows: Sequence[Row], schema: Optional[RowSchema] = None):
        self._rows = list(rows)
        self.schema = schema or ARTICLE_INPUT_SCHEMA

    def rows(self) -> Iterator[Row]:
        for row in self._rows:
            _count_source_row()
            yield row


class SocketSource(Source):
    """Line-JSON messages from a TCP socket
    (testInferenceFromSocket, TensorFlowTest.java:123-140).

    max_count bounds the stream like MessageDeserializationSchema's record
    counter (:34-40) — the reference's hack to end a Kafka stream is a
    first-class bound here.

    A long-lived stream read is never left with ``settimeout(None)``
    (one dead peer would hang the job): a connection that goes
    ``idle_timeout`` seconds without delivering a byte raises the typed
    ``StreamIdleError``.  Wrap in ``ResilientSource`` for
    reconnect-with-backoff on top.

    Schema contract: a payload that parses but
    cannot project onto the declared schema raises the typed
    ``SchemaProjectionError`` (counted in
    ``pipeline/feeder_errors_total``) instead of silently ending the
    stream; malformed JSON lines are still dropped-and-counted
    (``pipeline/codec_errors_total``) as before.
    """

    def __init__(self, host: str, port: int, max_count: int = 0,
                 schema: Optional[RowSchema] = None, timeout: float = 30.0,
                 idle_timeout: float = 300.0):
        self._host = host
        self._port = port
        self._max = max_count
        self._timeout = timeout
        self._idle_timeout = idle_timeout
        self._faults = faultinject.plan()
        self.schema = schema or ARTICLE_INPUT_SCHEMA

    def rows(self) -> Iterator[Row]:
        n = 0
        if self._faults.fire("io.connect"):
            raise ConnectionRefusedError(
                f"injected io.connect fault for {self._host}:{self._port}")
        with socket_lib.create_connection((self._host, self._port),
                                          timeout=self._timeout) as sock:
            # `timeout` governed CONNECT; from here the idle window
            # bounds every read — a silent peer surfaces as a typed
            # error instead of parking the source forever
            sock.settimeout(self._idle_timeout or None)
            f = sock.makefile("r", encoding="utf-8")
            while True:
                if self._faults.fire("io.read"):
                    raise ConnectionResetError(
                        f"injected io.read fault after {n} row(s)")
                try:
                    line = f.readline()
                except TimeoutError as e:  # socket.timeout alias (py3.10+)
                    raise StreamIdleError(
                        f"no data from {self._host}:{self._port} in "
                        f"{self._idle_timeout:.0f}s (dead peer?)") from e
                if not line:  # EOF: peer closed cleanly
                    return
                line = line.strip()
                if not line:
                    continue
                try:
                    row = Message.from_json(line).to_row()
                except (ValueError, TypeError):
                    # a malformed line must not kill a long-lived stream;
                    # counted so a lossy producer is visible
                    obs.counter("pipeline/codec_errors_total").inc()
                    log.warning("dropping malformed socket line: %.80r", line)
                    continue
                except AttributeError as e:
                    # valid JSON but not an object-shaped message (a
                    # bare list/number): the row can never project onto
                    # the schema — a contract violation, not line noise.
                    # Surface it typed instead of the old silent stop.
                    obs.counter("pipeline/feeder_errors_total").inc()
                    raise SchemaProjectionError(
                        f"socket payload is not a message object and "
                        f"cannot project onto {self.schema!r}: "
                        f"{line[:80]!r}") from e
                if len(row) != len(self.schema):
                    obs.counter("pipeline/feeder_errors_total").inc()
                    raise SchemaProjectionError(
                        f"socket row has {len(row)} column(s) but the "
                        f"declared schema is {self.schema!r}")
                _count_source_row()
                yield row
                n += 1
                if self._max and n >= self._max:
                    return


class IteratorSource(Source):
    """Wrap any row iterator/callable (streaming-bridge hook)."""

    def __init__(self, it: Callable[[], Iterator[Row]],
                 schema: Optional[RowSchema] = None):
        self._it = it
        self.schema = schema or ARTICLE_INPUT_SCHEMA

    def rows(self) -> Iterator[Row]:
        return self._it()


class KafkaSource(Source):
    """Kafka topic consumer (App.java:134-143). Optional dependency: raises
    a clear error at use time when kafka-python is unavailable.

    ``idle_timeout`` (seconds, 0 = wait forever — Kafka's default,
    because a quiet topic is normal) bounds how long the consumer may
    sit with no messages: an unbounded stream that idles past it raises
    ``StreamIdleError`` (same contract as SocketSource) so a dead
    broker/partition is a typed, retryable event; wrap in
    ``ResilientSource`` for reconnect-with-backoff.
    """

    def __init__(self, topic: str, bootstrap_servers: str = "localhost:9092",
                 group_id: str = "summarization", max_count: int = 0,
                 schema: Optional[RowSchema] = None,
                 idle_timeout: float = 0.0):
        self.topic = topic
        self.bootstrap_servers = bootstrap_servers
        self.group_id = group_id
        self._max = max_count
        self._idle_timeout = idle_timeout
        self._faults = faultinject.plan()
        self.schema = schema or ARTICLE_INPUT_SCHEMA

    def rows(self) -> Iterator[Row]:
        try:
            from kafka import KafkaConsumer  # type: ignore
        except ImportError as e:  # pragma: no cover - env without kafka
            raise RuntimeError(
                "KafkaSource needs the kafka-python package; use "
                "CollectionSource/SocketSource or install kafka-python") from e
        if self._faults.fire("io.connect"):
            raise ConnectionRefusedError(
                f"injected io.connect fault for {self.bootstrap_servers}")
        kwargs = {}
        if self._idle_timeout:
            # kafka-python ends iteration (no exception) on this timeout;
            # the tail check below turns that into the typed idle error
            kwargs["consumer_timeout_ms"] = int(self._idle_timeout * 1000)
        consumer = KafkaConsumer(
            self.topic, bootstrap_servers=self.bootstrap_servers,
            group_id=self.group_id, value_deserializer=lambda b: b, **kwargs)
        n = 0
        try:
            for msg in consumer:  # pragma: no cover - needs a broker
                if self._faults.fire("io.read"):
                    raise ConnectionResetError(
                        f"injected io.read fault after {n} row(s)")
                try:
                    row = Message.from_json(
                        msg.value.decode("utf-8")).to_row()
                except (ValueError, TypeError):
                    obs.counter("pipeline/codec_errors_total").inc()
                    log.warning("dropping malformed kafka message")
                    continue
                _count_source_row()
                yield row
                n += 1
                if self._max and n >= self._max:
                    return
            if self._idle_timeout and not (self._max and n >= self._max):
                # iteration ended on consumer_timeout_ms, not on the
                # bound: the stream went idle
                raise StreamIdleError(
                    f"no kafka messages on {self.topic!r} in "
                    f"{self._idle_timeout:.0f}s (dead broker/partition?)")
        finally:
            # an abandoned consumer stays in its group until the broker
            # times it out; leave the group on every exit path
            consumer.close()


class ResilientSource(Source):
    """Reconnect-with-backoff + exactly-once wrapper for any source.

    ``factory`` builds a fresh inner source per (re)connection attempt
    (construction must be cheap and side-effect free, which holds for
    every source here: sockets/consumers open inside ``rows()``).  On a
    connection-class failure — ``OSError`` (covers ConnectionError and
    socket errors), ``StreamIdleError``, or (when kafka-python is
    installed) ``KafkaError``, which subclasses RuntimeError rather than
    OSError — the stream reconnects with decorrelated-jitter backoff up
    to ``max_reconnects`` times, then surfaces ``RetriesExhaustedError``
    with the last cause chained.

    Exactly-once: a reconnected peer typically replays from its own
    notion of the start (a socket server re-streams; a Kafka consumer
    re-polls uncommitted offsets), so rows are deduped by their first
    column (the Message uuid) before reaching the consumer; replayed
    duplicates are counted in ``resilience/io_dup_rows_total``, and
    reconnects in ``resilience/io_reconnects_total``.  Pass
    ``dedup=False`` for schemas whose first column is not a unique key.
    The dedup memory is BOUNDED: only the ``dedup_window``
    least-recently-SEEN keys are held (LRU — a replayed key refreshes
    its recency, so a peer that replays the same prefix on every
    reconnect cannot age the live keys out; default 65536, evictions
    counted in ``pipeline/dedup_evictions_total``).  The window only
    needs to cover replay depth since the last reconnect, and an
    unbounded set would leak on exactly the long-running streams this
    wrapper is for; ``dedup_window=0`` keeps every key (short bounded
    streams).

    ``seed``/``sleep`` pin the backoff for deterministic chaos tests.
    """

    def __init__(self, factory: Callable[[], Source],
                 max_reconnects: int = 8, base_delay: float = 0.05,
                 max_delay: float = 5.0, seed: Optional[int] = None,
                 dedup: bool = True, dedup_window: int = 65536,
                 schema: Optional[RowSchema] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self._factory = factory
        self._max_reconnects = max_reconnects
        self._base_delay = base_delay
        self._max_delay = max_delay
        self._seed = seed
        self._dedup = dedup
        self._dedup_window = dedup_window
        self._sleep = sleep
        self._c_reconnects = obs.counter("resilience/io_reconnects_total")
        self._c_dups = obs.counter("resilience/io_dup_rows_total")
        self._c_dedup_evicted = obs.counter("pipeline/dedup_evictions_total")
        self.schema = schema or factory().schema

    def rows(self) -> Iterator[Row]:
        policy = RetryPolicy(
            max_attempts=self._max_reconnects + 1,
            base_delay=self._base_delay, max_delay=self._max_delay,
            seed=self._seed, name="io.source", sleep=self._sleep)
        seen: "collections.OrderedDict[Any, None]" = collections.OrderedDict()
        while True:
            src = self._factory()
            try:
                for row in src.rows():
                    if self._dedup:
                        key = row[0] if row else None
                        if key in seen:
                            # LRU refresh: a replayed key is evidence it
                            # is still live replay depth — keep it young
                            seen.move_to_end(key)
                            self._c_dups.inc()
                            continue
                        seen[key] = None
                        if self._dedup_window and len(seen) > self._dedup_window:
                            seen.popitem(last=False)  # oldest-seen out
                            self._c_dedup_evicted.inc()
                    yield row
                return  # clean end of stream
            except _RECONNECT_ERRORS as e:
                policy.note_failure(e)  # raises when the budget is spent
                self._c_reconnects.inc()
                delay = policy.next_delay()
                log.warning("stream source failed (%s); reconnecting in "
                            "%.2fs", e, delay)
                self._sleep(delay)


# --------------------------------------------------------------------------
# Sinks (each flushes per record; the reference's bridge held results back)
# --------------------------------------------------------------------------

class Sink:
    def write(self, row: Row) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CollectionSink(Sink):
    def __init__(self) -> None:
        self.rows: List[Row] = []
        self._lock = threading.Lock()

    def write(self, row: Row) -> None:
        with self._lock:
            self.rows.append(row)
        _count_sink_row()


class PrintSink(Sink):
    """print().setParallelism(1) parity (App.java:100,121,129)."""

    def write(self, row: Row) -> None:
        print(row, flush=True)
        _count_sink_row()


class SocketSink(Sink):
    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket_lib.create_connection((host, port), timeout=timeout)

    def write(self, row: Row) -> None:
        data = (Message.from_row(row).to_json() + "\n").encode("utf-8")
        self._sock.sendall(data)  # immediate flush
        _count_sink_row()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class KafkaSink(Sink):
    """Kafka topic producer (App.java:145-152); optional dependency."""

    def __init__(self, topic: str, bootstrap_servers: str = "localhost:9092"):
        self.topic = topic
        self.bootstrap_servers = bootstrap_servers
        self._producer = None

    def _ensure(self):
        if self._producer is None:
            try:
                from kafka import KafkaProducer  # type: ignore
            except ImportError as e:  # pragma: no cover
                raise RuntimeError(
                    "KafkaSink needs the kafka-python package") from e
            self._producer = KafkaProducer(
                bootstrap_servers=self.bootstrap_servers)
        return self._producer

    def write(self, row: Row) -> None:  # pragma: no cover - needs a broker
        p = self._ensure()
        p.send(self.topic, Message.from_row(row).to_json().encode("utf-8"))
        p.flush()  # immediate flush
        _count_sink_row()

    def close(self) -> None:  # pragma: no cover
        if self._producer is not None:
            self._producer.close()


class QueueSink(Sink):
    """Push rows into a thread-safe queue (bridge glue)."""

    def __init__(self, q: Optional["queue.Queue[Row]"] = None):
        self.queue: "queue.Queue[Row]" = q if q is not None else queue.Queue()

    def write(self, row: Row) -> None:
        self.queue.put(row)
        _count_sink_row()


class BreakerSink(Sink):
    """Circuit-breaker wrapper: a failing sink SHEDS rows instead of
    blocking (or repeatedly stalling) the whole pipeline job.

    Semantics (RESILIENCE.md "graceful degradation"): while the breaker
    is closed, writes flow and failures are counted against it; after
    ``threshold`` consecutive failures it opens and rows are dropped
    immediately (``resilience/sink_shed_total``) for ``reset_secs``,
    then a half-open probe write decides recovery.  Shedding loses data
    BY DESIGN — a streaming job that blocks on a dead broker loses all
    of it — and every loss is counted (``resilience/sink_errors_total``,
    ``resilience/sink_shed_total``).  ``raise_on_error=True`` restores
    fail-stop for pipelines that prefer crashing to shedding.

    Injection point ``io.write`` fires inside the protected write.
    """

    def __init__(self, inner: Sink, breaker: Optional[CircuitBreaker] = None,
                 raise_on_error: bool = False):
        self._inner = inner
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            threshold=5, reset_secs=30.0, name="io.sink")
        self._raise = raise_on_error
        self._faults = faultinject.plan()
        self._c_shed = obs.counter("resilience/sink_shed_total")
        self._c_errors = obs.counter("resilience/sink_errors_total")

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def write(self, row: Row) -> None:
        if not self._breaker.allow():
            self._c_shed.inc()
            return
        try:
            if self._faults.fire("io.write"):
                raise ConnectionResetError("injected io.write fault")
            self._inner.write(row)
        except (OSError, RuntimeError) as e:
            self._breaker.record_failure()
            self._c_errors.inc()
            self._c_shed.inc()
            log.warning("sink write failed (%s); row shed "
                        "(breaker %s)", e, self._breaker.state)
            if self._raise:
                raise
        else:
            self._breaker.record_success()

    def close(self) -> None:
        self._inner.close()

