"""Threaded, bucketing batcher (a copy of the JAX package's
data/batcher.py, after the reference's batcher.py:222-379).

Producer-consumer queues: 16 example threads and 4 batch threads when
streaming, 1 + 1 in single_pass.  Example threads read the source (chunk
files, whose list is shuffled every pass, through ``chunks.text_pairs``, which skips empty articles,
or an ``example_source``) and build SummaryExamples; batch threads bucket them:

  * train and eval modes: ``batch_size * 100`` examples (one batch's
    worth in single_pass) are sorted by encoder length and cut into
    batches, which are shuffled unless single_pass (JAX :293-321); a
    single_pass tail batch is padded with repeats of its last example
    tagged ``real_mask=False``;
  * decode mode ``repeat`` (the reference's: one article repeated across
    the batch, only the first row real) or ``distinct`` (the port's
    default: the beam search keeps its own beam axis, so a batch holds
    distinct articles; once a batch's first article has arrived each
    further one is waited for ``TRICKLE_WAIT_S`` at most, then a partial
    batch ships padded with ``real_mask=False`` repeats, JAX :322-347).

A crashed producer restarts in place against a restart budget shared by
all of them (``max_worker_restarts``); once the budget is spent the
first error surfaces from ``next_batch()`` as ``WorkerCrashError``.
The JAX batcher's watcher thread is not copied: a streaming producer
ends only through that terminal error, after which the watcher stops
anyway, so it never had a dead thread to restart.  The
``etl.worker`` fault point (resilience/faultinject.py) fires in the
example loop.  ``next_batch()`` polls, so it raises a producer's error
and sees the end of a single pass.

The port's pipeline contract: a source may yield ``IDLE`` when nothing
arrived within its poll interval (pipeline/estimator.py's queue reader
does); the example threads skip it.  Counters and the gauge of obs/:
``resilience/etl_worker_restarts_total``, ``data/examples_total``,
``data/empty_articles_total``, ``data/batches_total``,
``data/oov_words_total``, ``data/enc_tokens_total``,
``data/batch_queue_depth``.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from typing import Callable, Iterator, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data import chunks
from textsummarization_on_flink_tpu_torch.data import oov as oov_lib
from textsummarization_on_flink_tpu_torch.data.batching import (
    Batch,
    SummaryExample,
)
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.resilience import faultinject
from textsummarization_on_flink_tpu_torch.resilience.errors import (
    WorkerCrashError,
)

log = logging.getLogger(__name__)


class _Idle:
    def __repr__(self) -> str:
        return "IDLE"


#: yielded by an example source when nothing arrived within its poll
#: interval; the example threads skip it
IDLE = _Idle()

#: seconds a distinct decode batch waits for each article after its first
#: (the JAX batcher's ``_get_example(timeout=0.2)``)
TRICKLE_WAIT_S = 0.2


class Batcher:
    BATCH_QUEUE_MAX = 100

    def __init__(self, data_path: str, vocab: Vocab, hps: HParams,
                 single_pass: Optional[bool] = None,
                 decode_batch_mode: str = "distinct",
                 example_source: Optional[
                     Callable[[], Iterator[Tuple[str, ...]]]] = None,
                 max_worker_restarts: int = 3):
        """
        Args:
          data_path: chunk-file glob (ignored when example_source given).
          single_pass: one pass over the source, or stream forever; None
            means one pass in decode mode and ``hps.single_pass``
            otherwise.
          decode_batch_mode: 'distinct' packs distinct articles (the
            port's default); 'repeat' mirrors the reference (one example
            repeated across the batch).
          example_source: optional zero-arg callable returning an iterator
            of (article, abstract) pairs or (uuid, article, abstract,
            reference) 4-tuples with passthrough columns, and ``IDLE``
            when nothing has arrived yet.
          max_worker_restarts: total crash-restart budget shared by all
            producer threads; spent, the first error surfaces from
            next_batch() as WorkerCrashError.  0 fails fast.
        """
        if single_pass is None:
            single_pass = hps.mode == "decode" or hps.single_pass
        if decode_batch_mode not in ("repeat", "distinct"):
            raise ValueError(f"decode_batch_mode must be 'repeat' or "
                             f"'distinct', got {decode_batch_mode!r}")
        self._data_path = data_path
        self._vocab = vocab
        self._hps = hps
        self._single_pass = single_pass
        self._decode_batch_mode = decode_batch_mode
        self._example_source = example_source
        self._faults = faultinject.plan_for(hps)
        self._restarts_left = max(int(max_worker_restarts), 0)
        self._restart_lock = threading.Lock()
        self._batch_queue: "queue.Queue[Batch]" = queue.Queue(
            self.BATCH_QUEUE_MAX)
        self._example_queue: "queue.Queue[SummaryExample]" = queue.Queue(
            self.BATCH_QUEUE_MAX * hps.batch_size)
        self._finished_reading = False
        if single_pass:
            n_example, n_batch, self._bucketing_cache_size = 1, 1, 1
        else:
            n_example, n_batch, self._bucketing_cache_size = 16, 4, 100
        # the first terminal producer failure, re-raised by next_batch()
        self._fill_error: Optional[BaseException] = None
        self._fill_error_lock = threading.Lock()

        reg = obs.registry_for(hps)
        self._c_restarts = reg.counter("resilience/etl_worker_restarts_total")
        self._c_examples = reg.counter("data/examples_total")
        self._c_empty = reg.counter("data/empty_articles_total")
        self._c_batches = reg.counter("data/batches_total")
        self._c_oov_words = reg.counter("data/oov_words_total")
        self._c_enc_tokens = reg.counter("data/enc_tokens_total")
        self._g_fill = reg.gauge("data/batch_queue_depth")

        self._example_q_threads = [self._start(self._fill_example_queue)
                                   for _ in range(n_example)]
        self._batch_q_threads = [self._start(self._fill_batch_queue)
                                 for _ in range(n_batch)]

    def _start(self, fn: Callable[[], None]) -> threading.Thread:
        t = threading.Thread(target=self._run_producer, args=(fn,),
                             daemon=True)
        t.start()
        return t

    # -- consumer API --
    def queued_batches(self) -> int:
        """Approximate count of ready batches in the output queue."""
        return self._batch_queue.qsize()

    def raise_if_failed(self) -> None:
        """Re-raise the first terminal producer failure (the restart
        budget spent) as WorkerCrashError, its cause chained."""
        err = self._fill_error
        if err is not None:
            raise WorkerCrashError(
                "batcher producer thread failed; see chained cause "
                "(worker restart budget spent)") from err

    def next_batch(self) -> Optional[Batch]:
        """The next Batch, or None when a single_pass source is spent.
        Polls, so an end of stream that comes while it waits is seen, and
        a producer's failure raises here instead of blocking forever."""
        warned = False
        while True:
            try:
                batch = self._batch_queue.get(timeout=0.2)
                self._g_fill.set(self._batch_queue.qsize())
                return batch
            except queue.Empty:
                self.raise_if_failed()
                if not warned:
                    log.warning(
                        "Bucket input queue is empty when calling "
                        "next_batch. Bucket queue size: %i, Input queue "
                        "size: %i", self._batch_queue.qsize(),
                        self._example_queue.qsize())
                    warned = True
                if (self._single_pass and self._finished_reading
                        and not any(t.is_alive()
                                    for t in self._batch_q_threads)
                        and self._batch_queue.qsize() == 0):
                    log.info("Finished reading dataset in single_pass mode.")
                    return None

    # -- producers --
    def _consume_restart(self) -> bool:
        """Take one unit of the shared restart budget, if any is left."""
        with self._restart_lock:
            if self._restarts_left <= 0:
                return False
            self._restarts_left -= 1
            return True

    def _run_producer(self, fn: Callable[[], None]) -> None:
        """Thread body: run ``fn``; after a crash, run it again from
        scratch (re-opening its source) while the shared budget lasts,
        then record the failure for the consumer."""
        while True:
            try:
                fn()
                return  # clean exit (single_pass exhaustion)
            except BaseException as e:  # noqa: BLE001 (recorded, re-raised)
                # after a terminal failure a crash is its fallout (a batch
                # thread seeing the dead example queue): no budget for it
                if self._fill_error is None and self._consume_restart():
                    self._c_restarts.inc()
                    log.warning("batcher producer crashed (%r); restarting "
                                "in place (%d restart(s) left)", e,
                                self._restarts_left)
                    continue
                with self._fill_error_lock:
                    if self._fill_error is None:
                        self._fill_error = e
                log.error("batcher producer thread failed: %r", e)
                return

    def _text_pairs(self) -> Iterator[Tuple[str, ...]]:
        """(article, abstract) pairs, or the source's 4-tuples and IDLE."""
        if self._example_source is not None:
            yield from self._example_source()
            return
        yield from chunks.text_pairs(self._data_path, self._single_pass,
                                     on_empty=self._skip_empty)

    def _skip_empty(self) -> None:
        self._c_empty.inc()
        log.warning("Found an example with empty article text. Skipping it.")

    def _fill_example_queue(self) -> None:
        gen = self._text_pairs()
        while True:
            if self._faults.fire("etl.worker"):
                # an unhandled error mid-loop, through the restart path a
                # real one takes
                raise RuntimeError("injected etl.worker fault")
            try:
                item = next(gen)
            except StopIteration:
                log.info("example generator exhausted data.")
                if self._single_pass:
                    self._finished_reading = True
                    return
                raise RuntimeError(
                    "single_pass mode is off but the example generator is "
                    "out of data; error.")
            if item is IDLE:
                continue
            if len(item) == 4:
                uuid, article, abstract, reference = item
            else:
                article, abstract = item
                uuid, reference = "", ""
            sents = [s.strip() for s in oov_lib.abstract2sents(abstract)]
            ex = SummaryExample.build(article, sents, self._vocab, self._hps,
                                      uuid=uuid, reference=reference)
            self._c_examples.inc()
            self._c_enc_tokens.inc(ex.enc_len)
            self._c_oov_words.inc(len(ex.article_oovs))
            self._example_queue.put(ex)

    def _get_example(self, timeout: Optional[float] = None,
                     ) -> Optional[SummaryExample]:
        """The next example; None once a single pass has been read, or
        after ``timeout`` seconds of measured time (None: no limit)."""
        deadline = (None if timeout is None
                    else time.monotonic() + max(timeout, 0.0))
        while True:
            poll = 0.2
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                poll = min(poll, remaining)
            try:
                return self._example_queue.get(timeout=poll)
            except queue.Empty:
                if self._fill_error is not None:
                    raise RuntimeError("example producer thread failed")
                if self._single_pass and self._finished_reading:
                    return None

    def _put_batch(self, rows: List[Tuple[SummaryExample, bool]]) -> None:
        self._batch_queue.put(Batch([r[0] for r in rows], self._hps,
                                    self._vocab,
                                    real_mask=[r[1] for r in rows]))
        self._c_batches.inc()
        self._g_fill.set(self._batch_queue.qsize())

    def _fill_batch_queue(self) -> None:
        hps = self._hps
        size = hps.batch_size
        while True:
            if hps.mode != "decode":
                inputs = []
                for _ in range(size * self._bucketing_cache_size):
                    ex = self._get_example()
                    if ex is None:
                        break
                    inputs.append(ex)
                if not inputs:
                    return  # single_pass exhausted
                rows = [(ex, True) for ex in inputs]
                if self._single_pass and len(rows) % size:
                    # the tail batch, padded with repeats tagged not real
                    rows.extend([(rows[-1][0], False)]
                                * (size - len(rows) % size))
                rows.sort(key=lambda r: r[0].enc_len)  # length bucketing
                batches = [rows[i:i + size] for i in range(0, len(rows),
                                                           size)]
                if not self._single_pass:
                    random.shuffle(batches)
                for b in batches:
                    self._put_batch(b)
            elif self._decode_batch_mode == "repeat":
                ex = self._get_example()
                if ex is None:
                    return
                self._put_batch([(ex, True)] + [(ex, False)] * (size - 1))
            else:  # distinct: a batch of different articles
                first = self._get_example()  # wait for the first article
                if first is None:
                    return
                exs = [first]
                # top up briefly, then ship a partial batch: a streamed
                # article must not wait for batch_size - 1 neighbours
                while len(exs) < size:
                    ex = self._get_example(timeout=TRICKLE_WAIT_S)
                    if ex is None:
                        break
                    exs.append(ex)
                rows = [(ex, True) for ex in exs]
                self._put_batch(rows + [(exs[-1], False)]
                                * (size - len(rows)))
