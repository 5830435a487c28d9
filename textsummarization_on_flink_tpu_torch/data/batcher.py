"""Synchronous batcher: batches in source order, on the calling thread.

The JAX package's data/batcher.py runs producer threads, length
bucketing, batch shuffling and a restart watcher (after the reference's
batcher.py:222-379), and shuffles the chunk files of each pass
(chunks.py:114-123).  The port's ``next_batch()`` reads the next
``batch_size`` examples from the source on the calling thread, in file
order, and packs them into one static-shape Batch; the threads, file
shuffling, bucketing over many batches and batch shuffling are
ROADMAP.md queue 1, item 3.  What the port keeps of the JAX batcher's
row order and latency:

  * decode mode (a batch holds distinct articles: the beam search keeps
    its own beam axis): one pass; once a batch's first article has
    arrived, each further one is waited for ``TRICKLE_WAIT_S`` at most,
    then a partial batch ships (JAX data/batcher.py:329-345), so a
    streamed article does not wait for ``batch_size - 1`` neighbours.  A
    source says "nothing yet" by yielding ``IDLE`` (the pipeline's queue
    reader does, pipeline/estimator.py); a source that never does
    fills every batch but the last;
  * train and eval modes: one pass with ``single_pass``, else the file
    list is read again and again, forever.  With ``single_pass`` each
    batch's rows are sorted by encoder length (stable), as the JAX
    batcher's bucketing does over a window of one batch
    (data/batcher.py:298-321).  Train batches carry the teacher-forcing
    arrays (``dec_batch``, ``target_batch``, ``dec_padding_mask``) that
    Batch always builds.

In one pass a short tail batch is padded with repeats of its last
example tagged ``real_mask=False``, and ``next_batch()`` returns None
once the source is spent.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data import chunks
from textsummarization_on_flink_tpu_torch.data import oov as oov_lib
from textsummarization_on_flink_tpu_torch.data.batching import (
    Batch,
    SummaryExample,
)
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab


class _Idle:
    def __repr__(self) -> str:
        return "IDLE"


#: yielded by an example source when nothing arrived within its poll
#: interval; the batcher skips it but for the decode-mode top-up
IDLE = _Idle()

#: seconds a decode batch waits for each article after its first (the
#: JAX batcher's ``_get_example(timeout=0.2)``)
TRICKLE_WAIT_S = 0.2


class Batcher:
    def __init__(self, data_path: str, vocab: Vocab, hps: HParams,
                 example_source: Optional[
                     Callable[[], Iterator[Tuple[str, ...]]]] = None,
                 single_pass: Optional[bool] = None):
        """
        Args:
          data_path: chunk-file glob (ignored when example_source given).
          example_source: optional zero-arg callable returning an iterator
            of (article, abstract) pairs or (uuid, article, abstract,
            reference) 4-tuples with passthrough columns, and ``IDLE``
            when nothing has arrived yet.
          single_pass: one pass over the files or forever; None means one
            pass in decode mode and ``hps.single_pass`` otherwise.
        """
        if single_pass is None:
            single_pass = hps.mode == "decode" or hps.single_pass
        self._vocab = vocab
        self._hps = hps
        self._single_pass = single_pass
        self._items = (example_source() if example_source is not None
                       else chunks.text_pairs(data_path, single_pass))

    def _next_example(self, wait: Optional[float] = None):
        """The next example; None once the source is spent; ``IDLE`` when
        ``wait`` seconds passed with nothing but ``IDLE`` from the source
        (None: wait as long as it takes)."""
        t0 = time.monotonic()
        while True:
            item = next(self._items, None)
            if item is None:
                return None
            if item is not IDLE:
                break
            if wait is not None and time.monotonic() - t0 >= wait:
                return IDLE
        if len(item) == 4:
            uuid, article, abstract, reference = item
        else:
            article, abstract = item
            uuid, reference = "", ""
        sents = [s.strip() for s in oov_lib.abstract2sents(abstract)]
        return SummaryExample.build(article, sents, self._vocab, self._hps,
                                    uuid=uuid, reference=reference)

    def _examples(self) -> List[SummaryExample]:
        """Up to batch_size examples for the next batch."""
        exs: List[SummaryExample] = []
        decode = self._hps.mode == "decode"
        while len(exs) < self._hps.batch_size:
            # decode: the first article is waited for, the rest for
            # TRICKLE_WAIT_S each
            ex = self._next_example(TRICKLE_WAIT_S if decode and exs
                                    else None)
            if ex is None or ex is IDLE:
                break
            exs.append(ex)
        return exs

    def next_batch(self) -> Optional[Batch]:
        """The next Batch of distinct examples, or None when the source is
        exhausted."""
        exs = self._examples()
        if not exs:
            return None
        pad = self._hps.batch_size - len(exs)
        rows = [(ex, True) for ex in exs] + [(exs[-1], False)] * pad
        if self._hps.mode != "decode" and self._single_pass:
            rows.sort(key=lambda r: r[0].enc_len)  # stable
        return Batch([r[0] for r in rows], self._hps, self._vocab,
                     real_mask=[r[1] for r in rows])
