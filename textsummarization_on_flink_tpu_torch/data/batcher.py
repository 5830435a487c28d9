"""Synchronous batcher: batches in file order, on the calling thread.

The JAX package's data/batcher.py runs producer threads, length
bucketing, batch shuffling and a restart watcher (after the reference's
batcher.py:222-379), and shuffles the chunk files of each pass
(chunks.py:114-123).  The port's ``next_batch()`` reads the next
``batch_size`` examples from the source on the calling thread, in file
order, and packs them into one static-shape Batch; the threads, file
shuffling, bucketing and batch shuffling are ROADMAP.md queue 1, item 3.

  * decode mode (``decode_batch_mode="distinct"``: the beam search keeps
    its own beam axis, so a batch holds distinct articles): one pass;
  * train and eval modes: one pass with ``single_pass``, else the file
    list is read again and again, forever.  Train batches carry the
    teacher-forcing arrays (``dec_batch``, ``target_batch``,
    ``dec_padding_mask``) that Batch always builds.

In one pass a short tail batch is padded with repeats of its last
example tagged ``real_mask=False``, and ``next_batch()`` returns None
once the source is spent.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data import chunks
from textsummarization_on_flink_tpu_torch.data import oov as oov_lib
from textsummarization_on_flink_tpu_torch.data.batching import (
    Batch,
    SummaryExample,
)
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab


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
            reference) 4-tuples with passthrough columns.
          single_pass: one pass over the files or forever; None means one
            pass in decode mode and ``hps.single_pass`` otherwise.
        """
        if single_pass is None:
            single_pass = hps.mode == "decode" or hps.single_pass
        self._vocab = vocab
        self._hps = hps
        self._items = (example_source() if example_source is not None
                       else chunks.text_pairs(data_path, single_pass))

    def _next_example(self) -> Optional[SummaryExample]:
        item = next(self._items, None)
        if item is None:
            return None
        if len(item) == 4:
            uuid, article, abstract, reference = item
        else:
            article, abstract = item
            uuid, reference = "", ""
        sents = [s.strip() for s in oov_lib.abstract2sents(abstract)]
        return SummaryExample.build(article, sents, self._vocab, self._hps,
                                    uuid=uuid, reference=reference)

    def next_batch(self) -> Optional[Batch]:
        """The next Batch of distinct examples, or None when the source is
        exhausted."""
        exs = []
        while len(exs) < self._hps.batch_size:
            ex = self._next_example()
            if ex is None:
                break
            exs.append(ex)
        if not exs:
            return None
        n_real = len(exs)
        exs.extend([exs[-1]] * (self._hps.batch_size - n_real))
        mask = [i < n_real for i in range(self._hps.batch_size)]
        return Batch(exs, self._hps, self._vocab, real_mask=mask)
