"""Deprecated raw driver (me/littlebo/Summarization.java parity).

The port's counterpart of the JAX package's pipeline/raw_driver.py.  The
reference keeps an @Deprecated entry point that calls TFUtils.train and
TFUtils.inference directly with a hand-built TFConfig, bypassing the
Estimator/Model param system (Summarization.java:28,79-155).  Here:
``training()`` and ``inference()`` wire a source to the trainer or the
decoder with explicit HParams.  Training starts from fresh params
(``hps.seed``), as the JAX package's does.  Prefer pipeline.estimator
and pipeline.app.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data.batcher import Batcher
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode.decoder import (
    BeamSearchDecoder,
)
from textsummarization_on_flink_tpu_torch.pipeline.estimator import (
    rows_to_examples,
    train_dir_for,
)
from textsummarization_on_flink_tpu_torch.pipeline.io import (
    CollectionSink,
    Sink,
    Source,
)
from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib


def _deprecated() -> None:
    warnings.warn(
        "pipeline.raw_driver mirrors the reference's @Deprecated "
        "Summarization entry point; use pipeline.estimator / pipeline.app",
        DeprecationWarning, stacklevel=3)


def _example_source(source: Source):
    def example_source():
        # 3-column (uuid, article, reference) or 4-column rows with the
        # summary in between: the reference is always the last column
        return rows_to_examples((r[0], r[1], r[-1]) for r in source.rows())

    return example_source


def training(hps: HParams, source: Source,
             vocab: Optional[Vocab] = None) -> trainer_lib.TrainState:
    """Summarization.training() parity (:79-118): train directly from a
    row stream, no param system."""
    _deprecated()
    vocab = vocab or Vocab(hps.vocab_path, hps.vocab_size)
    batcher = Batcher("", vocab, hps.replace(mode="train"), single_pass=True,
                      example_source=_example_source(source))
    train_dir = train_dir_for(hps)
    trainer = trainer_lib.Trainer(hps, vocab.size(), batcher,
                                  checkpointer=ckpt_lib.Checkpointer(
                                      train_dir, hps=hps),
                                  train_dir=train_dir)
    return trainer.train(num_steps=hps.num_steps)


def inference(hps: HParams, source: Source, sink: Optional[Sink] = None,
              vocab: Optional[Vocab] = None) -> Sink:
    """Summarization.inference() parity (:120-155)."""
    _deprecated()
    vocab = vocab or Vocab(hps.vocab_path, hps.vocab_size)
    out = sink if sink is not None else CollectionSink()
    dec_hps = hps.replace(mode="decode", single_pass=False)
    batcher = Batcher("", vocab, dec_hps, single_pass=True,
                      example_source=_example_source(source))
    decoder = BeamSearchDecoder(dec_hps, vocab, batcher,
                                train_dir=train_dir_for(hps),
                                decode_root=os.path.join(
                                    hps.log_root or ".",
                                    hps.exp_name or "exp"))
    decoder.decode(result_sink=lambda r: out.write(r.as_row()),
                   log_results=False)
    return out
