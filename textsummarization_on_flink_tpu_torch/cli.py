"""Command-line entry of the port: the reference's run_summarization.py
surface.

    python -m textsummarization_on_flink_tpu_torch --mode=train \
        --model_family=transformer --data_path='.../train_*.bin' \
        --vocab_path=.../vocab --log_root=/tmp/log --exp_name=myexperiment \
        --num_steps=1000

  * ``--mode=train``: restore the newest checkpoint of
    ``<log_root>/<exp_name>/train`` or start from fresh params (``--seed``),
    then train with checkpoints every 60 s (or ``--checkpoint_steps``) and
    at the end (run_summarization.py:181-244);
  * ``--mode=eval``: load the newest training checkpoint, evaluate a
    batch, update the smoothed loss and save ``bestmodel`` when it
    improves, again and again (run_summarization.py:247-292);
  * ``--mode=decode``: beam-search decode of chunk files (distinct
    articles per batch): with ``--single_pass=1`` one pass, scored with
    ROUGE into ``ROUGE_results.txt``; otherwise continuous decoding of
    the files, reshuffled every pass, reloading the newest checkpoint
    every 60 s and writing ``attn_vis_data.json``;
  * ``--inference=1``: decode raw text files, one article per file, in
    one bounded pass (RawTextBatcher path, run_summarization.py:339-348).
    The JAX package repeats one article across the batch here; the port
    packs distinct articles, which gives the same per-article results.

Both families train, evaluate and decode.  The checkpoint-surgery flags
run and exit, as the reference's do: ``--convert_to_coverage_model``
(run_summarization.py:157-178) and ``--restore_best_model`` (:132-154).
Runs on CUDA unless ``--device=cpu``; with no CUDA device and no
``--device=cpu`` it raises.

On a mesh (``--dp``, ``--tp``, ``--sp`` with a product above 1) every
mode but serving runs one process per rank under torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node=4 \
        -m textsummarization_on_flink_tpu_torch --mode=train --dp=2 --tp=2 ...

``main`` joins the world (parallel/distributed.py: NCCL when each rank
has a card of its own, gloo when ranks share one or run on the CPU) and
raises when torchrun's world is missing or of another size.  Each rank
reads ``batch_size / dp`` rows (utils.local_batch_hps); only the chief
writes checkpoints, summaries, ``vocab_metadata.tsv`` and decode files.

``python -m textsummarization_on_flink_tpu_torch.cli serve-replica`` is
a process-fleet child (serve/procfleet.py): it reads its HParams from
``TS_HPS_JSON`` and serves until SIGTERM.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional

from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data.batcher import Batcher
from textsummarization_on_flink_tpu_torch.data.etl import (
    raw_text_example_source,
)
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode.decoder import (
    BeamSearchDecoder,
)
from textsummarization_on_flink_tpu_torch.device import resolve_device
from textsummarization_on_flink_tpu_torch.parallel import distributed
from textsummarization_on_flink_tpu_torch.parallel import mesh as mesh_lib
from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib
from textsummarization_on_flink_tpu_torch.utils import local_batch_hps

log = logging.getLogger(__name__)


def _dirs(hps: HParams):
    root = os.path.join(hps.log_root or ".", hps.exp_name or "exp")
    return root, os.path.join(root, "train"), os.path.join(root, "eval")


def setup_training(hps: HParams, vocab: Vocab,
                   batcher: Optional[Batcher] = None,
                   ) -> trainer_lib.TrainState:
    """run_summarization.py:181-209: restore-or-init, then train with
    periodic checkpoints (JAX cli.py:47-73).  Returns the final state."""
    _, train_dir, _ = _dirs(hps)
    device = resolve_device(hps.device)
    # on a mesh the batcher feeds this rank's dp rows
    batcher = batcher or Batcher(hps.data_path, vocab, local_batch_hps(hps),
                                 single_pass=hps.single_pass)
    # every rank holds a Checkpointer: its save is collective, then the
    # chief writes (JAX cli.py:51-66); every rank restores
    checkpointer = ckpt_lib.Checkpointer(train_dir, hps=hps)
    if distributed.is_chief():
        # embedding-projector metadata (model.py:185-197, data.py:93-105)
        vocab.write_metadata(os.path.join(train_dir, "vocab_metadata.tsv"))
    state = checkpointer.restore(device=device)
    if state is not None:
        log.info("rank %d restored training from step %d (params %s)",
                 distributed.rank(), state.step,
                 ckpt_lib.content_fingerprint(state.params))
    trainer = trainer_lib.Trainer(hps, vocab.size(), batcher, state=state,
                                  checkpointer=checkpointer,
                                  train_dir=train_dir)
    return trainer.train(num_steps=hps.num_steps)


def run_eval(hps: HParams, vocab: Vocab, max_iters: int = 0,
             batcher: Optional[Batcher] = None) -> float:
    """run_summarization.py:247-292 (JAX cli.py:76-100): each iteration
    loads the newest training checkpoint, evaluates one batch, updates
    the smoothed loss and saves ``bestmodel`` on improvement.
    max_iters=0 runs forever (the reference's behaviour); tests pass a
    bound.  Returns the running-average loss."""
    eval_hps = hps.replace(mode="eval")
    _, train_dir, eval_dir = _dirs(hps)
    device = resolve_device(hps.device)
    batcher = batcher or Batcher(hps.data_path, vocab,
                                 local_batch_hps(eval_hps),
                                 single_pass=False)
    evaluator = trainer_lib.Evaluator(
        eval_hps, batcher, eval_dir=eval_dir,
        best_saver=ckpt_lib.BestModelSaver(eval_dir))
    iters = 0
    while True:
        path, flat = ckpt_lib.load_ckpt(train_dir)
        state = ckpt_lib.arrays_to_state(flat, device)
        log.info("evaluating checkpoint %s (step %d)", path, state.step)
        evaluator.run(state.params, state.step, max_batches=1)
        iters += 1
        if max_iters and iters >= max_iters:
            return evaluator.running_avg_loss


def run_decode(hps: HParams, vocab: Vocab,
               batcher: Optional[Batcher] = None,
               max_batches: int = 0) -> BeamSearchDecoder:
    """run_summarization.py:360-365 (+ raw-text inference :339-348; JAX
    cli.py:103-131).  Raw-text inference is one bounded pass; chunk files
    are read once with ``--single_pass`` (then scored with ROUGE) or
    streamed forever otherwise (``max_batches`` bounds that, for tests).
    Returns the decoder after its loop; ``rouge_results`` holds the
    ROUGE scores of a single pass."""
    decode_hps = hps.replace(mode="decode")
    # on a mesh the chief alone reads the articles (the decoder
    # broadcasts them)
    if batcher is None and distributed.is_chief():
        if hps.inference:
            batcher = Batcher("", vocab, decode_hps, single_pass=True,
                              example_source=raw_text_example_source(
                                  hps.data_path))
        else:
            batcher = Batcher(hps.data_path, vocab, decode_hps,
                              single_pass=hps.single_pass)
    _, train_dir, _ = _dirs(hps)
    decoder = BeamSearchDecoder(decode_hps, vocab, batcher,
                                train_dir=train_dir)
    decoder.decode(with_rouge=hps.single_pass and not hps.inference,
                   max_batches=max_batches)
    return decoder


def _join_mesh(hps: HParams, ranks: int) -> None:
    """Join the world of ``ranks`` processes torchrun started (the JAX
    package's multi-host bring-up, cli.py:147-150 there)."""
    del ranks
    mesh_lib.join_world(hps)


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "serve-replica":
        # the process-fleet child (SERVING.md "Process fleet"): its
        # configuration arrives as TS_HPS_JSON and its ports leave
        # through the portfile handshake, so it dispatches before the
        # flag parse; the child builds its server on hps.device
        from textsummarization_on_flink_tpu_torch.serve import procfleet

        return procfleet.replica_child_main(argv[1:])
    hps = HParams.from_argv(argv)
    hps.validate()
    resolve_device(hps.device)  # no card and no --device=cpu: raise here
    ranks = hps.dp * hps.tp * hps.sp
    if ranks > 1:
        _join_mesh(hps, ranks)
    try:
        _run(hps)
    finally:
        if ranks > 1:
            distributed.destroy()
    return 0


def _run(hps: HParams) -> None:
    log.info("Starting summarization in %s mode on %s...", hps.mode,
             hps.device)
    # the surgery flags run and exit (run_summarization.py:341-349); on a
    # mesh the chief runs them
    _, train_dir, eval_dir = _dirs(hps)
    if hps.convert_to_coverage_model or hps.restore_best_model:
        if not distributed.is_chief():
            return
        if hps.convert_to_coverage_model:
            ckpt_lib.convert_to_coverage_model(train_dir, hps, seed=hps.seed)
        else:
            ckpt_lib.restore_best_model(eval_dir, train_dir, hps)
        return
    training = hps.mode in ("train", "eval") and not hps.inference
    vocab = Vocab(hps.vocab_path, hps.vocab_size)
    if not training:
        run_decode(hps, vocab)
    elif hps.mode == "train":
        setup_training(hps, vocab)
    else:
        run_eval(hps, vocab)


if __name__ == "__main__":
    raise SystemExit(main())
