"""Sequence-level distillation of the AAN draft.

Port of the JAX package's train/distill.py.  The narrow draft
(``draft_hidden`` < hidden_dim with a factored vocab head) has no
full-model counterpart to map from, so it is trained to imitate the
frozen full model:

  * the teacher decodes each batch once through the greedy tier
    (beam_size=1 beam search, the program the spec verifier's acceptance
    test compares against);
  * its emitted stream becomes the teacher-forced (dec_batch,
    target_batch, dec_padding_mask) triple: extended-vocab ids stay in
    the targets (the pointer loss scores copies) and feed back
    UNK-mapped as inputs;
  * the draft trains on it through the transformer's loss head with the
    trainer's step body (``trainer.train_step``: clip, Adagrad), so the
    distillation objective and the from-scratch one are one code path,
    and the trainer's watchdog (``NonFiniteLossError``) guards its
    windowed loss reads.

The draft's TrainState is saved by ``checkpoint.Checkpointer`` in its own
directory beside a ``teacher.json`` sidecar holding the teacher's
content fingerprint; a restore or ``load_distilled_draft`` against a
different teacher raises.  On the card the draft's encoder runs the
flash kernels, forward and backward, and the teacher's decode the flash
forward.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.config import (
    HParams,
    derive_draft_hps,
)
from textsummarization_on_flink_tpu_torch.data.vocab import START_ID, UNK_ID
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode import speculative
from textsummarization_on_flink_tpu_torch.device import resolve_device
from textsummarization_on_flink_tpu_torch.params import from_numpy_tree
from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib

log = logging.getLogger(__name__)

TEACHER_SIDECAR = "teacher.json"


def teacher_fingerprint(full_params: Any) -> str:
    """The frozen teacher's content fingerprint (distill.py:61-72): the
    checkpoint layer's ``content_fingerprint``, byte for byte the JAX
    package's, so a sidecar written by either package checks in both."""
    return ckpt_lib.content_fingerprint(full_params)


def teacher_arrays(full_params: Any, hps: HParams,
                   arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One batch's distillation triple (distill.py:75-104): the teacher's
    greedy decode of the articles laid out teacher-forced.  Targets keep
    extended-vocab ids; inputs are the targets shifted right behind START
    and UNK-mapped; the mask covers the emitted tokens."""
    thps = hps.replace(beam_size=1, mode="decode")
    enc = {k: v for k, v in arrays.items() if k.startswith("enc_")}
    out = beam_search.run_beam_search(full_params, thps, enc)
    B = enc["enc_batch"].shape[0]
    T = hps.max_dec_steps
    dec = np.zeros((B, T), np.int32)
    tgt = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), np.float32)
    for b in range(B):
        n = min(int(out.length[b]) - 1, T)  # generated tokens past START
        if n <= 0:
            continue
        gen = out.tokens[b, 1:1 + n].astype(np.int64)
        inputs = np.concatenate(([START_ID], gen[:n - 1]))
        dec[b, :n] = np.where(inputs >= hps.vocab_size, UNK_ID, inputs)
        tgt[b, :n] = gen
        mask[b, :n] = 1.0
    return {**enc, "dec_batch": dec, "target_batch": tgt,
            "dec_padding_mask": mask}


def acceptance_rate(full_params: Any, draft_params: Any, hps: HParams,
                    arrays: Dict[str, np.ndarray]) -> float:
    """accepted / drafted over one spec decode of the batch (distill.py:
    107-118)."""
    out = speculative.run_spec_decode(full_params, draft_params, hps, arrays)
    drafted = int(out.drafted.sum())
    return int(out.accepted.sum()) / drafted if drafted else 0.0


def load_distilled_draft(train_dir: str, full_params: Optional[Any] = None,
                         device: Any = "cpu") -> Any:
    """The draft params of the newest checkpoint of a DistillTrainer
    directory, on ``device``, its teacher sidecar checked against
    ``full_params`` when given (distill.py:121-134): what
    ``BeamSearchDecoder(draft_params=...)`` takes."""
    path, flat = ckpt_lib.load_ckpt(train_dir, max_retries=0)
    if full_params is not None:
        _check_teacher(train_dir, teacher_fingerprint(full_params), path)
    return from_numpy_tree(ckpt_lib._unflatten_dicts(flat)["params"], device)


def _check_teacher(train_dir: str, fingerprint: str, ckpt_path: str) -> None:
    sidecar = os.path.join(train_dir, TEACHER_SIDECAR)
    try:
        with open(sidecar, encoding="utf-8") as f:
            want = json.load(f)["teacher_sha"]
    except (OSError, KeyError, ValueError):
        return  # a directory without the sidecar: nothing to check
    if want != fingerprint:
        raise ValueError(
            f"distilled draft at {ckpt_path} was trained against teacher "
            f"{want}, not the full model in hand ({fingerprint}) — a "
            f"mismatched (full, draft) pair silently tanks acceptance; "
            f"re-distill or load the matching teacher checkpoint")


class DistillTrainer:
    """Distillation of the draft on one device (distill.py:150-278).

    ``hps`` is the full model's config, on ``hps.device``; the draft's
    shape derives through ``config.derive_draft_hps`` (the shape the
    decoder builds).  ``batcher`` is any ``next_batch() -> Batch | None``
    of articles (their abstracts are not read: the teacher writes the
    targets).  ``cache_teacher=True`` keeps each batch object's teacher
    triple, so later epochs over a fixed set pay the draft's step alone.
    A fresh draft is drawn from ``seed`` (``hps.seed`` when None)."""

    def __init__(self, hps: HParams, vsize: int, batcher: Any,
                 full_params: Any,
                 state: Optional[trainer_lib.TrainState] = None,
                 checkpointer: Optional[Any] = None,
                 checkpoint_secs: float = 60.0,
                 metrics_every: int = 0,
                 cache_teacher: bool = False,
                 seed: Optional[int] = None):
        self.hps = hps
        self.dhps = derive_draft_hps(hps).replace(mode="train")
        self._device = resolve_device(hps.device)
        self.batcher = batcher
        self.full_params = from_numpy_tree(full_params, self._device)
        self.checkpointer = checkpointer
        self.checkpoint_secs = checkpoint_secs
        self.metrics_every = metrics_every or hps.metrics_every or 10
        self._teacher_sha = teacher_fingerprint(self.full_params)
        restored = None
        if state is None and checkpointer is not None:
            restored = checkpointer.restore(device=self._device)
            if restored is not None:
                _check_teacher(checkpointer.directory, self._teacher_sha,
                               "restored checkpoint")
                restored = trainer_lib.cast_opt_state(self.dhps, restored)
        if state is not None:
            self.state = state
        elif restored is not None:
            self.state = restored
        else:
            self.state = trainer_lib.init_train_state(
                self.dhps.replace(seed=hps.seed if seed is None else seed),
                vsize, device=self._device)
        self._loss_fn = trainer_lib.make_loss_fn(self.dhps)
        self._cache: Optional[Dict[int, Any]] = {} if cache_teacher else None
        self._obs = obs.registry_for(hps)
        self._c_steps = self._obs.counter("train/distill_steps_total")
        self._g_loss = self._obs.gauge("train/distill_loss")
        self._m_teacher = self._obs.histogram(
            "train/distill_teacher_seconds")

    def draft_params(self) -> Any:
        return self.state.params

    def _teacher_arrays(self, batch: Any) -> Dict[str, np.ndarray]:
        if self._cache is not None and id(batch) in self._cache:
            # (batch, arrays): the batch held alive keeps its id unique
            return self._cache[id(batch)][1]
        t0 = time.monotonic()
        arrays = teacher_arrays(self.full_params, self.hps,
                                batch.as_arrays())
        self._m_teacher.observe(time.monotonic() - t0)
        if self._cache is not None:
            self._cache[id(batch)] = (batch, arrays)
        return arrays

    def _save(self) -> None:
        if self.checkpointer is None:
            return
        self.checkpointer.save(self.state)
        sidecar = os.path.join(self.checkpointer.directory, TEACHER_SIDECAR)
        with open(sidecar, "w", encoding="utf-8") as f:
            json.dump({"teacher_sha": self._teacher_sha}, f)

    def distill(self, num_steps: int) -> trainer_lib.TrainState:
        """``num_steps`` distillation steps (fewer if the batcher ends);
        saves the draft's checkpoint and the teacher sidecar at the
        cadence and at the end."""
        state = self._distill_steps(num_steps)
        self._save()
        return state

    def _flush_metrics(self, pending) -> None:
        """One host read for a window of device losses; a non-finite one
        raises the trainer's NonFiniteLossError."""
        if not pending:
            return
        losses = torch.stack([m.loss for _, m in pending]).cpu().numpy()
        for (step, _), loss in zip(pending, losses):
            loss = float(loss)
            self._g_loss.set(loss)
            log.info("distill step %d loss %f", step, loss)
            if not np.isfinite(loss):
                raise trainer_lib.NonFiniteLossError(
                    f"distillation loss is not finite at step {step}")

    def _distill_steps(self, limit: int) -> trainer_lib.TrainState:
        last_ckpt = time.monotonic()
        pending = []
        step = int(self.state.step)
        start = step
        while not limit or step - start < limit:
            batch = self.batcher.next_batch()
            if batch is None:
                break
            arrays = beam_search._to_device(self._teacher_arrays(batch),
                                            self._device)
            self.state, metrics = trainer_lib.train_step(
                self.dhps, self.state, arrays, loss_fn=self._loss_fn)
            step += 1
            pending.append((step, metrics))
            self._c_steps.inc()
            if len(pending) >= self.metrics_every:
                self._flush_metrics(pending)
                pending = []
            if self.checkpointer is not None and \
                    time.monotonic() - last_ckpt >= self.checkpoint_secs:
                self._flush_metrics(pending)
                pending = []
                self._save()
                last_ckpt = time.monotonic()
        self._flush_metrics(pending)
        return self.state
