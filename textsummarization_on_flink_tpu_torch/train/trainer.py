"""Training and eval loops: the train step, NaN watchdog, summaries.

Port of the single-device path of the JAX package's train/trainer.py
(after the reference's run_training / run_eval, run_summarization.py:
105-129, 212-292, and train.py:89-125):

  * ``train_step``: gradients of the objective (``total_loss`` with
    coverage, else ``loss``; model.py:291) -> global-norm clip -> TF1
    Adagrad -> step + 1, params and accumulators updated in place;
  * ``Trainer.train``: per-step ``loss`` and ``seconds for training step``
    log lines, JSON-lines summaries, a non-finite-loss watchdog that reads
    the loss after every step (train.py:107-108), checkpoints every
    ``CHECKPOINT_SECS`` (save_model_secs=60 parity) or every
    ``hps.checkpoint_steps``, and one at the end;
  * ``Evaluator.run``: the exponentially smoothed running-average loss
    (decay .99, clipped at 12) driving best-model saves.

Not ported yet (ROADMAP.md queue 1, items 2c-2f and 6): remat, the obs
registry, flight recorder and fault injection, divergence recovery
(nan_skip_steps / nan_max_rollbacks), the DevicePrefetcher,
steps_per_dispatch, the profiler hooks, and the mesh.  Batches come
synchronously from data/batcher.py and move to the device per step.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.decode.beam_search import (
    _to_device as batch_to_device,
)
from textsummarization_on_flink_tpu_torch.device import resolve_device
from textsummarization_on_flink_tpu_torch.models import get_family
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
    tree_leaves,
)
from textsummarization_on_flink_tpu_torch.train import optim

log = logging.getLogger(__name__)

#: the checkpoint cadence when hps.checkpoint_steps is 0 (the reference's
#: save_model_secs=60, run_summarization.py:198)
CHECKPOINT_SECS = 60.0


class TrainState(NamedTuple):
    params: Any  # tree of tensors that require grad
    opt_state: optim.AdagradState
    step: int  # global step (int32 in checkpoints)


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    coverage_loss: torch.Tensor
    total_loss: torch.Tensor
    global_norm: torch.Tensor


def init_train_state(hps: HParams, vsize: int, params: Optional[Any] = None,
                     device: Any = None) -> TrainState:
    """Fresh params of the family from ``hps.seed`` or the given tree
    (numpy or tensors), on ``device`` (hps.device when None), with
    accumulators at ``adagrad_init_acc`` and step 0."""
    device = resolve_device(hps.device) if device is None else device
    if params is None:
        params = init_numpy_params(hps, vsize, hps.seed)
    return make_train_state(params, None, 0, device,
                            init_acc=hps.adagrad_init_acc)


def make_train_state(params: Any, accumulators: Optional[Any], step: int,
                     device: Any, init_acc: float = 0.0) -> TrainState:
    """A TrainState on ``device`` from numpy or tensor trees; the params
    get ``requires_grad``; accumulators of None start at ``init_acc``
    (0 is what the JAX package's arrays_to_state gives a params-only
    checkpoint)."""
    params = from_numpy_tree(params, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    if accumulators is None:
        opt_state = optim.adagrad_init(params, init_acc)
    else:
        opt_state = optim.AdagradState(
            accumulators=from_numpy_tree(accumulators, device))
    return TrainState(params=params, opt_state=opt_state, step=int(step))


def make_loss_fn(hps: HParams) -> Callable:
    """(params, arrays) -> (objective, TrainOutput): the one definition
    of the training objective (trainer.py:93-106)."""
    family = get_family(hps.model_family)

    def loss_fn(params: Any, arrays: Dict[str, torch.Tensor]):
        out = family.forward_train(params, hps, arrays)
        # minimise total_loss when coverage is on (model.py:291)
        objective = out.total_loss if hps.coverage else out.loss
        return objective, out

    return loss_fn


def train_step(hps: HParams, state: TrainState,
               arrays: Dict[str, torch.Tensor],
               loss_fn: Optional[Callable] = None,
               ) -> Tuple[TrainState, StepMetrics]:
    """grads -> clip -> Adagrad -> step + 1 (trainer.py:139-148).  The
    params and accumulators of ``state`` are updated in place; the
    returned state holds them with the new step."""
    loss_fn = loss_fn if loss_fn is not None else make_loss_fn(hps)
    leaves = tree_leaves(state.params)
    objective, out = loss_fn(state.params, arrays)
    # materialize_grads: a param the objective does not reach (pgen_linear
    # with pointer_gen off) gets zeros, as jax.grad gives it
    grads = list(torch.autograd.grad(objective, leaves,
                                     materialize_grads=True))
    grads, gnorm = optim.clip_by_global_norm(grads, hps.max_grad_norm)
    opt_state = optim.adagrad_update(grads, state.opt_state, state.params,
                                     hps.lr)
    metrics = StepMetrics(loss=out.loss.detach(),
                          coverage_loss=out.coverage_loss.detach(),
                          total_loss=out.total_loss.detach(),
                          global_norm=gnorm)
    return TrainState(state.params, opt_state, state.step + 1), metrics


def calc_running_avg_loss(loss: float, running_avg_loss: float,
                          decay: float = 0.99) -> float:
    """Early-stopping smoother (run_summarization.py:105-129)."""
    if running_avg_loss == 0:
        running_avg_loss = loss
    else:
        running_avg_loss = running_avg_loss * decay + (1 - decay) * loss
    return min(running_avg_loss, 12)


class SummaryWriter:
    """JSON-lines scalar summaries under ``<directory>/events.jsonl``, one
    ``{"step": N, name: value, ...}`` record per call, flushed at once
    (the JAX package's records; a TensorBoard-writer stand-in)."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "events.jsonl")
        self._f = open(self.path, "a", encoding="utf-8")

    def scalars(self, step: int, **values: float) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class NonFiniteLossError(RuntimeError):
    """Raised by the NaN/Inf watchdog (train.py:107-108 parity)."""


class NanLossError(NonFiniteLossError):
    """Divergence recovery exhausted its budgets (JAX trainer.py:278).
    The port has no divergence recovery yet (ROADMAP.md queue 1, item
    2e), so it never raises this; the type is kept so handlers written
    against the JAX package's hierarchy work unchanged."""


class Trainer:
    """Single-device training driver (trainer.py:478-1078, the
    single-device path).

    batcher: anything with next_batch() -> Batch | None.  checkpointer:
    optional; saves every ``CHECKPOINT_SECS`` (or every
    ``hps.checkpoint_steps`` when > 0) and at the end.  A step's logged
    seconds are host wall time ending in the loss read, a device sync."""

    def __init__(self, hps: HParams, vsize: int, batcher: Any,
                 state: Optional[TrainState] = None,
                 checkpointer: Optional[Any] = None,
                 train_dir: Optional[str] = None):
        self.hps = hps
        self.batcher = batcher
        self.device = resolve_device(hps.device)
        self.state = state if state is not None else init_train_state(
            hps, vsize, device=self.device)
        self.checkpointer = checkpointer
        self.train_dir = train_dir or os.path.join(
            hps.log_root or ".", hps.exp_name or "exp", "train")
        self.writer: Optional[SummaryWriter] = None
        self._loss_fn = make_loss_fn(hps)

    def train(self, num_steps: Optional[int] = None) -> TrainState:
        """Run until step ``num_steps`` (hps.num_steps when None; 0 = until
        the batcher is exhausted)."""
        limit = self.hps.num_steps if num_steps is None else num_steps
        # the cadence is a duration: monotonic, never the wall clock
        last_ckpt = time.monotonic()
        step = self.state.step
        self.writer = SummaryWriter(self.train_dir)
        try:
            while not (limit and step >= limit):
                batch = self.batcher.next_batch()
                if batch is None:
                    log.info("batcher exhausted; stopping training at step "
                             "%d", step)
                    break
                step = self._one_step(step, batch)
                if self.checkpointer is not None and self._due(
                        step, last_ckpt):
                    self.checkpointer.save(self.state)
                    last_ckpt = time.monotonic()
            if self.checkpointer is not None:
                self.checkpointer.save(self.state)
        finally:
            self.writer.close()
        return self.state

    def _due(self, step: int, last_ckpt: float) -> bool:
        if self.hps.checkpoint_steps > 0:
            return step % self.hps.checkpoint_steps == 0
        return time.monotonic() - last_ckpt >= CHECKPOINT_SECS

    def _one_step(self, step: int, batch: Any) -> int:
        arrays = batch_to_device(batch.as_arrays(), self.device)
        t0 = time.perf_counter()
        self.state, m = train_step(self.hps, self.state, arrays,
                                   self._loss_fn)
        loss = float(m.loss)  # the watchdog's read: a device sync
        dt = time.perf_counter() - t0
        log.info("seconds for training step: %.3f", dt)
        log.info("loss: %f", loss)
        scalars = dict(loss=loss, total_loss=float(m.total_loss),
                       global_norm=float(m.global_norm), step_time=dt)
        if self.hps.coverage:
            scalars["coverage_loss"] = float(m.coverage_loss)
            log.info("coverage_loss: %f", scalars["coverage_loss"])
        if not np.isfinite(loss):
            self._dump_nan_batch(step, batch)
            raise NonFiniteLossError(
                f"Loss is not finite. Stopping. (step {step}, loss {loss})")
        self.writer.scalars(step + 1, **scalars)
        return step + 1

    def _dump_nan_batch(self, step: int, batch: Any) -> None:
        """--debug: keep the batch of a non-finite loss (the reference
        wires tfdbg's has_inf_or_nan filter here,
        run_summarization.py:216-218)."""
        if not self.hps.debug:
            return
        path = os.path.join(self.train_dir, f"nan_batch_step{step}.npz")
        os.makedirs(self.train_dir, exist_ok=True)
        np.savez(path, **batch.as_arrays())
        log.error("non-finite loss at step %d; offending batch dumped to %s",
                  step, path)


class Evaluator:
    """Eval loop with the running-average loss and the best-model hook
    (trainer.py:1081-1162, run_summarization.py:247-292)."""

    def __init__(self, hps: HParams, batcher: Any,
                 eval_dir: Optional[str] = None,
                 best_saver: Optional[Callable[[Any, float, int], Any]] = None):
        self.hps = hps
        self.batcher = batcher
        self.device = resolve_device(hps.device)
        self.eval_dir = eval_dir or os.path.join(
            hps.log_root or ".", hps.exp_name or "exp", "eval")
        self.writer = SummaryWriter(self.eval_dir)
        self.best_saver = best_saver
        self.running_avg_loss = 0.0
        self.best_loss: Optional[float] = None
        self._family = get_family(hps.model_family)

    @torch.no_grad()
    def run(self, params: Any, step: int, max_batches: int = 0) -> float:
        """Evaluate batches (all, or max_batches); returns the running
        average loss."""
        n = 0
        while True:
            batch = self.batcher.next_batch()
            if batch is None:
                break
            t0 = time.monotonic()
            arrays = batch_to_device(batch.as_arrays(), self.device)
            out = self._family.forward_train(params, self.hps, arrays)
            loss = float(out.total_loss if self.hps.coverage else out.loss)
            log.info("seconds for eval batch: %.3f  loss: %f",
                     time.monotonic() - t0, loss)
            if not np.isfinite(loss):
                raise NonFiniteLossError("Eval loss is not finite.")
            self.running_avg_loss = calc_running_avg_loss(
                loss, self.running_avg_loss)
            self.writer.scalars(step, eval_loss=loss,
                                running_avg_loss=self.running_avg_loss)
            # the best-model check runs after every eval batch, as the
            # reference's loop does (run_summarization.py:281-292)
            if self.best_loss is None or \
                    self.running_avg_loss < self.best_loss:
                log.info("Found new best model with %.3f running_avg_loss. "
                         "Saving...", self.running_avg_loss)
                if self.best_saver is not None:
                    self.best_saver(params, self.running_avg_loss, step)
                self.best_loss = self.running_avg_loss
            n += 1
            if max_batches and n >= max_batches:
                break
        return self.running_avg_loss
