"""Training and eval loops: the train step, NaN watchdog, summaries.

Port of the JAX package's train/trainer.py (after the reference's
run_training / run_eval, run_summarization.py:105-129, 212-292, and
train.py:89-125):

  * ``train_step``: gradients of the objective (``total_loss`` with
    coverage, else ``loss``; model.py:291) -> global-norm clip -> TF1
    Adagrad (accumulators stored in ``--opt_state_dtype``) -> step + 1,
    params and accumulators updated in place, or out of place while
    divergence recovery needs the pre-step state;
  * ``Trainer.train``: batches from a ``DevicePrefetcher`` (a thread that
    reads the batcher and copies each batch to the device ahead of the
    step), ``steps_per_dispatch`` steps back to back per dispatch, the
    metrics read in windows of ``metrics_every`` steps (one device sync
    per window) with their per-step ``loss`` and ``seconds for training
    step`` log lines, JSON-lines summaries and the non-finite-loss
    watchdog (train.py:107-108), divergence recovery (skip, roll back
    with an LR cut, then ``NanLossError``) with the ``train.step_nan``
    fault point, a ``torch.profiler`` capture of steps 2-7 into
    ``profile_dir``, checkpoints every ``CHECKPOINT_SECS``
    (save_model_secs=60 parity) or every ``hps.checkpoint_steps``, and
    one at the end;
  * ``Evaluator.run``: the exponentially smoothed running-average loss
    (decay .99, clipped at 12) driving best-model saves.

Eager PyTorch has no ``lax.scan``: a dispatch of k steps is k calls of
``train_step`` with no host sync between them, the same operations in
the same order as k dispatches of one.  So ``steps_per_dispatch`` saves
no launch, and no sync while ``metrics_every`` >= k; it sets the unit
the JAX package works in, so that one set of flags acts on the same
steps in both packages: the ``train.step_nan`` fault point fires once
per dispatch, a recovery skip discards a whole dispatch (armed recovery
reads the metrics once per dispatch), and the checkpoint and profiler
cadences fall on dispatch boundaries.  Under ``--debug`` each dispatch
runs in ``DebugNans``, the counterpart of the JAX package's
``jax_debug_nans``: the first op whose output holds a NaN, in the
forward or the backward, raises, and the trainer dumps the batch and
raises ``NonFiniteLossError`` (``NanLossError`` once recovery is spent)
as the JAX trainer does.  The trainer reports through the
obs registry (obs/), as the JAX trainer does: a ``train_step`` flight
frame per flushed step into a ring of ``flight_frames`` (dumped to
``<train_dir>/flight_train_nan.jsonl`` and ``flight_nan_rollback.jsonl``
by the watchdog and divergence recovery), the ``train/host_wait_seconds``
histogram, and per round the profiler's ``train/host_wait``,
``train/step_dispatch``, ``train/metrics_flush`` and ``train/checkpoint``
phases inside a ``train/round`` wall; with ``profile_analytic`` the
dispatch is priced by ``obs/cost.py`` for the divergence sentinel.

On a mesh (``dp * tp * sp > 1``, one process per rank, see
parallel/mesh.py; JAX trainer.py:606-631) the Trainer runs the sharded
step on its rank's shards of the state: its batcher yields the rank's
``batch_size / dp`` rows (utils.local_batch_hps), and where tp or sp
ranks share a dp index the first of them broadcasts its batch to the
others, so they compute on the same rows.  Checkpoints gather the tp
shards and only the chief writes them; only the chief writes the
summaries; the time-based checkpoint cadence follows the chief's clock.
Divergence recovery refuses a mesh, as the JAX trainer does.  The
Evaluator runs the sharded eval step on the same rules.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue as queue_lib
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.decode.beam_search import (
    _to_device as batch_to_device,
)
from textsummarization_on_flink_tpu_torch.device import resolve_device
from textsummarization_on_flink_tpu_torch.models import get_family
from textsummarization_on_flink_tpu_torch.obs import cost as cost_lib
from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs import profile as profile_lib
from textsummarization_on_flink_tpu_torch.parallel import collectives
from textsummarization_on_flink_tpu_torch.parallel import distributed
from textsummarization_on_flink_tpu_torch.parallel import mesh as mesh_lib
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
    tree_leaves,
    tree_map,
)
from textsummarization_on_flink_tpu_torch.resilience import faultinject
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


def opt_state_dtype(hps: HParams) -> Optional[torch.dtype]:
    """The accumulators' storage dtype (None: the params' own, f32)."""
    return torch.bfloat16 if hps.opt_state_dtype == "bfloat16" else None


def init_train_state(hps: HParams, vsize: int, params: Optional[Any] = None,
                     device: Any = None) -> TrainState:
    """Fresh params of the family from ``hps.seed`` or the given tree
    (numpy or tensors), on ``device`` (hps.device when None), with
    accumulators at ``adagrad_init_acc`` in ``--opt_state_dtype`` and
    step 0."""
    device = resolve_device(hps.device) if device is None else device
    if params is None:
        params = init_numpy_params(hps, vsize, hps.seed)
    return make_train_state(params, None, 0, device,
                            init_acc=hps.adagrad_init_acc,
                            acc_dtype=opt_state_dtype(hps))


def make_train_state(params: Any, accumulators: Optional[Any], step: int,
                     device: Any, init_acc: float = 0.0,
                     acc_dtype: Optional[torch.dtype] = None) -> TrainState:
    """A TrainState on ``device`` from numpy or tensor trees; the params
    get ``requires_grad``; accumulators of None start at ``init_acc``
    (0 is what the JAX package's arrays_to_state gives a params-only
    checkpoint), in ``acc_dtype`` (None: the params')."""
    params = from_numpy_tree(params, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    if accumulators is None:
        opt_state = optim.adagrad_init(params, init_acc, dtype=acc_dtype)
    else:
        opt_state = optim.AdagradState(
            accumulators=from_numpy_tree(accumulators, device))
    return TrainState(params=params, opt_state=opt_state, step=int(step))


def cast_opt_state(hps: HParams, state: TrainState) -> TrainState:
    """The state with its accumulators in ``--opt_state_dtype`` (JAX
    trainer.py:74-86): a checkpoint holds them in f32 (npz has no bf16),
    so a bf16-state run narrows them again on resume."""
    dtype = opt_state_dtype(hps) or torch.float32
    acc = state.opt_state.accumulators
    if all(a.dtype == dtype for a in tree_leaves(acc)):
        return state
    return state._replace(opt_state=optim.AdagradState(
        accumulators=tree_map(lambda a: a.to(dtype), acc)))


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
               loss_fn: Optional[Callable] = None, inplace: bool = True,
               plan: Optional[Any] = None,
               ) -> Tuple[TrainState, StepMetrics]:
    """grads -> clip -> Adagrad -> step + 1 (trainer.py:139-148).  With
    ``inplace`` the params and accumulators of ``state`` are updated in
    place and the returned state holds them with the new step; without
    it ``state`` is left as it was and the returned state holds new
    tensors (the same arithmetic).

    With the ``plan`` of a mesh (parallel/mesh.py) ``state`` holds this
    rank's shards and ``arrays`` its part of the batch: where T is
    sharded each sp rank takes 1/sp of the objective, the gradients
    become the global batch's (``mesh.reduce_grads``), the clip uses the
    full gradient's norm, and every rank gets the global batch's
    metrics."""
    loss_fn = loss_fn if loss_fn is not None else make_loss_fn(hps)
    leaves = tree_leaves(state.params)
    with collectives.bound(plan):
        objective, out = loss_fn(state.params, arrays)
        if plan is not None and plan.registry.shards_t:
            objective = objective / plan.sp
        # materialize_grads: a param the objective does not reach
        # (pgen_linear with pointer_gen off) gets zeros, as jax.grad
        # gives it
        grads = list(torch.autograd.grad(objective, leaves,
                                         materialize_grads=True))
    norm = None
    if plan is not None:
        with torch.no_grad():
            grads = mesh_lib.reduce_grads(plan, grads)
            norm = mesh_lib.sharded_global_norm(plan, grads, state.params)
    grads, gnorm = optim.clip_by_global_norm(grads, hps.max_grad_norm, norm)
    if inplace:
        params = state.params
        opt_state = optim.adagrad_update(grads, state.opt_state, params,
                                         hps.lr)
    else:
        params, opt_state = optim.adagrad_step(grads, state.opt_state,
                                               state.params, hps.lr)
    loss, cov, total = (out.loss.detach(), out.coverage_loss.detach(),
                        out.total_loss.detach())
    if plan is not None:
        loss, cov, total = mesh_lib.mean_over_dp(
            plan, torch.stack([loss, cov, total]).float())
    metrics = StepMetrics(loss=loss, coverage_loss=cov, total_loss=total,
                          global_norm=gnorm)
    return TrainState(params, opt_state, state.step + 1), metrics


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
    ``{"step": N, name: value, ...}`` record per call (the JAX package's
    records; a TensorBoard-writer stand-in).  ``flush_every=k`` buffers
    k records per flush (``hps.summary_flush_every``; the default
    flushes every record, as the JAX writer does).  On a mesh only the
    chief writes (JAX trainer.py:174-200), so a shared log_root sees one
    record per step."""

    def __init__(self, directory: str, flush_every: int = 1):
        self.path = os.path.join(directory, "events.jsonl")
        self._chief = distributed.is_chief()
        self._f = None
        if self._chief:
            os.makedirs(directory, exist_ok=True)
            self._f = open(self.path, "a", encoding="utf-8")
        self._flush_every = max(int(flush_every), 1)
        self._unflushed = 0

    def scalars(self, step: int, **values: float) -> None:
        if self._f is None:
            return
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._unflushed += 1
        if self._unflushed >= self._flush_every:
            self._f.flush()
            self._unflushed = 0

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class DebugNans(TorchDispatchMode):
    """--debug's op-level NaN check (the JAX package's jax_debug_nans,
    set by its utils.apply_debug_mode): every floating output of every
    aten op run under this mode, the autograd backward's included, is
    tested, and the first NaN raises FloatingPointError naming the op.
    Uninitialised factories (``empty*``, ``new_empty*``) are not tested:
    the kernels' wrappers allocate their outputs with them.  A CUDA
    kernel writes outside aten, so its output is tested by the next op
    that reads it.  Each test syncs the device: a debug cost only."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if "empty" in func.overloadpacket.__name__:
            return out
        for x in pytree.tree_leaves(out):
            if (isinstance(x, torch.Tensor) and x.is_floating_point()
                    and bool(torch.isnan(x).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (--debug)")
        return out


class NonFiniteLossError(RuntimeError):
    """Raised by the NaN/Inf watchdog (train.py:107-108 parity)."""


class NanLossError(NonFiniteLossError):
    """Divergence recovery exhausted its budgets (JAX trainer.py:278): the
    watchdog skipped ``hps.nan_skip_steps`` batches and rolled back
    ``hps.nan_max_rollbacks`` times, and the loss still went non-finite.
    A ``NonFiniteLossError`` subclass, so watchdog handlers keep
    working."""


class _DivergenceRecovery:
    """Armed NaN/Inf recovery (hps.nan_skip_steps > 0 or
    hps.nan_max_rollbacks > 0; JAX trainer.py:286-360).

    On a non-finite dispatch:
      1. SKIP: discard the dispatch (the trainer updates out of place
         while armed, so the pre-dispatch state is intact) and take the
         next batch, up to ``nan_skip_steps`` consecutive skips; a
         finite dispatch restores the budget;
      2. ROLLBACK: restore the last good checkpoint (or, with no
         checkpointer or before its first save, the last snapshot) and
         cut the LR by ``nan_lr_cut``, up to ``nan_max_rollbacks`` times;
      3. RAISE ``NanLossError``.

    Counters ``resilience/train/nan_skips_total`` and
    ``resilience/train/rollbacks_total``; gauge
    ``resilience/train/lr_scale``.  The snapshot holds references to a
    state's tensors, not copies: while armed, no update writes into a
    tensor in place, so an earlier state stays as it was."""

    SNAPSHOT_EVERY = 10  # good dispatches between snapshots (no checkpointer)

    def __init__(self, hps: HParams, checkpointer: Any,
                 registry: obs.Registry, initial_state: TrainState,
                 device: Any):
        self.hps = hps
        self.checkpointer = checkpointer
        self.device = device
        self.skips_left = hps.nan_skip_steps
        self.rollbacks_left = hps.nan_max_rollbacks
        self.lr_scale = 1.0
        self._c_skips = registry.counter("resilience/train/nan_skips_total")
        self._c_rollbacks = registry.counter(
            "resilience/train/rollbacks_total")
        self._g_lr_scale = registry.gauge("resilience/train/lr_scale")
        self._g_lr_scale.set(1.0)
        self.snapshot = initial_state
        self._good_since_snapshot = 0

    def note_good(self, state: TrainState) -> None:
        self.skips_left = self.hps.nan_skip_steps  # a consecutive budget
        if self.checkpointer is None:
            self._good_since_snapshot += 1
            if self._good_since_snapshot >= self.SNAPSHOT_EVERY:
                self.snapshot = state
                self._good_since_snapshot = 0

    def next_action(self) -> str:
        if self.skips_left > 0:
            return "skip"
        if self.rollbacks_left > 0:
            return "rollback"
        return "raise"

    def take_skip(self) -> None:
        self.skips_left -= 1
        self._c_skips.inc()

    def take_rollback(self) -> TrainState:
        """Consume one rollback: cut the LR and return the state to
        resume from, its accumulators in ``--opt_state_dtype``."""
        self.rollbacks_left -= 1
        self.skips_left = self.hps.nan_skip_steps
        self.lr_scale *= self.hps.nan_lr_cut
        self._g_lr_scale.set(self.lr_scale)
        self._c_rollbacks.inc()
        restored = (self.checkpointer.restore(device=self.device)
                    if self.checkpointer is not None else None)
        if restored is None:
            return self.snapshot
        return cast_opt_state(self.hps, restored)


class PrefetchError(RuntimeError):
    """The DevicePrefetcher's thread failed; the cause is chained
    (``raise ... from``).  A RuntimeError subclass, so handlers written
    for the JAX package's hierarchy keep working."""


class _CudaTransfer:
    """A batch to the card off the main stream: the host arrays are
    copied into pinned memory and from there, without blocking, on a
    side stream (in the prefetcher's thread); ``ready`` (in the
    consumer's thread) makes the current stream wait for those copies
    and marks the tensors as used by it, so the allocator does not hand
    their memory back to the side stream early."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, arrays: Dict[str, np.ndarray]):
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {}
            for k, v in arrays.items():
                t = torch.as_tensor(np.asarray(v))
                t = t.float() if t.dtype.is_floating_point else t.long()
                out[k] = t.pin_memory().to(self.device, non_blocking=True)
            event = self.stream.record_event()
        return out, event

    def ready(self, item) -> Dict[str, torch.Tensor]:
        out, event = item
        main = torch.cuda.current_stream(self.device)
        main.wait_event(event)
        for t in out.values():
            t.record_stream(main)
        return out


class _CpuTransfer:
    """A batch to CPU tensors (no stream)."""

    def __init__(self, device: torch.device):
        self.device = device

    def __call__(self, arrays: Dict[str, np.ndarray]):
        return batch_to_device(arrays, self.device)

    def ready(self, item) -> Dict[str, torch.Tensor]:
        return item


def make_transfer(device: torch.device):
    return (_CudaTransfer(device) if device.type == "cuda"
            else _CpuTransfer(device))


class DevicePrefetcher:
    """The batcher read, and each batch copied to the device, by a thread
    ahead of the train loop (JAX trainer.py:363-476): ``next_batch()``
    returns (batch, device arrays) in the batcher's order, or None once
    the batcher is exhausted.

    A failure of the thread surfaces on the next ``next_batch()`` call as
    a ``PrefetchError`` chained to its cause; the consumer polls, so a
    dead thread never strands it on an empty queue.  ``stop()`` joins the
    thread.  Counters ``train/prefetch_batches_total`` and
    ``train/prefetch_errors_total``; gauge ``train/prefetch_queue_depth``.
    """

    def __init__(self, batcher: Any, transfer: Any, depth: int = 2,
                 registry: Optional[obs.Registry] = None):
        self._batcher = batcher
        self._transfer = transfer
        self._q: Any = queue_lib.Queue(maxsize=max(depth, 1))
        self._done = object()
        self._stopped = threading.Event()
        self.error: Optional[BaseException] = None
        reg = registry if registry is not None else obs.registry()
        self._g_depth = reg.gauge("train/prefetch_queue_depth")
        self._c_errors = reg.counter("train/prefetch_errors_total")
        self._c_batches = reg.counter("train/prefetch_batches_total")
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="device-prefetcher")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stopped.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue_lib.Full:
                continue
        return False

    def _pump(self) -> None:
        try:
            while not self._stopped.is_set():
                batch = self._batcher.next_batch()
                if batch is None:
                    break
                # the copy to the device starts here, ahead of the step
                if not self._put((batch, self._transfer(batch.as_arrays()))):
                    return  # stopped while the queue was full
        except BaseException as e:  # re-raised by the consumer
            self.error = e
            self._c_errors.inc()
            log.exception("device prefetcher failed")
        finally:
            self._put(self._done)

    def next_batch(self):
        self._g_depth.set(self._q.qsize())
        while True:
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue_lib.Empty:
                # the thread died before it could queue its sentinel
                if self.error is not None and self._q.empty():
                    raise PrefetchError(
                        "input pipeline failed mid-training") from self.error
        if item is self._done:
            if self.error is not None:
                raise PrefetchError(
                    "input pipeline failed mid-training") from self.error
            return None
        self._c_batches.inc()
        batch, moved = item
        return batch, self._transfer.ready(moved)

    def stop(self) -> None:
        """Stop and join the thread (an exit at the step limit or on an
        error must not go on draining the batcher)."""
        self._stopped.set()
        self._thread.join(timeout=10.0)


class _Profiler:
    """torch.profiler over the capture window from ``start_step``; the
    trace is written into ``directory`` as a Chrome trace,
    ``train_steps_<first>-<last>.pt.trace.json``, when the window closes
    (``-aborted`` in place of the last step when the run failed)."""

    def __init__(self, directory: str, device: torch.device,
                 start_step: int):
        from torch.profiler import ProfilerActivity, profile

        self.directory = directory
        self.start_step = start_step
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self, last_step: Optional[int] = None) -> str:
        self._prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        last = "aborted" if last_step is None else last_step
        path = os.path.join(self.directory,
                            f"train_steps_{self.start_step}-{last}"
                            f".pt.trace.json")
        self._prof.export_chrome_trace(path)
        return path


class Trainer:
    """Training driver (trainer.py:478-1078), on one device or on a mesh.

    batcher: anything with next_batch() -> Batch | None (on a mesh: the
    rank's rows, ``utils.local_batch_hps``).  state: a full state (the
    Trainer shards it on a mesh).  checkpointer: optional; saves every
    ``checkpoint_secs`` (or every ``hps.checkpoint_steps`` when > 0) and
    at the end.  A window's logged seconds per step are host wall time
    over the window, ending in the metrics read, a device sync."""

    def __init__(self, hps: HParams, vsize: int, batcher: Any,
                 state: Optional[TrainState] = None,
                 checkpointer: Optional[Any] = None,
                 train_dir: Optional[str] = None,
                 checkpoint_secs: float = CHECKPOINT_SECS,
                 metrics_every: int = 0):
        self.hps = hps
        self.batcher = batcher
        self.device = resolve_device(hps.device)
        # metrics are read, logged and checked in windows of this many
        # steps (one device sync per window); 0 = auto: every step under
        # --debug, every 10 otherwise.  Every step still gets a summary
        # record.
        self.metrics_every = (metrics_every or hps.metrics_every
                              or (1 if hps.debug else 10))
        self.checkpoint_secs = checkpoint_secs
        state = state if state is not None else init_train_state(
            hps, vsize, device=self.device)
        # a checkpoint holds f32 accumulators: narrow them for bf16 state
        self.state = cast_opt_state(hps, state)
        # --debug pins one step per dispatch: the exact watchdog reads
        # every step
        self.steps_per_dispatch = max(
            1 if hps.debug else hps.steps_per_dispatch, 1)
        self.checkpointer = checkpointer
        self.train_dir = train_dir or os.path.join(
            hps.log_root or ".", hps.exp_name or "exp", "train")
        self.writer: Optional[SummaryWriter] = None
        self._obs = obs.registry_for(hps)
        self._c_nan = self._obs.counter("train/nan_watchdog_total")
        # the batches the loop takes (skipped ones too) and their target
        # tokens: a run's tokens per second divides them by its time
        self._c_batches = self._obs.counter("train/batches_total")
        self._c_tokens = self._obs.counter("train/target_tokens_total")
        # time the loop sat blocked on the input side
        self._m_host_wait = self._obs.histogram("train/host_wait_seconds")
        # the gauge the DevicePrefetcher writes: read per flushed step
        # into the flight frames
        self._g_prefetch = self._obs.gauge("train/prefetch_queue_depth")
        # the phase ledger (obs/profile.py): the loop's sub-phases inside
        # a per-round wall; a dark job gets the null profiler
        self._prof = profile_lib.install_profiler(
            self._obs, divergence_factor=hps.profile_divergence_factor)
        if hps.profile_analytic:
            # the dispatch's analytic price, computed off the hot path
            k = self.steps_per_dispatch
            self._prof.register_cost(
                "train/step_dispatch", "step",
                lambda: cost_lib.train_step_cost(hps, steps=k))
        # the failure flight recorder: per-step frames dumped to
        # <train_dir>/flight_<reason>.jsonl by the watchdog and recovery.
        # On a mesh the ranks share train_dir: the chief alone records
        if self._obs.enabled and hps.flight_frames > 0 \
                and distributed.is_chief():
            flightrec.install_flight_recorder(
                self._obs, self.train_dir, capacity=hps.flight_frames)
        # the fault plan is resolved once, so each point's RNG stream runs
        # on across the whole run
        self._faults = faultinject.plan_for(hps)
        self._recovery: Optional[_DivergenceRecovery] = None
        self._plan = None
        if hps.nan_skip_steps > 0 or hps.nan_max_rollbacks > 0:
            if hps.dp * hps.tp * hps.sp > 1 \
                    or distributed.world_size() > 1:
                raise ValueError(
                    "divergence recovery (nan_skip_steps/nan_max_rollbacks) "
                    "is single-host, default-mesh only: a skip must revert "
                    "to the pre-step state, which the sharded/multi-host "
                    "collective step donates away")
            self._recovery = _DivergenceRecovery(
                hps, checkpointer, self._obs, self.state, self.device)
        if hps.dp * hps.tp * hps.sp > 1:
            mesh_lib.validate_divisibility(hps, self.state.params)
            self._plan = mesh_lib.make_mesh(hps)
            self.state = mesh_lib.shard_train_state(self._plan, self.state)
        self._loss_fn = make_loss_fn(hps)
        self._step_hps = hps
        self._profiler: Optional[_Profiler] = None

    def train(self, num_steps: Optional[int] = None) -> TrainState:
        """Run until step ``num_steps`` (hps.num_steps when None; 0 = until
        the batcher is exhausted).  With ``hps.profile_dir`` (else the
        TS_PROFILE_DIR environment variable) steps 2-7 of this run are
        traced by torch.profiler into that directory."""
        limit = self.hps.num_steps if num_steps is None else num_steps
        profile_dir = self.hps.profile_dir or os.environ.get(
            "TS_PROFILE_DIR", "")
        self.writer = SummaryWriter(self.train_dir,
                                    flush_every=self.hps.summary_flush_every)
        prefetcher = DevicePrefetcher(
            self.batcher, make_transfer(self.device),
            depth=max(2, self.steps_per_dispatch + 1), registry=self._obs)
        try:
            return self._train_steps(limit, prefetcher, profile_dir)
        finally:
            prefetcher.stop()
            if self._profiler is not None:  # a capture the run aborted
                self._profiler.stop()
                self._profiler = None
            self.writer.close()

    def _dispatch(self, items: List[Tuple[Any, Dict[str, torch.Tensor]]],
                  ) -> Tuple[TrainState, List[StepMetrics]]:
        """The steps of one dispatch back to back, no host sync between
        them; out of place while recovery is armed, so ``self.state``
        stays the pre-dispatch state."""
        state, metrics = self.state, []
        for _, arrays in items:
            if self._plan is not None:
                arrays = mesh_batch(self._plan, arrays)
            state, m = train_step(self._step_hps, state, arrays,
                                  self._loss_fn,
                                  inplace=self._recovery is None,
                                  plan=self._plan)
            metrics.append(m)
        return state, metrics

    @staticmethod
    def _fetch(metrics: List[StepMetrics]) -> np.ndarray:
        """[n, 4] host array (loss, coverage_loss, total_loss,
        global_norm) of device metrics: one copy, one sync."""
        return torch.stack([torch.stack(tuple(m)) for m in metrics]
                           ).float().cpu().numpy()

    def _flush_metrics(self, pending, window_dt: float) -> None:
        """Read a window of metrics, log and summarize each step, and run
        the watchdog (train.py:107-108; detection deferred by up to
        ``metrics_every`` steps unless --debug pins the window to 1).
        pending: [(first step, metrics of its steps: a list of
        StepMetrics or an [n, 4] host array, host arrays or None)]."""
        if not pending:
            return
        p0 = self._prof.start()
        on_device = [m for _, m, _ in pending if isinstance(m, list)]
        fetched = iter(np.split(self._fetch(sum(on_device, [])),
                                np.cumsum([len(m) for m in on_device])[:-1])
                       if on_device else [])
        total = sum(len(m) for _, m, _ in pending)
        step_time = window_dt / max(total, 1)
        log.info("seconds for training step: %.3f (avg over %d)", step_time,
                 total)
        prefetch_depth = self._g_prefetch.value
        for step0, m, arrays in pending:
            host = next(fetched) if isinstance(m, list) else m
            for i, (loss, cov, total_loss, gnorm) in enumerate(host):
                step = step0 + i
                loss = float(loss)
                log.info("loss: %f", loss)
                scalars = dict(loss=loss, total_loss=float(total_loss),
                               global_norm=float(gnorm), step_time=step_time)
                if self.hps.coverage:
                    scalars["coverage_loss"] = float(cov)
                    log.info("coverage_loss: %f", scalars["coverage_loss"])
                # the frame a NaN post-mortem reads; a non-finite loss
                # is framed too (the last frames before a blowup)
                flightrec.record(
                    self._obs, "train_step", step=step, loss=loss,
                    global_norm=float(gnorm), step_time=round(step_time, 6),
                    prefetch_depth=prefetch_depth)
                if not np.isfinite(loss):
                    self._c_nan.inc()
                    self._dump_nan_batch(step, arrays)
                    flightrec.trigger(self._obs, "train_nan", step=step)
                    # the bad step opens a window read at >= metrics_every
                    # steps, in whole dispatches
                    lag = max(self.metrics_every + self.steps_per_dispatch
                              - 2, 0)
                    raise NonFiniteLossError(
                        f"Loss is not finite. Stopping. (step {step}, loss "
                        f"{loss}; detection is windowed: up to {lag} "
                        f"optimizer steps may have run past the first bad "
                        f"one; --debug pins the window to 1 for step-exact "
                        f"detection)")
                self.writer.scalars(step + 1, **scalars)
        self._prof.end("train/metrics_flush", p0)

    def _dump_nan_batch(self, step: int, arrays) -> None:
        """--debug: keep the batch of a non-finite loss (the reference
        wires tfdbg's has_inf_or_nan filter here,
        run_summarization.py:216-218)."""
        if not self.hps.debug or arrays is None:
            return
        path = os.path.join(self.train_dir, f"nan_batch_step{step}.npz")
        os.makedirs(self.train_dir, exist_ok=True)
        np.savez(path, **arrays)
        log.error("non-finite loss at step %d; offending batch dumped to %s",
                  step, path)

    def _recover(self, step: int) -> bool:
        """Armed handling of one non-finite dispatch: True when the run
        goes on (``self.state`` is the state to resume from), False when
        both budgets are spent."""
        rec = self._recovery
        action = rec.next_action()
        if action == "skip":
            rec.take_skip()
            log.warning("non-finite loss at step %d: skipping the batch "
                        "(%d consecutive skips left before rollback)", step,
                        rec.skips_left)
            return True
        if action == "rollback":
            restored = rec.take_rollback()
            # the frames before this rollback are the post-mortem's
            flightrec.trigger(self._obs, "nan_rollback", step=step,
                              rollbacks_left=rec.rollbacks_left)
            self.state = restored
            # the LR cut applies to the steps from here on
            self._step_hps = self.hps.replace(lr=self.hps.lr * rec.lr_scale)
            log.warning("non-finite loss at step %d: rolled back to step %d "
                        "with lr scale %.3g (%d rollbacks left)", step,
                        self.state.step, rec.lr_scale, rec.rollbacks_left)
            return True
        return False

    def _due(self, step: int, prev_step: int, last_ckpt: float) -> bool:
        if self.hps.checkpoint_steps > 0:
            # crossed a cadence boundary in this dispatch
            cs = self.hps.checkpoint_steps
            return step // cs != prev_step // cs
        due = time.monotonic() - last_ckpt >= self.checkpoint_secs
        if self._plan is None:
            return due
        # the save is collective: every rank follows the chief's clock
        return bool(collectives.broadcast(
            self._plan, torch.tensor([int(due)]), "world")[0])

    def _train_steps(self, limit: int, prefetcher: DevicePrefetcher,
                     profile_dir: str) -> TrainState:
        flush_every = max(self.metrics_every, 1)
        pending: List[Tuple[int, Any, Optional[Dict[str, np.ndarray]]]] = []
        pending_steps = 0
        # the cadence is a duration: monotonic, never the wall clock
        last_ckpt = window_t0 = time.monotonic()
        step = self.state.step
        # the capture window: steps 2-7 of this run (it may resume)
        profile_start, profile_stop = step + 2, step + 7
        profile_done = False
        exhausted = False
        while not exhausted:
            if limit and step >= limit:
                break
            # the round's wall: the phases below sum toward it, the gap is
            # the loop's own bookkeeping
            w0 = self._prof.start()
            # k batches per dispatch, clipped to the steps left
            k = self.steps_per_dispatch
            if limit:
                k = min(k, limit - step)
            items = []
            t_wait = time.perf_counter()
            p0 = self._prof.start()
            while len(items) < k:
                item = prefetcher.next_batch()
                if item is None:
                    exhausted = True
                    break
                items.append(item)
            self._m_host_wait.observe(time.perf_counter() - t_wait)
            self._prof.end("train/host_wait", p0)
            if not items:
                log.info("batcher exhausted; stopping training at step %d",
                         step)
                break
            if profile_dir and self._profiler is None and not profile_done \
                    and step >= profile_start and distributed.is_chief():
                self._flush_metrics(pending, time.monotonic() - window_t0)
                pending, pending_steps = [], 0
                self._profiler = _Profiler(profile_dir, self.device, step)
                window_t0 = time.monotonic()
                # the capture's opening edge in the profiler's notes:
                # /profile names the steps a trace covers
                self._prof.note("profiler_capture", dir=str(profile_dir),
                                start_step=profile_start,
                                stop_step=profile_stop)
                log.info("profiler trace started -> %s", profile_dir)
            n = len(items)
            self._c_batches.inc(n)
            self._c_tokens.inc(sum(
                float(b.as_arrays()["dec_padding_mask"].sum())
                for b, _ in items))
            arrays = items[0][0].as_arrays() if self.hps.debug else None
            p0 = self._prof.start()
            try:
                with (DebugNans() if self.hps.debug
                      else contextlib.nullcontext()):
                    new_state, metrics = self._dispatch(items)
            except FloatingPointError as e:
                # --debug (one step per dispatch): an op made a NaN; the
                # JAX trainer's handling of jax_debug_nans
                # (train/trainer.py:963-984 there)
                self._c_nan.inc()
                self._dump_nan_batch(step, arrays)
                flightrec.trigger(self._obs, "train_nan", step=step)
                if self._recovery is not None:
                    # the dispatch did not complete: self.state is the
                    # pre-dispatch state (out-of-place updates)
                    if self._recover(step):
                        step = self.state.step
                        continue
                    raise NanLossError(
                        f"Loss is not finite and divergence recovery is "
                        f"exhausted. Stopping. (step {step}; {e})") from e
                raise NonFiniteLossError(
                    f"Loss is not finite. Stopping. (step {step}; {e})"
                ) from e
            # the dispatch's host time (launches are asynchronous: the
            # device's work is waited for in the metrics flush)
            dt = self._prof.end("train/step_dispatch", p0)
            self._prof.observe_dispatch("train/step_dispatch", "step", dt)
            injected = self._faults.fire("train.step_nan")
            if self._recovery is not None:
                # armed: one metrics read per dispatch, so a bad state never
                # outlives the dispatch that made it
                fetched = self._fetch(metrics)
                if injected or not np.all(np.isfinite(fetched[:, 0])):
                    self._c_nan.inc()
                    self._dump_nan_batch(step, arrays)
                    flightrec.trigger(self._obs, "train_nan", step=step,
                                      injected=bool(injected))
                    # new_state is dropped; self.state is the pre-dispatch
                    # state, untouched (out-of-place updates)
                    if self._recover(step):
                        step = self.state.step
                        continue
                    raise NanLossError(
                        f"Loss is not finite and divergence recovery is "
                        f"exhausted. Stopping. (step {step}"
                        f"{'; injected train.step_nan' if injected else ''})")
                self.state = new_state
                self._recovery.note_good(new_state)
                metrics = fetched
            else:
                self.state = new_state
                if injected:
                    self._c_nan.inc()
                    flightrec.trigger(self._obs, "train_nan", step=step,
                                      injected=True)
                    raise NonFiniteLossError(
                        f"injected train.step_nan fault at step {step} "
                        f"(divergence recovery unarmed: nan_skip_steps and "
                        f"nan_max_rollbacks are 0)")
            pending.append((step, metrics, arrays))
            prev_step = step
            step += n
            pending_steps += n
            if pending_steps >= flush_every or self._recovery is not None:
                self._flush_metrics(pending, time.monotonic() - window_t0)
                pending, pending_steps = [], 0
                window_t0 = time.monotonic()
            if self._profiler is not None and step > profile_stop:
                with obs.spans.span(self._obs, "train/profiler_capture"):
                    path = self._profiler.stop(step - 1)
                self._profiler = None
                profile_done = True
                log.info("profiler trace written to %s", path)
            if self.checkpointer is not None and self._due(step, prev_step,
                                                           last_ckpt):
                # the save reads the state anyway: flush with it
                self._flush_metrics(pending, time.monotonic() - window_t0)
                pending, pending_steps = [], 0
                p0 = self._prof.start()
                self.checkpointer.save(self.state, plan=self._plan)
                self._prof.end("train/checkpoint", p0)
                last_ckpt = window_t0 = time.monotonic()
            self._prof.end_wall("train/round", w0)
        self._flush_metrics(pending, time.monotonic() - window_t0)
        if self._profiler is not None:
            path = self._profiler.stop(step - 1)
            self._profiler = None
            log.info("profiler trace written to %s", path)
        if self.checkpointer is not None:
            self.checkpointer.save(self.state, plan=self._plan)
        return self.state


def mesh_batch(plan: Any, arrays: Dict[str, torch.Tensor],
               ) -> Dict[str, torch.Tensor]:
    """A rank's batch (its dp rows) as the sharded step takes it: where
    tp or sp ranks share the dp index, the first of them broadcasts its
    rows to the others (utils.local_batch_hps states the rule), then
    the rank's sp block of T where the path shards T."""
    arrays = collectives.broadcast_arrays(plan, arrays, "batch")
    return plan.registry.sp_block(arrays)


class Evaluator:
    """Eval loop with the running-average loss and the best-model hook
    (trainer.py:1081-1162, run_summarization.py:247-292).  On a mesh
    (JAX trainer.py:1104-1136) each rank evaluates its rows with its
    shards of the full params given to ``run`` and every rank holds the
    global batch's loss; only the chief writes summaries and best
    models."""

    def __init__(self, hps: HParams, batcher: Any,
                 eval_dir: Optional[str] = None,
                 best_saver: Optional[Callable[[Any, float, int], Any]] = None):
        self.hps = hps
        self.batcher = batcher
        self.device = resolve_device(hps.device)
        self.eval_dir = eval_dir or os.path.join(
            hps.log_root or ".", hps.exp_name or "exp", "eval")
        self.writer = SummaryWriter(self.eval_dir,
                                    flush_every=hps.summary_flush_every)
        self.best_saver = best_saver
        self.running_avg_loss = 0.0
        self.best_loss: Optional[float] = None
        self._family = get_family(hps.model_family)
        self._plan = None
        if hps.dp * hps.tp * hps.sp > 1:  # the Trainer's mesh rule
            self._plan = mesh_lib.make_mesh(hps)
            self._eval_step = mesh_lib.make_sharded_eval_step(self._plan)

    @torch.no_grad()
    def run(self, params: Any, step: int, max_batches: int = 0) -> float:
        """Evaluate batches (all, or max_batches); returns the running
        average loss."""
        n = 0
        full_params = params
        if self._plan is not None:
            mesh_lib.validate_divisibility(self.hps, params)
            params = self._plan.registry.shard_params(params)
        while True:
            batch = self.batcher.next_batch()
            if batch is None:
                break
            t0 = time.monotonic()
            arrays = batch_to_device(batch.as_arrays(), self.device)
            if self._plan is not None:
                out = self._eval_step(params, mesh_batch(self._plan, arrays))
            else:
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
                if self.best_saver is not None and distributed.is_chief():
                    self.best_saver(full_params, self.running_avg_loss,
                                    step)
                self.best_loss = self.running_avg_loss
            n += 1
            if max_batches and n >= max_batches:
                break
        return self.running_avg_loss
