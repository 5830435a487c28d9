"""The (dp, tp, sp) mesh over ``torch.distributed`` ranks, and the sharded
train, eval and beam-search steps (JAX package parallel/mesh.py).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh`` and
lets XLA insert the collectives; the port runs one process per rank
(parallel/distributed.py), a world of ``dp * tp * sp`` ranks laid out in
JAX's axis order (rank = (d * tp + t) * sp + s), and writes the
collectives out (parallel/collectives.py):

  * **dp**: each dp index computes on its own rows; the gradients are
    summed over dp in one flat all-reduce, in the registry's wire dtype
    (``--grad_allreduce_dtype``), and divided by dp;
  * **tp**: the vocabulary tensors (and the transformer's and the AAN's
    heads and FFNs) are sharded over tp (parallel/sharding.py's per-leaf rule); the
    models call the Megatron collectives where the JAX package's GSPMD
    puts its own;
  * **sp**: on the paths that shard T each sp rank keeps its block of
    T; its objective is 1/sp of the loss and every gradient is summed
    over sp.  The pointer-generator (JAX mesh.py:17-22): the biLSTM runs
    over the whole article on every rank, the encoder states, features,
    energies and coverage stay on the rank's block, and each decoder
    step's attention merges the blocks over sp (its context reduction);
    the transformer's and the AAN's encoder: its position-wise layers on
    the block, its self-attention ring or Ulysses attention under
    ``--sp_attention`` and otherwise the block's queries against the
    keys all-gathered over sp (with tp, on the rank's heads), the
    encoder output all-gathered before the decoder
    (collectives.gather_sp).

A step's results equal the single-rank step's: the same loss, global
norm and updated params, up to the order of the sums.  Layout decisions
come from the sharding registry; the step builders decide none.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.parallel import collectives
from textsummarization_on_flink_tpu_torch.parallel import distributed
from textsummarization_on_flink_tpu_torch.parallel import sharding as sharding_lib

log = logging.getLogger(__name__)

MESH_AXES = sharding_lib.MESH_AXES

#: the process groups of each mesh shape already built in this process
#: (every rank builds every group once, in one order)
_GROUPS: Dict[Tuple[int, int, int], Dict[str, Any]] = {}


def _axis_ranks(dp: int, tp: int, sp: int) -> Dict[str, List[List[int]]]:
    """Every group of every axis as lists of global ranks, in a fixed
    order: dp, tp and sp groups, the ranks of one dp index ("batch"),
    and the world."""
    def rank(d, t, s):
        return (d * tp + t) * sp + s

    return {
        "dp": [[rank(d, t, s) for d in range(dp)]
               for t in range(tp) for s in range(sp)],
        "tp": [[rank(d, t, s) for t in range(tp)]
               for d in range(dp) for s in range(sp)],
        "sp": [[rank(d, t, s) for s in range(sp)]
               for d in range(dp) for t in range(tp)],
        "batch": [[rank(d, t, s) for t in range(tp) for s in range(sp)]
                  for d in range(dp)],
        "world": [list(range(dp * tp * sp))],
    }


def _build_groups(dp: int, tp: int, sp: int, me: int) -> Dict[str, Any]:
    """{axis: (process group or None, member ranks)} of this rank."""
    key = (dp, tp, sp)
    if key in _GROUPS:
        return _GROUPS[key]
    out: Dict[str, Any] = {}
    for axis, groups in _axis_ranks(dp, tp, sp).items():
        for members in groups:
            if len(members) == 1:
                pg = None
            elif axis == "world":
                pg = dist.group.WORLD
            else:
                # new_group is collective: every rank creates every group
                pg = dist.new_group(members)
            if me in members:
                out[axis] = (pg, tuple(members))
    _GROUPS[key] = out
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class MeshPlan:
    """This rank's view of the mesh: the hps its registry derives from,
    its coordinates and its process groups."""

    hps: HParams
    rank: int
    groups: Dict[str, Any]  # axis -> (ProcessGroup or None, members)
    backend: str  # "nccl", "gloo", or "" at world 1

    @property
    def dp(self) -> int:
        return self.hps.dp

    @property
    def tp(self) -> int:
        return self.hps.tp

    @property
    def sp(self) -> int:
        return self.hps.sp

    def size(self, axis: str) -> int:
        return len(self.groups[axis][1])

    def group(self, axis: str) -> Any:
        return self.groups[axis][0]

    def members(self, axis: str) -> Tuple[int, ...]:
        return self.groups[axis][1]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.members(axis).index(self.rank)

    def peer(self, axis: str, offset: int) -> int:
        """The global rank ``offset`` steps along ``axis``'s ring."""
        members = self.members(axis)
        return members[(self.coord(axis) + offset) % len(members)]

    @property
    def registry(self) -> sharding_lib.ShardingRegistry:
        return sharding_lib.ShardingRegistry(self)

    @property
    def is_chief(self) -> bool:
        return self.rank == 0


def make_mesh(hps: HParams) -> MeshPlan:
    """This rank's plan of the (dp, tp, sp) mesh.  Raises when dp*tp*sp
    differs from the world's rank count (run under torchrun with
    ``--nproc_per_node=dp*tp*sp``, after ``distributed.initialize()``);
    with every axis 1 and no process group it is the single-rank plan."""
    want = hps.dp * hps.tp * hps.sp
    world = distributed.world_size()
    if want != world:
        raise ValueError(
            f"mesh needs dp*tp*sp={want} ranks, the world has {world} "
            f"(launch with python -m torch.distributed.run "
            f"--nproc_per_node={want} and call "
            f"parallel.distributed.initialize())")
    me = distributed.rank()
    groups = _build_groups(hps.dp, hps.tp, hps.sp, me) if want > 1 else {
        axis: (None, (0,)) for axis in MESH_AXES + ("batch", "world")}
    return MeshPlan(hps=hps, rank=me, groups=groups,
                    backend=distributed.backend() or "")


def join_world(hps: HParams) -> bool:
    """Join the world of ``dp * tp * sp`` processes torchrun started (the
    JAX package's multi-host bring-up; cli.py and the pipeline's
    entry points call it).  Returns False, joining nothing, off a mesh;
    raises when torchrun's world is missing or of another size.
    Idempotent."""
    ranks = hps.dp * hps.tp * hps.sp
    if ranks == 1:
        return False
    world = distributed.world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", "0") or 0)
    if world != ranks:
        raise ValueError(
            f"--dp={hps.dp} --tp={hps.tp} --sp={hps.sp} needs {ranks} ranks; "
            f"torchrun's world has {world or 'none'} (launch with python -m "
            f"torch.distributed.run --standalone --nproc_per_node={ranks} "
            f"-m textsummarization_on_flink_tpu_torch ...)")
    distributed.initialize(device=hps.device)
    return True


def validate_divisibility(hps: HParams, params: Optional[Any] = None,
                          ) -> None:
    """Fail fast with actionable errors (JAX mesh.py:316-356; the vocab
    file may hold fewer words than --vocab_size, so the ACTUAL embedding
    rows are what tp must divide)."""
    if hps.dp > 1 and hps.batch_size % hps.dp != 0:
        raise ValueError(f"data-parallel axis dp={hps.dp} must divide "
                         f"batch_size={hps.batch_size}")
    if hps.tp > 1 and params is not None:
        vsize_actual = params["embedding"].shape[0]
        if vsize_actual % hps.tp != 0:
            raise ValueError(
                f"tensor-parallel axis tp={hps.tp} must divide the actual "
                f"vocabulary size {vsize_actual} (the vocab file may hold "
                f"fewer words than --vocab_size); pick a dividing tp or "
                f"trim the vocab")
    if hps.sp > 1 and hps.max_enc_steps % hps.sp != 0:
        raise ValueError(f"sequence-parallel axis sp={hps.sp} must divide "
                         f"max_enc_steps={hps.max_enc_steps}")
    if hps.sp > 1 and hps.sp_attention == "ulysses" \
            and hps.num_heads % hps.sp != 0:
        raise ValueError(
            f"sp_attention=ulysses re-shards heads over sp: sp={hps.sp} "
            f"must divide num_heads={hps.num_heads}")
    if hps.tp > 1 and hps.model_family in ("transformer", "avg_attention"):
        # the AAN pads its heads to a multiple of tp (sharding.pad_heads),
        # where the JAX package lets a head straddle ranks
        if hps.model_family == "transformer" \
                and hps.num_heads % hps.tp != 0:
            raise ValueError(
                f"tensor-parallel axis tp={hps.tp} must divide "
                f"num_heads={hps.num_heads} (Megatron head sharding)")
        if hps.ffn_width % hps.tp != 0:
            raise ValueError(f"tensor-parallel axis tp={hps.tp} must divide "
                             f"ffn_dim={hps.ffn_width}")
        if hps.sp_attention:
            raise ValueError(
                "sp_attention with tp>1 is not supported: the SP "
                "shard_map replicates the head axis, which would silently "
                "all-gather the Megatron-sharded q/k/v every layer — use "
                "sp-only attention (tp=1) or tp without sp_attention")
    if hps.tp > 1 and hps.model_family == "avg_attention":
        _validate_aan_tp(hps)


def _validate_aan_tp(hps: HParams) -> None:
    """The AAN's sharded widths on tp: the attention blocks' columns
    (hidden_dim in the encoder, the decoder's width in its
    cross-attention), the decoder's FFNs (aan_ffn, ffn) and the narrow
    draft's factored vocab_head rank.  The JAX package's placement
    (mesh.shard_train_state's device_put) raises for each of these
    widths that tp does not divide, so the port refuses the same,
    before a model is built.  num_heads is not among them: the port
    pads the heads to a multiple of tp (sharding.pad_heads)."""
    from textsummarization_on_flink_tpu_torch.config import (
        resolve_draft_hidden,
    )

    hd = resolve_draft_hidden(hps)
    dec_ffn = hps.ffn_width if hd == hps.hidden_dim else (
        hps.ffn_dim or 4 * hd)
    for what, width in (("hidden_dim", hps.hidden_dim),
                        ("the AAN decoder's width", hd),
                        ("the AAN decoder's ffn width", dec_ffn),
                        ("draft_vocab_rank", hps.draft_vocab_rank)):
        if width % hps.tp != 0:
            raise ValueError(
                f"tensor-parallel axis tp={hps.tp} must divide {what} "
                f"{width}: the JAX package's placement refuses the same "
                f"(its device_put of the sharded leaf raises)")


def shard_batch(plan: MeshPlan, arrays: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's part of a global batch (registry delegate)."""
    return plan.registry.shard_batch(arrays)


def shard_train_state(plan: MeshPlan, state: Any) -> Any:
    """This rank's TrainState from a full one (registry delegate)."""
    return plan.registry.shard_state(state)


# --------------------------------------------------------------------------
# The sharded steps
# --------------------------------------------------------------------------

def mean_over_dp(plan: MeshPlan, values: torch.Tensor) -> torch.Tensor:
    """The dp groups' values (a vector) averaged, gathered in rank order
    so every rank holds the same bits."""
    if plan.dp == 1:
        return values
    got = collectives.all_gather(plan, values.reshape(1, -1), "dp", 0)
    return got.sum(dim=0) / plan.dp


def reduce_grads(plan: MeshPlan, grads: List[torch.Tensor],
                 ) -> List[torch.Tensor]:
    """This rank's gradients (of its dp rows' mean objective, 1/sp of it
    where T is sharded) -> the global batch's: summed over sp where T is
    sharded, then summed over dp in the registry's wire dtype and
    divided by dp, back in f32.

    The bf16 wire rounds each dp group's gradient to bf16 and sums the
    bf16 values in the backend: gloo and NCCL add in the operand's dtype,
    so each partial sum is rounded to bf16 (at dp = 2 one add, rounded
    once).  The JAX package's CPU backend sums the bf16-rounded values
    in f32 and rounds once; on TPU its wire is bf16.  f32 is restored
    before clipping and Adagrad."""
    reg = plan.registry
    if reg.shards_t:
        grads = collectives.flat_all_reduce(plan, grads, "sp")
    if plan.dp > 1:
        grads = collectives.flat_all_reduce(plan, grads, "dp",
                                            dtype=reg.wire_dtype("grads"))
        grads = [g / plan.dp for g in grads]
    return grads


def sharded_global_norm(plan: MeshPlan, grads: List[torch.Tensor],
                        params: Any) -> torch.Tensor:
    """The global norm of the full gradient (``grads`` in
    ``tree_leaves(params)`` order): the tp-sharded leaves' sum of squares
    summed over tp, the replicated leaves' counted once."""
    if plan.tp == 1:
        return torch.sqrt(sum(torch.sum(g * g) for g in grads))
    tp_sharded = [sharding_lib.param_spec(path).dim_of("tp") is not None
                  for path, _ in sharding_lib.tree_paths(params)]
    zero = grads[0].new_zeros(())
    sharded = sum((torch.sum(g * g) for g, s in zip(grads, tp_sharded) if s),
                  zero)
    replicated = sum((torch.sum(g * g) for g, s in zip(grads, tp_sharded)
                      if not s), zero)
    return torch.sqrt(collectives.all_reduce(plan, sharded, "tp")
                      + replicated)


def make_sharded_train_step(plan: MeshPlan, donate: bool = True,
                            state: Optional[Any] = None):
    """THE sharded train step: ``step(state, arrays) -> (state, metrics)``
    on this rank's sharded state (``shard_train_state``) and its part of
    the batch (``shard_batch`` of a global batch, or ``sp_block`` of the
    rank's own rows).  It is train.trainer.train_step bound to ``plan``
    (as the JAX package's wraps its make_train_step): the same objective,
    clip and TF1 Adagrad, with the loss and global norm the global
    batch's, the same metrics on every rank, and each rank's params its
    shards of the single-rank step's.  ``donate`` updates in place (the
    JAX package's buffer donation); without it ``state`` is left as it
    was.  ``state`` is accepted for the JAX signature (the port needs no
    probe of the tree)."""
    from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib

    del state
    return functools.partial(trainer_lib.train_step, plan.hps,
                             loss_fn=trainer_lib.make_loss_fn(plan.hps),
                             inplace=donate, plan=plan)


def make_lowp_allreduce_train_step(plan: MeshPlan, donate: bool = True,
                                   state: Optional[Any] = None):
    """DEPRECATED shim (JAX mesh.py:281-303): the unified
    ``make_sharded_train_step`` reads the grad wire dtype from the
    registry (``hps.grad_allreduce_dtype``); this forces it on and
    delegates."""
    warnings.warn(
        "make_lowp_allreduce_train_step is deprecated: the unified "
        "make_sharded_train_step reads the grad wire dtype from the "
        "sharding registry (hps.grad_allreduce_dtype) and supports "
        "dp x tp meshes; call it directly",
        DeprecationWarning, stacklevel=2)
    if plan.hps.grad_allreduce_dtype != "bfloat16":
        hps = plan.hps.replace(grad_allreduce_dtype="bfloat16")
        hps.validate()  # the bf16 wire's refusals (config.py)
        plan = dataclasses.replace(plan, hps=hps)
    return make_sharded_train_step(plan, donate=donate, state=state)


def make_sharded_eval_step(plan: MeshPlan, params: Optional[Any] = None):
    """``eval_step(params, arrays) -> StepMetrics``: the eval forward on
    this rank's sharded params and part of the batch; the losses are the
    global batch's on every rank (global_norm 0).  ``params`` is accepted
    for the JAX signature."""
    from textsummarization_on_flink_tpu_torch.models import get_family
    from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib

    del params
    hps = plan.hps
    family = get_family(hps.model_family)

    @torch.no_grad()
    def eval_step(params, arrays):
        with collectives.bound(plan):
            out = family.forward_train(params, hps, arrays)
        scalars = mean_over_dp(plan, torch.stack(
            [out.loss, out.coverage_loss, out.total_loss]).float())
        return trainer_lib.StepMetrics(
            loss=scalars[0], coverage_loss=scalars[1],
            total_loss=scalars[2], global_norm=torch.zeros_like(scalars[0]))

    return eval_step


def make_sharded_beam_search(plan: MeshPlan, params: Optional[Any] = None):
    """Beam search on the mesh: ``search(params, arrays) ->
    BeamSearchOutput`` of the whole batch, on every rank.  Every rank
    holds the whole batch (``arrays``: host arrays); each dp group
    searches its dp rows with the tp-sharded projection (``params``: this
    rank's sharded tree), and the outputs are all-gathered over dp.
    Beams stay rank-local: the only collectives inside the search are
    tp's (the scores' all-gather, the embedding's and the transformer
    blocks' all-reduces, and the loop test).  The sp ranks of a dp index
    search the same rows and shard the encoder's T as training does
    (JAX mesh.py:377-381): the pointer-generator's attention runs on each
    rank's block of T and merges over sp every step, and the
    transformer's and the AAN's encoder runs its block (its
    self-attention through --sp_attention's ring or Ulysses attention,
    or against the keys all-gathered over sp).  A batch whose T (a serve
    bucket's) sp does not divide is padded with masked positions to the
    next multiple and its attention cut back (GSPMD pads an uneven shard
    so).  A search that raises on one rank raises on every rank
    (``collectives.all_ok``) before the gather."""
    from textsummarization_on_flink_tpu_torch.decode import beam_search

    del params
    hps = plan.hps
    reg = plan.registry

    def search(p, arrays):
        rows = reg.dp_rows({k: arrays[k]
                            for k in sharding_lib.ENC_BATCH_NAMES})
        T = rows["enc_padding_mask"].shape[1]
        pad = -T % plan.sp if reg.shards_t else 0
        if pad:
            rows = {k: (np.pad(np.asarray(x), ((0, 0), (0, pad)))
                        if k != "enc_lens" else x) for k, x in rows.items()}
        err: Optional[BaseException] = None
        try:
            with collectives.bound(plan):
                out = beam_search.run_beam_search(p, hps, rows)
            if pad:
                out = out._replace(attn_dists=np.ascontiguousarray(
                    out.attn_dists[..., :T]))
        except Exception as e:  # noqa: BLE001 - re-raised after the agreement
            err = e
        # a rank that failed tells the others before they wait on it in
        # the gather
        if not collectives.all_ok(plan, err is None):
            raise err if err is not None else RuntimeError(
                "the sharded beam search failed on another rank")
        if plan.dp == 1:
            return out
        return beam_search.BeamSearchOutput(*[
            collectives.all_gather(plan, torch.from_numpy(x), "dp",
                                   0).numpy() for x in out])

    return search
