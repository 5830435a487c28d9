"""The sharding registry: ONE mesh story for train, eval, decode and
checkpoint (JAX package parallel/sharding.py).

Every tensor role maps HERE, and only here, to a spec over the named
``(dp, tp, sp)`` mesh, plus a wire dtype where a role is reduced over
the mesh.  The roles, the per-leaf rule and the table are the JAX
package's; the specs are the port's own small ``Spec`` type (one mesh
axis name or None per tensor axis), not ``PartitionSpec``, and they are
carried out by hand: ``shard_params`` slices each tp leaf along its
spec's axis, ``gather_params`` rebuilds it with an all-gather,
``shard_batch`` takes the rank's dp rows and, where a path shards the
encoder's time axis, its sp block of T.

Which paths shard T (``shards_t``): every family's at sp > 1, as the
JAX package's ``batch_spec`` gives the encoder arrays ``P("dp", "sp")``
(its sharding.py:128-133).  The pointer-generator's biLSTM runs over the
whole article on every sp rank (its scan is sequential, as in the JAX
package); each rank keeps its block of the encoder states and features,
and the attention's energies, softmax and coverage stay on that block,
merged over sp at every decoder step (ops/fused_attention.py:
merge_sp_blocks).  The transformer's and the AAN's encoder runs its
position-wise layers on the rank's block of T, as the JAX package's
GSPMD partitions them; its self-attention is ring or Ulysses attention
under ``--sp_attention``, and otherwise the rank's block of queries
against every key (k, v and the mask all-gathered over sp, the JAX
einsum's partitioning).

Serving (the JAX package's sharding.py:235-307): the slot engine's
resident ``[slots, ...]`` state shards over dp (slot i lives on dp index
i // (slots / dp), and the tp and sp ranks of that index hold the same
residents); a paged state's pools and the page table are replicated
(each rank holds the whole arena and reads only its residents' pages);
a prefill batch shards over dp when its rows divide dp, and the
one-article prefill replicates.

``analytic_comms`` computes the JAX package's per-step collective-byte
prediction from a copy of the same rule; the sharded trainer's dp
gradient all-reduce moves exactly its ``dp_wire_bytes``
(``parallel/collective_bytes_total{op=all_reduce,axis=dp}``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from textsummarization_on_flink_tpu_torch.config import HParams

PyTree = Any

#: canonical mesh axis order (rank = (d * tp + t) * sp + s)
MESH_AXES = ("dp", "tp", "sp")

#: the train/eval batch array names (the model-family input contract)
BATCH_NAMES = ("enc_batch", "enc_lens", "enc_padding_mask",
               "enc_batch_extend_vocab", "dec_batch", "target_batch",
               "dec_padding_mask")

#: encoder-side names only (the beam-search input contract)
ENC_BATCH_NAMES = ("enc_batch", "enc_lens", "enc_padding_mask",
                   "enc_batch_extend_vocab")

#: every role the registry answers for (``ShardingRegistry.table()``)
ROLES = ("params", "opt_state", "step", "train_batch", "eval_batch",
         "metrics", "grads", "beam_output", "slot_state",
         "prefill_batch", "prefill_state", "arena_pool", "page_table")


class Spec(tuple):
    """One mesh axis name (or None) per tensor axis; ``Spec()`` is
    replicated.  ``Spec("tp", None)`` shards axis 0 over tp."""

    def __new__(cls, *axes: Optional[str]) -> "Spec":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"

    def dim_of(self, axis: str) -> Optional[int]:
        """The tensor axis sharded over mesh ``axis``, or None."""
        return self.index(axis) if axis in self else None


# --------------------------------------------------------------------------
# Spec rules (pure: a role -> Spec)
# --------------------------------------------------------------------------

def param_spec(path: Tuple[Any, ...], leaf: Any = None) -> Spec:
    """The spec of one parameter leaf by its key path (JAX sharding.py:
    91-119).

    Pointer-generator: the vocabulary tensors shard over tp; everything
    else (the LSTMs, the attention, the reduction) is replicated.

    Transformer: the tied [V, H] embedding and the [V] out_bias shard
    over the vocabulary; attention wq/wk/wv and ffn w1/b1 column-shard
    (heads and ffn over tp), wo and ffn w2 row-shard: the Megatron
    layout, one all-reduce on each attention and FFN block's output."""
    keys = tuple(path)
    if "embedding" in keys:
        return Spec("tp", None)
    if "output_projection" in keys:
        if keys[-1] == "w":
            return Spec(None, "tp")
        return Spec("tp")
    if keys[-1] == "out_bias":
        return Spec("tp")
    if keys[-1] in ("wq", "wk", "wv", "w1"):
        return Spec(None, "tp")
    if keys[-1] in ("wo", "w2"):
        return Spec("tp", None)
    if keys[-1] == "b1":
        return Spec("tp")
    return Spec()


#: the attention blocks whose wq/wk/wv columns and wo rows hold heads
ATTENTION_BLOCKS = ("self_attn", "cross_attn")


def head_pad(hps: HParams) -> int:
    """The zero heads each attention block is padded with on a tp mesh:
    num_heads rounded up to a multiple of tp, less num_heads.  Only the
    AAN pads (the transformer refuses a tp that does not divide
    num_heads, as the JAX package does); the JAX package shards the
    AAN's H columns and lets a head straddle ranks, the port keeps whole
    heads on a rank and adds zero ones."""
    if hps.model_family != "avg_attention":
        return 0
    return -hps.num_heads % max(int(hps.tp), 1)


def head_axis(path: Tuple[Any, ...]) -> Optional[int]:
    """The axis of an attention weight that holds heads x head dim (the
    columns of wq/wk/wv, the rows of wo), or None for another leaf."""
    if len(path) < 2 or path[-2] not in ATTENTION_BLOCKS:
        return None
    if path[-1] in ("wq", "wk", "wv"):
        return 1
    return 0 if path[-1] == "wo" else None


def pad_heads(hps: HParams, path: Tuple[Any, ...], x: Any,
              value: float = 0.0) -> Any:
    """``x`` with head_pad(hps) heads of ``value`` appended on its head
    axis (the Megatron layout's real heads first); other leaves, or no
    pad, as they are.  Zero weights give a zero head: its output and
    every gradient of it are exactly 0."""
    pad, dim = head_pad(hps), head_axis(path)
    if not pad or dim is None:
        return x
    width = x.shape[dim] // hps.num_heads * pad
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[dim] = width
        return torch.cat([x, x.new_full(shape, value)], dim=dim)
    x = np.asarray(x)
    widths = [(0, 0)] * x.ndim
    widths[dim] = (0, width)
    return np.pad(x, widths, constant_values=value)


def unpad_heads(hps: HParams, path: Tuple[Any, ...], x: Any) -> Any:
    """The inverse of pad_heads: the real heads of a padded leaf."""
    pad, dim = head_pad(hps), head_axis(path)
    if not pad or dim is None:
        return x
    real = x.shape[dim] // (hps.num_heads + pad) * hps.num_heads
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, 0, real).contiguous()
    return np.take(np.asarray(x), range(real), axis=dim)


def tree_paths(tree: PyTree, prefix: Tuple[Any, ...] = (),
               ) -> Iterator[Tuple[Tuple[Any, ...], Any]]:
    """(key path, leaf) pairs in ``params.tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def param_specs(params: PyTree) -> PyTree:
    """The spec tree of a params tree (grads and the Adagrad accumulators
    share it: same structure, same layout)."""
    return _map_paths(param_spec, params)


def batch_spec(name: str) -> Spec:
    """Batch arrays shard over dp on axis 0; the encoder's
    sequence-major arrays also shard T_enc over sp, on the paths that
    shard T (``shards_t``)."""
    if name in ("enc_batch", "enc_padding_mask", "enc_batch_extend_vocab"):
        return Spec("dp", "sp")
    return Spec("dp")


def state_specs(state: Any) -> Any:
    """Specs of a TrainState: params and accumulators share the params
    rule; the step is replicated."""
    from textsummarization_on_flink_tpu_torch.train import optim, trainer

    return trainer.TrainState(
        params=param_specs(state.params),
        opt_state=optim.AdagradState(
            accumulators=param_specs(state.opt_state.accumulators)),
        step=Spec())


def wire_dtype(hps: HParams, role: str = "grads") -> Optional[torch.dtype]:
    """The dtype a reduced role rides the wire in, or None when the
    reduction stays in the tensor's own dtype."""
    if role == "grads" and hps.grad_allreduce_dtype == "bfloat16":
        return torch.bfloat16
    return None


def shards_t(hps: HParams) -> bool:
    """Whether the path shards the encoder's time axis over sp: every
    family's at sp > 1 (JAX parallel/sharding.py:128-133; the
    pointer-generator's as JAX parallel/mesh.py:17-22 says, the
    transformer's and the AAN's encoder with or without
    --sp_attention)."""
    return hps.sp > 1


def slot_state_specs(state: Any) -> Any:
    """Specs of a slot engine's resident state (beam_search.SlotState or
    PagedSlotState): every slot-leading leaf Spec('dp'); a paged state's
    pools (enc_pages, ext_pool, attn_pool) ``arena_pool_spec()``.  The
    host lengths are slot-leading too."""
    import torch.utils._pytree as pytree

    from textsummarization_on_flink_tpu_torch.decode import beam_search

    def dp(tree):
        return pytree.tree_map(lambda _: Spec("dp"), tree)

    if isinstance(state, beam_search.PagedSlotState):
        return beam_search.PagedSlotState(
            beam=dp(state.beam), enc_rest=dp(state.enc_rest),
            enc_pages=[arena_pool_spec() for _ in state.enc_pages],
            ext_pool=arena_pool_spec(), attn_pool=arena_pool_spec(),
            enc_mask=Spec("dp"), enc_valid_len=Spec("dp"))
    return beam_search.SlotState(
        beam=dp(state.beam), enc_view=dp(state.enc_view),
        enc_mask=Spec("dp"), ext_ids=Spec("dp"), enc_valid_len=Spec("dp"))


def slot_batch_specs() -> Dict[str, Spec]:
    """Encoder arrays stacked over slots: the slots axis over dp; T_enc
    is not sharded (the resident state keeps one width)."""
    return {k: Spec("dp") for k in ENC_BATCH_NAMES}


def prefill_batch_spec(dp: int, rows: int = 1) -> Spec:
    """A prefill batch of ``rows`` articles: over dp when the rows divide
    dp, else replicated (the one-article prefill)."""
    return Spec("dp") if rows >= dp and rows % dp == 0 else Spec()


def arena_pool_spec() -> Spec:
    """The page pools ([pages + 1, block, ...]): replicated."""
    return Spec()


def page_table_spec() -> Spec:
    """The page table ([slots, b_max] ids): replicated."""
    return Spec()


# --------------------------------------------------------------------------
# Registry (mesh-bound: the specs carried out on this rank)
# --------------------------------------------------------------------------

def _slice_dim(x: Any, dim: int, index: int, parts: int) -> Any:
    n = x.shape[dim] // parts
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, index * n, n).contiguous()
    return np.ascontiguousarray(np.take(np.asarray(x),
                                        range(index * n, (index + 1) * n),
                                        axis=dim))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardingRegistry:
    """The mesh-bound registry: every consumer asks THIS object for
    specs, shards and gathers; nothing else decides a layout."""

    plan: Any

    @property
    def hps(self) -> HParams:
        return self.plan.hps

    @property
    def dp(self) -> int:
        return self.plan.dp

    @property
    def tp(self) -> int:
        return self.plan.tp

    @property
    def sp(self) -> int:
        return self.plan.sp

    @property
    def shards_t(self) -> bool:
        return shards_t(self.hps)

    def param_specs(self, params: PyTree) -> PyTree:
        return param_specs(params)

    def state_specs(self, state: Any) -> Any:
        return state_specs(state)

    def batch_spec(self, name: str) -> Spec:
        return batch_spec(name)

    def wire_dtype(self, role: str = "grads") -> Optional[torch.dtype]:
        return wire_dtype(self.hps, role)

    # -- serving --
    def slot_state_specs(self, state: Any) -> Any:
        return slot_state_specs(state)

    def slot_batch_specs(self) -> Dict[str, Spec]:
        return slot_batch_specs()

    def prefill_batch_spec(self, rows: int = 1) -> Spec:
        return prefill_batch_spec(self.dp, rows)

    def prefill_batch_specs(self, rows: int = 1) -> Dict[str, Spec]:
        spec = self.prefill_batch_spec(rows)
        return {k: spec for k in ENC_BATCH_NAMES}

    def prefill_state_specs(self, pre: Any) -> Any:
        """A beam_search.PrefillState's specs: its leaves' leading axis
        takes the prefill batch's rule (the true length is a host int)."""
        import torch.utils._pytree as pytree

        from textsummarization_on_flink_tpu_torch.decode import beam_search

        spec = self.prefill_batch_spec(int(pre.enc_mask.shape[0]))
        return beam_search.PrefillState(
            enc_view=pytree.tree_map(lambda _: spec, pre.enc_view),
            enc_mask=spec, ext_ids=spec, enc_valid_len=Spec())

    def arena_pool_spec(self) -> Spec:
        return arena_pool_spec()

    def page_table_spec(self) -> Spec:
        return page_table_spec()

    # -- params and state --
    def shard_params(self, params: PyTree, pad_value: float = 0.0,
                     ) -> PyTree:
        """This rank's slice of every tp leaf of a full params tree
        (tensors or numpy), the attention weights first padded to whole
        heads on every rank (pad_heads, with ``pad_value``); replicated
        leaves as they are."""
        def shard(path, x):
            dim = param_spec(path).dim_of("tp")
            if dim is None or self.tp == 1:
                return x
            x = pad_heads(self.hps, path, x, pad_value)
            return _slice_dim(x, dim, self.plan.coord("tp"), self.tp)

        return _map_paths(shard, params)

    def gather_params(self, params: PyTree) -> PyTree:
        """The full tree from every tp rank's slices: an all-gather over
        tp of each tp leaf (every rank takes part), the pad heads
        dropped, so the tree has the JAX package's layout."""
        from textsummarization_on_flink_tpu_torch.parallel import (
            collectives,
        )

        def gather(path, x):
            dim = param_spec(path).dim_of("tp")
            if dim is None or self.tp == 1:
                return x
            return unpad_heads(self.hps, path, collectives.all_gather(
                self.plan, x.detach(), "tp", dim))

        return _map_paths(gather, params)

    def shard_state(self, state: Any) -> Any:
        """This rank's TrainState from a full one: params and
        accumulators sliced, params requiring grad.  A pad head's
        accumulators start at adagrad_init_acc: its gradients are 0, so
        Adagrad leaves its weights at 0 (an accumulator of 0 would give
        0 * rsqrt(0))."""
        from textsummarization_on_flink_tpu_torch.train import optim

        params = self.shard_params(state.params)
        for p in _leaves(params):
            if isinstance(p, torch.Tensor) and not p.requires_grad:
                p.requires_grad_(True)
        return state._replace(params=params, opt_state=optim.AdagradState(
            accumulators=self.shard_params(state.opt_state.accumulators,
                                           self.hps.adagrad_init_acc)))

    def gather_state(self, state: Any) -> Any:
        """The full TrainState (collective over tp)."""
        from textsummarization_on_flink_tpu_torch.train import optim

        return state._replace(
            params=self.gather_params(state.params),
            opt_state=optim.AdagradState(accumulators=self.gather_params(
                state.opt_state.accumulators)))

    # -- batches --
    def dp_rows(self, arrays: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's dp rows of a global batch."""
        if self.dp == 1:
            return dict(arrays)
        d = self.plan.coord("dp")
        return {k: _slice_dim(v, 0, d, self.dp) for k, v in arrays.items()}

    def sp_block(self, arrays: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's sp block of T of the sequence-major encoder arrays,
        on a path that shards T; the arrays as they are otherwise."""
        if not self.shards_t:
            return dict(arrays)
        s = self.plan.coord("sp")
        return {k: (_slice_dim(v, 1, s, self.sp)
                    if batch_spec(k).dim_of("sp") is not None else v)
                for k, v in arrays.items()}

    def shard_batch(self, arrays: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's part of a global batch: its dp rows, and its sp
        block of T where the path shards T."""
        return self.sp_block(self.dp_rows(arrays))

    # -- documentation --
    def table(self) -> List[Dict[str, str]]:
        """The role -> spec -> wire-dtype table (tests assert it covers
        ROLES)."""
        w = self.hps.grad_allreduce_dtype
        return [
            {"role": "params", "spec": "per-leaf rule (vocab/heads over "
                                       "tp, else replicated)", "wire": "-"},
            {"role": "opt_state", "spec": "same tree rule as params",
             "wire": "-"},
            {"role": "step", "spec": "Spec()", "wire": "-"},
            {"role": "train_batch",
             "spec": "Spec('dp'[, 'sp' where the path shards T])",
             "wire": "-"},
            {"role": "eval_batch", "spec": "same as train_batch",
             "wire": "-"},
            {"role": "metrics", "spec": "Spec(): all-gathered over dp, "
                                        "averaged", "wire": "-"},
            {"role": "grads", "spec": "same tree rule as params; summed "
                                      "over sp where T is sharded, "
                                      "averaged over dp", "wire": w},
            {"role": "beam_output", "spec": "Spec('dp'): each dp group "
                                            "searches its rows, "
                                            "all-gathered", "wire": "-"},
            {"role": "slot_state",
             "spec": "Spec('dp'): slot i on dp index i // (slots/dp); a "
                     "paged state's pools arena_pool", "wire": "-"},
            {"role": "prefill_batch",
             "spec": "Spec('dp') when the prefill batch divides dp, else "
                     "Spec()", "wire": "-"},
            {"role": "prefill_state", "spec": "same leading-axis rule as "
                                              "prefill_batch", "wire": "-"},
            {"role": "arena_pool",
             "spec": "Spec(): the [pages+1, block, ...] pools replicate; "
                     "each rank reads its own residents' pages",
             "wire": "-"},
            {"role": "page_table",
             "spec": "Spec(): the [slots, b_max] ids replicate",
             "wire": "-"},
        ]


def _leaves(tree: PyTree) -> List[Any]:
    return [x for _, x in tree_paths(tree)]


def _map_paths(fn, tree: PyTree, prefix: Tuple[Any, ...] = ()) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_paths(fn, v, prefix + (i,)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


# --------------------------------------------------------------------------
# Analytic comms accounting (the CPU-verifiable wire-byte claims)
# --------------------------------------------------------------------------

def analytic_comms(hps: HParams, params: Optional[PyTree] = None) -> dict:
    """Per-step collective-byte prediction from the specs alone (JAX
    sharding.py:391-443, the same numbers).

    Returns::

      param_elements     total parameter scalars
      dp_grad_elements   per-rank elements the dp gradient all-reduce
                         moves each step: tp-sharded leaves count their
                         shard, replicated leaves their full size
      dp_wire_bytes      dp_grad_elements x the wire dtype's size: 43.0
                         MB at reference scale under the bf16 wire, 86.0
                         in f32
      wire_dtype         the grad wire dtype's name
      tp_scores_bytes    the per-step [T_dec, B, V_ext] scores-shaped
                         all-gather at the compute dtype (0 when tp == 1)

    The port's dp_grad_elements count the pad heads' zero gradients (the
    AAN on a tp that does not divide num_heads, pad_heads), which its
    wire carries and the JAX package's count has not: dp_wire_bytes is
    then JAX's plus ``head_pad_elements(hps, params)`` x the wire size.
    ``params`` (numpy or tensors) gives the shapes; None builds a fresh
    tree at ``hps.vocab_size``."""
    params = _shapes_tree(hps, params)
    tp = max(int(hps.tp), 1)
    total = 0
    dp_elems = 0
    for path, leaf in tree_paths(params):
        elems = _elements(leaf)
        total += elems
        spec = param_spec(path, leaf)
        dp_elems += _padded(hps, path, elems) // tp if "tp" in spec \
            else elems
    wire = hps.grad_allreduce_dtype
    wire_size = 2 if wire == "bfloat16" else 4
    compute_size = 2 if hps.compute_dtype == "bfloat16" else 4
    scores = (hps.max_dec_steps * hps.batch_size
              * (hps.vocab_size + hps.max_oov_buckets) * compute_size
              if tp > 1 else 0)
    return {
        "param_elements": total,
        "dp_grad_elements": dp_elems,
        "dp_wire_bytes": dp_elems * wire_size,
        "wire_dtype": wire,
        "tp_scores_bytes": scores,
    }


def head_pad_elements(hps: HParams, params: Optional[PyTree] = None,
                      ) -> int:
    """Of ``analytic_comms``' dp_grad_elements, the pad heads' (0 unless
    head_pad(hps)): per rank, each padded attention weight's shard less
    its unpadded share."""
    params = _shapes_tree(hps, params)
    tp = max(int(hps.tp), 1)
    return sum(_padded(hps, path, _elements(leaf)) // tp
               - _elements(leaf) // tp
               for path, leaf in tree_paths(params)
               if "tp" in param_spec(path, leaf))


def _shapes_tree(hps: HParams, params: Optional[PyTree]) -> PyTree:
    if params is not None:
        return params
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params

    return init_numpy_params(hps, hps.vocab_size, 0)


def _elements(leaf: Any) -> int:
    return int(np.prod(leaf.shape)) if leaf.shape else 1


def _padded(hps: HParams, path: Tuple[Any, ...], elems: int) -> int:
    """A leaf's elements after pad_heads."""
    if head_axis(path) is None or not head_pad(hps):
        return elems
    return elems // hps.num_heads * (hps.num_heads + head_pad(hps))

