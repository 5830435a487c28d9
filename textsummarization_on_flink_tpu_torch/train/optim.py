"""Adagrad + global-norm clipping, exact TF1 semantics.

Port of the JAX package's train/optim.py.  The reference trains with
``tf.train.AdagradOptimizer(lr, initial_accumulator_value=0.1)`` after
``clip_by_global_norm(grads, 2.0)`` (model.py:288-305).  TF1 Adagrad has
no epsilon:

    accum += g^2
    param -= lr * g * rsqrt(accum)

``torch.optim.Adagrad`` is not this update (it adds ``eps`` to
``sqrt(accum)``), so the update is written here by hand.  Unlike the
JAX package's pure functions, ``adagrad_update`` updates the params and
accumulators in place, under ``torch.no_grad``: the step needs no second
copy of either.  ``adagrad_step`` is the same update out of place, for a
caller that must keep the pre-step state (divergence recovery).  The
clip scale is tf.clip_by_global_norm's,
``min(1, max_norm / max(norm, 1e-30))``.

Storage-dtype-aware (JAX train/optim.py:43-76): accumulators may be
stored in bf16 (``--opt_state_dtype=bfloat16``); the update widens each
to its param's dtype (f32), adds g^2, takes the rsqrt and applies it in
f32, then rounds the accumulator back to its storage dtype.  With f32
accumulators the update is the f32 formula above, unchanged.

Trees are the port's nested dicts/lists of tensors (params.py); leaves
pair in ``params.tree_leaves`` order.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from textsummarization_on_flink_tpu_torch.params import tree_leaves, tree_map


class AdagradState(NamedTuple):
    accumulators: Any  # a tree of the params' structure


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all leaves, a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(x * x) for x in leaves))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None,
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """tf.clip_by_global_norm: scales ``grads`` in place; returns
    (grads, the pre-clip norm).  ``norm``: the norm when the caller has
    it (on a mesh, the full gradient's; ``global_norm(grads)`` if None)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-30), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads, norm


def adagrad_init(params: Any, initial_accumulator_value: float,
                 dtype: Optional[torch.dtype] = None) -> AdagradState:
    """Accumulators of each param's shape and device, filled with
    ``initial_accumulator_value``, in ``dtype`` (None: the param's)."""
    return AdagradState(accumulators=tree_map(
        lambda p: torch.full_like(p.detach(), initial_accumulator_value,
                                  dtype=dtype or p.dtype), params))


def _leaves(grads, state, params):
    ps = tree_leaves(params)
    accs = tree_leaves(state.accumulators)
    if not (len(ps) == len(accs) == len(grads)):
        raise ValueError(f"{len(ps)} params, {len(accs)} accumulators and "
                         f"{len(grads)} gradients")
    return ps, accs


def _apply(grads: List[torch.Tensor], ps: List[torch.Tensor],
           accs: List[torch.Tensor], lr: float,
           ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The update on leaf lists, in place: accumulators widened to their
    param's dtype when stored narrower, a += g^2, p -= lr * g * rsqrt(a),
    the accumulator rounded back to its storage dtype.  Returns (ps,
    accs)."""
    same = all(a.dtype == p.dtype for a, p in zip(accs, ps))
    wide = accs if same else [a.to(p.dtype) for a, p in zip(accs, ps)]
    torch._foreach_addcmul_(wide, grads, grads)  # accum += g^2
    torch._foreach_addcmul_(ps, grads, torch._foreach_rsqrt(wide),
                            value=-lr)  # p -= lr * g * rsqrt(accum)
    if not same:
        for a, w in zip(accs, wide):
            a.copy_(w)  # rounds to the storage dtype
    return ps, accs


@torch.no_grad()
def adagrad_update(grads: List[torch.Tensor], state: AdagradState,
                   params: Any, lr: float) -> AdagradState:
    """One TF1 Adagrad step in place: ``grads`` is the list of gradients
    in ``tree_leaves(params)`` order.  Returns the (same) state."""
    _apply(grads, *_leaves(grads, state, params), lr)
    return state


@torch.no_grad()
def adagrad_step(grads: List[torch.Tensor], state: AdagradState,
                 params: Any, lr: float) -> Tuple[Any, AdagradState]:
    """``adagrad_update`` out of place: (new params, new state), new
    tensors with the arithmetic of the in-place update; ``params`` and
    ``state`` are left as they were.  The new params require grad."""
    ps, accs = _leaves(grads, state, params)
    new_ps, new_accs = _apply(grads, [p.detach().clone() for p in ps],
                              [a.clone() for a in accs], lr)
    new = {id(old): t for old, t in zip(ps + accs, new_ps + new_accs)}
    return (tree_map(lambda p: new[id(p)].requires_grad_(True), params),
            AdagradState(accumulators=tree_map(lambda a: new[id(a)],
                                               state.accumulators)))
