"""Adagrad + global-norm clipping, exact TF1 semantics.

Port of the JAX package's train/optim.py.  The reference trains with
``tf.train.AdagradOptimizer(lr, initial_accumulator_value=0.1)`` after
``clip_by_global_norm(grads, 2.0)`` (model.py:288-305).  TF1 Adagrad has
no epsilon:

    accum += g^2
    param -= lr * g * rsqrt(accum)

``torch.optim.Adagrad`` is not this update (it adds ``eps`` to
``sqrt(accum)``), so the update is written here by hand.  Unlike the
JAX package's pure functions, it updates the params and accumulators in
place, under ``torch.no_grad``: the step needs no second copy of either.
The clip scale is tf.clip_by_global_norm's,
``min(1, max_norm / max(norm, 1e-30))``.

Trees are the port's nested dicts/lists of tensors (params.py); leaves
pair in ``params.tree_leaves`` order.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

import torch

from textsummarization_on_flink_tpu_torch.params import tree_leaves, tree_map


class AdagradState(NamedTuple):
    accumulators: Any  # a tree of the params' structure


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all leaves, a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(x * x) for x in leaves))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """tf.clip_by_global_norm: scales ``grads`` in place; returns
    (grads, the pre-clip norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-30), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads, norm


def adagrad_init(params: Any, initial_accumulator_value: float,
                 ) -> AdagradState:
    """Accumulators of each param's shape, dtype and device, filled with
    ``initial_accumulator_value``."""
    return AdagradState(accumulators=tree_map(
        lambda p: torch.full_like(p.detach(), initial_accumulator_value),
        params))


@torch.no_grad()
def adagrad_update(grads: List[torch.Tensor], state: AdagradState,
                   params: Any, lr: float) -> AdagradState:
    """One TF1 Adagrad step in place: ``grads`` is the list of gradients
    in ``tree_leaves(params)`` order.  Returns the (same) state."""
    ps = tree_leaves(params)
    accs = tree_leaves(state.accumulators)
    if not (len(ps) == len(accs) == len(grads)):
        raise ValueError(f"{len(ps)} params, {len(accs)} accumulators and "
                         f"{len(grads)} gradients")
    torch._foreach_addcmul_(accs, grads, grads)  # accum += g^2
    torch._foreach_addcmul_(ps, grads, torch._foreach_rsqrt(accs),
                            value=-lr)  # p -= lr * g * rsqrt(accum)
    return state
