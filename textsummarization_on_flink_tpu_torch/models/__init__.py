"""Model families of the port.

Every family is a module with the JAX package's functional surface
(models/__init__.py there): ``beam_encode(params, hps, arrays)`` and
``beam_adapter(hps) -> (init_state, step)`` for beam search, and
``forward_train(params, hps, arrays) -> TrainOutput`` for training and
eval.  Both families decode and train.  The AAN draft is not ported
yet.
"""

from __future__ import annotations

from types import ModuleType

from textsummarization_on_flink_tpu_torch.config import ROADMAP_AAN

FAMILIES = ("pointer_generator", "transformer", "avg_attention")

_ROADMAP = {"avg_attention": ROADMAP_AAN}


def get_family(name: str) -> ModuleType:
    """Resolve a model-family name to its module."""
    if name == "pointer_generator":
        from textsummarization_on_flink_tpu_torch.models import pointer_generator
        return pointer_generator
    if name == "transformer":
        from textsummarization_on_flink_tpu_torch.models import transformer
        return transformer
    if name in _ROADMAP:
        raise NotImplementedError(
            f"model_family {name!r} is not ported to PyTorch yet: "
            f"{_ROADMAP[name]}")
    raise ValueError(
        f"unknown model_family {name!r}; expected one of {FAMILIES}")
