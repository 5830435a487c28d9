"""Model families of the port.

Every family is a module with the JAX package's functional surface
(models/__init__.py there): ``beam_encode(params, hps, arrays)`` and
``beam_adapter(hps) -> (init_state, step)`` for beam search, its
length-bounded form ``beam_adapter_masked`` and ``pad_enc_view`` for
the slot engine, and
``forward_train(params, hps, arrays) -> TrainOutput`` for training and
eval.  All three families decode and train: the pointer-generator, the
transformer and the average-attention (AAN) family, the speculative
tier's draft, which also runs as a model of its own.
"""

from __future__ import annotations

from types import ModuleType

FAMILIES = ("pointer_generator", "transformer", "avg_attention")


def masked_adapter(beam_adapter_fn):
    """A family's ``beam_adapter_masked`` from its ``beam_adapter`` (JAX
    models/__init__.py:31-50): the same step with a leading ``nb``
    argument, the number of encoder blocks that hold every active
    resident (a host int here), which the slot engine's step binds from
    its residents' lengths."""

    def beam_adapter_masked(hps):
        init_state, step = beam_adapter_fn(hps)

        def step_masked(params, enc, enc_mask, ext_ids, nb, t, latest,
                        state):
            return step(params, enc, enc_mask, ext_ids, t, latest, state,
                        nb=nb)

        return init_state, step_masked

    return beam_adapter_masked


def get_family(name: str) -> ModuleType:
    """Resolve a model-family name to its module."""
    if name == "pointer_generator":
        from textsummarization_on_flink_tpu_torch.models import pointer_generator
        return pointer_generator
    if name == "transformer":
        from textsummarization_on_flink_tpu_torch.models import transformer
        return transformer
    if name == "avg_attention":
        from textsummarization_on_flink_tpu_torch.models import avg_attention
        return avg_attention
    raise ValueError(
        f"unknown model_family {name!r}; expected one of {FAMILIES}")
