"""The port's parameters: a nested dict of tensors with the JAX tree's names.

``from_numpy_tree`` takes the JAX package's params as numpy (for example
``jax.device_get(init_params(...))``, or the ``params`` subtree of an
unflattened checkpoint) and returns the port's tree on a device
(checkpoint/checkpointer.py writes tensors back as numpy).
``tree_leaves`` and ``tree_map`` walk a tree in the order
``jax.tree_util`` does (dict keys sorted, lists in order), so sums over
leaves (the global gradient norm) add in the JAX package's order and
two trees of one structure pair leaf by leaf.  ``init_params`` builds a
fresh tree of the same names and shapes as the family's ``init_params``
(``models/pointer_generator.py`` :88-133, ``models/transformer.py``
:73-125, ``models/avg_attention.py`` :107-157; ``hps.model_family``
picks) with the same initializer families, drawn with numpy from a
seed.  The values differ from the JAX package's for the same seed (jax.random and
numpy are different generators); tests that compare the two packages
hand both the same numpy tree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from textsummarization_on_flink_tpu_torch.config import HParams

Params = Dict[str, Any]


def from_numpy_tree(tree: Any, device: Any = "cpu",
                    dtype: torch.dtype = torch.float32) -> Any:
    """Nested dict/list of array-likes (numpy arrays, or tensors already)
    -> the same structure of tensors on ``device``; floating leaves
    become ``dtype``, integer leaves keep their type."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy_tree(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=dtype
                       if tree.dtype.is_floating_point else tree.dtype)
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.kind == "V":  # V: a bf16 leaf
        arr = arr.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict/list, dict keys sorted (the order of
    jax.tree_util.tree_leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """fn over the leaves of one or more trees of the same structure;
    the result has the first tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _trunc_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    """std * truncated normal on [-2, 2] (jax.random.truncated_normal's
    law), by resampling the draws that fall outside."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return (std * x).astype(np.float32)


def _uniform(rng: np.random.Generator, shape, mag: float) -> np.ndarray:
    return rng.uniform(-mag, mag, shape).astype(np.float32)


def _glorot(rng: np.random.Generator, shape) -> np.ndarray:
    if len(shape) == 1:
        fan_in = fan_out = shape[0]
    else:
        fan_in, fan_out = shape[-2], shape[-1]
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def init_numpy_params(hps: HParams, vsize: int, seed: int) -> Params:
    """The params of ``hps.model_family`` as numpy."""
    if hps.model_family == "transformer":
        return _transformer_numpy_params(hps, vsize, seed)
    if hps.model_family == "avg_attention":
        return aan_numpy_params(hps, vsize, np.random.default_rng(seed))
    return _pointer_generator_numpy_params(hps, vsize, seed)


def _pointer_generator_numpy_params(hps: HParams, vsize: int,
                                    seed: int) -> Params:
    """Names and shapes of pointer_generator.py:88-133 (initializers
    after the reference's model.py:204-231)."""
    rng = np.random.default_rng(seed)
    H, E = hps.hidden_dim, hps.emb_dim
    D = 2 * H  # attention vector size == encoder state size
    tn = hps.trunc_norm_init_std
    mag = hps.rand_unif_init_mag
    zeros = lambda n: np.zeros((n,), np.float32)  # noqa: E731
    return {
        "embedding": _trunc_normal(rng, (vsize, E), tn),
        "encoder": {
            "fw": {"kernel": _uniform(rng, (E + H, 4 * H), mag),
                   "bias": zeros(4 * H)},
            "bw": {"kernel": _uniform(rng, (E + H, 4 * H), mag),
                   "bias": zeros(4 * H)},
        },
        "reduce": {
            "w_reduce_c": _trunc_normal(rng, (2 * H, H), tn),
            "w_reduce_h": _trunc_normal(rng, (2 * H, H), tn),
            "bias_reduce_c": _trunc_normal(rng, (H,), tn),
            "bias_reduce_h": _trunc_normal(rng, (H,), tn),
        },
        "decoder": {
            "cell": {"kernel": _uniform(rng, (E + H, 4 * H), mag),
                     "bias": zeros(4 * H)},
            "attention": {
                "W_h": _glorot(rng, (D, D)),
                "v": _glorot(rng, (D,)),
                "w_c": _glorot(rng, (D,)),
                "linear_kernel": _glorot(rng, (2 * H, D)),
                "linear_bias": zeros(D),
            },
            "input_linear": {"kernel": _glorot(rng, (E + D, E)),
                             "bias": zeros(E)},
            "pgen_linear": {"kernel": _glorot(rng, (D + H + H + E, 1)),
                            "bias": zeros(1)},
            "output_linear": {"kernel": _glorot(rng, (H + D, H)),
                              "bias": zeros(H)},
        },
        "output_projection": {
            "w": _trunc_normal(rng, (H, vsize), tn),
            "v": _trunc_normal(rng, (vsize,), tn),
        },
    }


def ln_params(H: int) -> Params:
    """A LayerNorm's unit scale and zero bias."""
    return {"scale": np.ones((H,), np.float32),
            "bias": np.zeros((H,), np.float32)}


def ffn_params(rng: np.random.Generator, H: int, F: int) -> Params:
    return {"w1": _glorot(rng, (H, F)), "b1": np.zeros((F,), np.float32),
            "w2": _glorot(rng, (F, H)), "b2": np.zeros((H,), np.float32)}


def attn_params(rng: np.random.Generator, H_in: int, H: int) -> Params:
    """Attention projections; wk and wv read an H_in-wide input (the
    narrow AAN draft's cross-attention over the H-wide encoder)."""
    return {"wq": _glorot(rng, (H, H)), "wk": _glorot(rng, (H_in, H)),
            "wv": _glorot(rng, (H_in, H)), "wo": _glorot(rng, (H, H))}


def _encoder_numpy_params(rng: np.random.Generator, hps: HParams) -> Params:
    H, F = hps.hidden_dim, hps.ffn_width
    layers = [{"ln1": ln_params(H), "self_attn": attn_params(rng, H, H),
               "ln2": ln_params(H), "ffn": ffn_params(rng, H, F)}
              for _ in range(hps.enc_layers)]
    return {"layers": layers, "ln_out": ln_params(H)}


def _embeddings(rng: np.random.Generator, hps: HParams, vsize: int) -> Params:
    H = hps.hidden_dim
    return {
        "embedding": _trunc_normal(rng, (vsize, H), 0.02),
        "pos_enc": _trunc_normal(rng, (hps.max_enc_steps, H), 0.02),
        "pos_dec": _trunc_normal(rng, (hps.max_dec_steps + 1, H), 0.02),
    }


def _transformer_numpy_params(hps: HParams, vsize: int,
                              seed: int) -> Params:
    """Names, shapes and initializer families of transformer.py:73-125:
    glorot-uniform projections, truncated-normal (std 0.02) embeddings,
    unit LayerNorm scales, zero biases.  Layers are plain lists."""
    rng = np.random.default_rng(seed)
    H, F = hps.hidden_dim, hps.ffn_width
    encoder = _encoder_numpy_params(rng, hps)
    dec_layers = [{"ln1": ln_params(H), "self_attn": attn_params(rng, H, H),
                   "ln_cross": ln_params(H),
                   "cross_attn": attn_params(rng, H, H),
                   "ln2": ln_params(H), "ffn": ffn_params(rng, H, F)}
                  for _ in range(hps.dec_layers)]
    return {
        **_embeddings(rng, hps, vsize),
        "encoder": encoder,
        "decoder": {"layers": dec_layers, "ln_out": ln_params(H)},
        "pgen_linear": {"kernel": _glorot(rng, (2 * H, 1)),
                        "bias": np.zeros((1,), np.float32)},
        "out_bias": np.zeros((vsize,), np.float32),
    }


def aan_layer_params(rng: np.random.Generator, H_in: int, H: int,
                     F: int) -> Params:
    """One AAN decoder layer at width H (avg_attention.py:85-99): the
    average branch's FFN and its 2H -> 2H input/forget gate, then the
    cross-attention (K/V from the H_in-wide encoder) and the FFN."""
    return {
        "ln1": ln_params(H),
        "aan_ffn": ffn_params(rng, H, F),
        "aan_gate": {"kernel": _glorot(rng, (2 * H, 2 * H)),
                     "bias": np.zeros((2 * H,), np.float32)},
        "ln_cross": ln_params(H),
        "cross_attn": attn_params(rng, H_in, H),
        "ln2": ln_params(H),
        "ffn": ffn_params(rng, H, F),
    }


def aan_numpy_params(hps: HParams, vsize: int,
                     rng: np.random.Generator) -> Params:
    """Names and shapes of avg_attention.py:107-157: the transformer's
    H-wide embeddings, positions and encoder, a decoder of AAN layers at
    the draft width H_d (``draft_hidden``, or H), and for a narrow draft
    the [H, H_d] ``emb_proj``; with ``draft_vocab_rank`` r the factored
    ``vocab_head`` (w1 [H_d, r], w2 [r, V])."""
    H = hps.hidden_dim
    Hd = hps.draft_hidden or H
    Fd = hps.ffn_dim or 4 * Hd
    params = {
        **_embeddings(rng, hps, vsize),
        "encoder": _encoder_numpy_params(rng, hps),
        "decoder": {"layers": [aan_layer_params(rng, H, Hd, Fd)
                               for _ in range(hps.dec_layers)],
                    "ln_out": ln_params(Hd)},
        "pgen_linear": {"kernel": _glorot(rng, (2 * Hd, 1)),
                        "bias": np.zeros((1,), np.float32)},
        "out_bias": np.zeros((vsize,), np.float32),
    }
    if Hd != H:
        params["emb_proj"] = {"kernel": _glorot(rng, (H, Hd))}
    if hps.draft_vocab_rank:
        params["vocab_head"] = {
            "w1": _glorot(rng, (Hd, hps.draft_vocab_rank)),
            "w2": _glorot(rng, (hps.draft_vocab_rank, vsize))}
    return params


def add_coverage_params(params: Params, seed: int) -> Params:
    """A copy of the pointer-generator ``params`` (leaves shared, dicts
    new) with a fresh glorot ``decoder/attention/w_c`` for coverage
    conversion (JAX pointer_generator.py:136-141;
    run_summarization.py:157-178).  Drawn with numpy from ``seed``: the
    law is the JAX package's, the bits cannot be jax.random's."""
    new = tree_map(lambda x: x, params)
    D = np.shape(new["decoder"]["attention"]["W_h"])[0]
    new["decoder"]["attention"]["w_c"] = _glorot(np.random.default_rng(seed),
                                                 (D,))
    return new


def init_params(hps: HParams, vsize: int, seed: int,
                device: Any = "cpu") -> Params:
    """A fresh params tree on ``device`` (see init_numpy_params)."""
    return from_numpy_tree(init_numpy_params(hps, vsize, seed), device)
