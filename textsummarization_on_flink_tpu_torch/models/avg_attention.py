"""Average-attention (AAN) decoder family: the speculative tier's draft.

Port of the JAX package's models/avg_attention.py (after *Accelerating
Neural Transformer via an Average Attention Network*): the decoder's
self-attention becomes a cumulative average, position t summarizing its
prefix as the running mean of the layer inputs, passed through an FFN
and merged with the current input by a learned input/forget gate.  The
decode step carries one running f32 sum per layer, [B, K, L, H_d], in
place of a KV cache, so its cost and state do not grow with the history.

Everything else is the transformer family's: the encoder stack (its
self-attention through the flash kernels on the card), the per-layer
cross-attention and copy distribution, the decode output tail and the
loss head (``transformer.train_output_tail``), the encoder view and its
padding for the slot engine.  Param names match the transformer's where
the leaves are shared.

The NARROW variant (``draft_hidden`` H_d < H) runs the decoder blocks at
width H_d against the H-wide embedding and encoder through an [H, H_d]
``emb_proj`` on the decoder inputs and [H, H_d] cross-attention K/V maps,
and scores the vocabulary through the factored ``vocab_head``
(``draft_vocab_rank`` r: (h @ [H_d, r]) @ [r, V]).  It is trained by
sequence-level distillation (train/distill.py).

On a mesh the family runs the transformer's layout (parallel/sharding.py's
per-leaf rule, JAX sharding.py:91-119): the tied embedding and out_bias
over the vocabulary, the cross_attn heads and both FFNs (aan_ffn, ffn)
Megatron-style, the encoder on its sp block of T (the transformer's
encoder: ring or Ulysses attention under --sp_attention, else the
block's queries against the keys gathered over sp).  The narrow variant's factored head shards its rank r
over tp (w1 column-, w2 row-parallel), so its scores are a sum over tp
of rank-partial products (transformer.vocab_scores_of).  Where tp does
not divide num_heads (the JAX package lets a head straddle ranks) the
heads are padded with zero ones to a multiple of tp
(sharding.pad_heads): each rank runs ceil(num_heads / tp) whole heads,
a zero head adds exactly 0 and gets zero gradients, and the head mean
of the copy distribution counts the real heads only
(collectives.head_mean).

Two inits: ``init_params`` (fresh, from a numpy seed) and
``init_from_transformer`` (the mapped draft: the full transformer's
shared leaves copied, the AAN branch fresh, every key accounted for).
``forward_train`` computes the prefix mean with an f32 ``cumsum``, the
decode step with a running f32 sum: training and decoding agree to a
tight tolerance, not bitwise.  Every beam loop drives the same step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from textsummarization_on_flink_tpu_torch.config import (
    HParams,
    derive_draft_hps,
    resolve_draft_hidden,
)
from textsummarization_on_flink_tpu_torch.models import masked_adapter
from textsummarization_on_flink_tpu_torch.models import pointer_generator as pg
from textsummarization_on_flink_tpu_torch.models import transformer as tf
from textsummarization_on_flink_tpu_torch import params as params_lib

Params = Dict[str, Any]

TrainOutput = pg.TrainOutput
BeamStepOut = pg.BeamStepOut
TransformerEncView = tf.TransformerEncView


def _decoder_hps(hps: HParams) -> HParams:
    """HParams of the decoder-side blocks (avg_attention.py:72-83):
    hidden_dim is the draft width H_d and the FFN width follows it
    (4 * H_d when ffn_dim is 0); the identity at equal width."""
    Hd = resolve_draft_hidden(hps)
    if Hd == hps.hidden_dim:
        return hps
    return hps.replace(hidden_dim=Hd, ffn_dim=hps.ffn_dim or 4 * Hd)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def init_params(hps: HParams, vsize: int, seed: int) -> Params:
    """A fresh numpy params tree of the family (avg_attention.py:107-157),
    drawn from ``seed`` with numpy (params.aan_numpy_params)."""
    return params_lib.aan_numpy_params(hps, vsize,
                                       np.random.default_rng(seed))


#: decoder-layer leaves copied from the mapped full-model layer; the
#: strict check below holds every draft leaf to this list or _FRESH_KEYS
_MAPPED_LAYER_KEYS = ("ln1", "ln_cross", "cross_attn", "ln2", "ffn")
#: family-specific leaves with no full-model counterpart: fresh
_FRESH_KEYS = ("aan_ffn", "aan_gate")


def draft_layer_indices(full_layers: int, draft_layers: int) -> List[int]:
    """The evenly strided subset of the full model's decoder layers the
    mapped draft keeps (avg_attention.py:168-177): the last alone for one
    layer, first and last included from two."""
    if draft_layers >= full_layers:
        return list(range(full_layers))
    if draft_layers == 1:
        return [full_layers - 1]
    step = (full_layers - 1) / (draft_layers - 1)
    return sorted({round(i * step) for i in range(draft_layers)})


def init_from_transformer(full_params: Params, full_hps: HParams,
                          draft_hps: HParams, seed: int) -> Params:
    """The mapped draft of a full transformer (avg_attention.py:180-283):
    embedding, positions, the whole encoder and out_bias copied (the
    tree shares the full model's leaves); at equal width also pgen_linear,
    the decoder's ln_out and, for each of ``draft_hps.dec_layers``
    evenly strided layers, ln1/ln_cross/cross_attn/ln2/ffn.  Fresh
    (numpy, from ``seed``): aan_ffn and aan_gate; at a narrow width the
    whole H_d-wide decoder side (blocks, boundary projections, pgen, ln);
    the factored head whenever ``draft_vocab_rank`` > 0."""
    if full_hps.model_family != "transformer":
        raise ValueError(
            f"init_from_transformer maps transformer checkpoints only, "
            f"got model_family={full_hps.model_family!r} (use fresh init "
            f"or a separately trained draft for other families)")
    if draft_hps.hidden_dim != full_hps.hidden_dim:
        raise ValueError(
            f"mapped draft must share hidden_dim with the full model "
            f"(draft {draft_hps.hidden_dim} vs full {full_hps.hidden_dim})")
    rng = np.random.default_rng(seed)
    H = draft_hps.hidden_dim
    dhps = _decoder_hps(draft_hps)
    Hd, Fd = dhps.hidden_dim, dhps.ffn_width
    keep = draft_layer_indices(full_hps.dec_layers, draft_hps.dec_layers)
    dec_layers = []
    for src_idx in keep:
        src = full_params["decoder"]["layers"][src_idx]
        layer = params_lib.aan_layer_params(rng, H, Hd, Fd)
        if Hd == H:
            for k in _MAPPED_LAYER_KEYS:
                layer[k] = src[k]
        unknown = set(layer) - set(_MAPPED_LAYER_KEYS) - set(_FRESH_KEYS)
        if unknown:
            raise KeyError(f"unmapped draft layer keys: {sorted(unknown)}")
        dec_layers.append(layer)
    params = {k: full_params[k] for k in ("embedding", "pos_enc", "pos_dec",
                                          "encoder", "out_bias")}
    if Hd == H:
        params["decoder"] = {"layers": dec_layers,
                             "ln_out": full_params["decoder"]["ln_out"]}
        params["pgen_linear"] = full_params["pgen_linear"]
    else:
        params["decoder"] = {"layers": dec_layers,
                             "ln_out": params_lib.ln_params(Hd)}
        params["pgen_linear"] = {
            "kernel": params_lib._glorot(rng, (2 * Hd, 1)),
            "bias": np.zeros((1,), np.float32)}
        params["emb_proj"] = {"kernel": params_lib._glorot(rng, (H, Hd))}
    rank = draft_hps.draft_vocab_rank
    if rank:
        vsize = full_params["out_bias"].shape[0]
        params["vocab_head"] = {"w1": params_lib._glorot(rng, (Hd, rank)),
                                "w2": params_lib._glorot(rng, (rank, vsize))}
    return params


def make_draft_params(hps: HParams, full_params: Params,
                      seed: int = 0) -> Params:
    """``hps.spec_draft`` resolved to the draft's params, on the device of
    ``full_params`` (avg_attention.py:286-302): "map" is
    ``init_from_transformer``, "fresh" ``init_params``.  The decoder and
    the scripts build drafts only through here."""
    dhps = derive_draft_hps(hps)
    if hps.spec_draft == "map":
        tree = init_from_transformer(full_params, hps, dhps, seed)
    elif hps.spec_draft == "fresh":
        tree = init_params(dhps, hps.vocab_size, seed)
    else:
        raise ValueError(
            f"make_draft_params needs spec_draft='map'|'fresh', got "
            f"{hps.spec_draft!r}")
    emb = full_params["embedding"]
    device = emb.device if isinstance(emb, torch.Tensor) else "cpu"
    return params_lib.from_numpy_tree(tree, device)


# --------------------------------------------------------------------------
# The cumulative-average block
# --------------------------------------------------------------------------

def _aan_gate(layer: Dict[str, Any], x_norm: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """i, f = sigmoid(W [x; g]); i * x + f * g, in x's dtype
    (avg_attention.py:309-318)."""
    dt = x_norm.dtype
    H = x_norm.shape[-1]
    gate = layer["aan_gate"]
    gates = torch.sigmoid(torch.cat([x_norm, g], dim=-1)
                          @ gate["kernel"].to(dt) + gate["bias"].to(dt))
    return gates[..., :H] * x_norm + gates[..., H:] * g


def _aan_block_train(layer: Dict[str, Any],
                     x_norm: torch.Tensor) -> torch.Tensor:
    """The average branch over the time axis (-2): the prefix mean by one
    f32 cumsum, the FFN, the gate (avg_attention.py:321-331)."""
    T = x_norm.shape[-2]
    csum = torch.cumsum(x_norm.float(), dim=-2)
    denom = (torch.arange(T, dtype=torch.float32, device=x_norm.device)
             + 1.0)[:, None]
    avg = (csum / denom).to(x_norm.dtype)
    g = tf._ffn_block(layer["aan_ffn"], avg)
    return _aan_gate(layer, x_norm, g)


def _emb_proj(params: Params, y: torch.Tensor) -> torch.Tensor:
    """The narrow draft's [H, H_d] decoder-input projection (identity at
    equal width)."""
    ep = params.get("emb_proj")
    if ep is not None:
        y = y @ ep["kernel"].to(y.dtype)
    return y


# --------------------------------------------------------------------------
# Training forward (parallel over decode steps)
# --------------------------------------------------------------------------

def forward_train(params: Params, hps: HParams,
                  arrays: Dict[str, torch.Tensor]) -> TrainOutput:
    """Teacher-forced forward through the transformer's loss head
    (avg_attention.py:354-389): the encoder stack, then each AAN layer's
    average branch, cross-attention (the narrow draft's rectangular K/V
    over the H-wide encoder output) and FFN at the decoder width."""
    dhps = _decoder_hps(hps)
    enc_out, arrays = tf.encode_train(params, hps, arrays)
    enc_mask = arrays["enc_padding_mask"]
    y = _emb_proj(params, tf._embed_dec_train(params, hps,
                                              arrays["dec_batch"]))
    cross_mask = enc_mask[:, None, :]

    def layer_fn(layer, y, enc_out, cross_mask):
        y = y + _aan_block_train(layer, tf._ln(layer["ln1"], y))
        c, probs = tf._mha(dhps, layer["cross_attn"],
                           tf._ln(layer["ln_cross"], y), enc_out, cross_mask)
        y = y + c
        return y + tf._ffn_block(layer["ffn"], tf._ln(layer["ln2"], y)), \
            c, probs

    layer_fn = pg.maybe_remat(hps, layer_fn)
    cross_ctx = attn_dist = None
    for layer in params["decoder"]["layers"]:
        y, cross_ctx, attn_dist = layer_fn(layer, y, enc_out, cross_mask)
    h = tf._ln(params["decoder"]["ln_out"], y).float()
    return tf.train_output_tail(params, hps, arrays, h, cross_ctx, attn_dist)


# --------------------------------------------------------------------------
# Decoding (the O(1)-in-history step and the beam adapter)
# --------------------------------------------------------------------------

def beam_encode(params: Params, hps: HParams,
                arrays: Dict[str, torch.Tensor]) -> TransformerEncView:
    """The transformer's encoder view, the K/V heads split at the decoder
    width (avg_attention.py:396-404)."""
    return tf.beam_encode(params, hps, arrays, head_hps=_decoder_hps(hps))


def decode_onestep(params: Params, hps: HParams, enc: TransformerEncView,
                   enc_mask: torch.Tensor, ext_ids: torch.Tensor,
                   t: torch.Tensor, latest: torch.Tensor,
                   aan_sum: torch.Tensor, nb: Optional[int] = None,
                   ) -> Tuple[torch.Tensor, ...]:
    """One AAN step for B articles x K hypotheses (avg_attention.py:
    407-446): each layer adds its normalized input to the running f32 sum
    and averages by t + 1; no cache, no attention over past positions.
    t [B]; latest [B, K]; aan_sum [B, K, L, H_d].  Returns (final_dist
    [B, K, V_ext], attn_dist [B, K, T_enc], p_gen [B, K], h [B, K, H_d],
    the new sum [B, K, L, H_d]: a new tensor, the input left as it
    was)."""
    dhps = _decoder_hps(hps)
    y = _emb_proj(params, tf._embed_dec(params, hps, latest, t))
    dt = y.dtype
    denom = (t.float() + 1.0)[:, None, None]
    new_sums = []
    attn_dist = cross_ctx = None
    for li, layer in enumerate(params["decoder"]["layers"]):
        x_norm = tf._ln(layer["ln1"], y)
        s = aan_sum[:, :, li] + x_norm.float()
        new_sums.append(s)
        g = tf._ffn_block(layer["aan_ffn"], (s / denom).to(dt))
        y = y + _aan_gate(layer, x_norm, g)
        cross_out, attn_dist = tf.cross_attend_layer(
            dhps, layer, y, enc.cross_k[:, li], enc.cross_v[:, li],
            enc_mask, nb=nb)
        y = y + cross_out
        y = y + tf._ffn_block(layer["ffn"], tf._ln(layer["ln2"], y))
        cross_ctx = cross_out
    final_dist, p_gen, h = tf.decode_output_tail(params, dhps, y, cross_ctx,
                                                 attn_dist, ext_ids)
    return final_dist, attn_dist, p_gen, h, torch.stack(new_sums, dim=2)


def beam_adapter(hps: HParams):
    """(init_state, step) of the beam protocol (avg_attention.py:449-479):
    the state is the one running-sum tensor [B, K, L, H_d], f32."""
    K = hps.beam_size
    L = hps.dec_layers
    Hd = _decoder_hps(hps).hidden_dim

    def init_state(params: Params, enc: TransformerEncView):
        del params
        return {"aan_sum": torch.zeros(
            (enc.cross_k.shape[0], K, L, Hd), dtype=torch.float32,
            device=enc.cross_k.device)}

    def step(params: Params, enc: TransformerEncView,
             enc_mask: torch.Tensor, ext_ids: torch.Tensor, t: torch.Tensor,
             latest: torch.Tensor, state,
             nb: Optional[int] = None) -> BeamStepOut:
        final_dist, attn_dist, p_gen, _, new_sum = decode_onestep(
            params, hps, enc, enc_mask, ext_ids, t, latest,
            state["aan_sum"], nb=nb)
        topk_probs, topk_ids = pg.top_k(final_dist, 2 * hps.beam_size)
        return BeamStepOut(topk_ids=topk_ids,
                           topk_log_probs=torch.log(topk_probs + 1e-10),
                           attn_dist=attn_dist, p_gen=p_gen,
                           state={"aan_sum": new_sum})

    return init_state, step


#: the slot engine's length-bounded adapter: the step with a leading nb
beam_adapter_masked = masked_adapter(beam_adapter)

#: the encoder view is the transformer's, and so is its prefill padding
pad_enc_view = tf.pad_enc_view
