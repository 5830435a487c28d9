"""Bahdanau additive attention with coverage and padding-mask renorm.

Port of the JAX package's ops/attention.py (the reference's
attention_decoder.py:79-129):

    e_i   = v . tanh(W_h h_i + W_s s_t [+ w_c c_i] + b_attn)
    a     = renorm(softmax(e) * enc_mask)
    ctx   = sum_i a_i h_i

``encoder_features`` (W_h h_i) is computed once per article outside the
decoder loop, as the reference hoists it.  Energy, masked softmax and
context run in one call to ops/fused_attention.py: the CUDA kernel on the
card, its plain version on the CPU.

With the ``plan`` of a mesh whose sp axis shards T (the
pointer-generator's, parallel/sharding.py: shards_t) the encoder
tensors, the mask and the coverage are this rank's block of T: the
kernel's sp-block form runs on the block and the ranks' blocks are
merged (fused_attention.merge_sp_blocks), so the context is the whole
row's on every rank and the attention this rank's block of it (the
whole row with ``full_attn``, which the copy distribution scatters).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa


def encoder_features(attn_params: Dict[str, torch.Tensor],
                     enc_states: torch.Tensor) -> torch.Tensor:
    """W_h h_i for every encoder position: [B, T, D] -> [B, T, D], in the
    encoder stream's dtype (bf16 under compute_dtype=bfloat16: the
    attention re-reads it every decoder step and widens it to f32)."""
    return enc_states @ attn_params["W_h"].to(enc_states.dtype)


def _dec_feats(attn_params, dec_state):
    c, h = dec_state
    dec_in = torch.cat([c, h], dim=-1)
    return dec_in @ attn_params["linear_kernel"] + attn_params["linear_bias"]


def attend(attn_params: Dict[str, torch.Tensor], enc_states: torch.Tensor,
           enc_feats: torch.Tensor, enc_mask: torch.Tensor,
           dec_state: Tuple[torch.Tensor, torch.Tensor],
           coverage: Optional[torch.Tensor], use_coverage: bool,
           plan=None,
           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One attention query per row (``plan``: T sharded over sp, see the
    module docstring).

    enc_states/enc_feats [B, T, D]; enc_mask [B, T]; dec_state (c, h)
    each [B, H]; coverage [B, T] or None.  Returns (context [B, D],
    attn_dist [B, T], new_coverage [B, T] or None); new coverage is
    coverage + attn_dist (the caller decides whether to keep it)."""
    dec_feats = _dec_feats(attn_params, dec_state)
    apply_cov = bool(use_coverage and coverage is not None)
    cov_in = coverage if apply_cov else torch.zeros_like(enc_mask)
    context, attn_dist = fa.fused_attention(
        enc_states, enc_feats, enc_mask, dec_feats, cov_in,
        attn_params["v"], attn_params["w_c"], apply_cov, plan)
    new_coverage = None
    if use_coverage:
        new_coverage = (coverage if coverage is not None else 0.0) + attn_dist
    return context, attn_dist, new_coverage


def attend_shared(attn_params: Dict[str, torch.Tensor],
                  enc_states: torch.Tensor, enc_feats: torch.Tensor,
                  enc_mask: torch.Tensor,
                  dec_state: Tuple[torch.Tensor, torch.Tensor],
                  coverage: Optional[torch.Tensor], use_coverage: bool,
                  nb: Optional[int] = None, block: int = 0, plan=None,
                  full_attn: bool = False,
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """attend() with K queries per article sharing the article's encoder
    (the beam's K hypotheses): enc_states/enc_feats [B, T, D] and
    enc_mask [B, T] carry no query axis; dec_state leaves are [B, K, H]
    and coverage [B, K, T].  The JAX package's attend_shared works on one
    article under vmap; here the batch axis is written out.

    ``nb`` (the slot engine's length-bounded step, JAX ops/attention.py:
    88-129): the number of ``block``-position encoder blocks that hold
    every active resident's article, a host int.  The attention then
    reads the first min(nb * block, T) positions only, and attn_dist is
    0 past them, where the JAX package's blocked formula leaves those
    blocks at the masked floor.  None is the dense form.

    ``plan`` (T sharded over sp; no length bound there, as the slot
    engine does not shard T): the merged context, and the attention of
    this rank's block, or of the whole row with ``full_attn``; the new
    coverage is always the block's."""
    dec_feats = _dec_feats(attn_params, dec_state)  # [B, K, D]
    apply_cov = bool(use_coverage and coverage is not None)
    cov_in = (coverage if apply_cov else enc_mask.new_zeros(
        dec_feats.shape[:2] + enc_mask.shape[1:]))
    t_active = None
    if nb is not None:
        T = enc_mask.shape[-1]
        t_active = max(1, min(int(nb) * max(int(block), 1), T))
    if plan is None:
        context, attn_dist = fa.fused_attention_shared(
            enc_states, enc_feats, enc_mask, dec_feats, cov_in,
            attn_params["v"], attn_params["w_c"], apply_cov, t_active)
        attn_block = attn_dist
    else:
        context, attn_dist = fa.merge_sp_blocks(
            plan, *fa.fused_attention_block(
                enc_states, enc_feats, enc_mask, dec_feats, cov_in,
                attn_params["v"], attn_params["w_c"], apply_cov),
            full_attn=full_attn)
        T_blk = enc_mask.shape[-1]
        attn_block = (attn_dist.narrow(-1, plan.coord("sp") * T_blk, T_blk)
                      if full_attn else attn_dist)
    new_coverage = None
    if use_coverage:
        new_coverage = (coverage if coverage is not None else 0.0) \
            + attn_block
    return context, attn_dist, new_coverage
