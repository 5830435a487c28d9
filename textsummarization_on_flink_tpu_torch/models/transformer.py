"""Transformer summarization family: training and beam decode.

Port of the JAX package's models/transformer.py (pre-LN encoder-decoder,
learned positions, tied input/output embedding, the final decoder
layer's head-averaged cross-attention as the copy distribution, a
static-shape KV cache for incremental decoding).  Functions take the
params tree (a nested dict of tensors with the JAX tree's names; layers
are lists, see params.py) and tensors on one device.  The JAX package
vmaps its beam step over articles; here the article axis B is written
out and the beam axis K follows it.

The encoder's self-attention and the training decoder's causal
self-attention go through ops/flash_attention.py on every shape: the
CUDA kernels on the card (forward, and in training the dK/dV and dQ
backward kernels), their plain versions on the CPU.  The JAX package's
gate for its TPU flash kernel (``_use_flash``: TS_FLASH, 128-aligned
shapes, T >= 1024) follows from the Mosaic kernel's 128-lane tiling and
is not read here.

On a mesh (parallel/; the plan bound by the sharded steps) the family
runs the JAX package's layout: on tp the tied embedding and out_bias
over the vocabulary (collectives.embed, losses.vocab_scores) and the
Megatron heads and FFN (wq/wk/wv/w1/b1 column-, wo/w2 row-sharded, one
all-reduce per block), so the flash kernels run this rank's
num_heads/tp heads (ceil(num_heads/tp) for the AAN, padded with zero
heads: parallel/sharding.py::pad_heads) and the copy distribution's
head mean is summed over tp; with sp > 1 the encoder holds its sp
block of T (its embeddings, layer norms, projections and FFNs run on the
block, as the JAX package's GSPMD partitions them), its self-attention
is ring or Ulysses under --sp_attention (parallel/ring_attention.py,
JAX transformer.py:226-255) and otherwise the block's queries against
the keys and mask all-gathered over sp, and its output, mask and
extended ids are all-gathered over sp before the decoder.

``forward_train`` computes the materialised loss or, with
``--loss_chunk``, the streaming one (ops/losses.py), and under
``--remat`` recomputes each layer of both stacks in the backward
(``torch.utils.checkpoint``, non-reentrant: each layer's forward, its
flash kernel included, runs again in the backward).

Under ``compute_dtype=bfloat16`` the cast points are the JAX package's:
master params stay f32 and each weight is cast to the activation dtype
at its use (``.to(x.dtype)``, so autograd carries each gradient back to
the f32 leaf); the embeddings are summed in f32 and rounded once; the
residual streams, projections and FFN are bf16; LayerNorm computes in
f32 and returns its input's dtype; attention logits are f32 sums of
exact bf16 products, masking and softmax f32, P rounded to bf16 before
P V (the self-attention's flash kernels take bf16 q, k, v); the
encoder's output is f32 and cast to bf16 again for the cross-attention;
the final LN and the cross-attention context are f32 for p_gen and the
vocab projection (bf16 operands, f32 sums).  Decoding keeps the KV cache
in float32 (it holds the bf16 projections widened) unless
``decode_cache_dtype`` says otherwise, and forms both
attentions' logits and contexts in f32, rounding each context to bf16
before ``wo``.  ``decode_cache_dtype=bfloat16`` stores that cache in
bf16 (half its bytes, resident and per step) and widens it to f32 where
it is read, so the logits, softmax and contexts stay f32.  In f32 every
cast is a no-op.  The slot engine's step
bounds the cross-attention by its residents' longest article
(``cross_attend_layer(nb=...)``, plain torch over the K/V prefix, as the
JAX package computes it in XLA).

The speculative tier's verifier (``spec_init_state``, ``spec_verify``)
scores the S = spec_k + 1 positions of a cycle in one parallel pass over
a per-row KV cache of [B, L, W, nh, hd], W = max_dec_steps + spec_k + 1
(in the beam step's cache dtype), each row at its own step ``t0``.  The AAN
draft family (models/avg_attention.py) shares this module's encoder
stack, cross-attention, output tail and loss head; its factored
``vocab_head`` (the narrow draft) goes through ``vocab_scores_of`` and
``vocab_proj_weight``.  Neither the pointer-generator nor the AAN has a
KV cache, so ``decode_cache_dtype`` changes nothing there.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from textsummarization_on_flink_tpu_torch.config import (
    HParams,
    resolve_enc_block,
)
from textsummarization_on_flink_tpu_torch.models import masked_adapter
from textsummarization_on_flink_tpu_torch.models import pointer_generator as pg
from textsummarization_on_flink_tpu_torch.ops import flash_attention as fa
from textsummarization_on_flink_tpu_torch.ops import losses as loss_ops
from textsummarization_on_flink_tpu_torch.parallel import collectives
from textsummarization_on_flink_tpu_torch.parallel import ring_attention
from textsummarization_on_flink_tpu_torch.parallel import sharding

Params = Dict[str, Any]

NEG = -1e30  # masked-logit floor, never -inf

BeamStepOut = pg.BeamStepOut  # shared beam protocol output type
TrainOutput = pg.TrainOutput  # same contract for the Trainer/Evaluator


def _head_dim(hps: HParams) -> int:
    return hps.hidden_dim // hps.num_heads


# --------------------------------------------------------------------------
# Core blocks
# --------------------------------------------------------------------------

def _ln(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with the population variance (jnp.var) and eps 1e-6,
    computed in f32 and returned in x's dtype (transformer.py:132-137)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6) * p["scale"]
            + p["bias"]).to(x.dtype)


def _local_heads(hps: HParams) -> int:
    """This rank's heads: ceil(num_heads / tp) on a tp mesh (the
    Megatron column split of wq/wk/wv; the AAN pads num_heads to a
    multiple of tp with zero heads, parallel/sharding.py::pad_heads),
    num_heads otherwise."""
    return -(-hps.num_heads // collectives.tp_size())


def _split_heads(hps: HParams, x: torch.Tensor) -> torch.Tensor:
    """[..., nh*hd] -> [..., nh, hd] (nh: the heads x holds)"""
    return x.reshape(x.shape[:-1] + (-1, _head_dim(hps)))


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def _mha(hps: HParams, p: Dict[str, torch.Tensor], q_in: torch.Tensor,
         kv_in: torch.Tensor, mask: torch.Tensor,
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-head attention in plain PyTorch (transformer.py:149-180).

    q_in: [..., Tq, H]; kv_in: [..., Tk, H]; mask: broadcastable to
    [..., Tq, Tk] (1 = attend).  Returns (output [..., Tq, H] in q_in's
    dtype, head-averaged probabilities [..., Tq, Tk] in f32).  The
    projections run in the activation dtype; the logits are f32 sums of
    exact products (preferred_element_type=f32), P is rounded to that
    dtype before P V, whose f32 sums are rounded once."""
    dt = q_in.dtype
    q_in, kv_in = collectives.copy_to_tp(q_in), collectives.copy_to_tp(kv_in)
    q = _split_heads(hps, q_in @ p["wq"].to(dt))  # [..., Tq, nh, hd]
    k = _split_heads(hps, kv_in @ p["wk"].to(dt))
    v = _split_heads(hps, kv_in @ p["wv"].to(dt))
    scale = _head_dim(hps) ** -0.5
    logits = torch.einsum("...qnd,...knd->...nqk", q.float(),
                          k.float()) * scale
    m = mask[..., None, :, :] > 0
    logits = torch.where(m, logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    # a fully-masked query row gives a uniform softmax over -1e30 logits;
    # zero it so padding queries emit exact zeros
    any_key = torch.sum(mask[..., None, :, :], dim=-1, keepdim=True) > 0
    probs = torch.where(any_key, probs, 0.0)
    ctx = torch.einsum("...nqk,...knd->...qnd", probs.to(dt).float(),
                       v.float()).to(dt)
    out = collectives.reduce_from_tp(_merge_heads(ctx) @ p["wo"].to(dt))
    return out, collectives.head_mean(probs, -3, hps.num_heads)


def _ffn_block(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The FFN in x's dtype, weights and biases cast at their use (on a
    tp mesh w1/b1 column- and w2 row-sharded, one all-reduce)."""
    dt = x.dtype
    x = collectives.copy_to_tp(x)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w1"].to(dt) + p["b1"].to(dt), approximate="tanh")
    return collectives.reduce_from_tp(h @ p["w2"].to(dt)) + p["b2"].to(dt)


def _self_attention(hps: HParams, p: Dict[str, torch.Tensor],
                    x_norm: torch.Tensor, pad_mask, causal: bool,
                    ) -> torch.Tensor:
    """Self-attention block (transformer.py:220-296) through the flash
    wrapper on every shape, in x_norm's dtype (the flash kernels' bf16
    forms under bf16), on this rank's heads.  x_norm [B, T, H]; pad_mask
    [B, T] or None.  Where the encoder's T is sharded over sp
    (``_t_sharded``, a pad mask, not causal): under --sp_attention ring
    or Ulysses attention over the sp ranks, on f32 q/k/v (JAX
    transformer.py:226-255); otherwise this rank's block of queries
    against every key, k, v and the mask all-gathered over sp (the
    gather's backward reduce-scatters the ranks' partial dK and dV),
    which is how GSPMD partitions the JAX package's einsum ``_mha``
    (:290-295)."""
    dt = x_norm.dtype
    x_norm = collectives.copy_to_tp(x_norm)
    # [B, T, nh, hd], contiguous
    q = _split_heads(hps, x_norm @ p["wq"].to(dt))
    k = _split_heads(hps, x_norm @ p["wk"].to(dt))
    v = _split_heads(hps, x_norm @ p["wv"].to(dt))
    sm_scale = _head_dim(hps) ** -0.5
    if _t_sharded(hps) and not causal and pad_mask is not None:
        if hps.sp_attention:
            ctx = ring_attention.sp_attention(hps.sp_attention, q.float(),
                                              k.float(), v.float(), pad_mask,
                                              sm_scale).to(dt)
        else:
            ctx = fa.flash_attention(
                q, collectives.gather_sp(k, 1), collectives.gather_sp(v, 1),
                collectives.gather_sp_data(pad_mask, 1), False, sm_scale)
    else:
        ctx = fa.flash_attention(q, k, v, pad_mask, causal, sm_scale)
    return collectives.reduce_from_tp(_merge_heads(ctx) @ p["wo"].to(dt))


def _t_sharded(hps: HParams) -> bool:
    """Whether this forward holds the encoder's sp block of T (a mesh
    with sp > 1: parallel/sharding.py, shards_t)."""
    return sharding.shards_t(hps) and collectives.axis_size("sp") > 1


def _encoder_stack(params: Params, hps: HParams, x: torch.Tensor,
                   enc_mask: torch.Tensor) -> torch.Tensor:
    """x: [B, T_enc, H] in the activation dtype; enc_mask: [B, T_enc] ->
    [B, T_enc, H] f32 (transformer.py:313)."""

    def layer_fn(layer, x, enc_mask):
        x = x + _self_attention(hps, layer["self_attn"],
                                _ln(layer["ln1"], x), enc_mask, causal=False)
        return x + _ffn_block(layer["ffn"], _ln(layer["ln2"], x))

    layer_fn = pg.maybe_remat(hps, layer_fn)  # JAX transformer.py:309
    for layer in params["encoder"]["layers"]:
        x = layer_fn(layer, x, enc_mask)
    return _ln(params["encoder"]["ln_out"], x).float()


class TransformerEncView(NamedTuple):
    """Per-batch encoder view for decoding: the per-layer cross-attention
    K/V, precomputed once per article."""

    cross_k: torch.Tensor  # [B, L, T_enc, nh, hd]
    cross_v: torch.Tensor  # [B, L, T_enc, nh, hd]


def _embed_enc(params: Params, hps: HParams,
               enc_batch: torch.Tensor) -> torch.Tensor:
    """Summed in f32, then rounded once to the compute dtype
    (transformer.py:329-332); an sp block of T takes its positions."""
    T = enc_batch.shape[-1]
    t0 = collectives.current().coord("sp") * T if _t_sharded(hps) else 0
    return pg._cast(hps, collectives.embed(params["embedding"], enc_batch)
                    + params["pos_enc"][t0:t0 + T])


def _pos_dec(params: Params, positions: torch.Tensor) -> torch.Tensor:
    """pos_dec rows at ``positions``, an index past the last row reading
    the last, as a JAX gather clamps (the spec engine's draft and
    verifier score positions past the horizon, whose outputs it drops)."""
    return params["pos_dec"][positions.clamp(
        max=params["pos_dec"].shape[0] - 1)]


def _embed_dec(params: Params, hps: HParams, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """tokens [B, K] at positions [B] (each article's own step)."""
    return pg._cast(hps, collectives.embed(params["embedding"], tokens)
                    + _pos_dec(params, positions)[:, None])


def _embed_dec_train(params: Params, hps: HParams,
                     dec_batch: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder inputs dec_batch [B, T_dec] at positions
    0 .. T_dec-1 for every article (transformer.py:357)."""
    T = dec_batch.shape[-1]
    return pg._cast(hps, collectives.embed(params["embedding"], dec_batch)
                    + params["pos_dec"][:T])


# --------------------------------------------------------------------------
# Training forward (fully parallel over decode steps)
# --------------------------------------------------------------------------

def encode_train(params: Params, hps: HParams,
                 arrays: Dict[str, torch.Tensor],
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training encoder: (its output in the compute dtype [B, T_enc,
    H], the arrays).  Where T is sharded over sp the encoder runs on this
    rank's block and its output, mask and extended ids are all-gathered
    over sp (the returned arrays hold the whole mask and ids)."""
    enc_mask = arrays["enc_padding_mask"]  # [B, T_enc]
    x = _embed_enc(params, hps, arrays["enc_batch"])
    enc_f32 = _encoder_stack(params, hps, x, enc_mask)
    if _t_sharded(hps):
        enc_f32 = collectives.gather_sp(enc_f32, 1)
        enc_mask = collectives.gather_sp_data(enc_mask, 1)
        arrays = dict(arrays, enc_padding_mask=enc_mask,
                      enc_batch_extend_vocab=collectives.gather_sp_data(
                          arrays["enc_batch_extend_vocab"], 1))
    # f32 out of the encoder, cast again for the cross-attention (:355)
    return pg._cast(hps, enc_f32), arrays


def forward_train(params: Params, hps: HParams,
                  arrays: Dict[str, torch.Tensor]) -> TrainOutput:
    """Teacher-forced training/eval forward pass (transformer.py:341-378):
    the masked-average pointer NLL (or the baseline cross-entropy) and
    the optional coverage penalty on the final layer's copy attention.

    arrays: a Batch's arrays as tensors (data/batching.py) on the params'
    device.  Where the encoder's T is sharded over sp the arrays hold
    this rank's block of the encoder arrays: the encoder runs on it and
    its output, mask and extended ids are all-gathered over sp before
    the decoder, which runs the same on every sp rank."""
    enc_out, arrays = encode_train(params, hps, arrays)
    enc_mask = arrays["enc_padding_mask"]
    y = _embed_dec_train(params, hps, arrays["dec_batch"])
    cross_mask = enc_mask[:, None, :]  # [B, 1, T_enc]

    def layer_fn(layer, y, enc_out, cross_mask):
        y = y + _self_attention(hps, layer["self_attn"], _ln(layer["ln1"], y),
                                None, causal=True)
        c, probs = _mha(hps, layer["cross_attn"], _ln(layer["ln_cross"], y),
                        enc_out, cross_mask)
        y = y + c
        return y + _ffn_block(layer["ffn"], _ln(layer["ln2"], y)), c, probs

    layer_fn = pg.maybe_remat(hps, layer_fn)  # JAX transformer.py:370
    cross_ctx = attn_dist = None
    for layer in params["decoder"]["layers"]:
        y, cross_ctx, attn_dist = layer_fn(layer, y, enc_out, cross_mask)
    h = _ln(params["decoder"]["ln_out"], y).float()
    return train_output_tail(params, hps, arrays, h, cross_ctx, attn_dist)


def train_output_tail(params: Params, hps: HParams,
                      arrays: Dict[str, torch.Tensor], h: torch.Tensor,
                      cross_ctx: torch.Tensor, attn_dist: torch.Tensor,
                      ) -> TrainOutput:
    """The loss head (transformer.py:416-480): p_gen from [h, cross_ctx],
    the tied vocab projection (materialised, or streamed in chunks of
    decoder steps with --loss_chunk), the pointer mixture's gold
    probability (or the baseline cross-entropy when pointer_gen is off),
    the coverage penalty.

    h [B, T_dec, H] final-LN decoder states (f32); cross_ctx the final
    layer's cross-attention output (in the activation dtype, widened
    here); attn_dist its head-averaged copy distribution [B, T_dec,
    T_enc] (f32)."""
    dec_mask = arrays["dec_padding_mask"]  # [B, T_dec]
    pl = params["pgen_linear"]
    p_gens = torch.sigmoid(torch.cat([h, cross_ctx.float()], dim=-1)
                           @ pl["kernel"] + pl["bias"])[..., 0]  # [B, T_dec]
    targets = arrays["target_batch"]
    if hps.loss_chunk > 0:
        # step-major views for the streaming losses; the [B, T_dec, V]
        # logits never exist
        h_t = h.transpose(0, 1)  # [T_dec, B, H]
        w = vocab_proj_weight(params)
        if hps.pointer_gen:
            gold = loss_ops.streaming_gold_probs(
                h_t, attn_dist.transpose(0, 1), p_gens.transpose(0, 1),
                targets.transpose(0, 1), arrays["enc_batch_extend_vocab"],
                w, params["out_bias"], chunk=hps.loss_chunk,
                compute_dtype=hps.compute_dtype).transpose(0, 1)
            loss = loss_ops.mask_and_avg(-torch.log(gold + 1e-10), dec_mask)
        else:
            loss = loss_ops.streaming_softmax_cross_entropy(
                h_t, targets.transpose(0, 1), dec_mask.transpose(0, 1), w,
                params["out_bias"], chunk=hps.loss_chunk,
                compute_dtype=hps.compute_dtype)
        return _with_coverage(hps, loss, dec_mask, attn_dist, p_gens)
    logits = vocab_scores_of(params, hps, h)  # [B, T_dec, V]
    if hps.pointer_gen:
        # step-major views, as the JAX package hands them to the shared
        # mixture function
        gold = loss_ops.gold_mixture_prob_from_scores(
            logits.transpose(0, 1), attn_dist.transpose(0, 1),
            p_gens.transpose(0, 1), targets.transpose(0, 1),
            arrays["enc_batch_extend_vocab"]).transpose(0, 1)
        loss = loss_ops.mask_and_avg(-torch.log(gold + 1e-10), dec_mask)
    else:
        loss = loss_ops.softmax_cross_entropy_baseline(logits, targets,
                                                       dec_mask)
    return _with_coverage(hps, loss, dec_mask, attn_dist, p_gens)


def _with_coverage(hps: HParams, loss: torch.Tensor,
                   dec_mask: torch.Tensor, attn_dist: torch.Tensor,
                   p_gens: torch.Tensor) -> TrainOutput:
    """The TrainOutput of ``loss`` with the coverage penalty added."""
    if hps.coverage:
        cov_loss = loss_ops.coverage_loss(attn_dist, dec_mask)
    else:
        cov_loss = torch.zeros((), device=loss.device)
    total = loss + hps.cov_loss_wt * cov_loss
    return TrainOutput(loss=loss, coverage_loss=cov_loss, total_loss=total,
                       attn_dists=attn_dist, p_gens=p_gens)


# --------------------------------------------------------------------------
# Decoding (KV-cache incremental step + beam adapter)
# --------------------------------------------------------------------------

def beam_encode(params: Params, hps: HParams,
                arrays: Dict[str, torch.Tensor],
                head_hps: Optional[HParams] = None) -> TransformerEncView:
    """Encode a batch once and precompute per-layer cross-attention K/V
    (transformer.py:487-508), in the compute dtype.  ``head_hps`` carries
    the decoder's width for the head split (the narrow AAN draft's H_d:
    its [H, H_d] K/V kernels project the H-wide encoder output); None is
    ``hps``.  The search holds the whole batch on every rank: where the
    encoder's T is sharded (an sp mesh) it runs on this rank's block and
    its output is all-gathered over sp, as in training."""
    head_hps = head_hps if head_hps is not None else hps
    enc_batch, enc_mask = arrays["enc_batch"], arrays["enc_padding_mask"]
    if _t_sharded(hps):
        enc_batch, enc_mask = (collectives.sp_block_of(x, 1).contiguous()
                               for x in (enc_batch, enc_mask))
    x = _embed_enc(params, hps, enc_batch)
    enc_f32 = _encoder_stack(params, hps, x, enc_mask)
    if _t_sharded(hps):
        enc_f32 = collectives.gather_sp(enc_f32, 1)
    enc_out = pg._cast(hps, enc_f32)
    dt = enc_out.dtype
    ks, vs = [], []
    for layer in params["decoder"]["layers"]:
        p = layer["cross_attn"]
        ks.append(_split_heads(head_hps, enc_out @ p["wk"].to(dt)))
        vs.append(_split_heads(head_hps, enc_out @ p["wv"].to(dt)))
    return TransformerEncView(cross_k=torch.stack(ks, dim=1),
                              cross_v=torch.stack(vs, dim=1))


def cross_attend_layer(hps: HParams, layer: Dict[str, Any], y: torch.Tensor,
                       ck: torch.Tensor, cv: torch.Tensor,
                       enc_mask: torch.Tensor, nb: Optional[int] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross-attention against its precomputed K/V
    (transformer.py:514-579).

    y: [B, K, H]; ck/cv: [B, T_enc, nh, hd]; enc_mask: [B, T_enc].
    Returns (cross_out [B, K, H] in y's dtype — not yet residual-added —
    and the head-averaged probabilities [B, K, T_enc], f32).  The logits
    and the context are f32 products of the widened q and K/V.

    ``nb`` (the slot engine's length-bounded step): the logits and the
    context run over the first min(nb * decode_enc_block, T_enc) keys
    only, and the probabilities are 0 past them, where the JAX package's
    block chain leaves uncovered blocks at the masked floor.  None is
    the dense form."""
    hd = _head_dim(hps)
    dt = y.dtype
    cp = layer["cross_attn"]
    qc = _split_heads(hps, collectives.copy_to_tp(_ln(layer["ln_cross"], y))
                      @ cp["wq"].to(dt))
    T = enc_mask.shape[-1]
    t_act = T
    if nb is not None:
        t_act = max(1, min(int(nb) * resolve_enc_block(hps), T))
    mask = enc_mask[:, :t_act]
    clogits = torch.einsum("bknd,btnd->bknt", qc.float(),
                           ck[:, :t_act].float()) * (hd ** -0.5)
    clogits = torch.where(mask[:, None, None, :] > 0, clogits, NEG)
    cprobs = torch.softmax(clogits, dim=-1)
    any_key = torch.sum(enc_mask, dim=-1) > 0  # [B]
    cprobs = torch.where(any_key[:, None, None, None], cprobs, 0.0)
    cctx = torch.einsum("bknt,btnd->bknd", cprobs, cv[:, :t_act].float())
    cross_out = collectives.reduce_from_tp(_merge_heads(cctx).to(dt)
                                           @ cp["wo"].to(dt))
    probs = collectives.head_mean(cprobs, 2, hps.num_heads)
    if t_act < T:
        probs = F.pad(probs, (0, T - t_act))
    return cross_out, probs


def vocab_scores_of(params: Params, hps: HParams,
                    h: torch.Tensor) -> torch.Tensor:
    """Raw vocabulary scores of final-LN decoder states h [..., H_dec]
    (transformer.py:381-397): the tied-embedding projection, or, when the
    params carry a factored ``vocab_head`` (the narrow AAN draft),
    (h @ w1) @ w2 with w1 [H_d, r] and w2 [r, V], the [H_d, V] product
    never formed.  Both products take the compute dtype's operands."""
    vh = params.get("vocab_head")
    if vh is not None:
        # on tp the rank r is sharded (w1 column-, w2 row-parallel): each
        # rank's product is a part of the scores, summed over tp, and the
        # vocab-sharded out_bias is gathered
        hr = loss_ops.project_scores(collectives.copy_to_tp(h), vh["w1"],
                                     hps.compute_dtype)
        return collectives.reduce_from_tp(loss_ops.project_scores(
            hr, vh["w2"], hps.compute_dtype)) \
            + collectives.gather_vocab(params["out_bias"])
    return loss_ops.vocab_scores(h, params["embedding"].T,
                                 params["out_bias"], hps.compute_dtype)


def vocab_proj_weight(params: Params) -> torch.Tensor:
    """The [H_dec, V] projection matrix of the streaming losses
    (transformer.py:400-414): the tied embedding's transpose, or the
    factored head's w1 @ w2 (so with --loss_chunk a factored head agrees
    with the materialised loss to the matmul's association, not
    bitwise)."""
    vh = params.get("vocab_head")
    if vh is not None:
        # on tp: the rank-partial products summed over tp and cut to this
        # rank's vocabulary columns, as vocab_scores takes them
        return collectives.reduce_scatter_tp(vh["w1"] @ vh["w2"], 1)
    return params["embedding"].T


def decode_output_tail(params: Params, hps: HParams, y: torch.Tensor,
                       cross_ctx: torch.Tensor, attn_dist: torch.Tensor,
                       ext_ids: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decoder output head (transformer.py:582-604): final LN, vocab
    projection, p_gen, pointer mixture.  y, cross_ctx [B, K, H];
    attn_dist [B, K, T_enc]; ext_ids [B, T_enc].  Returns
    (final_dist [B, K, V_ext], p_gen [B, K], h [B, K, H] f32)."""
    h = _ln(params["decoder"]["ln_out"], y).float()
    vocab_dist = torch.softmax(vocab_scores_of(params, hps, h), dim=-1)
    pl = params["pgen_linear"]
    p_gen = torch.sigmoid(torch.cat([h, cross_ctx.float()], dim=-1)
                          @ pl["kernel"] + pl["bias"])[..., 0]
    if not hps.pointer_gen:
        return vocab_dist, p_gen, h
    B, K, _ = y.shape
    ext_k = ext_ids[:, None, :].expand(B, K, ext_ids.shape[-1])
    final_dist = pg.final_distribution(
        hps, vocab_dist.reshape(B * K, -1), attn_dist.reshape(B * K, -1),
        p_gen.reshape(B * K), ext_k.reshape(B * K, -1)).reshape(B, K, -1)
    return final_dist, p_gen, h


def cache_dtype(hps: HParams) -> torch.dtype:
    """The decode KV cache's storage dtype (``--decode_cache_dtype``)."""
    return (torch.bfloat16 if hps.decode_cache_dtype == "bfloat16"
            else torch.float32)


def beam_adapter(hps: HParams):
    """(init_state, step) closures implementing the beam protocol for the
    transformer (transformer.py:607-678).  State: the KV cache
    ``cache_k`` / ``cache_v`` of [B, K, L, T_dec+1, nh, hd] (nh the
    rank's heads under tp) in ``cache_dtype(hps)`` whatever the compute
    dtype; a position is valid up to each article's own step t."""
    K = hps.beam_size
    L = hps.dec_layers
    hd = _head_dim(hps)
    T = hps.max_dec_steps + 1
    store = cache_dtype(hps)

    def init_state(params: Params, enc: TransformerEncView):
        del params
        B = enc.cross_k.shape[0]
        shape = (B, K, L, T, _local_heads(hps), hd)
        kw = dict(dtype=store, device=enc.cross_k.device)
        return {"cache_k": torch.zeros(shape, **kw),
                "cache_v": torch.zeros(shape, **kw)}

    def step(params: Params, enc: TransformerEncView, enc_mask: torch.Tensor,
             ext_ids: torch.Tensor, t: torch.Tensor, latest: torch.Tensor,
             state, nb: Optional[int] = None) -> BeamStepOut:
        """t [B]: each article's step (an article whose search ended
        keeps stepping masked, up to t = max_dec_steps, which pos_dec and
        the cache's last column hold); latest [B, K]; nb: the slot
        engine's block count of the cross-attention (None: dense)."""
        B = latest.shape[0]
        y = _embed_dec(params, hps, latest, t)  # [B, K, H]
        pos_ok = torch.arange(T, device=t.device)[None, :] <= t[:, None]
        # written in place: the state is this step's own (the search
        # gathers a fresh copy by parent after every step)
        cache_k, cache_v = state["cache_k"], state["cache_v"]
        bi = torch.arange(B, device=t.device)[:, None]
        ki = torch.arange(K, device=t.device)[None, :]
        ti = t[:, None]
        attn_dist = cross_ctx = None
        dt = y.dtype  # projections in the activation dtype; the logits
        # and softmax f32, the cache stored in `store` and widened at use
        for li, layer in enumerate(params["decoder"]["layers"]):
            p = layer["self_attn"]
            h_norm = collectives.copy_to_tp(_ln(layer["ln1"], y))
            # [B, K, nh, hd]
            q = _split_heads(hps, h_norm @ p["wq"].to(dt))
            cache_k[bi, ki, li, ti] = _split_heads(
                hps, h_norm @ p["wk"].to(dt)).to(store)
            cache_v[bi, ki, li, ti] = _split_heads(
                hps, h_norm @ p["wv"].to(dt)).to(store)
            logits = torch.einsum("bknd,bktnd->bknt", q.float(),
                                  cache_k[:, :, li].float()) * (hd ** -0.5)
            logits = torch.where(pos_ok[:, None, None, :], logits, NEG)
            probs = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("bknt,bktnd->bknd", probs,
                               cache_v[:, :, li].float())
            y = y + collectives.reduce_from_tp(_merge_heads(ctx).to(dt)
                                               @ p["wo"].to(dt))
            cross_out, attn_dist = cross_attend_layer(
                hps, layer, y, enc.cross_k[:, li], enc.cross_v[:, li],
                enc_mask, nb=nb)
            y = y + cross_out
            y = y + _ffn_block(layer["ffn"], _ln(layer["ln2"], y))
            cross_ctx = cross_out
        final_dist, p_gen, _ = decode_output_tail(params, hps, y, cross_ctx,
                                                  attn_dist, ext_ids)
        topk_probs, topk_ids = pg.top_k(final_dist, 2 * hps.beam_size)
        return BeamStepOut(topk_ids=topk_ids,
                           topk_log_probs=torch.log(topk_probs + 1e-10),
                           attn_dist=attn_dist, p_gen=p_gen,
                           state={"cache_k": cache_k, "cache_v": cache_v})

    return init_state, step


#: the slot engine's length-bounded adapter: the step with a leading nb
beam_adapter_masked = masked_adapter(beam_adapter)


def pad_enc_view(enc: TransformerEncView, t_target: int,
                 ) -> TransformerEncView:
    """Zero-pad a bucket-width encoder view's key axis (axis 2) to
    ``t_target`` (the prefill -> pack hand-off; JAX transformer.py:687):
    the padded keys sit behind the valid-length mask and are never
    attended."""
    def pad(x):
        if x.shape[2] >= t_target:
            return x
        return F.pad(x, (0, 0, 0, 0, 0, t_target - x.shape[2]))

    return TransformerEncView(cross_k=pad(enc.cross_k),
                              cross_v=pad(enc.cross_v))


# --------------------------------------------------------------------------
# Speculative verify: the cycle's positions scored in one parallel pass
# --------------------------------------------------------------------------

def spec_init_state(hps: HParams, spec_k: int, batch: int,
                    device: Any) -> Dict[str, torch.Tensor]:
    """The verifier's KV cache of ``batch`` articles (transformer.py:708):
    [B, L, W, nh, hd] with W = max_dec_steps + spec_k + 1, wide enough
    that a block starting at any step up to the horizon writes its
    spec_k + 1 entries in bounds.  In ``cache_dtype(hps)``, as the beam
    step's cache; a position is valid up to each row's committed step,
    so rejected entries are never read and the next block overwrites
    them."""
    L, nh, hd = hps.dec_layers, hps.num_heads, _head_dim(hps)
    W = hps.max_dec_steps + spec_k + 1
    shape = (batch, L, W, nh, hd)
    kw = dict(dtype=cache_dtype(hps), device=device)
    return {"cache_k": torch.zeros(shape, **kw),
            "cache_v": torch.zeros(shape, **kw)}


def spec_verify(params: Params, hps: HParams, enc: TransformerEncView,
                enc_mask: torch.Tensor, ext_ids: torch.Tensor,
                t0: torch.Tensor, tokens: torch.Tensor,
                state: Dict[str, torch.Tensor]):
    """Score S teacher-forced positions of B articles in one decoder pass
    (transformer.py:727-794).  ``tokens`` [B, S] are the inputs consumed
    at steps t0 .. t0+S-1 (OOV already mapped to UNK), t0 [B] each row's
    committed step.  Each position attends the cache entries at steps
    <= its own: the beam step's masked softmax over S query rows (the
    masked columns add exact zeros; only the order of the sums can
    differ).  The cache is written in place, append-only.  Returns
    (topk_ids [B, S, 2], topk_log_probs [B, S, 2], attn_dist [B, S,
    T_enc], p_gen [B, S], state)."""
    B, S = tokens.shape
    hd = _head_dim(hps)
    cache_k, cache_v = state["cache_k"], state["cache_v"]
    W, store = cache_k.shape[2], cache_k.dtype
    pos = t0[:, None] + torch.arange(S, device=t0.device)  # [B, S]
    y = pg._cast(hps, params["embedding"][tokens] + _pos_dec(params, pos))
    dt = y.dtype
    pos_ok = torch.arange(W, device=t0.device)[None, None, :] \
        <= pos[:, :, None]  # [B, S, W]
    bi = torch.arange(B, device=t0.device)[:, None]
    attn_dist = cross_ctx = None
    for li, layer in enumerate(params["decoder"]["layers"]):
        p = layer["self_attn"]
        h_norm = _ln(layer["ln1"], y)
        q = _split_heads(hps, h_norm @ p["wq"].to(dt))  # [B, S, nh, hd]
        cache_k[bi, li, pos] = _split_heads(
            hps, h_norm @ p["wk"].to(dt)).to(store)
        cache_v[bi, li, pos] = _split_heads(
            hps, h_norm @ p["wv"].to(dt)).to(store)
        logits = torch.einsum("bsnd,btnd->bsnt", q.float(),
                              cache_k[:, li].float()) * (hd ** -0.5)
        logits = torch.where(pos_ok[:, :, None, :], logits, NEG)
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bsnt,btnd->bsnd", probs, cache_v[:, li].float())
        y = y + _merge_heads(ctx).to(dt) @ p["wo"].to(dt)
        cross_out, attn_dist = cross_attend_layer(
            hps, layer, y, enc.cross_k[:, li], enc.cross_v[:, li], enc_mask)
        y = y + cross_out
        y = y + _ffn_block(layer["ffn"], _ln(layer["ln2"], y))
        cross_ctx = cross_out
    final_dist, p_gen, _ = decode_output_tail(params, hps, y, cross_ctx,
                                              attn_dist, ext_ids)
    topk_probs, topk_ids = pg.top_k(final_dist, 2)
    return (topk_ids, torch.log(topk_probs + 1e-10), attn_dist, p_gen,
            {"cache_k": cache_k, "cache_v": cache_v})
