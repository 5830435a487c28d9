"""Pointer-generator seq2seq model (See et al. 2017).

Port of the JAX package's models/pointer_generator.py (encoder, the
teacher-forced training forward, one decode step with the reference's
decode-mode semantics, and the beam adapter).  Functions take the params tree (a nested dict of tensors with
the JAX tree's names, see params.py) and tensors on one device.  The
JAX package vmaps its step over articles; here the article axis B is
written out and the beam axis K follows it.

Decode-mode semantics (initial_state_attention=True, the reference's
attention_decoder.py:138-160) are kept exactly, including the quirk that
the previous step's attention is recomputed to advance coverage while
the current step's attention does not advance it.

``forward_train`` keeps the JAX package's hoisting: the embedding half
of ``input_linear`` is one [B, T_dec, E] matmul before the decoder loop,
the loop carries (state, context, coverage) from zeros with one
attention per step (ops/attention.attend: the fused attention's autograd
Function, its kernels forward and backward on the card), and the
[T_dec, B, H] @ [H, V] projection and the losses run once after the
loop: materialised, under ``--remat`` recomputed in the backward
(``torch.utils.checkpoint``), or with ``--loss_chunk`` streamed in
chunks of decoder steps (ops/losses.py).  The ``TrainOutput`` contract
the Trainer and Evaluator read is defined here for both families, as in
the JAX package.

On a tp mesh (parallel/) the embedding [V/tp, E] and the projection's
w [H, V/tp] and v [V/tp] are this rank's vocabulary shards: lookups go
through collectives.embed and the scores through losses.vocab_scores
(an all-gather over tp along the vocab axis), as the JAX package's
GSPMD lays them out; everything else is replicated.

On an sp mesh (``_t_sharded``) the encoder's time axis is sharded, as
the JAX package's mesh shards "encoder states, attention energies, and
coverage" over T_enc (its parallel/mesh.py:17-22): the biLSTM runs over
the whole article on every sp rank (a sequential scan), each rank keeps
its block of the states (a copy, so the whole states are freed; d_es
comes back on the block and reaches the whole-T LSTM through the slice,
zero elsewhere, the ranks' LSTM gradients summed over sp) and computes
the features of that block only, and every attention runs on the block
and is merged over sp
(ops/attention.py with the plan); coverage stays the block's.  The
training forward takes the rank's sp block of the encoder arrays (the
registry's batch spec) and all-gathers the ids and the mask for the
encoder; the beam search takes the whole batch on every rank and the
encoder takes the block.  The copy distribution needs the whole row's
attention: decode gathers it with each step's merge, training
all-gathers the stacked [T_dec, B, T_enc / sp] blocks once after the
decoder loop (its backward a reduce-scatter), and the coverage loss and
the copy scatter read the whole row.

Under ``compute_dtype=bfloat16`` (JAX pointer_generator.py:154-200) the
encoder runs in bf16 (embeddings, the biLSTM's weights and state), its
states and features stay bf16 (the fused attention reads that stream,
forward and backward, and widens it to f32), the decoder's LSTM, p_gen
and output layers stay f32, and the vocab projection takes bf16
operands with f32 sums.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from textsummarization_on_flink_tpu_torch.config import (
    HParams,
    resolve_enc_block,
)
from textsummarization_on_flink_tpu_torch.models import masked_adapter
from textsummarization_on_flink_tpu_torch.ops import attention as attn_ops
from textsummarization_on_flink_tpu_torch.ops import losses as loss_ops
from textsummarization_on_flink_tpu_torch.ops import lstm as lstm_ops
from textsummarization_on_flink_tpu_torch.parallel import collectives
from textsummarization_on_flink_tpu_torch.parallel import sharding

Params = Dict[str, Any]


class EncoderOutput(NamedTuple):
    enc_states: torch.Tensor  # [B, T_enc, 2H]
    enc_features: torch.Tensor  # precomputed W_h h_i, [B, T_enc, 2H]
    dec_in_state: Tuple[torch.Tensor, torch.Tensor]  # (c, h) each [B, H]


class DecodeStepOutput(NamedTuple):
    topk_ids: torch.Tensor  # [B, K, 2*beam]
    topk_log_probs: torch.Tensor  # [B, K, 2*beam]
    state: Tuple[torch.Tensor, torch.Tensor]  # new (c, h), each [B, K, H]
    attn_dist: torch.Tensor  # [B, K, T_enc]
    p_gen: torch.Tensor  # [B, K]
    coverage: torch.Tensor  # [B, K, T_enc] (zeros if coverage off)


class TrainOutput(NamedTuple):
    """What a family's forward_train returns (pointer_generator.py
    TrainOutput of the JAX package)."""

    loss: torch.Tensor  # scalar
    coverage_loss: torch.Tensor  # scalar (0 when coverage is off)
    total_loss: torch.Tensor  # loss + cov_loss_wt * coverage_loss
    attn_dists: torch.Tensor  # [B, T_dec, T_enc]
    p_gens: torch.Tensor  # [B, T_dec]


class BeamStepOut(NamedTuple):
    """Model-agnostic one-step beam output: ``state`` is a dict whose
    every leaf leads with [B, K], so the search gathers surviving
    hypotheses leaf by leaf."""

    topk_ids: torch.Tensor  # [B, K, 2*beam]
    topk_log_probs: torch.Tensor  # [B, K, 2*beam]
    attn_dist: torch.Tensor  # [B, K, T_enc]
    p_gen: torch.Tensor  # [B, K]
    state: Dict[str, torch.Tensor]


def _linear(p: Dict[str, torch.Tensor], *args: torch.Tensor) -> torch.Tensor:
    """attention_decoder.py:184-228 `linear`: concat args, matmul, bias."""
    x = torch.cat(args, dim=-1) if len(args) > 1 else args[0]
    return x @ p["kernel"] + p["bias"]


def _cast(hps: HParams, x: torch.Tensor) -> torch.Tensor:
    """x in bf16 under compute_dtype=bfloat16, else unchanged."""
    return x.to(torch.bfloat16) if hps.compute_dtype == "bfloat16" else x


def maybe_remat(hps: HParams, fn: Callable) -> Callable:
    """fn recomputed in the backward under --remat (jax.checkpoint in the
    JAX package) while a gradient is being taken, fn itself otherwise.
    Non-reentrant: the recompute runs when the backward needs fn's saved
    tensors, on autograd's thread, so the mesh plan bound now is bound
    again around it."""
    if not (hps.remat and torch.is_grad_enabled()):
        return fn
    plan = collectives.current()

    def bound_fn(*args):
        with collectives.bound(plan):
            return fn(*args)

    return lambda *args: checkpoint(bound_fn, *args, use_reentrant=False)


def _t_sharded(hps: HParams):
    """The bound plan when this forward shards the encoder's T over sp
    (the pointer-generator on a mesh with sp > 1), else None."""
    plan = collectives.current()
    if sharding.shards_t(hps) and collectives.axis_size("sp", plan) > 1:
        return plan
    return None


def encode(params: Params, hps: HParams, enc_batch: torch.Tensor,
           enc_lens: torch.Tensor, enc_padding_mask: torch.Tensor,
           ) -> EncoderOutput:
    """Embed + biLSTM + state reduction (model.py:210-221).  Under bf16
    the encoder states and features stay bf16: the attention re-reads
    both every decoder step, so they are its bytes.  The arrays hold the
    whole article; where T is sharded over sp the output keeps this
    rank's block of the states and features (the features computed for
    the block only)."""
    emb = _cast(hps, collectives.embed(params["embedding"], enc_batch))
    enc_states, fw_st, bw_st = lstm_ops.bidirectional_encoder(
        params["encoder"]["fw"], params["encoder"]["bw"], emb, enc_lens,
        enc_padding_mask)
    # _reduce_states (model.py:97-121): ReLU linear from fw||bw to H, in
    # f32 (the JAX package's bf16 state promotes against f32 weights)
    r = params["reduce"]
    old_c = torch.cat([fw_st[0], bw_st[0]], dim=-1).float()
    old_h = torch.cat([fw_st[1], bw_st[1]], dim=-1).float()
    new_c = torch.relu(old_c @ r["w_reduce_c"] + r["bias_reduce_c"])
    new_h = torch.relu(old_h @ r["w_reduce_h"] + r["bias_reduce_h"])
    if _t_sharded(hps) is not None:  # a copy: the whole states are freed
        enc_states = collectives.sp_block_of(enc_states, 1).contiguous()
    enc_feats = attn_ops.encoder_features(params["decoder"]["attention"],
                                          enc_states)
    return EncoderOutput(enc_states, enc_feats, (new_c, new_h))


def _decoder_core(params: Params, hps: HParams, enc: EncoderOutput,
                  enc_padding_mask: torch.Tensor,
                  state: Tuple[torch.Tensor, torch.Tensor],
                  coverage: torch.Tensor, x: torch.Tensor, plan=None,
                  ) -> Dict[str, Any]:
    """One train-mode decoder step (attention_decoder.py:141-174): the
    merged input+context ``x`` -> cell -> attention (advances coverage)
    -> p_gen -> the output projection's input.  Coverage always flows;
    with coverage off the energies do not read it.  ``x`` is the
    input_linear output (forward_train adds its context half per step).
    ``plan``: T sharded over sp (the mask, the coverage and the returned
    attention are this rank's block)."""
    dp = params["decoder"]
    cell_out, new_state = lstm_ops.lstm_cell(dp["cell"], x, state)
    new_context, attn_dist, new_cov = attn_ops.attend(
        dp["attention"], enc.enc_states, enc.enc_features, enc_padding_mask,
        new_state, coverage if hps.coverage else None, hps.coverage, plan)
    if new_cov is None:
        new_cov = coverage
    p_gen = torch.sigmoid(
        _linear(dp["pgen_linear"], new_context, new_state[0], new_state[1], x)
    )[:, 0]
    output = _linear(dp["output_linear"], cell_out, new_context)
    return dict(state=new_state, context=new_context, attn_dist=attn_dist,
                coverage=new_cov, p_gen=p_gen, output=output)


def forward_train(params: Params, hps: HParams,
                  arrays: Dict[str, torch.Tensor]) -> TrainOutput:
    """The training and eval forward (model.py:199-277 semantics; JAX
    pointer_generator.py:221-315).  Where T is sharded over sp the
    encoder arrays are this rank's block (see the module docstring)."""
    plan = _t_sharded(hps)
    mask_blk = arrays["enc_padding_mask"]
    if plan is not None:
        arrays = dict(arrays, **{
            k: collectives.gather_sp_data(arrays[k], 1)
            for k in ("enc_batch", "enc_padding_mask",
                      "enc_batch_extend_vocab")})
    B, T_enc = mask_blk.shape
    enc = encode(params, hps, arrays["enc_batch"], arrays["enc_lens"],
                 arrays["enc_padding_mask"])
    # [B, T_dec, E]
    emb_dec = collectives.embed(params["embedding"], arrays["dec_batch"])
    ip = params["decoder"]["input_linear"]
    E = emb_dec.shape[-1]
    emb_proj = emb_dec @ ip["kernel"][:E] + ip["bias"]  # [B, T_dec, E]
    k_ctx = ip["kernel"][E:]
    D = enc.enc_states.shape[-1]
    state = enc.dec_in_state
    context = emb_proj.new_zeros((B, D))
    coverage = emb_proj.new_zeros((B, T_enc))
    outputs, attn_dists, p_gens = [], [], []
    for t in range(emb_proj.shape[1]):
        x = emb_proj[:, t] + context @ k_ctx
        res = _decoder_core(params, hps, enc, mask_blk, state, coverage, x,
                            plan)
        state, context, coverage = res["state"], res["context"], \
            res["coverage"]
        outputs.append(res["output"])
        attn_dists.append(res["attn_dist"])
        p_gens.append(res["p_gen"])
    outputs_t = torch.stack(outputs)  # [T_dec, B, H]
    attn_t = torch.stack(attn_dists)  # [T_dec, B, T_enc]
    if plan is not None:  # the whole rows, for the copy scatter
        attn_t = collectives.gather_sp(attn_t, 2)
    p_gens_t = torch.stack(p_gens)  # [T_dec, B]

    # the projection and the loss over all steps at once: the [T_dec, B,
    # V] f32 scores are also kept for the backward, so the training peak
    # grows by about twice their size; --remat recomputes them in the
    # backward instead, and --loss_chunk streams them in chunks of
    # decoder steps in both passes
    dec_mask = arrays["dec_padding_mask"]
    w = params["output_projection"]["w"]
    v = params["output_projection"]["v"]
    targets_t = arrays["target_batch"].T  # [T_dec, B]
    if hps.loss_chunk > 0:
        if hps.pointer_gen:
            gold = loss_ops.streaming_gold_probs(
                outputs_t, attn_t, p_gens_t, targets_t,
                arrays["enc_batch_extend_vocab"], w, v,
                chunk=hps.loss_chunk, compute_dtype=hps.compute_dtype)
            loss = loss_ops.pointer_nll(gold.T, dec_mask)
        else:
            loss = loss_ops.streaming_softmax_cross_entropy(
                outputs_t, targets_t, dec_mask.T, w, v,
                chunk=hps.loss_chunk, compute_dtype=hps.compute_dtype)
    else:
        def scores_loss(outputs_t, attn_t, p_gens_t):
            scores = loss_ops.vocab_scores(outputs_t, w, v,
                                           hps.compute_dtype)
            if hps.pointer_gen:
                gold = loss_ops.gold_mixture_prob_from_scores(
                    scores, attn_t, p_gens_t, targets_t,
                    arrays["enc_batch_extend_vocab"])
                return loss_ops.pointer_nll(gold.T, dec_mask)
            return loss_ops.softmax_cross_entropy_baseline(
                scores.transpose(0, 1), arrays["target_batch"], dec_mask)

        loss = maybe_remat(hps, scores_loss)(outputs_t, attn_t, p_gens_t)
    attn_b = attn_t.transpose(0, 1)  # [B, T_dec, T_enc]
    if hps.coverage:
        cov_loss = loss_ops.coverage_loss(attn_b, dec_mask)
    else:
        cov_loss = loss.new_zeros(())
    return TrainOutput(loss=loss, coverage_loss=cov_loss,
                       total_loss=loss + hps.cov_loss_wt * cov_loss,
                       attn_dists=attn_b, p_gens=p_gens_t.T)


def run_encoder(params: Params, hps: HParams,
                arrays: Dict[str, torch.Tensor]) -> EncoderOutput:
    """Beam-search encoder pass (model.py:347-364)."""
    return encode(params, hps, arrays["enc_batch"], arrays["enc_lens"],
                  arrays["enc_padding_mask"])


def final_distribution(hps: HParams, vocab_dist: torch.Tensor,
                       attn_dist: torch.Tensor, p_gen: torch.Tensor,
                       enc_batch_extend_vocab: torch.Tensor) -> torch.Tensor:
    """Extended-vocab mixture distribution [N, V + max_oov_buckets]
    (model.py:146-183) for N query rows.

    Repeated article words add into one index several times.  On the
    CPU ``scatter_add_`` sums them in index order, deterministically; on
    CUDA it adds with atomics in an order that may change from run to
    run, so the last bits of a repeated word's probability can differ
    between runs (a few ulp of f32, far below what top-k ties need)."""
    N, V = vocab_dist.shape
    out = vocab_dist.new_zeros((N, V + hps.max_oov_buckets))
    out[:, :V] = p_gen[:, None] * vocab_dist
    out.scatter_add_(1, enc_batch_extend_vocab.long(),
                     (1.0 - p_gen)[:, None] * attn_dist)
    return out


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on a nonnegative last axis: values in descending
    order, and on equal values the lower index first.  torch.topk does
    not promise an order among equal values, so the index rides in the
    low 32 bits of an int64 key whose high bits are the value's float
    bits (monotonic in the value for x >= 0): the keys are distinct and
    their order is exactly (value descending, index ascending)."""
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    rank = (n - 1) - torch.arange(n, device=x.device, dtype=torch.int64)
    _, idx = torch.topk((bits << 32) | rank, k, dim=-1)
    return torch.gather(x, -1, idx), idx


def decode_onestep_shared(params: Params, hps: HParams, enc: EncoderOutput,
                          enc_mask: torch.Tensor, ext_ids: torch.Tensor,
                          latest_tokens: torch.Tensor,
                          state: Tuple[torch.Tensor, torch.Tensor],
                          prev_coverage: torch.Tensor,
                          nb: Optional[int] = None) -> DecodeStepOutput:
    """One beam-search decoder step for B articles x K hypotheses, with
    the reference's decode-mode semantics (attention_decoder.py:138-160):

      1. attention at the PREVIOUS state rebuilds the previous context
         and advances coverage (the only place coverage advances);
      2. merge input + context, step the cell;
      3. attention at the new state WITHOUT advancing coverage;
      4. p_gen, output projection, pointer mixture, top-2*beam.

    enc leaves are [B, T_enc, ...] with no hypothesis axis and are
    shared by the K hypotheses; enc_mask/ext_ids [B, T_enc];
    latest_tokens [B, K] fixed-vocab ids (the caller maps OOV -> UNK);
    state (c, h) [B, K, H]; prev_coverage [B, K, T_enc].  ``nb`` (the
    slot engine, JAX pointer_generator.py:393-423): both attends read the
    first nb encoder blocks only (ops/attention.attend_shared).  Where T
    is sharded over sp, enc and the coverage hold this rank's block and
    enc_mask and ext_ids the whole article: the attends run on the block
    and merge over sp, the second gathering the whole row's attention
    for the copy distribution and the step's output."""
    dp = params["decoder"]
    use_cov = hps.coverage
    block = resolve_enc_block(hps) if nb is not None else 0
    plan = _t_sharded(hps)
    if plan is not None:
        enc_mask = collectives.sp_block_of(enc_mask, 1).contiguous()
    ctx_prev, _, cov = attn_ops.attend_shared(
        dp["attention"], enc.enc_states, enc.enc_features, enc_mask,
        state, prev_coverage if use_cov else None, use_cov,
        nb=nb, block=block, plan=plan)
    if cov is None:
        cov = prev_coverage
    inp_emb = collectives.embed(params["embedding"],
                                latest_tokens)  # [B, K, E]
    x = _linear(dp["input_linear"], inp_emb, ctx_prev)
    cell_out, new_state = lstm_ops.lstm_cell(dp["cell"], x, state)
    context, attn_dist, _ = attn_ops.attend_shared(
        dp["attention"], enc.enc_states, enc.enc_features, enc_mask,
        new_state, cov if use_cov else None, use_cov, nb=nb, block=block,
        plan=plan, full_attn=True)
    p_gen = torch.sigmoid(
        _linear(dp["pgen_linear"], context, new_state[0], new_state[1], x)
    )[..., 0]  # [B, K]
    output = _linear(dp["output_linear"], cell_out, context)
    vocab_scores = loss_ops.vocab_scores(
        output, params["output_projection"]["w"],
        params["output_projection"]["v"], hps.compute_dtype)
    vocab_dist = torch.softmax(vocab_scores, dim=-1)  # [B, K, V]
    B, K = latest_tokens.shape
    if hps.pointer_gen:
        ext_k = ext_ids[:, None, :].expand(B, K, ext_ids.shape[-1])
        final_dist = final_distribution(
            hps, vocab_dist.reshape(B * K, -1),
            attn_dist.reshape(B * K, -1), p_gen.reshape(B * K),
            ext_k.reshape(B * K, -1)).reshape(B, K, -1)
    else:
        final_dist = vocab_dist
    topk_probs, topk_ids = top_k(final_dist, 2 * hps.beam_size)
    return DecodeStepOutput(topk_ids=topk_ids,
                            topk_log_probs=torch.log(topk_probs),
                            state=new_state, attn_dist=attn_dist, p_gen=p_gen,
                            coverage=cov)


def beam_encode(params: Params, hps: HParams,
                arrays: Dict[str, torch.Tensor]) -> EncoderOutput:
    """Batched encoder view for beam search (leaves lead with B)."""
    return run_encoder(params, hps, arrays)


def beam_adapter(hps: HParams):
    """(init_state, step) closures implementing the beam protocol for the
    LSTM pointer-generator.  State = decoder cell (c, h) + coverage."""
    K = hps.beam_size

    def init_state(params: Params, enc: EncoderOutput):
        del params
        c, h = enc.dec_in_state  # [B, H]
        B, H = c.shape
        T_enc = enc.enc_states.shape[1]  # this rank's block where sharded
        return {
            "cell_c": c[:, None, :].expand(B, K, H).contiguous(),
            "cell_h": h[:, None, :].expand(B, K, H).contiguous(),
            "coverage": c.new_zeros((B, K, T_enc)),
        }

    def step(params: Params, enc: EncoderOutput, enc_mask: torch.Tensor,
             ext_ids: torch.Tensor, t: torch.Tensor, latest: torch.Tensor,
             state, nb: Optional[int] = None) -> BeamStepOut:
        del t  # the LSTM state carries all positional context
        out = decode_onestep_shared(params, hps, enc, enc_mask, ext_ids,
                                    latest,
                                    (state["cell_c"], state["cell_h"]),
                                    state["coverage"], nb=nb)
        return BeamStepOut(
            topk_ids=out.topk_ids, topk_log_probs=out.topk_log_probs,
            attn_dist=out.attn_dist, p_gen=out.p_gen,
            state={"cell_c": out.state[0], "cell_h": out.state[1],
                   "coverage": out.coverage})

    return init_state, step


#: the slot engine's length-bounded adapter: the step with a leading nb
beam_adapter_masked = masked_adapter(beam_adapter)


def pad_enc_view(enc: EncoderOutput, t_target: int) -> EncoderOutput:
    """Zero-pad a bucket-width encoder view's time axis (axis 1) to
    ``t_target`` (the prefill -> pack hand-off; JAX
    pointer_generator.py:509).  The biLSTM encoder writes zeros past an
    article's length, so a bucket-width encode padded is the full-width
    one; dec_in_state has no time axis."""
    def pad(x):
        if x.shape[1] >= t_target:
            return x
        return F.pad(x, (0, 0, 0, t_target - x.shape[1]))

    return EncoderOutput(enc_states=pad(enc.enc_states),
                         enc_features=pad(enc.enc_features),
                         dec_in_state=enc.dec_in_state)
