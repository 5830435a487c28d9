"""Sequence losses: masked-average NLL over the pointer mixture + coverage.

Port of the JAX package's ops/losses.py (materialised forms).  Parity
targets in the reference:

  * ``mask_and_avg`` (model.py:446-460): per-example sum over steps of
    masked values, normalised by the true decoder length, then the batch
    mean;
  * the pointer NLL (model.py:252-265): -log of the gold token's
    probability under the final (mixture) distribution;
  * ``coverage_loss`` (model.py:463-480): sum_i min(a_i^t, c_i^t) per
    step, coverage starting at zero and accumulating attention.

The gold probability of target w is computed without the extended-vocab
distribution or the [T, B, V] softmax:

    p_gen * exp(score_w - logsumexp(scores)) * [w < V]
        + (1 - p_gen) * sum_{i: ext_ids_i = w} a_i

The streaming ``--loss_chunk`` forms (JAX ops/losses.py:139-318),
``streaming_gold_probs`` and ``streaming_softmax_cross_entropy``, take
the pre-projection decoder outputs and project [chunk, B, V] scores at
a time; each is a ``torch.autograd.Function`` that saves only its inputs
and whose backward rebuilds one chunk's scores at a time, so no
[T, B, V] tensor exists in either pass.  ``project_scores`` is the one
vocab projection of the losses and the decode heads: bf16 operands with
f32 sums and an f32 result under ``compute_dtype=bfloat16``;
``vocab_scores`` adds the bias and, on a tp mesh, gathers the vocab
shards.  On a dp mesh the baseline cross-entropy divides by its rank's
share of the global token count (``collectives.dp_share``), so the dp
ranks' mean is the global batch's loss.
"""

from __future__ import annotations

from typing import Tuple

import torch

from textsummarization_on_flink_tpu_torch.parallel import collectives


def mask_and_avg(values: torch.Tensor,
                 padding_mask: torch.Tensor) -> torch.Tensor:
    """values, padding_mask: [B, T] -> scalar (model.py:446-460)."""
    dec_lens = torch.sum(padding_mask, dim=1)
    values_per_ex = torch.sum(values * padding_mask, dim=1) / dec_lens
    return torch.mean(values_per_ex)


def gold_mixture_prob_from_scores(vocab_scores: torch.Tensor,
                                  attn_dists: torch.Tensor,
                                  p_gens: torch.Tensor,
                                  targets: torch.Tensor,
                                  enc_batch_extend_vocab: torch.Tensor,
                                  ) -> torch.Tensor:
    """Gold-target probability for all steps at once, from raw vocab
    scores, in log space.

    vocab_scores [T, B, V]; attn_dists [T, B, T_enc]; p_gens [T, B];
    targets [T, B] extended ids; enc_batch_extend_vocab [B, T_enc].
    Returns [T, B]."""
    V = vocab_scores.shape[-1]
    lse = torch.logsumexp(vocab_scores, dim=-1)  # [T, B]
    in_vocab = targets < V
    safe_t = torch.where(in_vocab, targets, 0).long()
    score_t = torch.gather(vocab_scores, -1, safe_t[..., None])[..., 0]
    gen_prob = torch.where(in_vocab, torch.exp(score_t - lse), 0.0)
    copy_prob = torch.sum(
        attn_dists * (enc_batch_extend_vocab[None] == targets[..., None]),
        dim=-1)
    return p_gens * gen_prob + (1.0 - p_gens) * copy_prob


def pointer_nll(gold_probs: torch.Tensor,
                dec_padding_mask: torch.Tensor) -> torch.Tensor:
    """-log(gold prob), masked-averaged, with no epsilon (model.py:261).
    gold_probs: [B, T]."""
    return mask_and_avg(-torch.log(gold_probs), dec_padding_mask)


def coverage_loss(attn_dists: torch.Tensor,
                  dec_padding_mask: torch.Tensor) -> torch.Tensor:
    """attn_dists [B, T_dec, T_enc] -> scalar (model.py:463-480).

    covloss_t = sum_i min(a_i^t, c_i^t), c_0 = 0, c_{t+1} = c_t + a_t:
    the coverage at step t is an exclusive prefix sum over the steps."""
    coverage = torch.cumsum(attn_dists, dim=1) - attn_dists
    covlosses = torch.sum(torch.minimum(attn_dists, coverage), dim=2)
    return mask_and_avg(covlosses, dec_padding_mask)


def softmax_cross_entropy_baseline(vocab_scores: torch.Tensor,
                                   targets: torch.Tensor,
                                   dec_padding_mask: torch.Tensor,
                                   ) -> torch.Tensor:
    """The non-pointer loss: tf.contrib.seq2seq.sequence_loss with its
    defaults (model.py:268), the global token-weighted mean
    sum(nll * mask) / sum(mask)."""
    log_probs = torch.log_softmax(vocab_scores, dim=-1)
    nll = -torch.gather(log_probs, -1, targets.long()[..., None])[..., 0]
    return torch.sum(nll * dec_padding_mask) / collectives.dp_share(
        torch.sum(dec_padding_mask))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] of bf16 operands with f32 sums and an f32
    result.  On the card one GEMM of bf16 operands
    (``torch.mm(out_dtype=...)``; device.resolve_device turns the bf16
    reduced-precision reduction off).  The CPU has no such GEMM, so the
    operands are widened to f32, which gives the same exact products."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Bf16Projection(torch.autograd.Function):
    """x @ w with both operands rounded to bf16 (jnp.dot(x.astype(bf16),
    w.astype(bf16), preferred_element_type=f32)).  Its backward is what
    jax.vjp gives that expression: each cotangent is an f32 product of
    the f32 gradient with the other bf16 operand, rounded to bf16 (the
    operand's dtype) and widened back (the astype's transpose).  Saves
    the two bf16 operands."""

    @staticmethod
    def forward(ctx, x, w):
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x.dtype, w.dtype)
        return _mm_f32(xb, wb).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        d_x = d_w = None
        if ctx.needs_input_grad[0]:
            d_x = (g2 @ wb.float().T).to(torch.bfloat16).to(ctx.dtypes[0])
            d_x = d_x.reshape(*g.shape[:-1], wb.shape[0])
        if ctx.needs_input_grad[1]:
            d_w = (xb.float().T @ g2).to(torch.bfloat16).to(ctx.dtypes[1])
        return d_x, d_w


def project_scores(x: torch.Tensor, w: torch.Tensor,
                   compute_dtype: str = "float32") -> torch.Tensor:
    """x @ w, the vocab projection every loss and decode head goes
    through (JAX ops/losses.py:139-151): in f32, or with bf16 operands,
    f32 sums and an f32 result under ``compute_dtype="bfloat16"``."""
    if compute_dtype == "bfloat16":
        return _Bf16Projection.apply(x, w)
    return x @ w


def vocab_scores(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """``project_scores(x, w) + v``, the vocab scores of every loss and
    decode head.  On a tp mesh (parallel/collectives.py) ``w`` [H, V/tp]
    and ``v`` [V/tp] are this rank's vocab shards: its [..., V/tp] scores
    are all-gathered over tp along the vocab axis (the per-step
    scores-shaped all-gather the JAX package's ``tp_scores_bytes``
    prices), and ``x``'s gradient is summed over tp."""
    if collectives.tp_size() == 1:
        return project_scores(x, w, compute_dtype) + v
    return collectives.gather_vocab(project_scores(
        collectives.copy_to_tp(x), w, compute_dtype) + v)


def _chunks(chunk: int, T: int) -> Tuple[int, int]:
    """(chunks, padded length) for T steps in chunks of ``chunk``."""
    n = -(-T // chunk)
    return n, n * chunk


def _pad_steps(x: torch.Tensor, length: int) -> torch.Tensor:
    """Zero rows after x's leading T up to ``length`` (_pack_chunks,
    JAX ops/losses.py:160-173: the padded tail computes on zeros, is
    sliced away in the forward and gets zero cotangents)."""
    pad = length - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _clamp_chunk(chunk: int, T: int) -> int:
    return int(min(max(chunk, 1), T))


def _chunk_gold(o, a, p, t, ext, w, v, compute_dtype):
    scores = vocab_scores(o, w, v, compute_dtype)  # [chunk, B, V]
    return gold_mixture_prob_from_scores(scores, a, p, t, ext)


def _chunk_nll(o, t, w, v, compute_dtype):
    scores = vocab_scores(o, w, v, compute_dtype)
    log_probs = torch.log_softmax(scores, dim=-1)
    return -torch.gather(log_probs, -1, t.long()[..., None])[..., 0]


def _recompute_grads(fn, diff, g_c, plan=None):
    """The vjp of one chunk: ``fn(*diff)`` rebuilt with ``diff`` as fresh
    leaves (its scores recomputed), differentiated against the cotangent
    ``g_c``.  ``plan``: the mesh the forward ran on (a backward runs on
    autograd's thread, where the forward's binding is not seen)."""
    leaves = [x.detach().requires_grad_(True) for x in diff]
    with torch.enable_grad(), collectives.bound(plan):
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, g_c)


class _StreamingGold(torch.autograd.Function):
    """Gold mixture probability [T, B] from decoder outputs [T, B, H],
    ``chunk`` steps at a time (JAX ``_streaming_gold`` and its custom
    VJP).  Saves its inputs only; the backward rebuilds each chunk's
    scores and sums dw, dv over the chunks in order."""

    @staticmethod
    def forward(ctx, chunk, compute_dtype, outputs, attn_dists, p_gens,
                targets, ext, w, v):
        T = targets.shape[0]
        n, Tp = _chunks(chunk, T)
        o, a, p, t = (_pad_steps(x, Tp) for x in
                      (outputs, attn_dists, p_gens, targets))
        gold = torch.cat([
            _chunk_gold(o[i * chunk:(i + 1) * chunk],
                        a[i * chunk:(i + 1) * chunk],
                        p[i * chunk:(i + 1) * chunk],
                        t[i * chunk:(i + 1) * chunk], ext, w, v,
                        compute_dtype) for i in range(n)])
        ctx.save_for_backward(outputs, attn_dists, p_gens, targets, ext, w,
                              v)
        ctx.chunk, ctx.compute_dtype = chunk, compute_dtype
        ctx.plan = collectives.current()
        return gold[:T]

    @staticmethod
    def backward(ctx, g):
        outputs, attn_dists, p_gens, targets, ext, w, v = ctx.saved_tensors
        chunk, cd = ctx.chunk, ctx.compute_dtype
        T = targets.shape[0]
        n, Tp = _chunks(chunk, T)
        o, a, p, t, gp = (_pad_steps(x, Tp) for x in
                          (outputs, attn_dists, p_gens, targets, g))
        dw, dv = torch.zeros_like(w), torch.zeros_like(v)
        do, da, dp = [], [], []
        for i in range(n):
            s = slice(i * chunk, (i + 1) * chunk)
            t_c = t[s]
            do_c, da_c, dp_c, dw_c, dv_c = _recompute_grads(
                lambda o_, a_, p_, w_, v_: _chunk_gold(o_, a_, p_, t_c, ext,
                                                       w_, v_, cd),
                (o[s], a[s], p[s], w, v), gp[s], ctx.plan)
            dw, dv = dw + dw_c, dv + dv_c
            do.append(do_c)
            da.append(da_c)
            dp.append(dp_c)
        return (None, None, torch.cat(do)[:T], torch.cat(da)[:T],
                torch.cat(dp)[:T], None, None, dw, dv)


def streaming_gold_probs(outputs: torch.Tensor, attn_dists: torch.Tensor,
                         p_gens: torch.Tensor, targets: torch.Tensor,
                         enc_batch_extend_vocab: torch.Tensor,
                         w: torch.Tensor, v: torch.Tensor, *, chunk: int,
                         compute_dtype: str = "float32") -> torch.Tensor:
    """Chunked gold_mixture_prob_from_scores from pre-projection decoder
    outputs (JAX ops/losses.py:231-249).

    outputs [T, B, H] (step-major); attn_dists [T, B, T_enc]; p_gens,
    targets [T, B]; enc_batch_extend_vocab [B, T_enc]; w [H, V]; v [V].
    Returns [T, B], equal to the materialised formula on
    ``project_scores(outputs, w) + v``, with one [chunk, B, V] scores
    block at a time in the forward and the backward."""
    T = outputs.shape[0]
    return _StreamingGold.apply(_clamp_chunk(chunk, T), compute_dtype,
                                outputs, attn_dists, p_gens, targets,
                                enc_batch_extend_vocab, w, v)


class _StreamingNll(torch.autograd.Function):
    """Per-token NLL [T, B] of the plain vocab softmax, ``chunk`` steps at
    a time (JAX ``_streaming_ce_nll`` and its custom VJP)."""

    @staticmethod
    def forward(ctx, chunk, compute_dtype, outputs, targets, w, v):
        T = targets.shape[0]
        n, Tp = _chunks(chunk, T)
        o, t = _pad_steps(outputs, Tp), _pad_steps(targets, Tp)
        nll = torch.cat([
            _chunk_nll(o[i * chunk:(i + 1) * chunk],
                       t[i * chunk:(i + 1) * chunk], w, v, compute_dtype)
            for i in range(n)])
        ctx.save_for_backward(outputs, targets, w, v)
        ctx.chunk, ctx.compute_dtype = chunk, compute_dtype
        ctx.plan = collectives.current()
        return nll[:T]

    @staticmethod
    def backward(ctx, g):
        outputs, targets, w, v = ctx.saved_tensors
        chunk, cd = ctx.chunk, ctx.compute_dtype
        T = targets.shape[0]
        n, Tp = _chunks(chunk, T)
        o, t, gp = (_pad_steps(x, Tp) for x in (outputs, targets, g))
        dw, dv = torch.zeros_like(w), torch.zeros_like(v)
        do = []
        for i in range(n):
            s = slice(i * chunk, (i + 1) * chunk)
            t_c = t[s]
            do_c, dw_c, dv_c = _recompute_grads(
                lambda o_, w_, v_: _chunk_nll(o_, t_c, w_, v_, cd),
                (o[s], w, v), gp[s], ctx.plan)
            dw, dv = dw + dw_c, dv + dv_c
            do.append(do_c)
        return None, None, torch.cat(do)[:T], None, dw, dv


def streaming_softmax_cross_entropy(outputs: torch.Tensor,
                                    targets: torch.Tensor,
                                    dec_padding_mask: torch.Tensor,
                                    w: torch.Tensor, v: torch.Tensor, *,
                                    chunk: int,
                                    compute_dtype: str = "float32",
                                    ) -> torch.Tensor:
    """Chunked softmax_cross_entropy_baseline from pre-projection outputs
    (JAX ops/losses.py:306-318), all step-major: outputs [T, B, H],
    targets and dec_padding_mask [T, B].  The same global token-weighted
    mean as the materialised formula."""
    T = outputs.shape[0]
    nll = _StreamingNll.apply(_clamp_chunk(chunk, T), compute_dtype,
                              outputs, targets, w, v)
    return torch.sum(nll * dec_padding_mask) / collectives.dp_share(
        torch.sum(dec_padding_mask))
