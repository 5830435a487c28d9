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

The streaming ``--loss_chunk`` forms (JAX ops/losses.py:139-318) are not
ported yet (config.ROADMAP_LOSS_CHUNK); HParams.validate refuses the
flag.
"""

from __future__ import annotations

import torch

from textsummarization_on_flink_tpu_torch.config import ROADMAP_BF16


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
    return torch.sum(nll * dec_padding_mask) / torch.sum(dec_padding_mask)


def project_scores(x: torch.Tensor, w: torch.Tensor,
                   compute_dtype: str = "float32") -> torch.Tensor:
    """x @ w, the vocab projection every loss and decode head goes
    through.  f32 only in the port (the JAX package's bf16 operands wait
    for config.ROADMAP_BF16)."""
    if compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: {ROADMAP_BF16}")
    return x @ w
