"""Sequence-parallel self-attention over the sp ranks: ring and Ulysses.

Port of the JAX package's parallel/ring_attention.py for the
transformer encoder's self-attention (models/transformer.py dispatches
here under ``--sp_attention`` with sp > 1, a pad mask and no causal
mask).  Each sp rank holds its block of queries, keys and values
([B, T/sp, nh, hd]) and of the pad mask ([B, T/sp]).

Ring (``ring_self_attention``): an autograd ``Function``.  Its forward
rotates K/V/mask around the ring (``collectives.ring_pass``, one
``batch_isend_irecv`` per hop) while the JAX package's online softmax
accumulates the output (ring_attention.py:76-120 there): padding keys at
-1e30 before the max, their probabilities exact zeros, and a query row
whose keys are all padding giving 0.  It saves the log-sum-exp; its
backward rotates K/V again with their dK/dV accumulators riding along,
which come home after sp hops.  The full [T, T] scores never exist on a
rank.

Ulysses (``ulysses_self_attention``): a differentiable all-to-all moves
q/k/v from sequence blocks to head groups ([B, T, nh/sp, hd]), the mask
is all-gathered, full attention runs per local head group, and a second
all-to-all moves the context back.  nh % sp == 0.

Both take f32 q/k/v, as the JAX package hands them (its
transformer.py:246-255), and their per-block products are plain
``torch.matmul``: the JAX package computes them as einsums outside any
Pallas kernel.
"""

from __future__ import annotations

import torch

from textsummarization_on_flink_tpu_torch.parallel import collectives

NEG = -1e30


def _block_logits(q: torch.Tensor, k: torch.Tensor, kmask: torch.Tensor,
                  sm_scale: float) -> torch.Tensor:
    """Masked scores [B, nh, Tq, Tk] of q [B, Tq, nh, hd] against one
    key block k [B, Tk, nh, hd], kmask [B, Tk] (padding keys at -1e30)."""
    logits = torch.einsum("bqnd,bknd->bnqk", q, k) * sm_scale
    return torch.where(kmask[:, None, None, :] > 0, logits, NEG)


def _pack(*ts: torch.Tensor) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


def _unpack(flat: torch.Tensor, *likes: torch.Tensor):
    out, i = [], 0
    for t in likes:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mask, plan, sm_scale):
        n = collectives.axis_size("sp", plan)
        B, Tb, nh, hd = q.shape
        m = q.new_full((B, nh, Tb), NEG)
        l = q.new_zeros((B, nh, Tb))
        o = q.new_zeros((B, nh, Tb, hd))
        k_cur, v_cur, mask_cur = k, v, mask.to(q.dtype)
        for i in range(n):
            logits = _block_logits(q, k_cur, mask_cur, sm_scale)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            p = p * (mask_cur[:, None, None, :] > 0)  # exact zeros
            scale_old = torch.exp(m - m_new)
            l = l * scale_old + p.sum(dim=-1)
            o = o * scale_old[..., None] + torch.einsum(
                "bnqk,bknd->bnqd", p, v_cur)
            m = m_new
            if i < n - 1:  # the last block's rotation is never read
                k_cur, v_cur, mask_cur = _unpack(
                    collectives.ring_pass(plan, _pack(k_cur, v_cur,
                                                      mask_cur)),
                    k_cur, v_cur, mask_cur)
        # all-padding rows: l = 0 -> a zero output, and an infinite lse
        # that zeroes their probabilities in the backward
        out = o / torch.clamp(l[..., None], min=1e-30)
        lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                          torch.full_like(l, float("inf")))
        out = out.transpose(1, 2).contiguous()  # [B, Tq, nh, hd]
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.plan, ctx.sm_scale = plan, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        plan, sm_scale = ctx.plan, ctx.sm_scale
        n = collectives.axis_size("sp", plan)
        g = g.contiguous()
        delta = torch.einsum("bqnd,bqnd->bnq", g, out)  # rowsum(dO * O)
        dq = torch.zeros_like(q)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        k_cur, v_cur, mask_cur = k, v, mask.to(q.dtype)
        for i in range(n):
            logits = _block_logits(q, k_cur, mask_cur, sm_scale)
            p = torch.exp(logits - lse[..., None])
            p = p * (mask_cur[:, None, None, :] > 0)
            dv = dv + torch.einsum("bnqk,bqnd->bknd", p, g)
            dp = torch.einsum("bqnd,bknd->bnqk", g, v_cur)
            ds = p * (dp - delta[..., None]) * sm_scale
            dq = dq + torch.einsum("bnqk,bknd->bqnd", ds, k_cur)
            dk = dk + torch.einsum("bnqk,bqnd->bknd", ds, q)
            # dK/dV ride with their block; after n hops they are home
            if i < n - 1:
                k_cur, v_cur, mask_cur, dk, dv = _unpack(
                    collectives.ring_pass(plan, _pack(k_cur, v_cur, mask_cur,
                                                      dk, dv)),
                    k_cur, v_cur, mask_cur, dk, dv)
            else:
                dk, dv = _unpack(collectives.ring_pass(plan, _pack(dk, dv)),
                                 dk, dv)
        return dq, dk, dv, None, None, None


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: torch.Tensor, sm_scale: float,
                        ) -> torch.Tensor:
    """This rank's attention output [B, T/sp, nh, hd] of its queries
    against the whole sequence's keys and values, over the bound plan's
    sp ring.  q/k/v [B, T/sp, nh, hd] f32, kv_mask [B, T/sp]."""
    return _Ring.apply(q, k, v, kv_mask, collectives.current(), sm_scale)


def _to_heads(x: torch.Tensor, sp: int) -> torch.Tensor:
    """[B, Tb, nh, hd] sequence block -> [B, sp * Tb, nh/sp, hd] head
    group (an all-to-all over sp)."""
    B, Tb, nh, hd = x.shape
    blocks = x.reshape(B, Tb, sp, nh // sp, hd).permute(2, 0, 1, 3, 4)
    got = collectives.all_to_all_sp(blocks.contiguous())  # [sp, B, Tb, ..]
    return got.permute(1, 0, 2, 3, 4).reshape(B, sp * Tb, nh // sp, hd)


def _to_blocks(x: torch.Tensor, sp: int) -> torch.Tensor:
    """The inverse of ``_to_heads``."""
    B, T, nhl, hd = x.shape
    Tb = T // sp
    blocks = x.reshape(B, sp, Tb, nhl, hd).permute(1, 0, 2, 3, 4)
    got = collectives.all_to_all_sp(blocks.contiguous())  # [sp, B, Tb, ..]
    return got.permute(1, 2, 0, 3, 4).reshape(B, Tb, sp * nhl, hd)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_mask: torch.Tensor,
                           sm_scale: float) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism (JAX ring_attention.py:
    140-170): q/k/v [B, T/sp, nh, hd] -> [B, T, nh/sp, hd], full
    attention per local head group, and back.  Requires nh % sp == 0."""
    sp = collectives.axis_size("sp")
    qh, kh, vh = (_to_heads(x, sp) for x in (q, k, v))
    mask_full = collectives.gather_sp_data(kv_mask, 1)
    logits = _block_logits(qh, kh, mask_full, sm_scale)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * (mask_full[:, None, None, :] > 0)  # all-padding row -> 0
    ctx = torch.einsum("bnqk,bknd->bqnd", probs, vh)
    return _to_blocks(ctx, sp)


def sp_attention(mode: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, kv_mask: torch.Tensor,
                 sm_scale: float) -> torch.Tensor:
    """The bound plan's sequence-parallel attention: ``mode`` 'ring' or
    'ulysses'."""
    if mode == "ring":
        return ring_self_attention(q, k, v, kv_mask, sm_scale)
    if mode == "ulysses":
        return ulysses_self_attention(q, k, v, kv_mask, sm_scale)
    raise ValueError(f"unknown sp_attention mode {mode!r}")
