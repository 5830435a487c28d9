"""Batched beam search on the device.

Port of the batch path of the JAX package's decode/beam_search.py, with
the same semantics as the reference's Python beam search
(beam_search.py of the pointer-generator):

  * at step 0 only the first (all-identical) hypothesis is expanded;
  * each live hypothesis proposes ``2*beam_size`` continuations;
  * candidates are processed in descending score order: a STOP candidate
    joins the results only after ``min_dec_steps`` tokens (earlier STOPs
    are discarded), anything else refills the live beam, and processing
    halts once either pool holds ``beam_size`` entries;
  * the search ends when ``beam_size`` results exist or
    ``max_dec_steps`` is reached; no results falls back to the live beam;
  * the final ranking is by length-normalized log-prob, the length
    counting the START token.

The per-step triage is the JAX package's cumulative-sum formulation over
the sorted ``beam*2*beam`` candidates, with B articles searched at once
(the article axis the JAX package gets from vmap is written out).  Each
step appends one column of backpointers (parent slot, chosen token, the
step's attention rows and p_gen) to history buffers updated in place;
a finished hypothesis is four scalars.  The loop is the JAX package's
``chunked`` kind: a masked update of ``_SELECT_FIELDS`` per step (an
article whose search has ended keeps them; its history writes land in
columns the backtrack never reads), and the early-exit test once every
C steps (TS_BEAM_CHUNK, default 25), one host sync per chunk.
``_finalize_beam`` then backtracks the winning trajectory on the host in
numpy.  Tokens equal the JAX package's on the same params.

The slot functions below (the JAX package's beam_search.py:505-1080)
split that search over a persistent state of ``slots`` resident
articles, for continuous serving: an article is prefilled at its serve
bucket, packed into a free slot, stepped a chunk at a time beside the
others, and unpacked when its search ends, while the other slots keep
going.  The dense state keeps every resident at max_enc_steps; the
paged one pools the encoder-axis tensors in pages of decode_enc_block
rows, addressed through a per-slot page table.  Both run the same beam
body as the batch search.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch.profiler import record_function

from textsummarization_on_flink_tpu_torch.config import (
    HParams,
    beam_chunk_from_env,
    resolve_enc_block,
)
from textsummarization_on_flink_tpu_torch.data.vocab import (
    START_ID,
    STOP_ID,
    UNK_ID,
)
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.models import get_family
from textsummarization_on_flink_tpu_torch.obs import profile as profile_lib
from textsummarization_on_flink_tpu_torch.parallel import collectives

NEG = -1e30  # effectively -inf, without inf-inf NaN hazards

#: decode steps run so far, over all batches (chunks count whole: an
#: article's masked steps after its search ended are run all the same);
#: a run sets it to 0 before the steps it wants counted
steps_run = 0


class BeamSearchOutput(NamedTuple):
    """Best hypothesis per article (host numpy, batch axis leading)."""

    tokens: np.ndarray  # [B, T_dec+1] extended-vocab ids, [0]=START
    length: np.ndarray  # [B] token count including START
    avg_log_prob: np.ndarray  # [B]
    attn_dists: np.ndarray  # [B, T_dec, T_enc] attention per generated token
    p_gens: np.ndarray  # [B, T_dec]


@dataclasses.dataclass
class _BeamState:
    """Search state of B articles (the JAX package's _BeamState with a
    leading article axis).  History buffers are T+1 wide: column T is the
    scratch column that steps past the horizon write into."""

    t: torch.Tensor  # [B] decode step
    latest: torch.Tensor  # [B, K] extended-vocab id of each live hyp's last token
    sum_lp: torch.Tensor  # [B, K] total log prob of live hyps
    dec_state: Dict[str, torch.Tensor]  # model decode state, leaves [B, K, ...]
    n_res: torch.Tensor  # [B] filled result slots
    parent_hist: torch.Tensor  # [B, K, T+1] parent slot per step
    tok_hist: torch.Tensor  # [B, K, T+1] chosen token per step
    attn_steps: torch.Tensor  # [B, K, T+1, T_enc] per-parent-slot attention
    pgen_steps: torch.Tensor  # [B, K, T+1] per-parent-slot p_gen
    res_lp: torch.Tensor  # [B, K+1] (slot K is a scratch slot)
    res_len: torch.Tensor  # [B, K+1] token count incl START
    res_t: torch.Tensor  # [B, K+1] finish step of each result
    res_par: torch.Tensor  # [B, K+1] parent (pre-expansion) slot at finish


# the order-sensitive small fields: the only ones the masked update
# protects once an article's search has ended (beam_search.py:316 of the
# JAX package).  Histories and dec_state take the step's writes anyway:
# they land in columns the backtrack never reads, and dec_state is not
# read again.
_SELECT_FIELDS = ("t", "latest", "sum_lp", "n_res",
                  "res_lp", "res_len", "res_t", "res_par")


def _init_beam_state(hps: HParams, B: int, T_enc: int,
                     dec_state: Dict[str, torch.Tensor],
                     device: torch.device,
                     attn_cols: Optional[int] = None) -> _BeamState:
    """The step-0 search state of B articles.  ``attn_cols`` narrows the
    attention history to that many columns (the paged slots keep one
    scratch column and write each step's rows into the page pool)."""
    K, T = hps.beam_size, hps.max_dec_steps
    ilong = dict(device=device, dtype=torch.long)
    f32 = dict(device=device, dtype=torch.float32)
    return _BeamState(
        t=torch.zeros((B,), **ilong),
        latest=torch.full((B, K), START_ID, **ilong),
        sum_lp=torch.zeros((B, K), **f32),
        dec_state=dec_state,
        n_res=torch.zeros((B,), **ilong),
        parent_hist=torch.zeros((B, K, T + 1), **ilong),
        tok_hist=torch.zeros((B, K, T + 1), **ilong),
        attn_steps=torch.zeros(
            (B, K, T + 1 if attn_cols is None else attn_cols, T_enc), **f32),
        pgen_steps=torch.zeros((B, K, T + 1), **f32),
        res_lp=torch.full((B, K + 1), NEG, **f32),
        res_len=torch.ones((B, K + 1), **ilong),
        res_t=torch.zeros((B, K + 1), **ilong),
        res_par=torch.zeros((B, K + 1), **ilong),
    )


def _beam_cond(hps: HParams):
    """Per-article search-still-running predicate [B] (the reference's
    `steps < max_dec_steps and len(results) < beam_size`)."""

    def cond(s: _BeamState) -> torch.Tensor:
        return (s.t < hps.max_dec_steps) & (s.n_res < hps.beam_size)

    return cond


def _make_beam_body(params, hps: HParams, step_fn, enc, enc_mask, ext_ids,
                    attn_col_fn=None):
    """One decode step for B articles, closed over their encoder view,
    shared by the batch search and the slot steps.  ``attn_col_fn(col)``
    overrides the attention history's write column (the paged slots
    write every step into their one scratch column, 0)."""
    K = hps.beam_size
    V = hps.vocab_size
    S = K * 2 * K  # candidate count per step

    def body(s: _BeamState) -> _BeamState:
        B = s.t.shape[0]
        dev = s.t.device
        latest = torch.where(s.latest >= V, UNK_ID, s.latest)  # OOV -> UNK
        step = step_fn(params, enc, enc_mask, ext_ids, s.t, latest,
                       s.dec_state)
        # candidate pool: every live hyp x its 2K continuations
        cand_lp = s.sum_lp[:, :, None] + step.topk_log_probs  # [B, K, 2K]
        # step 0: all hyps identical -> expand only hyp 0
        first = (torch.arange(K, device=dev) == 0)[None, :, None]
        cand_lp = torch.where((s.t > 0)[:, None, None] | first, cand_lp, NEG)
        flat_lp = cand_lp.reshape(B, S)
        flat_tok = step.topk_ids.reshape(B, S)
        # stable descending, as jnp.argsort(-x): ties (the many NEG
        # candidates of step 0) keep their flat order
        order = torch.argsort(-flat_lp, dim=-1, stable=True)
        srt_lp = torch.gather(flat_lp, 1, order)
        srt_tok = torch.gather(flat_tok, 1, order)
        parent = order // (2 * K)  # originating live hyp

        # sequential triage as cumsums: counts only advance for selected
        # candidates, and a candidate is processed only while both pools
        # are still short of K
        is_stop = srt_tok == STOP_ID
        valid_stop = is_stop & (s.t >= hps.min_dec_steps)[:, None]
        non_stop = ~is_stop
        live_rank = torch.cumsum(non_stop.long(), dim=-1)  # inclusive
        res_rank = torch.cumsum(valid_stop.long(), dim=-1)
        n_res = s.n_res[:, None]
        live_sel = non_stop & (live_rank <= K) & (n_res + res_rank < K)
        res_sel = valid_stop & (n_res + res_rank <= K) & (live_rank < K)

        # --- rebuild the live beam: the first K selected, in order (a
        # stable sort of integers, not of booleans) ---
        sel = torch.argsort((~live_sel).long(), dim=-1, stable=True)[:, :K]
        ok = torch.gather(live_sel, 1, sel)
        par = torch.gather(parent, 1, sel)  # [B, K]
        new_latest = torch.gather(srt_tok, 1, sel)
        new_sum_lp = torch.where(ok, torch.gather(srt_lp, 1, sel), NEG)

        # --- append ONE backpointer column at each article's step t, in
        # place; t == T only on masked steps past the horizon, whose
        # writes land in the scratch column T ---
        bi = torch.arange(B, device=dev)[:, None]
        ki = torch.arange(K, device=dev)[None, :]
        col = s.t[:, None]
        s.parent_hist[bi, ki, col] = par
        s.tok_hist[bi, ki, col] = new_latest
        acol = col if attn_col_fn is None else attn_col_fn(col)
        s.attn_steps[bi, ki, acol] = step.attn_dist
        s.pgen_steps[bi, ki, col] = step.p_gen

        # --- record finished hypotheses as scalar backpointers; the
        # unselected candidates all write the scratch slot K ---
        slot = torch.where(res_sel, n_res + res_rank - 1, K)  # [B, S]
        res_lp = s.res_lp.scatter(1, slot, torch.where(res_sel, srt_lp, NEG))
        res_lp[:, K] = NEG  # scratch slot: restore the invariant
        res_len = s.res_len.scatter(1, slot, (s.t + 2)[:, None].expand(B, S))
        res_t = s.res_t.scatter(1, slot, s.t[:, None].expand(B, S))
        res_par = s.res_par.scatter(1, slot, parent)

        return _BeamState(
            t=s.t + 1,
            latest=new_latest,
            sum_lp=new_sum_lp,
            dec_state={k: v[bi, par] for k, v in step.state.items()},
            n_res=s.n_res + res_sel.sum(dim=-1),
            parent_hist=s.parent_hist,
            tok_hist=s.tok_hist,
            attn_steps=s.attn_steps,
            pgen_steps=s.pgen_steps,
            res_lp=res_lp,
            res_len=res_len,
            res_t=res_t,
            res_par=res_par,
        )

    return body


def _masked_step(cond, body, s: _BeamState) -> _BeamState:
    """body(s), with the order-sensitive fields of articles whose search
    had already ended carried through unchanged."""
    keep = cond(s)
    s2 = body(s)
    for f in _SELECT_FIELDS:
        new, old = getattr(s2, f), getattr(s, f)
        k = keep.reshape(keep.shape + (1,) * (new.ndim - 1))
        setattr(s2, f, torch.where(k, new, old))
    return s2


def _finalize_beam(hps: HParams, s: _BeamState) -> BeamSearchOutput:
    """Rank each article's finished pool (falling back to the live beam)
    and backtrack the winning trajectory through the backpointer columns,
    on the host (the reference's beam_search.py:158-168 plus the JAX
    package's backtrack, beam_search.py:385-442 there)."""
    K, T = hps.beam_size, hps.max_dec_steps
    h = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
         if f.name != "dec_state"}
    h = {k: v.cpu().numpy() for k, v in h.items()}
    B, T_enc = h["attn_steps"].shape[0], h["attn_steps"].shape[-1]
    neg = np.float32(NEG)
    tokens = np.full((B, T + 1), STOP_ID, np.int32)
    tokens[:, 0] = START_ID
    length = np.zeros((B,), np.int32)
    avg_lp = np.zeros((B,), np.float32)
    attn = np.zeros((B, T, T_enc), np.float32)
    pgens = np.zeros((B, T), np.float32)
    for b in range(B):
        t_b = int(h["t"][b])
        use_live = int(h["n_res"][b]) == 0
        if use_live:
            pool_lp = np.concatenate([h["sum_lp"][b], [neg]]).astype(np.float32)
            pool_len = np.full((K + 1,), t_b + 1, np.int32)
        else:
            pool_lp = h["res_lp"][b].astype(np.float32)
            pool_len = h["res_len"][b].astype(np.int32)
        avg = pool_lp / pool_len.astype(np.float32)
        avg = np.where(pool_lp <= neg / np.float32(2), neg, avg)
        best = int(np.argmax(avg))
        # the winner's last token: a live winner's came from post-expansion
        # slot `best` at step t-1; a result's from its recorded
        # (res_t, res_par), with a STOP token
        live_slot = min(best, K - 1)
        live_last_t = max(t_b - 1, 0)
        if use_live:
            last_t = live_last_t
            last_parent = int(h["parent_hist"][b, live_slot, live_last_t])
            last_token = int(h["tok_hist"][b, live_slot, live_last_t])
        else:
            last_t = int(h["res_t"][b, best])
            last_parent = int(h["res_par"][b, best])
            last_token = STOP_ID
        slot = 0
        for tt in range(min(last_t, T - 1), -1, -1):
            if tt == last_t:
                row_par, tok = last_parent, last_token
            else:
                row_par = int(h["parent_hist"][b, slot, tt])
                tok = int(h["tok_hist"][b, slot, tt])
            tokens[b, tt + 1] = tok
            attn[b, tt] = h["attn_steps"][b, row_par, tt]
            pgens[b, tt] = h["pgen_steps"][b, row_par, tt]
            slot = row_par
        length[b] = pool_len[best]
        avg_lp[b] = avg[best]
    return BeamSearchOutput(tokens=tokens, length=length, avg_log_prob=avg_lp,
                            attn_dists=attn, p_gens=pgens)


def _search_batch(params, hps: HParams, arrays: Dict[str, torch.Tensor],
                  chunk: Optional[int] = None) -> BeamSearchOutput:
    """Encode B articles once, then search them together."""
    global steps_run
    family = get_family(hps.model_family)
    # the three phases are labelled for torch.profiler
    # (scripts/torch_decode_profile.py reads them); a label costs about a
    # microsecond when no profiler runs
    with record_function("decode/encode"):
        enc = family.beam_encode(params, hps, arrays)
    init_state_fn, step_fn = family.beam_adapter(hps)
    enc_mask = arrays["enc_padding_mask"]
    B, T_enc = enc_mask.shape
    s = _init_beam_state(hps, B, T_enc, init_state_fn(params, enc),
                         enc_mask.device)
    cond = _beam_cond(hps)
    body = _make_beam_body(params, hps, step_fn, enc, enc_mask,
                           arrays["enc_batch_extend_vocab"])
    if chunk is None:
        chunk = beam_chunk_from_env()
    C = min(max(int(chunk), 1), hps.max_dec_steps)
    # a step of an article whose search ended is masked, so overshooting
    # by up to C-1 steps changes nothing; the test costs one host sync
    with record_function("decode/search"):
        # on a tp mesh the ranks of a search exchange scores every step,
        # so they leave the loop together
        while bool(collectives.agree_any(cond(s).any())):
            for _ in range(C):
                s = _masked_step(cond, body, s)
            steps_run += C
    with record_function("decode/finalize"):
        return _finalize_beam(hps, s)


_ENC_KEYS = ("enc_batch", "enc_lens", "enc_padding_mask",
             "enc_batch_extend_vocab")


def _to_device(arrays: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in arrays.items():
        t = torch.as_tensor(np.asarray(v))
        t = t.float() if t.dtype.is_floating_point else t.long()
        out[k] = t.to(device)
    return out


@torch.no_grad()
def run_beam_search(params, hps: HParams, arrays: Dict[str, np.ndarray],
                    chunk: Optional[int] = None) -> BeamSearchOutput:
    """Host entry: decode a batch (Batch.as_arrays()) on the device that
    holds ``params``.  Returns host numpy arrays; callers strip
    START/[STOP] and map ids back to words (decode/decoder.py).  The
    batch's wall is booked as the profiler's ``decode/beam_search``
    phase."""
    device = params["embedding"].device
    prof = profile_lib.profiler_for(obs.registry_for(hps))
    t0 = prof.start()
    dev_arrays = _to_device({k: arrays[k] for k in _ENC_KEYS}, device)
    out = _search_batch(params, hps, dev_arrays, chunk)
    prof.end("decode/beam_search", t0)
    return out


# --------------------------------------------------------------------------
# Slot state: the continuous-batching search (JAX beam_search.py:472-774)
# --------------------------------------------------------------------------
#
#   pre   = prefill(params, hps, bucket_arrays)          # per admission
#   state = init_slots(params, hps, slots, pre)          # once
#   pack_slot(params, hps, state, i, pre)                # admit into slot i
#   fin   = step_slots(params, hps, state, active, chunk)
#   out   = unpack_slot(hps, state, i)                   # retire slot i
#
# The contract is the JAX package's (:505-532):
#   * the resident state keeps one shape, max_enc_steps wide; prefill
#     encodes an article at its serve bucket and pads its view out to it,
#     stamped with the article's true length (kept on the host: the step
#     bounds its attention by the longest active resident's length, a
#     host int, so the bound costs no device sync);
#   * an inactive slot's order-sensitive fields (_SELECT_FIELDS) are
#     carried through a step unchanged, as the batch search's masked
#     update carries a finished article's; its histories and dec_state
#     take the step's writes into regions unpack never reads, so a slot's
#     tensors are meaningful only between its pack and the step that
#     finishes it (pack overwrites them on reuse);
#   * pack and unpack happen between chunks only; the one host sync of a
#     chunk is the read of its finished mask.


@dataclasses.dataclass
class PrefillState:
    """One article through the prefill stage: its encoder view at the
    resident width (leaves [1, T_enc, ...]), mask and extended-vocab ids
    [1, T_enc], and its true length."""

    enc_view: Any
    enc_mask: torch.Tensor
    ext_ids: torch.Tensor
    enc_valid_len: int


@dataclasses.dataclass
class SlotState:
    """The dense resident state of ``slots`` articles: the search state
    (_BeamState, leaves [slots, ...]), the family's encoder view, masks
    and extended-vocab ids [slots, T_enc], and each slot's true article
    length on the host."""

    beam: _BeamState
    enc_view: Any
    enc_mask: torch.Tensor
    ext_ids: torch.Tensor
    enc_valid_len: np.ndarray


def _pad_time(x: torch.Tensor, T: int) -> torch.Tensor:
    """[1, t] -> [1, T], zeros past t."""
    return x if x.shape[1] >= T else F.pad(x, (0, T - x.shape[1]))


@torch.no_grad()
def prefill(params, hps: HParams, arrays: Dict[str, Any]) -> PrefillState:
    """Encode ONE article at its bucket shape (``arrays``: the enc_*
    arrays of a Batch of one at the bucket, [1, bucket]) and pad its view
    to the resident width (JAX prefill_jit): both families' encoders are
    pad-invariant, so this is the full-width encode's view."""
    family = get_family(hps.model_family)
    dev = _to_device({k: arrays[k] for k in _ENC_KEYS},
                     params["embedding"].device)
    T = hps.max_enc_steps
    view = family.pad_enc_view(family.beam_encode(params, hps, dev), T)
    return PrefillState(
        enc_view=view, enc_mask=_pad_time(dev["enc_padding_mask"], T),
        ext_ids=_pad_time(dev["enc_batch_extend_vocab"], T),
        enc_valid_len=int(np.asarray(arrays["enc_lens"]).reshape(-1)[0]))


def _zeros_like_slots(view, slots: int):
    return pytree.tree_map(
        lambda x: x.new_zeros((slots,) + tuple(x.shape[1:])), view)


def _slot_beams(params, hps: HParams, slots: int, view1,
                attn_cols: Optional[int] = None) -> _BeamState:
    """The step-0 search state of ``slots`` empty slots, from a zero
    encoder view of one article."""
    init_state_fn, _ = get_family(hps.model_family).beam_adapter(hps)
    dec1 = init_state_fn(params, view1)
    dec = {k: v.expand((slots,) + tuple(v.shape[1:])).contiguous()
           for k, v in dec1.items()}
    return _init_beam_state(hps, slots, hps.max_enc_steps, dec,
                            params["embedding"].device, attn_cols)


@torch.no_grad()
def init_slots(params, hps: HParams, slots: int,
               template: PrefillState) -> SlotState:
    """The empty dense state of ``slots`` slots, shaped like the prefilled
    ``template`` (JAX init_slots_jit; zeros: an inactive slot is never
    stepped unmasked and pack overwrites it before use)."""
    view = _zeros_like_slots(template.enc_view, slots)
    return SlotState(
        beam=_slot_beams(params, hps, slots,
                         _zeros_like_slots(template.enc_view, 1)),
        enc_view=view,
        enc_mask=template.enc_mask.new_zeros((slots, hps.max_enc_steps)),
        ext_ids=template.ext_ids.new_zeros((slots, hps.max_enc_steps)),
        enc_valid_len=np.zeros((slots,), np.int64))


def _write_slot(dst: _BeamState, src: _BeamState, idx: int) -> None:
    """Slot ``idx`` of dst := article 0 of src, in place."""
    for f in dataclasses.fields(_BeamState):
        if f.name == "dec_state":
            for k, v in src.dec_state.items():
                dst.dec_state[k][idx] = v[0]
        else:
            getattr(dst, f.name)[idx] = getattr(src, f.name)[0]


def _packed_beam(params, hps: HParams, pre: PrefillState,
                 attn_cols: Optional[int] = None) -> _BeamState:
    init_state_fn, _ = get_family(hps.model_family).beam_adapter(hps)
    return _init_beam_state(hps, 1, hps.max_enc_steps,
                            init_state_fn(params, pre.enc_view),
                            pre.enc_mask.device, attn_cols)


@torch.no_grad()
def pack_slot(params, hps: HParams, state: SlotState, idx: int,
              pre: PrefillState) -> None:
    """Admit one prefilled article into slot ``idx`` (JAX pack_slot_jit):
    its encoder view, mask, ids and length, and a fresh search."""
    _write_slot(state.beam, _packed_beam(params, hps, pre), idx)
    for dst, src in zip(pytree.tree_leaves(state.enc_view),
                        pytree.tree_leaves(pre.enc_view)):
        dst[idx] = src[0]
    state.enc_mask[idx] = pre.enc_mask[0]
    state.ext_ids[idx] = pre.ext_ids[0]
    state.enc_valid_len[idx] = pre.enc_valid_len


def active_blocks(hps: HParams, valid_len: np.ndarray,
                  active: np.ndarray) -> int:
    """ceil(longest active resident's length / decode_enc_block): the
    step's bound in blocks (JAX step_slots_jit's nb), on the host."""
    block = resolve_enc_block(hps)
    longest = int(np.max(np.where(active, valid_len, 0), initial=0))
    return -(-longest // block)


def _slot_chunk(params, hps: HParams, beam: _BeamState, active: np.ndarray,
                enc_view, enc_mask, ext_ids, nb: int, chunk: int,
                attn_col_fn=None, after_step=None) -> _BeamState:
    """``chunk`` masked steps of every slot, an inactive slot's search
    frozen as a finished article's is."""
    global steps_run
    _, step_fn = get_family(hps.model_family).beam_adapter_masked(hps)
    cond = _beam_cond(hps)
    act = torch.as_tensor(active, device=enc_mask.device)

    def masked_cond(s: _BeamState) -> torch.Tensor:
        return act & cond(s)

    def step_nb(p, e, m, x, t, latest, st):
        return step_fn(p, e, m, x, nb, t, latest, st)

    body = _make_beam_body(params, hps, step_nb, enc_view, enc_mask, ext_ids,
                           attn_col_fn)
    for _ in range(chunk):
        t_old = beam.t
        beam = _masked_step(masked_cond, body, beam)
        if after_step is not None:
            after_step(beam, t_old)
    steps_run += chunk
    return beam


def _finished(hps: HParams, beam: _BeamState, active: np.ndarray):
    """Host bool [slots]: active slots whose search has ended (the chunk's
    one sync)."""
    done = ~_beam_cond(hps)(beam)
    return active & done.cpu().numpy()


@torch.no_grad()
def step_slots(params, hps: HParams, state: SlotState, active,
               chunk: int) -> np.ndarray:
    """Advance every active slot by ``chunk`` masked decode steps (JAX
    step_slots_jit).  active: host bool [slots].  Each step's attention
    reads only the first nb * decode_enc_block encoder positions, nb from
    the longest active resident.  Returns the host mask of active slots
    whose search finished."""
    active = np.asarray(active, dtype=bool)
    nb = active_blocks(hps, state.enc_valid_len, active)
    state.beam = _slot_chunk(params, hps, state.beam, active, state.enc_view,
                             state.enc_mask, state.ext_ids, nb, chunk)
    return _finished(hps, state.beam, active)


def _one_slot(beam: _BeamState, idx: int, **override) -> _BeamState:
    fields = {f.name: getattr(beam, f.name)[idx:idx + 1]
              for f in dataclasses.fields(_BeamState)
              if f.name != "dec_state"}
    fields.update(override)
    return _BeamState(dec_state={}, **fields)


def _unbatched(out: BeamSearchOutput) -> BeamSearchOutput:
    return BeamSearchOutput(*(x[0] for x in out))


@torch.no_grad()
def unpack_slot(hps: HParams, state: SlotState,
                idx: int) -> BeamSearchOutput:
    """The finished hypothesis of slot ``idx`` (host numpy, no batch
    axis), ranked as the batch search ranks (JAX unpack_slot_jit).  The
    slot is not cleared: the caller's active mask retires it."""
    return _unbatched(_finalize_beam(hps, _one_slot(state.beam, idx)))


# --------------------------------------------------------------------------
# Paged resident state (JAX beam_search.py:723-1080)
# --------------------------------------------------------------------------
#
# The encoder-axis tensors of the resident state (the family's encoder
# view, the extended-vocab ids, the attention history) become pools of
# decode_enc_block-row pages shared by all slots, sized by the arena
# (decode/arena.PageArena); a slot's pages are named by its page-table
# row.  Page index P (the arena's capacity) is the scratch page: unused
# table entries and inactive slots point at it, and it holds garbage.
# dec_state stays dense.  Each chunk gathers the active slots' dense
# views through the table once, runs the dense step, and writes each
# step's attention rows into the slots' pages at the step's column.
#
#   pages = resolve_arena_pages(hps, paged_page_bytes(params, hps))
#   state = init_slots_paged(params, hps, slots, pre, pages)
#   row   = arena.alloc(ceil(len / block)), padded with the scratch id
#   pack_slot_paged(params, hps, state, i, pre, row)
#   fin   = step_slots_paged(params, hps, state, active, table, chunk)
#   out   = unpack_slot_paged(hps, state, i, row); arena.free(...)


@dataclasses.dataclass
class PagedSlotState:
    """The paged resident state: the search state (attention history one
    scratch column wide), the encoder view with its pooled leaves cut to
    time width 0 (the tree and the leaves without a time axis stay), the
    pools [pages + 1, block, ...] (row pages is the scratch page), the
    extended-vocab ids' pool [pages + 1, block], the attention history's
    [pages + 1, K, T_dec + 1, block], the masks [slots, T_enc] and the
    true lengths (host)."""

    beam: _BeamState
    enc_rest: Any
    enc_pages: List[torch.Tensor]
    ext_pool: torch.Tensor
    attn_pool: torch.Tensor
    enc_mask: torch.Tensor
    enc_valid_len: np.ndarray


def _pool_spec(hps: HParams) -> Tuple[int, int, int]:
    """(block, pages per slot at most, padded width): pages are the
    length bound's blocks."""
    block = resolve_enc_block(hps)
    b_max = -(-hps.max_enc_steps // block)
    return block, b_max, block * b_max


_time_axes_cache: Dict[Any, Tuple[Optional[int], ...]] = {}


def _enc_time_axes(hps: HParams, enc_view) -> Tuple[Optional[int], ...]:
    """Each leaf's encoder-time axis (None: no time axis), found by
    padding meta copies of the leaves through the family's own
    pad_enc_view past any real width and seeing which axis grew (the JAX
    package probes with jax.eval_shape)."""
    leaves = pytree.tree_leaves(enc_view)
    key = (hps.model_family, hps.max_enc_steps,
           tuple(tuple(x.shape) for x in leaves))
    axes = _time_axes_cache.get(key)
    if axes is not None:
        return axes
    meta = pytree.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        enc_view)
    padded = get_family(hps.model_family).pad_enc_view(
        meta, hps.max_enc_steps + 17)
    found = []
    for a, b in zip(leaves, pytree.tree_leaves(padded)):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                if x != y]
        if len(diff) > 1:
            raise ValueError(f"pad_enc_view changed more than one axis "
                             f"({tuple(a.shape)} -> {tuple(b.shape)})")
        found.append(diff[0] if diff else None)
    axes = _time_axes_cache[key] = tuple(found)
    return axes


def _leaf_to_pages(leaf: torch.Tensor, ta: int, block: int,
                   b_max: int) -> torch.Tensor:
    """One prefilled [1, ...] leaf -> its [b_max, block, *tail] pages (time
    axis first, zero-padded to the page grid)."""
    x = leaf.movedim(ta, 1)[0]  # [T_enc, *tail]
    pad = b_max * block - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x.reshape((b_max, block) + tuple(x.shape[1:]))


def _pages_to_leaf(pool: torch.Tensor, pages: torch.Tensor, ta: int,
                   T_enc: int) -> torch.Tensor:
    """The dense [slots, ...] leaf gathered through the page table
    (pages: [slots, b_max]; scratch rows bring garbage that sits behind
    the masks)."""
    g = pool[pages]  # [slots, b_max, block, *tail]
    g = g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + tuple(g.shape[3:]))
    return g[:, :T_enc].movedim(1, ta).contiguous()


@torch.no_grad()
def paged_page_bytes(params, hps: HParams) -> int:
    """Bytes one page spans over all pools (the encoder view's pooled
    leaves, the ids, the attention history): what resolve_arena_pages
    divides serve_arena_mb by.  The leaves' widths and dtypes come from
    encoding a one-token article."""
    block, _, _ = _pool_spec(hps)
    probe = dict(enc_batch=np.zeros((1, 1), np.int64),
                 enc_lens=np.ones((1,), np.int64),
                 enc_padding_mask=np.ones((1, 1), np.float32),
                 enc_batch_extend_vocab=np.zeros((1, 1), np.int64))
    view = get_family(hps.model_family).beam_encode(
        params, hps, _to_device(probe, params["embedding"].device))
    total = 0
    for leaf, ta in zip(pytree.tree_leaves(view), _enc_time_axes(hps, view)):
        if ta is None:
            continue
        tail = int(np.prod([d for i, d in enumerate(leaf.shape)
                            if i not in (0, ta)], dtype=np.int64))
        total += block * tail * leaf.element_size()
    total += block * 8  # the ids' page (int64)
    total += hps.beam_size * (hps.max_dec_steps + 1) * block * 4  # f32
    return int(total)


@torch.no_grad()
def init_slots_paged(params, hps: HParams, slots: int,
                     template: PrefillState, pages: int) -> PagedSlotState:
    """The empty paged state: pools of ``pages`` pages and the scratch
    page, shaped like the prefilled ``template`` (JAX
    init_slots_paged_jit)."""
    block, b_max, _ = _pool_spec(hps)
    axes = _enc_time_axes(hps, template.enc_view)
    leaves, spec = pytree.tree_flatten(template.enc_view)
    rest, pools = [], []
    for leaf, ta in zip(leaves, axes):
        shape = [slots] + list(leaf.shape[1:])
        if ta is not None:
            tail = [d for i, d in enumerate(leaf.shape) if i not in (0, ta)]
            pools.append(leaf.new_zeros([pages + 1, block] + tail))
            shape[ta] = 0
        rest.append(leaf.new_zeros(shape))
    K, T = hps.beam_size, hps.max_dec_steps
    return PagedSlotState(
        beam=_slot_beams(params, hps, slots,
                         _zeros_like_slots(template.enc_view, 1),
                         attn_cols=1),
        enc_rest=pytree.tree_unflatten(rest, spec),
        enc_pages=pools,
        ext_pool=template.ext_ids.new_zeros((pages + 1, block)),
        attn_pool=template.enc_mask.new_zeros((pages + 1, K, T + 1, block)),
        enc_mask=template.enc_mask.new_zeros((slots, hps.max_enc_steps)),
        enc_valid_len=np.zeros((slots,), np.int64))


@torch.no_grad()
def pack_slot_paged(params, hps: HParams, state: PagedSlotState, idx: int,
                    pre: PrefillState, row) -> None:
    """Admit one prefilled article into slot ``idx`` whose pages are
    ``row`` ([b_max] ids: its allocation, then the scratch id) (JAX
    pack_slot_paged_jit).  The unused entries all write the scratch page;
    a recycled page's old attention rows need no clearing: unpack zeroes
    the columns past the new tenant's length, and the backtrack reads no
    step past its end."""
    block, b_max, _ = _pool_spec(hps)
    _write_slot(state.beam, _packed_beam(params, hps, pre, attn_cols=1), idx)
    row_t = torch.as_tensor(np.asarray(row), dtype=torch.long,
                            device=state.enc_mask.device)
    axes = _enc_time_axes(hps, pre.enc_view)
    pools = iter(state.enc_pages)
    for leaf, rest_leaf, ta in zip(pytree.tree_leaves(pre.enc_view),
                                   pytree.tree_leaves(state.enc_rest), axes):
        if ta is None:
            rest_leaf[idx] = leaf[0]
        else:
            next(pools)[row_t] = _leaf_to_pages(leaf, ta, block, b_max)
    ext = _pad_time(pre.ext_ids, b_max * block)[0]
    state.ext_pool[row_t] = ext.reshape(b_max, block)
    state.enc_mask[idx] = pre.enc_mask[0]
    state.enc_valid_len[idx] = pre.enc_valid_len


@torch.no_grad()
def step_slots_paged(params, hps: HParams, state: PagedSlotState, active,
                     table, chunk: int) -> np.ndarray:
    """Advance every active slot by ``chunk`` masked steps through the
    page table (``table``: host int [slots, b_max]) (JAX
    step_slots_paged_jit).  The active slots' dense encoder views are
    gathered once per chunk; an inactive slot's row is routed to the
    scratch page before the gather and before the writes, so a retired
    slot's stale row can neither read nor dirty pages the arena has
    handed to another resident.  Returns the host finished mask."""
    active = np.asarray(active, dtype=bool)
    block, b_max, t_pad = _pool_spec(hps)
    T_enc = state.enc_mask.shape[1]
    slots = active.shape[0]
    K = hps.beam_size
    scratch = state.attn_pool.shape[0] - 1
    pages = torch.as_tensor(
        np.where(active[:, None], np.asarray(table), scratch),
        dtype=torch.long, device=state.enc_mask.device)
    nb = active_blocks(hps, state.enc_valid_len, active)
    rest, spec = pytree.tree_flatten(state.enc_rest)
    pools = iter(state.enc_pages)
    dense = [leaf if ta is None else
             _pages_to_leaf(next(pools), pages, ta, T_enc)
             for leaf, ta in zip(rest, _enc_time_axes(hps, state.enc_rest))]
    enc_view = pytree.tree_unflatten(dense, spec)
    ext = state.ext_pool[pages].reshape(slots, t_pad)[:, :T_enc]
    flat_pages = pages.reshape(-1)

    def write_attn(beam: _BeamState, t_old: torch.Tensor) -> None:
        # the step's attention rows into the slots' pages at the
        # pre-step column (t <= max_dec_steps always)
        attn = beam.attn_steps[:, :, 0, :]  # [slots, K, T_enc]
        if t_pad > T_enc:
            attn = F.pad(attn, (0, t_pad - T_enc))
        vals = attn.reshape(slots, K, b_max, block).transpose(1, 2)
        state.attn_pool[flat_pages, :, t_old.repeat_interleave(b_max)] = \
            vals.reshape(slots * b_max, K, block)

    state.beam = _slot_chunk(params, hps, state.beam, active, enc_view,
                             state.enc_mask, ext.contiguous(), nb, chunk,
                             attn_col_fn=torch.zeros_like,
                             after_step=write_attn)
    return _finished(hps, state.beam, active)


@torch.no_grad()
def unpack_slot_paged(hps: HParams, state: PagedSlotState, idx: int,
                      row) -> BeamSearchOutput:
    """The finished hypothesis of slot ``idx`` (JAX unpack_slot_paged_jit):
    its attention pages (``row``, its current table row: free them after
    this call) gathered back into the dense history, the columns past its
    length zeroed (where the dense search's masked softmax wrote 0 and a
    recycled page holds its last tenant's rows), then the batch search's
    finalize."""
    _, b_max, t_pad = _pool_spec(hps)
    K, T = hps.beam_size, hps.max_dec_steps
    T_enc = state.enc_mask.shape[1]
    ap = state.attn_pool[torch.as_tensor(np.asarray(row), dtype=torch.long,
                                         device=state.attn_pool.device)]
    attn = ap.permute(1, 2, 0, 3).reshape(K, T + 1, t_pad)[:, :, :T_enc]
    attn = attn.clone()
    attn[:, :, int(state.enc_valid_len[idx]):] = 0.0
    return _unbatched(_finalize_beam(
        hps, _one_slot(state.beam, idx, attn_steps=attn[None])))
