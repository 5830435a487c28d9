"""Speculative decode: a draft proposes, the full model verifies.

Port of the JAX package's decode/speculative.py.  A cheap draft (the
avg_attention family, its step O(1) in history) proposes ``spec_k``
tokens greedily; the full model scores the ``spec_k + 1`` positions of
the cycle; the longest draft prefix equal to the full model's own greedy
choices is accepted, followed by the full model's token at the first
disagreement.  Every cycle emits at least one token, and the stream is
the full model's greedy decode token for token: each emitted token is
the full model's choice at its position.  Greedy is the serving ladder's
greedy tier, beam_size=1 beam search, with the same early-STOP rule
(``_greedy_choice``).

The full model's verifier, by family:

  * transformer: ``transformer.spec_verify``, the S positions in one
    parallel decoder pass over an append-only KV cache (the commit is
    the identity: the committed step masks rejected entries);
  * any other family: S teacher-forced K = 1 steps of the family's own
    beam step, their states stacked and the state after the accepted
    prefix committed (each step returns new tensors, so the stack does
    not alias).

The JAX package vmaps one article's ``lax.while_loop`` over the batch.
Here the B rows run in lockstep, each with its own step ``t``, last
token, done flag, accept length ``a`` and emitted count ``n``; draft and
verifier states are gathered per row at ``n - 1`` and ``a``; a done row
keeps its outputs and counts as they were.  The loop reads ``done.all()``
on the host once per cycle.  A row's outputs are what it would give
alone.

``hps.spec_k_adaptive`` (or a ``SpecKController``) runs the adaptive
engine: the controller re-picks k between cycles from the accept
histogram (``expected_speedup`` at the draft/full cost ratio committed
in BYTE_BUDGET.json), reading the histogram and the done flags in the
cycle's one host read.  The carry's k-dependent shapes (verify cache,
histogram) are pinned to spec_k_max, and any k sequence reproduces
greedy exactly.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from textsummarization_on_flink_tpu_torch.config import (
    HParams,
    derive_draft_hps,
    resolve_spec_bounds,
)
from textsummarization_on_flink_tpu_torch.data.vocab import (
    START_ID,
    STOP_ID,
    UNK_ID,
)
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode.beam_search import NEG
from textsummarization_on_flink_tpu_torch.models import get_family
from textsummarization_on_flink_tpu_torch.obs import profile as profile_lib

#: draft-verify cycles run so far, over all batches (a lockstep cycle
#: counts once whatever its rows); a run sets it to 0 before the cycles
#: it wants counted
cycles_run = 0


class SpecDecodeOutput(NamedTuple):
    """The batch's output (host numpy): BeamSearchOutput's fields, so the
    decoder's ``_make_result`` takes it as it is, and the speculative
    counts per article."""

    tokens: np.ndarray  # [B, T_dec+1] extended-vocab ids, [0]=START
    length: np.ndarray  # [B] token count including START
    avg_log_prob: np.ndarray  # [B]
    attn_dists: np.ndarray  # [B, T_dec, T_enc]
    p_gens: np.ndarray  # [B, T_dec]
    cycles: np.ndarray  # [B] draft-verify cycles run
    drafted: np.ndarray  # [B] draft tokens proposed (sum of each cycle's k)
    accepted: np.ndarray  # [B] draft tokens accepted
    accept_hist: np.ndarray  # [B, k_cap+1] cycles per accept length


class _Carry(NamedTuple):
    """The rows' loop state.  tokens/attn/pgens carry a scratch column at
    index T that truncated and done rows' writes land in."""

    t: torch.Tensor  # [B] committed generated-token count
    last: torch.Tensor  # [B] last committed token (extended id)
    done: torch.Tensor  # [B] bool
    sum_lp: torch.Tensor  # [B] f32 sum of the committed log probs
    tokens: torch.Tensor  # [B, T+1]
    attn: torch.Tensor  # [B, T+1, T_enc] f32
    pgens: torch.Tensor  # [B, T+1] f32
    f_state: Any  # full model's verify state
    d_state: Any  # draft's beam state (K = 1)
    cycles: torch.Tensor  # [B]
    accepted: torch.Tensor  # [B]
    hist: torch.Tensor  # [B, k_cap+1]
    drafted: torch.Tensor  # [B]


def _greedy_choice(topk_ids: torch.Tensor, topk_lps: torch.Tensor,
                   t: torch.Tensor, min_dec_steps: int):
    """The greedy policy of the draft and the verifier (speculative.py:
    118-128): the best of the top-2 (last axis, descending) with STOP
    discarded before ``min_dec_steps``, as the beam_size=1 triage does.
    t broadcasts against the leading axes.  Returns (token, log prob)."""
    blocked = (topk_ids == STOP_ID) & (t < min_dec_steps)[..., None]
    idx = torch.argmax(torch.where(blocked, NEG, topk_lps), dim=-1,
                       keepdim=True)
    return (torch.gather(topk_ids, -1, idx)[..., 0],
            torch.gather(topk_lps, -1, idx)[..., 0])


def _map_unk(tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Extended-vocab ids feed back as UNK (beam_search.py:112)."""
    return torch.where(tokens >= vocab_size, UNK_ID, tokens)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every row b of a [B, S, ...] stack."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _keep(done: torch.Tensor, old: torch.Tensor,
          new: torch.Tensor) -> torch.Tensor:
    """new, with the done rows' old values."""
    return torch.where(done.reshape(done.shape + (1,) * (new.ndim - 1)),
                       old, new)


class _FullDriver:
    """init / verify / commit of the full model (speculative.py:136-197):
    verify(state, t0 [B], inputs [B, S]) -> (choices [B, S], log probs
    [B, S], attn [B, S, T_enc], p_gen [B, S], aux); commit(aux, a [B])
    -> the state after each row's first a + 1 inputs."""

    def __init__(self, params, hps: HParams, enc, enc_mask, ext_ids):
        self.params, self.hps = params, hps
        self.enc, self.enc_mask, self.ext_ids = enc, enc_mask, ext_ids
        self.family = get_family(hps.model_family)
        self.parallel = hps.model_family == "transformer"
        self.init_fn, self.step_fn = self.family.beam_adapter(hps)

    def init(self, cache_k: int):
        if self.parallel:
            return self.family.spec_init_state(
                self.hps, cache_k, self.enc_mask.shape[0],
                self.enc_mask.device)
        return self.init_fn(self.params, self.enc)

    def verify(self, state, t0: torch.Tensor, inputs: torch.Tensor):
        hps = self.hps
        S = inputs.shape[1]
        pos = t0[:, None] + torch.arange(S, device=t0.device)
        if self.parallel:
            tids, tlps, attn, pgen, aux = self.family.spec_verify(
                self.params, hps, self.enc, self.enc_mask, self.ext_ids, t0,
                _map_unk(inputs, hps.vocab_size), state)
        else:
            outs, states = [], []
            for j in range(S):
                out = self.step_fn(self.params, self.enc, self.enc_mask,
                              self.ext_ids, pos[:, j],
                              _map_unk(inputs[:, j:j + 1], hps.vocab_size),
                              state)
                state = out.state
                outs.append(out)
                states.append(state)
            tids = torch.stack([o.topk_ids[:, 0] for o in outs], dim=1)
            tlps = torch.stack([o.topk_log_probs[:, 0] for o in outs], dim=1)
            attn = torch.stack([o.attn_dist[:, 0] for o in outs], dim=1)
            pgen = torch.stack([o.p_gen[:, 0] for o in outs], dim=1)
            # stacked[:, j] = the state after inputs 0..j
            aux = {k: torch.stack([s[k] for s in states], dim=1)
                   for k in states[0]}
        toks, lps = _greedy_choice(tids, tlps, pos, hps.min_dec_steps)
        return toks, lps, attn, pgen, aux

    def commit(self, aux, a: torch.Tensor, done: torch.Tensor, old):
        """The state after each live row's accepted prefix; a done row's
        state as it was (the cache excepted: its rows are never read
        again)."""
        if self.parallel:
            return aux  # append-only cache: the step counter masks it
        return {k: _keep(done, old[k], _rows(v, a)) for k, v in aux.items()}


class _Engine:
    """Both models' encoder views of one batch and the cycle over its
    rows (speculative.py:200-309)."""

    def __init__(self, full_params, draft_params, fhps: HParams,
                 dhps: HParams, arrays: Dict[str, torch.Tensor]):
        self.fhps, self.dhps = fhps, dhps
        self.draft_params = draft_params
        self.enc_mask = arrays["enc_padding_mask"]
        self.ext_ids = arrays["enc_batch_extend_vocab"]
        f_enc = get_family(fhps.model_family).beam_encode(full_params, fhps,
                                                          arrays)
        d_family = get_family(dhps.model_family)
        self.d_enc = d_family.beam_encode(draft_params, dhps, arrays)
        self.d_init, self.d_step = d_family.beam_adapter(dhps)
        self.full = _FullDriver(full_params, fhps, f_enc, self.enc_mask,
                                self.ext_ids)

    def init(self, k_cap: int) -> _Carry:
        B, T_enc = self.enc_mask.shape
        T = self.fhps.max_dec_steps
        dev = self.enc_mask.device
        ilong = dict(dtype=torch.long, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        return _Carry(
            t=torch.zeros((B,), **ilong),
            last=torch.full((B,), START_ID, **ilong),
            done=torch.zeros((B,), dtype=torch.bool, device=dev),
            sum_lp=torch.zeros((B,), **f32),
            tokens=torch.zeros((B, T + 1), **ilong),
            attn=torch.zeros((B, T + 1, T_enc), **f32),
            pgens=torch.zeros((B, T + 1), **f32),
            f_state=self.full.init(k_cap),
            d_state=self.d_init(self.draft_params, self.d_enc),
            cycles=torch.zeros((B,), **ilong),
            accepted=torch.zeros((B,), **ilong),
            hist=torch.zeros((B, k_cap + 1), **ilong),
            drafted=torch.zeros((B,), **ilong))

    def cycle(self, c: _Carry, spec_k: int) -> _Carry:
        """One propose / verify / accept / commit cycle of every row
        (speculative.py:212-263)."""
        global cycles_run
        fhps = self.fhps
        T, V = fhps.max_dec_steps, fhps.vocab_size
        S = spec_k + 1
        B = c.t.shape[0]
        dev = c.t.device
        js = torch.arange(S, device=dev)

        # the draft proposes spec_k tokens greedily; S steps, the last
        # giving the accept-all case's state
        st, latest = c.d_state, _map_unk(c.last, V)
        d_toks, d_states = [], []
        for j in range(S):
            out = self.d_step(self.draft_params, self.d_enc, self.enc_mask,
                              self.ext_ids, c.t + j, latest[:, None], st)
            tok, _ = _greedy_choice(out.topk_ids[:, 0],
                                    out.topk_log_probs[:, 0], c.t + j,
                                    fhps.min_dec_steps)
            st = out.state
            d_toks.append(tok)
            d_states.append(st)
            latest = _map_unk(tok, V)
        d_toks = torch.stack(d_toks, dim=1)  # [B, S]: positions t+1..t+S

        # the full model scores all S positions
        inputs = torch.cat([c.last[:, None], d_toks[:, :spec_k]], dim=1)
        g_toks, g_lps, v_attn, v_pgen, v_aux = self.full.verify(
            c.f_state, c.t, inputs)

        # the longest agreeing prefix, then the correction
        agree = (d_toks[:, :spec_k] == g_toks[:, :spec_k]).long()
        a = torch.cumprod(agree, dim=1).sum(dim=1)  # [B] in 0..spec_k
        e = torch.where(js[None] < a[:, None], d_toks, g_toks)
        is_stop = (e == STOP_ID) & (js[None] <= a[:, None])
        any_stop = is_stop.any(dim=1)
        first_stop = torch.argmax(is_stop.long(), dim=1)
        n_limit = torch.where(any_stop, first_stop + 1, a + 1)
        n = torch.minimum(n_limit, T - c.t)  # >= 1 on a live row
        live = ~c.done
        valid = (js[None] < n[:, None]) & live[:, None]

        # commit: scatter the n emitted tokens (truncated and done rows
        # write the scratch column T) and advance both models
        widx = torch.where(valid, c.t[:, None] + js[None], T)
        bi = torch.arange(B, device=dev)[:, None]
        tokens, attn, pgens = c.tokens.clone(), c.attn.clone(), \
            c.pgens.clone()
        tokens[bi, widx] = e
        attn[bi, widx] = v_attn
        pgens[bi, widx] = v_pgen
        stopped = any_stop & (first_stop < n)
        n_live = torch.where(live, n, 0)
        t2 = c.t + n_live
        last_idx = (n - 1).clamp(min=0)
        d_stack = {k: torch.stack([s[k] for s in d_states], dim=1)
                   for k in d_states[0]}
        d_state = {k: _keep(c.done, c.d_state[k], _rows(v, last_idx))
                   for k, v in d_stack.items()}
        f_state = self.full.commit(v_aux, a, c.done, c.f_state)
        a_live = torch.where(live, a, 0)
        hist = c.hist.clone()
        hist[torch.arange(B, device=dev), a] += live.long()
        cycles_run += 1
        return _Carry(
            t=t2,
            last=torch.where(live, _rows(e, last_idx), c.last),
            done=c.done | stopped | (t2 >= T),
            sum_lp=c.sum_lp + torch.where(valid, g_lps, 0.0).sum(dim=1),
            tokens=tokens, attn=attn, pgens=pgens,
            f_state=f_state, d_state=d_state,
            cycles=c.cycles + live.long(),
            accepted=c.accepted + a_live,
            hist=hist,
            drafted=c.drafted + spec_k * live.long())


def _output(c: _Carry, T: int) -> SpecDecodeOutput:
    """The rows' carry as host numpy (speculative.py:312-330)."""
    length = c.t + 1  # generated tokens + START, the beam length rule
    start = torch.full_like(c.t[:, None], START_ID)
    np_ = lambda x: x.cpu().numpy()  # noqa: E731
    return SpecDecodeOutput(
        tokens=np_(torch.cat([start, c.tokens[:, :T]], dim=1)).astype(
            np.int32),
        length=np_(length).astype(np.int32),
        avg_log_prob=np_(c.sum_lp / length.float()),
        attn_dists=np_(c.attn[:, :T]),
        p_gens=np_(c.pgens[:, :T]),
        cycles=np_(c.cycles).astype(np.int32),
        drafted=np_(c.drafted).astype(np.int32),
        accepted=np_(c.accepted).astype(np.int32),
        accept_hist=np_(c.hist).astype(np.int32))


def _prepare(full_params, draft_params, hps: HParams,
             arrays: Dict[str, np.ndarray]):
    """(full hps, draft hps, the engine): both at beam_size 1, the batch's
    enc_* arrays on the full params' device."""
    fhps = hps.replace(beam_size=1)
    dhps = derive_draft_hps(hps).replace(beam_size=1, mode="decode")
    device = full_params["embedding"].device
    dev_arrays = beam_search._to_device(
        {k: arrays[k] for k in beam_search._ENC_KEYS}, device)
    return fhps, _Engine(full_params, draft_params, fhps, dhps, dev_arrays)


@torch.no_grad()
def run_spec_decode(full_params, draft_params, hps: HParams,
                    arrays: Dict[str, np.ndarray],
                    controller: "Optional[SpecKController]" = None,
                    real_mask=None) -> SpecDecodeOutput:
    """Host entry (speculative.py:370-404): speculatively decode a batch
    (Batch.as_arrays()) on the device of ``full_params``; host numpy out,
    run_beam_search's contract plus the speculative counts.

    ``controller`` (or ``hps.spec_k_adaptive``) routes through the
    adaptive engine; a persistent controller carries its acceptance
    estimate across batches, and ``real_mask`` keeps padding rows out of
    its observations.  A fixed-k batch's wall is booked as the
    profiler's ``decode/spec_cycle`` phase (the adaptive engine books
    each cycle)."""
    if controller is None and hps.spec_k_adaptive:
        controller = SpecKController.from_hps(hps)
    if controller is not None:
        return run_spec_decode_adaptive(full_params, draft_params, hps,
                                        arrays, controller,
                                        real_mask=real_mask)
    prof = profile_lib.profiler_for(obs.registry_for(hps))
    t0 = prof.start()
    fhps, engine = _prepare(full_params, draft_params, hps, arrays)
    spec_k = int(hps.spec_k)
    c = engine.init(spec_k)
    while not bool(c.done.all()):
        c = engine.cycle(c, spec_k)
    prof.end("decode/spec_cycle", t0)
    return _output(c, fhps.max_dec_steps)


# --------------------------------------------------------------------------
# Acceptance-adaptive spec_k
# --------------------------------------------------------------------------

#: committed draft/full per-step cost ratios, read once per process
_RATIO_CACHE: Dict[str, float] = {}


def committed_draft_ratio(family: str, default: float = 0.5) -> float:
    """The draft/full per-step cost ratio the adaptive controller prices
    draft steps at (speculative.py:453-471): BYTE_BUDGET.json's
    spec.max_draft_flops_ratio of the family at the repository's root, or
    ``default`` where the file or the entry is missing."""
    if family not in _RATIO_CACHE:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "BYTE_BUDGET.json")
        try:
            with open(path, encoding="utf-8") as f:
                ratio = float(
                    json.load(f)["spec"]["max_draft_flops_ratio"][family])
        except (OSError, KeyError, TypeError, ValueError):
            ratio = float(default)
        _RATIO_CACHE[family] = ratio
    return _RATIO_CACHE[family]


class SpecKController:
    """The acceptance-adaptive draft length (speculative.py:474-562):
    from k_start, pick the k in [k_min, k_max] that maximizes expected
    progress per unit of cost, ``expected_speedup(alpha, k,
    draft_ratio)``, at the acceptance probability alpha estimated from the
    accept histogram.  A cycle with accept length a < k counts a
    successes and one failure, a == k counts k censored successes; a
    small symmetric prior keeps the first cycles from pinning k to a
    bound.  Host arithmetic on counts: the k trajectory is a
    deterministic function of the observed accept sequence."""

    def __init__(self, k_min: int, k_start: int, k_max: int,
                 draft_ratio: float, prior_trials: float = 8.0,
                 prior_alpha: float = 0.5):
        if not 1 <= k_min <= k_start <= k_max:
            raise ValueError(
                f"need 1 <= k_min <= k_start <= k_max, got "
                f"[{k_min}, {k_start}, {k_max}]")
        if draft_ratio <= 0:
            raise ValueError(f"draft_ratio must be > 0, got {draft_ratio}")
        self.k = int(k_start)
        self.k_min = int(k_min)
        self.k_max = int(k_max)
        self.draft_ratio = float(draft_ratio)
        self._succ = float(prior_alpha) * float(prior_trials)
        self._trials = float(prior_trials)
        self.cycles = 0
        self.drafted = 0
        self.accepted = 0

    @classmethod
    def from_hps(cls, hps: HParams,
                 draft_ratio: Optional[float] = None) -> "SpecKController":
        """Bounds from config.resolve_spec_bounds, the cost ratio from the
        committed budget unless given."""
        k_min, k_start, k_max = resolve_spec_bounds(hps)
        if draft_ratio is None:
            draft_ratio = committed_draft_ratio(hps.model_family)
        return cls(k_min, k_start, k_max, draft_ratio)

    @property
    def alpha(self) -> float:
        """The per-position acceptance probability estimate."""
        return self._succ / self._trials

    @property
    def mean_k(self) -> float:
        """The mean spec_k over the observed cycles (k_start before any)."""
        return self.drafted / self.cycles if self.cycles else float(self.k)

    def observe(self, hist_counts, k_used: int) -> int:
        """Fold one cycle's accept-histogram delta (counts per accept
        length 0..k_used; entries past k_used ignored) into the estimate
        and re-pick k.  Returns the new k."""
        k_used = int(k_used)
        counts = [int(x) for x in hist_counts]
        for a, n in enumerate(counts[:k_used + 1]):
            if n <= 0:
                continue
            self.cycles += n
            self.drafted += n * k_used
            self.accepted += n * a
            self._succ += n * a
            self._trials += n * (a + 1 if a < k_used else a)
        return self.update()

    def update(self) -> int:
        """k = argmax of expected progress per cost at the current alpha,
        ties to the lower k."""
        alpha = self.alpha
        best_k, best = self.k_min, -1.0
        for k in range(self.k_min, self.k_max + 1):
            s = expected_speedup(alpha, k, self.draft_ratio)
            if s > best + 1e-12:
                best, best_k = s, k
        self.k = best_k
        return self.k


@torch.no_grad()
def run_spec_decode_adaptive(full_params, draft_params, hps: HParams,
                             arrays: Dict[str, np.ndarray],
                             controller: SpecKController,
                             real_mask=None) -> SpecDecodeOutput:
    """The adaptive loop (speculative.py:565-626): one cycle at the
    controller's k, then one host read of the accept histogram and the
    done flags, whose delta over the real rows (``real_mask`` [B]) the
    controller observes.  At most max_dec_steps cycles: each commits at
    least one token of every live row."""
    fhps, engine = _prepare(full_params, draft_params, hps, arrays)
    c = engine.init(controller.k_max)
    real = (np.asarray(real_mask, dtype=bool) if real_mask is not None
            else np.ones(c.t.shape[0], dtype=bool))
    prev_hist = 0  # broadcasts against the first histogram read
    prof = profile_lib.profiler_for(obs.registry_for(hps))
    for _ in range(fhps.max_dec_steps):
        k = controller.k
        t0 = prof.start()
        c = engine.cycle(c, k)
        prof.end("decode/spec_cycle", t0)
        # the cycle's one host read: the histogram and the done flags
        hist_done = torch.cat([c.hist, c.done[:, None].long()],
                              dim=1).cpu().numpy()
        hist, done = hist_done[:, :-1], hist_done[:, -1].astype(bool)
        controller.observe((hist - prev_hist)[real].sum(axis=0), k)
        prev_hist = hist
        if done.all():
            break
    return _output(c, fhps.max_dec_steps)


def expected_speedup(alpha: float, spec_k: int, draft_ratio: float) -> float:
    """The spec tier's expected speed-up over greedy under the
    bandwidth-bound decode model (speculative.py:629-646): a cycle emits
    E = (1 - alpha^(k+1)) / (1 - alpha) tokens and costs k + 1 draft steps
    at ``draft_ratio`` of a full step plus one full-model verify, so
    speed-up = E / ((k + 1) * ratio + 1)."""
    a = min(max(float(alpha), 0.0), 1.0)
    if a >= 1.0:
        e = float(spec_k + 1)
    else:
        e = (1.0 - a ** (spec_k + 1)) / (1.0 - a)
    return e / ((spec_k + 1) * float(draft_ratio) + 1.0)
