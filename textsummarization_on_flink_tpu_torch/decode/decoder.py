"""Beam-search decoder: checkpoint loading, decode loop, writers.

Port of the batch path of the JAX package's decode/decoder.py (after the
reference's decode.py): each batch of articles is decoded by one call of
decode/beam_search.py on the params' device, and the npz checkpoint
layer replaces the TF Saver.

Kept: decode-dir naming from the checkpoint name + key hps
(``get_decode_dir_name``, decode.py:303-313); single-pass mode writes
pyrouge-layout reference/decoded files and scores them with the native
ROUGE of evaluate/rouge.py, writing ``ROUGE_results.txt``
(decode.py:133-147, 187-222, 268-301); continuous mode decodes until the
batcher ends (or ``max_batches``), reloads the newest checkpoint once
``SECS_UNTIL_NEW_CKPT`` seconds have passed (decode.py:36, 149-157) and
writes the attention-visualizer JSON of each result (decode.py:225-249);
``[STOP]``-truncation of the emitted tokens (decode.py:112-118);
html-escaping of <, > (``make_html_safe``); the summary is
sentence-split on '.'.  Each ``decode_batch`` runs under a
``Deadline`` (the caller's, or ``decode_deadline_secs``): with no
explicit tier, a budget short of the full-beam latency estimate degrades
the batch to greedy (``should_degrade``, the serve layer's per-request
predicate), and the results say ``degraded``.

The quality tiers: ``beam``, ``greedy`` (beam_size=1), ``spec`` (the
draft-then-verify engine of decode/speculative.py, token for token the
greedy tier) and ``draft`` (greedy on the draft alone).  The draft is
``draft_params=``, or built from ``spec_draft`` ("map": from the full
transformer's params, re-derived under the params lock at each
checkpoint reload; "fresh": random from ``seed``); spec dispatches count
``decode/spec_cycles_total``, ``decode/spec_draft_tokens_total``,
``decode/spec_accepted_tokens_total`` and the ``decode/spec_accept_len``
histogram over real rows, and the gauge ``decode/spec_k_current`` reads
the adaptive controller's k.

``SlotDecodeEngine`` (``BeamSearchDecoder.slot_engine``) is the JAX
package's continuous-batching engine over the slot functions of
decode/beam_search.py: a prefill stage at the serve buckets, resident
articles stepped a chunk at a time, each retired the moment its search
ends; dense, or over a page arena (decode/arena.py).  It decodes at the
beam tier only, as the JAX engine does.

On a mesh (``dp * tp * sp > 1``; JAX decoder.py:238-247) the decoder is
``sharded``: the batch search runs through
``parallel.mesh.make_sharded_beam_search``.  Every rank holds the whole
batch (the chief reads the batcher and broadcasts each batch's arrays),
each dp group searches its rows with its tp shards of the params, and
the chief, which holds the gathered outputs, makes the results and
writes the decode dir.  Only the beam tier decodes there, as in the JAX
package (decoder.py:455-459 there).  The sp ranks of a dp index search
the same rows and shard the encoder's T as the JAX package's search
does: the pointer-generator's attention on each rank's block, the
transformer's and the AAN's encoder on its block (ring or Ulysses
under --sp_attention, else the block's queries against the gathered
keys).  The slot engine keeps T whole on every rank (JAX
parallel/sharding.py:277-292).

A sharded decoder runs in one of two ways.  In lockstep (cli.py's decode,
the pipeline's transform) every rank calls ``decode``/``decode_batch``
and the chief alone holds the batcher.  Led (``led = True``: the serve
layer, serve/mesh.py) the chief alone calls, and each call sends its op
down the chief's command stream (``lead``) to the followers, which run
``serve.mesh.follow``; the slot engine on a mesh is always led.
``release_followers`` ends the stream.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.config import (
    SERVE_TIERS,
    HParams,
    bucket_for,
    derive_draft_hps,
    parse_bucket_spec,
    resolve_arena_pages,
    resolve_enc_block,
    resolve_spec_bounds,
)
from textsummarization_on_flink_tpu_torch.data import oov as oov_lib
from textsummarization_on_flink_tpu_torch.data.batching import Batch
from textsummarization_on_flink_tpu_torch.data.vocab import STOP_DECODING, Vocab
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode import speculative
from textsummarization_on_flink_tpu_torch.decode.arena import PageArena
from textsummarization_on_flink_tpu_torch.device import resolve_device
from textsummarization_on_flink_tpu_torch.evaluate import rouge
from textsummarization_on_flink_tpu_torch.models import avg_attention
from textsummarization_on_flink_tpu_torch.obs import cost as cost_lib
from textsummarization_on_flink_tpu_torch.obs import profile as profile_lib
from textsummarization_on_flink_tpu_torch.parallel import collectives
from textsummarization_on_flink_tpu_torch.parallel import distributed
from textsummarization_on_flink_tpu_torch.parallel import mesh as mesh_lib
from textsummarization_on_flink_tpu_torch.params import from_numpy_tree
from textsummarization_on_flink_tpu_torch.resilience.policy import Deadline

log = logging.getLogger(__name__)

SECS_UNTIL_NEW_CKPT = 60  # decode.py:36


def make_html_safe(s: str) -> str:
    """decode.py:252-255."""
    return s.replace("<", "&lt;").replace(">", "&gt;")


def words_to_sentences(decoded_words: List[str]) -> List[str]:
    """Split a decoded word stream into '.'-terminated sentences
    (decode.py:193-201 / write_for_flink :166-175)."""
    words = list(decoded_words)
    sents: List[str] = []
    while words:
        try:
            fst_period_idx = words.index(".")
        except ValueError:
            fst_period_idx = len(words) - 1
        sent = words[: fst_period_idx + 1]
        words = words[fst_period_idx + 1:]
        sents.append(" ".join(sent))
    return sents


def get_decode_dir_name(hps: HParams, ckpt_path: Optional[str]) -> str:
    """decode.py:303-313 naming (ckpt basename + key decode hps)."""
    if ckpt_path is not None:
        ckpt_name = "ckpt-" + os.path.basename(ckpt_path).split("-")[-1].split(".")[0]
    else:
        ckpt_name = "ckpt-none"
    return (f"decode_{ckpt_name}_{hps.max_enc_steps}maxenc_"
            f"{hps.beam_size}beam_{hps.min_dec_steps}mindec_"
            f"{hps.max_dec_steps}maxdec")


class DecodedResult:
    """One article's decode output (the streaming-row payload)."""

    def __init__(self, uuid: str, article: str, decoded_words: List[str],
                 reference: str, abstract_sents: List[str],
                 attn_dists: Optional[np.ndarray] = None,
                 p_gens: Optional[np.ndarray] = None,
                 degraded: bool = False, tier: str = "beam",
                 params_fingerprint: str = ""):
        self.uuid = uuid
        self.article = article
        self.decoded_words = decoded_words
        self.reference = reference
        self.abstract_sents = abstract_sents
        self.attn_dists = attn_dists
        self.p_gens = p_gens
        # True when the decode deadline forced beam search down to greedy
        self.degraded = degraded
        self.tier = tier
        # fingerprint of the params that decoded this result
        self.params_fingerprint = params_fingerprint

    @property
    def decoded_sents(self) -> List[str]:
        return [make_html_safe(s) for s in words_to_sentences(self.decoded_words)]

    @property
    def summary(self) -> str:
        return " ".join(self.decoded_sents)

    def as_row(self) -> Tuple[str, str, str, str]:
        """(uuid, article, summary, reference): the write_for_flink row
        (flink_writer.py:22-34), the pipeline's output row."""
        return (self.uuid, self.article, self.summary, self.reference)


class BeamSearchDecoder:
    """The decode loop over a batcher (decode.py:42-157).

    Params come either as a tree (``params=``: the port's tensors, or the
    JAX package's numpy tree, moved to ``hps.device``) or from the newest
    checkpoint in ``train_dir`` (reloaded in continuous mode).  After a
    single pass with ROUGE, ``rouge_results`` holds the scores.  The
    spec and draft tiers need a draft: ``draft_params=`` (a tree of
    either package, e.g. train/distill.load_distilled_draft's), or one
    built from ``hps.spec_draft``."""

    def __init__(self, hps: HParams, vocab: Vocab, batcher: Any,
                 params: Optional[Any] = None,
                 train_dir: Optional[str] = None,
                 decode_root: Optional[str] = None,
                 max_ckpt_retries: Optional[int] = None,
                 draft_params: Optional[Any] = None):
        if params is None and train_dir is None:
            raise ValueError("need params or train_dir")
        self._hps = hps
        self._vocab = vocab
        self._batcher = batcher
        self._train_dir = train_dir
        self._max_ckpt_retries = max_ckpt_retries
        self._device = resolve_device(hps.device)
        # guards the (params, ckpt_path) pair, which a continuous-mode
        # reload replaces together
        self._params_lock = threading.Lock()
        self._ckpt_path: Optional[str] = None
        self._fp_cache: Optional[Tuple[Any, str]] = None
        # the JAX decoder's metrics: per-request latency, finished
        # beams, token volume, busy seconds, checkpoint reloads
        self._obs = obs.registry_for(hps)
        self._m_latency = self._obs.histogram("decode/request_latency_seconds")
        self._c_requests = self._obs.counter("decode/requests_total")
        self._c_beams = self._obs.counter("decode/beams_finished_total")
        self._c_tokens = self._obs.counter("decode/tokens_total")
        self._c_busy = self._obs.counter("decode/busy_seconds_total")
        self._c_reloads = self._obs.counter("decode/ckpt_reloads_total")
        # deadline degradation: `_beam_secs` is an EMA of full-beam
        # dispatch latency; the first full-beam dispatch (CUDA context,
        # kernel builds) is not sampled, so the estimate starts at the
        # second
        self._c_degraded = self._obs.counter(
            "resilience/decode_degraded_total")
        self._g_beam_est = self._obs.gauge(
            "resilience/decode_beam_latency_est_seconds")
        self._beam_secs: Optional[float] = None
        self._beam_warm = False
        self.rouge_results: Optional[Dict[str, Dict[str, float]]] = None
        # the speculative tier (JAX decoder.py:194-236): the draft rides
        # the params lock, so a spec dispatch never pairs a new full
        # model with an old mapped draft; the accept-length buckets span
        # 0..spec_k_max, every k the adaptive controller may pick
        self._draft_params = (None if draft_params is None else
                              from_numpy_tree(draft_params, self._device))
        _, _, spec_k_max = resolve_spec_bounds(hps)
        self._h_accept = self._obs.histogram(
            "decode/spec_accept_len",
            buckets=[float(i) for i in range(0, spec_k_max + 1)])
        self._c_spec_cycles = self._obs.counter("decode/spec_cycles_total")
        self._c_spec_drafted = self._obs.counter(
            "decode/spec_draft_tokens_total")
        self._c_spec_accepted = self._obs.counter(
            "decode/spec_accepted_tokens_total")
        # one controller per decoder: it adapts k inside a dispatch and
        # carries its acceptance estimate across requests (mutated on the
        # dispatch path only); the gauge reads spec_k when not adaptive
        self._spec_ctl: Optional[speculative.SpecKController] = None
        self._g_spec_k = self._obs.gauge("decode/spec_k_current")
        self._g_spec_k.set(float(hps.spec_k))
        if hps.spec_k_adaptive:
            self._spec_ctl = speculative.SpecKController.from_hps(hps)
            self._g_spec_k.set(float(self._spec_ctl.k))
        # the mesh (JAX decoder.py:238-247): set before the params load,
        # which shards them
        self._plan = None
        self._sharded_search: Optional[Callable] = None
        # the chief's command stream (led mode; see the module docstring)
        self.led = False
        self._released = False
        if hps.dp * hps.tp * hps.sp > 1:
            self._plan = mesh_lib.make_mesh(hps)
            self._sharded_search = mesh_lib.make_sharded_beam_search(
                self._plan)
        if params is None:
            self._load_params()
        else:
            self._set_params(from_numpy_tree(params, self._device), None)
        if self._draft_params is None and hps.spec_draft:
            self._draft_params = avg_attention.make_draft_params(
                hps, self._params, seed=hps.seed)

        root = decode_root or os.path.join(hps.log_root or ".",
                                           hps.exp_name or "exp")
        # on a mesh the chief alone writes the decode dir
        self._writes = distributed.is_chief()
        if hps.single_pass:
            self._decode_dir = os.path.join(
                root, get_decode_dir_name(hps, self._ckpt_path))
            if self._writes and os.path.exists(self._decode_dir):
                raise FileExistsError(
                    f"single_pass decode directory {self._decode_dir} should "
                    "not already exist")  # decode.py:70-71
        else:
            self._decode_dir = os.path.join(root, "decode")
        self._rouge_ref_dir = os.path.join(self._decode_dir, "reference")
        self._rouge_dec_dir = os.path.join(self._decode_dir, "decoded")
        if self._writes:
            os.makedirs(self._decode_dir, exist_ok=True)
            if hps.single_pass:
                os.makedirs(self._rouge_ref_dir, exist_ok=True)
                os.makedirs(self._rouge_dec_dir, exist_ok=True)

    def _set_params(self, params: Any, path: Optional[str]) -> None:
        """Install (params, ckpt_path) under the lock; on a mesh also this
        rank's shards of the params for the sharded search."""
        shards = (None if self._plan is None
                  else self._plan.registry.shard_params(params))
        with self._params_lock:
            self._params, self._ckpt_path = params, path
            self._mesh_params = shards

    @property
    def sharded(self) -> bool:
        """True on a mesh: only the beam tier decodes (the serve layer
        refuses other tiers at submit)."""
        return self._sharded_search is not None

    @property
    def plan(self) -> Any:
        """The mesh plan, or None off a mesh."""
        return self._plan

    def lead(self, cmd: Tuple[Any, ...]) -> None:
        """On the chief of a mesh: send one op (``("decode",)``,
        ``("reload", path)``, ``("engine", op, ...)``) down the command
        stream; a no-op off a mesh and on a follower.  After
        ``release_followers`` only a release (host bookkeeping, no
        collective) may still be led, and is not sent."""
        if self._plan is None or not self._writes:
            return
        if self._released:
            if cmd[:2] == ("engine", "release"):
                return
            raise RuntimeError(
                f"the mesh's followers were released; op {cmd[:2]!r} "
                f"needs them")
        collectives.command(self._plan, cmd)

    def release_followers(self) -> None:
        """On the chief of a mesh: send the followers' stop, once."""
        if self._plan is None or not self._writes or self._released:
            return
        collectives.command(self._plan, ("stop",))
        self._released = True

    def _engine_params(self) -> Any:
        """The params the slot engine runs on: this rank's shards on a
        mesh, the full tree otherwise."""
        with self._params_lock:
            return self._params if self._plan is None else self._mesh_params

    def _params_snapshot(self) -> Tuple[Any, Optional[str]]:
        """The (params, ckpt_path) pair, read atomically."""
        with self._params_lock:
            return self._params, self._ckpt_path

    @property
    def params_fingerprint(self) -> str:
        """Content fingerprint of the active params
        (checkpoint.checkpointer.content_fingerprint — byte for byte the
        JAX package's), computed once per params object."""
        params, _ = self._params_snapshot()
        cached = self._fp_cache
        if cached is not None and cached[0] is params:
            return cached[1]
        fp = ckpt_lib.content_fingerprint(params)
        self._fp_cache = (params, fp)
        return fp

    def _load_params(self, path: Optional[str] = None) -> None:
        """Load the newest loadable checkpoint of the train dir, or the
        checkpoint at ``path``; on a mesh with no ``path`` every rank takes
        the one the chief found (a checkpoint that lands between two
        ranks' scans would otherwise split the mesh)."""
        if path is not None:
            flat = ckpt_lib.load_arrays_verified(path)
        else:
            path, flat = ckpt_lib.load_ckpt(
                self._train_dir, max_retries=self._max_ckpt_retries)
            if self._plan is not None:
                chief_path = collectives.broadcast_object(self._plan, path)
                if chief_path != path:
                    path, flat = chief_path, ckpt_lib.load_arrays_verified(
                        chief_path)
        tree = ckpt_lib._unflatten_dicts(flat)
        params = from_numpy_tree(tree["params"], self._device)
        draft = None
        if self._hps.spec_draft == "map":
            # the mapped draft is a view of the full params: derived from
            # the ones the swap installs, outside the lock like the load
            draft = avg_attention.make_draft_params(self._hps, params,
                                                    seed=self._hps.seed)
        self._set_params(params, path)
        if draft is not None:
            with self._params_lock:
                self._draft_params = draft
        log.info("decoder loaded checkpoint %s", path)

    def reload(self, path: str) -> None:
        """Load the checkpoint at ``path`` (a mesh follower's part of the
        chief's reload)."""
        self._load_params(path)
        self._c_reloads.inc()

    def maybe_reload_checkpoint(self, last_load: float) -> float:
        """Continuous-mode checkpoint refresh (decode.py:149-157): once
        ``SECS_UNTIL_NEW_CKPT`` seconds have passed since ``last_load`` (a
        ``time.monotonic()`` reference, so a wall-clock jump neither
        storms nor starves reloads), load the newest checkpoint of the
        train dir if it is not the one in use; the (params, ckpt_path)
        pair swaps under the lock and ``decode/ckpt_reloads_total``
        counts it.  On a mesh the chief's clock and newest checkpoint
        decide for every rank: in lockstep each call is one collective;
        led, only the chief calls, and a reload it decides on is sent to
        the followers with its path.  Returns the new reference time."""
        if self._train_dir is None:
            return last_load
        due = time.monotonic() - last_load >= SECS_UNTIL_NEW_CKPT
        latest = ckpt_lib.latest_checkpoint(self._train_dir) if due else None
        if self.led:
            if not due:
                return last_load
            _, current = self._params_snapshot()
            if latest is not None and latest != current:
                log.info("Decoder has been decoding for %.0f seconds; "
                         "loading new checkpoint %s",
                         time.monotonic() - last_load, latest)
                self.lead(("reload", latest))
                self.reload(latest)
            return time.monotonic()
        if self._plan is not None:
            # the ranks of a mesh reload together, at the chief's call
            due, latest = collectives.broadcast_object(self._plan,
                                                       (due, latest))
        if not due:
            return last_load
        _, current = self._params_snapshot()
        if latest is not None and latest != current:
            log.info("Decoder has been decoding for %.0f seconds; loading "
                     "new checkpoint", time.monotonic() - last_load)
            self._load_params()
            self._c_reloads.inc()
        return time.monotonic()

    def should_degrade(self, deadline: Deadline) -> bool:
        """True when the remaining budget cannot cover a full-beam
        dispatch (JAX decode/decoder.py:343-360): needs an estimate from
        a completed full-beam dispatch after the first one, so early
        requests never degrade."""
        return (deadline.bounded
                and self._sharded_search is None
                and self._hps.beam_size > 1
                and self._beam_secs is not None
                and deadline.remaining() < self._beam_secs)

    @property
    def has_draft(self) -> bool:
        """Whether the spec and draft tiers are servable (a draft model
        is configured: mapped, fresh or given)."""
        return self._draft_params is not None

    def _spec_snapshot(self) -> Tuple[Any, Any]:
        """The (full params, draft params) pair, read atomically."""
        with self._params_lock:
            return self._params, self._draft_params

    def decode_batch(self, batch: Batch,
                     deadline: Optional[Deadline] = None,
                     tier: Optional[str] = None) -> List[DecodedResult]:
        """One dispatch for the whole batch; one result per REAL input
        row (``batch.real_mask``: padding rows are dropped).

        An explicit ``tier`` (beam, greedy: beam_size=1, spec, draft) is
        dispatched as given: the serve layer already decided each
        request's degradation.  With ``tier=None`` the batch runs at the
        beam tier unless its deadline (the caller's, or one of
        ``decode_deadline_secs``; 0 never degrades) cannot cover the
        full-beam estimate: then it runs greedy, and its results are
        ``degraded`` and counted in ``resilience/decode_degraded_total``
        (JAX decode/decoder.py:382-450)."""
        if deadline is None:
            deadline = Deadline.after(self._hps.decode_deadline_secs)
        if self.sharded and tier not in (None, "beam"):
            raise ValueError(
                f"sharded (mesh) decoding supports the beam tier only; got "
                f"tier={tier!r}")
        if tier is not None:
            if tier not in SERVE_TIERS:
                raise ValueError(
                    f"tier must be one of {SERVE_TIERS}, got {tier!r}")
            degraded = False
            eff_tier = tier
        else:
            degraded = self.should_degrade(deadline)
            eff_tier = "greedy" if degraded else "beam"
        t0 = time.perf_counter()
        with obs.spans.span(self._obs, "decode/batch", tier=eff_tier):
            results = self._decode_batch_inner(batch, eff_tier)
        dt = time.perf_counter() - t0
        if degraded:
            for res in results:
                res.degraded = True
            self._c_degraded.inc(len(results))
            log.warning("decode deadline short of full-beam estimate "
                        "(%.3fs remaining < %.3fs est); degraded %d "
                        "result(s) to greedy", deadline.remaining(),
                        self._beam_secs, len(results))
        elif eff_tier == "beam":
            if not self._beam_warm:
                self._beam_warm = True  # the first dispatch: not sampled
            else:
                # EMA of full-beam dispatch latency only: greedy
                # dispatches must not pull the estimate down
                self._beam_secs = (dt if self._beam_secs is None
                                   else 0.7 * self._beam_secs + 0.3 * dt)
                self._g_beam_est.set(self._beam_secs)
        self._c_busy.inc(dt)
        # requests in a batch share one dispatch: the batch wall time is
        # each request's latency
        for res in results:
            self._m_latency.observe(dt)
            self._c_tokens.inc(len(res.decoded_words))
        self._c_requests.inc(len(results))
        self._c_beams.inc(len(results))
        return results

    def _decode_batch_inner(self, batch: Optional[Batch],
                            tier: str) -> List[DecodedResult]:
        # one atomic params read per dispatch (JAX decoder.py:452-502)
        if self._sharded_search is not None:
            # every rank searches the chief's batch; the others return
            # no results (batch may be None there)
            if self.led:
                self.lead(("decode",))
            arrays = collectives.broadcast_object(
                self._plan, batch.as_arrays() if self._writes else None)
            with self._params_lock:
                shards = self._mesh_params
            out = self._sharded_search(shards, arrays)
            if not self._writes:
                return []
        elif tier == "spec":
            full, draft = self._spec_snapshot()
            if draft is None:
                raise ValueError(
                    "spec tier needs a draft model: set hps.spec_draft "
                    "('map'/'fresh') or pass draft_params=")
            real = np.asarray(batch.real_mask, dtype=bool)
            out = speculative.run_spec_decode(full, draft, self._hps,
                                              batch.as_arrays(),
                                              controller=self._spec_ctl,
                                              real_mask=real)
            if self._spec_ctl is not None:
                self._g_spec_k.set(float(self._spec_ctl.k))
            self._c_spec_cycles.inc(int(out.cycles[real].sum()))
            self._c_spec_drafted.inc(int(out.drafted[real].sum()))
            self._c_spec_accepted.inc(int(out.accepted[real].sum()))
            # the histogram already counts cycles per accept length
            for a, count in enumerate(out.accept_hist[real].sum(axis=0)):
                self._h_accept.observe(float(a), n=int(count))
        elif tier == "draft":
            _, draft = self._spec_snapshot()
            if draft is None:
                raise ValueError(
                    "draft tier needs a draft model: set hps.spec_draft "
                    "('map'/'fresh') or pass draft_params=")
            dhps = derive_draft_hps(self._hps).replace(beam_size=1,
                                                       mode="decode")
            out = beam_search.run_beam_search(draft, dhps, batch.as_arrays())
        else:
            hps = (self._hps.replace(beam_size=1) if tier == "greedy"
                   else self._hps)
            params, _ = self._params_snapshot()
            out = beam_search.run_beam_search(params, hps, batch.as_arrays())
        results: List[DecodedResult] = []
        for b in range(len(batch.original_articles)):
            if not batch.real_mask[b]:
                continue
            results.append(self._make_result(
                out.tokens[b], int(out.length[b]), out.attn_dists[b],
                out.p_gens[b], uuid=batch.uuids[b],
                article=batch.original_articles[b],
                reference=batch.references[b],
                abstract_sents=batch.original_abstracts_sents[b],
                art_oovs=batch.art_oovs[b], tier=tier))
        return results

    def _make_result(self, tokens, length: int, attn_dists, p_gens, *,
                     uuid: str, article: str, reference: str,
                     abstract_sents: List[str], art_oovs: List[str],
                     tier: str = "beam") -> DecodedResult:
        """One article's raw beam output -> DecodedResult: START strip,
        id -> word through the article's OOVs, [STOP] truncation
        (decode.py:112-118)."""
        output_ids = [int(t) for t in tokens[1:length]]  # strip START
        decoded_words = oov_lib.outputids2words(
            output_ids, self._vocab, art_oovs)
        try:
            decoded_words = decoded_words[:decoded_words.index(STOP_DECODING)]
        except ValueError:
            pass
        return DecodedResult(
            uuid=uuid, article=article, decoded_words=decoded_words,
            reference=reference, abstract_sents=abstract_sents,
            attn_dists=attn_dists[: max(len(decoded_words), 1)],
            p_gens=p_gens[: max(len(decoded_words), 1)],
            tier=tier, params_fingerprint=self.params_fingerprint)

    def slot_engine(self, slots: int, chunk: int,
                    registry: Optional[obs.Registry] = None,
                    ) -> "SlotDecodeEngine":
        """The continuous-batching engine over this decoder's params:
        ``slots`` resident articles decoded ``chunk`` steps at a time,
        with refill between chunks (JAX decoder.py:553); on a mesh its
        resident slots shard over dp (JAX decoder.py:690-810).  Its
        spans and analytic prices go to ``registry`` (the serving
        server's; ``obs.registry_for(hps)`` when None)."""
        return SlotDecodeEngine(self, slots, chunk, registry=registry)

    def decode(self, with_rouge: bool = True,
               result_sink: Optional[Callable[[DecodedResult], None]] = None,
               max_batches: int = 0, log_results: bool = True,
               ) -> Optional[Dict[str, Dict[str, float]]]:
        """The main loop (decode.py:131-157).

        single_pass: decode the batcher's one pass, write the pyrouge
        files of every result, then (with_rouge) score them, write
        ``ROUGE_results.txt`` into the decode dir and return the scores
        (also kept as ``rouge_results``).  Otherwise decode until the
        batcher ends or ``max_batches``, logging each result and writing
        its attention-visualizer file unless ``log_results`` is False (the
        pipeline's transform wants its rows through the sink only), and
        reload a newer checkpoint every ``SECS_UNTIL_NEW_CKPT`` seconds.
        Every result also goes to ``result_sink`` at once."""
        t_last = time.monotonic()
        counter = 0
        n_batches = 0
        while True:
            # on a mesh the chief alone reads the batcher, and every rank
            # stops when it ends
            batch = self._batcher.next_batch() if self._writes else None
            if self._plan is not None:
                more = collectives.broadcast_object(self._plan,
                                                    batch is not None)
            else:
                more = batch is not None
            if not more:
                log.info("batcher exhausted; stopping decode loop")
                break
            t0 = time.monotonic()
            results = self.decode_batch(batch)
            log.info("decoded batch of %d article(s) in %.3f s",
                     len(results), time.monotonic() - t0)
            for res in results:
                if self._hps.single_pass:
                    self.write_for_rouge(res, counter)
                    counter += 1
                elif log_results:
                    log.info("ARTICLE: %s", res.article)
                    log.info("GENERATED SUMMARY: %s", res.summary)
                    self.write_for_attnvis(res)
                if result_sink is not None:
                    result_sink(res)
            n_batches += 1
            if max_batches and n_batches >= max_batches:
                break
            if not self._hps.single_pass:
                t_last = self.maybe_reload_checkpoint(t_last)
        if self._hps.single_pass and with_rouge and counter > 0 \
                and self._writes:
            log.info("Output has been saved in %s and %s. Now starting "
                     "ROUGE eval...", self._rouge_ref_dir,
                     self._rouge_dec_dir)
            self.rouge_results = rouge.rouge_eval(self._rouge_ref_dir,
                                                  self._rouge_dec_dir)
            rouge.rouge_log(self.rouge_results, self._decode_dir)
            return self.rouge_results
        return None

    def write_for_rouge(self, res: DecodedResult, ex_index: int) -> None:
        """pyrouge file layout (decode.py:187-222)."""
        decoded_sents = res.decoded_sents
        reference_sents = [make_html_safe(s) for s in res.abstract_sents]
        ref_file = os.path.join(self._rouge_ref_dir,
                                f"{ex_index:06d}_reference.txt")
        decoded_file = os.path.join(self._rouge_dec_dir,
                                    f"{ex_index:06d}_decoded.txt")
        with open(ref_file, "w", encoding="utf-8") as f:
            f.write("\n".join(reference_sents))
        with open(decoded_file, "w", encoding="utf-8") as f:
            f.write("\n".join(decoded_sents))
        log.info("Wrote example %i to file", ex_index)

    def write_for_attnvis(self, res: DecodedResult) -> None:
        """The attention visualizer's JSON (decode.py:225-249 field
        layout), rewritten for each result."""
        article_lst = res.article.split()
        to_write = {
            "article_lst": [make_html_safe(t) for t in article_lst],
            "decoded_lst": [make_html_safe(t) for t in res.decoded_words],
            "abstract_str": make_html_safe(" ".join(res.abstract_sents)),
            "attn_dists": (res.attn_dists[:, : len(article_lst)].tolist()
                           if res.attn_dists is not None else []),
        }
        if self._hps.pointer_gen and res.p_gens is not None:
            to_write["p_gens"] = res.p_gens.tolist()
        output_fname = os.path.join(self._decode_dir, "attn_vis_data.json")
        with open(output_fname, "w", encoding="utf-8") as f:
            json.dump(to_write, f)
        log.info("Wrote visualization data to %s", output_fname)


class PrefilledArticle(NamedTuple):
    """One article through the prefill stage: the request's example
    (uuid, reference and OOVs travel with it), its beam_search.PrefillState
    on the device, the serve bucket it was encoded at, and on a mesh its
    prefill id (the followers of dp index 0 keep their state under it)."""

    example: Any
    state: Any
    bucket: int
    pid: int = -1


#: the probe article a rank encodes once for the shapes and structure of
#: a PrefillState it must receive before it has prefilled one itself
_PROBE = dict(enc_batch=np.zeros((1, 1), np.int64),
              enc_lens=np.ones((1,), np.int64),
              enc_padding_mask=np.ones((1, 1), np.float32),
              enc_batch_extend_vocab=np.zeros((1, 1), np.int64))


def _pre_leaves(pre) -> List[Any]:
    """A PrefillState's tensors in order: the view's leaves, the mask,
    the extended-vocab ids."""
    return pytree.tree_leaves(pre.enc_view) + [pre.enc_mask, pre.ext_ids]


class SlotDecodeEngine:
    """The host side of the slot functions of decode/beam_search.py (JAX
    decoder.py:651-1050), for serve/batcher.ContinuousBatcher, which owns
    the requests.  One thread (the server's dispatch thread) calls
    prefill, pack, step and unpack; a chunk's one host sync is the read
    of its finished mask.

    The resident state keeps one shape, max_enc_steps wide; the prefill
    encodes each article at its serve bucket (the micro-batcher's list),
    and each chunk's attention reads only the prefix that the longest
    active resident needs.  With ``serve_arena_pages`` or
    ``serve_arena_mb`` the state is paged: a resident holds
    ceil(length / decode_enc_block) pages of a shared arena, and an
    admission the arena cannot hold raises ``ArenaExhaustedError``
    before any device state changes (the batcher requeues it).

    Each call reads the decoder's params snapshot, so a checkpoint
    reloaded between chunks takes effect at the next chunk.  Runs on the
    decoder's device (hps.device).

    On a mesh (a sharded decoder; JAX decoder.py:690-810, 875-885) the
    resident slots shard over dp (parallel/sharding.py's slot_state
    rule): slot i lives on dp index i // (slots / dp), and the tp and sp
    ranks of that index hold the same residents with their shards of the
    params.  The chief's calls are led (each sends its op down the
    command stream; the followers run serve.mesh.follow), and every rank
    keeps the host mirrors (which slots are resident, the page table):

      * ``prefill`` runs on dp index 0's ranks (the chief's), which keep
        the state;
      * ``pack`` runs on the owner's ranks: dp index 0's ranks send the
        prefilled state to the owner's over dp as tensors
        (collectives.send_between) when the owner is another index;
      * the batcher fills free slots in ``slot_order``, the dp indices
        in turn;
      * ``step`` runs on every rank over its own residents, the fused
        attention bounded by that rank's longest one, and returns the
        dp-gathered finished list, the same on every rank;
      * ``unpack`` finalizes on the owner's ranks and the result reaches
        the chief; ``release`` and the page frees are mirrored.

    The chief's ``PageArena`` is the one allocator: admission,
    backpressure and the allocation failures equal the single rank's.
    Every rank holds pools of the whole arena (the arena_pool rule) and
    writes and reads only its own residents' pages.  An op that raises on
    one rank raises on every rank (collectives.all_ok) before a rank
    waits on it.

    With ``profile_analytic`` the engine prices its dispatch shapes for
    the profiler's divergence sentinel (obs/cost.py, off the hot path):
    the chunk once, as ``serve/dispatch`` / ``slot_chunk<chunk>``, and
    each prefill bucket at its first use, as ``serve/prefill`` /
    bucket.  Not here, for want of its counterpart in the port: the JAX
    engine's compile-ledger budgets (eager PyTorch has no jit cache)."""

    def __init__(self, decoder: BeamSearchDecoder, slots: int, chunk: int,
                 registry: Optional[obs.Registry] = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if chunk < 1:
            raise ValueError(f"refill chunk must be >= 1, got {chunk}")
        self._dec = decoder
        self._hps = decoder._hps
        self._plan = decoder.plan
        if self._plan is not None and slots % self._hps.dp != 0:
            raise ValueError(
                f"continuous serving shards resident slots over dp: "
                f"dp={self._hps.dp} must divide serve slots={slots}")
        self.slots = slots
        self.chunk = min(chunk, self._hps.max_dec_steps)
        # the slot loop does not shard T (JAX parallel/sharding.py:
        # 277-292): its model functions run as at sp = 1; the prices stay
        # a rank's share of the whole mesh's
        self._run_hps = self._hps.replace(sp_attention="", sp=1)
        self._price_hps = self._hps.replace(sp_attention="")
        self._hps1 = self._hps.replace(batch_size=1)
        # this rank's slots [lo, lo + local) (all of them off a mesh)
        dp = self._hps.dp if self._plan is not None else 1
        self._local = slots // dp
        self._d = self._plan.coord("dp") if self._plan is not None else 0
        self._lo = self._d * self._local
        # the micro-batcher's bucket list: both serving modes encode an
        # article at the same shape
        self._buckets = parse_bucket_spec(self._hps.serve_buckets,
                                          self._hps.max_enc_steps)
        self._state = None  # built at this rank's first pack
        self._active = np.zeros(slots, dtype=bool)
        self._obs = (registry if registry is not None
                     else obs.registry_for(self._hps))
        self._prof = profile_lib.profiler_for(self._obs)
        self._priced_buckets: set = set()
        if self._hps.profile_analytic:
            # the engine's whole chunk (a rank is priced at its share)
            chunk_hps, n = self._price_hps.replace(batch_size=slots), \
                self.chunk
            self._prof.register_cost(
                "serve/dispatch", f"slot_chunk{n}",
                lambda: cost_lib.decode_step_cost(chunk_hps, path="slot",
                                                  chunk=n))
        self._block = resolve_enc_block(self._hps)
        self._b_max = -(-self._hps.max_enc_steps // self._block)
        page_bytes = None
        if self._hps.serve_arena_pages > 0 or self._hps.serve_arena_mb > 0:
            # the whole model's page: the arena's page count is the
            # single rank's
            page_bytes = beam_search.paged_page_bytes(
                decoder._params_snapshot()[0], self._run_hps)
        self._arena_pages = resolve_arena_pages(self._hps, page_bytes)
        self.paged = self._arena_pages > 0
        self._arena: Optional[PageArena] = (
            PageArena(self._arena_pages) if self.paged else None)
        # row i is slot i's page-table row; unused entries name the
        # scratch page (id = the arena's capacity)
        self._table = np.full((slots, self._b_max), self._arena_pages,
                              np.int64)
        self._page_rows: Dict[int, np.ndarray] = {}
        # on a mesh: dp index 0's prefilled states by prefill id, the
        # chief's next id, and a probe PrefillState (shapes, structure)
        self._pre: Dict[int, Any] = {}
        self._next_pid = 0
        self._template = None

    @property
    def slot_order(self) -> List[int]:
        """The order the batcher fills free slots in: the dp indices in
        turn on a mesh (slot 0 of each index, then slot 1, ..), so that
        every dp index takes residents under light load; 0, 1, .. off a
        mesh."""
        dp = self.slots // self._local
        return [d * self._local + i for i in range(self._local)
                for d in range(dp)]

    def _params(self):
        return self._dec._engine_params()

    def _lead(self, *cmd) -> Any:
        """Run one op: on the chief of a mesh send it first, then every
        rank runs its part (``apply``)."""
        if self._plan is not None:
            self._dec.lead(("engine",) + cmd)
        return self.apply(cmd)

    def apply(self, cmd: Tuple[Any, ...]) -> Any:
        """This rank's part of one op of the chief's (the followers' entry,
        serve.mesh.follow)."""
        op, args = cmd[0], cmd[1:]
        fn = dict(prefill=self._do_prefill, pack=self._do_pack,
                  step=self._do_step, unpack=self._do_unpack,
                  release=self._retire)[op]
        return fn(*args)

    def _agreed(self, err: Optional[BaseException], what: str) -> None:
        """Raise on every rank when the op failed on any (no-op off a
        mesh, where ``err`` is raised where it happens)."""
        if self._plan is None:
            if err is not None:
                raise err
            return
        if not collectives.all_ok(self._plan, err is None):
            raise err if err is not None else RuntimeError(
                f"slot engine {what} failed on another rank")

    def _owner(self, idx: int) -> int:
        return idx // self._local

    def _ensure_state(self, params, pre) -> None:
        if self._state is not None:
            return
        with collectives.bound(self._plan):
            if self.paged:
                self._state = beam_search.init_slots_paged(
                    params, self._run_hps, self._local, pre,
                    self._arena_pages)
            else:
                self._state = beam_search.init_slots(
                    params, self._run_hps, self._local, pre)

    def prefill(self, example) -> PrefilledArticle:
        """The prefill stage for one SummaryExample: the encoder (and the
        transformer's cross-attention K/V) at the article's serve bucket,
        padded to the resident width.  May run while other articles are
        resident."""
        bucket = bucket_for(self._buckets, example.enc_len)
        batch = Batch([example], self._hps1, self._dec._vocab,
                      enc_steps=bucket)
        arrays = {k: v for k, v in batch.as_arrays().items()
                  if k.startswith("enc_")}
        self._register_prefill_cost(bucket)
        pid = self._next_pid
        self._next_pid += 1
        pre = self._lead("prefill", pid, arrays)
        return PrefilledArticle(example=example, state=pre, bucket=bucket,
                                pid=pid)

    def _encode(self, arrays) -> Any:
        with collectives.bound(self._plan):
            return beam_search.prefill(self._params(), self._run_hps, arrays)

    def _register_prefill_cost(self, bucket: int) -> None:
        """Queue the analytic price of one prefill bucket, at its first
        use (``profile_analytic``)."""
        if not self._hps.profile_analytic or bucket in self._priced_buckets:
            return
        self._priced_buckets.add(bucket)
        hps = self._price_hps
        self._prof.register_cost(
            "serve/prefill", bucket,
            lambda: cost_lib.prefill_cost(hps, bucket))

    def _do_prefill(self, pid: int, arrays) -> Any:
        err, pre = None, None
        if self._d == 0:
            try:
                pre = self._encode(arrays)
            except Exception as e:  # noqa: BLE001 - raised by _agreed
                err = e
        self._agreed(err, "prefill")
        if self._plan is not None and pre is not None:
            self._pre[pid] = pre
        return pre

    def pages_needed(self, item) -> int:
        """Arena pages one admission takes: ceil(length / block), from the
        host-side example (0 when the state is dense)."""
        if not self.paged:
            return 0
        ex = item.example if isinstance(item, PrefilledArticle) else item
        enc_len = min(int(ex.enc_len), self._hps.max_enc_steps)
        return max(1, -(-enc_len // self._block))

    def free_pages(self) -> int:
        """Free arena pages (bottomless when the state is dense)."""
        if not self.paged:
            return 1 << 30
        return self._arena.free_pages

    def arena_stats(self) -> Optional[Dict[str, float]]:
        """The arena's capacity, free and in-use pages and fill; None when
        the state is dense.  Host counters only."""
        if not self.paged:
            return None
        a = self._arena
        return {"capacity": a.capacity, "free": a.free_pages,
                "in_use": a.pages_in_use, "fill": a.fill}

    def _named_tensors(self) -> Dict[str, Any]:
        """The resident state's device tensors by name (the host lengths
        left out)."""
        out: Dict[str, Any] = {}
        st = self._state
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            if f.name == "beam":
                v = {g.name: getattr(v, g.name)
                     for g in dataclasses.fields(v)}
            if isinstance(v, np.ndarray):
                continue
            leaves, _ = pytree.tree_flatten(v)
            for i, x in enumerate(leaves):
                out[f"{f.name}.{i}"] = x
        return out

    def resident_bytes_per_slot(self) -> float:
        """Mean device bytes one resident holds, of this rank's share on a
        mesh.  Dense: the state's bytes over the rank's slots (each slot
        holds the widest article's).  Paged: the dense part's share per
        slot plus the in-use pages' bytes over the residents.  Tensor
        metadata and host counters only."""
        if self._state is None:
            return 0.0
        total = float(sum(x.nbytes for x in self._named_tensors().values()))
        if not self.paged:
            return total / self._local
        st = self._state
        pools = list(st.enc_pages) + [st.ext_pool, st.attn_pool]
        pool_bytes = float(sum(x.nbytes for x in pools))
        dense = total - pool_bytes
        local = self._active[self._lo:self._lo + self._local]
        n_active = max(1, int(local.sum()))
        page = pool_bytes / st.attn_pool.shape[0]
        used = int(np.sum(self._table[self._lo:self._lo + self._local][
            local] != self._arena_pages))
        return dense / self._local + used * page / n_active

    def pack(self, idx: int, item) -> None:
        """Admit one prefilled article (or a SummaryExample, prefilled
        here) into free slot ``idx``.  Paged: its pages are allocated
        first, so ArenaExhaustedError leaves the device state untouched,
        and a pack that fails after the allocation frees them."""
        if self._active[idx]:
            raise AssertionError(f"slot {idx} is already resident")
        if not isinstance(item, PrefilledArticle):
            item = self.prefill(item)
        row = None
        ids = None
        if self.paged:
            need = self.pages_needed(item)
            ids = self._arena.alloc(need)  # may raise ArenaExhaustedError
            row = np.full(self._b_max, self._arena_pages, np.int64)
            row[:need] = ids
        try:
            if self._plan is None:
                self._pack_local(idx, item.state, row)
            else:
                self._lead("pack", idx, item.pid, row)
        except BaseException:
            if ids is not None:
                self._arena.free(ids)
            raise
        if ids is not None:
            self._page_rows[idx] = ids

    def _pack_local(self, idx: int, pre, row) -> None:
        """Slot ``idx`` (this rank's) := the prefilled state ``pre``."""
        params = self._params()
        self._ensure_state(params, pre)
        local = idx - self._lo
        with collectives.bound(self._plan):
            if self.paged:
                beam_search.pack_slot_paged(params, self._run_hps,
                                            self._state, local, pre, row)
            else:
                beam_search.pack_slot(params, self._run_hps, self._state,
                                      local, pre)
        if row is not None:
            self._table[idx] = row
        self._active[idx] = True

    def _probe(self) -> Any:
        """A PrefillState of the probe article: the structure, shapes and
        dtypes of one this rank must receive (encoded once; collective
        over tp like any prefill)."""
        if self._template is None:
            self._template = self._encode(_PROBE)
        return self._template

    def _do_pack(self, idx: int, pid: int, row) -> None:
        owner = self._owner(idx)
        err = None
        try:
            pre = None
            if self._d == 0:
                pre = self._pre.pop(pid)
                # the prefill queue packs in order: older ids were dropped
                for old in [p for p in self._pre if p < pid]:
                    del self._pre[old]
            if owner != 0 and self._d in (0, owner):
                like = None
                if self._d == owner:
                    like = _pre_leaves(self._probe())
                sent = collectives.send_between(
                    self._plan, None if pre is None else _pre_leaves(pre),
                    "dp", 0, owner, like=like)
                if self._d == owner:
                    pre = self._unflatten_pre(sent)
            if self._d == owner:
                self._pack_local(idx, pre, row)
        except Exception as e:  # noqa: BLE001 - raised by _agreed
            err = e
        self._agreed(err, "pack")
        # every rank mirrors the residency and the page row
        self._active[idx] = True
        if row is not None:
            self._table[idx] = row

    def _unflatten_pre(self, leaves) -> Any:
        """A received PrefillState: the probe's structure over ``leaves``;
        the true length rides the mask."""
        probe = self._probe()
        view_n = len(pytree.tree_leaves(probe.enc_view))
        _, spec = pytree.tree_flatten(probe.enc_view)
        mask = leaves[view_n]
        return beam_search.PrefillState(
            enc_view=pytree.tree_unflatten(list(leaves[:view_n]), spec),
            enc_mask=mask, ext_ids=leaves[view_n + 1],
            enc_valid_len=int(mask[0].sum().item()))

    def step(self) -> List[int]:
        """One chunk for every resident slot; the slots whose search
        finished (ready to unpack)."""
        if not self._active.any():
            return []
        with obs.spans.span(self._obs, "decode/slot_chunk",
                            active=int(self._active.sum())):
            return self._lead("step")

    def _do_step(self) -> List[int]:
        local = self._active[self._lo:self._lo + self._local]
        finished = np.zeros(self._local, dtype=bool)
        err = None
        if local.any():
            try:
                params = self._params()
                with collectives.bound(self._plan):
                    if self.paged:
                        finished = beam_search.step_slots_paged(
                            params, self._run_hps, self._state, local,
                            self._table[self._lo:self._lo + self._local],
                            self.chunk)
                    else:
                        finished = beam_search.step_slots(
                            params, self._run_hps, self._state, local,
                            self.chunk)
            except Exception as e:  # noqa: BLE001 - raised by _agreed
                err = e
        self._agreed(err, "step")
        if self._plan is not None:
            finished = collectives.all_gather(
                self._plan, torch.from_numpy(np.asarray(finished, np.uint8)),
                "dp", 0).numpy().astype(bool)
        return [int(i) for i in np.nonzero(finished)[0]]

    def unpack(self, idx: int, example) -> DecodedResult:
        """Retire slot ``idx``: its hypothesis as a DecodedResult, and the
        slot (and its pages) freed.  ``example`` is the SummaryExample
        packed into it."""
        if not self._active[idx]:
            raise AssertionError(f"slot {idx} is not resident")
        out = self._lead("unpack", idx)
        res = self._dec._make_result(
            out.tokens, int(out.length), out.attn_dists, out.p_gens,
            uuid=example.uuid, article=example.original_article,
            reference=example.reference,
            abstract_sents=example.original_abstract_sents,
            art_oovs=example.article_oovs)
        self._dec._c_requests.inc()
        self._dec._c_beams.inc()
        self._dec._c_tokens.inc(len(res.decoded_words))
        return res

    def _do_unpack(self, idx: int) -> Optional[beam_search.BeamSearchOutput]:
        owner = self._owner(idx)
        out, err = None, None
        try:
            if self._d == owner:
                local = idx - self._lo
                if self.paged:
                    out = beam_search.unpack_slot_paged(
                        self._run_hps, self._state, local, self._table[idx])
                else:
                    out = beam_search.unpack_slot(self._run_hps, self._state,
                                                  local)
        except Exception as e:  # noqa: BLE001 - raised by _agreed
            err = e
        self._agreed(err, "unpack")
        if self._plan is not None and owner != 0:
            out = self._result_to_chief(out, owner)
        self._retire(idx)
        return out

    def _result_to_chief(self, out, owner: int):
        """The owner's result at the chief: sent over dp by the owner's
        rank that shares the chief's tp and sp coordinates."""
        plan = self._plan
        if plan.coord("tp") != 0 or plan.coord("sp") != 0:
            return None
        T = self._hps.max_dec_steps
        T_enc = self._hps.max_enc_steps
        like = [torch.zeros(T + 1, dtype=torch.int32),
                torch.zeros((), dtype=torch.int32),
                torch.zeros((), dtype=torch.float32),
                torch.zeros((T, T_enc), dtype=torch.float32),
                torch.zeros(T, dtype=torch.float32)]
        sent = collectives.send_between(
            plan, None if out is None else [torch.from_numpy(np.array(x))
                                            for x in out],
            "dp", owner, 0, like=like if self._d == 0 else None)
        if self._d != 0:
            return None
        return beam_search.BeamSearchOutput(*[x.numpy() for x in sent])

    def _retire(self, idx: int) -> None:
        """Slot ``idx`` off every rank's mirrors; the chief's pages back
        to its arena, the row to scratch."""
        ids = self._page_rows.pop(idx, None)
        if ids is not None:
            self._arena.free(ids)
        if self.paged:
            self._table[idx] = self._arena_pages
        self._active[idx] = False

    def release(self, idx: int) -> None:
        """Free slot ``idx`` without unpacking (a deadline eviction): the
        stale state is masked until the next pack overwrites it."""
        self._lead("release", idx)

    def active_count(self) -> int:
        return int(self._active.sum())

    def cache_sizes(self) -> Dict[str, Tuple[int, ...]]:
        """The resident state's tensor shapes by name (this rank's share on
        a mesh).  The JAX engine reports its kernels' jit-cache sizes
        here; eager PyTorch has no jit cache, and what stays fixed across
        requests is the resident state's shape, which this returns (empty
        before the first pack)."""
        if self._state is None:
            return {}
        return {k: tuple(x.shape) for k, x in self._named_tensors().items()}
