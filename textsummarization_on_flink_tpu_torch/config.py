"""Typed hyperparameters for the PyTorch port.

A copy of the part of ``textsummarization_on_flink_tpu/config.py`` that
the port's paths read (beam decode, training and eval): the reference's
flag names and defaults (run_summarization.py:48-88), the static OOV
budget, the training cadence fields, the byte-diet and long-run options
of the trainer (``loss_chunk``, ``compute_dtype``, ``opt_state_dtype``,
``remat``, ``metrics_every``, ``steps_per_dispatch``, ``profile_dir``,
the divergence-recovery budgets and ``faults``), and the
``--flag=value`` argv parser and renderer (the pipeline's
hyperparameter strings).  The port adds one field, ``device``: entry
points run on ``cuda`` unless the caller asks for ``cpu``.

From the serve layer on it also carries the JAX package's observability
fields (``obs``, ``obs_http_port``, ``flight_frames``,
``summary_flush_every``) and its micro-batch serving fields
(``decode_deadline_secs`` and the ``serve_*`` queue, bucket, front-door
and tier fields), with the JAX types, defaults and checks, and the
serving helpers ``SERVE_TIERS``, ``parse_bucket_spec``,
``parse_fair_weights``, ``resolve_tenant_burst`` and ``bucket_for``.
The continuous engine's fields
(``serve_mode=continuous``, ``serve_slots``, ``serve_refill_chunk``,
``serve_prefill_depth``, ``serve_arena_pages``, ``serve_arena_mb``,
``decode_enc_block``) are the JAX package's, with its defaults, checks
and resolvers (``resolve_serve_slots``, ``resolve_enc_block``,
``resolve_refill_chunk``, ``resolve_arena_pages``).  The speculative
tier's and the AAN draft's fields (``spec_k``, ``spec_draft``,
``draft_dec_layers``, ``draft_hidden``, ``draft_vocab_rank``,
``spec_k_adaptive``, ``spec_k_min``, ``spec_k_max``) are the JAX
package's too, with its checks and its resolvers ``derive_draft_hps``,
``resolve_draft_hidden`` and ``resolve_spec_bounds``; every tier of
``SERVE_TIERS`` is served.  The fleet's fields (``serve_replicas``,
``serve_hedge_ms``, ``serve_hedge_max_ratio``, ``serve_fleet_transport``,
``serve_scrape_timeout_ms``, ``serve_scrape_interval_ms``) and the
hierarchical summarizer's (``hier_chunk_words``, ``hier_overlap_words``,
``hier_chunk_tier``, ``hier_reduce_tier``) are the JAX package's too,
with its checks and ``resolve_hier_chunk_words``; ``from_json`` reads
``to_json`` back (a process-fleet child takes its configuration so).

The mesh fields (``dp``, ``tp``, ``sp``, ``sp_attention``,
``grad_allreduce_dtype``) are the JAX package's, with its checks: a
world of ``dp * tp * sp`` ranks runs the sharded train, eval and batch
decode paths, the slot engine and the serve layer (parallel/), every
model family.

The profiler's fields (``profile_analytic``,
``profile_divergence_factor``) and the transformer's decode-cache
storage type (``decode_cache_dtype``) are the JAX package's, with its
defaults and checks.  The one JAX field the port has no use for,
``scan_unroll``, is in ``JAX_ONLY_FIELDS``: ``from_argv`` (so
``from_string`` and the pipeline's hyperparameter strings too) takes it
and ignores it.  Flags unknown to both packages are ignored, as the
reference's ``FLAGS(known_only=True)`` does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shlex
from typing import Any, Dict, List, Optional, Tuple

#: the JAX package's HParams fields that the port does not have, as
#: name -> (type, JAX default): a copy of the field list of
#: textsummarization_on_flink_tpu/config.py, kept literal under the import
#: rule.  ``scan_unroll`` (the lax.scan unroll factor of the LSTM
#: recurrences) changes XLA's compile, never a result, and eager PyTorch
#: has no scan to unroll, so any value is taken and ignored.
JAX_ONLY_FIELDS: Dict[str, Tuple[type, Any]] = {
    "scan_unroll": (int, 8),
}


def _parse_flag(ftype: Any, val: str) -> Any:
    """A flag's string value as the field's type (the reference's absl
    parsing: a boolean is true for 1/true/yes)."""
    if ftype in ("bool", bool):
        return str(val).lower() in ("1", "true", "yes")
    if ftype in ("int", int):
        return int(val)
    if ftype in ("float", float):
        return float(val)
    return val


@dataclasses.dataclass(frozen=True)
class HParams:
    # Where to find data (run_summarization.py:48-50)
    data_path: str = ""
    vocab_path: str = ""

    # Important settings (run_summarization.py:52-56)
    mode: str = "train"  # train / eval / decode
    num_steps: int = 0  # 0 = never stop
    single_pass: bool = False
    inference: bool = False  # decode from raw text files

    # Where to save output (run_summarization.py:58-60)
    log_root: str = ""
    exp_name: str = ""

    # Model hyperparameters (run_summarization.py:62-74)
    hidden_dim: int = 256
    emb_dim: int = 128
    batch_size: int = 16
    max_enc_steps: int = 400
    max_dec_steps: int = 100
    beam_size: int = 4
    min_dec_steps: int = 35
    vocab_size: int = 50000
    lr: float = 0.15
    adagrad_init_acc: float = 0.1
    rand_unif_init_mag: float = 0.02
    trunc_norm_init_std: float = 1e-4
    max_grad_norm: float = 2.0

    # Pointer-generator / coverage (run_summarization.py:76-81)
    pointer_gen: bool = True
    coverage: bool = False
    cov_loss_wt: float = 1.0

    # Checkpoint surgery flags (run_summarization.py:83-85): the CLI runs
    # the surgery and exits
    convert_to_coverage_model: bool = False
    restore_best_model: bool = False

    # Debugging (run_summarization.py:88): the trainer dumps the batch of
    # a non-finite loss to <train_dir>/nan_batch_step<N>.npz
    debug: bool = False

    # additions of the JAX package that the port's paths read
    max_oov_buckets: int = 128  # static extended-vocab budget
    compute_dtype: str = "float32"
    seed: int = 111  # the reference seeds tf at 111 (run_summarization.py:329)
    model_family: str = "pointer_generator"
    # checkpoint cadence in steps; 0 keeps the wall-clock cadence
    # (save_model_secs=60, run_summarization.py:198)
    checkpoint_steps: int = 0
    # metrics fetch cadence in steps (one device sync per window); 0 =
    # auto: 1 under --debug, 10 otherwise (JAX config.py:84-86)
    metrics_every: int = 0
    # > 0: the streaming chunked vocab loss, [chunk, B, V] scores at a
    # time in the forward and the backward (JAX config.py:92-100); 0
    # keeps the materialised loss
    loss_chunk: int = 0
    # Adagrad accumulator storage dtype; the update math stays f32 (JAX
    # config.py:101-105)
    opt_state_dtype: str = "float32"
    # recompute in the backward instead of keeping activations: the
    # transformer's layers, the pointer-generator's hoisted scores and
    # loss (JAX config.py:115-118)
    remat: bool = False
    # train steps per dispatch: k batches run back to back and their
    # metrics are read once; checkpoint and metrics cadences quantize to
    # dispatches; --debug forces 1 (JAX config.py:119-126)
    steps_per_dispatch: int = 1
    # profiler trace directory for the steps 2-7 capture window; "" =
    # none (TS_PROFILE_DIR is the fallback) (JAX config.py:155-163)
    profile_dir: str = ""
    # analytic pricing for the profiler's divergence sentinel: each
    # dispatch shape priced once off the hot path by obs/cost.py, and
    # achieved bytes/s and FLOPs/s gauges published against it; a
    # dispatch whose achieved bytes/s falls more than
    # profile_divergence_factor (> 1) below the shape's warm baseline
    # dumps the flight ring (JAX config.py:165-177)
    profile_analytic: bool = False
    profile_divergence_factor: float = 5.0
    # fault-injection arming for this job, "point:prob:seed[:max]"
    # comma-separated (resilience/faultinject.py; JAX config.py:178-184)
    faults: str = ""
    # divergence recovery: skip up to nan_skip_steps consecutive
    # non-finite steps, then roll back (cutting the LR by nan_lr_cut) up
    # to nan_max_rollbacks times, then raise NanLossError; both 0 keeps
    # the hard abort (JAX config.py:185-197)
    nan_skip_steps: int = 0
    nan_max_rollbacks: int = 0
    nan_lr_cut: float = 0.5

    # observability (obs/, JAX config.py:135-177): False runs this job
    # dark (obs.registry_for(hps) hands back the null registry); the
    # live exposition port (0 = off, TS_OBS_HTTP the fallback); the
    # flight recorder's ring in frames (0 = off); the summary writer's
    # flush cadence in records
    obs: bool = True
    obs_http_port: int = 0
    flight_frames: int = 64
    summary_flush_every: int = 1

    # per-request decode deadline in seconds; once a full-beam latency
    # estimate exists and the budget cannot cover it, beam degrades to
    # greedy (0 = no deadline) (JAX config.py:201-207)
    decode_deadline_secs: float = 0.0
    # micro-batch serving (serve/, JAX config.py:208-239): requests per
    # dispatch (0 = batch_size), the coalescing window, the admission
    # queue's depth, the encoder-length buckets ("" = auto), the engine
    # ("microbatch" or "continuous": the slot engine of decode/decoder.py)
    serve_max_batch: int = 0
    serve_max_wait_ms: float = 20.0
    serve_max_queue: int = 256
    serve_buckets: str = ""
    serve_mode: str = "microbatch"
    # continuous serving (JAX config.py:241-296): resident decode slots
    # (0 = batch_size); decode steps per chunk, the refill granularity
    # (0 = the TS_BEAM_CHUNK default, clamped to max_dec_steps); the
    # encoder-key block of the length-bounded slot step (clamped to
    # max_enc_steps); requests prefilled beyond the free slots per tick;
    # the page arena in pages (0 = dense slots unless serve_arena_mb
    # sets a byte budget in MiB)
    serve_slots: int = 0
    serve_refill_chunk: int = 0
    decode_enc_block: int = 64
    serve_prefill_depth: int = 2
    serve_arena_pages: int = 0
    serve_arena_mb: float = 0.0
    # the tier a request gets when it names none, and the tier a beam
    # request falls to under deadline pressure (JAX config.py:351-360)
    serve_default_tier: str = "beam"
    serve_degrade_tier: str = "greedy"
    # the front door (serve/frontdoor.py, JAX config.py:381-421): summary
    # cache entries and bytes (0 = off / unbounded), in-flight
    # coalescing, per-tenant token buckets (0 = unlimited; burst 0 =
    # about one second of rate), weighted-fair pickup "tenant:weight,..."
    serve_cache_entries: int = 0
    serve_cache_bytes: int = 0
    serve_coalesce: bool = False
    serve_tenant_rate: float = 0.0
    serve_tenant_burst: int = 0
    serve_fair_weights: str = ""
    # the fleet (serve/fleet.py, serve/procfleet.py; JAX config.py:
    # 362-441): replicas behind the FleetRouter (1 = a single server);
    # the hedge latency budget in ms (0 = off) and the hedge ceiling as a
    # share of admissions; "inproc" replicas (threads) or "proc" (one
    # supervised child process each); the hard deadline of every
    # supervisor-to-child scrape and connect, and the scrape cache window
    serve_replicas: int = 1
    serve_hedge_ms: float = 0.0
    serve_hedge_max_ratio: float = 0.1
    serve_fleet_transport: str = "inproc"
    serve_scrape_timeout_ms: float = 250.0
    serve_scrape_interval_ms: float = 50.0
    # hierarchical summarization (serve/hiersum.py; JAX config.py:
    # 443-461): words per map-pass chunk (0 = max_enc_steps), words of
    # overlap between adjacent chunks, and the map and reduce tiers ("" =
    # greedy and beam; both beam on a continuous server)
    hier_chunk_words: int = 0
    hier_overlap_words: int = 0
    hier_chunk_tier: str = "greedy"
    hier_reduce_tier: str = "beam"

    # transformer family (JAX config.py:77-83): hidden_dim is d_model,
    # embeddings are tied, ffn_dim=0 means 4*hidden_dim
    enc_layers: int = 6
    dec_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 0
    # storage type of the transformer's decode self-attention KV cache,
    # "float32" or "bfloat16" (widened to f32 at use) (JAX :260)
    decode_cache_dtype: str = "float32"

    # the speculative tier (JAX config.py:298-350): draft tokens proposed
    # per cycle; the draft ("" = none, "map" = mapped from the full
    # transformer's checkpoint, "fresh" = random init); the draft's
    # decoder layers (0 = dec_layers), width (0 = hidden_dim) and vocab
    # head rank (0 = the tied projection); the acceptance-adaptive draft
    # length and its bounds
    spec_k: int = 4
    spec_draft: str = ""
    draft_dec_layers: int = 0
    draft_hidden: int = 0
    draft_vocab_rank: int = 0
    spec_k_adaptive: bool = False
    spec_k_min: int = 1
    spec_k_max: int = 8

    # the (dp, tp, sp) mesh (JAX config.py:74-76, :106-114, :462-471):
    # axis sizes; the dp gradient all-reduce's wire dtype ("bfloat16":
    # dp x tp meshes with pointer losses); the transformer encoder's
    # sequence-parallel attention ("", "ring", "ulysses")
    dp: int = 1
    tp: int = 1
    sp: int = 1
    grad_allreduce_dtype: str = "float32"
    sp_attention: str = ""

    # ---- the port's own ----
    device: str = "cuda"  # "cuda" or "cpu"; no silent fallback

    def replace(self, **kw: Any) -> "HParams":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "HParams":
        """The inverse of ``to_json`` (JAX config.py:497): keys this
        package does not know are dropped."""
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def ffn_width(self) -> int:
        """Transformer FFN hidden width (ffn_dim, or 4*hidden_dim when 0)."""
        return self.ffn_dim or 4 * self.hidden_dim

    @classmethod
    def from_argv(cls, argv: List[str]) -> "HParams":
        """Parse the reference's space-joined ``--flag value`` /
        ``--flag=value`` hyperparameter string (known flags only, like
        FLAGS(known_only=True) at run_summarization.py:420).  A JAX-only
        field (``JAX_ONLY_FIELDS``) is parsed and dropped."""
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        types = dict(fields)
        types.update((n, t) for n, (t, _) in JAX_ONLY_FIELDS.items())
        bool_literals = ("1", "0", "true", "false", "yes", "no")
        out: Dict[str, Any] = {}
        i = 0
        toks = [t for t in argv if t]
        while i < len(toks):
            tok = toks[i]
            if not tok.startswith("--"):
                i += 1
                continue
            body = tok[2:]
            is_bool = types.get(body.split("=", 1)[0]) in ("bool", bool)
            if "=" in body:
                name, val = body.split("=", 1)
                i += 1
            elif (i + 1 < len(toks) and not toks[i + 1].startswith("--")
                  and not (is_bool and toks[i + 1].lower() not in bool_literals)):
                # separate-token value; for booleans only consume a literal,
                # so `--single_pass train_*.bin` reads as a bare True flag
                name, val = body, toks[i + 1]
                i += 2
            elif is_bool:  # bare boolean flag
                name, val = body, "True"
                i += 1
            else:  # non-bool flag with no value: skip it
                i += 1
                continue
            if name in fields:
                out[name] = _parse_flag(fields[name], val)
        return cls(**out)

    def to_argv(self) -> str:
        """Render as the reference's hyperparameter string (JAX
        config.py:548-556): every field as ``--name=value``, values with
        whitespace shell-quoted, an empty value as ``--name=``.  Parse
        it back with ``from_string``."""
        parts = []
        for f in dataclasses.fields(self):
            v = str(getattr(self, f.name))
            parts.append(f"--{f.name}={shlex.quote(v) if v else ''}")
        return " ".join(parts)

    @classmethod
    def from_string(cls, s: str) -> "HParams":
        """Parse a whole hyperparameter string (shlex-split, so quoted
        values with spaces survive the round trip)."""
        return cls.from_argv(shlex.split(s))

    def validate(self) -> None:
        if self.mode not in ("train", "eval", "decode"):
            raise ValueError(f"mode must be train/eval/decode, got {self.mode!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad compute_dtype {self.compute_dtype!r}")
        if self.loss_chunk < 0:
            raise ValueError(
                f"loss_chunk must be >= 0 (0 = materialized loss), got "
                f"{self.loss_chunk}")
        if self.opt_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"bad opt_state_dtype {self.opt_state_dtype!r} "
                f"(float32/bfloat16)")
        if self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{self.steps_per_dispatch}")
        if self.nan_skip_steps < 0 or self.nan_max_rollbacks < 0:
            raise ValueError("nan_skip_steps/nan_max_rollbacks must be >= 0")
        if not 0.0 < self.nan_lr_cut <= 1.0:
            raise ValueError(
                f"nan_lr_cut must be in (0, 1], got {self.nan_lr_cut}")
        if not 0 <= self.obs_http_port <= 65535:
            raise ValueError(f"obs_http_port must be in [0, 65535] "
                             f"(0 = off), got {self.obs_http_port}")
        if self.flight_frames < 0:
            raise ValueError(f"flight_frames must be >= 0 (0 = off), got "
                             f"{self.flight_frames}")
        if self.summary_flush_every < 1:
            raise ValueError(f"summary_flush_every must be >= 1, got "
                             f"{self.summary_flush_every}")
        if self.profile_divergence_factor <= 1.0:
            raise ValueError(
                f"profile_divergence_factor must be > 1 (a dispatch "
                f"cannot 'diverge' by running at or above baseline), "
                f"got {self.profile_divergence_factor}")
        self._validate_serving()
        self._validate_mesh()
        if self.max_dec_steps < 1 or self.max_enc_steps < 1:
            raise ValueError("max_enc_steps/max_dec_steps must be >= 1")
        if self.min_dec_steps >= self.max_dec_steps:
            raise ValueError("min_dec_steps must be < max_dec_steps")
        if self.beam_size < 1 or self.batch_size < 1:
            raise ValueError("beam_size/batch_size must be >= 1")
        if self.max_oov_buckets < 0:
            raise ValueError("max_oov_buckets must be >= 0")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{self.device!r}")
        if self.model_family in ("transformer", "avg_attention"):
            if self.hidden_dim % self.num_heads != 0:
                raise ValueError(
                    f"num_heads={self.num_heads} must divide "
                    f"hidden_dim={self.hidden_dim}")
            if self.enc_layers < 1 or self.dec_layers < 1:
                raise ValueError("enc_layers/dec_layers must be >= 1")
        self._validate_spec()
        if self.decode_cache_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"bad decode_cache_dtype {self.decode_cache_dtype!r} "
                f"(float32/bfloat16)")
        if self.faults:
            # parse for validation only: unknown points and bad
            # probabilities fail here, not at the injection site
            from textsummarization_on_flink_tpu_torch.resilience import (
                faultinject,
            )

            faultinject.parse(self.faults)
        # an unknown family raises from models.get_family
        from textsummarization_on_flink_tpu_torch.models import get_family

        get_family(self.model_family)

    def _validate_mesh(self) -> None:
        """The JAX package's checks of the mesh fields (JAX config.py:
        637-640, :656-670)."""
        if min(self.dp, self.tp, self.sp) < 1:
            raise ValueError(f"mesh axes must be >= 1, got dp={self.dp} "
                             f"tp={self.tp} sp={self.sp}")
        if self.sp_attention not in ("", "ring", "ulysses"):
            raise ValueError(
                f"sp_attention must be '', 'ring', or 'ulysses', got "
                f"{self.sp_attention!r}")
        if self.grad_allreduce_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"bad grad_allreduce_dtype {self.grad_allreduce_dtype!r} "
                f"(float32/bfloat16)")
        if self.grad_allreduce_dtype == "bfloat16":
            if self.sp > 1:
                raise ValueError(
                    "grad_allreduce_dtype=bfloat16 supports dp x tp "
                    "meshes (sp=1): the per-group gradient vmap does not "
                    "compose with sequence-parallel attention's shard_map")
            if not self.pointer_gen:
                raise ValueError(
                    "grad_allreduce_dtype=bfloat16 requires pointer_gen "
                    "losses: the baseline CE normalizes by the GLOBAL "
                    "token count, which the per-shard objective cannot "
                    "express (shard-mean != global mean)")

    def _validate_spec(self) -> None:
        """The JAX package's checks of the speculative tier's and the
        draft's fields (JAX config.py:591-627)."""
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.spec_draft not in ("", "map", "fresh"):
            raise ValueError(
                f"spec_draft must be ''|'map'|'fresh', got "
                f"{self.spec_draft!r}")
        if not 0 <= self.draft_dec_layers <= self.dec_layers:
            raise ValueError(
                f"draft_dec_layers must be in [0, dec_layers="
                f"{self.dec_layers}], got {self.draft_dec_layers}")
        if not 0 <= self.draft_hidden <= self.hidden_dim:
            raise ValueError(
                f"draft_hidden must be in [0, hidden_dim="
                f"{self.hidden_dim}] (0 = equal width), got "
                f"{self.draft_hidden}")
        if self.draft_hidden and self.draft_hidden % self.num_heads != 0:
            raise ValueError(
                f"num_heads={self.num_heads} must divide "
                f"draft_hidden={self.draft_hidden}")
        if self.draft_vocab_rank < 0:
            raise ValueError(
                f"draft_vocab_rank must be >= 0 (0 = tied projection), "
                f"got {self.draft_vocab_rank}")
        if (0 < self.draft_hidden < self.hidden_dim
                and self.draft_vocab_rank == 0):
            raise ValueError(
                "a narrow draft (draft_hidden < hidden_dim) requires a "
                "factored vocab head (draft_vocab_rank > 0): the tied "
                "[V, H] projection cannot consume H_d-wide states")
        if self.spec_k_min < 1 or self.spec_k_max < self.spec_k_min:
            raise ValueError(
                f"need 1 <= spec_k_min <= spec_k_max, got "
                f"[{self.spec_k_min}, {self.spec_k_max}]")
        if self.spec_k_adaptive and not (
                self.spec_k_min <= self.spec_k <= self.spec_k_max):
            raise ValueError(
                f"spec_k_adaptive needs the starting spec_k={self.spec_k} "
                f"inside [spec_k_min={self.spec_k_min}, "
                f"spec_k_max={self.spec_k_max}]")

    def _validate_serving(self) -> None:
        """The JAX package's checks of the serving fields (JAX
        config.py:628-636, :694-757)."""
        if self.serve_default_tier not in SERVE_TIERS:
            raise ValueError(
                f"serve_default_tier must be one of {SERVE_TIERS}, got "
                f"{self.serve_default_tier!r}")
        if (self.serve_degrade_tier not in SERVE_TIERS
                or self.serve_degrade_tier == "beam"):
            raise ValueError(
                f"serve_degrade_tier must be a tier BELOW beam "
                f"({SERVE_TIERS[1:]}), got {self.serve_degrade_tier!r}")
        if self.decode_deadline_secs < 0:
            raise ValueError(f"decode_deadline_secs must be >= 0, got "
                             f"{self.decode_deadline_secs}")
        if self.serve_max_batch < 0 or self.serve_max_batch > self.batch_size:
            raise ValueError(
                f"serve_max_batch must be in [0, batch_size={self.batch_size}]"
                f", got {self.serve_max_batch}")
        if self.serve_max_wait_ms < 0:
            raise ValueError(f"serve_max_wait_ms must be >= 0, got "
                             f"{self.serve_max_wait_ms}")
        if self.serve_max_queue < 1:
            raise ValueError(f"serve_max_queue must be >= 1, got "
                             f"{self.serve_max_queue}")
        # parse for validation only: bad bucket specs fail at config
        # time, not at the first micro-batch
        parse_bucket_spec(self.serve_buckets, self.max_enc_steps)
        if self.serve_mode not in ("microbatch", "continuous"):
            raise ValueError(
                f"serve_mode must be 'microbatch' or 'continuous', got "
                f"{self.serve_mode!r}")
        if self.serve_slots < 0:
            raise ValueError(f"serve_slots must be >= 0 (0 = batch_size), "
                             f"got {self.serve_slots}")
        if self.serve_refill_chunk < 0:
            raise ValueError(
                f"serve_refill_chunk must be >= 0 (0 = TS_BEAM_CHUNK "
                f"default), got {self.serve_refill_chunk}")
        if self.decode_enc_block < 1:
            raise ValueError(
                f"decode_enc_block must be >= 1, got {self.decode_enc_block}")
        if self.serve_prefill_depth < 0:
            raise ValueError(
                f"serve_prefill_depth must be >= 0, got "
                f"{self.serve_prefill_depth}")
        if self.serve_arena_pages < 0:
            raise ValueError(
                f"serve_arena_pages must be >= 0 (0 = paging off), got "
                f"{self.serve_arena_pages}")
        if self.serve_arena_mb < 0:
            raise ValueError(
                f"serve_arena_mb must be >= 0 (0 = no byte budget), got "
                f"{self.serve_arena_mb}")
        if self.serve_cache_entries < 0:
            raise ValueError(
                f"serve_cache_entries must be >= 0 (0 = cache off), got "
                f"{self.serve_cache_entries}")
        if self.serve_cache_bytes < 0:
            raise ValueError(
                f"serve_cache_bytes must be >= 0 (0 = no byte bound), "
                f"got {self.serve_cache_bytes}")
        if self.serve_tenant_rate < 0:
            raise ValueError(
                f"serve_tenant_rate must be >= 0 (0 = unlimited), got "
                f"{self.serve_tenant_rate}")
        if self.serve_tenant_burst < 0:
            raise ValueError(
                f"serve_tenant_burst must be >= 0 (0 = auto), got "
                f"{self.serve_tenant_burst}")
        parse_fair_weights(self.serve_fair_weights)


def beam_chunk_from_env() -> int:
    """Decode steps between two early-exit checks of the chunked beam
    loop (one host sync per chunk).  TS_BEAM_CHUNK, default 25 — the
    same variable and default as the JAX package."""
    return int(os.environ.get("TS_BEAM_CHUNK", "25"))


#: per-request serving quality tiers, costliest first (JAX config.py:
#: 772-775)
SERVE_TIERS = ("beam", "greedy", "spec", "draft")


def derive_draft_hps(hps: "HParams") -> "HParams":
    """The draft model's HParams from the full model's (JAX
    config.py:816): the avg_attention family at the same hidden width
    with ``draft_dec_layers`` decoder layers (0 = the full model's
    count).  The one resolver: the decoder, the spec engine and the
    distillation trainer all derive the draft's shape through it."""
    return hps.replace(
        model_family="avg_attention",
        dec_layers=hps.draft_dec_layers or hps.dec_layers)


def resolve_draft_hidden(hps: "HParams") -> int:
    """The draft's decoder width: draft_hidden, or hidden_dim when 0 (JAX
    config.py:828)."""
    return hps.draft_hidden or hps.hidden_dim


def resolve_spec_bounds(hps: "HParams") -> Tuple[int, int, int]:
    """(k_min, k_start, k_max) of the speculative tier (JAX config.py:
    837): all three spec_k unless spec_k_adaptive, else [spec_k_min,
    spec_k_max] around the starting spec_k.  The decoder's accept-length
    buckets, the SpecKController and the adaptive engine's verify-cache
    width all derive through it."""
    if not hps.spec_k_adaptive:
        return (hps.spec_k, hps.spec_k, hps.spec_k)
    return (hps.spec_k_min, hps.spec_k, hps.spec_k_max)


def parse_bucket_spec(spec: str, max_enc_steps: int) -> List[int]:
    """Resolve ``serve_buckets`` to the ascending encoder-length bucket
    list the serve micro-batcher pads into (JAX config.py:849-891).

    The one parser: HParams.validate() and serve/batcher.py both resolve
    through this.  ``max_enc_steps`` is always the top bucket.  Auto ("")
    is {max//4, max//2, max} without the buckets under 64 (except
    ``max_enc_steps`` itself); explicit specs keep every entry."""
    spec = (spec or "").strip()
    if not spec:
        buckets = sorted({max_enc_steps // 4, max_enc_steps // 2,
                          max_enc_steps})
        return [b for b in buckets
                if b == max_enc_steps or b >= 64]
    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            b = int(tok)
        except ValueError:
            raise ValueError(
                f"serve_buckets entry {tok!r} is not an integer") from None
        if b < 1:
            raise ValueError(f"serve_buckets entries must be >= 1, got {b}")
        if b > max_enc_steps:
            raise ValueError(
                f"serve_buckets entry {b} exceeds max_enc_steps="
                f"{max_enc_steps} (padding past the model's static "
                f"encoder budget buys nothing)")
        out.append(b)
    buckets = sorted(set(out))
    if not buckets or buckets[-1] != max_enc_steps:
        # the top bucket must cover every admissible article
        buckets.append(max_enc_steps)
    return buckets


def parse_fair_weights(spec: str) -> Dict[str, float]:
    """Resolve ``serve_fair_weights`` to a {tenant: weight} dict (JAX
    config.py:893-932); unlisted tenants weigh 1.0 at pickup."""
    spec = (spec or "").strip()
    if not spec:
        return {}
    out: Dict[str, float] = {}
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if ":" not in tok:
            raise ValueError(
                f"serve_fair_weights entry {tok!r} must be tenant:weight")
        tenant, _, w = tok.rpartition(":")
        tenant = tenant.strip()
        if not tenant:
            raise ValueError(
                f"serve_fair_weights entry {tok!r} names no tenant (the "
                f"default tenant's weight is always 1.0)")
        try:
            weight = float(w)
        except ValueError:
            raise ValueError(
                f"serve_fair_weights weight {w!r} is not a number"
            ) from None
        if weight <= 0:
            raise ValueError(
                f"serve_fair_weights weight for {tenant!r} must be > 0, "
                f"got {weight}")
        out[tenant] = weight
    return out


def resolve_tenant_burst(hps: "HParams") -> int:
    """Effective per-tenant token-bucket burst depth: serve_tenant_burst,
    or about one second of the rate (min 1) when 0 (JAX config.py:934)."""
    if hps.serve_tenant_burst:
        return hps.serve_tenant_burst
    return max(1, int(hps.serve_tenant_rate + 0.999999))


def resolve_serve_slots(hps: "HParams") -> int:
    """Effective continuous-mode slot count: serve_slots, or batch_size
    when 0 (JAX config.py:958)."""
    return hps.serve_slots or hps.batch_size


def resolve_enc_block(hps: "HParams") -> int:
    """Effective encoder-key block of the length-bounded slot step and
    the page arena: decode_enc_block clamped to [1, max_enc_steps] (JAX
    config.py:965)."""
    return max(1, min(int(hps.decode_enc_block), hps.max_enc_steps))


def resolve_refill_chunk(hps: "HParams") -> int:
    """Effective continuous-mode chunk length: serve_refill_chunk, or the
    TS_BEAM_CHUNK default, clamped to [1, max_dec_steps] (JAX
    config.py:987)."""
    chunk = hps.serve_refill_chunk or beam_chunk_from_env()
    return max(1, min(int(chunk), hps.max_dec_steps))


def resolve_arena_pages(hps: "HParams",
                        page_bytes: Optional[int] = None) -> int:
    """Effective page count of the slot engine's page arena (JAX
    config.py:995): serve_arena_pages when set, else what a
    serve_arena_mb byte budget buys at ``page_bytes`` per page
    (decode.beam_search.paged_page_bytes, required then), else 0 (dense
    slots).  A non-zero count must hold one full-length article,
    ceil(max_enc_steps / decode_enc_block) pages: a smaller arena would
    never admit it."""
    b_max = -(-hps.max_enc_steps // resolve_enc_block(hps))
    if hps.serve_arena_pages > 0:
        pages = int(hps.serve_arena_pages)
    elif hps.serve_arena_mb > 0:
        if not page_bytes or page_bytes <= 0:
            raise ValueError(
                "serve_arena_mb sizing needs page_bytes "
                "(beam_search.paged_page_bytes(params, hps))")
        pages = int(hps.serve_arena_mb * (1 << 20) // page_bytes)
    else:
        return 0
    if pages < b_max:
        raise ValueError(
            f"arena of {pages} page(s) cannot hold one full-length "
            f"article ({b_max} pages of {resolve_enc_block(hps)} rows "
            f"at max_enc_steps={hps.max_enc_steps}); raise "
            f"serve_arena_pages/serve_arena_mb or decode_enc_block")
    return pages


def resolve_hier_chunk_words(hps: "HParams") -> int:
    """Effective map-pass chunk width of hierarchical summarization:
    ``hier_chunk_words``, or the full encoder horizon when 0 (JAX
    config.py:1027).  The one resolver, so no two components disagree
    about where a chunk boundary falls."""
    return hps.hier_chunk_words or hps.max_enc_steps


def bucket_for(buckets: List[int], enc_len: int) -> int:
    """Smallest bucket covering ``enc_len`` (JAX config.py:975); articles
    are already truncated to buckets[-1]."""
    for b in buckets:
        if enc_len <= b:
            return b
    return buckets[-1]
