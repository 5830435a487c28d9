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

Fields of the JAX package that steer paths this package does not have
yet (mesh axes, serving engines, speculative tiers) are not fields here:
``JAX_ONLY_FIELDS`` lists them with their JAX types and defaults, and
``from_argv`` (so ``from_string`` and the pipeline's hyperparameter
strings too) accepts one at its default and raises
``NotImplementedError`` naming the ROADMAP item that brings it for any
other value, so a JAX run's flags never silently become a different
run.  Flags unknown to both packages are ignored, as the reference's
``FLAGS(known_only=True)`` does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shlex
from typing import Any, Dict, List, Optional, Tuple

#: ROADMAP.md names the queue item that brings each missing mode, option
#: or family; error messages point there
ROADMAP_BF16_TRANSFORMER = (
    "ROADMAP.md queue 1, item 2g (the transformer in bfloat16: bf16-operand "
    "forms of the flash kernels)")
ROADMAP_BF16_CACHE = "ROADMAP.md queue 2, item 6 (bf16 decode KV cache)"
ROADMAP_AAN = ("ROADMAP.md queue 1, item 5 (AAN draft, speculative decode, "
               "distillation)")
ROADMAP_HEAD_DIM = ("ROADMAP.md queue 3, item 1 (transformer head dims above "
                    "256 on the card)")
ROADMAP_PG_WIDTH = ("ROADMAP.md queue 3, item 4 (pointer-generator widths "
                    "past the fused attention kernels' shared memory on the "
                    "card)")
ROADMAP_SERVING = ("ROADMAP.md queue 1, item 3b (the serve layer behind "
                   "transform(serving=True))")
ROADMAP_MULTI_GPU = ("ROADMAP.md queue 1, item 6 (multi-GPU: data, tensor "
                     "and sequence parallelism)")
ROADMAP_OBS = ("ROADMAP.md queue 1, item 2d (the obs registry, flight "
               "recorder and resilience policy)")
ROADMAP_FLEET = ("ROADMAP.md queue 1, item 7 (the fleet layer: replicas, "
                 "hedging, the process fleet, hierarchical summarization)")
ROADMAP_SLOTS = ("ROADMAP.md queue 1, item 4 (the slot and paged decode "
                 "engine)")
ROADMAP_HIERSUM = ("ROADMAP.md queue 1, item 7 (hierarchical summarization "
                   "and the document framing behind "
                   "transform(hierarchical=True))")


#: the JAX package's HParams fields that the port does not have, as
#: name -> (type, JAX default, what brings it): a copy of the field list of
#: textsummarization_on_flink_tpu/config.py, kept literal under the import
#: rule.  A value other than the default raises NotImplementedError naming
#: the ROADMAP item.  ``scan_unroll`` (the lax.scan unroll factor of the
#: LSTM recurrences) names no item: it changes XLA's compile, never a
#: result, and eager PyTorch has no scan to unroll, so any value is taken
#: and ignored.
JAX_ONLY_FIELDS: Dict[str, Tuple[type, Any, Optional[str]]] = {
    "dp": (int, 1, ROADMAP_MULTI_GPU),
    "tp": (int, 1, ROADMAP_MULTI_GPU),
    "sp": (int, 1, ROADMAP_MULTI_GPU),
    "sp_attention": (str, "", ROADMAP_MULTI_GPU),
    "grad_allreduce_dtype": (str, "float32", ROADMAP_MULTI_GPU),
    "scan_unroll": (int, 8, None),
    "obs": (bool, True, ROADMAP_OBS),
    "obs_http_port": (int, 0, ROADMAP_OBS),
    "flight_frames": (int, 64, ROADMAP_OBS),
    "summary_flush_every": (int, 1, ROADMAP_OBS),
    "profile_analytic": (bool, False, ROADMAP_OBS),
    "profile_divergence_factor": (float, 5.0, ROADMAP_OBS),
    "decode_deadline_secs": (float, 0.0, ROADMAP_SERVING),
    "serve_max_batch": (int, 0, ROADMAP_SERVING),
    "serve_max_wait_ms": (float, 20.0, ROADMAP_SERVING),
    "serve_max_queue": (int, 256, ROADMAP_SERVING),
    "serve_buckets": (str, "", ROADMAP_SERVING),
    "serve_mode": (str, "microbatch", ROADMAP_SERVING),
    "serve_cache_entries": (int, 0, ROADMAP_SERVING),
    "serve_cache_bytes": (int, 0, ROADMAP_SERVING),
    "serve_coalesce": (bool, False, ROADMAP_SERVING),
    "serve_tenant_rate": (float, 0.0, ROADMAP_SERVING),
    "serve_tenant_burst": (int, 0, ROADMAP_SERVING),
    "serve_fair_weights": (str, "", ROADMAP_SERVING),
    "serve_slots": (int, 0, ROADMAP_SLOTS),
    "serve_refill_chunk": (int, 0, ROADMAP_SLOTS),
    "serve_prefill_depth": (int, 2, ROADMAP_SLOTS),
    "serve_arena_pages": (int, 0, ROADMAP_SLOTS),
    "serve_arena_mb": (float, 0.0, ROADMAP_SLOTS),
    "decode_enc_block": (int, 64, ROADMAP_SLOTS),
    "spec_k": (int, 4, ROADMAP_AAN),
    "spec_draft": (str, "", ROADMAP_AAN),
    "draft_dec_layers": (int, 0, ROADMAP_AAN),
    "draft_hidden": (int, 0, ROADMAP_AAN),
    "draft_vocab_rank": (int, 0, ROADMAP_AAN),
    "spec_k_adaptive": (bool, False, ROADMAP_AAN),
    "spec_k_min": (int, 1, ROADMAP_AAN),
    "spec_k_max": (int, 8, ROADMAP_AAN),
    "serve_default_tier": (str, "beam", ROADMAP_AAN),
    "serve_degrade_tier": (str, "greedy", ROADMAP_AAN),
    "serve_replicas": (int, 1, ROADMAP_FLEET),
    "serve_hedge_ms": (float, 0.0, ROADMAP_FLEET),
    "serve_hedge_max_ratio": (float, 0.1, ROADMAP_FLEET),
    "serve_fleet_transport": (str, "inproc", ROADMAP_FLEET),
    "serve_scrape_timeout_ms": (float, 250.0, ROADMAP_FLEET),
    "serve_scrape_interval_ms": (float, 50.0, ROADMAP_FLEET),
    "hier_chunk_words": (int, 0, ROADMAP_FLEET),
    "hier_overlap_words": (int, 0, ROADMAP_FLEET),
    "hier_chunk_tier": (str, "greedy", ROADMAP_FLEET),
    "hier_reduce_tier": (str, "beam", ROADMAP_FLEET),
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


def _refuse_jax_only(name: str, val: str) -> None:
    """Raise NotImplementedError when a JAX-only field gets a value other
    than its JAX default (compared as the field's type: ``to_argv``
    renders ``True``, ``0.15``, ``''``)."""
    ftype, default, item = JAX_ONLY_FIELDS[name]
    if item is not None and _parse_flag(ftype, val) != default:
        raise NotImplementedError(
            f"--{name}={val}: the PyTorch port has no {name!r} yet (only the "
            f"JAX default {default!r} is accepted); {item}")


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

    # transformer family (JAX config.py:77-83): hidden_dim is d_model,
    # embeddings are tied, ffn_dim=0 means 4*hidden_dim
    enc_layers: int = 6
    dec_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 0
    # storage type of the transformer's decode KV cache (JAX :260);
    # float32 only in the port
    decode_cache_dtype: str = "float32"

    # ---- the port's own ----
    device: str = "cuda"  # "cuda" or "cpu"; no silent fallback

    def replace(self, **kw: Any) -> "HParams":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @property
    def ffn_width(self) -> int:
        """Transformer FFN hidden width (ffn_dim, or 4*hidden_dim when 0)."""
        return self.ffn_dim or 4 * self.hidden_dim

    @classmethod
    def from_argv(cls, argv: List[str]) -> "HParams":
        """Parse the reference's space-joined ``--flag value`` /
        ``--flag=value`` hyperparameter string (known flags only, like
        FLAGS(known_only=True) at run_summarization.py:420).  A JAX-only
        field (``JAX_ONLY_FIELDS``) away from its default raises
        NotImplementedError."""
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        types = dict(fields)
        types.update((n, t) for n, (t, _, _) in JAX_ONLY_FIELDS.items())
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
            if name in JAX_ONLY_FIELDS:
                _refuse_jax_only(name, val)
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
        if self.compute_dtype == "bfloat16" and \
                self.model_family == "transformer":
            raise NotImplementedError(
                f"compute_dtype='bfloat16' with the transformer: its flash "
                f"kernels take float32 operands only; "
                f"{ROADMAP_BF16_TRANSFORMER}")
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
        if self.model_family == "transformer":
            if self.hidden_dim % self.num_heads != 0:
                raise ValueError(
                    f"num_heads={self.num_heads} must divide "
                    f"hidden_dim={self.hidden_dim}")
            if self.enc_layers < 1 or self.dec_layers < 1:
                raise ValueError("enc_layers/dec_layers must be >= 1")
            head_dim = self.hidden_dim // self.num_heads
            if self.device == "cuda" and head_dim > 256:
                raise ValueError(
                    f"head dim {head_dim} (hidden_dim / num_heads): the "
                    f"flash kernels take head dims up to 256 on the card; "
                    f"{ROADMAP_HEAD_DIM}")
        if self.device == "cuda" and self.model_family == "pointer_generator":
            self._refuse_pg_width()
        if self.decode_cache_dtype == "bfloat16":
            raise NotImplementedError(
                f"decode_cache_dtype='bfloat16': the port stores the KV "
                f"cache in float32 only; {ROADMAP_BF16_CACHE}")
        if self.decode_cache_dtype != "float32":
            raise ValueError(f"bad decode_cache_dtype "
                             f"{self.decode_cache_dtype!r}")
        if self.faults:
            # parse for validation only: unknown points and bad
            # probabilities fail here, not at the injection site
            from textsummarization_on_flink_tpu_torch.resilience import (
                faultinject,
            )

            faultinject.parse(self.faults)
        # families not ported yet raise from models.get_family, which
        # names their roadmap item
        from textsummarization_on_flink_tpu_torch.models import get_family

        get_family(self.model_family)


    def _refuse_pg_width(self) -> None:
        """On the card, refuse before a model is built an encoder width
        the fused attention kernels do not take (at the batch, the beam in
        decode, and with the backward only in training: eval runs the
        forward alone); without a card the entry points raise on the
        device instead."""
        import torch

        if not torch.cuda.is_available():
            return
        from textsummarization_on_flink_tpu_torch.ops import fused_attention

        dtype = (torch.bfloat16 if self.compute_dtype == "bfloat16"
                 else torch.float32)
        decode = self.mode == "decode" or self.inference
        refusal = fused_attention.width_refusal(
            self.batch_size, self.max_enc_steps, 2 * self.hidden_dim,
            self.beam_size if decode else 1, dtype,
            backward=self.mode == "train" and not self.inference)
        if refusal is not None:
            raise ValueError(
                f"hidden_dim={self.hidden_dim}: the fused attention kernels "
                f"do not take this width on the card ({refusal}); "
                f"{ROADMAP_PG_WIDTH}")


def beam_chunk_from_env() -> int:
    """Decode steps between two early-exit checks of the chunked beam
    loop (one host sync per chunk).  TS_BEAM_CHUNK, default 25 — the
    same variable and default as the JAX package."""
    return int(os.environ.get("TS_BEAM_CHUNK", "25"))
