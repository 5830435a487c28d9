"""The port's repairs of the widths the card refused (ROADMAP queue 3,
items 1, 4 and 5), on the CPU:

  * the fused attention's D padding: ``_padded_forward`` and
    ``_padded_backward`` around the plain versions equal the plain
    versions at the true D, odd D in f32 and D not a multiple of 8 in
    bf16: each output within 1e-6 times the larger of 1 and its largest
    magnitude, since the padded sums add exact zeros and only the order
    of f32 sums may differ; bf16 outputs, rounded once from those f32
    values, within one bf16 ulp beside that);
  * the launch form the wrappers mirror (a ring that steps down with D,
    then the slab form past the dense form's room), and
    ``HParams.validate`` taking every pointer-generator width on the
    card;
  * the JAX-only hyperparameters: every one accepted at its JAX default,
    any other value refused naming its ROADMAP item.

The flash kernels' head-dim padding (160 to 256) is held in
tests/test_torch_pg_checkpoint.py::test_flash_head_dim_padding_is_exact.
"""

import dataclasses
import shlex

import numpy as np
import pytest
import torch

from textsummarization_on_flink_tpu.config import HParams as JaxHParams
from textsummarization_on_flink_tpu_torch import config
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa


def _inputs(B, K, T, D, dtype, seed=0):
    """The fused attention's per-row inputs (K = 1 drops the query axis),
    article 1 fully masked."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T)[None] < rng.randint(T // 2, T + 1, B)[:, None])
    mask = mask.astype(np.float32)
    mask[1] = 0.0
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    es, ef = (t(rng.randn(B, T, D)).to(dtype) for _ in range(2))
    df = t(rng.randn(B, K, D))
    cov = t(np.abs(rng.randn(B, K, T)) * mask[:, None])
    v, w_c = t(rng.randn(D) * 0.1), t(rng.randn(D) * 0.1)
    return es, ef, t(mask), df, cov, v, w_c


def _bf16_ulp(x):
    return torch.finfo(torch.bfloat16).eps * x.float().abs().clamp(
        min=torch.finfo(torch.bfloat16).tiny)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        extra = _bf16_ulp(w) if w.dtype == torch.bfloat16 else 0.0
        tol = 1e-6 * max(1.0, float(w.float().abs().max()))
        assert bool(((g.float() - w.float()).abs() <= tol + extra).all())


@pytest.mark.parametrize("D,dtype", [(7, torch.float32),
                                     (510, torch.float32),
                                     (12, torch.bfloat16),
                                     (510, torch.bfloat16),
                                     (860, torch.bfloat16)])
@pytest.mark.parametrize("K", [1, 4])
def test_padded_forward_equals_the_plain_version(D, dtype, K):
    """Zero columns up to the 16-byte multiple add v . tanh(0) = 0 to
    every energy and give zero context columns, which are sliced away."""
    args = _inputs(3, K, 37, D, dtype, seed=D)
    assert fa._padded_width(D, dtype) % (8 if dtype == torch.bfloat16
                                          else 4) == 0
    got = fa._padded_forward(fa._attention_plain, *args, True)
    want = fa._attention_plain(*args, True)
    _close(got, want)
    assert not got[0][1].any() and not got[1][1].any()


@pytest.mark.parametrize("D,dtype", [(7, torch.float32),
                                     (510, torch.float32),
                                     (12, torch.bfloat16),
                                     (510, torch.bfloat16)])
@pytest.mark.parametrize("use_cov", [False, True])
def test_padded_backward_equals_the_plain_version(D, dtype, use_cov):
    """The backward at the padded width: every gradient equals the plain
    backward's at the true D (d_es, d_ef, d_df, d_v and d_w_c sliced back
    to D columns; d_cov over positions)."""
    es, ef, mask, df, cov, v, w_c = _inputs(3, 1, 29, D, dtype, seed=D)
    df, cov = df[:, 0], cov[:, 0]
    _, attn = fa._attention_plain(es, ef, mask, df[:, None], cov[:, None],
                                  v, w_c, use_cov)
    g = torch.Generator().manual_seed(D)
    g_ctx, g_attn = torch.randn(3, D, generator=g), torch.randn(3, 29,
                                                                generator=g)
    args = (es, ef, mask, df, cov, v, w_c, attn[:, 0], g_ctx, g_attn,
            use_cov)
    got = fa._padded_backward(fa._attention_bwd_plain, *args)
    want = fa._attention_bwd_plain(*args)
    _close(got, want)
    assert all(not x[1].any() for x in got[:4])


def test_an_aligned_width_is_not_copied():
    """D already a multiple of the 16-byte step goes to the kernel as it
    is: the same tensors, no padding copy."""
    seen = []
    args = _inputs(3, 2, 11, 16, torch.float32)
    fa._padded_forward(lambda *a: seen.append(a) or (a[3], a[4]), *args,
                       True)
    assert all(a is b for a, b in zip(seen[0], args))


@pytest.mark.parametrize("B,K,D,elt,form", [
    (16, 4, 512, 4, (False, 4, True, 0)),    # the beam-decode shape
    (16, 1, 860, 4, (False, 4, True, 0)),    # hidden 430 in training
    (16, 4, 800, 4, (False, 4, True, 0)),    # hidden 400 at beam 4
    (4, 4, 512, 4, (True, 8, True, 0)),      # the App's decode: wide clusters
    (4, 4, 800, 4, (True, 4, True, 0)),      # the wide ring steps down
    (2, 4, 2048, 4, (True, 2, True, 0)),     # ... to its last 2 chunks
    (16, 4, 2236, 4, (False, 4, True, 512)),  # past even that: slabs
    (16, 4, 1384, 2, (False, 4, True, 0)),   # bf16 rows: half the ring bytes
    (16, 4, 2400, 4, (False, 4, True, 512)),  # hidden 1200 at beam 4
    (16, 1, 2400, 4, (False, 2, True, 0)),   # ... at K = 1: dense still
    (4, 1, 4096, 4, (True, 4, True, 512)),   # the long form, slabs
    (16, 4, 4096, 2, (False, 4, True, 512)),  # bf16 past its dense room
    (2, 64, 512, 4, (True, 4, True, 256)),   # many queries: narrower slabs
])
def test_the_launch_form_steps_its_ring_down_with_d(B, K, D, elt, form):
    """The form launch() takes on a 132-SM card (wide clusters, ring
    chunks, state in shared memory, slab columns): the ring halves, down
    to 2 chunks, while the block's constants do not fit beside it; past
    that the slab form (a dense form never becomes one), its slab halved
    while K queries' slabs do not fit.  No width is refused."""
    assert fa._launch_form(B, 400, D, K, elt, 132) == form
    es = torch.empty(B, 400, D, device="meta",
                     dtype=torch.bfloat16 if elt == 2 else torch.float32)
    assert fa._shape_refusal(es, torch.empty(B, K, D, device="meta")) is None


@pytest.mark.parametrize("hidden,mode,slab,bwd_slab", [
    (256, "decode", False, False), (400, "decode", False, False),
    (430, "train", False, False), (691, "decode", False, False),
    (1117, "decode", True, False), (1155, "train", False, True),
    (255, "train", False, False), (1155, "eval", False, False),
    (1117, "eval", False, False), (1200, "decode", True, False),
    (1200, "train", False, True), (1200, "eval", False, False),
    (2048, "train", True, True), (2048, "decode", True, False)])
def test_validate_takes_every_width_on_the_card(hidden, mode, slab,
                                                bwd_slab, monkeypatch):
    """``HParams.validate`` takes every pointer-generator width on a
    132-SM card at batch 16, T 400 (the widths past 1,116 at beam 4 and
    1,154 in training that it refused before included), and the kernels
    take them: the dense forms where their constants fit one block, the
    slab forms past that (beam 4 in decode, K = 1 and the backward in
    training, the forward alone in eval)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(fa, "_sm_count", lambda dev: 132)
    HParams(mode=mode, hidden_dim=hidden, batch_size=16, max_enc_steps=400,
            beam_size=4, device="cuda").validate()
    D = fa._padded_width(2 * hidden, torch.float32)
    form = fa._launch_form(16, 400, D, 4 if mode == "decode" else 1, 4, 132)
    assert form is not None and bool(form[3]) == slab
    assert (mode == "train" and fa._bwd_form(D) == "slab") == bwd_slab


def _jax_only_nondefault():
    """A value other than the JAX default for every JAX-only field."""
    for name, (ftype, default) in config.JAX_ONLY_FIELDS.items():
        if ftype is bool:
            other = not default
        elif ftype is str:
            other = "other"
        else:
            other = ftype(default + 3)
        yield name, other


def test_jax_only_fields_mirror_the_jax_hparams():
    """JAX_ONLY_FIELDS is exactly the JAX HParams fields the port lacks,
    with the JAX types and defaults; the port and it cover every JAX
    field."""
    port = {f.name for f in dataclasses.fields(HParams)}
    jax_fields = {f.name: f for f in dataclasses.fields(JaxHParams)}
    assert set(config.JAX_ONLY_FIELDS) == set(jax_fields) - port
    for name, (ftype, default) in config.JAX_ONLY_FIELDS.items():
        assert jax_fields[name].type == ftype.__name__
        assert jax_fields[name].default == default


def test_jax_only_fields_at_their_defaults_are_accepted():
    """The JAX to_argv renders every field at its default (True, 5.0,
    ''): the port parses the string, and its own fields come through."""
    hps = HParams.from_string(JaxHParams(lr=0.25, hidden_dim=24).to_argv())
    assert (hps.lr, hps.hidden_dim) == (0.25, 24)
    argv = [f"--{n}={shlex.quote(str(d)) if str(d) else ''}"
            for n, (_, d) in config.JAX_ONLY_FIELDS.items()]
    assert HParams.from_string(" ".join(argv)) == HParams()


@pytest.mark.parametrize("name,other",
                         list(_jax_only_nondefault()),
                         ids=[n for n, _ in _jax_only_nondefault()])
def test_a_jax_only_field_off_its_default_names_its_item(name, other):
    """The one JAX-only field left, scan_unroll, changes no result: any
    value is taken and ignored.  No field is refused any more."""
    assert list(config.JAX_ONLY_FIELDS) == ["scan_unroll"]
    argv = [f"--{name}={other}", "--mode=decode", "--device=cpu"]
    assert HParams.from_argv(argv) == HParams(mode="decode", device="cpu")


def test_jax_flags_that_parsed_silently_now_raise():
    """The flags that parsed silently before the repair parse as the JAX
    package parses them: the mesh's and, since the profiler's sentinel
    was ported, the profiler's."""
    argv = ("--dp=2 --decode_deadline_secs=2 --spec_draft=map "
            "--serve_default_tier=greedy --grad_allreduce_dtype=bfloat16 "
            "--mode=decode").split()
    got, want = HParams.from_argv(argv), JaxHParams.from_argv(argv)
    assert (got.dp, got.grad_allreduce_dtype) == (want.dp,
                                                  want.grad_allreduce_dtype)
    assert (got.dp, got.grad_allreduce_dtype) == (2, "bfloat16")
    for flags in ("--sp 2", "--tp=2"):
        got, want = (HParams.from_argv(flags.split()),
                     JaxHParams.from_argv(flags.split()))
        assert (got.sp, got.tp) == (want.sp, want.tp) != (1, 1)
    for argv in (["--profile_analytic"],
                 ["--profile_divergence_factor", "2.5"]):
        got, want = HParams.from_argv(argv), JaxHParams.from_argv(argv)
        assert (got.profile_analytic, got.profile_divergence_factor) == (
            want.profile_analytic, want.profile_divergence_factor) != (
            False, 5.0)
    # the slot engine's flags came with the slot engine (item 4), the
    # speculative tier's with the AAN draft (item 5), the fleet's and the
    # hierarchical summarizer's with the fleet layer (item 7)
    assert HParams.from_argv(
        "--hier_chunk_words 64".split()).hier_chunk_words == 64
    assert HParams.from_argv("--serve_replicas=2".split()).serve_replicas == 2
    assert HParams.from_argv("--serve_slots 4".split()).serve_slots == 4
    assert HParams.from_argv("--spec_k_adaptive".split()).spec_k_adaptive
    # the obs fields came with the obs package: taken as JAX takes them
    assert HParams.from_argv("--obs False".split()).obs is False
    # a name neither package knows is ignored, as the reference does
    assert HParams.from_argv(["--no_such_flag=3"]) == HParams()


#: the fields the obs package, the serve layer, the speculative tier, the
#: fleet layer, the mesh, the profiler's sentinel and the bf16 decode
#: cache brought, each at a value other than its JAX default; the item's
#: label
#: where the value still needs an unported item, else None
PORTED_FLAGS = [
    ("obs", "False", None), ("obs_http_port", "9000", None),
    ("flight_frames", "8", None), ("summary_flush_every", "4", None),
    ("decode_deadline_secs", "2.5", None), ("serve_max_batch", "4", None),
    ("serve_max_wait_ms", "5.0", None), ("serve_max_queue", "32", None),
    ("serve_buckets", "100,200", None),
    ("serve_mode", "continuous", None),
    ("serve_slots", "4", None), ("serve_refill_chunk", "5", None),
    ("decode_enc_block", "32", None), ("serve_prefill_depth", "3", None),
    ("serve_arena_pages", "8", None), ("serve_arena_mb", "64.0", None),
    ("serve_cache_entries", "16", None), ("serve_cache_bytes", "4096", None),
    ("serve_coalesce", "True", None), ("serve_tenant_rate", "2.5", None),
    ("serve_tenant_burst", "3", None),
    ("serve_fair_weights", "free:1,paid:4", None),
    ("serve_default_tier", "greedy", None),
    ("serve_degrade_tier", "spec", None),
    ("spec_k", "3", None), ("spec_draft", "map", None),
    ("draft_dec_layers", "2", None), ("draft_hidden", "256", None),
    ("draft_vocab_rank", "64", None), ("spec_k_adaptive", "True", None),
    ("spec_k_min", "2", None), ("spec_k_max", "6", None),
    ("serve_replicas", "2", None), ("serve_hedge_ms", "40.0", None),
    ("serve_hedge_max_ratio", "0.25", None),
    ("serve_fleet_transport", "proc", None),
    ("serve_scrape_timeout_ms", "100.0", None),
    ("serve_scrape_interval_ms", "10.0", None),
    ("hier_chunk_words", "64", None), ("hier_overlap_words", "8", None),
    ("hier_chunk_tier", "beam", None), ("hier_reduce_tier", "greedy", None),
    ("dp", "2", None), ("tp", "2", None), ("sp", "2", None),
    ("sp_attention", "ring", None), ("grad_allreduce_dtype", "bfloat16", None),
    ("profile_analytic", "True", None),
    ("profile_divergence_factor", "2.5", None),
    ("decode_cache_dtype", "bfloat16", None),
]


@pytest.mark.parametrize("name,value,item", PORTED_FLAGS,
                         ids=[n for n, _, _ in PORTED_FLAGS])
def test_a_ported_flag_off_its_default_parses_as_jax_parses_it(name, value,
                                                              item):
    """The port's from_argv gives what the JAX HParams.from_argv gives;
    a value that needs an unported item raises naming it."""
    argv = [f"--{name}={value}", "--mode=decode", "--device=cpu"]
    assert name not in config.JAX_ONLY_FIELDS
    if item is not None:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue 1, " + item):
            HParams.from_argv(argv)
        return
    got = HParams.from_argv(argv)
    want = JaxHParams.from_argv(argv[:2])
    assert getattr(got, name) == getattr(want, name) != getattr(
        JaxHParams(), name)
    assert type(getattr(got, name)) is type(getattr(want, name))
    got.validate()


def test_summary_flush_every_buffers_as_the_jax_writer_does(tmp_path):
    """--summary_flush_every=k: both packages' writers hold k records
    before a flush, and write the same bytes."""
    from textsummarization_on_flink_tpu.train import trainer as jax_trainer
    from textsummarization_on_flink_tpu_torch.train import trainer

    mine = trainer.SummaryWriter(str(tmp_path / "port"), flush_every=3)
    theirs = jax_trainer.SummaryWriter(str(tmp_path / "jax"), flush_every=3)

    def on_disk(d):
        with open(tmp_path / d / "events.jsonl", "rb") as f:
            return f.read()

    for step in (1, 2):
        mine.scalars(step, loss=2.5 / step)
        theirs.scalars(step, loss=2.5 / step)
        assert on_disk("port") == on_disk("jax") == b""
    mine.scalars(3, loss=0.75)
    theirs.scalars(3, loss=0.75)
    assert on_disk("port") == on_disk("jax")
    assert on_disk("port").count(b"\n") == 3
