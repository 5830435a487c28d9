"""The port's speculative tier against the JAX package's, on the CPU.

Mirrors tests/test_speculative.py at its widths (TF_HPS, PG_HPS,
AAN_HPS): the params of both models come from the JAX package
(``make_models``, jax.random) and are carried across as numpy, and the
same numpy article arrays go to both packages.  The port's
``run_spec_decode`` must give the JAX package's tokens, lengths, cycle
counts, accepted counts and accept histograms exactly (mapped, fresh and
narrow drafts, fixed and adaptive k), and the port's own greedy tier's
tokens, with the log-probs, attention and p_gen within rtol 1e-5 / atol
1e-6 (f32 on both sides; the verifier's softmax runs over a wider cache
than the greedy step's, so only the order of sums differs).  Then the
decoder's spec and draft tiers and their metrics, the serve layer's tier
check and degrade ladder, and the mapped draft's re-derivation at a
checkpoint reload.
"""

import dataclasses
import tempfile

import jax
import numpy as np
import pytest
import torch

from tests.test_speculative import (
    AAN_HPS,
    PG_HPS,
    TF_HPS,
    make_arrays,
    make_models,
    serve_hps as jax_serve_hps,
)
from textsummarization_on_flink_tpu.config import (
    derive_draft_hps as jax_derive_draft_hps,
)
from textsummarization_on_flink_tpu.decode import (
    speculative as jax_spec,
)
from textsummarization_on_flink_tpu.models import (
    avg_attention as jax_aan,
    get_family as jax_get_family,
)
from textsummarization_on_flink_tpu_torch import config, obs
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data.batching import (
    Batch,
    SummaryExample,
)
from textsummarization_on_flink_tpu_torch.data.vocab import STOP_ID, Vocab
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode import speculative
from textsummarization_on_flink_tpu_torch.decode.decoder import (
    BeamSearchDecoder,
)
from textsummarization_on_flink_tpu_torch.models import transformer as tfm
from textsummarization_on_flink_tpu_torch.obs import Registry
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
)
from textsummarization_on_flink_tpu_torch.serve.server import ServingServer
from textsummarization_on_flink_tpu_torch.train import trainer

TOL = dict(rtol=1e-5, atol=1e-6)
#: the JAX serving tests' vocabulary (tests/test_speculative.py)
SERVE_WORDS = ["the", "a", "cat", "dog", "sat", "ran", "mat", "it", "was",
               "."]
#: its size with the four specials: the vocab_size of the port's serving
#: hyperparameters here (a JAX gather clamps an id past the embedding, a
#: torch index raises)
SERVE_VSIZE = len(SERVE_WORDS) + 4


@pytest.fixture(autouse=True)
def _isolated_obs():
    """Each test's metrics in a registry of its own: a histogram keeps
    the buckets of its first registration."""
    with obs.use_registry(Registry()) as reg:
        yield reg


def port_hps(jhps, **kw):
    """The port's HParams of a JAX HParams (its fields the port has), on
    the CPU."""
    fields = {f.name: getattr(jhps, f.name)
              for f in dataclasses.fields(config.HParams)
              if f.name != "device"}
    fields.update(kw)
    return config.HParams(device="cpu", **fields)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def assert_spec_matches_greedy(spec, greedy):
    """The port's spec output against its greedy tier (beam_size=1 beam
    search), row by row."""
    for b in range(spec.tokens.shape[0]):
        n = int(greedy.length[b])
        assert int(spec.length[b]) == n, b
        assert list(spec.tokens[b][:n]) == list(greedy.tokens[b][:n]), b
        np.testing.assert_allclose(spec.avg_log_prob[b],
                                   greedy.avg_log_prob[b], **TOL)
        np.testing.assert_allclose(spec.attn_dists[b][:n - 1],
                                   greedy.attn_dists[b][:n - 1], **TOL)
        np.testing.assert_allclose(spec.p_gens[b][:n - 1],
                                   greedy.p_gens[b][:n - 1], **TOL)


def assert_spec_matches_jax(spec, want):
    """Exactly JAX's tokens and counts; its scores at f32 tolerance."""
    for f in ("tokens", "length", "cycles", "drafted", "accepted",
              "accept_hist"):
        np.testing.assert_array_equal(getattr(spec, f),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(spec.avg_log_prob,
                               np.asarray(want.avg_log_prob), **TOL)
    np.testing.assert_allclose(spec.attn_dists, np.asarray(want.attn_dists),
                               **TOL)
    np.testing.assert_allclose(spec.p_gens, np.asarray(want.p_gens), **TOL)


def run_both(jhps, params, draft, arrays, **kw):
    """(port spec, JAX spec, port greedy) on one batch."""
    thps = port_hps(jhps, **kw)
    jhps = jhps.replace(**kw)
    tp, td = from_numpy_tree(params), from_numpy_tree(draft)
    spec = speculative.run_spec_decode(tp, td, thps, arrays)
    want = jax_spec.run_spec_decode(params, draft, jhps, arrays)
    greedy = beam_search.run_beam_search(tp, thps.replace(beam_size=1),
                                         arrays)
    return spec, want, greedy


def jax_models(jhps, narrow=False, fresh=False, seed=0):
    """(full, draft) numpy trees from the JAX package: the JAX test's
    mapped (transformer) or fresh (other families) draft, or a narrow /
    fresh draft of the transformer."""
    if not (narrow or fresh):
        return tuple(numpy_tree(x) for x in make_models(jhps, seed))
    full = jax_get_family(jhps.model_family).init_params(
        jhps, jhps.vocab_size, jax.random.PRNGKey(seed))
    dhps = jax_derive_draft_hps(jhps)
    if fresh:
        draft = jax_aan.init_params(dhps, jhps.vocab_size,
                                    jax.random.PRNGKey(seed + 2))
    else:
        draft = jax_aan.init_from_transformer(full, jhps, dhps,
                                              jax.random.PRNGKey(seed + 1))
    return numpy_tree(full), numpy_tree(draft)


NARROW = dict(draft_hidden=4, draft_vocab_rank=4)
CASES = [
    pytest.param(TF_HPS, {}, False, id="tf-mapped"),
    pytest.param(PG_HPS, {}, True, id="pg-fresh"),
    pytest.param(TF_HPS.replace(**NARROW), {"narrow": True}, False,
                 id="tf-narrow-mapped"),
    pytest.param(TF_HPS.replace(**NARROW), {"fresh": True}, True,
                 id="tf-narrow-fresh"),
]


@pytest.mark.parametrize("jhps,model_kw,_fresh", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_spec_decode_matches_jax_and_greedy(jhps, model_kw, _fresh, seed):
    params, draft = jax_models(jhps, **model_kw)
    spec, want, greedy = run_both(jhps, params, draft,
                                  make_arrays(jhps, 3, seed=seed))
    assert_spec_matches_jax(spec, want)
    assert_spec_matches_greedy(spec, greedy)


@pytest.mark.parametrize("jhps", [TF_HPS, PG_HPS], ids=["tf", "pg"])
def test_adaptive_k_trajectory_matches_jax(jhps):
    """spec_k_adaptive: the same outputs as JAX's and the same k picked at
    every cycle by both packages' controllers (the one draft ratio)."""
    kw = dict(spec_k_adaptive=True, spec_k=3, spec_k_min=1, spec_k_max=5)
    params, draft = jax_models(jhps)
    thps = port_hps(jhps, **kw)
    jhps = jhps.replace(**kw)
    seen = {"port": [], "jax": []}

    def spy(base, key):
        class Spy(base):
            def update(self):
                seen[key].append(super().update())
                return self.k
        return Spy(1, 3, 5, draft_ratio=0.25)

    tctl = spy(speculative.SpecKController, "port")
    jctl = spy(jax_spec.SpecKController, "jax")
    tp, td = from_numpy_tree(params), from_numpy_tree(draft)
    for seed in range(3):
        arrays = make_arrays(jhps, 3, seed=seed)
        spec = speculative.run_spec_decode(tp, td, thps, arrays,
                                           controller=tctl)
        want = jax_spec.run_spec_decode(params, draft, jhps, arrays,
                                        controller=jctl)
        assert_spec_matches_jax(spec, want)
        assert_spec_matches_greedy(spec, beam_search.run_beam_search(
            tp, thps.replace(beam_size=1), arrays))
    # the controllers left k_start (3) and took the same k each cycle
    assert seen["port"] == seen["jax"] and set(seen["port"]) != {3}
    assert (tctl.cycles, tctl.drafted, tctl.accepted) == \
        (jctl.cycles, jctl.drafted, jctl.accepted)


def test_accept_all_with_the_aan_as_its_own_draft():
    """A perfect draft: every proposal accepted, still greedy's tokens,
    and JAX's counts."""
    full = numpy_tree(jax_get_family("avg_attention").init_params(
        AAN_HPS, AAN_HPS.vocab_size, jax.random.PRNGKey(0)))
    spec, want, greedy = run_both(AAN_HPS, full, full,
                                  make_arrays(AAN_HPS, 3))
    assert_spec_matches_jax(spec, want)
    assert_spec_matches_greedy(spec, greedy)
    np.testing.assert_array_equal(spec.accepted, spec.drafted)
    assert int(spec.accept_hist[:, :AAN_HPS.spec_k].sum()) == 0


def test_reject_at_0_holds_in_both_packages():
    """An adversarial draft rejected at position 0 every cycle: it
    proposes a token that appears in no article, with its p_gen pushed to
    1 so that no copy mass can reach another token, and the full model's
    bias keeps that token out of its own choices.  Every cycle then emits
    exactly the full model's correction: accepted 0, cycles = generated
    tokens, in the port and in the JAX package."""
    params, draft = jax_models(TF_HPS)
    arrays = make_arrays(TF_HPS, 3, seed=4)
    absent = sorted(set(range(STOP_ID + 1, TF_HPS.vocab_size))
                    - set(arrays["enc_batch_extend_vocab"].ravel().tolist()))
    assert absent, "every id appears in the articles: pick another seed"
    tok = absent[0]
    draft["out_bias"] = draft["out_bias"].copy()
    draft["out_bias"][tok] = 1e4
    draft["pgen_linear"]["bias"] = np.full_like(
        draft["pgen_linear"]["bias"], 1e4)
    params["out_bias"] = params["out_bias"].copy()
    params["out_bias"][tok] = -1e4
    spec, want, greedy = run_both(TF_HPS, params, draft, arrays)
    assert_spec_matches_jax(spec, want)
    assert_spec_matches_greedy(spec, greedy)
    for out in (spec, want):
        assert int(np.sum(out.accepted)) == 0
        np.testing.assert_array_equal(out.cycles, np.asarray(out.length) - 1)
        np.testing.assert_array_equal(np.asarray(out.accept_hist)[:, 0],
                                      out.cycles)


def test_spec_verify_matches_jax_per_position():
    """The transformer's parallel verifier: one block of S positions per
    row, each row at its own step, against the JAX spec_verify of each
    article alone (tokens of the top-2, log-probs, attention, p_gen)."""
    jhps = TF_HPS.replace(beam_size=1)
    thps = port_hps(jhps)
    params, _ = jax_models(TF_HPS)
    arrays = make_arrays(jhps, 3, seed=2)
    S = jhps.spec_k + 1
    rng = np.random.RandomState(0)
    tokens = rng.randint(4, jhps.vocab_size, size=(3, S)).astype(np.int32)
    t0 = np.array([0, 3, jhps.max_dec_steps - 1], np.int32)
    jfam = jax_get_family("transformer")
    jenc = jfam.beam_encode(params, jhps, arrays)
    tp = from_numpy_tree(params)
    dev = beam_search._to_device(arrays, "cpu")
    tenc = tfm.beam_encode(tp, thps, dev)
    state = tfm.spec_init_state(thps, jhps.spec_k, 3, "cpu")
    got = tfm.spec_verify(tp, thps, tenc, dev["enc_padding_mask"],
                          dev["enc_batch_extend_vocab"],
                          torch.as_tensor(t0).long(),
                          torch.as_tensor(tokens).long(), state)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    for b in range(3):
        one = jax.tree_util.tree_map(lambda x, b=b: x[b], jenc)
        want = jfam.spec_verify(
            jparams, jhps, one, arrays["enc_padding_mask"][b],
            arrays["enc_batch_extend_vocab"][b], np.int32(t0[b]),
            tokens[b], jfam.spec_init_state(jhps, jhps.spec_k))
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:4], want[1:4]):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(
            got[4]["cache_k"][b].numpy(), np.asarray(want[4]["cache_k"]),
            **TOL)


def test_controller_trajectories_and_speedup_match_the_budget():
    """The committed BYTE_BUDGET.json spec.adaptive trajectories and the
    expected_speedup curve, from the port's copies."""
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__), "..",
                           "BYTE_BUDGET.json")) as f:
        spec_budget = json.load(f)["spec"]
    ad = spec_budget["adaptive"]
    per = int(ad["cycles_per_round"])
    cases = {
        "accept_all_trajectory": lambda k: [0] * k + [per],
        "reject_at_0_trajectory": lambda k: [per] + [0] * k,
        "half_accept_trajectory":
            lambda k: [0] * (k // 2) + [per] + [0] * (k - k // 2),
    }
    for name, hist_fn in cases.items():
        ctl = speculative.SpecKController(
            int(ad["k_min"]), int(ad["k_start"]), int(ad["k_max"]),
            float(ad["draft_ratio"]))
        got = [ctl.observe(hist_fn(ctl.k), ctl.k) for _ in ad[name]]
        assert got == ad[name], name
    for alpha in (0.0, 0.3, 0.5, 0.9, 1.0):
        for k in (1, 4, 8):
            assert speculative.expected_speedup(alpha, k, 0.35) == \
                jax_spec.expected_speedup(alpha, k, 0.35)
    assert speculative.committed_draft_ratio("transformer") == \
        float(spec_budget["max_draft_flops_ratio"]["transformer"])
    with pytest.raises(ValueError, match="k_min"):
        speculative.SpecKController(3, 2, 5, 0.3)


# -- the decoder's tiers ------------------------------------------------------

def decoder_setup(jax_kw=None, **kw):
    """A port decoder over the JAX serving test's transformer (mapped
    draft from hps.spec_draft), its vocab and a batch of 3 articles with
    a padding row."""
    jhps = jax_serve_hps(**(jax_kw or {}))
    thps = port_hps(jhps, vocab_size=SERVE_VSIZE, **kw)
    vocab = Vocab(words=SERVE_WORDS)
    params = init_numpy_params(thps, vocab.size(), 3)
    dec = BeamSearchDecoder(thps, vocab, batcher=None, params=params,
                            decode_root=tempfile.mkdtemp(prefix="spec_"))
    exs = [SummaryExample.build(f"the cat sat on the mat {i} .", [], vocab,
                                thps, uuid=f"u{i}") for i in range(2)]
    batch = Batch(exs + [exs[0]], thps, vocab)
    batch.real_mask[2] = False
    return thps, dec, batch


def test_decoder_spec_tier_equals_greedy_and_counts_real_rows():
    reg = Registry()
    with obs.use_registry(reg):
        thps, dec, batch = decoder_setup()
        assert dec.has_draft
        greedy = dec.decode_batch(batch, tier="greedy")
        spec = dec.decode_batch(batch, tier="spec")
        draft = dec.decode_batch(batch, tier="draft")
    assert [r.decoded_words for r in spec] == \
        [r.decoded_words for r in greedy]
    assert [r.tier for r in spec + draft] == ["spec"] * 2 + ["draft"] * 2
    out = speculative.run_spec_decode(*dec._spec_snapshot(), thps,
                                      batch.as_arrays())
    cycles = reg.counter("decode/spec_cycles_total").value
    assert cycles == int(out.cycles[:2].sum()) > 0
    assert reg.counter("decode/spec_draft_tokens_total").value == \
        int(out.drafted[:2].sum())
    assert reg.counter("decode/spec_accepted_tokens_total").value == \
        int(out.accepted[:2].sum())
    hist = reg.histogram("decode/spec_accept_len")
    assert hist.count == cycles
    assert hist.buckets == tuple(float(i) for i in range(thps.spec_k + 1))
    assert reg.gauge("decode/spec_k_current").value == float(thps.spec_k)


def test_decoder_adaptive_controller_and_buckets():
    thps, dec, batch = decoder_setup(spec_k_adaptive=True, spec_k=2,
                                     spec_k_min=1, spec_k_max=7)
    assert dec._h_accept.buckets == tuple(float(i) for i in range(8))
    assert dec._spec_ctl is not None and dec._spec_ctl.k == 2
    greedy = dec.decode_batch(batch, tier="greedy")
    spec = dec.decode_batch(batch, tier="spec")
    assert [r.decoded_words for r in spec] == \
        [r.decoded_words for r in greedy]
    assert dec._spec_ctl.cycles > 0
    assert dec._g_spec_k.value == float(dec._spec_ctl.k)


def test_decoder_without_a_draft_refuses_spec_and_draft():
    _, dec, batch = decoder_setup(spec_draft="")
    assert not dec.has_draft
    for tier in ("spec", "draft"):
        with pytest.raises(ValueError, match="draft model"):
            dec.decode_batch(batch, tier=tier)
    with pytest.raises(ValueError, match="tier must be"):
        dec.decode_batch(batch, tier="warp")


def test_draft_params_injected_and_mapped_draft_follows_a_reload(tmp_path):
    """draft_params= serves the spec tier; with spec_draft=map a
    checkpoint reload re-derives the draft from the new params under the
    lock, so the spec tier stays greedy's."""
    jhps = jax_serve_hps()
    thps = port_hps(jhps, vocab_size=SERVE_VSIZE)
    vocab = Vocab(words=SERVE_WORDS)
    train_dir = str(tmp_path / "train")
    ck = ckpt_lib.Checkpointer(train_dir)
    p0 = init_numpy_params(thps, vocab.size(), 0)
    ck.save(trainer.make_train_state(p0, None, 1, "cpu"))
    dec = BeamSearchDecoder(thps, vocab, batcher=None, train_dir=train_dir,
                            decode_root=str(tmp_path / "d"))
    full0, draft0 = dec._spec_snapshot()
    assert draft0["embedding"] is full0["embedding"]
    p1 = init_numpy_params(thps, vocab.size(), 1)
    ck.save(trainer.make_train_state(p1, None, 2, "cpu"))
    dec.maybe_reload_checkpoint(-1e9)
    full1, draft1 = dec._spec_snapshot()
    assert draft1["embedding"] is full1["embedding"] is not full0["embedding"]
    ex = SummaryExample.build("the dog ran home .", [], vocab, thps, uuid="u")
    batch = Batch([ex] * thps.batch_size, thps, vocab)
    assert [r.decoded_words for r in dec.decode_batch(batch, tier="spec")] \
        == [r.decoded_words for r in dec.decode_batch(batch, tier="greedy")]
    injected = BeamSearchDecoder(
        thps.replace(spec_draft=""), vocab, batcher=None, params=p1,
        decode_root=str(tmp_path / "i"), draft_params=numpy_tree(draft1))
    assert injected.has_draft
    assert [r.decoded_words for r in injected.decode_batch(batch,
                                                           tier="spec")] \
        == [r.decoded_words for r in dec.decode_batch(batch, tier="greedy")]


# -- the serve layer -----------------------------------------------------------

def make_server(reg, **kw):
    """A micro-batch server; its decoder's metrics go to the default
    registry, so a caller that reads them builds it under
    obs.use_registry."""
    jhps = jax_serve_hps()
    thps = port_hps(jhps, vocab_size=SERVE_VSIZE, **kw)
    vocab = Vocab(words=SERVE_WORDS)
    params = init_numpy_params(thps, vocab.size(), 0)
    return ServingServer(thps, vocab, params=params, registry=reg,
                         decode_root=tempfile.mkdtemp(prefix="spec_srv_"))


def test_server_spec_and_draft_tiers():
    reg = Registry()
    with obs.use_registry(reg):
        server = make_server(reg)
    with obs.use_registry(reg), server:
        greedy = [server.submit(f"the cat sat {i} .", uuid=f"g{i}",
                                tier="greedy").result(timeout=120)
                  for i in range(3)]
        spec = [server.submit(f"the cat sat {i} .", uuid=f"s{i}",
                              tier="spec").result(timeout=120)
                for i in range(3)]
        draft = server.submit("the dog ran .", uuid="d",
                              tier="draft").result(timeout=120)
        with pytest.raises(ValueError, match="one of"):
            server.submit("the cat .", tier="warp")
    assert [g.decoded_words for g in greedy] == \
        [s.decoded_words for s in spec]
    assert draft.tier == "draft"
    assert reg.counter("serve/tier_spec_total").value == 3
    assert reg.counter("serve/tier_greedy_total").value == 3
    assert reg.counter("serve/tier_draft_total").value == 1
    assert reg.counter("decode/spec_cycles_total").value > 0


def test_server_tier_checks_at_submit():
    reg = Registry()
    server = make_server(reg, spec_draft="")
    with server:
        for tier in ("spec", "draft"):
            with pytest.raises(ValueError, match="draft model"):
                server.submit("the cat .", tier=tier)
    cont = make_server(Registry(), serve_mode="continuous")
    with pytest.raises(ValueError, match="beam tier only"):
        cont.submit("the cat .", tier="spec")


@pytest.mark.parametrize("has_draft", [True, False], ids=["draft", "none"])
def test_degrade_ladder_spec_to_draft(has_draft):
    """A spec request whose budget cannot cover the beam estimate falls to
    draft (counted as a degraded spec request); a draftless job's beam
    request keeps the legacy ladder to greedy."""
    reg = Registry()
    server = make_server(reg, spec_draft="map" if has_draft else "",
                         decode_deadline_secs=5.0)
    server._decoder._beam_secs = 10.0  # a known full-beam estimate
    tier = "spec" if has_draft else "beam"
    with server:
        res = server.submit("the cat sat .", uuid="x",
                            tier=tier).result(timeout=120)
    want = "draft" if has_draft else "greedy"
    assert res.tier == want and res.degraded
    assert reg.counter(f"serve/tier_{want}_total").value == 1
    assert reg.counter(f"serve/tier_degraded_{tier}_total").value == 1
