"""The port's average-attention (AAN) family against the JAX package's
models/avg_attention.py, on the CPU.

The params come from the JAX package's initialisers (jax.random) and are
carried across as numpy; the same numpy batches go to both packages, at
the widths of tests/test_speculative.py (AAN_HPS: hidden 8, 2 heads,
2 + 2 layers) and of tests/test_torch_slots.py for the slot engine.
Both the equal-width family and the NARROW variant (draft_hidden 4, a
factored vocab head of rank 4) are held.

Tolerances: losses within rtol 1e-5; gradients within rtol 1e-4 /
atol 1e-5 (f32 on both sides, gradients up to ~2 in size; a backward
sums in a different order);
tokens and lengths exactly equal; attention within 1e-5.  Inside the
port, forward_train's cumsum and the decode step's running sum agree to
rtol 1e-4 / atol 1e-5, the JAX package's own bound for the same check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import WORDS, abstract, article, make_hps
from test_torch_slots import (
    LENS,
    PLACEMENT,
    assert_same_hypothesis,
    batch_arrays,
    jax_slots,
    port_slots,
)
from tests.test_speculative import AAN_HPS, TF_HPS, make_arrays
from textsummarization_on_flink_tpu.config import (
    derive_draft_hps as jax_derive_draft_hps,
)
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu.models import avg_attention as jax_aan
from textsummarization_on_flink_tpu.models import transformer as jax_tfm
from textsummarization_on_flink_tpu_torch import cli
from textsummarization_on_flink_tpu_torch import config
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import chunks
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.models import avg_attention as aan
from textsummarization_on_flink_tpu_torch.models import get_family
from textsummarization_on_flink_tpu_torch.models import transformer as tfm
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
    tree_leaves,
)

NARROW = dict(draft_hidden=4, draft_vocab_rank=4)
VARIANTS = [pytest.param({}, id="equal"), pytest.param(NARROW, id="narrow")]


def port_hps(jhps, **kw):
    import dataclasses

    fields = {f.name: getattr(jhps, f.name)
              for f in dataclasses.fields(config.HParams)
              if f.name != "device"}
    fields.update(kw)
    return config.HParams(device="cpu", **fields)


def jax_params(jhps, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(
        jax_aan.init_params(jhps, jhps.vocab_size, jax.random.PRNGKey(seed))))


def train_arrays(jhps, B=3, seed=0):
    arrays = make_arrays(jhps, B, seed=seed)
    rng = np.random.RandomState(seed)
    T = jhps.max_dec_steps
    dec = rng.randint(1, jhps.vocab_size, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[0, T - 3:] = 0.0  # a shorter target
    arrays.update(dec_batch=dec, target_batch=np.roll(dec, -1, axis=1),
                  dec_padding_mask=mask)
    return arrays


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("loss_chunk", [0, 3], ids=["materialised",
                                                    "streaming"])
def test_forward_train_loss_and_grads_match_jax(variant, loss_chunk):
    """The teacher-forced loss and every gradient, the materialised loss
    and the streaming one (which projects through vocab_proj_weight: w1
    @ w2 for the narrow draft's factored head)."""
    jhps = AAN_HPS.replace(mode="train", coverage=True, loss_chunk=loss_chunk,
                           **variant)
    thps = port_hps(jhps)
    p = jax_params(jhps)
    arrays = train_arrays(jhps)
    jp = jax.tree_util.tree_map(jnp.asarray, p)

    def jloss(params):
        return jax_aan.forward_train(params, jhps, arrays).total_loss

    want_loss, want_grads = jax.value_and_grad(jloss)(jp)
    tp = from_numpy_tree(p)
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    out = aan.forward_train(tp, thps, beam_search._to_device(arrays, "cpu"))
    np.testing.assert_allclose(float(out.total_loss), float(want_loss),
                               rtol=1e-5)
    grads = torch.autograd.grad(out.total_loss, leaves)
    jleaves = jax.tree_util.tree_leaves(want_grads)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    if variant:
        assert "vocab_head" in tp and "emb_proj" in tp


@pytest.mark.parametrize("variant", VARIANTS)
def test_beam_decode_tokens_match_jax(variant):
    jhps = AAN_HPS.replace(**variant)
    thps = port_hps(jhps)
    p = jax_params(jhps, seed=1)
    for seed in (0, 1):
        arrays = make_arrays(jhps, 3, seed=seed)
        want = jax_bs.run_beam_search(p, jhps, arrays)
        got = beam_search.run_beam_search(from_numpy_tree(p), thps, arrays)
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
        np.testing.assert_array_equal(got.length, np.asarray(want.length))
        np.testing.assert_allclose(got.attn_dists, np.asarray(want.attn_dists),
                                   atol=1e-5)
        np.testing.assert_allclose(got.avg_log_prob,
                                   np.asarray(want.avg_log_prob), rtol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_and_decode_agree(variant):
    """forward_train's cumsum and the O(1) step's running sum on the same
    forced tokens: attention and p_gen per step (the JAX package's own
    check, test_speculative.py TestAvgAttentionFamily)."""
    thps = port_hps(AAN_HPS.replace(**variant), batch_size=2, mode="train")
    p = from_numpy_tree(jax_params(AAN_HPS.replace(**variant)))
    arrays = beam_search._to_device(train_arrays(AAN_HPS, B=2), "cpu")
    out = aan.forward_train(p, thps, arrays)
    enc = aan.beam_encode(p, thps, arrays)
    init_fn, step_fn = aan.beam_adapter(thps.replace(beam_size=1))
    state = init_fn(p, enc)
    with torch.no_grad():
        for t in range(thps.max_dec_steps):
            step = step_fn(p, enc, arrays["enc_padding_mask"],
                           arrays["enc_batch_extend_vocab"],
                           torch.full((2,), t), arrays["dec_batch"][:, t:t + 1],
                           state)
            assert step.state["aan_sum"] is not state["aan_sum"]
            state = step.state
            np.testing.assert_allclose(step.attn_dist[:, 0].numpy(),
                                       out.attn_dists[:, t].detach().numpy(),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(step.p_gen[:, 0].numpy(),
                                       out.p_gens[:, t].detach().numpy(),
                                       rtol=1e-4, atol=1e-5)


def slot_case():
    kw = dict(batch_size=len(LENS), decode_enc_block=4,
              serve_buckets="4,8,12,24", model_family="avg_attention",
              hidden_dim=32, num_heads=4, enc_layers=2, dec_layers=2)
    jhps, thps = make_hps(**kw)
    p = init_numpy_params(thps, len(WORDS) + 4, 11)
    p["embedding"] *= 30.0
    p["out_bias"][3] = 3.0  # STOP_ID: some beams end early
    return jhps, thps, p


def test_slot_engine_runs_the_aan_family():
    """The slot engine with the AAN family: each slot's hypothesis is the
    port's batch search's and the JAX slot search's."""
    jhps, thps, p = slot_case()
    arrays = batch_arrays(thps, LENS)
    params = from_numpy_tree(p)
    ref = beam_search.run_beam_search(params, thps, arrays)
    done, _ = port_slots(thps, params, arrays, PLACEMENT, slots=5)
    want = jax_slots(jhps, p, arrays, {0: 1, 1: 3, 2: 2, 3: 0})
    for s, a in PLACEMENT.items():
        assert_same_hypothesis(done[s], ref.tokens[a], ref.length[a],
                               ref.avg_log_prob[a], ref.attn_dists[a])
    by_article = {a: want[s] for s, a in {0: 1, 1: 3, 2: 2, 3: 0}.items()}
    for s, a in PLACEMENT.items():
        assert_same_hypothesis(done[s], by_article[a].tokens,
                               by_article[a].length)


@pytest.mark.parametrize("variant", VARIANTS)
def test_numpy_init_has_the_jax_names_and_shapes(variant):
    jhps = AAN_HPS.replace(**variant)
    got = ckpt_lib._flatten(aan.init_params(port_hps(jhps), 24, 0))
    want = ckpt_lib._flatten(jax_params(jhps))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def _jax_full(hps):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(
        jax_tfm.init_params(hps, hps.vocab_size, jax.random.PRNGKey(0))))


def test_mapped_draft_copies_the_shared_leaves():
    """init_from_transformer keeps the evenly strided layers' mapped
    leaves, the embeddings, encoder, head and pgen; aan_ffn and aan_gate
    are fresh, and the tree's shapes are the JAX mapping's."""
    jhps = TF_HPS.replace(dec_layers=4, draft_dec_layers=2)
    full = _jax_full(jhps)
    thps = port_hps(jhps)
    draft = aan.init_from_transformer(full, thps, config.derive_draft_hps(
        thps), seed=1)
    want = jax_aan.init_from_transformer(
        full, jhps, jax_derive_draft_hps(jhps), jax.random.PRNGKey(1))
    assert aan.draft_layer_indices(4, 2) == [0, 3]
    assert aan.draft_layer_indices(4, 1) == [3]
    assert aan.draft_layer_indices(6, 3) == [0, 2, 5] == \
        jax_aan.draft_layer_indices(6, 3)
    got_flat, want_flat = ckpt_lib._flatten(draft), ckpt_lib._flatten(want)
    assert {k: v.shape for k, v in got_flat.items()} == \
        {k: v.shape for k, v in want_flat.items()}
    for k, v in got_flat.items():
        if "aan_" in k:
            continue
        np.testing.assert_array_equal(v, want_flat[k], err_msg=k)
    for dst, src in zip(draft["decoder"]["layers"], (0, 3)):
        assert dst["cross_attn"] is full["decoder"]["layers"][src]["cross_attn"]


def test_narrow_mapped_draft_shares_the_encoder_only():
    jhps = TF_HPS.replace(**NARROW)
    full = _jax_full(jhps)
    thps = port_hps(jhps)
    thps.validate()
    draft = aan.make_draft_params(thps.replace(spec_draft="map"),
                                  from_numpy_tree(full))
    assert draft["encoder"]["layers"][0]["ffn"]["w1"].shape == (8, 32)
    np.testing.assert_array_equal(draft["embedding"].numpy(),
                                  full["embedding"])
    assert tuple(draft["emb_proj"]["kernel"].shape) == (8, 4)
    assert tuple(draft["vocab_head"]["w2"].shape) == (4, jhps.vocab_size)
    layer = draft["decoder"]["layers"][0]
    assert tuple(layer["cross_attn"]["wk"].shape) == (8, 4)
    assert tuple(layer["cross_attn"]["wq"].shape) == (4, 4)
    fresh = aan.make_draft_params(thps.replace(spec_draft="fresh"),
                                  from_numpy_tree(full))
    assert tuple(fresh["vocab_head"]["w1"].shape) == (4, 4)
    with pytest.raises(ValueError, match="spec_draft"):
        aan.make_draft_params(thps, full)
    with pytest.raises(ValueError, match="transformer checkpoints"):
        aan.init_from_transformer(full, thps.replace(
            model_family="pointer_generator"), thps, seed=0)
    with pytest.raises(ValueError, match="factored vocab head"):
        thps.replace(draft_vocab_rank=0).validate()


def test_factored_vocab_scores_match_jax():
    jhps = AAN_HPS.replace(**NARROW)
    p = jax_params(jhps)
    h = np.random.RandomState(0).randn(3, 5, 4).astype(np.float32)
    want = jax_tfm.vocab_scores_of(jax.tree_util.tree_map(jnp.asarray, p),
                                   jhps, jnp.asarray(h))
    got = tfm.vocab_scores_of(from_numpy_tree(p), port_hps(jhps),
                              torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        tfm.vocab_proj_weight(from_numpy_tree(p)).numpy(),
        np.asarray(jax_tfm.vocab_proj_weight(p)), rtol=1e-6)


def test_cli_trains_evaluates_and_decodes_the_family(tmp_path):
    """model_family=avg_attention through cli.main on the CPU: a train
    run that resumes, an eval pass and a single-pass decode."""
    assert get_family("avg_attention") is aan
    chunks.write_chunk_file(
        str(tmp_path / "train_000.bin"),
        [{"article": [article(i)], "abstract": [abstract(i)]}
         for i in range(4)])
    (tmp_path / "vocab").write_text("".join(f"{w} {100 - i}\n"
                                            for i, w in enumerate(WORDS)))
    flags = ["--device=cpu", f"--log_root={tmp_path}",
             f"--data_path={tmp_path / 'train_*.bin'}",
             f"--vocab_path={tmp_path / 'vocab'}",
             "--model_family=avg_attention", "--hidden_dim=16",
             "--num_heads=2", "--enc_layers=1", "--dec_layers=2",
             "--batch_size=2", "--max_enc_steps=16", "--max_dec_steps=6",
             "--min_dec_steps=2", "--beam_size=2",
             f"--vocab_size={len(WORDS) + 4}", "--max_oov_buckets=6"]
    train_dir = tmp_path / "exp" / "train"
    assert cli.main(["--mode=train", "--num_steps=2", *flags]) == 0
    assert cli.main(["--mode=train", "--num_steps=3", *flags]) == 0
    assert (train_dir / "model.ckpt-3.npz").exists()
    flat = ckpt_lib.load_arrays(str(train_dir / "model.ckpt-3.npz"))
    assert "params/decoder/layers/1/aan_gate/kernel" in flat
    hps = config.HParams.from_argv(["--mode=eval", *flags])
    assert np.isfinite(cli.run_eval(hps, cli.Vocab(hps.vocab_path,
                                                   hps.vocab_size),
                                    max_iters=1))
    out = cli.main(["--mode=decode", "--single_pass=1", *flags])
    assert out == 0
    decoded = list((tmp_path / "exp").glob("decode_*/decoded/*.txt"))
    assert len(decoded) == 4
