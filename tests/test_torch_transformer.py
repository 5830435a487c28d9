"""The port's transformer family (decode half) against the JAX package's.

Same numpy params and batches in both packages, 2 + 2 layers at hidden
32 (4 heads of 8): the encoder's cross K/V and one beam step within
1e-5 (f32 on both sides, only the order of sums differs) with equal
top-k ids; beam tokens EXACTLY equal; a JAX-written transformer
checkpoint serves in the port with an equal fingerprint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import WORDS, abstract, article, make_hps, n, t
from textsummarization_on_flink_tpu.checkpoint import checkpointer as jax_ckpt
from textsummarization_on_flink_tpu.data import batching as jax_batching
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu.decode import decoder as jax_dec
from textsummarization_on_flink_tpu.models import transformer as jtfm
from textsummarization_on_flink_tpu.train import trainer as jax_trainer
from textsummarization_on_flink_tpu_torch import cli
from textsummarization_on_flink_tpu_torch import config as torch_config
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode import decoder as dec_lib
from textsummarization_on_flink_tpu_torch.models import get_family
from textsummarization_on_flink_tpu_torch.models import transformer as tfm
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
)

TOL = dict(rtol=1e-5, atol=1e-5)
TF = dict(model_family="transformer", hidden_dim=32, num_heads=4,
          enc_layers=2, dec_layers=2, batch_size=3)
VSIZE = len(WORDS) + 4


def tf_hps(**kw):
    return make_hps(**dict(TF, **kw))


def tf_params(thps, seed=11, emb_scale=30.0, stop_bias=3.0):
    """One numpy tree for both packages, shaped for beam parity: a wide
    embedding (tied, so also the vocab projection) makes the random
    model's distributions peaked, and a STOP bias makes some beams finish
    before the horizon while others run to it."""
    p = init_numpy_params(thps, VSIZE, seed)
    p["embedding"] *= emb_scale
    p["out_bias"][3] = stop_bias  # STOP_ID
    return p


def _batches(jhps, thps, n_articles, offset=0):
    jv, tv = JaxVocab(words=WORDS), Vocab(words=WORDS)
    jex = [jax_batching.SummaryExample.build(
        article(i + offset), [abstract(i)], jv, jhps) for i in range(n_articles)]
    tex = [batching.SummaryExample.build(
        article(i + offset), [abstract(i)], tv, thps) for i in range(n_articles)]
    return (jax_batching.Batch(jex, jhps, jv), batching.Batch(tex, thps, tv),
            jv, tv)


def _flat_shapes(tree):
    return {k: v.shape for k, v in ckpt_lib._flatten(tree).items()}


def test_init_params_names_shapes_match_jax():
    """The numpy initialiser has the JAX tree's names and shapes, and the
    JAX tree carries across with from_numpy_tree(jax.device_get(tree)),
    layers as lists."""
    jhps, thps = tf_hps(ffn_dim=48)
    jtree = jax.device_get(jtfm.init_params(jhps, VSIZE, jax.random.PRNGKey(0)))
    carried = from_numpy_tree(jtree)
    assert isinstance(carried["encoder"]["layers"], list)
    assert isinstance(carried["decoder"]["layers"], list)
    assert carried["decoder"]["layers"][1]["ffn"]["w1"].shape == (32, 48)
    got = init_numpy_params(thps, VSIZE, 0)
    assert _flat_shapes(got) == _flat_shapes(jtree) == _flat_shapes(carried)
    for a, b in zip(ckpt_lib._flatten(carried).values(),
                    ckpt_lib._flatten(jtree).values()):
        np.testing.assert_array_equal(a, b)


def test_beam_encode_cross_kv_matches_jax():
    jhps, thps = tf_hps()
    jb, tb, _, _ = _batches(jhps, thps, 3)
    p = tf_params(thps)
    ja = {k: jnp.asarray(v) for k, v in jb.as_arrays().items()}
    want = jtfm.beam_encode(p, jhps, ja)
    arrays = beam_search._to_device(tb.as_arrays(), "cpu")
    got = tfm.beam_encode(from_numpy_tree(p), thps, arrays)
    assert got.cross_k.shape == (3, 2, thps.max_enc_steps, 4, 8)
    np.testing.assert_allclose(n(got.cross_k), np.asarray(want.cross_k), **TOL)
    np.testing.assert_allclose(n(got.cross_v), np.asarray(want.cross_v), **TOL)


def test_beam_adapter_step_matches_jax():
    """One step of B articles, each at its own step t (the JAX step is
    vmapped with a scalar t per article), from a random KV cache: top-k
    ids equal; log-probs, attention, p_gen and the written caches within
    1e-5."""
    jhps, thps = tf_hps()
    jb, tb, jv, _ = _batches(jhps, thps, 3)
    p = tf_params(thps)
    K, L, T = thps.beam_size, thps.dec_layers, thps.max_dec_steps + 1
    rng = np.random.RandomState(0)
    cache = {c: rng.randn(3, K, L, T, 4, 8).astype(np.float32)
             for c in ("cache_k", "cache_v")}
    steps = np.array([0, 4, thps.max_dec_steps])  # the last: a masked step
    latest = rng.randint(0, thps.vocab_size, (3, K))
    ja = {k: jnp.asarray(v) for k, v in jb.as_arrays().items()}
    jenc = jtfm.beam_encode(p, jhps, ja)
    _, jstep = jtfm.beam_adapter(jhps)
    want = jax.vmap(jstep, in_axes=(None, 0, 0, 0, 0, 0, 0))(
        jax.tree_util.tree_map(jnp.asarray, p), jenc,
        ja["enc_padding_mask"], ja["enc_batch_extend_vocab"],
        jnp.asarray(steps), jnp.asarray(latest),
        {c: jnp.asarray(v) for c, v in cache.items()})
    arrays = beam_search._to_device(tb.as_arrays(), "cpu")
    tp = from_numpy_tree(p)
    enc = tfm.beam_encode(tp, thps, arrays)
    _, step = tfm.beam_adapter(thps)
    got = step(tp, enc, arrays["enc_padding_mask"],
               arrays["enc_batch_extend_vocab"], t(steps).long(),
               t(latest).long(), {c: t(v.copy()) for c, v in cache.items()})
    np.testing.assert_array_equal(n(got.topk_ids), np.asarray(want.topk_ids))
    for f in ("topk_log_probs", "attn_dist", "p_gen"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(want, f)), **TOL)
    for c in cache:
        np.testing.assert_allclose(n(got.state[c]), np.asarray(want.state[c]),
                                   **TOL)
    assert (n(got.topk_ids) >= thps.vocab_size).any()  # the copy path


@pytest.mark.parametrize("pointer_gen,beam_size", [(True, 3), (True, 1),
                                                   (False, 3)])
def test_beam_search_tokens_equal_jax(pointer_gen, beam_size):
    jhps, thps = tf_hps(pointer_gen=pointer_gen, beam_size=beam_size)
    jb, tb, _, _ = _batches(jhps, thps, 3)
    p = tf_params(thps)
    want = jax_bs.run_beam_search(p, jhps, jb.as_arrays())
    got = beam_search.run_beam_search(from_numpy_tree(p), thps,
                                      tb.as_arrays())
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.length, want.length)
    np.testing.assert_allclose(got.avg_log_prob, want.avg_log_prob, **TOL)
    np.testing.assert_allclose(got.attn_dists, want.attn_dists, **TOL)
    np.testing.assert_allclose(got.p_gens, want.p_gens, **TOL)


def test_parity_batches_exercise_stop_and_copy():
    """The token test above is only as strong as its batch: with these
    params a beam copies an article OOV (an id >= the vocab size, mapped
    to UNK at the next step), and some articles finish on STOP before the
    horizon while others run to it."""
    _, thps = tf_hps()
    _, tb, _, tv = _batches(thps, thps, 3)
    out = beam_search.run_beam_search(from_numpy_tree(tf_params(thps)), thps,
                                      tb.as_arrays())
    assert (out.tokens >= tv.size()).any()
    T1 = thps.max_dec_steps + 1
    assert (out.length < T1).any() and (out.length == T1).any()


def test_jax_transformer_checkpoint_serves_in_port(tmp_path):
    """A checkpoint the JAX package's Checkpointer wrote (list-bearing
    tree) loads in the port with an equal content fingerprint and decodes
    the JAX decoder's words."""
    jhps, thps = tf_hps()
    p = tf_params(thps, seed=21)
    state = jax_trainer.init_train_state(jhps, VSIZE, params=p)
    train_dir = str(tmp_path / "train")
    jax_ckpt.Checkpointer(train_dir, hps=jhps).save(state)
    jb, tb, jv, tv = _batches(jhps, thps, 3, offset=2)
    jd = jax_dec.BeamSearchDecoder(jhps, jv, None, train_dir=train_dir,
                                   decode_root=str(tmp_path / "j"),
                                   max_ckpt_retries=0)
    td = dec_lib.BeamSearchDecoder(thps, tv, None, train_dir=train_dir,
                                   decode_root=str(tmp_path / "t"),
                                   max_ckpt_retries=0)
    assert isinstance(td._params["decoder"]["layers"], list)
    assert td.params_fingerprint == jd.params_fingerprint
    want = jd.decode_batch(jb)
    got = td.decode_batch(tb)
    assert [r.decoded_words for r in got] == [r.decoded_words for r in want]
    assert any(r.decoded_words for r in got)


def test_cli_decodes_with_the_transformer_on_cpu(tmp_path):
    """--model_family=transformer reaches the adapter through cli.main."""
    _, thps = tf_hps()
    train_dir = tmp_path / "exp" / "train"
    path = str(train_dir / "model.ckpt-3.npz")
    ckpt_lib.save_arrays(path, ckpt_lib._flatten(
        {"params": tf_params(thps)}, ""))
    ckpt_lib.write_index(str(train_dir), path)
    vocab_path = tmp_path / "vocab"
    vocab_path.write_text("".join(f"{w} {100 - i}\n"
                                  for i, w in enumerate(WORDS)))
    (tmp_path / "articles").mkdir()
    for i in range(4):
        (tmp_path / "articles" / f"a{i}.txt").write_text(article(i))
    flags = dict(mode="decode", inference=1, single_pass=1, device="cpu",
                 data_path=str(tmp_path / "articles" / "*.txt"),
                 vocab_path=str(vocab_path), log_root=str(tmp_path),
                 exp_name="exp", **{k: getattr(thps, k) for k in (
                     "model_family", "hidden_dim", "num_heads", "enc_layers",
                     "dec_layers", "batch_size", "vocab_size",
                     "max_enc_steps", "max_dec_steps", "beam_size",
                     "min_dec_steps", "max_oov_buckets")})
    assert cli.main([f"--{k}={v}" for k, v in flags.items()]) == 0
    d = tmp_path / "exp" / dec_lib.get_decode_dir_name(thps, path)
    assert len(list((d / "decoded").iterdir())) == 4


def test_unported_transformer_options_raise_with_their_roadmap_item():
    hps = torch_config.HParams(model_family="transformer")
    hps.validate()
    assert get_family("transformer") is tfm
    # the bf16 KV cache is taken; another storage dtype is refused
    hps.replace(decode_cache_dtype="bfloat16").validate()
    with pytest.raises(ValueError, match="bad decode_cache_dtype"):
        hps.replace(decode_cache_dtype="float16").validate()
    with pytest.raises(ValueError, match="num_heads"):
        hps.replace(num_heads=7).validate()
    # queue 1 item 5 landed: the AAN family validates, and a factored
    # vocab_head scores through (h @ w1) @ w2 + out_bias
    hps.replace(model_family="avg_attention").validate()
    assert get_family("avg_attention").__name__.endswith("avg_attention")
    _, thps = tf_hps()
    p = from_numpy_tree(tf_params(thps))
    H, V = p["pos_dec"].shape[1], p["out_bias"].shape[0]
    g = torch.Generator().manual_seed(0)
    p["vocab_head"] = {"w1": torch.randn(H, 3, generator=g),
                       "w2": torch.randn(3, V, generator=g)}
    got = tfm.vocab_scores_of(p, thps, p["pos_dec"])
    torch.testing.assert_close(
        got, (p["pos_dec"] @ p["vocab_head"]["w1"]) @ p["vocab_head"]["w2"]
        + p["out_bias"])
