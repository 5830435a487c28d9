"""The port's sequence-parallel attention (parallel/ring_attention.py) and
the transformer on meshes, on spawned gloo ranks (CPU), against the JAX
package.

Ring and Ulysses attention, forward and the gradients of q, k and v,
against full masked attention (``jax.vjp`` of the reference formula)
and against the JAX package's own ring and Ulysses ops on its 8-device
virtual mesh; the pad mask has a row whose padding spans whole sp blocks
and a row of padding only (its output and gradients are exact zeros).
Then the transformer's train step at dp2 x sp4 under both modes, at
dp4 x tp2 (Megatron heads and FFN) and at dp2 x tp4 with --loss_chunk,
against the JAX single-device step at the JAX package's tolerances
(loss and global norm rtol 2e-5, params rtol 1e-4 / atol 1e-6), and the
JAX refusals (Ulysses heads, sp_attention with tp).  Attention outputs
and gradients agree within 1e-5 absolute (f32; only the order of the
sums differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_mesh import (
    load_json,
    load_npz,
    params_of,
    run_ranks,
    save_npz,
    save_params,
)
from textsummarization_on_flink_tpu.config import HParams as JHParams
from textsummarization_on_flink_tpu.data.batching import Batch, SummaryExample
from textsummarization_on_flink_tpu.data.vocab import Vocab
from textsummarization_on_flink_tpu.parallel import mesh as jmesh
from textsummarization_on_flink_tpu.parallel import ring_attention as jra
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.params import init_numpy_params
from textsummarization_on_flink_tpu_torch.parallel import mesh

B, T, NH, HD = 4, 16, 4, 8
SCALE = HD ** -0.5
TF = dict(model_family="transformer", hidden_dim=8, num_heads=4,
          enc_layers=2, dec_layers=2, batch_size=8, max_enc_steps=16,
          max_dec_steps=6, beam_size=2, min_dec_steps=2, vocab_size=64,
          max_oov_buckets=8)


def attention_inputs():
    rng = np.random.RandomState(0)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    lens = np.array([T, 5, 9, 0])  # row 1's padding spans blocks 2 and 3
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return dict(q=f32(B, T, NH, HD), k=f32(B, T, NH, HD),
                v=f32(B, T, NH, HD), mask=mask, g=f32(B, T, NH, HD),
                scale=np.float32(SCALE))


def full_attention(q, k, v, mask):
    """Masked softmax attention, all-padding rows giving 0."""
    logits = jnp.einsum("bqnd,bknd->bnqk", q, k) * SCALE
    logits = jnp.where(mask[:, None, None, :] > 0, logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1) * (mask[:, None, None, :] > 0)
    return jnp.einsum("bnqk,bknd->bqnd", probs, v)


@pytest.fixture(scope="module")
def attn_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp4")
    save_npz(work, "x", attention_inputs())
    cases = [{"name": f"{mode}_dp{dp}_sp{sp}", "kind": "attention",
              "mode": mode, "inputs": "x",
              "hps": dict(TF, dp=dp, sp=sp, batch_size=B)}
             for mode in ("ring", "ulysses") for dp, sp in ((1, 4), (2, 2))]
    run_ranks(work, 4, cases)
    return work


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("dp,sp", [(1, 4), (2, 2)])
def test_sp_attention_matches_full_attention(attn_ranks, mode, dp, sp):
    x = attention_inputs()
    got = load_npz(attn_ranks, f"{mode}_dp{dp}_sp{sp}")
    args = [jnp.asarray(x[n]) for n in ("q", "k", "v")]
    out, vjp = jax.vjp(lambda q, k, v: full_attention(
        q, k, v, jnp.asarray(x["mask"])), *args)
    grads = vjp(jnp.asarray(x["g"]))
    np.testing.assert_allclose(got["out"], out, atol=1e-5)
    for name, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], want, atol=1e-5)
    # the all-padding article: exact zeros, forward and backward
    for name in ("out", "dq", "dk", "dv"):
        assert not got[name][3].any()


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sp_attention_matches_the_jax_op_on_its_mesh(attn_ranks, mode):
    x = attention_inputs()
    devices = np.asarray(jax.devices()[:4]).reshape(1, 4)
    fn = jra.make_sp_attention(Mesh(devices, ("dp", "sp")), mode)

    @jax.jit
    def fwd_bwd(q, k, v, mask, g):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mask, SCALE), q, k, v)
        return out, vjp(g)

    out, grads = fwd_bwd(*(jnp.asarray(x[n])
                           for n in ("q", "k", "v", "mask", "g")))
    got = load_npz(attn_ranks, f"{mode}_dp1_sp4")
    np.testing.assert_allclose(got["out"], out, atol=1e-5)
    for name, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], want, atol=1e-5)


def make_batch(jhps, vocab, seed=0):
    rng = np.random.RandomState(seed)
    exs = []
    for _ in range(jhps.batch_size):
        n_art = rng.randint(3, jhps.max_enc_steps)
        art = " ".join(rng.choice([f"w{j}" for j in range(50)] + ["zzz"],
                                  n_art))
        abs_ = " ".join(rng.choice([f"w{j}" for j in range(50)],
                                   rng.randint(2, jhps.max_dec_steps)))
        exs.append(SummaryExample.build(art, [abs_], vocab, jhps))
    return Batch(exs, jhps, vocab).as_arrays()


@pytest.fixture(scope="module")
def tf_setup():
    jhps = JHParams(**TF)
    vocab = Vocab(words=[f"w{i}" for i in range(60)], max_size=64)
    batch = make_batch(jhps, vocab)
    params = init_numpy_params(HParams(**TF), 64, 5)
    state = jtrainer.init_train_state(
        jhps, 64, params=jax.tree_util.tree_map(jnp.asarray, params))
    ref_state, ref_m = jax.jit(jtrainer.make_train_step(jhps))(state, batch)
    return params, batch, ref_state, ref_m


TF_MESHES = {
    "ring_dp2_sp4": dict(dp=2, sp=4, sp_attention="ring"),
    "ulysses_dp2_sp4": dict(dp=2, sp=4, sp_attention="ulysses"),
    "tp_dp4_tp2": dict(dp=4, tp=2),
    "tp_chunk_dp2_tp4": dict(dp=2, tp=4, loss_chunk=3),
}


@pytest.fixture(scope="module")
def tf_ranks(tf_setup, tmp_path_factory):
    params, batch, *_ = tf_setup
    work = tmp_path_factory.mktemp("tf8")
    save_params(work, "params", params)
    save_npz(work, "batch", batch)
    cases = [{"name": name, "kind": "train", "params": "params",
              "batch": "batch", "hps": dict(TF, **kw)}
             for name, kw in TF_MESHES.items()]
    run_ranks(work, 8, cases)
    return work


@pytest.mark.parametrize("name", sorted(TF_MESHES))
def test_transformer_step_on_a_mesh_matches_single_device(tf_setup, tf_ranks,
                                                          name):
    *_, ref_state, ref_m = tf_setup
    info = load_json(tf_ranks, name)
    loss, _, _, gnorm = info["metrics"][0]
    np.testing.assert_allclose(loss, float(ref_m.loss), rtol=2e-5)
    np.testing.assert_allclose(gnorm, float(ref_m.global_norm), rtol=2e-5)
    got = jax.tree_util.tree_leaves(params_of(load_npz(tf_ranks, name)))
    for g, r in zip(got, jax.tree_util.tree_leaves(ref_state.params)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-6)
    if name.startswith("tp"):
        assert info["local_vocab"] == 64 // TF_MESHES[name]["tp"]
        assert info["bytes_per_step"]["all_reduce/tp"] > 0
    else:
        # the encoder's blocks went round the ring or through all-to-alls
        op = "send_recv/sp" if name.startswith("ring") else "all_to_all/sp"
        assert info["bytes_per_step"][op] > 0
        assert info["bytes_per_step"]["reduce_scatter/sp"] > 0


def test_jax_refusals_hold():
    params = {"embedding": np.zeros((64, 8), np.float32)}
    with pytest.raises(ValueError, match="ulysses re-shards heads"):
        mesh.validate_divisibility(HParams(**dict(
            TF, sp=8, sp_attention="ulysses")), params)
    with pytest.raises(ValueError, match="sp_attention with tp>1"):
        mesh.validate_divisibility(HParams(**dict(
            TF, tp=2, sp=2, sp_attention="ring")), params)
    with pytest.raises(ValueError, match="ulysses re-shards heads"):
        jmesh.validate_divisibility(JHParams(**dict(
            TF, sp=8, sp_attention="ulysses")), params)
