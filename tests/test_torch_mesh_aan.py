"""The AAN family on a mesh: the port's sharded train step and beam
search on spawned gloo ranks (CPU) against the JAX package's
single-device step and search, at the widths of tests/test_speculative.py
(AAN_HPS: hidden 8, 2 heads, 2 + 2 layers, vocab 24).

The per-leaf rule (JAX parallel/sharding.py:91-119) shards the tied
embedding and out_bias over the vocabulary, the cross_attn wq/wk/wv/wo
and both FFNs (aan_ffn, ffn) Megatron-style, and the NARROW variant's
factored vocab_head over its rank (w1 column-, w2 row-parallel: its
scores are a sum over tp of rank-partial products).  Cases: dp=2, tp=2,
sp=2 under --sp_attention=ring and ulysses (the encoder's T sharded), the
narrow variant at tp=2 with the materialised and the streaming loss, and
a dp2 x tp2 beam search.

Tolerances (PR 19's): the loss within rtol 1e-5; the gradients, checked
through the updated params of one Adagrad step, within rtol 1e-4 / atol
1e-5; the beam tokens and lengths exactly equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh import load_json, load_npz, params_of, run_ranks, save_npz
from _torch_mesh import save_params
from test_torch_avg_attention import NARROW, jax_params, train_arrays
from tests.test_speculative import AAN_HPS, make_arrays
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch import config

B = 4  # rows of the global batch: two per dp index
TRAIN = dict(mode="train", coverage=True, batch_size=B)
#: name -> (world, variant fields, mesh and option fields)
CASES = {
    "dp2": (2, {}, dict(dp=2)),
    "tp2": (2, {}, dict(tp=2)),
    "sp2_ring": (2, {}, dict(sp=2, sp_attention="ring")),
    "sp2_ulysses": (2, {}, dict(sp=2, sp_attention="ulysses")),
    "narrow_tp2": (2, NARROW, dict(tp=2)),
    "narrow_tp2_streaming": (2, dict(NARROW, loss_chunk=3), dict(tp=2)),
    "dp2_tp2": (4, {}, dict(dp=2, tp=2)),
}
SEARCH = dict(dp=2, tp=2)


def _fields(jhps, **kw):
    out = {f.name: getattr(jhps, f.name)
           for f in dataclasses.fields(config.HParams)
           if f.name != "device"}
    out.update(kw)
    return out


def _train_hps(variant):
    return AAN_HPS.replace(**TRAIN, **variant)


def _jax_step(variant):
    return _jax_step_of(tuple(sorted(variant.items())))


@functools.lru_cache(maxsize=None)
def _jax_step_of(items):
    jhps = _train_hps(dict(items))
    p = jax_params(jhps, seed=3)
    batch = train_arrays(jhps, B=B, seed=5)
    state = jtrainer.init_train_state(
        jhps, jhps.vocab_size, params=jax.tree_util.tree_map(jnp.asarray, p))
    new, m = jax.jit(jtrainer.make_train_step(jhps))(state, batch)
    return p, batch, new, m


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    work = tmp_path_factory.mktemp("aan")
    by_world = {2: [], 4: []}
    for name, (world, variant, mesh) in CASES.items():
        p, batch, _, _ = _jax_step(variant)
        save_params(work, f"params_{name}", p)
        save_npz(work, f"batch_{name}", batch)
        by_world[world].append({
            "name": name, "kind": "train", "params": f"params_{name}",
            "batch": f"batch_{name}",
            "hps": _fields(_train_hps(variant), **mesh)})
    sp = jax_params(AAN_HPS, seed=1)
    save_params(work, "params_search", sp)
    save_npz(work, "batch_search", make_arrays(AAN_HPS.replace(batch_size=B),
                                               B, seed=2))
    by_world[4].append({"name": "search", "kind": "search",
                        "params": "params_search", "batch": "batch_search",
                        "hps": _fields(AAN_HPS.replace(batch_size=B),
                                       **SEARCH)})
    for world, cases in by_world.items():
        run_ranks(work, world, cases)
    return work


def _leaves(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


@pytest.mark.parametrize("name", list(CASES))
def test_aan_train_step_equals_jax(worlds, name):
    _, variant, _ = CASES[name]
    _, _, ref, ref_m = _jax_step(variant)
    info = load_json(worlds, name)
    loss = info["metrics"][0][0]
    np.testing.assert_allclose(loss, float(ref_m.loss), rtol=1e-5)
    np.testing.assert_allclose(info["metrics"][0][3],
                               float(ref_m.global_norm), rtol=1e-4)
    got = _leaves(params_of(load_npz(worlds, name)))
    want = _leaves(ref.params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_aan_beam_tokens_equal_jax_at_dp2_tp2(worlds):
    jhps = AAN_HPS.replace(batch_size=B)
    arrays = make_arrays(jhps, B, seed=2)
    want = jax_bs.run_beam_search(jax_params(AAN_HPS, seed=1), jhps, arrays)
    for r in range(4):
        got = load_npz(worlds, f"search.rank{r}")
        np.testing.assert_array_equal(got["tokens"], np.asarray(want.tokens))
        np.testing.assert_array_equal(got["length"], np.asarray(want.length))
        np.testing.assert_allclose(got["avg_log_prob"],
                                   np.asarray(want.avg_log_prob),
                                   rtol=1e-5, atol=1e-5)


def test_the_aan_tp_refusal_names_its_fault():
    """The port's Megatron layout needs tp to divide the narrow head's
    rank; the JAX package's GSPMD takes an uneven one (ROADMAP.md port
    fault 8), so the port refuses before a model is built."""
    from textsummarization_on_flink_tpu_torch.parallel import mesh

    hps = config.HParams(device="cpu", model_family="avg_attention",
                         hidden_dim=8, num_heads=2, draft_hidden=4,
                         draft_vocab_rank=3, tp=2)
    with pytest.raises(ValueError, match="port fault 8"):
        mesh.validate_divisibility(hps)
    mesh.validate_divisibility(hps.replace(draft_vocab_rank=4))
