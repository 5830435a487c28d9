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

Head counts tp does not divide (num_heads 1 at hidden 8, 3 at hidden
12, tp=2): the JAX package shards H's columns and lets a head straddle
ranks; the port pads the heads with zero ones to a multiple of tp
(sharding.pad_heads), so rank 1 of the one-head model holds only a zero
head.  Its train step is held against JAX's single-device step and
against JAX's own tp=2 sharded step on the virtual CPU mesh, its beam
tokens against JAX's search; the pads stay exactly 0 through 3 Adagrad
steps, a checkpoint has the JAX layout and restores onto the mesh bit
for bit, and the copy distribution's head mean counts the real heads
only.  The dp all-reduce carries the pad heads' zero gradients: the
port prices them in ``analytic_comms`` (``sharding.head_pad_elements``),
and the bytes it moves are JAX's count plus those elements at the wire
size.

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
from textsummarization_on_flink_tpu.parallel import mesh as jmesh
from textsummarization_on_flink_tpu.parallel import sharding as jsharding
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch import config
from textsummarization_on_flink_tpu_torch.parallel import sharding

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
    # head counts tp does not divide: the port pads to whole heads
    "tp2_h1": (2, dict(num_heads=1), dict(tp=2)),
    "tp2_h3": (2, dict(hidden_dim=12, num_heads=3), dict(tp=2)),
    "dp2_tp2_h1": (4, dict(num_heads=1), dict(dp=2, tp=2)),
}
SEARCH = dict(dp=2, tp=2)
#: the padded cases' variants (tp=2), searched and stepped 3 times
PADDED = {"h1": dict(num_heads=1), "h3": dict(hidden_dim=12, num_heads=3)}


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
    for key, variant in PADDED.items():
        p, batch, _, _ = _jax_step(variant)
        by_world[2].append({
            "name": f"steps3_{key}", "kind": "train", "steps": 3,
            "local": True, "checkpoint": True, "params": f"params_tp2_{key}",
            "batch": f"batch_tp2_{key}",
            "hps": _fields(_train_hps(variant), tp=2)})
        jhps = AAN_HPS.replace(batch_size=B, **variant)
        save_params(work, f"params_search_{key}", jax_params(jhps, seed=1))
        save_npz(work, f"batch_search_{key}", make_arrays(jhps, B, seed=2))
        by_world[2].append({"name": f"search_{key}", "kind": "search",
                            "params": f"params_search_{key}",
                            "batch": f"batch_search_{key}",
                            "hps": _fields(jhps, tp=2)})
    save_npz(work, "head_probs", {"probs": _head_probs()})
    by_world[2].append({"name": "head_mean", "kind": "head_mean",
                        "inputs": "head_probs",
                        "hps": _fields(AAN_HPS.replace(hidden_dim=12,
                                                       num_heads=3), tp=2)})
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
    """Both packages refuse the narrow AAN's draft_vocab_rank=3 at tp=2:
    the JAX package's placement (shard_train_state's device_put of the
    rank-sharded vocab_head) raises ValueError, and the port refuses the
    same before a model is built, saying that JAX refuses it too.  A
    head count tp does not divide is no longer refused."""
    from textsummarization_on_flink_tpu_torch.parallel import mesh

    hps = config.HParams(device="cpu", model_family="avg_attention",
                         hidden_dim=8, num_heads=2, draft_hidden=4,
                         draft_vocab_rank=3, tp=2)
    with pytest.raises(ValueError, match="JAX package's placement refuses"):
        mesh.validate_divisibility(hps)
    mesh.validate_divisibility(hps.replace(draft_vocab_rank=4))
    mesh.validate_divisibility(hps.replace(draft_vocab_rank=4, num_heads=1))
    jhps = AAN_HPS.replace(draft_hidden=4, draft_vocab_rank=3, tp=2)
    state = jtrainer.init_train_state(
        jhps, jhps.vocab_size,
        params=jax.tree_util.tree_map(jnp.asarray, jax_params(jhps)))
    with pytest.raises(ValueError, match="divisible"):
        jmesh.shard_train_state(jmesh.make_mesh(jhps), state)


def _head_probs():
    """[B, 4, T] head probabilities for num_heads 3 at tp=2: three real
    heads (random rows that sum to 1) and a pad head uniform over T, as
    a zero head's softmax is."""
    rng = np.random.RandomState(7)
    real = rng.rand(2, 3, 6).astype(np.float32)
    real /= real.sum(-1, keepdims=True)
    pad = np.full((2, 1, 6), 1.0 / 6, np.float32)
    return np.concatenate([real, pad], axis=1)


def test_head_mean_counts_the_real_heads_only(worlds):
    """collectives.head_mean on tp=2 with num_heads=3 (rank 1 holds head
    2 and a pad head): the mean of the three real heads, which differs
    from a mean that lets the uniform pad head in."""
    probs = _head_probs()
    got = load_npz(worlds, "head_mean")["mean"]
    np.testing.assert_allclose(got, probs[:, :3].mean(1), rtol=1e-6)
    # the pad head in the sum adds 1 / (T * num_heads) everywhere
    assert np.abs(probs.sum(1) / 3 - probs[:, :3].mean(1)).min() > 0.05
    assert np.abs(probs.mean(1) - probs[:, :3].mean(1)).max() > 1e-3


@pytest.mark.parametrize("key", list(PADDED))
def test_padded_heads_match_the_jax_tp2_sharded_step(worlds, key):
    """JAX's own tp=2 step (its heads straddling the ranks) on the
    virtual CPU mesh gives the port's padded step's loss and params."""
    variant = PADDED[key]
    p, batch, _, _ = _jax_step(variant)
    jhps = _train_hps(variant).replace(tp=2)
    plan = jmesh.make_mesh(jhps)
    state = jtrainer.init_train_state(
        jhps, jhps.vocab_size, params=jax.tree_util.tree_map(jnp.asarray, p))
    step = jmesh.make_sharded_train_step(plan, donate=False)
    jstate, jm = step(jmesh.shard_train_state(plan, state), batch)
    info = load_json(worlds, f"tp2_{key}")
    np.testing.assert_allclose(info["metrics"][0][0], float(jm.loss),
                               rtol=1e-5)
    got = _leaves(params_of(load_npz(worlds, f"tp2_{key}")))
    for g, w in zip(got, _leaves(jax.device_get(jstate.params))):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("key", list(PADDED))
def test_aan_beam_tokens_equal_jax_with_padded_heads(worlds, key):
    jhps = AAN_HPS.replace(batch_size=B, **PADDED[key])
    arrays = make_arrays(jhps, B, seed=2)
    want = jax_bs.run_beam_search(jax_params(jhps, seed=1), jhps, arrays)
    for r in range(2):
        got = load_npz(worlds, f"search_{key}.rank{r}")
        np.testing.assert_array_equal(got["tokens"], np.asarray(want.tokens))
        np.testing.assert_array_equal(got["length"], np.asarray(want.length))
        np.testing.assert_allclose(got["avg_log_prob"],
                                   np.asarray(want.avg_log_prob),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", list(PADDED))
def test_pad_heads_stay_zero_through_three_steps(worlds, key):
    """After 3 Adagrad steps every pad column of wq/wk/wv and pad row of
    wo on rank 1 is still exactly 0 (its gradients are exactly 0; its
    accumulators start at adagrad_init_acc), and the real heads
    trained."""
    jhps = _train_hps(PADDED[key])
    nh, pad = jhps.num_heads, sharding.head_pad(jhps.replace(tp=2))
    local = load_npz(worlds, f"steps3_{key}.local.rank1")
    n_pad = 0
    for name, x in local.items():
        path = tuple(name.split("/"))
        dim = sharding.head_axis(path)
        if dim is None or not name.startswith("params/"):
            continue
        hd = x.shape[dim] * 2 // (nh + pad)  # two ranks' heads
        held = x.shape[dim] // hd
        real = max(nh - held, 0)  # rank 1's real heads
        tail = np.take(x, range(real * hd, x.shape[dim]), axis=dim)
        assert tail.size and not tail.any(), name
        n_pad += 1
        if real:
            assert np.take(x, range(real * hd), axis=dim).any(), name
    assert n_pad == 4 * (jhps.enc_layers + jhps.dec_layers)
    info = load_json(worlds, f"steps3_{key}")
    assert all(np.isfinite(m[0]) for m in info["metrics"])


@pytest.mark.parametrize("key", list(PADDED))
def test_a_padded_checkpoint_has_the_jax_layout(worlds, key):
    """The tp=2 checkpoint of the padded model (gathered, pads dropped)
    has exactly the shapes of the JAX package's unsharded tree, and
    restore_sharded pads it again onto the mesh, bit for bit."""
    jhps = _train_hps(PADDED[key])
    flat = load_npz(worlds, f"steps3_{key}")
    assert [x.shape for x in _leaves(params_of(flat))] == \
        [x.shape for x in _leaves(jax_params(jhps, seed=3))]
    accs = {k[len("opt_state/accumulators/"):]: v.shape
            for k, v in flat.items() if k.startswith("opt_state/")}
    assert accs == {k[len("params/"):]: v.shape for k, v in flat.items()
                    if k.startswith("params/")}
    assert load_json(worlds, f"steps3_{key}")["restored_equal"] is True


def test_padded_dp_wire_is_priced(worlds):
    """At dp2 x tp2 with one head the dp all-reduce moves the port's
    analytic_comms dp_wire_bytes, which is the JAX package's count plus
    the pad heads' elements in f32 (each rank's zero head of every
    attention block)."""
    jhps = _train_hps(dict(num_heads=1)).replace(dp=2, tp=2)
    hps = config.HParams(device="cpu", **_fields(jhps))
    params = load_npz(worlds, "params_dp2_tp2_h1")
    tree = params_of(params)
    comms = sharding.analytic_comms(hps, params=tree)
    jax_comms = jsharding.analytic_comms(jhps, params=tree)
    per_step = load_json(worlds, "dp2_tp2_h1")["bytes_per_step"]
    assert per_step["all_reduce/dp"] == comms["dp_wire_bytes"]
    H, L = jhps.hidden_dim, jhps.enc_layers + jhps.dec_layers
    pad = sharding.head_pad_elements(hps, tree)
    # half of each padded leaf is the pad: 4 leaves of H*H per layer
    assert pad == 4 * L * H * H // 2
    assert comms["dp_wire_bytes"] - jax_comms["dp_wire_bytes"] == 4 * pad
