"""The port's sharded train and eval steps on spawned gloo ranks (CPU)
against the JAX package's single-device step and its sharded step on the
8-device virtual mesh, at the tiny widths of tests/test_parallel.py.

One numpy params tree and one global batch (the JAX package's Batch of
test_parallel.py's ``make_batch``) go to both packages.  The ranks
(tests/_torch_mesh_worker.py) import only the port; the cases of one
world size share one spawn.

Tolerances are the JAX package's own (tests/test_parallel.py): one f32
step's loss and global norm within rtol 2e-5 and the params within rtol
1e-4 / atol 1e-6; the bf16 wire's single step within its envelope (loss
rtol 1e-5, global norm rtol 1e-2, each leaf's update within 5% of the
f32 update's L2 norm + 1e-4) and 20 steps within loss rtol 1e-3 and a
worst-leaf relative L2 of 2e-2.  The dp all-reduce moves exactly
``analytic_comms``'s ``dp_wire_bytes`` per step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.params import init_numpy_params
from textsummarization_on_flink_tpu_torch.parallel import sharding

TINY = dict(hidden_dim=8, emb_dim=6, batch_size=8, max_enc_steps=16,
            max_dec_steps=6, beam_size=2, min_dec_steps=2, vocab_size=64,
            max_oov_buckets=8, num_steps=2)


def make_batch(jhps, vocab, seed=0):
    """tests/test_parallel.py's batch."""
    rng = np.random.RandomState(seed)
    exs = []
    for _ in range(jhps.batch_size):
        n_art = rng.randint(5, jhps.max_enc_steps)
        n_abs = rng.randint(2, jhps.max_dec_steps)
        art = " ".join(rng.choice([f"w{j}" for j in range(50)] + ["zzz_oov"],
                                  n_art))
        abs_ = " ".join(rng.choice([f"w{j}" for j in range(50)], n_abs))
        exs.append(SummaryExample.build(art, [abs_], vocab, jhps))
    return Batch(exs, jhps, vocab)


def jax_state(jhps, params):
    return jtrainer.init_train_state(
        jhps, 64, params=jax.tree_util.tree_map(jnp.asarray, params))


def leaves(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


@pytest.fixture(scope="module")
def setup():
    jhps = JHParams(**TINY)
    vocab = Vocab(words=[f"w{i}" for i in range(60)], max_size=64)
    batch = make_batch(jhps, vocab).as_arrays()
    params = init_numpy_params(HParams(**TINY), 64, 7)
    single = jax.jit(jtrainer.make_train_step(jhps))
    ref_state, ref_m = single(jax_state(jhps, params), batch)
    return jhps, params, batch, single, ref_state, ref_m


def _case(name, kind, steps=1, **hps):
    return {"name": name, "kind": kind, "steps": steps,
            "params": "params", "batch": "batch", "hps": dict(TINY, **hps)}


def _assert_f32_step(got_flat, info, ref_state, ref_m):
    loss, _, _, gnorm = info["metrics"][0]
    np.testing.assert_allclose(loss, float(ref_m.loss), rtol=2e-5)
    np.testing.assert_allclose(gnorm, float(ref_m.global_norm), rtol=2e-5)
    for g, r in zip(leaves(params_of(got_flat)), leaves(ref_state.params)):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)


def _assert_wire_step(got_flat, info, p0, ref_state, ref_m):
    loss, _, _, gnorm = info["metrics"][0]
    np.testing.assert_allclose(loss, float(ref_m.loss), rtol=1e-5)
    np.testing.assert_allclose(gnorm, float(ref_m.global_norm), rtol=1e-2)
    for a, r, g in zip(leaves(p0), leaves(ref_state.params),
                       leaves(params_of(got_flat))):
        ur, ul = r - a, g - a
        err = np.linalg.norm(ur - ul)
        assert err <= 0.05 * np.linalg.norm(ur) + 1e-4, err


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    """Every 4-rank case in one spawn."""
    jhps, params, batch, *_ = setup
    work = tmp_path_factory.mktemp("mesh4")
    save_params(work, "params", params)
    save_npz(work, "batch", batch)
    cases = [
        _case("dp4", "train", dp=4),
        _case("dp2tp2", "train", dp=2, tp=2),
        _case("eval_dp4", "eval", dp=4),
        _case("eval_dp2tp2", "eval", dp=2, tp=2),
        _case("dp4_5steps", "train", steps=5, dp=4),
        _case("wire_dp4", "train", dp=4, grad_allreduce_dtype="bfloat16"),
        _case("wire_dp2tp2", "train", dp=2, tp=2,
              grad_allreduce_dtype="bfloat16"),
        _case("wire20_dp4", "train", steps=20, dp=4,
              grad_allreduce_dtype="bfloat16"),
        _case("wire20_dp2tp2", "train", steps=20, dp=2, tp=2,
              grad_allreduce_dtype="bfloat16"),
        _case("chunk_bf16acc", "train", steps=5, dp=2, tp=2, loss_chunk=3,
              opt_state_dtype="bfloat16", grad_allreduce_dtype="bfloat16"),
    ]
    done = run_ranks(work, 4, cases)
    return work, done


@pytest.fixture(scope="module")
def world8(setup, tmp_path_factory):
    jhps, params, batch, *_ = setup
    work = tmp_path_factory.mktemp("mesh8")
    save_params(work, "params", params)
    save_npz(work, "batch", batch)
    cases = [
        _case("dp2tp2sp2", "train", dp=2, tp=2, sp=2),
        _case("wire_dp8", "train", dp=8, grad_allreduce_dtype="bfloat16"),
        _case("wire_dp4tp2", "train", dp=4, tp=2,
              grad_allreduce_dtype="bfloat16"),
    ]
    run_ranks(work, 8, cases)
    return work


def test_ranks_join_a_gloo_world_on_the_cpu(world4):
    _, done = world4
    assert [d["backend"] for d in done] == ["gloo"] * 4


@pytest.mark.parametrize("name,dp,tp", [("dp4", 4, 1), ("dp2tp2", 2, 2)])
def test_train_step_matches_single_device_and_jax_mesh(setup, world4, name,
                                                       dp, tp):
    jhps, params, batch, _, ref_state, ref_m = setup
    work, _ = world4
    flat, info = load_npz(work, name), load_json(work, name)
    _assert_f32_step(flat, info, ref_state, ref_m)
    # and the JAX package's own sharded step on the virtual mesh
    plan = jmesh.make_mesh(jhps.replace(dp=dp, tp=tp))
    step = jmesh.make_sharded_train_step(plan, donate=False)
    jstate, jm = step(jmesh.shard_train_state(plan, jax_state(jhps, params)),
                      batch)
    np.testing.assert_allclose(info["metrics"][0][0], float(jm.loss),
                               rtol=2e-5)
    for g, r in zip(leaves(params_of(flat)),
                    leaves(jax.device_get(jstate.params))):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)
    # each tp rank held V/tp rows of the embedding
    assert info["local_vocab"] == 64 // tp


def test_train_step_dp2_tp2_sp2_matches_single_device(setup, world8):
    *_, ref_state, ref_m = setup
    _assert_f32_step(load_npz(world8, "dp2tp2sp2"),
                     load_json(world8, "dp2tp2sp2"), ref_state, ref_m)


@pytest.mark.parametrize("name,dp,tp", [("dp4", 4, 1), ("dp2tp2", 2, 2),
                                        ("wire_dp4", 4, 1),
                                        ("wire_dp2tp2", 2, 2)])
def test_dp_allreduce_bytes_equal_analytic_comms(setup, world4, name, dp, tp):
    """parallel/collective_bytes_total{op=all_reduce,axis=dp} per step is
    the registry's dp_wire_bytes, and the tp gathers moved the scores."""
    jhps, params, *_ = setup
    work, _ = world4
    wire = "bfloat16" if name.startswith("wire") else "float32"
    hps = HParams(**TINY).replace(dp=dp, tp=tp, grad_allreduce_dtype=wire)
    comms = sharding.analytic_comms(hps, params=params)
    per_step = load_json(work, name)["bytes_per_step"]
    assert per_step["all_reduce/dp"] == comms["dp_wire_bytes"]
    if tp > 1:
        # the [T_dec, B/dp, V] scores gathered per step (f32)
        assert per_step["all_gather/tp"] == pytest.approx(
            comms["tp_scores_bytes"] / dp * 64 / 72)


@pytest.mark.parametrize("name", ["eval_dp4", "eval_dp2tp2"])
def test_sharded_eval_step(setup, world4, name):
    *_, ref_m = setup
    work, _ = world4
    np.testing.assert_allclose(load_json(work, name)["metrics"][0],
                               float(ref_m.loss), rtol=2e-5)


def test_multi_step_training_loss_decreases(world4):
    work, _ = world4
    losses = [m[0] for m in load_json(work, "dp4_5steps")["metrics"]]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", ["wire_dp4", "wire_dp2tp2"])
def test_bf16_wire_single_step_parity(setup, world4, name):
    _, params, _, _, ref_state, ref_m = setup
    work, _ = world4
    _assert_wire_step(load_npz(work, name), load_json(work, name), params,
                      ref_state, ref_m)


@pytest.mark.parametrize("name", ["wire_dp8", "wire_dp4tp2"])
def test_bf16_wire_single_step_parity_on_8_ranks(setup, world8, name):
    _, params, _, _, ref_state, ref_m = setup
    _assert_wire_step(load_npz(world8, name), load_json(world8, name),
                      params, ref_state, ref_m)


@pytest.mark.parametrize("name", ["wire20_dp4", "wire20_dp2tp2"])
def test_bf16_wire_n_step_envelope(setup, world4, name):
    jhps, params, batch, single, *_ = setup
    work, _ = world4
    s_ref = jax_state(jhps, params)
    for _ in range(20):
        s_ref, m_ref = single(s_ref, batch)
    info = load_json(work, name)
    np.testing.assert_allclose(info["metrics"][-1][0], float(m_ref.loss),
                               rtol=1e-3)
    for r, g in zip(leaves(s_ref.params),
                    leaves(params_of(load_npz(work, name)))):
        rel = np.linalg.norm(r - g) / (np.linalg.norm(r) + 1e-12)
        assert rel < 2e-2, rel


def test_dp_tp_with_loss_chunk_and_bf16_state(world4):
    work, _ = world4
    info = load_json(work, "chunk_bf16acc")
    losses = [m[0] for m in info["metrics"]]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert info["acc_dtypes"] == ["torch.bfloat16"]
    assert info["local_vocab"] == 32
