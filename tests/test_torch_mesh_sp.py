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
recurrence that amplifies them).

The transformer and the AAN without --sp_attention (the JAX package's
batch_spec shards their encoder arrays over sp too, and GSPMD partitions
the einsum attention ``_mha`` around T): each rank runs the encoder's
position-wise layers on its block of T and its self-attention on its
block of queries against the keys and mask all-gathered over sp.  Their
train steps at sp=2, dp2 x sp2 and tp2 x sp2 and their eval steps are
held to the JAX single-device step at the same tolerances (the AAN's as
tests/test_torch_mesh_aan.py states them: loss rtol 1e-5, global norm
rtol 1e-4, params rtol 1e-4 / atol 1e-5), their batch searches at sp=2
to the JAX search's tokens and lengths exactly (the transformer also at
T = 15, which the search pads to 16 with a masked position), and each
rank's flash attention saved, for each encoder layer, its block of q
and of the output (T / sp positions) beside the gathered k and v."""

import jax
import numpy as np
import pytest

import jax.numpy as jnp

import test_torch_mesh_aan as maan
import test_torch_mesh_decode as mdec
import test_torch_mesh_train as mt
import test_torch_sp_attention as spa
from _torch_mesh import load_json, load_npz, params_of, run_ranks, save_npz
from _torch_mesh import save_params
from test_torch_avg_attention import jax_params
from tests.test_speculative import AAN_HPS, make_arrays
from textsummarization_on_flink_tpu.config import HParams as JHParams
from textsummarization_on_flink_tpu.data.vocab import Vocab
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.params import init_numpy_params

TINY = dict(mt.TINY, coverage=True)
#: the transformer's widths of tests/test_torch_sp_attention.py (hidden 8,
#: 4 heads, 2 + 2 layers, batch 8, T 16); no --sp_attention
TF = dict(spa.TF)
#: family -> {case: mesh fields} of the train steps without
#: --sp_attention, and the world each runs in
FAMILY_MESHES = {"tf": {"sp2": dict(sp=2), "dp2sp2": dict(dp=2, sp=2),
                        "tp2sp2": dict(tp=2, sp=2)},
                 "aan": {"sp2": dict(sp=2), "dp2sp2": dict(dp=2, sp=2),
                         "tp2sp2": dict(tp=2, sp=2)}}
#: the transformer's searches at sp=2: T 16, and T 15, which sp does not
#: divide
TF_SEARCH_T = {"search_sp2": None, "search_sp2_t15": 15}


@pytest.fixture(scope="module")
def tf_setup():
    jhps = JHParams(**TF)
    vocab = Vocab(words=[f"w{i}" for i in range(60)], max_size=64)
    batch = spa.make_batch(jhps, vocab)
    params = init_numpy_params(HParams(**TF), 64, 5)
    state = jtrainer.init_train_state(
        jhps, 64, params=jax.tree_util.tree_map(jnp.asarray, params))
    ref_state, ref_m = jax.jit(jtrainer.make_train_step(jhps))(state, batch)
    return params, batch, ref_state, ref_m


def _family_cases(tf_setup, work, world):
    """The transformer's and the AAN's cases of one world: their train
    steps, and at world 2 their eval steps, searches and saved check."""
    params, batch, *_ = tf_setup
    save_params(work, "tf_params", params)
    save_npz(work, "tf_batch", batch)
    aan_p, aan_batch, _, _ = maan._jax_step({})
    save_params(work, "aan_params", aan_p)
    save_npz(work, "aan_batch", aan_batch)
    aan_hps = maan._fields(maan._train_hps({}))
    hps_of = {"tf": TF, "aan": aan_hps}
    cases = []
    for fam, meshes in FAMILY_MESHES.items():
        for name, mesh in meshes.items():
            if int(np.prod(list(mesh.values()))) != world:
                continue
            for kind in ("train", "eval"):
                cases.append({"name": f"{fam}_{kind}_{name}", "kind": kind,
                              "steps": 1, "params": f"{fam}_params",
                              "batch": f"{fam}_batch",
                              "hps": dict(hps_of[fam], **mesh)})
    if world == 2:
        _, thps, _, sparams = mdec._setup("transformer")
        save_params(work, "tf_search_params", sparams)
        for name, t in TF_SEARCH_T.items():
            save_npz(work, f"tf_{name}_batch",
                     mdec._setup("transformer", t)[2].as_arrays())
            cases.append({"name": f"tf_{name}", "kind": "search",
                          "params": "tf_search_params",
                          "batch": f"tf_{name}_batch",
                          "hps": mdec._hps_fields(thps, mode="decode",
                                                  sp=2)})
        jhps = AAN_HPS.replace(batch_size=maan.B)
        save_params(work, "aan_search_params", jax_params(AAN_HPS, seed=1))
        save_npz(work, "aan_search_batch", make_arrays(jhps, maan.B, seed=2))
        cases.append({"name": "aan_search_sp2", "kind": "search",
                      "params": "aan_search_params",
                      "batch": "aan_search_batch",
                      "hps": maan._fields(jhps, sp=2)})
    saved = {2: ("tf_saved_sp2", dict(sp=2)),
             4: ("tf_saved_tp2sp2", dict(tp=2, sp=2))}[world]
    cases.append({"name": saved[0], "kind": "saved", "steps": 1,
                  "params": "tf_params", "batch": "tf_batch",
                  "hps": dict(TF, **saved[1])})
    return cases


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


def _spawn(work, setup, tf_setup, world, cases):
    params, batch, *_ = setup
    save_params(work, "params", params)
    save_npz(work, "batch", batch)
    run_ranks(work, world, cases + _family_cases(tf_setup, work, world))
    return work


@pytest.fixture(scope="module")
def world2(setup, tf_setup, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("sp2"), setup, tf_setup, 2, [
        _case("sp2", "train", sp=2), _case("eval_sp2", "eval", sp=2),
        _case("saved_sp2", "saved", sp=2)])


@pytest.fixture(scope="module")
def world4(setup, tf_setup, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("sp4"), setup, tf_setup, 4, [
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


@pytest.mark.parametrize("fam,name", [(f, n) for f, meshes in
                                      FAMILY_MESHES.items() for n in meshes])
def test_transformer_and_aan_train_step_on_sp_match_jax(request, tf_setup,
                                                        fam, name):
    """The transformer's and the AAN's step with the encoder's T sharded
    over sp and no --sp_attention (with dp, and with tp's Megatron heads
    beside it): the loss, the global norm and every updated parameter
    are the JAX single-device step's."""
    work = _world(request, int(np.prod(list(
        FAMILY_MESHES[fam][name].values()))))
    info = load_json(work, f"{fam}_train_{name}")
    got = params_of(load_npz(work, f"{fam}_train_{name}"))
    if fam == "tf":
        *_, ref_state, ref_m = tf_setup
        mt._assert_f32_step(load_npz(work, f"{fam}_train_{name}"), info,
                            ref_state, ref_m)
        return
    _, _, ref, ref_m = maan._jax_step({})
    np.testing.assert_allclose(info["metrics"][0][0], float(ref_m.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(info["metrics"][0][3],
                               float(ref_m.global_norm), rtol=1e-4)
    want = jax.tree_util.tree_leaves(ref.params)
    got = jax.tree_util.tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fam,name", [(f, n) for f, meshes in
                                      FAMILY_MESHES.items() for n in meshes])
def test_transformer_and_aan_eval_step_on_sp_match_jax(request, tf_setup,
                                                       fam, name):
    """The eval step on the same meshes: the JAX single-device loss."""
    work = _world(request, int(np.prod(list(
        FAMILY_MESHES[fam][name].values()))))
    ref_m = tf_setup[3] if fam == "tf" else maan._jax_step({})[3]
    np.testing.assert_allclose(
        load_json(work, f"{fam}_eval_{name}")["metrics"][0],
        float(ref_m.loss), rtol=2e-5 if fam == "tf" else 1e-5)


@pytest.mark.parametrize("name", sorted(TF_SEARCH_T) + ["aan_search_sp2"])
def test_transformer_and_aan_search_on_sp_equal_jax(world2, name):
    """The batch search at sp=2 without --sp_attention: every rank's
    tokens and lengths are the JAX single-device search's (at T = 15 the
    port pads the batch to 16 with a masked position)."""
    if name.startswith("aan"):
        jhps = AAN_HPS.replace(batch_size=maan.B)
        want = jax_bs.run_beam_search(jax_params(AAN_HPS, seed=1), jhps,
                                      make_arrays(jhps, maan.B, seed=2))
        got_name = name
    else:
        # the ranks' params (their position table is max_enc_steps 16 rows
        # long) on the batch of T positions
        params = mdec._setup("transformer")[3]
        jhps, _, batch, _ = mdec._setup("transformer", TF_SEARCH_T[name])
        want = jax_bs.run_beam_search(params, jhps, batch.as_arrays())
        got_name = f"tf_{name}"
    for r in range(2):
        got = load_npz(world2, f"{got_name}.rank{r}")
        np.testing.assert_array_equal(got["tokens"], np.asarray(want.tokens))
        np.testing.assert_array_equal(got["length"], np.asarray(want.length))
        np.testing.assert_allclose(got["avg_log_prob"],
                                   np.asarray(want.avg_log_prob),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,world,tp,sp", [("tf_saved_sp2", 2, 1, 2),
                                              ("tf_saved_tp2sp2", 4, 2, 2)])
def test_each_sp_rank_saves_its_block_of_the_transformer_encoder(
        request, tf_setup, name, world, tp, sp):
    """Each rank's flash attention saved, per encoder layer, its block of
    q and of the context (T / sp positions, its num_heads / tp heads) and
    the k and v gathered over sp (T positions); the decoder's causal
    self-attention holds the whole target on every rank.  The step
    those ranks took is the single device's."""
    work = _world(request, world)
    B, T, nh = TF["batch_size"], TF["max_enc_steps"], TF["num_heads"] // tp
    hd = TF["hidden_dim"] // TF["num_heads"]
    T_dec = TF["max_dec_steps"]
    for r in range(world):
        info = load_json(work, f"{name}.rank{r}")
        enc = [x for x in info["flash"] if not x["causal"]]
        dec = [x for x in info["flash"] if x["causal"]]
        assert len(enc) == TF["enc_layers"] and len(dec) == TF["dec_layers"]
        for x in enc:
            assert x["q"] == x["out"] == [B, T // sp, nh, hd]
            assert x["k"] == x["v"] == [B, T, nh, hd]
        for x in dec:
            assert x["q"] == x["k"] == x["out"] == [B, T_dec, nh, hd]
    np.testing.assert_allclose(
        load_json(work, f"{name}.train")["metrics"][0][0],
        float(tf_setup[3].loss), rtol=2e-5)
