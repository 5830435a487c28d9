"""The port's transformer training against the JAX package's on the CPU:
``forward_train`` and every parameter's gradient, and three Adagrad train
steps, from one numpy params tree and the same batches.

Sizes: hidden 64, 2 heads of 32 (the reference head width), 2 + 2 layers,
FFN 256, V = 200, T_enc = 40, T_dec = 12, batch 3, with copied article
OOVs in the targets.  The JAX side runs its einsum ``_mha`` path (the
CPU backend never takes its flash kernel); the port's self-attention
goes through the flash Function with its plain backward.

Tolerances: outputs within 1e-5 and gradients within 1e-5 * max(1,
max|g|) (f32 on both sides; only the order of sums differs); after three
steps the losses and global norms within 1e-5 relative, the params within
1e-5 absolute and the accumulators within 1e-5 relative (each Adagrad
step moves a param by at most lr = 0.15, so a 1e-7 relative difference
in a gradient stays far below 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import make_hps, n
from textsummarization_on_flink_tpu.models import transformer as jtfm
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode.beam_search import _to_device
from textsummarization_on_flink_tpu_torch.models import get_family
from textsummarization_on_flink_tpu_torch.models import transformer as tfm
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
    tree_leaves,
)
from textsummarization_on_flink_tpu_torch.train import trainer

TOL = dict(rtol=1e-5, atol=1e-5)
WORDS = [f"w{i}" for i in range(196)]
VSIZE = len(WORDS) + 4  # 200 with the four specials


def hps_pair(**kw):
    fields = dict(model_family="transformer", hidden_dim=64, num_heads=2,
                  enc_layers=2, dec_layers=2, ffn_dim=256, batch_size=3,
                  vocab_size=VSIZE, max_enc_steps=40, max_dec_steps=12,
                  max_oov_buckets=8, mode="train")
    fields.update(kw)
    return make_hps(**fields)


def batch_arrays(thps, seed):
    """A Batch's numpy arrays: ragged articles with ~30% OOV words and
    abstracts drawn from their article (so targets copy OOVs)."""
    rng = np.random.RandomState(seed)
    vocab = Vocab(words=WORDS)
    exs = []
    for _ in range(thps.batch_size):
        art = [WORDS[j] if rng.rand() < 0.7 else f"zz{j % 6}"
               for j in rng.randint(0, len(WORDS), rng.randint(10, 45))]
        abs_ = [art[j] for j in rng.randint(0, len(art), rng.randint(3, 14))]
        exs.append(batching.SummaryExample.build(
            " ".join(art), [" ".join(abs_)], vocab, thps))
    return batching.Batch(exs, thps, vocab).as_arrays()


@pytest.fixture(scope="module", params=[True, False], ids=["pg", "no_pg"])
def jax_reference(request):
    """JAX forward_train outputs with coverage on, and the gradients of
    both objectives (total_loss: coverage on; loss: coverage off, whose
    loss, attn_dists and p_gens are the same numbers), one jit per
    pointer_gen."""
    jhps, thps = hps_pair(pointer_gen=request.param, coverage=True)
    p = init_numpy_params(thps, VSIZE, 3)
    arrays = batch_arrays(thps, 0)
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}

    def f(params):
        def objective(pp, field):
            out = jtfm.forward_train(pp, jhps, ja)
            return getattr(out, field), out

        (_, out), g_total = jax.value_and_grad(
            objective, has_aux=True)(params, "total_loss")
        g_loss = jax.grad(lambda pp: objective(pp, "loss")[0])(params)
        return out, g_total, g_loss

    out, g_total, g_loss = jax.jit(f)(jax.tree_util.tree_map(jnp.asarray, p))
    return request.param, p, arrays, out, g_total, g_loss


@pytest.mark.parametrize("coverage", [True, False])
def test_forward_train_and_grads_match_jax(jax_reference, coverage):
    pointer_gen, p, arrays, jout, g_total, g_loss = jax_reference
    _, thps = hps_pair(pointer_gen=pointer_gen, coverage=coverage)
    tp = from_numpy_tree(p)
    for x in tree_leaves(tp):
        x.requires_grad_(True)
    out = tfm.forward_train(tp, thps, _to_device(arrays, "cpu"))
    for f in ("loss", "attn_dists", "p_gens"):
        np.testing.assert_allclose(n(getattr(out, f)),
                                   np.asarray(getattr(jout, f)), **TOL)
    if coverage:
        np.testing.assert_allclose(n(out.coverage_loss),
                                   np.asarray(jout.coverage_loss), **TOL)
        np.testing.assert_allclose(n(out.total_loss),
                                   np.asarray(jout.total_loss), **TOL)
        assert float(out.coverage_loss.detach()) > 0
    else:  # JAX: coverage_loss = zeros(()), total = loss
        assert float(out.coverage_loss) == 0.0
        assert float(out.total_loss.detach()) == float(out.loss.detach())
    objective = out.total_loss if coverage else out.loss
    grads = torch.autograd.grad(objective, tree_leaves(tp),
                                materialize_grads=True)
    want = jax.tree_util.tree_leaves(g_total if coverage else g_loss)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert float(np.max(np.abs(n(g) - w))) <= \
            1e-5 * max(1.0, float(np.max(np.abs(w))))
    if pointer_gen:
        assert (arrays["target_batch"] >= VSIZE).any()  # the copy path


def test_three_train_steps_track_jax():
    """Port train_step (flash Function, plain backward on the CPU) against
    jax.jit(make_train_step(hps)) on the same three batches."""
    jhps, thps = hps_pair(pointer_gen=True, coverage=True)
    p = init_numpy_params(thps, VSIZE, 5)
    batches = [batch_arrays(thps, s) for s in (1, 2, 3)]
    jstate = jtrainer.init_train_state(jhps, VSIZE, params=jax.tree_util.
                                       tree_map(jnp.asarray, p))
    jstep = jax.jit(jtrainer.make_train_step(jhps))
    state = trainer.init_train_state(thps, VSIZE, params=p)
    for arrays in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in arrays.items()})
        state, m = trainer.train_step(thps, state, _to_device(arrays, "cpu"))
        for f in ("loss", "coverage_loss", "total_loss", "global_norm"):
            np.testing.assert_allclose(float(getattr(m, f)),
                                       float(getattr(jm, f)), rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    for got, want in zip(tree_leaves(state.params),
                         jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=0,
                                   atol=1e-5)
    for got, want in zip(tree_leaves(state.opt_state.accumulators),
                         jax.tree_util.tree_leaves(
                             jstate.opt_state.accumulators)):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                                   atol=0)


def test_adagrad_is_tf1_without_epsilon_and_clips_globally():
    """One update by hand: accum += g^2, p -= lr * g * rsqrt(accum), after
    scaling every gradient by min(1, max_norm / global_norm)."""
    from textsummarization_on_flink_tpu_torch.train import optim

    params = {"a": torch.tensor([1.0, -2.0]), "b": [torch.tensor([0.5])]}
    grads = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]  # norm 13
    state = optim.adagrad_init(params, 0.1)
    grads, norm = optim.clip_by_global_norm(grads, 2.0)
    assert float(norm) == 13.0
    optim.adagrad_update(grads, state, params, lr=0.15)
    g = np.array([3.0, 4.0, 12.0]) * 2.0 / 13.0
    acc = 0.1 + g * g
    want = np.array([1.0, -2.0, 0.5]) - 0.15 * g / np.sqrt(acc)
    got = np.concatenate([n(x) for x in tree_leaves(params)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([n(x) for x in tree_leaves(state.accumulators)]),
        acc, rtol=1e-6)


def test_pointer_generator_forward_train_names_its_roadmap_item():
    """The pointer-generator's training slice (ROADMAP.md queue 1, item 1)
    has landed: its forward_train runs (tests/test_torch_pg_training.py
    holds it against the JAX package's)."""
    from textsummarization_on_flink_tpu_torch.models import (
        pointer_generator as pg,
    )

    assert get_family("pointer_generator").forward_train is pg.forward_train
    assert get_family("transformer").forward_train is tfm.forward_train
    _, thps = make_hps(mode="train", coverage=True, vocab_size=VSIZE,
                       max_oov_buckets=8)
    out = pg.forward_train(from_numpy_tree(init_numpy_params(thps, VSIZE, 0)),
                           thps, _to_device(batch_arrays(thps, 0), "cpu"))
    assert np.isfinite(float(out.total_loss))
