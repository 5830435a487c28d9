"""The port's pointer-generator training against the JAX package's on the
CPU: the fused attention's backward (the plain formulas of
``_attention_bwd_plain`` and the ``FusedAttention`` autograd Function)
against ``jax.vjp`` of the reference formula, ``forward_train`` and every
parameter's gradient, and three Adagrad train steps, from one numpy
params tree and the same batches.

Sizes: hidden 16, embedding 8, V = 60, T_enc = 24, T_dec = 10, batch 2
(tests/_torch_parity.py), articles with copied OOVs in the targets.  The
JAX side runs its XLA attention formula (the CPU backend never takes the
Pallas kernel) and differentiates it with ``jax.vjp``, as its custom_vjp
does.

Tolerances: the attention's gradients within 1e-5 * max(1, max|g|);
outputs within 1e-5 and gradients within 1e-5 * max(1, max|g|) (f32 on
both sides; only the order of sums differs); after three steps the
losses and global norms within 1e-5 relative, the params within 1e-5
absolute and the accumulators within 1e-5 relative, as for the
transformer (tests/test_torch_training.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import WORDS, article, make_hps, n, numpy_params, t
from textsummarization_on_flink_tpu.models import pointer_generator as jpg
from textsummarization_on_flink_tpu.ops import pallas_attention as pa
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode.beam_search import _to_device
from textsummarization_on_flink_tpu_torch.models import pointer_generator as tpg
from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    tree_leaves,
)
from textsummarization_on_flink_tpu_torch.train import trainer

TOL = dict(rtol=1e-5, atol=1e-5)
VSIZE = len(WORDS) + 4


def _close(got, want):
    """|got - want| <= 1e-5 * max(1, max|want|)."""
    want = np.asarray(want)
    err = float(np.max(np.abs(n(got) - want))) if want.size else 0.0
    assert err <= 1e-5 * max(1.0, float(np.max(np.abs(want)))), err


def attention_inputs(B=3, T=19, D=12, seed=0):
    """Per-row attention inputs: ragged rows, row 1 fully masked, and the
    cotangents of (ctx, attn)."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T)[None] < np.array([[13], [T], [T]])).astype(
        np.float32)
    mask[1] = 0.0
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(es=f32(B, T, D), ef=f32(B, T, D), mask=mask,
                df=f32(B, D),
                cov=(np.abs(f32(B, T)) * mask).astype(np.float32),
                v=f32(D) * 0.5, w_c=f32(D) * 0.5, g_ctx=f32(B, D),
                g_attn=f32(B, T))


@pytest.mark.parametrize("use_cov", [True, False])
def test_attention_backward_matches_jax_vjp_and_autograd(use_cov):
    x = attention_inputs()
    names = ("es", "ef", "df", "cov", "v", "w_c")

    def f(es, ef, df, cov, v, w_c):
        return pa._attention_xla(es, ef, x["mask"], df, cov, v, w_c, use_cov)

    (_, attn_j), vjp = jax.vjp(f, *(jnp.asarray(x[k]) for k in names))
    want = vjp((jnp.asarray(x["g_ctx"]), jnp.asarray(x["g_attn"])))
    args = {k: t(x[k]) for k in x}
    got = fa._attention_bwd_plain(
        args["es"], args["ef"], args["mask"], args["df"], args["cov"],
        args["v"], args["w_c"], t(np.array(attn_j)), args["g_ctx"],
        args["g_attn"], use_cov)
    # autograd of the plain forward formula, the third reading
    leaves = [args[k].clone().requires_grad_() for k in names]
    ctx_p, attn_p = fa._attention_plain(
        leaves[0], leaves[1], args["mask"], leaves[2][:, None],
        leaves[3][:, None], leaves[4], leaves[5], use_cov)
    auto = torch.autograd.grad(
        (ctx_p[:, 0] * args["g_ctx"]).sum()
        + (attn_p[:, 0] * args["g_attn"]).sum(), leaves,
        materialize_grads=True)
    for name, g, w, a in zip(names, got, want, auto):
        _close(g, w)
        _close(g, n(a))
        assert np.isfinite(n(g)).all(), name
    for g in got[:4]:  # the empty article: zero gradients, not NaN
        assert not n(g)[1].any()
    if not use_cov:
        assert not n(got[3]).any() and not n(got[5]).any()


@pytest.mark.parametrize("use_cov", [True, False])
def test_autograd_function_matches_jax_custom_vjp(use_cov):
    """``fused_attention`` with inputs that require grad goes through
    FusedAttention (plain forward and backward on the CPU) and gives the
    JAX package's custom_vjp gradients."""
    x = attention_inputs(seed=3)
    names = ("es", "ef", "df", "cov", "v", "w_c")
    leaves = [t(x[k]).requires_grad_() for k in names]
    ctx, attn = fa.fused_attention(leaves[0], leaves[1], t(x["mask"]),
                                   leaves[2], leaves[3], leaves[4],
                                   leaves[5], use_cov)
    assert ctx.grad_fn is not None and "FusedAttention" in \
        type(ctx.grad_fn).__name__
    got = torch.autograd.grad((ctx * t(x["g_ctx"])).sum()
                              + (attn * t(x["g_attn"])).sum(), leaves)

    def f(*a):
        c, at = pa.fused_attention(a[0], a[1], jnp.asarray(x["mask"]), a[2],
                                   a[3], a[4], a[5], use_cov)
        return (jnp.sum(c * x["g_ctx"]) + jnp.sum(at * x["g_attn"]))

    want = jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(x[k]) for k in names))
    for g, w in zip(got, want):
        _close(g, w)
    with torch.no_grad():  # decode: the forward alone, no graph
        ctx_ng, _ = fa.fused_attention(*(leaves[:2]), t(x["mask"]),
                                       *leaves[2:], use_cov)
    assert ctx_ng.grad_fn is None
    np.testing.assert_array_equal(n(ctx_ng), n(ctx))


def test_backward_refuses_bf16_encoder_streams():
    """The backward no longer refuses a bf16 encoder stream: through the
    autograd Function, bf16 es/ef give bf16 d_es/d_ef (the primal's
    dtype, as jax.vjp gives them) and f32 gradients of the rest, and a
    stream of another dtype is still refused (fp16 is no stream the
    forward takes)."""
    x = attention_inputs()
    args = {k: t(x[k]) for k in x}
    es16 = args["es"].to(torch.bfloat16).requires_grad_()
    ef16 = args["ef"].to(torch.bfloat16).requires_grad_()
    df = args["df"].clone().requires_grad_()
    ctx, attn = fa.fused_attention(es16, ef16, args["mask"], df, args["cov"],
                                   args["v"], args["w_c"], True)
    d_es, d_ef, d_df = torch.autograd.grad(
        (ctx * args["g_ctx"]).sum() + (attn * args["g_attn"]).sum(),
        (es16, ef16, df))
    assert (d_es.dtype, d_ef.dtype, d_df.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        fa._attention_bwd_cuda(args["es"].half(), args["ef"].half(),
                               args["mask"], args["df"], args["cov"],
                               args["v"], args["w_c"], args["g_attn"],
                               args["g_ctx"], args["g_attn"], True)


def hps_pair(**kw):
    return make_hps(**dict(dict(mode="train", max_oov_buckets=8), **kw))


def batch_arrays(thps, seed):
    """A Batch's numpy arrays: articles with ~40% OOV words and
    abstracts drawn from their article (so targets copy OOVs)."""
    rng = np.random.RandomState(seed)
    vocab = Vocab(words=WORDS)
    exs = []
    for i in range(thps.batch_size):
        art = article(seed * 7 + i, n_words=int(rng.randint(8, 30))).split()
        abs_ = [art[j] for j in rng.randint(0, len(art), rng.randint(3, 13))]
        exs.append(batching.SummaryExample.build(
            " ".join(art), [" ".join(abs_)], vocab, thps))
    return batching.Batch(exs, thps, vocab).as_arrays()


@pytest.fixture(scope="module", params=[True, False], ids=["pg", "no_pg"])
def jax_reference(request):
    """JAX forward_train outputs and the gradients of both objectives
    (total_loss with coverage on, loss with coverage off), one jit per
    (pointer_gen, coverage)."""
    out = {}
    for coverage in (True, False):
        jhps, thps = hps_pair(pointer_gen=request.param, coverage=coverage)
        p = numpy_params(thps, VSIZE, 3)
        arrays = batch_arrays(thps, 0)
        ja = {k: jnp.asarray(v) for k, v in arrays.items()}
        field = "total_loss" if coverage else "loss"

        def f(params, jhps=jhps, ja=ja, field=field):
            def objective(pp):
                o = jpg.forward_train(pp, jhps, ja)
                return getattr(o, field), o

            (_, o), g = jax.value_and_grad(objective, has_aux=True)(params)
            return o, g

        jout, grads = jax.jit(f)(jax.tree_util.tree_map(jnp.asarray, p))
        out[coverage] = (p, arrays, jout, grads)
    return request.param, out


@pytest.mark.parametrize("coverage", [True, False])
def test_forward_train_and_grads_match_jax(jax_reference, coverage):
    pointer_gen, ref = jax_reference
    p, arrays, jout, g_want = ref[coverage]
    _, thps = hps_pair(pointer_gen=pointer_gen, coverage=coverage)
    tp = from_numpy_tree(p)
    for x in tree_leaves(tp):
        x.requires_grad_(True)
    out = tpg.forward_train(tp, thps, _to_device(arrays, "cpu"))
    for f in ("loss", "coverage_loss", "total_loss", "attn_dists", "p_gens"):
        np.testing.assert_allclose(n(getattr(out, f)),
                                   np.asarray(getattr(jout, f)), **TOL)
    if coverage:
        assert float(out.coverage_loss.detach()) > 0
    else:
        assert float(out.coverage_loss) == 0.0
    objective = out.total_loss if coverage else out.loss
    grads = torch.autograd.grad(objective, tree_leaves(tp),
                                materialize_grads=True)
    want = jax.tree_util.tree_leaves(g_want)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _close(g, w)
    if pointer_gen:
        assert (arrays["target_batch"] >= VSIZE).any()  # the copy path


def test_three_train_steps_track_jax():
    """Port train_step (the fused attention's Function, plain backward on
    the CPU) against jax.jit(make_train_step(hps)) on the same three
    batches, pointer_gen and coverage on, lr 0.15 (the reference's)."""
    jhps, thps = hps_pair(pointer_gen=True, coverage=True)
    p = numpy_params(thps, VSIZE, 5)
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


def test_validate_refuses_remat_and_loss_chunk():
    """remat and the streaming loss are taken now; validate still refuses
    a negative chunk, as the JAX package's does, and takes the
    transformer in bf16 with both (it raised before its flash kernels had
    bf16 forms)."""
    _, thps = hps_pair()
    thps.replace(remat=True).validate()
    thps.replace(loss_chunk=4).validate()
    with pytest.raises(ValueError, match="loss_chunk"):
        thps.replace(loss_chunk=-1).validate()
    thps.replace(model_family="transformer", hidden_dim=32, num_heads=2,
                 compute_dtype="bfloat16", remat=True,
                 loss_chunk=4).validate()


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    """The kernel path never runs the plain version: handed CPU tensors
    it raises, and nothing is launched."""
    x = attention_inputs()
    args = {k: t(x[k]) for k in x}
    before = fa.launches_bwd
    with pytest.raises(ValueError, match="CUDA"):
        fa._attention_bwd_cuda(args["es"], args["ef"], args["mask"],
                               args["df"], args["cov"], args["v"],
                               args["w_c"], args["g_attn"], args["g_ctx"],
                               args["g_attn"], True)
    assert fa.launches_bwd == before
