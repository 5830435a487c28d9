"""The port's byte-diet options against the JAX package's, on the CPU:
the streaming ``--loss_chunk`` losses, bf16 compute for the
pointer-generator (the vocab projection, the fused attention's backward
on a bf16 encoder stream, the loss and its gradients, beam decode), bf16
Adagrad state, and ``--remat``.  Mirrors the JAX package's
tests/test_byte_diet.py, tests/test_model_core.py and
tests/test_transformer.py for these options.

Sizes: hidden 16, embedding 8, V = 60, T_enc = 24, T_dec = 10, batch 2
(tests/_torch_parity.py; the transformer 2 + 2 layers of 2 heads), the
same numpy params and batches through both packages.

Tolerances:
  * f32: within 1e-5 * max(1, max|x|) of the JAX package (only the order
    of sums differs), and the streaming loss within 1e-6 relative of the
    port's own materialised loss (the JAX package's own pin);
  * a bf16 value the port rounds once from f32 (the projection's and the
    attention's cotangents) within one bf16 unit in the last place of
    the JAX package's: the f32 sums before the rounding differ in order,
    which can move a value across a rounding boundary;
  * bf16 end to end (the loss and every gradient of the
    pointer-generator, N Adagrad steps with bf16 state): within
    BF16_GAP_FACTOR times the JAX package's own distance between its
    bf16 and its f32 result on the same inputs (per leaf, largest
    absolute difference).  XLA keeps bf16 intermediates of fused
    operations in f32 (its default excess precision) where PyTorch
    rounds each operation's result, so the two packages round at other
    places: their bf16 results differ by about as much as bf16 differs
    from f32, and no tighter pin holds.  JAX's own bf16 parity test
    fails on this tree (ROADMAP.md queue 3), so it cannot be the
    yardstick.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import (
    WORDS,
    article,
    decode_params,
    make_hps,
    n,
    numpy_params,
    t,
)
from textsummarization_on_flink_tpu import config as jax_config
from textsummarization_on_flink_tpu.checkpoint import checkpointer as jckpt
from textsummarization_on_flink_tpu.decode import beam_search as jbeam
from textsummarization_on_flink_tpu.models import pointer_generator as jpg
from textsummarization_on_flink_tpu.models import transformer as jtfm
from textsummarization_on_flink_tpu.ops import losses as jlosses
from textsummarization_on_flink_tpu.ops import pallas_attention as pa
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch import config as torch_config
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode.beam_search import _to_device
from textsummarization_on_flink_tpu_torch.models import pointer_generator as tpg
from textsummarization_on_flink_tpu_torch.models import transformer as ttfm
from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa
from textsummarization_on_flink_tpu_torch.ops import losses
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    tree_leaves,
)
from textsummarization_on_flink_tpu_torch.train import optim
from textsummarization_on_flink_tpu_torch.train import trainer

VSIZE = len(WORDS) + 4
BF16_GAP_FACTOR = 4.0
TF = dict(model_family="transformer", hidden_dim=16, num_heads=2,
          enc_layers=2, dec_layers=2)


def hps_pair(family="pointer_generator", **kw):
    fields = dict(mode="train", max_oov_buckets=8, coverage=True)
    if family == "transformer":
        fields.update(TF)
    fields.update(kw)
    return make_hps(**fields)


def batch_arrays(thps, seed):
    """A Batch's numpy arrays: articles with ~40% OOV words and abstracts
    drawn from their article (so targets copy OOVs)."""
    rng = np.random.RandomState(seed)
    vocab = Vocab(words=WORDS)
    exs = []
    for i in range(thps.batch_size):
        art = article(seed * 7 + i, n_words=int(rng.randint(8, 30))).split()
        abs_ = [art[j] for j in rng.randint(0, len(art), rng.randint(3, 13))]
        exs.append(batching.SummaryExample.build(
            " ".join(art), [" ".join(abs_)], vocab, thps))
    return batching.Batch(exs, thps, vocab).as_arrays()


def _scaled_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))) / \
        max(1.0, float(np.max(np.abs(want))))


def jax_loss_and_grads(family, jhps, p, arrays):
    mod = jtfm if family == "transformer" else jpg
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}

    def f(pp):
        return mod.forward_train(pp, jhps, ja).total_loss

    loss, g = jax.jit(jax.value_and_grad(f))(
        jax.tree_util.tree_map(jnp.asarray, p))
    return float(loss), [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


def port_loss_and_grads(family, thps, p, arrays):
    mod = ttfm if family == "transformer" else tpg
    tp = from_numpy_tree(p)
    for x in tree_leaves(tp):
        x.requires_grad_(True)
    out = mod.forward_train(tp, thps, _to_device(arrays, "cpu"))
    grads = torch.autograd.grad(out.total_loss, tree_leaves(tp),
                                materialize_grads=True)
    return float(out.total_loss.detach()), [n(g) for g in grads]


# ---------------------------------------------------------------------------
# the streaming loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [3, 1, 999],
                         ids=["divides_not", "one", "above_T"])
@pytest.mark.parametrize("pointer_gen", [True, False], ids=["pg", "no_pg"])
@pytest.mark.parametrize("family", ["pointer_generator", "transformer"])
def test_streaming_loss_matches_jax_and_the_materialised_loss(
        family, pointer_gen, chunk):
    """--loss_chunk: the loss and every gradient equal the JAX package's
    streaming loss (within 1e-5) and the port's materialised loss (1e-6
    relative for the loss, 1e-5 for the gradients), at a chunk that does
    not divide T_dec = 10 (the padded tail), chunk 1 and a chunk above
    T_dec (clamped to one chunk)."""
    jhps, thps = hps_pair(family, pointer_gen=pointer_gen, loss_chunk=chunk)
    p = numpy_params(thps, VSIZE, 3)
    arrays = batch_arrays(thps, 0)
    j_loss, j_grads = jax_loss_and_grads(family, jhps, p, arrays)
    s_loss, s_grads = port_loss_and_grads(family, thps, p, arrays)
    m_loss, m_grads = port_loss_and_grads(family, thps.replace(loss_chunk=0),
                                          p, arrays)
    assert abs(s_loss - j_loss) <= 1e-5 * max(1.0, abs(j_loss))
    assert s_loss == pytest.approx(m_loss, rel=1e-6)
    assert len(s_grads) == len(j_grads) == len(m_grads)
    for s, j, m in zip(s_grads, j_grads, m_grads):
        assert _scaled_err(s, j) <= 1e-5
        assert _scaled_err(s, m) <= 1e-5


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_streaming_gold_probs_unit_matches_jax(chunk):
    """streaming_gold_probs alone (JAX tests/test_byte_diet.py:108): equal
    to the JAX package's and to the materialised formula, values and the
    vjp of every differentiable input."""
    rng = np.random.RandomState(3)
    T, B, H, V, Te = 5, 3, 4, 11, 6
    x = dict(o=rng.randn(T, B, H), a=rng.rand(T, B, Te), p=rng.rand(T, B),
             w=rng.randn(H, V), v=rng.randn(V), g=rng.randn(T, B))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    targets = rng.randint(0, V + 2, (T, B)).astype(np.int32)
    ext = rng.randint(0, V + 2, (B, Te)).astype(np.int32)
    want, vjp = jax.vjp(
        lambda o, a, p, w, v: jlosses.streaming_gold_probs(
            o, a, p, jnp.asarray(targets), jnp.asarray(ext), w, v,
            chunk=chunk),
        *(jnp.asarray(x[k]) for k in "oapwv"))
    j_grads = vjp(jnp.asarray(x["g"]))
    leaves = [t(x[k]).requires_grad_() for k in "oapwv"]
    got = losses.streaming_gold_probs(*leaves[:3], t(targets), t(ext),
                                      *leaves[3:], chunk=chunk)
    mat = losses.gold_mixture_prob_from_scores(
        t(x["o"]) @ t(x["w"]) + t(x["v"]), t(x["a"]), t(x["p"]),
        t(targets), t(ext))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=0)
    np.testing.assert_allclose(n(got), n(mat), rtol=1e-6, atol=0)
    grads = torch.autograd.grad(got, leaves, t(x["g"]))
    for g, w in zip(grads, j_grads):
        assert _scaled_err(n(g), w) <= 1e-5


def _saved_with_last_dim(fn, V):
    """The shapes of every tensor autograd saves for the backward while
    ``fn()`` runs, whose last dimension is V."""
    shapes = []

    def pack(x):
        if x.dim() and x.shape[-1] == V:
            shapes.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        fn()
    return shapes


def test_streaming_loss_saves_no_materialised_scores():
    """The claim itself, at the JAX package's shapes (T 64, B 4, H 16,
    V 2048, chunk 8; its test measures XLA's temp memory instead): the
    streaming losses save no tensor with V in its last dimension larger
    than one [chunk, B, V] block (the [H, V] weight, H = 16 < chunk * B,
    is the largest), while the materialised softmax saves a whole
    [T, B, V] one."""
    T, B, H, V, chunk = 64, 4, 16, 2048, 8
    rng = np.random.RandomState(4)
    o = t(rng.randn(T, B, H).astype(np.float32)).requires_grad_()
    w = t((rng.randn(H, V) * 0.02).astype(np.float32)).requires_grad_()
    v = torch.zeros(V, requires_grad=True)
    targets = t(rng.randint(0, V, (T, B)).astype(np.int32))
    mask = torch.ones(T, B)
    attn = t(rng.rand(T, B, 5).astype(np.float32))
    p_gens = t(rng.rand(T, B).astype(np.float32))
    ext = t(rng.randint(0, V + 2, (B, 5)).astype(np.int32))
    block = chunk * B * V
    for fn in (
            lambda: losses.streaming_softmax_cross_entropy(
                o, targets, mask, w, v, chunk=chunk),
            lambda: losses.streaming_gold_probs(
                o, attn, p_gens, targets, ext, w, v, chunk=chunk),
            lambda: losses.streaming_gold_probs(
                o, attn, p_gens, targets, ext, w, v, chunk=chunk,
                compute_dtype="bfloat16")):
        shapes = _saved_with_last_dim(fn, V)
        assert shapes and max(int(np.prod(s)) for s in shapes) <= block
    mat = _saved_with_last_dim(
        lambda: losses.softmax_cross_entropy_baseline(
            (o @ w + v).transpose(0, 1), targets.T, mask.T), V)
    assert max(int(np.prod(s)) for s in mat) >= T * B * V


@pytest.mark.parametrize("family", ["pointer_generator", "transformer"])
def test_loss_chunk_keeps_no_tbv_tensor_in_the_model(family):
    """forward_train with --loss_chunk saves no [T_dec, B, V]-sized tensor
    with V last for the backward; the materialised loss does."""
    _, thps = hps_pair(family)
    p = from_numpy_tree(numpy_params(thps, VSIZE, 3))
    for x in tree_leaves(p):
        x.requires_grad_(True)
    arrays = _to_device(batch_arrays(thps, 0), "cpu")
    mod = ttfm if family == "transformer" else tpg
    tbv = thps.max_dec_steps * thps.batch_size * VSIZE

    def biggest(h):
        shapes = _saved_with_last_dim(
            lambda: mod.forward_train(p, h, arrays), VSIZE)
        return max(int(np.prod(s)) for s in shapes)

    assert biggest(thps.replace(loss_chunk=3)) < tbv
    assert biggest(thps) >= tbv


# ---------------------------------------------------------------------------
# bf16 compute
# ---------------------------------------------------------------------------

def _within_one_bf16_ulp(got, want):
    """|got - want| <= one bf16 unit in the last place of want (8
    significant bits: 2^-7 of the value's power of two)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.ldexp(np.float32(1.0), np.frexp(np.abs(want))[1] - 8)
    assert np.all(np.abs(got - want) <= ulp + 1e-30), \
        float(np.max(np.abs(got - want) / (ulp + 1e-30)))


def test_bf16_projection_and_its_vjp_match_jax():
    """project_scores in bf16: the scores within 1e-5 relative (exact
    products of the same bf16 values, f32 sums); its vjp, each cotangent
    rounded once to bf16 as jax.vjp's dot transpose does, within one
    bf16 ulp."""
    rng = np.random.RandomState(6)
    x = rng.randn(3, 7, 16).astype(np.float32)
    w = rng.randn(16, 50).astype(np.float32)
    g = rng.randn(3, 7, 50).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jlosses.project_scores(a, b, "bfloat16"),
                        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx, tw = t(x).requires_grad_(), t(w).requires_grad_()
    got = losses.project_scores(tx, tw, "bfloat16")
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dx, dw = torch.autograd.grad(got, (tx, tw), t(g))
    assert dx.dtype == dw.dtype == torch.float32
    _within_one_bf16_ulp(n(dx), jdx)
    _within_one_bf16_ulp(n(dw), jdw)


@pytest.mark.parametrize("use_cov", [True, False], ids=["cov", "no_cov"])
def test_bf16_attention_backward_matches_jax_bwd(use_cov):
    """_attention_bwd_plain on a bf16 encoder stream against the JAX
    package's custom_vjp backward (pallas_attention._bwd, jax.vjp of the
    formula): d_es and d_ef in bf16 (the primal's dtype) within one bf16
    ulp, d_df, d_cov, d_v, d_w_c in f32 within 1e-5 * max(1, max|g|).
    Ragged rows, row 1 fully masked (zero gradients)."""
    rng = np.random.RandomState(7)
    B, T, D = 3, 19, 16
    mask = (np.arange(T)[None] < np.array([[13], [T], [T]])).astype(
        np.float32)
    mask[1] = 0.0
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    es16, ef16 = t(f32(B, T, D), torch.bfloat16), t(f32(B, T, D),
                                                    torch.bfloat16)
    df, v, w_c = f32(B, D), f32(D) * 0.3, f32(D) * 0.3
    cov = (rng.rand(B, T) * mask).astype(np.float32)
    g_ctx, g_attn = f32(B, D), f32(B, T)
    jes = jnp.asarray(n(es16.float()), jnp.bfloat16)
    jef = jnp.asarray(n(ef16.float()), jnp.bfloat16)
    ctx, attn = pa._attention_xla(jes, jef, jnp.asarray(mask),
                                  jnp.asarray(df), jnp.asarray(cov),
                                  jnp.asarray(v), jnp.asarray(w_c), use_cov)
    want = pa._bwd(use_cov, (jes, jef, jnp.asarray(mask), jnp.asarray(df),
                             jnp.asarray(cov), jnp.asarray(v),
                             jnp.asarray(w_c)),
                   (jnp.asarray(g_ctx), jnp.asarray(g_attn)))
    want = [w for w in want if w is not None]
    got = fa._attention_bwd_plain(es16, ef16, t(mask), t(df), t(cov), t(v),
                                  t(w_c), t(np.asarray(attn)), t(g_ctx),
                                  t(g_attn), use_cov)
    assert [x.dtype for x in got[:2]] == [torch.bfloat16] * 2
    assert want[0].dtype == want[1].dtype == jnp.bfloat16
    for g, w in zip(got[:2], want[:2]):
        _within_one_bf16_ulp(n(g.float()), np.asarray(w, np.float32))
        assert float(g[1].float().abs().max()) == 0.0
    for g, w in zip(got[2:], want[2:]):
        if not use_cov and g is got[3]:
            continue  # d_cov is not read without coverage (JAX gives its
            # formula's value, the port zeros)
        assert _scaled_err(n(g), w) <= 1e-5


def _gap_bound(j16, j32):
    """BF16_GAP_FACTOR times JAX's bf16-to-f32 distance, with an f32 floor
    of 1e-5 * max(1, max|x|)."""
    gap = float(np.max(np.abs(np.asarray(j16, np.float64)
                              - np.asarray(j32, np.float64))))
    return BF16_GAP_FACTOR * gap + 1e-5 * max(1.0, float(np.max(np.abs(j16))))


@pytest.mark.parametrize("chunk", [0, 3], ids=["materialised", "chunk3"])
def test_bf16_pointer_generator_loss_and_grads_match_jax(chunk):
    """compute_dtype=bfloat16 (pointer-generator, coverage on): the loss
    and every gradient within BF16_GAP_FACTOR times the JAX package's own
    f32-to-bf16 distance (module docstring).  The encoder states and
    features are bf16, and so are their gradients through the fused
    attention's Function, accumulated over the decoder steps in bf16 as
    JAX's scan transpose accumulates a bf16 primal's cotangent."""
    res = {}
    for dt in ("float32", "bfloat16"):
        jhps, thps = hps_pair(compute_dtype=dt, loss_chunk=chunk)
        p = numpy_params(thps, VSIZE, 3)
        arrays = batch_arrays(thps, 0)
        res[dt] = (jax_loss_and_grads("pointer_generator", jhps, p, arrays),
                   port_loss_and_grads("pointer_generator", thps, p, arrays))
    (j32, jg32), _ = res["float32"]
    (j16, jg16), (t16, tg16) = res["bfloat16"]
    assert j16 != j32  # bf16 really changed the result
    assert abs(t16 - j16) <= _gap_bound([j16], [j32])
    for tg, jg, jg_f in zip(tg16, jg16, jg32):
        assert np.max(np.abs(tg - jg)) <= _gap_bound(jg, jg_f)


def test_bf16_encoder_streams_and_their_gradients_are_bf16():
    """Under bf16 the encoder states and features are bf16 tensors; the
    gradients autograd sums into them over the decoder steps are bf16
    (the dtype JAX keeps for the cotangent of a bf16 value closed over
    by its decoder scan)."""
    _, thps = hps_pair(compute_dtype="bfloat16")
    p = from_numpy_tree(numpy_params(thps, VSIZE, 3))
    arrays = _to_device(batch_arrays(thps, 0), "cpu")
    enc = tpg.encode(p, thps, arrays["enc_batch"], arrays["enc_lens"],
                     arrays["enc_padding_mask"])
    assert enc.enc_states.dtype == enc.enc_features.dtype == torch.bfloat16
    assert enc.dec_in_state[0].dtype == torch.float32
    seen = []
    orig = fa.FusedAttention.backward

    def spy(ctx, g_ctx, g_attn):
        out = orig(ctx, g_ctx, g_attn)
        seen.append((out[0].dtype, out[1].dtype))
        return out

    for x in tree_leaves(p):
        x.requires_grad_(True)
    fa.FusedAttention.backward = staticmethod(spy)
    try:
        out = tpg.forward_train(p, thps, arrays)
        torch.autograd.grad(out.total_loss, tree_leaves(p))
    finally:
        fa.FusedAttention.backward = staticmethod(orig)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * thps.max_dec_steps


def test_bf16_beam_decode_tokens_match_jax():
    """--mode=decode --compute_dtype=bfloat16: the port's beam search
    gives the JAX package's tokens.  Both start from one sharpened numpy
    checkpoint (decode_params), so that the beams do not split on
    rounding."""
    jhps, thps = make_hps(compute_dtype="bfloat16", coverage=True)
    p = decode_params(thps, VSIZE)
    rng = np.random.RandomState(8)
    B, T = thps.batch_size, thps.max_enc_steps
    lens = np.array([T, T - 7])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    ids = np.where(mask > 0, rng.randint(4, VSIZE, (B, T)), 1)
    ext = np.where((rng.rand(B, T) < 0.3) & (mask > 0),
                   VSIZE + rng.randint(0, 4, (B, T)), ids)
    arrays = dict(enc_batch=ids.astype(np.int32),
                  enc_lens=lens.astype(np.int32), enc_padding_mask=mask,
                  enc_batch_extend_vocab=ext.astype(np.int32))
    got = beam_search.run_beam_search(from_numpy_tree(p), thps, arrays)
    want = jbeam.run_beam_search(
        jax.tree_util.tree_map(jnp.asarray, p), jhps,
        {k: jnp.asarray(v) for k, v in arrays.items()})
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length, np.asarray(want.length))


# ---------------------------------------------------------------------------
# bf16 Adagrad state
# ---------------------------------------------------------------------------

def test_bf16_opt_state_dtypes():
    """--opt_state_dtype=bfloat16: bf16 accumulators, f32 params, before
    and after a step."""
    _, thps = hps_pair(opt_state_dtype="bfloat16")
    state = trainer.init_train_state(thps, VSIZE,
                                     params=numpy_params(thps, VSIZE, 0))
    assert {a.dtype for a in tree_leaves(state.opt_state.accumulators)} == \
        {torch.bfloat16}
    state, m = trainer.train_step(thps, state,
                                  _to_device(batch_arrays(thps, 0), "cpu"))
    assert np.isfinite(float(m.loss))
    assert {a.dtype for a in tree_leaves(state.opt_state.accumulators)} == \
        {torch.bfloat16}
    assert {x.dtype for x in tree_leaves(state.params)} == {torch.float32}


@pytest.mark.parametrize("inplace", [True, False], ids=["update", "step"])
def test_f32_adagrad_unchanged_bit_for_bit(inplace):
    """With f32 accumulators the storage-aware update is the f32 formula
    of the port before bf16 state (two foreach ops), bit for bit, in
    place (adagrad_update) and out of place (adagrad_step)."""
    rng = np.random.RandomState(9)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    ps = [t(rng.randn(*s).astype(np.float32)) for s in shapes]
    gs = [t(rng.randn(*s).astype(np.float32)) for s in shapes]
    params = {"a": ps[0], "b": ps[1], "c": [ps[2]]}
    state = optim.adagrad_init(params, 0.1)
    ref_p = [p.clone() for p in ps]
    ref_a = [torch.full_like(p, 0.1) for p in ps]
    torch._foreach_addcmul_(ref_a, gs, gs)
    torch._foreach_addcmul_(ref_p, gs, torch._foreach_rsqrt(ref_a),
                            value=-0.15)
    if inplace:
        optim.adagrad_update(gs, state, params, 0.15)
        new_p, new_a = params, state.accumulators
    else:
        new_p, new_state = optim.adagrad_step(gs, state, params, 0.15)
        new_a = new_state.accumulators
        assert all(torch.equal(a, torch.full_like(a, 0.1))
                   for a in tree_leaves(state.accumulators))
    for got, want in zip(tree_leaves(new_p), ref_p):
        assert torch.equal(got, want)
    for got, want in zip(tree_leaves(new_a), ref_a):
        assert torch.equal(got, want)


def test_bf16_opt_state_n_step_drift_tracks_jax():
    """N = 10 train steps with bf16 accumulators, port and JAX package, on
    one batch (as the JAX package's drift test): every param and
    accumulator within
    BF16_GAP_FACTOR times the JAX package's own distance between its
    bf16-state and f32-state runs, and the bf16 run still learning."""
    jhps, thps = hps_pair(opt_state_dtype="bfloat16")
    p = numpy_params(thps, VSIZE, 1)
    batches = [batch_arrays(thps, 1)] * 10
    runs = {}
    for dt in ("float32", "bfloat16"):
        jh = jhps.replace(opt_state_dtype=dt)
        js = jtrainer.init_train_state(
            jh, VSIZE, params=jax.tree_util.tree_map(jnp.asarray, p))
        step = jax.jit(jtrainer.make_train_step(jh))
        for arrays in batches:
            js, jm = step(js, {k: jnp.asarray(v) for k, v in arrays.items()})
        runs[dt] = js
    state = trainer.init_train_state(thps, VSIZE, params=p)
    losses_seen = []
    for arrays in batches:
        state, m = trainer.train_step(thps, state, _to_device(arrays, "cpu"))
        losses_seen.append(float(m.loss))
    assert losses_seen[-1] < losses_seen[0]
    for tree in ("params", "acc"):
        get = (lambda s: s.params) if tree == "params" else \
            (lambda s: s.opt_state.accumulators)
        got = [n(x.float()) for x in tree_leaves(get(state))]
        j16 = [np.asarray(x, np.float32)
               for x in jax.tree_util.tree_leaves(get(runs["bfloat16"]))]
        j32 = [np.asarray(x, np.float32)
               for x in jax.tree_util.tree_leaves(get(runs["float32"]))]
        for g, w16, w32 in zip(got, j16, j32):
            assert np.max(np.abs(g - w16)) <= _gap_bound(w16, w32)


def test_bf16_opt_state_checkpoint_renarrows_and_cross_loads(tmp_path):
    """npz has no bf16: both packages widen bf16 accumulators to f32 on
    save (exactly) and narrow them again on resume.  A port checkpoint
    restores in the JAX package and a JAX checkpoint in the port, with
    the same values, in bf16 once each Trainer has narrowed them."""
    jhps, thps = hps_pair(opt_state_dtype="bfloat16", log_root=str(tmp_path))
    p = numpy_params(thps, VSIZE, 0)
    arrays = batch_arrays(thps, 0)
    state, _ = trainer.train_step(
        thps, trainer.init_train_state(thps, VSIZE, params=p),
        _to_device(arrays, "cpu"))
    want = [n(a.float()) for a in tree_leaves(state.opt_state.accumulators)]
    ckpt_lib.Checkpointer(str(tmp_path / "port"), hps=thps).save(state)
    on_disk = ckpt_lib.load_arrays(str(tmp_path / "port" /
                                       "model.ckpt-1.npz"))
    assert all(v.dtype != np.dtype("V2") for v in on_disk.values())
    # the port's checkpoint in the JAX package
    jr = jckpt.Checkpointer(str(tmp_path / "port"), hps=jhps).restore()
    jr = jtrainer.cast_opt_state(jhps, jr)
    for a, w in zip(jax.tree_util.tree_leaves(jr.opt_state.accumulators),
                    want):
        assert a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32), w)
    # a JAX checkpoint in the port
    js, _ = jax.jit(jtrainer.make_train_step(jhps))(
        jtrainer.init_train_state(jhps, VSIZE, params=jax.tree_util.tree_map(
            jnp.asarray, p)), {k: jnp.asarray(v) for k, v in arrays.items()})
    jckpt.Checkpointer(str(tmp_path / "jax"), hps=jhps).save(js)
    restored = ckpt_lib.Checkpointer(str(tmp_path / "jax")).restore()
    assert {a.dtype for a in tree_leaves(restored.opt_state.accumulators)} \
        == {torch.float32}
    tr = trainer.Trainer(thps, VSIZE, batcher=None, state=restored,
                         train_dir=str(tmp_path / "t"))
    for a, w in zip(tree_leaves(tr.state.opt_state.accumulators),
                    jax.tree_util.tree_leaves(js.opt_state.accumulators)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(n(a.float()),
                                      np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["pointer_generator", "transformer"])
def test_remat_gives_the_same_gradients(family):
    """--remat recomputes (the pointer-generator's hoisted scores and loss,
    each transformer layer) in the backward: the same operations on the
    same values, so the loss and every gradient equal those without it,
    bit for bit on the CPU; and both equal the JAX package's --remat
    within 1e-5."""
    jhps, thps = hps_pair(family, remat=True)
    p = numpy_params(thps, VSIZE, 3)
    arrays = batch_arrays(thps, 0)
    r_loss, r_grads = port_loss_and_grads(family, thps, p, arrays)
    loss, grads = port_loss_and_grads(family, thps.replace(remat=False), p,
                                      arrays)
    assert r_loss == loss
    for a, b in zip(r_grads, grads):
        np.testing.assert_array_equal(a, b)
    j_loss, j_grads = jax_loss_and_grads(family, jhps, p, arrays)
    assert abs(r_loss - j_loss) <= 1e-5 * max(1.0, abs(j_loss))
    for a, b in zip(r_grads, j_grads):
        assert _scaled_err(a, b) <= 1e-5


def test_remat_reruns_each_flash_forward_once_in_the_backward(monkeypatch):
    """A non-reentrant checkpoint reruns each layer's forward when the
    backward needs its saved tensors, so under --remat a transformer
    train step calls the flash forward twice per layer (the dK/dV and dQ
    once): what chip_smoke.expected_train_launches counts on the card.
    Counted here through the plain versions the CPU runs."""
    _, thps = hps_pair("transformer", remat=True)
    calls = dict(forward=0, backward=0)
    fwd, bwd = fl._flash_plain, fl._flash_bwd_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fl, "_flash_plain", count("forward", fwd))
    monkeypatch.setattr(fl, "_flash_bwd_plain", count("backward", bwd))
    state = trainer.init_train_state(thps, VSIZE,
                                     params=numpy_params(thps, VSIZE, 0))
    trainer.train_step(thps, state, _to_device(batch_arrays(thps, 0), "cpu"))
    want = chip_smoke.expected_train_launches(thps, 1)
    assert calls["forward"] == want["flash_forward"] == \
        2 * (thps.enc_layers + thps.dec_layers)
    assert calls["backward"] == want["flash_bwd_dkv"] == \
        want["flash_bwd_dq"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("loss_chunk", -1), ("opt_state_dtype", "fp8"),
    ("steps_per_dispatch", 0), ("nan_skip_steps", -1),
    ("nan_max_rollbacks", -1), ("nan_lr_cut", 0.0), ("nan_lr_cut", 1.5),
    ("compute_dtype", "fp16"), ("faults", "nope.point:1.0:0"),
    ("faults", "train.step_nan:2.0:0"), ("faults", "train.step_nan:1.0"),
])
def test_config_validation_matches_jax(field, value):
    """The new fields refuse what the JAX package's validate refuses, with
    a ValueError naming the field or the point."""
    with pytest.raises(ValueError):
        jax_config.HParams(**{field: value}).validate()
    with pytest.raises(ValueError):
        torch_config.HParams(**{field: value}).validate()


def test_new_flags_parse_like_jax():
    """The new flags ride the reference's argv surface in both packages
    (so the pipeline's set_train_hyper_params carries them), and their
    defaults are the JAX package's."""
    argv = ("--loss_chunk=25 --opt_state_dtype=bfloat16 --remat=1 "
            "--compute_dtype=bfloat16 --metrics_every=4 "
            "--steps_per_dispatch=3 --profile_dir=/p "
            "--faults=train.step_nan:1.0:7:3 --nan_skip_steps=2 "
            "--nan_max_rollbacks=1 --nan_lr_cut=0.25").split()
    j = jax_config.HParams.from_argv(argv)
    tt = torch_config.HParams.from_argv(argv)
    fields = ("loss_chunk", "opt_state_dtype", "remat", "compute_dtype",
              "metrics_every", "steps_per_dispatch", "profile_dir", "faults",
              "nan_skip_steps", "nan_max_rollbacks", "nan_lr_cut")
    for f in fields:
        assert getattr(tt, f) == getattr(j, f), f
        assert getattr(torch_config.HParams(), f) == \
            getattr(jax_config.HParams(), f), f
    tt.validate()
    assert torch_config.HParams.from_string(tt.to_argv()) == tt
