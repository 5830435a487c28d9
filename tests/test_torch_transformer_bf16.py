"""The port's transformer under ``--compute_dtype=bfloat16`` against the
JAX package's, on the CPU: the flash self-attention's plain bf16
versions (forward and backward) against the JAX ``_mha`` in bf16 and the
library Pallas flash kernel (interpret mode, as
tests/test_torch_flash_attention.py runs it), the model's loss and
gradients, beam decode, the KV cache's dtype, ``--remat`` and the CLI.

Sizes: hidden 32 (2 heads of 16 and 4 heads of 8), T 24-40, 2 + 2
layers; the same numpy inputs and params through both packages.

Tolerances:
  * the flash forward and backward: within FLASH_BF16_ULPS bf16 units in
    the last place of the tensor's largest |value|.  Both packages round
    to bf16 at the same points of the formula (P before P V, dS before
    dK and dQ, each output once) but form the f32 values before each
    rounding with sums in other orders, and the einsum path ``_mha``
    rounds the normalised P where the library (and the port) rounds
    exp(s - m) and divides after;
  * the model end to end (the loss and every gradient): within
    BF16_GAP_FACTOR times the JAX package's own distance between its
    bf16 and f32 results, per leaf (tests/test_torch_byte_diet.py's rule:
    XLA keeps fused bf16 intermediates in f32 where PyTorch rounds each
    operation, so the two bf16 results differ by about as much as bf16
    differs from f32);
  * beam tokens: equal, from a sharpened checkpoint (a wide tied
    embedding), so that the beams do not split on rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import WORDS, abstract, article, make_hps, n, t
from test_torch_byte_diet import (
    _gap_bound,
    batch_arrays,
    hps_pair,
    jax_loss_and_grads,
    port_loss_and_grads,
)
from textsummarization_on_flink_tpu.config import HParams as JaxHParams
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu.models import transformer as jtfm
from textsummarization_on_flink_tpu_torch import cli
from textsummarization_on_flink_tpu_torch import config as torch_config
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data import chunks
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode.beam_search import _to_device
from textsummarization_on_flink_tpu_torch.models import transformer as tfm
from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
    tree_leaves,
)
from textsummarization_on_flink_tpu_torch.train import trainer

FLASH_BF16_ULPS = 2
BF16 = torch.bfloat16
VSIZE = len(WORDS) + 4


def _assert_within_ulps(got, want, ulps=FLASH_BF16_ULPS):
    """|got - want| <= ulps bf16 ulps of max|want| (8 significant bits:
    2^-7 of the largest value's power of two)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    top = float(np.max(np.abs(want)))
    bound = ulps * float(np.ldexp(1.0, np.frexp(top)[1] - 8)) if top else 0.0
    err = float(np.max(np.abs(got - want)))
    assert err <= bound, (err, bound)


def _inputs(B, T, H, seed, empty=True):
    """x [B, T, H] as bf16 values, a ragged key mask (article 1 fully
    masked when ``empty``, else ragged), and the attention weights."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, T, H) * 0.5).astype(np.float32)
    x = n(t(x).to(BF16).float())
    lens = rng.randint(T // 3, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    if empty:
        mask[1] = 0.0
    else:
        mask[1] = (np.arange(T) < T - 9).astype(np.float32)
    p = {k: (rng.randn(H, H) * 0.3).astype(np.float32)
         for k in ("wq", "wk", "wv")}
    p["wo"] = np.eye(H, dtype=np.float32)  # the output is the context
    return x, mask, p


def _jax_qkv(jhps, x, p):
    """q, k, v as the JAX package projects them in bf16 ([B, T, nh, hd]),
    as numpy f32 values (exactly bf16)."""
    xb = jnp.asarray(x, jnp.bfloat16)
    return [np.asarray(jtfm._split_heads(jhps, xb @ jnp.asarray(
        p[w]).astype(jnp.bfloat16)), np.float32) for w in ("wq", "wk", "wv")]


def _mha_mask(mask, T, causal):
    jm = jnp.asarray(mask)[:, None, :]
    if causal:
        jm = jm * jnp.tril(jnp.ones((T, T), jnp.float32))[None]
    return jm


# ---------------------------------------------------------------------------
# (a), (b): the flash plain versions in bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,nh", [(3, 24, 32, 2), (3, 40, 32, 4)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_bf16_matches_jax_mha_on_all_rows(B, T, H, nh, causal):
    """_flash_plain on bf16 q, k, v (the JAX package's own bf16
    projections) against the JAX ``_mha`` in bf16 through an identity
    ``wo``: every row, a ragged key mask with one fully masked article
    (exact zeros), combined with the causal triangle."""
    x, mask, p = _inputs(B, T, H, seed=T + nh)
    jhps = JaxHParams(hidden_dim=H, num_heads=nh, compute_dtype="bfloat16")
    hps = HParams(hidden_dim=H, num_heads=nh, device="cpu")
    xb = jnp.asarray(x, jnp.bfloat16)
    want, _ = jtfm._mha(jhps, p, xb, xb, _mha_mask(mask, T, causal))
    assert want.dtype == jnp.bfloat16
    q, k, v = (t(a, BF16) for a in _jax_qkv(jhps, x, p))
    got = fl._flash_plain(q, k, v, t(mask), causal, (H // nh) ** -0.5)
    assert got.dtype == BF16
    got = n(tfm._merge_heads(got).float())
    _assert_within_ulps(got, np.asarray(want, np.float32))
    assert not got[1].any()


def _library_flash(q, k, v, mask, causal, sm_scale):
    """The library Pallas kernel in interpret mode on [B, T, nh, hd]
    bf16 arrays, through a function of (q, k, v) whose vjp is the
    library's backward kernels: T and hd zero-padded to 128 and padding
    keys in their own segment, as the JAX transformer calls it
    (models/transformer.py:256-290)."""
    from jax.experimental.pallas.ops.tpu import flash_attention as lib

    B, T, nh, hd = q.shape
    t_pad, hd_pad = -T % 128, -hd % 128
    ids = None
    if not causal:
        pm = jnp.pad(jnp.asarray(mask), [(0, 0), (0, t_pad)])
        ids = lib.SegmentIds(q=(pm <= 0).astype(jnp.int32),
                             kv=(pm <= 0).astype(jnp.int32))

    def f(q, k, v):
        xs = [jnp.pad(jnp.swapaxes(a, 1, 2),
                      [(0, 0), (0, 0), (0, t_pad), (0, hd_pad)])
              for a in (q, k, v)]
        out = lib.flash_attention(*xs, segment_ids=ids, causal=causal,
                                  sm_scale=sm_scale)
        return jnp.swapaxes(out[:, :, :T, :hd], 1, 2)

    return f


def _has_force_tpu_interpret():
    from jax.experimental.pallas import tpu as pltpu

    return hasattr(pltpu, "force_tpu_interpret_mode")


@pytest.mark.parametrize("nh", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_bf16_matches_jax_flash_kernel_interpret(nh, causal):
    """The forward and the backward on bf16 inputs against the library
    kernel in interpret mode and its custom_vjp (the dK/dV and dQ
    kernels), on the real rows: non-causal with a ragged key mask (a
    padding row attends padding keys in the library, the real keys in
    the port, so only real rows and their gradients compare: the
    cotangent is zero on padding rows), causal on every row."""
    if not _has_force_tpu_interpret():
        pytest.skip("pltpu.force_tpu_interpret_mode is absent from this jax")
    from jax.experimental.pallas import tpu as pltpu

    B, T, H = 2, 40, 32
    hd = H // nh
    x, mask, p = _inputs(B, T, H, seed=3 + nh, empty=False)
    jhps = JaxHParams(hidden_dim=H, num_heads=nh)
    q, k, v = _jax_qkv(jhps, x, p)
    real = np.ones((B, T, 1, 1), np.float32) if causal \
        else mask[:, :, None, None]
    rng = np.random.RandomState(9)
    do = (rng.randn(B, T, nh, hd) * real).astype(np.float32)
    do = n(t(do).to(BF16).float())
    scale = hd ** -0.5
    f = _library_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                       mask, causal, scale)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(f, *(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)))
        w_grads = vjp(jnp.asarray(do, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    qt, kt, vt = (t(a, BF16) for a in (q, k, v))
    km = None if causal else t(mask)
    got = fl._flash_plain(qt, kt, vt, km, causal, scale)
    _assert_within_ulps(n(got.float()) * real,
                        np.asarray(want, np.float32) * real)
    lse = fl._flash_lse_plain(qt, kt, km, causal, scale)
    g_grads = fl._flash_bwd_plain(qt, kt, vt, got, lse, t(do, BF16), km,
                                  causal, scale)
    for g, w in zip(g_grads, w_grads):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        _assert_within_ulps(n(g.float()), np.asarray(w, np.float32))


@pytest.mark.parametrize("B,T,H,nh", [(3, 24, 32, 2), (2, 33, 32, 4)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_bf16_matches_jax_mha_vjp(B, T, H, nh, causal):
    """_flash_bwd_plain on bf16 inputs against jax.vjp of the JAX
    ``_mha`` in bf16 with identity weights, whose k and v are one input
    (kv_in): the port's dq against d q_in, its dk + dv against d kv_in,
    every row, one article fully masked (zero gradients)."""
    x, mask, _ = _inputs(B, T, H, seed=7 + T)
    rng = np.random.RandomState(T)
    kv = n(t((rng.randn(B, T, H) * 0.5).astype(np.float32)).to(BF16).float())
    do = n(t(rng.randn(B, T, H).astype(np.float32)).to(BF16).float())
    eye = {w: np.eye(H, dtype=np.float32) for w in ("wq", "wk", "wv", "wo")}
    jhps = JaxHParams(hidden_dim=H, num_heads=nh, compute_dtype="bfloat16")
    jm = _mha_mask(mask, T, causal)
    (want, _), vjp = jax.vjp(
        lambda a, b: jtfm._mha(jhps, eye, a, b, jm),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16))
    d_q, d_kv = vjp((jnp.asarray(do, jnp.bfloat16),
                     jnp.zeros(jm.shape[:1] + (T, T), jnp.float32)))
    hps = HParams(hidden_dim=H, num_heads=nh, device="cpu")
    q = tfm._split_heads(hps, t(x, BF16))
    k = v = tfm._split_heads(hps, t(kv, BF16))
    scale = (H // nh) ** -0.5
    out = fl._flash_plain(q, k, v, t(mask), causal, scale)
    _assert_within_ulps(n(tfm._merge_heads(out).float()),
                        np.asarray(want, np.float32))
    lse = fl._flash_lse_plain(q, k, t(mask), causal, scale)
    dq, dk, dv = fl._flash_bwd_plain(q, k, v, out,
                                     lse, tfm._split_heads(hps, t(do, BF16)),
                                     t(mask), causal, scale)
    assert dq.dtype == dk.dtype == dv.dtype == BF16
    _assert_within_ulps(n(tfm._merge_heads(dq).float()),
                        np.asarray(d_q, np.float32))
    _assert_within_ulps(n(tfm._merge_heads(dk.float() + dv.float())),
                        np.asarray(d_kv, np.float32))
    assert not n(dq.float())[1].any() and not n(dk.float())[1].any()


def test_flash_function_bf16_returns_bf16_gradients():
    """The autograd Function on bf16 CPU tensors: the plain versions
    forward and backward, bf16 out and gradients, equal to the plain
    backward called directly; no kernel launch counted."""
    x, mask, p = _inputs(2, 24, 32, seed=1)
    jhps = JaxHParams(hidden_dim=32, num_heads=2)
    q, k, v = (t(a, BF16).requires_grad_() for a in _jax_qkv(jhps, x, p))
    before = (fl.launches, fl.launches_bf16, fl.launches_bwd_dkv_bf16)
    out = fl.flash_attention(q, k, v, t(mask), False, 0.25)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, (q, k, v), do.to(BF16))
    assert (fl.launches, fl.launches_bf16, fl.launches_bwd_dkv_bf16) == before
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in got)
    qd, kd, vd = (a.detach() for a in (q, k, v))
    lse = fl._flash_lse_plain(qd, kd, t(mask), False, 0.25)
    want = fl._flash_bwd_plain(qd, kd, vd, out.detach(), lse, do.to(BF16),
                               t(mask), False, 0.25)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# (c), (f): the model's loss and gradients, --loss_chunk, --remat
# ---------------------------------------------------------------------------

TF = dict(hidden_dim=32, num_heads=2)


@pytest.mark.parametrize("chunk", [0, 3], ids=["materialised", "chunk3"])
@pytest.mark.parametrize("nh", [2, 4])
def test_bf16_transformer_loss_and_grads_match_jax(chunk, nh):
    """compute_dtype=bfloat16, the transformer (coverage on): the loss and
    every gradient within BF16_GAP_FACTOR times the JAX package's own
    f32-to-bf16 distance, materialised and with --loss_chunk=3."""
    res = {}
    for dt in ("float32", "bfloat16"):
        jhps, thps = hps_pair("transformer", compute_dtype=dt,
                              loss_chunk=chunk, hidden_dim=32, num_heads=nh)
        p = init_numpy_params(thps, VSIZE, 3)
        arrays = batch_arrays(thps, 0)
        res[dt] = (jax_loss_and_grads("transformer", jhps, p, arrays),
                   port_loss_and_grads("transformer", thps, p, arrays))
    (j32, jg32), (t32, _) = res["float32"]
    (j16, jg16), (t16, tg16) = res["bfloat16"]
    assert j16 != j32 and t16 != t32  # bf16 really changed the result
    assert abs(t16 - j16) <= _gap_bound([j16], [j32])
    assert len(tg16) == len(jg16)
    for tg, jg, jg_f in zip(tg16, jg16, jg32):
        assert tg.dtype == np.float32  # f32 master params, f32 gradients
        assert np.max(np.abs(tg - jg)) <= _gap_bound(jg, jg_f)


def test_bf16_transformer_remat_same_gradients_and_flash_reruns(monkeypatch):
    """--remat in bf16: the loss and every gradient equal those without it,
    bit for bit on the CPU, and a train step calls the flash forward twice
    per layer (the backward once), as chip_smoke.expected_train_launches
    counts on the card, all on bf16 inputs."""
    _, thps = hps_pair("transformer", compute_dtype="bfloat16", remat=True,
                       **TF)
    p = init_numpy_params(thps, VSIZE, 3)
    arrays = batch_arrays(thps, 0)
    r_loss, r_grads = port_loss_and_grads("transformer", thps, p, arrays)
    loss, grads = port_loss_and_grads("transformer",
                                      thps.replace(remat=False), p, arrays)
    assert r_loss == loss
    for a, b in zip(r_grads, grads):
        np.testing.assert_array_equal(a, b)
    calls = dict(forward=[], backward=[])
    fwd, bwd = fl._flash_plain, fl._flash_bwd_plain

    def count(name, fn):
        def wrapped(q, *a, **k):
            calls[name].append(q.dtype)
            return fn(q, *a, **k)
        return wrapped

    monkeypatch.setattr(fl, "_flash_plain", count("forward", fwd))
    monkeypatch.setattr(fl, "_flash_bwd_plain", count("backward", bwd))
    state = trainer.init_train_state(thps, VSIZE, params=p)
    trainer.train_step(thps, state, _to_device(arrays, "cpu"))
    want = chip_smoke.expected_train_launches(thps, 1)
    layers = thps.enc_layers + thps.dec_layers
    assert len(calls["forward"]) == want["flash_forward"] == \
        want["flash_forward_bf16"] == 2 * layers
    assert len(calls["backward"]) == want["flash_bwd_dkv_bf16"] == layers
    assert set(calls["forward"]) == set(calls["backward"]) == {BF16}


def test_bf16_train_step_keeps_f32_params_and_learns():
    """A few bf16 train steps (streaming loss): f32 params and Adagrad
    state, finite losses that fall on one repeated batch."""
    _, thps = hps_pair("transformer", compute_dtype="bfloat16", loss_chunk=4,
                       **TF)
    state = trainer.init_train_state(thps, VSIZE,
                                     params=init_numpy_params(thps, VSIZE, 0))
    arrays = _to_device(batch_arrays(thps, 1), "cpu")
    losses = []
    for _ in range(4):
        state, m = trainer.train_step(thps, state, arrays)
        losses.append(float(m.loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert {x.dtype for x in tree_leaves(state.params)} == {torch.float32}


# ---------------------------------------------------------------------------
# (d), (e): beam decode and the KV cache
# ---------------------------------------------------------------------------

def _tf_decode_hps(**kw):
    return make_hps(**dict(dict(model_family="transformer", hidden_dim=32,
                                num_heads=4, enc_layers=2, dec_layers=2,
                                batch_size=3, compute_dtype="bfloat16"), **kw))


def _tf_decode_params(thps, seed=11):
    """A sharpened checkpoint (tests/test_torch_transformer.py's): a wide
    tied embedding and a STOP bias."""
    p = init_numpy_params(thps, VSIZE, seed)
    p["embedding"] *= 30.0
    p["out_bias"][3] = 3.0  # STOP_ID
    return p


def _decode_batch(jhps, thps, n_articles):
    from textsummarization_on_flink_tpu.data import batching as jb
    from textsummarization_on_flink_tpu.data.vocab import Vocab as JVocab
    from textsummarization_on_flink_tpu_torch.data import batching as tb
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab

    jv, tv = JVocab(words=WORDS), Vocab(words=WORDS)
    jex = [jb.SummaryExample.build(article(i), [abstract(i)], jv, jhps)
           for i in range(n_articles)]
    tex = [tb.SummaryExample.build(article(i), [abstract(i)], tv, thps)
           for i in range(n_articles)]
    return jb.Batch(jex, jhps, jv).as_arrays(), \
        tb.Batch(tex, thps, tv).as_arrays()


@pytest.mark.parametrize("pointer_gen,beam_size", [(True, 3), (False, 3),
                                                   (True, 1)])
def test_bf16_beam_search_tokens_equal_jax(pointer_gen, beam_size):
    """--mode=decode --compute_dtype=bfloat16 with the transformer: the
    port's beam search gives the JAX package's tokens and lengths from
    one sharpened numpy checkpoint."""
    jhps, thps = _tf_decode_hps(pointer_gen=pointer_gen, beam_size=beam_size)
    ja, ta = _decode_batch(jhps, thps, 3)
    p = _tf_decode_params(thps)
    want = jax_bs.run_beam_search(p, jhps, ja)
    got = beam_search.run_beam_search(from_numpy_tree(p), thps, ta)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length, np.asarray(want.length))


def test_bf16_kv_cache_is_float32_holding_bf16_values():
    """Under bf16 compute the decode KV cache is float32 (the JAX
    package's cache_dtype without --decode_cache_dtype=bfloat16), before
    and after a step; the written positions hold the bf16 projections
    widened exactly; the encoder view's cross K/V are bf16.  With
    --decode_cache_dtype=bfloat16 the cache holds the same values in
    bf16, so the step's outputs are the f32 cache's, bit for bit."""
    _, thps = _tf_decode_hps()
    p = from_numpy_tree(_tf_decode_params(thps))
    _, ta = _decode_batch(thps, thps, 3)
    arrays = _to_device(ta, "cpu")
    enc = tfm.beam_encode(p, thps, arrays)
    assert enc.cross_k.dtype == enc.cross_v.dtype == BF16
    init_state, step = tfm.beam_adapter(thps)
    state = init_state(p, enc)
    assert {x.dtype for x in state.values()} == {torch.float32}
    B, K = 3, thps.beam_size
    latest = torch.full((B, K), 2, dtype=torch.long)
    out = step(p, enc, arrays["enc_padding_mask"],
               arrays["enc_batch_extend_vocab"], torch.zeros(B, dtype=torch.long),
               latest, state)
    for x in out.state.values():
        assert x.dtype == torch.float32
        first = x[:, :, :, 0]
        assert first.abs().max() > 0
        assert torch.equal(first.to(BF16).float(), first)
    assert out.topk_log_probs.dtype == torch.float32
    bhps = thps.replace(decode_cache_dtype="bfloat16")
    bhps.validate()
    binit, bstep = tfm.beam_adapter(bhps)
    bout = bstep(p, enc, arrays["enc_padding_mask"],
                 arrays["enc_batch_extend_vocab"],
                 torch.zeros(B, dtype=torch.long), latest, binit(p, enc))
    for name, x in bout.state.items():
        assert x.dtype == BF16
        assert torch.equal(x.float(), out.state[name])
    assert torch.equal(bout.topk_log_probs, out.topk_log_probs)
    assert torch.equal(bout.topk_ids, out.topk_ids)


def test_bf16_beam_adapter_step_matches_jax():
    """One beam step in bf16 (the first, from each article's encoder
    view): the top-k log-probs within BF16_GAP_FACTOR times the JAX
    package's own bf16-to-f32 distance, and the same best id.  The ids
    further down are not compared: their log-probs lie closer together
    than bf16 moves them (the JAX package's own bf16 step orders two of
    them otherwise than its f32 step)."""
    res = {}
    for dt in ("float32", "bfloat16"):
        jhps, thps = _tf_decode_hps(compute_dtype=dt)
        p = _tf_decode_params(thps)
        ja, ta = _decode_batch(jhps, thps, 3)
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        jarr = {k: jnp.asarray(v) for k, v in ja.items()}
        jenc = jtfm.beam_encode(jp, jhps, jarr)
        j_init, j_step = jtfm.beam_adapter(jhps)
        j_out = []
        for b in range(3):
            one = jax.tree_util.tree_map(lambda a, b=b: a[b], jenc)
            o = j_step(jp, one, jarr["enc_padding_mask"][b],
                       jarr["enc_batch_extend_vocab"][b], jnp.asarray(0),
                       jnp.full((thps.beam_size,), 2, jnp.int32),
                       j_init(jp, one))
            j_out.append((np.asarray(o.topk_ids),
                          np.asarray(o.topk_log_probs)))
        tp = from_numpy_tree(p)
        arrays = _to_device(ta, "cpu")
        enc = tfm.beam_encode(tp, thps, arrays)
        init_state, step = tfm.beam_adapter(thps)
        o = step(tp, enc, arrays["enc_padding_mask"],
                 arrays["enc_batch_extend_vocab"],
                 torch.zeros(3, dtype=torch.long),
                 torch.full((3, thps.beam_size), 2, dtype=torch.long),
                 init_state(tp, enc))
        res[dt] = (j_out, (n(o.topk_ids), n(o.topk_log_probs)))
    j32 = np.stack([lp for _, lp in res["float32"][0]])
    j16 = np.stack([lp for _, lp in res["bfloat16"][0]])
    ids16 = np.stack([i for i, _ in res["bfloat16"][0]])
    got_ids, got_lp = res["bfloat16"][1]
    np.testing.assert_array_equal(got_ids[..., 0], ids16[..., 0])
    assert np.max(np.abs(got_lp - j16)) <= _gap_bound(j16, j32)


# ---------------------------------------------------------------------------
# (g): the CLI and the config
# ---------------------------------------------------------------------------

def test_validate_takes_the_transformer_in_bf16():
    HParams(model_family="transformer", compute_dtype="bfloat16").validate()
    hps = HParams.from_string("--model_family=transformer "
                              "--compute_dtype=bfloat16 --loss_chunk=10 "
                              "--remat=1")
    hps.validate()
    assert (hps.model_family, hps.compute_dtype) == ("transformer",
                                                     "bfloat16")


def test_cli_trains_evaluates_and_decodes_the_transformer_in_bf16(tmp_path):
    """cli.main --mode=train --model_family=transformer
    --compute_dtype=bfloat16 --device=cpu writes a checkpoint, eval
    scores it (a finite loss, a best model), and --mode=decode decodes
    every article with it."""
    chunks.write_chunk_file(
        str(tmp_path / "train_000.bin"),
        [{"article": [article(i)], "abstract": [abstract(i)]}
         for i in range(4)])
    (tmp_path / "vocab").write_text("".join(f"{w} {100 - i}\n"
                                            for i, w in enumerate(WORDS)))
    (tmp_path / "articles").mkdir()
    for i in range(3):
        (tmp_path / "articles" / f"a{i}.txt").write_text(article(i + 5))
    flags = ["--device=cpu", f"--log_root={tmp_path}",
             f"--vocab_path={tmp_path / 'vocab'}",
             "--model_family=transformer", "--compute_dtype=bfloat16",
             "--hidden_dim=32", "--num_heads=2", "--enc_layers=2",
             "--dec_layers=2", "--batch_size=2", "--max_enc_steps=16",
             "--max_dec_steps=6", "--min_dec_steps=2", "--beam_size=2",
             f"--vocab_size={VSIZE}", "--max_oov_buckets=6"]
    train = [f"--data_path={tmp_path / 'train_*.bin'}"]
    assert cli.main(["--mode=train", "--num_steps=2", "--loss_chunk=3",
                     *train, *flags]) == 0
    train_dir = tmp_path / "exp" / "train"
    assert (train_dir / "model.ckpt-2.npz").exists()
    hps = torch_config.HParams.from_argv(["--mode=eval", *train, *flags])
    assert np.isfinite(cli.run_eval(hps, cli.Vocab(hps.vocab_path,
                                                   hps.vocab_size),
                                    max_iters=1))
    assert list((tmp_path / "exp" / "eval").glob("bestmodel-*.npz"))
    assert cli.main(["--mode=decode", "--inference=1", "--single_pass=1",
                     f"--data_path={tmp_path / 'articles' / '*.txt'}",
                     *flags]) == 0
    decoded = list((tmp_path / "exp").glob("decode*/decoded/*"))
    assert len(decoded) == 3


def test_serving_server_gives_the_jax_summaries_in_bf16(tmp_path):
    """The ServingServer builds the same decoder: a pinned group of 3
    articles (one dispatch, beam tier) through the port's server and the
    JAX package's, the transformer in bf16 from one sharpened numpy
    checkpoint, gives the same summaries."""
    from textsummarization_on_flink_tpu import obs as jax_obs
    from textsummarization_on_flink_tpu.data.vocab import Vocab as JVocab
    from textsummarization_on_flink_tpu.serve.server import (
        ServingServer as JaxServingServer,
    )
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.obs import Registry
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )

    jhps, thps = _tf_decode_hps(serve_buckets="24", serve_max_wait_ms=200.0)
    p = _tf_decode_params(thps)

    def summaries(server):
        futs = [server.submit(article(i), uuid=f"a{i}", tier="beam")
                for i in range(3)]
        with server:
            res = [f.result(timeout=120) for f in futs]
        return {r.uuid: r.decoded_words for r in res}

    want = summaries(JaxServingServer(jhps, JVocab(words=WORDS), params=p,
                                      decode_root=str(tmp_path / "j"),
                                      registry=jax_obs.Registry()))
    got = summaries(ServingServer(thps, Vocab(words=WORDS), params=p,
                                  decode_root=str(tmp_path / "t"),
                                  registry=Registry()))
    assert got == want and any(got.values())
