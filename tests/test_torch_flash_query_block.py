"""The flash attention's plain versions on a block of query rows against
every key (Tq != Tk: one sp rank's block of the encoder's queries, the
form the transformer's and the AAN's encoder take on an sp mesh without
--sp_attention), against the installed jax's reference
``flash_attention.mha_reference_no_custom_vjp``, which takes q and kv of
different lengths, and against ``jax.vjp`` of it.

Inputs from a numpy seed: B = 3 articles, Tk = 24 keys, a block of Tq =
Tk / 2 or Tk / 3 query rows (rows [Tq, 2 Tq) of the article's
queries), 2 heads at head dims 32, 128, 256 and 384 (the backward also
at 1280 and 1920, the head dims of the card's 10- and 15-block
clusters, which no other test reaches), a ragged key mask
(given to the reference as segment ids: query rows 1, real keys 1,
masked keys 0) and article 1 fully masked.  The reference gives a row
with no key to attend the mean of v (a uniform softmax over masked
logits) where the port, like the JAX package's ``_mha``, gives zeros:
that article is held to exact zeros and left out of the comparison.

Tolerances: f32 within 1e-5 of each tensor's largest |value| (only the
order of the sums differs).  bf16 (q, k, v, dO rounded to bf16, the
reference run in f32 on those values): the plain bf16 version rounds P
to bf16 before P V and before dV = P^T dO, dS * scale before dK and dQ,
each output once, and takes D = rowsum(dO * O) from the bf16-rounded
output, each a relative error of at most 2^-9 of the terms it rounds;
so each element is held within 2^-8 of the sum of the absolute terms it
is made of (|P| |V| for the output, |P|^T |dO| for dV, scale |dS|^T |q|
for dK and scale |dS| |k| for dQ, where |dS| stands for P (|dO| . |v| +
|dO| . |out|), the absolute terms of dO . v - D; from the float64
reference) plus 2^-8 of its own size.  The causal form needs as many
query rows as keys: a causal call on a block raises ValueError.  The
rows of a block equal the same rows of the whole attention, and the
blocks' dK and dV summed are the whole attention's (what the
all-gather's reduce-scatter backward adds up over the sp ranks), within
1e-6 of the largest |value|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

B, TK, NH = 3, 24, 2
HEAD_DIMS = (32, 128, 256, 384)
#: clusters of 10 and 15 blocks on the card (hd / 128), the dQ's too;
#: above 2048 the clusters whose blocks own 2 slabs (2176: 9 blocks, the
#: last with one; 2304: 9) and 3 (4224: 11 blocks)
CLUSTER_HEAD_DIMS = (1280, 1920, 2176, 2304, 4224)
RATIOS = (2, 3)  # Tq = TK / ratio
DTYPES = (torch.float32, torch.bfloat16)


def _inputs(hd, tq, seed):
    """q of the block, the whole q, k, v, the block's dO and the key mask
    (numpy f32; bf16 rounding is applied by the caller)."""
    rng = np.random.RandomState(seed)
    q_all, k, v = (rng.randn(B, TK, NH, hd).astype(np.float32)
                   for _ in range(3))
    do = rng.randn(B, tq, NH, hd).astype(np.float32)
    lens = rng.randint(TK // 3, TK + 1, B)
    lens[0] = TK
    mask = (np.arange(TK)[None] < lens[:, None]).astype(np.float32)
    mask[1] = 0.0
    return q_all[:, tq:2 * tq], q_all, k, v, do, mask


def _round(x, dtype):
    """x as the port's tensor of dtype, and its values as f32 numpy."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    return t, t.float().numpy()


def _reference(q, k, v, mask, scale):
    """out [B, Tq, nh, hd] and lse [B, Tq, nh] of the jax reference on
    [B, T, nh, hd] numpy inputs, the key mask as segment ids."""
    tq = q.shape[1]
    seg = jfa.SegmentIds(q=jnp.ones((B, tq), jnp.int32),
                         kv=jnp.asarray(mask, jnp.int32))
    out, l, m = jfa.mha_reference_no_custom_vjp(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        segment_ids=seg, sm_scale=scale, save_residuals=True)
    return (np.asarray(out).transpose(0, 2, 1, 3),
            np.asarray(m + jnp.log(l)).transpose(0, 2, 1))


def _reference_grads(q, k, v, mask, do, scale):
    """(dq, dk, dv) of the reference by jax.vjp, cotangent do."""
    tq = q.shape[1]
    seg = jfa.SegmentIds(q=jnp.ones((B, tq), jnp.int32),
                         kv=jnp.asarray(mask, jnp.int32))

    def f(q, k, v):
        return jfa.mha_reference_no_custom_vjp(q, k, v, segment_ids=seg,
                                               sm_scale=scale)

    tr = [jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)]
    _, vjp = jax.vjp(f, *tr)
    return [np.asarray(g).transpose(0, 2, 1, 3)
            for g in vjp(jnp.asarray(do).transpose(0, 2, 1, 3))]


def _abs_terms(q, k, v, mask, do, scale):
    """float64 sums of the absolute terms each output element is made of:
    |P| |V| (the output), |P|^T |dO| (dV), scale |dS|^T |q| (dK) and
    scale |dS| |k| (dQ), P the normalised probabilities."""
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    s = np.einsum("bqnd,bknd->bnqk", q, k) * scale
    ok = (mask > 0)[:, None, None, :]
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    e = np.where(ok, np.exp(s - m), 0.0)
    l = e.sum(-1, keepdims=True)
    p = e / np.where(l > 0, l, 1.0)
    out = np.einsum("bnqk,bknd->bqnd", p, v)
    # dS = P (dO . v - dO . out): the absolute terms of both products
    ds = p * (np.einsum("bqnd,bknd->bnqk", np.abs(do), np.abs(v))
              + np.einsum("bqnd,bqnd->bnq", np.abs(do), np.abs(out))[
                  ..., None])
    return dict(
        out=np.einsum("bnqk,bknd->bqnd", p, np.abs(v)),
        dv=np.einsum("bnqk,bqnd->bknd", p, np.abs(do)),
        dk=scale * np.einsum("bnqk,bqnd->bknd", ds, np.abs(q)),
        dq=scale * np.einsum("bnqk,bknd->bqnd", ds, np.abs(k)))


def _close(name, got, want, dtype, terms=None):
    """got (the port, torch) against want (the reference, numpy) on the
    articles with a key to attend; the empty article exact zeros."""
    got = got.float().numpy()
    keep = [0, 2]
    assert not got[1].any(), name
    g, w = got[keep], want[keep]
    if dtype == torch.float32:
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
        return
    bound = 2.0 ** -8 * (terms[keep] + np.abs(w))
    assert (np.abs(g - w) <= bound + 1e-6).all(), (
        name, float((np.abs(g - w) - bound).max()))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_query_block_forward_matches_jax_reference(hd, ratio, dtype):
    """The output and the lse of a block of Tk / ratio query rows."""
    tq = TK // ratio
    qb, _, k, v, do, mask = _inputs(hd, tq, seed=hd + ratio)
    (qt, qn), (kt, kn), (vt, vn) = (_round(x, dtype) for x in (qb, k, v))
    mt = torch.from_numpy(mask)
    scale = hd ** -0.5
    out = fl._flash_plain(qt, kt, vt, mt, False, scale)
    lse = fl._flash_lse_plain(qt, kt, mt, False, scale)
    assert out.shape == (B, tq, NH, hd) and out.dtype == dtype
    assert lse.shape == (B, tq, NH)
    want, want_lse = _reference(qn, kn, vn, mask, scale)
    terms = _abs_terms(qn, kn, vn, mask, do, scale)
    _close("out", out, want, dtype, terms["out"])
    assert np.isinf(lse[1].numpy()).all()  # no key to attend: +inf
    np.testing.assert_allclose(lse[[0, 2]].numpy(), want_lse[[0, 2]],
                               rtol=0, atol=1e-5 * max(
                                   1.0, np.abs(want_lse[[0, 2]]).max()))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("hd", HEAD_DIMS + CLUSTER_HEAD_DIMS)
def test_query_block_backward_matches_jax_vjp(hd, ratio, dtype):
    """dq [B, Tq, ...], dk and dv [B, Tk, ...] of a block of query rows:
    the plain backward formula against jax.vjp of the reference."""
    tq = TK // ratio
    qb, _, k, v, do, mask = _inputs(hd, tq, seed=10 * hd + ratio)
    (qt, qn), (kt, kn), (vt, vn), (dot, don) = (
        _round(x, dtype) for x in (qb, k, v, do))
    mt = torch.from_numpy(mask)
    scale = hd ** -0.5
    out = fl._flash_plain(qt, kt, vt, mt, False, scale)
    lse = fl._flash_lse_plain(qt, kt, mt, False, scale)
    got = fl._flash_bwd_plain(qt, kt, vt, out, lse, dot, mt, False, scale)
    assert [tuple(g.shape) for g in got] == [(B, tq, NH, hd),
                                             (B, TK, NH, hd),
                                             (B, TK, NH, hd)]
    want = _reference_grads(qn, kn, vn, mask, don, scale)
    terms = _abs_terms(qn, kn, vn, mask, don, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(name, g, w, dtype, terms[name])


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("hd", (32, 384))
def test_blocks_are_the_whole_attention(hd, ratio):
    """Cut the queries into ratio blocks: the blocks' outputs, lse and dq
    are the whole attention's rows, and their dk and dv summed are the
    whole attention's (the sp ranks' partial dK and dV that the
    all-gather's backward reduce-scatters)."""
    tq = TK // ratio
    _, q_all, k, v, _, mask = _inputs(hd, tq, seed=hd)
    do_all = np.random.RandomState(hd + 1).randn(
        B, TK, NH, hd).astype(np.float32)
    qa, ka, va, da, mt = (torch.from_numpy(x)
                          for x in (q_all, k, v, do_all, mask))
    scale = hd ** -0.5
    whole = fl._flash_plain(qa, ka, va, mt, False, scale)
    whole_lse = fl._flash_lse_plain(qa, ka, mt, False, scale)
    whole_g = fl._flash_bwd_plain(qa, ka, va, whole, whole_lse, da, mt,
                                  False, scale)
    dk = torch.zeros_like(ka)
    dv = torch.zeros_like(va)
    for i in range(ratio):
        rows = slice(i * tq, (i + 1) * tq)
        qb, db = qa[:, rows].contiguous(), da[:, rows].contiguous()
        out = fl._flash_plain(qb, ka, va, mt, False, scale)
        lse = fl._flash_lse_plain(qb, ka, mt, False, scale)
        g = fl._flash_bwd_plain(qb, ka, va, out, lse, db, mt, False, scale)
        for got, want in ((out, whole[:, rows]), (g[0], whole_g[0][:, rows])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-6 * float(want.abs().max()))
        fin = torch.isfinite(whole_lse[:, rows])
        assert torch.equal(fin, torch.isfinite(lse))
        np.testing.assert_allclose(lse[fin].numpy(),
                                   whole_lse[:, rows][fin].numpy(), rtol=0,
                                   atol=1e-6 * float(lse[fin].abs().max()))
        dk += g[1]
        dv += g[2]
    for got, want in ((dk, whole_g[1]), (dv, whole_g[2])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * float(want.abs().max()))


def test_causal_query_block_raises():
    """A causal call with fewer query rows than keys raises ValueError on
    every entry: the plain forward, lse and backward, and the autograd
    Function (flash_attention with a gradient)."""
    qb, _, k, v, do, mask = _inputs(32, 12, seed=0)
    qt, kt, vt, dot, mt = (torch.from_numpy(x) for x in (qb, k, v, do, mask))
    with pytest.raises(ValueError, match="causal"):
        fl._flash_plain(qt, kt, vt, mt, True, 0.1)
    with pytest.raises(ValueError, match="causal"):
        fl._flash_lse_plain(qt, kt, mt, True, 0.1)
    lse = fl._flash_lse_plain(qt, kt, mt, False, 0.1)
    with pytest.raises(ValueError, match="causal"):
        fl._flash_bwd_plain(qt, kt, vt, qt, lse, dot, mt, True, 0.1)
    with pytest.raises(ValueError, match="causal"):
        fl.flash_attention(qt.requires_grad_(), kt, vt, mt, True, 0.1)
