"""The flash self-attention backward of the port (``_flash_bwd_plain``,
the plain version of the dK/dV and dQ kernels, and the ``FlashAttention``
autograd Function that takes it on the CPU) against three references:
``torch.autograd`` through ``_flash_plain``; ``jax.grad`` through the
JAX package's einsum ``_mha`` self-attention, on every row; and the
gradient of the library Pallas flash kernel (run in interpret mode on
the CPU, as tests/test_transformer.py runs it) on the real rows.

Tolerance 1e-5 * max(1, max|g|), the form tests/test_transformer.py:
274-276 uses: f32 on both sides, only the order of sums differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from textsummarization_on_flink_tpu.config import HParams as JaxHParams
from textsummarization_on_flink_tpu.models import transformer as jtfm
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.models import transformer as tfm
from textsummarization_on_flink_tpu_torch.ops import flash_attention as fa


def _close(got, want):
    got, want = n(got), np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    assert err <= 1e-5 * max(1.0, float(np.max(np.abs(want)))), err


def _inputs(B, T, nh, hd, seed, empty_article=True):
    """q, k, v [B, T, nh, hd], a cotangent, and a ragged key mask whose
    article 1 is fully masked (an empty article)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, T, nh, hd).astype(np.float32)
                   for _ in range(4))
    lens = rng.randint(T // 3, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    if empty_article:
        mask[1] = 0.0
    return q, k, v, do, mask


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_autograd_of_plain_forward(hd, causal):
    """All rows; key mask and causal triangle combined; exact zeros for
    the empty article."""
    q, k, v, do, mask = _inputs(3, 19, 2, hd, seed=hd + causal)
    scale = hd ** -0.5
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    out = fa._flash_plain(qt, kt, vt, t(mask), causal, scale)
    want = torch.autograd.grad(out, (qt, kt, vt), t(do))
    lse = fa._flash_lse_plain(t(q), t(k), t(mask), causal, scale)
    got = fa._flash_bwd_plain(t(q), t(k), t(v), out.detach(), lse, t(do),
                              t(mask), causal, scale)
    for g, w in zip(got, want):
        _close(g, w)
        assert torch.isfinite(g).all()
    assert all(not g[1].any() for g in got)  # no key to attend: zeros
    assert torch.isinf(lse[1]).all() and torch.isfinite(lse[0]).all()


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_matches_jax_grad_of_mha_on_all_rows(hd, causal):
    """d/dx and d/dW of sum(attention(x) * G) (wo = I, so the output is the
    context): the port through FlashAttention (plain backward on the CPU)
    against jax.grad through JAX _mha with the same masks."""
    B, T, nh = 3, 17, 2
    H = nh * hd
    rng = np.random.RandomState(hd + 7 * causal)
    x = (rng.randn(B, T, H) * 0.3).astype(np.float32)
    w = {k: (rng.randn(H, H) * H ** -0.5).astype(np.float32)
         for k in ("wq", "wk", "wv")}
    cot = rng.randn(B, T, H).astype(np.float32)
    _, _, _, _, mask = _inputs(B, T, nh, hd, seed=3)
    jhps = JaxHParams(hidden_dim=H, num_heads=nh)
    jm = jnp.asarray(mask)[:, None, :]
    if causal:
        jm = jm * jnp.tril(jnp.ones((T, T), jnp.float32))[None]

    def jloss(x, wq, wk, wv):
        p = dict(wq=wq, wk=wk, wv=wv, wo=jnp.eye(H, dtype=jnp.float32))
        return jnp.sum(jtfm._mha(jhps, p, x, x, jm)[0] * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in ("wq", "wk", "wv")))
    hps = HParams(hidden_dim=H, num_heads=nh, device="cpu")
    xt = t(x).requires_grad_()
    wt = [t(w[k]).requires_grad_() for k in ("wq", "wk", "wv")]
    q, k, v = (tfm._split_heads(hps, xt @ wi) for wi in wt)
    out = fa.flash_attention(q, k, v, t(mask), causal, hd ** -0.5)
    got = torch.autograd.grad(tfm._merge_heads(out), [xt] + wt, t(cot))
    for g, wnt in zip(got, want):
        _close(g, wnt)


def _has_force_tpu_interpret():
    from jax.experimental.pallas import tpu as pltpu

    return hasattr(pltpu, "force_tpu_interpret_mode")


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_matches_jax_flash_kernel_grad_interpret(monkeypatch, causal):
    """The JAX flash branch's gradient (TS_FLASH=on, backend patched to
    "tpu", the Pallas forward and both backward kernels in interpret mode;
    T and hd zero-padded to 128 by the JAX package) through a loss masked
    to the real rows, as tests/test_transformer.py:254-276 does: the
    JAX branch lets a padding row attend padding keys, the port lets it
    attend the real keys, and the mask keeps those rows out."""
    if not _has_force_tpu_interpret():
        pytest.skip("pltpu.force_tpu_interpret_mode is absent from this jax")
    from jax.experimental.pallas import tpu as pltpu

    B, T, H, nh = 2, 40, 128, 4  # hd 32: the reference head width
    rng = np.random.RandomState(0)
    p = {k: (rng.randn(H, H) * 0.05).astype(np.float32)
         for k in ("wq", "wk", "wv", "wo")}
    x = (rng.randn(B, T, H) * 0.3).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([T, T - 13])[:, None]
            ).astype(np.float32)
    cot = rng.randn(B, T, H).astype(np.float32)
    real = np.ones((B, T, 1), np.float32) if causal else mask[:, :, None]
    jhps = JaxHParams(model_family="transformer", hidden_dim=H, num_heads=nh)
    jmask = None if causal else jnp.asarray(mask)

    def jloss(x, p):
        out = jtfm._self_attention(jhps, p, x, jmask, causal)
        return jnp.sum(out * real * cot)

    monkeypatch.setenv("TS_FLASH", "on")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert jtfm._use_flash(jhps, T)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    hps = HParams(hidden_dim=H, num_heads=nh, device="cpu")
    xt = t(x).requires_grad_()
    pt = {k: t(v).requires_grad_() for k, v in p.items()}
    out = tfm._self_attention(hps, pt, xt, None if causal else t(mask),
                              causal)
    keys = sorted(pt)
    got = torch.autograd.grad(torch.sum(out * t(real) * t(cot)),
                              [xt] + [pt[k] for k in keys])
    _close(got[0], want[0])
    for k, g in zip(keys, got[1:]):
        _close(g, want[1][k])


def test_function_takes_the_plain_versions_on_cpu_without_counting():
    """On CPU tensors the Function's forward and backward are the plain
    versions (bit-equal), and no launch counter moves."""
    q, k, v, do, mask = _inputs(2, 9, 1, 32, seed=1)
    counts = (fa.launches, fa.launches_bwd_dkv, fa.launches_bwd_dq)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, t(mask), False, 0.5)
    got = torch.autograd.grad(out, (qt, kt, vt), t(do))
    assert (fa.launches, fa.launches_bwd_dkv, fa.launches_bwd_dq) == counts
    plain = fa._flash_plain(t(q), t(k), t(v), t(mask), False, 0.5)
    np.testing.assert_array_equal(n(out), n(plain))
    lse = fa._flash_lse_plain(t(q), t(k), t(mask), False, 0.5)
    want = fa._flash_bwd_plain(t(q), t(k), t(v), plain, lse, t(do), t(mask),
                               False, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.parametrize("causal", [False, True])
def test_function_gradcheck_float64(causal):
    """torch.autograd.gradcheck of the Function (plain backward on the
    CPU) against finite differences in float64, key-masked with an empty
    article."""
    q, k, v, _, mask = _inputs(3, 6, 2, 4, seed=2)
    args = tuple(t(x, torch.float64).requires_grad_() for x in (q, k, v))
    km = t(mask, torch.float64)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.FlashAttention.apply(q, k, v, km, causal, 0.4),
        args)


def test_backward_kernel_path_refuses_cpu_tensors():
    """The backward kernels' entry point never runs the plain version:
    given CPU tensors it raises (no CUDA device is needed to check
    this)."""
    x = torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa._flash_bwd_cuda(x, x, x, x, torch.zeros(1, 4, 1), x, None,
                           False, 1.0)
