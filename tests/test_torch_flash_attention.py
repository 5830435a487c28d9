"""The port's flash self-attention (plain version) against the JAX
package's transformer self-attention: the einsum ``_mha`` on every row,
and the library Pallas flash kernel (run in interpret mode on the CPU,
as tests/test_transformer.py runs it) on the real rows.

Tolerance 1e-5: f32 on both sides, only the order of sums differs."""

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

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, T, H, seed, scale=0.3):
    """x [B, T, H], ragged key mask with article 1 fully masked, and one
    set of attention weights for both packages."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, T, H) * scale).astype(np.float32)
    lens = rng.randint(T // 3, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    mask[1] = 0.0
    p = {k: (rng.randn(H, H) * 0.3).astype(np.float32)
         for k in ("wq", "wk", "wv", "wo")}
    return x, mask, p


def _qkv(hps, x, p):
    tp = {k: t(v) for k, v in p.items()}
    xt = t(x)
    return [tfm._split_heads(hps, xt @ tp[w]) for w in ("wq", "wk", "wv")]


@pytest.mark.parametrize("B,T,H,nh", [(3, 17, 16, 4), (3, 40, 64, 2),
                                      (2, 33, 128, 4)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_mha_on_all_rows(B, T, H, nh, causal):
    """Ragged key mask, one fully masked article (zeros out), and the
    causal lower triangle (combined with the key mask)."""
    x, mask, p = _inputs(B, T, H, seed=T)
    hps = HParams(hidden_dim=H, num_heads=nh, device="cpu")
    jhps = JaxHParams(hidden_dim=H, num_heads=nh)
    p["wo"] = np.eye(H, dtype=np.float32)  # the output is the context
    jm = jnp.asarray(mask)[:, None, :]
    if causal:
        jm = jm[:, :, :] * jnp.tril(jnp.ones((T, T), jnp.float32))[None]
    want, want_probs = jtfm._mha(jhps, p, jnp.asarray(x), jnp.asarray(x), jm)
    q, k, v = _qkv(hps, x, p)
    got = fa._flash_plain(q, k, v, t(mask), causal, (H // nh) ** -0.5)
    got = tfm._merge_heads(got)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    assert not n(got)[1].any()  # no key to attend: exact zeros
    # the port's own plain _mha (the cross-attention's formula) agrees too
    got_mha, got_probs = tfm._mha(hps, {k: t(v) for k, v in p.items()},
                                  t(x), t(x), t(np.asarray(jm)))
    np.testing.assert_allclose(n(got_mha), np.asarray(want), **TOL)
    np.testing.assert_allclose(n(got_probs), np.asarray(want_probs), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_self_attention_matches_jax_einsum_path(causal):
    """The port's _self_attention (flash wrapper, plain on the CPU) equals
    the JAX package's CPU path through wo, on every row."""
    B, T, H, nh = 3, 21, 32, 4
    x, mask, p = _inputs(B, T, H, seed=5)
    hps = HParams(hidden_dim=H, num_heads=nh, device="cpu")
    jhps = JaxHParams(hidden_dim=H, num_heads=nh)
    jmask = None if causal else jnp.asarray(mask)
    want = jtfm._self_attention(jhps, p, jnp.asarray(x), jmask, causal)
    got = tfm._self_attention(hps, {k: t(v) for k, v in p.items()}, t(x),
                              None if causal else t(mask), causal)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def _has_force_tpu_interpret():
    from jax.experimental.pallas import tpu as pltpu

    return hasattr(pltpu, "force_tpu_interpret_mode")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_flash_kernel_interpret(monkeypatch, causal):
    """The JAX flash branch (TS_FLASH=on, backend patched to "tpu", the
    Pallas kernel in interpret mode; T and hd zero-padded to 128 by the
    JAX package) on its real rows.  Non-causal: the rows of real tokens
    (the JAX branch lets a padding row attend padding keys, the port lets
    it attend the real keys).  Causal: every row."""
    if not _has_force_tpu_interpret():
        pytest.skip("pltpu.force_tpu_interpret_mode is absent from this jax")
    from jax.experimental.pallas import tpu as pltpu

    B, T, H, nh = 2, 40, 128, 4  # hd 32: the reference head width
    x, mask, p = _inputs(B, T, H, seed=3)
    mask[1] = (np.arange(T) < T - 13).astype(np.float32)  # ragged, not empty
    p["wo"] = np.eye(H, dtype=np.float32)
    jhps = JaxHParams(model_family="transformer", hidden_dim=H, num_heads=nh)
    monkeypatch.setenv("TS_FLASH", "on")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert jtfm._use_flash(jhps, T)
    jmask = None if causal else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jtfm._self_attention(jhps, p, jnp.asarray(x),
                                               jmask, causal))
    hps = HParams(hidden_dim=H, num_heads=nh, device="cpu")
    q, k, v = _qkv(hps, x, p)
    got = n(tfm._merge_heads(fa._flash_plain(
        q, k, v, None if causal else t(mask), causal, (H // nh) ** -0.5)))
    real = np.ones((B, T, 1), bool) if causal else mask[:, :, None] > 0
    np.testing.assert_allclose(np.where(real, got, 0),
                               np.where(real, want, 0), **TOL)


def test_wrapper_takes_the_plain_version_on_cpu_without_counting():
    hps = HParams(hidden_dim=32, num_heads=1, device="cpu")
    x, mask, p = _inputs(2, 9, 32, seed=1)
    q, k, v = _qkv(hps, x, p)
    before = fa.launches
    got = fa.flash_attention(q, k, v, t(mask), False, 0.5)
    assert fa.launches == before
    np.testing.assert_array_equal(
        n(got), n(fa._flash_plain(q, k, v, t(mask), False, 0.5)))


def test_kernel_path_refuses_cpu_tensors():
    """The kernel's entry point never runs the plain version: given CPU
    tensors it raises (no CUDA device is needed to check this)."""
    q = torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa._flash_cuda(q, q, q, None, False, 1.0)
