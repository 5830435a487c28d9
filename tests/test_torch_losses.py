"""The port's ops/losses.py against the JAX package's, function by
function, on the same numpy inputs (ragged decoder masks, targets in and
out of the vocabulary, copied article OOVs).

Tolerance 1e-6 relative (atol 1e-7 for values near 0): f32 on both
sides; only the order of the sums differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from textsummarization_on_flink_tpu.ops import losses as jlosses
from textsummarization_on_flink_tpu_torch.ops import losses

TOL = dict(rtol=1e-6, atol=1e-7)
B, T, T_ENC, V, OOV = 3, 7, 11, 23, 4


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    lens = np.array([T, 4, 1])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    attn = rng.rand(B, T, T_ENC).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    ext = rng.randint(0, V + OOV, (B, T_ENC)).astype(np.int32)
    targets = rng.randint(0, V + OOV, (B, T)).astype(np.int32)
    targets[0, :3] = ext[0, :3]  # copies of article words, OOVs included
    return dict(
        scores=(rng.randn(B, T, V) * 3).astype(np.float32),
        attn=attn, mask=mask, ext=ext, targets=targets,
        p_gens=rng.rand(B, T).astype(np.float32),
        values=rng.rand(B, T).astype(np.float32))


def test_mask_and_avg_matches_jax():
    x = _inputs()
    want = jlosses.mask_and_avg(jnp.asarray(x["values"]), jnp.asarray(x["mask"]))
    got = losses.mask_and_avg(t(x["values"]), t(x["mask"]))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_gold_mixture_prob_from_scores_matches_jax():
    """Step-major [T, B, ...] inputs, as both packages' callers pass."""
    x = _inputs(1)
    sw = lambda a: np.ascontiguousarray(np.swapaxes(a, 0, 1))  # noqa: E731
    args = (sw(x["scores"]), sw(x["attn"]), sw(x["p_gens"]), sw(x["targets"]))
    want = jlosses.gold_mixture_prob_from_scores(
        *(jnp.asarray(a) for a in args), jnp.asarray(x["ext"]))
    got = losses.gold_mixture_prob_from_scores(
        *(t(a) for a in args[:3]), t(args[3]).long(), t(x["ext"]).long())
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    assert (x["targets"] >= V).any()  # the out-of-vocabulary branch ran


def test_pointer_nll_matches_jax():
    x = _inputs(2)
    gold = x["values"] * 0.9 + 0.05
    want = jlosses.pointer_nll(jnp.asarray(gold), jnp.asarray(x["mask"]))
    got = losses.pointer_nll(t(gold), t(x["mask"]))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_coverage_loss_matches_jax():
    x = _inputs(3)
    want = jlosses.coverage_loss(jnp.asarray(x["attn"]), jnp.asarray(x["mask"]))
    got = losses.coverage_loss(t(x["attn"]), t(x["mask"]))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_softmax_cross_entropy_baseline_matches_jax():
    """The global token mean (not the per-example average)."""
    x = _inputs(4)
    tg = x["targets"] % V  # the baseline's targets are in the vocabulary
    want = jlosses.softmax_cross_entropy_baseline(
        jnp.asarray(x["scores"]), jnp.asarray(tg), jnp.asarray(x["mask"]))
    got = losses.softmax_cross_entropy_baseline(
        t(x["scores"]), t(tg).long(), t(x["mask"]))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_project_scores_matches_jax_and_is_f32_only():
    """f32, and bf16 operands with f32 sums: the products of the bf16
    values are exact in f32 on both sides, so the bf16 form is held as
    tightly as the f32 one (1e-5 relative); the result is f32 either
    way."""
    rng = np.random.RandomState(5)
    h = rng.randn(B, T, 8).astype(np.float32)
    w = rng.randn(8, V).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        want = jlosses.project_scores(jnp.asarray(h), jnp.asarray(w), dtype)
        got = losses.project_scores(t(h), t(w), dtype)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
