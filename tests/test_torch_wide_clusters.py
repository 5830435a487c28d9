"""Head dims past the 8-block clusters (1152 and 2048: the wide forward's,
dK/dV's and dQ's clusters of 9 and 16 blocks on the card; 2304: their 9
blocks of 2 slabs each) in the port's transformer against the JAX
package's, on the CPU.  Which form each wide kernel takes is the
library's rule (``ts_flash_wide_form``), so the card tests
(tests/test_torch_cuda.py) hold it.

At hidden 1152, 2048 and 2304 with one head, 1 + 1 layers, T_enc 40 and a
narrow FFN (the head dim is what is under test), the same numpy params
and batches go through both packages: the JAX package pads the head dim
to a multiple of 128 for the library flash kernel (models/
transformer.py:262-272; both are multiples already), the port runs the
plain versions of its wide kernels here (ops/flash_attention.py).

Tolerances are tests/test_torch_wide_heads.py's: the loss within rtol
1e-5, every gradient within rtol 1e-4 / atol 1e-5 (f32 on both sides; at
parameter seed GRAD_SEED); under --compute_dtype=bfloat16 the gradient
as a whole (at GRAD_SEED) within BF16_GAP_FACTOR (4) times the JAX
package's own bf16-to-f32 distance in the L2 norm, and the loss by a
mean over the parameter seeds BF16_SEEDS (0-5, every one): the mean of
|port bf16 - JAX bf16| within BF16_GAP_FACTOR times the mean of JAX's
own |bf16 - f32|, plus the f32 floor 1e-5 * max(1, |loss|).  One seed's
JAX distance is no yardstick: over seeds 0-5 it ranges from 1.3e-5 to
2.7e-3, and eager and jitted JAX differ by about as much as the port
differs from JAX (tests/_bf16_seed_spread.py prints both); beam tokens
and lengths exactly equal, from a sharpened checkpoint."""

import functools

import numpy as np
import pytest

from _torch_parity import WORDS, abstract, article, make_hps
from test_torch_byte_diet import BF16_GAP_FACTOR, batch_arrays
from test_torch_wide_heads import _jax_loss_and_grads, _port_loss_and_grads
from textsummarization_on_flink_tpu.data import batching as jax_batching
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
)

VSIZE = len(WORDS) + 4
#: hidden_dim at one head: head dims 1152 (9 blocks), 2048 (16) and 2304
#: (9 blocks of 2 slabs)
HIDDEN = [pytest.param(1152, id="hd1152"), pytest.param(2048, id="hd2048"),
          pytest.param(2304, id="hd2304")]
COMMON = dict(model_family="transformer", num_heads=1, enc_layers=1,
              dec_layers=1, ffn_dim=256, max_enc_steps=40, batch_size=3)


def _hps(hidden, **kw):
    return make_hps(hidden_dim=hidden, **dict(COMMON, **kw))


#: the parameter seed of the f32 test and of the bf16 gradient rule
GRAD_SEED = 3
#: the parameter seeds of the bf16 loss rule
BF16_SEEDS = range(6)


def _case(hidden, dtype, seed, port=True):
    """(JAX's (loss, grads), the port's or None) of one train step at
    parameter seed ``seed``."""
    jhps, thps = _hps(hidden, mode="train", coverage=True,
                      max_oov_buckets=8, compute_dtype=dtype)
    p = init_numpy_params(thps, VSIZE, seed)
    arrays = batch_arrays(thps, 0)
    return (_jax_loss_and_grads("transformer", jhps, p, arrays),
            _port_loss_and_grads("transformer", thps, p, arrays)
            if port else None)


@functools.lru_cache(maxsize=None)
def _train_case(hidden, dtype):
    return _case(hidden, dtype, GRAD_SEED)


@functools.lru_cache(maxsize=None)
def _bf16_losses(hidden, seed):
    """(JAX's f32 loss, JAX's bf16 loss, the port's bf16 loss) at
    parameter seed ``seed``, cached per (hidden, seed) without the
    gradients (at GRAD_SEED _train_case's)."""
    if seed == GRAD_SEED:
        (j32, _), _ = _train_case(hidden, "float32")
        (j16, _), (t16, _) = _train_case(hidden, "bfloat16")
    else:
        (j32, _), _ = _case(hidden, "float32", seed, port=False)
        (j16, _), (t16, _) = _case(hidden, "bfloat16", seed)
    return j32, j16, t16


@pytest.mark.parametrize("hidden", HIDDEN)
def test_cluster_head_dim_loss_and_grads_match_jax(hidden):
    (want, want_grads), (got, grads) = _train_case(hidden, "float32")
    assert fl._padded_head_dim(hidden) == hidden
    assert fl._is_wide(hidden)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hidden", HIDDEN)
def test_cluster_head_dim_bf16_loss_and_grads_within_jax_gap(hidden):
    """compute_dtype=bfloat16: over BF16_SEEDS the mean of the port's
    bf16 loss's distance from JAX's within BF16_GAP_FACTOR times the mean
    of JAX's own bf16-to-f32 distance, plus the f32 floor 1e-5 * max(1,
    |loss|) (the module docstring); at GRAD_SEED the gradient (all
    leaves in one vector) within that factor of JAX's in the L2 norm
    (tests/test_torch_wide_heads.py's rule)."""
    losses = np.array([_bf16_losses(hidden, seed) for seed in BF16_SEEDS])
    j32s, j16s, t16s = losses.T
    assert (j16s != j32s).all()  # bf16 really changed every result
    bound = BF16_GAP_FACTOR * np.mean(np.abs(j16s - j32s)) \
        + 1e-5 * max(1.0, float(np.max(np.abs(j16s))))
    assert np.mean(np.abs(t16s - j16s)) <= bound
    (j32, jg32), _ = _train_case(hidden, "float32")
    (j16, jg16), (t16, tg16) = _train_case(hidden, "bfloat16")
    assert len(tg16) == len(jg16)

    def flat(leaves):
        return np.concatenate([np.ravel(x).astype(np.float64)
                               for x in leaves])

    gap = np.linalg.norm(flat(jg16) - flat(jg32))
    assert gap > 0
    assert np.linalg.norm(flat(tg16) - flat(jg16)) <= BF16_GAP_FACTOR * gap


@pytest.mark.parametrize("hidden", HIDDEN)
def test_cluster_head_dim_beam_tokens_equal_jax(hidden):
    jhps, thps = _hps(hidden, beam_size=3, pointer_gen=True)
    p = init_numpy_params(thps, VSIZE, 11)
    p["embedding"] *= 30.0  # tied: sharpens the vocab scores
    p["out_bias"][3] = 3.0  # STOP: some beams finish early
    jv, tv = JaxVocab(words=WORDS), Vocab(words=WORDS)
    jex = [jax_batching.SummaryExample.build(article(i), [abstract(i)], jv,
                                             jhps) for i in range(3)]
    tex = [batching.SummaryExample.build(article(i), [abstract(i)], tv, thps)
           for i in range(3)]
    want = jax_bs.run_beam_search(
        p, jhps, jax_batching.Batch(jex, jhps, jv).as_arrays())
    got = beam_search.run_beam_search(
        from_numpy_tree(p), thps, batching.Batch(tex, thps, tv).as_arrays())
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length, np.asarray(want.length))
    np.testing.assert_allclose(got.avg_log_prob,
                               np.asarray(want.avg_log_prob), rtol=1e-5,
                               atol=1e-5)
