"""Head dims above 256 (the wide flash kernels' widths) in the port's
transformer and AAN against the JAX package's, on the CPU.

At head dims 320 (hidden 640, 2 heads), 384 and 512 (hidden 384 and 512,
1 head), 2 + 2 layers, T_enc 40, the same numpy params and batches go
through both packages: the JAX package's transformer pads such a head
dim to a multiple of 128 for the library flash kernel
(models/transformer.py:262-272), the port pads it the same way for its
wide kernels on the card and runs the plain versions here
(ops/flash_attention.py).

Tolerances: the loss within rtol 1e-5; every gradient within rtol 1e-4 /
atol 1e-5 (f32 on both sides; a backward sums in another order); beam
tokens and lengths exactly equal, from a sharpened checkpoint (a wide
tied embedding and a STOP bias); under --compute_dtype=bfloat16 the loss
within BF16_GAP_FACTOR (4) times the JAX package's own bf16-to-f32
distance (tests/test_torch_byte_diet.py's rule, as PRs 10 and 13 hold
the bf16 paths), and the gradient as a whole (every leaf in one vector)
within 4 times JAX's bf16-to-f32 distance in the L2 norm.  The rule is
not applied leaf by leaf here: a leaf's JAX gap is one draw of rounding
noise and can be small by chance (on these inputs the per-leaf form
fails at hidden 32 too, on decoder ln1/scale at 1.09 times its bound,
where nothing is wide).  The pad-and-slice route the card takes is held
against the unpadded plain version at head dim 320, and the card's
config no longer refuses a head dim."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import WORDS, abstract, article, make_hps, n
from test_torch_byte_diet import (
    BF16_GAP_FACTOR,
    _gap_bound,
    batch_arrays,
    jax_loss_and_grads,
)
from textsummarization_on_flink_tpu.data import batching as jax_batching
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu.models import avg_attention as jax_aan
from textsummarization_on_flink_tpu.models import transformer as jax_tfm
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.models import avg_attention as aan
from textsummarization_on_flink_tpu_torch.models import transformer as tfm
from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
    tree_leaves,
)

VSIZE = len(WORDS) + 4
FAMILIES = ("transformer", "avg_attention")
#: (hidden_dim, num_heads) -> head dims 320, 384, 512
WIDTHS = [pytest.param((640, 2), id="hd320"),
          pytest.param((384, 1), id="hd384"),
          pytest.param((512, 1), id="hd512")]
COMMON = dict(enc_layers=2, dec_layers=2, max_enc_steps=40, batch_size=3)
MODULES = {"transformer": (jax_tfm, tfm), "avg_attention": (jax_aan, aan)}


def _hps(family, width, **kw):
    hidden, heads = width
    return make_hps(model_family=family, hidden_dim=hidden, num_heads=heads,
                    **dict(COMMON, **kw))


def _port_loss_and_grads(family, thps, p, arrays):
    tp = from_numpy_tree(p)
    for x in tree_leaves(tp):
        x.requires_grad_(True)
    out = MODULES[family][1].forward_train(
        tp, thps, beam_search._to_device(arrays, "cpu"))
    grads = torch.autograd.grad(out.total_loss, tree_leaves(tp),
                                materialize_grads=True)
    return float(out.total_loss.detach()), [n(g) for g in grads]


def _jax_loss_and_grads(family, jhps, p, arrays):
    if family == "transformer":
        return jax_loss_and_grads(family, jhps, p, arrays)
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}

    def f(pp):
        return jax_aan.forward_train(pp, jhps, ja).total_loss

    loss, g = jax.jit(jax.value_and_grad(f))(
        jax.tree_util.tree_map(jnp.asarray, p))
    return float(loss), [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


@functools.lru_cache(maxsize=None)
def _train_case(family, width, dtype):
    jhps, thps = _hps(family, width, mode="train", coverage=True,
                      max_oov_buckets=8, compute_dtype=dtype)
    p = init_numpy_params(thps, VSIZE, 3)
    arrays = batch_arrays(thps, 0)
    return (_jax_loss_and_grads(family, jhps, p, arrays),
            _port_loss_and_grads(family, thps, p, arrays))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("family", FAMILIES)
def test_wide_head_loss_and_grads_match_jax(family, width):
    (want, want_grads), (got, grads) = _train_case(family, width, "float32")
    hidden, heads = width
    assert hidden // heads > 256
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("width", [WIDTHS[0], WIDTHS[2]])
@pytest.mark.parametrize("family", FAMILIES)
def test_wide_head_bf16_loss_and_grads_within_jax_gap(family, width):
    """compute_dtype=bfloat16: the port's bf16 loss within
    BF16_GAP_FACTOR times JAX's own bf16-to-f32 distance, its gradient
    (all leaves) within that factor of JAX's in the L2 norm (module
    docstring)."""
    (j32, jg32), _ = _train_case(family, width, "float32")
    (j16, jg16), (t16, tg16) = _train_case(family, width, "bfloat16")
    assert j16 != j32  # bf16 really changed the result
    assert abs(t16 - j16) <= _gap_bound([j16], [j32])
    assert len(tg16) == len(jg16)
    assert all(tg.dtype == np.float32 for tg in tg16)

    def flat(leaves):
        return np.concatenate([np.ravel(x).astype(np.float64)
                               for x in leaves])

    gap = np.linalg.norm(flat(jg16) - flat(jg32))
    assert gap > 0
    assert np.linalg.norm(flat(tg16) - flat(jg16)) <= BF16_GAP_FACTOR * gap


def _decode_case(family, width):
    jhps, thps = _hps(family, width, beam_size=3, pointer_gen=True)
    p = init_numpy_params(thps, VSIZE, 11)
    p["embedding"] *= 30.0  # tied: sharpens the vocab scores
    p["out_bias"][3] = 3.0  # STOP: some beams finish early
    jv, tv = JaxVocab(words=WORDS), Vocab(words=WORDS)
    jex = [jax_batching.SummaryExample.build(article(i), [abstract(i)], jv,
                                             jhps) for i in range(3)]
    tex = [batching.SummaryExample.build(article(i), [abstract(i)], tv, thps)
           for i in range(3)]
    return (jhps, thps, p, jax_batching.Batch(jex, jhps, jv).as_arrays(),
            batching.Batch(tex, thps, tv).as_arrays())


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("family", FAMILIES)
def test_wide_head_beam_tokens_equal_jax(family, width):
    jhps, thps, p, jarrays, tarrays = _decode_case(family, width)
    want = jax_bs.run_beam_search(p, jhps, jarrays)
    got = beam_search.run_beam_search(from_numpy_tree(p), thps, tarrays)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length, np.asarray(want.length))
    np.testing.assert_allclose(got.avg_log_prob,
                               np.asarray(want.avg_log_prob), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hd,width", [(320, 384), (512, 512), (1000, 1024),
                                      (257, 384), (640, 640)])
def test_padded_head_dim_above_256(hd, width):
    """Above 256 a head dim pads to the next multiple of 128 (the wide
    kernels' slab), as the JAX package pads for the library kernel."""
    assert fl._padded_head_dim(hd) == width
    assert fl._is_wide(width)


@pytest.mark.parametrize("hd", [512, 1024])
@pytest.mark.parametrize("family", FAMILIES)
def test_validate_accepts_wide_head_dims_on_the_card(monkeypatch, family, hd):
    """HParams.validate on the card (a card the test pretends to have)
    takes any head dim: the refusal above 256 is gone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    HParams(model_family=family, hidden_dim=hd, num_heads=1,
            device="cuda").validate()


@pytest.mark.parametrize("causal", [False, True])
def test_pad_and_slice_equals_unpadded_plain_at_hd320(causal):
    """The card's route at head dim 320, on CPU tensors: q, k, v, out and
    dO zero-padded to 384, the plain versions run at 384 with the true
    head dim's scale, the results sliced back; equal to the unpadded
    plain forward, lse and backward, the pad columns exactly 0."""
    hd, width = 320, fl._padded_head_dim(320)
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 40, 1, hd).astype(
        np.float32)) for _ in range(4))
    mask = torch.ones(2, 40)
    mask[1, 25:] = 0.0
    scale = hd ** -0.5
    qp, kp, vp, dop = fl._pad_head_dim(width, q, k, v, do)
    out = fl._flash_plain(q, k, v, mask, causal, scale)
    outp = fl._flash_plain(qp, kp, vp, mask, causal, scale)
    torch.testing.assert_close(outp[..., :hd], out, rtol=1e-6, atol=1e-6)
    assert not outp[..., hd:].any()
    lse = fl._flash_lse_plain(q, k, mask, causal, scale)
    torch.testing.assert_close(fl._flash_lse_plain(qp, kp, mask, causal,
                                                   scale), lse, rtol=1e-6,
                               atol=1e-6)
    grads = fl._flash_bwd_plain(q, k, v, out, lse, do, mask, causal, scale)
    gradsp = fl._flash_bwd_plain(qp, kp, vp, outp, lse, dop, mask, causal,
                                 scale)
    for a, b in zip(gradsp, grads):
        torch.testing.assert_close(a[..., :hd], b, rtol=1e-6, atol=1e-6)
        assert not a[..., hd:].any()


def _refuse_load():
    raise AssertionError("a kernel library was loaded")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["fwd", "dkv", "dq"])
def test_simt_is_refused_off_the_wide_kernels(monkeypatch, kind, bf16):
    """``simt=True`` names the SIMT design of the wide kernels only: off
    them _entry raises ValueError before it loads any library."""
    for loader in ("_load_library", "_load_bwd_library",
                   "_load_wide_library"):
        monkeypatch.setattr(fl, loader, _refuse_load)
    with pytest.raises(ValueError, match="wide"):
        fl._entry(kind, bf16, False, simt=True)


@pytest.mark.parametrize("simt", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["fwd", "dkv", "dq"])
def test_wide_entry_names_take_simt_for_every_kernel(monkeypatch, kind, bf16,
                                                     simt):
    """On the wide library every kernel, the dQ included, has a SIMT entry
    beside its cluster entry: ts_flash_wide[_bwd_<kind>][_simt][_bf16]."""
    lib = type("Lib", (), {"ts_flash_wide_error_string": "err"})()
    monkeypatch.setattr(fl, "_load_wide_library", lambda: lib)
    monkeypatch.setattr(fl, "_load_library", _refuse_load)
    monkeypatch.setattr(fl, "_load_bwd_library", _refuse_load)
    name = ("ts_flash_wide" + ("" if kind == "fwd" else f"_bwd_{kind}")
            + ("_simt" if simt else "") + ("_bf16" if bf16 else ""))
    setattr(lib, name, name)
    assert fl._entry(kind, bf16, True, simt=simt) == (name, "err")
