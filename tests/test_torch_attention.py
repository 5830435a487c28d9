"""The port's fused attention against the JAX package's.

The port's plain version (the CPU path of ops/fused_attention.py) is held
against the Pallas kernels run as tests/test_pallas_attention.py runs
them (interpret mode), against the blocked Pallas kernel over several T
blocks, and against the XLA formulas.  Tolerance rtol/atol 1e-5 in f32:
both sides compute in f32 on the same values and differ only in the
order of their sums.  The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import make_hps, n, numpy_params, t
from textsummarization_on_flink_tpu.ops import attention as jax_attn
from textsummarization_on_flink_tpu.ops import pallas_attention as pa
from textsummarization_on_flink_tpu_torch.ops import attention as torch_attn
from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)


def make_inputs(B=3, T=37, D=24, K=1, seed=0, frac_valid=0.7,
                masked_row=None):
    rng = np.random.RandomState(seed)
    es = rng.randn(B, T, D).astype(np.float32)
    ef = rng.randn(B, T, D).astype(np.float32)
    lens = np.maximum((np.full(B, T) * frac_valid).astype(int), 1)
    lens[-1] = T  # one full-length row
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    if masked_row is not None:
        mask[masked_row] = 0.0  # an empty article: zero attention, no NaN
    df = rng.randn(B, K, D).astype(np.float32)
    cov = (np.abs(rng.randn(B, K, T)) * mask[:, None, :]).astype(np.float32)
    v = rng.randn(D).astype(np.float32)
    w_c = rng.randn(D).astype(np.float32)
    return es, ef, mask, df, cov, v, w_c


def _plain(es, ef, mask, df, cov, v, w_c, use_cov, dtype=torch.float32):
    ctx, attn = fa.fused_attention_shared(
        t(es, dtype), t(ef, dtype), t(mask), t(df), t(cov), t(v), t(w_c),
        use_cov)
    return n(ctx), n(attn)


@pytest.mark.parametrize("use_cov", [False, True])
@pytest.mark.parametrize("masked_row", [None, 1])
def test_plain_matches_pallas_kernel(use_cov, masked_row):
    es, ef, mask, df, cov, v, w_c = make_inputs(masked_row=masked_row)
    ctx_k, attn_k = pa._attention_pallas(es, ef, mask, df[:, 0], cov[:, 0],
                                         v, w_c, use_cov, interpret=True)
    ctx, attn = _plain(es, ef, mask, df, cov, v, w_c, use_cov)
    np.testing.assert_allclose(ctx[:, 0], n(ctx_k), **TOL)
    np.testing.assert_allclose(attn[:, 0], n(attn_k), **TOL)
    assert np.isfinite(ctx).all() and np.isfinite(attn).all()
    if masked_row is not None:
        assert not attn[masked_row].any() and not ctx[masked_row].any()


@pytest.mark.parametrize("use_cov", [False, True])
@pytest.mark.parametrize("masked_row", [None, 0])
def test_plain_matches_blocked_pallas_kernel(use_cov, masked_row):
    """T=70 spans five 16-position blocks of the streaming kernel."""
    es, ef, mask, df, cov, v, w_c = make_inputs(T=70, seed=1,
                                                masked_row=masked_row)
    ctx_k, attn_k = pa._attention_pallas_blocked(
        es, ef, mask, df[:, 0], cov[:, 0], v, w_c, use_cov, block_t=16,
        interpret=True)
    ctx, attn = _plain(es, ef, mask, df, cov, v, w_c, use_cov)
    np.testing.assert_allclose(ctx[:, 0], n(ctx_k), **TOL)
    np.testing.assert_allclose(attn[:, 0], n(attn_k), **TOL)


@pytest.mark.parametrize("use_cov", [False, True])
def test_plain_matches_xla_shared(use_cov):
    """K=3 hypotheses per article against one encoder copy, article by
    article against _attention_xla_shared."""
    es, ef, mask, df, cov, v, w_c = make_inputs(B=2, K=3, seed=2,
                                                masked_row=0)
    ctx, attn = _plain(es, ef, mask, df, cov, v, w_c, use_cov)
    for b in range(2):
        ctx_r, attn_r = pa._attention_xla_shared(
            es[b], ef[b], mask[b], df[b], cov[b], v, w_c, use_cov)
        np.testing.assert_allclose(ctx[b], n(ctx_r), **TOL)
        np.testing.assert_allclose(attn[b], n(attn_r), **TOL)


@pytest.mark.parametrize("blocked", [False, True])
def test_plain_accepts_bf16_encoder_stream(blocked):
    """bf16 es/ef: both sides upcast the same bf16 values in the kernel."""
    es, ef, mask, df, cov, v, w_c = make_inputs(T=40, seed=3)
    # round once through torch; JAX gets the same bf16 values
    es16 = t(es, torch.bfloat16)
    ef16 = t(ef, torch.bfloat16)
    jes = jnp.asarray(n(es16.float()), jnp.bfloat16)
    jef = jnp.asarray(n(ef16.float()), jnp.bfloat16)
    if blocked:
        ctx_k, attn_k = pa._attention_pallas_blocked(
            jes, jef, mask, df[:, 0], cov[:, 0], v, w_c, True, block_t=16,
            interpret=True)
    else:
        ctx_k, attn_k = pa._attention_pallas(
            jes, jef, mask, df[:, 0], cov[:, 0], v, w_c, True, interpret=True)
    ctx, attn = _plain(es, ef, mask, df, cov, v, w_c, True,
                       dtype=torch.bfloat16)
    np.testing.assert_allclose(ctx[:, 0], n(ctx_k), **TOL)
    np.testing.assert_allclose(attn[:, 0], n(attn_k), **TOL)


def test_per_row_form_matches_xla():
    es, ef, mask, df, cov, v, w_c = make_inputs(seed=4)
    ctx_r, attn_r = pa._attention_xla(es, ef, mask, df[:, 0], cov[:, 0], v,
                                      w_c, True)
    ctx, attn = fa.fused_attention(t(es), t(ef), t(mask), t(df[:, 0]),
                                   t(cov[:, 0]), t(v), t(w_c), True)
    np.testing.assert_allclose(n(ctx), n(ctx_r), **TOL)
    np.testing.assert_allclose(n(attn), n(attn_r), **TOL)


def test_cpu_tensors_take_the_plain_version_without_launches():
    before = fa.launches
    es, ef, mask, df, cov, v, w_c = make_inputs()
    _plain(es, ef, mask, df, cov, v, w_c, True)
    assert fa.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel path never runs the plain version: handed CPU tensors
    it raises instead."""
    es, ef, mask, df, cov, v, w_c = make_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        fa._attention_cuda(t(es), t(ef), t(mask), t(df), t(cov), t(v),
                           t(w_c), True)


@pytest.mark.parametrize("dtype,D,T,K,match", [
    (torch.float32, 6, 37, 4, "multiple of 4"),
    (torch.bfloat16, 12, 37, 4, "multiple of 8"),
    # a long encoder: its per-position state moves to device memory, so
    # the shape is taken (the wrapper goes on to refuse the CPU tensors)
    (torch.float32, 512, 300_000, 4, None),
    # many queries: the slab form's narrower slabs take them, until not
    # even slabs of 64 columns fit
    (torch.float32, 512, 400, 64, None),
    (torch.float32, 512, 400, 1024, "shared memory"),
    (torch.float32, 24, 0, 4, "empty"),
    (torch.float32, 24, 37, 0, "empty"),
])
def test_kernel_wrapper_refuses_shapes_before_the_device(dtype, D, T, K,
                                                         match):
    """The shapes the kernel does not take are refused from the shapes
    alone, before the device is looked at (so also here, on CPU
    tensors), and nothing is launched.  ``match`` None: a shape the
    kernel takes, refused only for its device."""
    B = 2
    before = fa.launches

    def zeros(*shape, dtype=torch.float32):  # no memory for long shapes
        return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)

    args = (zeros(B, T, D, dtype=dtype), zeros(B, T, D, dtype=dtype),
            zeros(B, T), zeros(B, K, D), zeros(B, K, T), zeros(D), zeros(D))
    if match is None:
        assert fa._shape_refusal(args[0], args[3]) is None
    with pytest.raises(ValueError, match=match or "CUDA"):
        fa._attention_cuda(*args, True)
    assert fa.launches == before


@pytest.mark.parametrize("B,K,T,D,dtype", [
    (16, 4, 400, 512, torch.float32),   # the beam-decode shape
    (16, 4, 400, 512, torch.bfloat16),
    (4, 1, 4096, 512, torch.float32),   # the long form
    (4, 1, 4096, 512, torch.bfloat16),
    (3, 4, 100, 64, torch.float32),     # the card tests' widths
    (2, 6, 70, 512, torch.bfloat16),
    (2, 1, 333, 96, torch.float32),
])
def test_kernel_takes_the_paths_shapes(B, K, T, D, dtype):
    """No refusal for the shapes the main paths and the card tests give
    the kernel; its shared memory stays within one block's."""
    es = torch.zeros(B, T, D, dtype=dtype)
    assert fa._shape_refusal(es, torch.zeros(B, K, D)) is None
    elt = 2 if dtype == torch.bfloat16 else 4
    assert fa._smem_bytes(T, D, K, elt) <= fa._SMEM_MAX


@pytest.mark.parametrize("B,K,T,D,in_smem", [
    (16, 4, 400, 512, True),      # the beam-decode shape
    (16, 16, 2000, 512, True),    # refused before the state could move
    (4, 4, 20000, 512, True),     # the wide clusters halve each block's
    (4, 4, 60000, 512, False),    # past them: the state in device memory
    (16, 16, 8000, 512, False),
    (2, 64, 8000, 64, False),
])
def test_kernel_keeps_the_state_in_shared_memory_while_it_fits(B, K, T, D,
                                                               in_smem):
    """The block's per-position state (P * (2K + 1) floats) stays in
    shared memory while it fits beside the ring and the queries on a
    132-SM card (the H100), and moves to device memory past that."""
    assert fa._state_in_smem(B, T, D, K, 4, 132) == in_smem
    es = torch.zeros(1, 1, 1).expand(B, T, D)
    assert fa._shape_refusal(es, torch.zeros(B, K, D)) is None


def _bwd_args(B, T, D):
    """The backward's ten tensors at (B, T, D), zeros broadcast from one
    element (no memory for long shapes)."""
    def zeros(*shape):
        return torch.zeros((1,) * len(shape)).expand(*shape)

    return (zeros(B, T, D), zeros(B, T, D), zeros(B, T), zeros(B, D),
            zeros(B, T), zeros(D), zeros(D), zeros(B, T), zeros(B, D),
            zeros(B, T))


@pytest.mark.parametrize("B,T,D,match", [
    (16, 400, 512, None),     # the pointer-generator's training shape
    (4, 4096, 512, None),     # the long encoder
    (2, 20000, 512, None),
    (3, 65, 132, None),       # D not a multiple of 128
    (2, 40, 2308, None),      # three column groups a thread, 3 chunks
    (2, 40, 62, "multiple of 4"),
    (65_536, 4, 8, "grid"),
    (2, 40, 2312, None),      # past the dense form's room: the slab form
    (2, 40, 4096, None),
    (2, 0, 8, "empty"),
])
def test_backward_wrapper_refuses_shapes_before_the_device(B, T, D, match):
    """The backward kernel's refusals come from the shapes alone, before
    the device is looked at (so also here, on CPU tensors), and nothing
    is launched.  ``match`` None: a shape the kernel takes, refused only
    for its device."""
    before = fa.launches_bwd
    args = _bwd_args(B, T, D)
    assert (fa._bwd_shape_refusal(args[0]) is None) == (match is None)
    with pytest.raises(ValueError, match=match or "CUDA"):
        fa._attention_bwd_cuda(*args, True)
    assert fa.launches_bwd == before


@pytest.mark.parametrize("D", [4, 128, 132, 516, 1024, 1028, 2048, 2052,
                               2072])
def test_backward_takes_every_width_it_took_before(D):
    """Every D the first backward kernel took (a multiple of 4 whose 28
    columns of sums fit in shared memory: up to 2,072) is still taken,
    within one block's shared memory."""
    assert fa._bwd_shape_refusal(torch.zeros(1, 1, 1).expand(2, 40, D)) \
        is None
    assert fa._bwd_smem_bytes(D) <= fa._SMEM_MAX


def test_backward_scratch_is_kept_per_stream_and_grown():
    """The backward's scratch (its ticket and partials) is one zeroed
    buffer per (device, stream), replaced by a larger zeroed one when a
    shape needs more."""
    cpu = torch.device("cpu")
    first = fa._bwd_scratch(cpu, 12345, 20)
    assert fa._bwd_scratch(cpu, 12345, 8) is first
    assert fa._bwd_scratch(cpu, 54321, 8) is not first
    grown = fa._bwd_scratch(cpu, 12345, 40)
    assert grown.numel() == 40 and not grown.any()
    assert fa._bwd_scratch(cpu, 12345, 20) is grown
    for key in ((None, 12345), (None, 54321)):
        fa._bwd_scratch_cache.pop(key)


@pytest.mark.parametrize("use_cov", [False, True])
def test_attend_shared_matches_jax(use_cov):
    jhps, thps = make_hps(coverage=use_cov)
    p = numpy_params(thps, 20)["decoder"]["attention"]
    rng = np.random.RandomState(5)
    B, K, T, H = 2, 3, 11, thps.hidden_dim
    es = rng.randn(B, T, 2 * H).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[7], [11]])).astype(np.float32)
    c = rng.randn(B, K, H).astype(np.float32)
    h = rng.randn(B, K, H).astype(np.float32)
    cov = (np.abs(rng.randn(B, K, T)) * mask[:, None]).astype(np.float32)
    tp = {k: t(v) for k, v in p.items()}
    ef_t = torch_attn.encoder_features(tp, t(es))
    ctx, attn, new_cov = torch_attn.attend_shared(
        tp, t(es), ef_t, t(mask), (t(c), t(h)), t(cov), use_cov)
    for b in range(B):
        ef_j = jax_attn.encoder_features(p, jnp.asarray(es[b]))
        np.testing.assert_allclose(n(ef_t[b]), n(ef_j), **TOL)
        ctx_j, attn_j, cov_j = jax_attn.attend_shared(
            p, es[b], ef_j, mask[b], (c[b], h[b]), cov[b], use_cov)
        np.testing.assert_allclose(n(ctx[b]), n(ctx_j), **TOL)
        np.testing.assert_allclose(n(attn[b]), n(attn_j), **TOL)
        if use_cov:
            np.testing.assert_allclose(n(new_cov[b]), n(cov_j), **TOL)
        else:
            assert new_cov is None and cov_j is None


def test_attend_matches_jax():
    _, thps = make_hps(coverage=True)
    p = numpy_params(thps, 20)["decoder"]["attention"]
    rng = np.random.RandomState(6)
    B, T, H = 3, 9, thps.hidden_dim
    es = rng.randn(B, T, 2 * H).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, 5:] = 0
    c, h = rng.randn(B, H).astype(np.float32), rng.randn(B, H).astype(np.float32)
    tp = {k: t(v) for k, v in p.items()}
    ef = torch_attn.encoder_features(tp, t(es))
    ctx, attn, cov = torch_attn.attend(tp, t(es), ef, t(mask), (t(c), t(h)),
                                       None, True)
    ctx_j, attn_j, cov_j = jax_attn.attend(
        p, es, jax_attn.encoder_features(p, jnp.asarray(es)), mask, (c, h),
        None, True)
    np.testing.assert_allclose(n(ctx), n(ctx_j), **TOL)
    np.testing.assert_allclose(n(attn), n(attn_j), **TOL)
    np.testing.assert_allclose(n(cov), n(cov_j), **TOL)
