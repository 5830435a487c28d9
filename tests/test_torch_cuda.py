"""The port's CUDA kernels on the card (marker ``cuda``; skips without a
CUDA device): the fused additive attention and its backward, the flash
self-attention and its backward (dK/dV and dQ), each against its plain
version, and the bitwise repeatability of the kernels redesigned last and
of the fused attention's backward.  This file imports
torch, numpy and the port only, so it also runs where jax is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance 1e-5 absolute: kernel and plain version compute in f32 on the
same values (bf16 inputs are upcast on load by both) and differ only in
the order of their sums; a bf16 output both round once from f32 (the
backward's d_es and d_ef on a bf16 stream) within one bf16 ulp plus
that tolerance.  The
training tests at the end (the streaming loss, a bf16 train step, the
pipeline) hold the card against --device=cpu."""

import numpy as np
import pytest
import torch

from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(B, K, T, D, dtype, seed=0):
    """The fused attention's inputs, article 1 fully masked."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(T // 2, T + 1, B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    if B > 1:
        mask[1] = 0.0  # an empty article
    arrs = [rng.randn(B, T, D), rng.randn(B, T, D), mask,
            rng.randn(B, K, D), np.abs(rng.randn(B, K, T)) * mask[:, None],
            rng.randn(D) * 0.1, rng.randn(D) * 0.1]
    dev = torch.device("cuda")
    out = [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]
    out[0], out[1] = out[0].to(dtype), out[1].to(dtype)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 4, 100, 64), (2, 1, 333, 96),
                                   (2, 6, 70, 512), (16, 1, 400, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_cov", [False, True])
def test_kernel_matches_plain_on_card(shape, dtype, use_cov):
    """Ragged last tiles, K below, at and above the kernel's 4 queries per
    register pass, one fully masked row; and the pointer-generator's
    training shape (K = 1), which bf16 training runs on a bf16 stream."""
    _need_cuda()
    args = _inputs(*shape, dtype)
    before = fa.launches
    ctx, attn = fa.fused_attention_shared(*args, use_cov)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ctx_p, attn_p = fa._attention_plain(*args, use_cov)
    np.testing.assert_allclose(ctx.cpu().numpy(), ctx_p.cpu().numpy(), **TOL)
    np.testing.assert_allclose(attn.cpu().numpy(), attn_p.cpu().numpy(),
                               **TOL)
    assert not attn[1].any() and not ctx[1].any()


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs_on_card():
    _need_cuda()
    args = _inputs(3, 2, 50, 32, torch.float32)
    bad = list(args)
    bad[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)  # strided
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention_shared(*bad, True)
    bad = list(args)
    bad[2] = args[2].cpu()
    with pytest.raises(ValueError, match="mask"):
        fa.fused_attention_shared(*bad, True)


#: T at the fused attention kernel's edges: one position, the 8-position
#: chunk (7, 8, 9), clusters of 8 blocks of one chunk each (63, 64, 65)
#: and of 16 (127, 128, 129: two articles take 16-block clusters, five
#: take 8), the beam-decode T and the long form
FUSED_EDGE_T = (1, 7, 8, 9, 63, 64, 65, 127, 128, 129, 400, 4096)


def _check_fused(args, use_cov):
    before = fa.launches
    ctx, attn = fa.fused_attention_shared(*args, use_cov)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ctx_p, attn_p = fa._attention_plain(*args, use_cov)
    np.testing.assert_allclose(ctx.cpu().numpy(), ctx_p.cpu().numpy(), **TOL)
    np.testing.assert_allclose(attn.cpu().numpy(), attn_p.cpu().numpy(),
                               **TOL)
    assert not attn[1].any() and not ctx[1].any()  # the empty article


@pytest.mark.cuda
@pytest.mark.parametrize("T", FUSED_EDGE_T)
@pytest.mark.parametrize("B", [2, 5])
def test_fused_attention_at_chunk_and_cluster_edges_on_card(T, B):
    """K = 4 (the beam), f32, coverage on, article 1 fully masked."""
    _need_cuda()
    _check_fused(_inputs(B, 4, T, 64, torch.float32, seed=T), True)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_cov", [False, True])
def test_fused_attention_query_counts_on_card(K, dtype, use_cov):
    """K below, at and above one register pass of 4 queries, both
    encoder dtypes, coverage on and off, article 1 fully masked."""
    _need_cuda()
    _check_fused(_inputs(3, K, 129, 96, dtype, seed=K), use_cov)


@pytest.mark.cuda
def test_fused_attention_refuses_what_the_kernel_does_not_take_on_card():
    """A row the kernel cannot stage in 16-byte pieces (D not a multiple
    of 4 in f32, of 8 in bf16) is refused by the kernel's wrapper (the
    entry point pads it: one launch, the plain version's result), and an
    encoder that is not 16-byte aligned is refused; nothing is launched
    for a refusal."""
    _need_cuda()
    B, K, T = 2, 4, 40
    cases = [(_inputs(B, K, T, 6, torch.float32), "multiple of 4"),
             (_inputs(B, K, T, 12, torch.bfloat16), "multiple of 8")]
    before = fa.launches
    for bad, match in cases:
        with pytest.raises(ValueError, match=match):
            fa._attention_cuda(*bad, True)
    assert fa.launches == before
    for padded, _ in cases:
        _check_fused(padded, True)
    args = _inputs(B, K, T, 64, torch.float32)
    flat = torch.empty(B * T * 64 + 1, device="cuda")
    es = flat[1:].view(B, T, 64)  # contiguous, 4 bytes past an alignment
    es.copy_(args[0])
    before = fa.launches
    with pytest.raises(ValueError, match="aligned"):
        fa.fused_attention_shared(es, *args[1:], True)
    assert fa.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_f32", "fused_bf16", "dq_hd32",
                                    "dq_hd128"])
def test_redesigned_kernels_repeat_their_bits_on_card(kernel):
    """Two launches on the same inputs give bitwise-equal outputs: the
    fused attention merges its blocks in rank order, without atomics, and
    a dQ block owns its rows."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    if kernel.startswith("fused"):
        dtype = torch.bfloat16 if kernel.endswith("bf16") else torch.float32
        args = _inputs(16, 4, 400, 512, dtype)

        def run():
            return fa.fused_attention_shared(*args, True)
    else:
        hd = 32 if kernel.endswith("32") else 128
        q, k, v, mask = _flash_inputs(4, 300, 4, hd)
        scale = hd ** -0.5
        out, lse = fl._flash_cuda(q, k, v, mask, False, scale, with_lse=True)
        do = torch.randn_like(q)
        dsum = torch.sum(do * out, dim=-1)

        def run():
            return (fl._bwd_dq_cuda(q, k, v, do, lse, dsum, mask, False,
                                    scale),)
    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _flash_inputs(B, T, nh, hd, seed=0, empty_article=True, qk_std=1.0):
    """q, k, v [B, T, nh, hd] (q and k of std ``qk_std``) and a ragged key
    mask (article 1 fully masked when B > 1 and empty_article)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, T, nh, hd, generator=g, device="cuda")
               for _ in range(3))
    q, k = q * qk_std, k * qk_std
    lens = torch.randint(T // 3, T + 1, (B,), generator=g, device="cuda")
    lens[0] = T
    mask = (torch.arange(T, device="cuda")[None] < lens[:, None]).float()
    if B > 1 and empty_article:
        mask[1] = 0.0
    return q, k, v, mask


#: T at the tensor-core kernels' tile edges: 64-row query and key blocks,
#: 64/32-key forward tiles and 64/16-row backward query tiles
EDGE_T = (63, 64, 65, 128, 129)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,nh,hd", [(3, 100, 8, 32), (2, 333, 2, 32),
                                       (3, 77, 4, 128), (2, 130, 8, 128),
                                       (1, 1, 1, 32), (3, 77, 2, 256),
                                       (16, 400, 2, 256)]
                         + [(2, T, 2, hd) for T in EDGE_T
                            for hd in (32, 128, 256)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_flash_kernel_matches_plain_on_card(B, T, nh, hd, causal, masked):
    """Ragged T (not a multiple of either tile) and T at the tile edges,
    both head dims, causal on and off, with a key mask (one article fully
    masked) and without."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(B, T, nh, hd)
    key_mask = mask if masked else None
    before = fl.launches
    got = fl.flash_attention(q, k, v, key_mask, causal, hd ** -0.5)
    torch.cuda.synchronize()
    assert fl.launches == before + 1
    want = fl._flash_plain(q, k, v, key_mask, causal, hd ** -0.5)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    if masked and B > 1:
        assert not got[1].any()


@pytest.mark.cuda
def test_flash_kernel_rejects_bad_inputs_on_card():
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(2, 40, 4, 32)
    cases = [
        ((q, k.transpose(1, 2).contiguous().transpose(1, 2), v, mask),
         "contiguous"),
        ((q, k, v, mask.cpu()), "key_mask"),
        ((q, k.double(), v, mask), "dtype"),
        ((q, k[:, :20].contiguous(), v, mask), "shape"),
    ]
    before = fl.launches
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            fl.flash_attention(*args, False, 0.1)
    assert fl.launches == before
    # head dim 320, refused before the wide kernels: padded to 384 and
    # taken, one launch of the wide forward
    wide = fl.launches_wide
    q3, k3, v3, _ = _flash_inputs(2, 40, 2, 320)
    got = fl.flash_attention(q3, k3, v3, mask, False, 0.1)
    torch.cuda.synchronize()
    assert (fl.launches, fl.launches_wide) == (before + 1, wide + 1)
    assert got.shape == q3.shape
    np.testing.assert_allclose(
        got.cpu().numpy(),
        fl._flash_plain(q3, k3, v3, mask, False, 0.1).cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 77, 100, 333, *EDGE_T])
@pytest.mark.parametrize("hd", [32, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_flash_backward_kernels_match_plain_on_card(T, hd, causal, masked):
    """Ragged T (not a multiple of either tile), both head dims, causal on
    and off, with a key mask (article 1 empty: exact zero gradients) and
    without.  One backward launches the dK/dV kernel once and the dQ
    kernel once; the forward's lse equals the plain one."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    B, nh = 3, 2
    q, k, v, mask = _flash_inputs(B, T, nh, hd, seed=T)
    key_mask = mask if masked else None
    scale = hd ** -0.5
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = fl.flash_attention(qg, kg, vg, key_mask, causal, scale)
    do = torch.randn_like(out)
    counts = (fl.launches_bwd_dkv, fl.launches_bwd_dq)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert (fl.launches_bwd_dkv, fl.launches_bwd_dq) == \
        (counts[0] + 1, counts[1] + 1)
    _, lse = fl._flash_cuda(q, k, v, key_mask, causal, scale, with_lse=True)
    lse_p = fl._flash_lse_plain(q, k, key_mask, causal, scale)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(), **TOL)
    want = fl._flash_bwd_plain(q, k, v, out.detach(), lse_p, do, key_mask,
                               causal, scale)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)
    if masked and B > 1:
        assert all(not g[1].any() for g in got)


@pytest.mark.cuda
def test_flash_backward_takes_a_strided_cotangent_on_card():
    """A strided dO (as _merge_heads and the wo matmul's backward may
    give) is made contiguous inside the Function, not rejected."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(2, 40, 4, 32)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = fl.flash_attention(qg, kg, vg, mask, False, 0.2)
    do = torch.randn(2, 4, 40, 32, device="cuda").transpose(1, 2)
    assert not do.is_contiguous()
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    lse = fl._flash_lse_plain(q, k, mask, False, 0.2)
    want = fl._flash_bwd_plain(q, k, v, out.detach(), lse, do.contiguous(),
                               mask, False, 0.2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_trained_magnitudes_on_card(hd, causal, dtype):
    """q and k of std 2, so |s| reaches about 20 as in a trained model.
    f32: the 3xTF32 products keep the forward and the lse within TOL and
    the three gradients within 1e-5 * max(1, max|g|), the gradient
    tolerance of the CPU tests (tests/test_torch_flash_backward.py).  An
    elementwise rtol is not a property of f32 at this scale: the plain
    version itself is up to ~2e-5 from float64 on gradient entries of size
    ~1 (scripts/torch_flash_precision.py).  bf16 (the forms that keep the
    running max and lse in log2 units): out and the gradients within
    FLASH_BF16_ULPS of the plain bf16 versions, lse within 1e-5 * max(1,
    |lse|) with the same +inf rows."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(3, 200, 2, hd, seed=7, qk_std=2.0)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    scale = hd ** -0.5
    s_max = float((torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
                   * scale).abs().max())
    assert s_max > 15.0
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = fl.flash_attention(qg, kg, vg, mask, causal, scale)
    do = torch.randn(out.shape, device="cuda").to(dtype)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    _, lse = fl._flash_cuda(q, k, v, mask, causal, scale, with_lse=True)
    torch.cuda.synchronize()
    want_out = fl._flash_plain(q, k, v, mask, causal, scale)
    lse_p = fl._flash_lse_plain(q, k, mask, causal, scale)
    want = fl._flash_bwd_plain(q, k, v, out.detach(), lse_p, do, mask,
                               causal, scale)
    if dtype == torch.bfloat16:
        _within_bf16_ulps(out.detach(), want_out)
        assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
        fin = torch.isfinite(lse_p)
        assert float((lse - lse_p)[fin].abs().max()) <= 1e-5 * max(
            1.0, float(lse_p[fin].abs().max()))
        for g, w in zip(got, want):
            _within_bf16_ulps(g, w)
    else:
        np.testing.assert_allclose(out.detach().cpu().numpy(),
                                   want_out.cpu().numpy(), **TOL)
        np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                                   **TOL)
        for g, w in zip(got, want):
            tol = 1e-5 * max(1.0, float(w.abs().max()))
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=0, atol=tol)
    assert all(not g[1].any() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 160])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_flash_head_dims_padded_to_the_kernels_on_card(hd, causal, masked):
    """Head dims the kernels are not built for (16 pads to 32, 64 to 128,
    160 to 256):
    the forward and both backward kernels against the plain versions at
    the true head dim, one launch each."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(3, 77, 2, hd, seed=hd)
    key_mask = mask if masked else None
    scale = hd ** -0.5
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    counts = (fl.launches, fl.launches_bwd_dkv, fl.launches_bwd_dq)
    out = fl.flash_attention(qg, kg, vg, key_mask, causal, scale)
    do = torch.randn_like(out)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert (fl.launches, fl.launches_bwd_dkv, fl.launches_bwd_dq) == \
        tuple(c + 1 for c in counts)
    assert out.shape == q.shape
    want_out = fl._flash_plain(q, k, v, key_mask, causal, scale)
    np.testing.assert_allclose(out.detach().cpu().numpy(),
                               want_out.cpu().numpy(), **TOL)
    lse_p = fl._flash_lse_plain(q, k, key_mask, causal, scale)
    want = fl._flash_bwd_plain(q, k, v, out.detach(), lse_p, do, key_mask,
                               causal, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)
    with torch.no_grad():  # decode's path: the forward alone
        np.testing.assert_allclose(
            fl.flash_attention(q, k, v, key_mask, causal, scale).cpu().numpy(),
            want_out.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,T,D", [(16, 16, 2000, 512), (4, 4, 17856, 512),
                                     (4, 4, 20000, 512), (4, 4, 60000, 512),
                                     (16, 16, 8000, 512), (2, 64, 8000, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_takes_long_encoders_on_card(B, K, T, D, dtype):
    """Encoders the kernel refused before (16 beams over 2,000 positions;
    4 beams at the old bound of 17,856 positions in f32 and past it),
    and longer ones whose per-position state no longer fits in a block's
    shared memory and lives in device memory (tests/test_torch_attention.py
    pins which): the results equal the plain version's and repeat bit for
    bit."""
    _need_cuda()
    args = _inputs(B, K, T, D, dtype, seed=T)
    _check_fused(args, True)
    first = fa.fused_attention_shared(*args, True)
    second = fa.fused_attention_shared(*args, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _bwd_inputs(B, T, D, seed=0):
    """The backward's inputs: the per-row forward's (article 1 empty), its
    attn output (from the forward kernel where it takes the width, else
    from the plain forward), and the cotangents."""
    es, ef, mask, df, cov, v, w_c = _inputs(B, 1, T, D, torch.float32, seed)
    if fa._shape_refusal(es, df) is None:
        df, cov = df[:, 0].contiguous(), cov[:, 0].contiguous()
        _, attn = fa._attention_rows(es, ef, mask, df, cov, v, w_c, True)
    else:
        _, attn = fa._attention_plain(es, ef, mask, df, cov, v, w_c, True)
        df, cov, attn = df[:, 0].contiguous(), cov[:, 0].contiguous(), \
            attn[:, 0].contiguous()
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    g_ctx = torch.randn(B, D, generator=g, device="cuda")
    g_attn = torch.randn(B, T, generator=g, device="cuda")
    return es, ef, mask, df, cov, v, w_c, attn, g_ctx, g_attn


def _close_scaled(got, want):
    """Within 1e-5 * max(1, max|want|), the CPU tests' gradient tolerance."""
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        tol = 1e-5 * max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(3, 1, 32), (2, 7, 64), (3, 65, 96),
                                   (5, 129, 128), (16, 400, 512),
                                   (2, 4096, 512), (2, 20000, 512),
                                   (2, 5, 64), (3, 300, 132), (2, 333, 516),
                                   (2, 50, 1028), (2, 60, 2308),
                                   (1, 400, 512), (4, 4096, 512),
                                   (40, 400, 512)])
@pytest.mark.parametrize("use_cov", [False, True])
def test_fused_attention_backward_matches_plain_on_card(B, T, D, use_cov):
    """Ragged T (one position, fewer than a ring chunk's 8 rows, the
    cluster edges, the training shape, long encoders), D not a multiple
    of 128 and past 1,024 (two and three column groups a thread), one and
    four articles (wide clusters), 40 (more clusters than fit at once),
    coverage on and off, article 1 empty: zero gradients, d_cov and d_w_c
    zero without coverage; one launch."""
    _need_cuda()
    args = _bwd_inputs(B, T, D, seed=T)
    before = fa.launches_bwd
    got = fa._attention_bwd_cuda(*args, use_cov)
    torch.cuda.synchronize()
    assert fa.launches_bwd == before + 1
    want = fa._attention_bwd_plain(*args, use_cov)
    _close_scaled(got, want)
    if B > 1:
        assert all(not g[1].any() for g in got[:4])
    if not use_cov:
        assert not got[3].any() and not got[5].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(16, 400), (4, 4096)])
@pytest.mark.parametrize("use_cov", [False, True])
def test_fused_attention_backward_repeats_its_bits_on_card(B, T, use_cov):
    """No float atomics: two launches on the same inputs give the same
    bits, d_v and d_w_c (sums over articles and positions, the last
    cluster's) included, at the training shape and a long encoder."""
    _need_cuda()
    args = _bwd_inputs(B, T, 512)
    first = fa._attention_bwd_cuda(*args, use_cov)
    second = fa._attention_bwd_cuda(*args, use_cov)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _bwd_entry(args, is_bf16):
    """The backward's C entry point called directly with its part sized
    by the wrapper's mirror (_bwd_part_floats): (its error code, the six
    outputs)."""
    B, T, D = args[0].shape
    outs = [torch.empty_like(x) for x in (args[0], args[1], args[3],
                                          args[7], args[5], args[6])]
    stream = torch.cuda.current_stream()
    lib = fa._load_bwd_library()
    floats = fa._bwd_part_floats(B, T, D, 2 if is_bf16 else 4)
    assert lib.ts_fused_attention_bwd_part(B, T, D, int(is_bf16)) == floats
    part = fa._bwd_scratch(args[0].device, stream.cuda_stream, floats)
    err = lib.ts_fused_attention_bwd(
        *(x.data_ptr() for x in args), None, *(x.data_ptr() for x in outs),
        part.data_ptr(), B, T, D, 1, int(is_bf16), stream.cuda_stream)
    torch.cuda.synchronize()
    return err, outs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2304, 2308, 2312, 3072, 3076])
def test_fused_attention_backward_refusal_matches_the_kernel_on_card(D):
    """_bwd_form mirrors the kernel's choice: the C entry point launches
    every width (the dense form up to 2,308 columns in f32, the slab form
    past it) and asks for the scratch _bwd_part_floats gives; each width
    agrees with the plain backward."""
    _need_cuda()
    args = _bwd_inputs(2, 20, D)
    assert fa._bwd_shape_refusal(args[0]) is None
    assert (fa._bwd_form(D) == "slab") == (D > 2308)
    err, outs = _bwd_entry(args, False)
    assert err == 0
    _close_scaled(outs, fa._attention_bwd_plain(*args, True))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2312, 3068, 3072, 3076, 3080])
def test_fused_attention_backward_bf16_refusal_matches_the_kernel_on_card(D):
    """The same for bf16 encoder streams: D a multiple of 8 (16-byte rows
    for the TMA copies), the dense form up to 3,072 columns, the slab
    form past it; other D refused (cudaErrorInvalidValue, 1) by both."""
    _need_cuda()
    args = list(_bwd_inputs(2, 20, D))
    args[0], args[1] = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    refused = fa._bwd_shape_refusal(args[0]) is not None
    assert refused == (D % 8 != 0)
    assert (fa._bwd_form(D, 2) == "slab") == (D > 3072)
    err, outs = _bwd_entry(args, True)
    assert err == (1 if refused else 0)
    if not refused:
        _close_bf16(outs, fa._attention_bwd_plain(*args, True))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,T,D", [(16, 4, 400, 2400), (4, 1, 400, 4096),
                                     (3, 4, 37, 2236), (2, 64, 50, 512),
                                     (5, 2, 130, 1028 * 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_cov", [False, True])
def test_fused_attention_slab_form_matches_plain_on_card(B, K, T, D, dtype,
                                                         use_cov):
    """The slab forward (widths whose dense form does not fit one block;
    many queries with narrower slabs; a last slab narrower than the
    rest; state in shared or device memory) against the plain version,
    every launch counted as a slab launch where _launch_form says so, a
    rerun the same bits."""
    _need_cuda()
    args = _inputs(B, K, T, D, dtype, seed=D)
    elt = 2 if dtype == torch.bfloat16 else 4
    slab = fa._launch_form(B, T, fa._padded_width(D, dtype), K, elt,
                           fa._sm_count(args[0].device))[3]
    before = fa.launches_slab
    _check_fused(args, use_cov)
    assert fa.launches_slab - before == (1 if slab else 0)
    first = fa.fused_attention_shared(*args, use_cov)
    again = fa.fused_attention_shared(*args, use_cov)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(16, 400, 2400), (4, 400, 4096),
                                   (3, 65, 2312), (2, 9, 5000)])
@pytest.mark.parametrize("use_cov", [False, True])
def test_fused_attention_backward_slab_form_matches_plain_on_card(B, T, D,
                                                                  use_cov):
    """The slab backward (past the dense form's 2,308 f32 columns; a last
    slab narrower than 512) against the plain backward, one slab launch,
    the empty article's gradients zero, a rerun the same bits."""
    _need_cuda()
    args = _bwd_inputs(B, T, D, seed=T)
    before = fa.launches_bwd_slab
    got = fa._attention_bwd_cuda(*args, use_cov)
    again = fa._attention_bwd_cuda(*args, use_cov)
    torch.cuda.synchronize()
    assert fa.launches_bwd_slab == before + 2
    _close_scaled(got, fa._attention_bwd_plain(*args, use_cov))
    assert all(not g[1].any() for g in got[:4])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,T,D", [(16, 4, 200, 512), (16, 1, 200, 512),
                                     (3, 4, 40, 2400), (2, 1, 9, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_sp_block_form_matches_plain_on_card(B, K, T, D,
                                                             dtype):
    """The sp-block forward: ctx and attn normalised over the block, the
    row max and the unfloored row sum against _attention_block_plain (a
    fully masked row: m at NEG, l 0); one sp launch."""
    _need_cuda()
    args = _inputs(B, K, T, D, dtype, seed=T)
    before = fa.launches_sp
    got = fa.fused_attention_block(*args, True)
    torch.cuda.synchronize()
    assert fa.launches_sp == before + 1
    want = fa._attention_block_plain(*args, True)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)
    valid = (want[3] > 0).cpu().numpy()
    np.testing.assert_allclose(got[2].cpu().numpy()[valid],
                               want[2].cpu().numpy()[valid], **TOL)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(),
                               **TOL)
    assert (got[2].cpu().numpy()[~valid] == np.float32(fa.NEG)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(16, 200, 512), (3, 40, 2400)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_backward_sp_block_form_on_card(B, T, D, dtype):
    """The sp-block backward takes its softmax correction from outside:
    against the plain backward with the same correction; one sp launch;
    the dense and slab widths."""
    _need_cuda()
    args = list(_bwd_inputs(B, T, D, seed=T))
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    correction = torch.randn(B, device="cuda")
    before = fa.launches_bwd_sp
    got = fa._attention_bwd_cuda(*args, True, correction)
    torch.cuda.synchronize()
    assert fa.launches_bwd_sp == before + 1
    want = fa._attention_bwd_plain(*args, True, correction)
    if dtype == torch.bfloat16:
        _close_bf16(got, want)
    else:
        _close_scaled(got, want)


def _bf16_ulp(x):
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _close_bf16(got, want):
    """bf16 streams: d_es and d_ef are f32 values within _close_scaled's
    tolerance of each other (the sums run in other orders, and a
    difference of nearby terms keeps that absolute error), rounded once
    to bf16 by kernel and plain version alike: within one bf16 ulp of the
    plain version's plus that tolerance.  The f32 rest as _close_scaled
    holds them."""
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == torch.bfloat16
        tol = 1e-5 * max(1.0, float(w.float().abs().max()))
        assert bool(((g.float() - w.float()).abs()
                     <= _bf16_ulp(w) + tol).all())
    _close_scaled(got[2:], want[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(16, 400, 512), (4, 4096, 512),
                                   (2, 1, 8), (3, 65, 136), (2, 333, 520),
                                   (2, 60, 2312), (40, 400, 512)])
@pytest.mark.parametrize("use_cov", [False, True])
def test_fused_attention_backward_bf16_matches_plain_on_card(B, T, D,
                                                              use_cov):
    """The backward kernel's bf16 encoder-stream form against the plain
    backward: the training shape, a long encoder, one position, ragged T
    and D, past 2,308 columns (taken in bf16 only), 40 articles; coverage
    on and off; article 1 empty; two launches give the same bits."""
    _need_cuda()
    args = list(_bwd_inputs(B, T, D, seed=T))
    args[0], args[1] = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    before = (fa.launches_bwd, fa.launches_bwd_bf16)
    got = fa._attention_bwd_cuda(*args, use_cov)
    again = fa._attention_bwd_cuda(*args, use_cov)
    torch.cuda.synchronize()
    assert (fa.launches_bwd, fa.launches_bwd_bf16) == (before[0] + 2,
                                                       before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close_bf16(got, fa._attention_bwd_plain(*args, use_cov))
    if B > 1:
        assert all(not g[1].any() for g in got[:4])


@pytest.mark.cuda
def test_fused_attention_backward_leaves_its_ticket_zero_on_card():
    """The one-launch backward learns which cluster ends last from an
    unsigned ticket at the start of its per-stream scratch: every launch,
    at any article count and on any stream, sets it back to 0, so the
    next launch on that scratch computes d_v and d_w_c."""
    _need_cuda()
    dev = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            for B, T, D in ((1, 300, 512), (16, 400, 512), (40, 60, 132),
                            (4, 4096, 512), (16, 400, 512)):
                args = _bwd_inputs(B, T, D, seed=B)
                got = fa._attention_bwd_cuda(*args, True)
                stream.synchronize()
                part = fa._bwd_scratch(dev, stream.cuda_stream, 4)
                assert int(part[:1].view(torch.int32)) == 0
                _close_scaled(got, fa._attention_bwd_plain(*args, True))


@pytest.mark.cuda
@pytest.mark.parametrize("use_cov", [False, True])
def test_fused_attention_function_on_card_matches_the_cpu(use_cov):
    """Autograd through FusedAttention on CUDA tensors (the forward and
    backward kernels, one launch each) gives the CPU path's gradients."""
    _need_cuda()
    es, ef, mask, df, cov, v, w_c, _, g_ctx, g_attn = _bwd_inputs(4, 150, 64)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).clone().requires_grad_()
                  for x in (es, ef, df, cov, v, w_c)]
        counts = (fa.launches, fa.launches_bwd)
        ctx, attn = fa.fused_attention(leaves[0], leaves[1], mask.to(dev),
                                       *leaves[2:], use_cov)
        loss = (ctx * g_ctx.to(dev)).sum() + (attn * g_attn.to(dev)).sum()
        grads[dev] = torch.autograd.grad(loss, leaves)
        launched = (fa.launches - counts[0], fa.launches_bwd - counts[1])
        assert launched == ((1, 1) if dev == "cuda" else (0, 0))
    _close_scaled([g.cpu() for g in grads["cuda"]], grads["cpu"])


@pytest.mark.cuda
def test_fused_attention_backward_refuses_on_card():
    """An fp16 encoder stream (the kernel takes f32 and bf16), a bf16
    stream with D not a multiple of 8, and an f32 one with D not a
    multiple of 4 are refused, and nothing is launched."""
    _need_cuda()
    args = list(_bwd_inputs(2, 40, 64))
    before = fa.launches_bwd
    fp16 = [args[0].half(), args[1].half()] + args[2:]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._attention_bwd_cuda(*fp16, True)
    args12 = list(_bwd_inputs(2, 40, 12))
    bf16 = [args12[0].to(torch.bfloat16), args12[1].to(torch.bfloat16)] + \
        args12[2:]
    with pytest.raises(ValueError, match="multiple of 8"):
        fa._attention_bwd_cuda(*bf16, True)
    odd = list(_bwd_inputs(2, 40, 64))
    odd = [odd[0][..., :62].contiguous(), odd[1][..., :62].contiguous(),
           odd[2], odd[3][..., :62].contiguous(), odd[4],
           odd[5][:62].contiguous(), odd[6][:62].contiguous(), odd[7],
           odd[8][..., :62].contiguous(), odd[9]]
    with pytest.raises(ValueError, match="multiple of 4"):
        fa._attention_bwd_cuda(*odd, True)
    assert fa.launches_bwd == before


@pytest.mark.cuda
def test_pipeline_fit_then_transform_on_card_matches_the_cpu(tmp_path):
    """SummarizationEstimator.fit (2 steps) then SummarizationModel.transform
    at a small width, once with --device=cuda and once with --device=cpu,
    from one initial checkpoint: the same rows (summaries equal), params
    and accumulators within 1e-4 relative to max(1, max|x|), and on the
    card exactly one fused forward and one backward launch per decoder
    step per train step and two fused launches per beam step (none on
    the CPU)."""
    import shlex

    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.config import HParams
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params
    from textsummarization_on_flink_tpu_torch.pipeline import estimator as est
    from textsummarization_on_flink_tpu_torch.pipeline import io
    from textsummarization_on_flink_tpu_torch.train import trainer

    _need_cuda()
    words = [f"w{i}" for i in range(96)]
    rng = np.random.RandomState(0)
    rows = []
    for i in range(8):
        art = [words[j] if rng.rand() < 0.8 else f"oov{j % 5}"
               for j in rng.randint(0, len(words), rng.randint(12, 40))]
        rows.append((f"u{i}", " ".join(art) + " .", "",
                     " ".join(art[:6]) + " ."))
    fields = dict(batch_size=4, hidden_dim=32, emb_dim=16, vocab_size=100,
                  max_enc_steps=40, max_dec_steps=12, min_dec_steps=3,
                  beam_size=4, max_oov_buckets=8, coverage=True,
                  exp_name="exp", trunc_norm_init_std=0.5,
                  rand_unif_init_mag=0.3)
    params = init_numpy_params(HParams(**fields), 100, 0)
    params["embedding"] *= 4.0
    params["output_projection"]["w"] *= 4.0
    out = {}
    for dev in ("cpu", "cuda"):
        root = str(tmp_path / dev)
        hps = {m: HParams(mode=m, num_steps=2, log_root=root, device=dev,
                          **fields) for m in ("train", "decode")}
        ckpt_lib.Checkpointer(est.train_dir_for(hps["train"])).save(
            trainer.make_train_state(params, None, 0, "cpu",
                                     init_acc=hps["train"].adagrad_init_acc))
        e = est.SummarizationEstimator()
        e.set_train_selected_cols(["uuid", "article", "reference"])
        e.set_inference_selected_cols(["uuid", "article", "reference"])
        e.set_inference_output_cols(["uuid", "article", "summary",
                                     "reference"])
        e.set_inference_output_types(["STRING"] * 4)
        e.set_train_hyper_params(shlex.split(hps["train"].to_argv()))
        e.set_inference_hyper_params(shlex.split(hps["decode"].to_argv()))
        e.with_vocab(Vocab(words=words))
        counts = (fa.launches, fa.launches_bwd)
        model = e.fit(io.CollectionSource(rows))
        fit = (fa.launches - counts[0], fa.launches_bwd - counts[1])
        counts, steps = fa.launches, beam_search.steps_run
        sink = model.transform(io.CollectionSource(rows))
        transform = (fa.launches - counts, beam_search.steps_run - steps)
        out[dev] = (sorted(sink.rows), ckpt_lib.load_arrays(
            ckpt_lib.latest_checkpoint(est.train_dir_for(hps["train"]))),
            fit, transform)
    (cpu_rows, cpu_arrays, cpu_fit, cpu_tf) = out["cpu"]
    (rows_, arrays, fit, (tf_launches, beam_steps)) = out["cuda"]
    assert cpu_fit == (0, 0) and cpu_tf[0] == 0
    assert fit == (2 * 12, 2 * 12)
    assert beam_steps > 0 and tf_launches == 2 * beam_steps
    assert len(rows_) == 8 and rows_ == cpu_rows
    assert int(arrays["step"]) == 2
    for k, w in cpu_arrays.items():
        err = float(np.max(np.abs(arrays[k] - w)))
        assert err <= 1e-4 * max(1.0, float(np.max(np.abs(w)))), (k, err)


def _small_pg(**kw):
    from textsummarization_on_flink_tpu_torch.config import HParams

    return HParams(**{**dict(mode="train", batch_size=4, hidden_dim=32,
                             emb_dim=16, vocab_size=100, max_enc_steps=40,
                             max_dec_steps=12, min_dec_steps=3,
                             max_oov_buckets=8, coverage=True), **kw})


def _small_batches(hps, n):
    from textsummarization_on_flink_tpu_torch.data import batching
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab

    words = [f"w{i}" for i in range(hps.vocab_size - 4)]
    vocab = Vocab(words=words)
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        exs = []
        for _ in range(hps.batch_size):
            art = [words[j] if rng.rand() < 0.8 else f"oov{j % 5}"
                   for j in rng.randint(0, len(words), rng.randint(12, 40))]
            abs_ = [art[j] for j in rng.randint(0, len(art),
                                                rng.randint(3, 11))]
            exs.append(batching.SummaryExample.build(
                " ".join(art), [" ".join(abs_)], vocab, hps))
        out.append(batching.Batch(exs, hps, vocab).as_arrays())
    return out


def _loss_and_grads(hps, params, arrays, dev):
    from textsummarization_on_flink_tpu_torch.decode.beam_search import (
        _to_device,
    )
    from textsummarization_on_flink_tpu_torch.models import (
        pointer_generator as pg,
    )
    from textsummarization_on_flink_tpu_torch.params import (
        from_numpy_tree,
        tree_leaves,
    )

    p = from_numpy_tree(params, dev)
    for x in tree_leaves(p):
        x.requires_grad_(True)
    out = pg.forward_train(p, hps, _to_device(arrays, dev))
    grads = torch.autograd.grad(out.total_loss, tree_leaves(p))
    return float(out.total_loss.detach()), [g.cpu().numpy() for g in grads]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 5, 99])
def test_streaming_loss_on_card_matches_the_materialised_loss(chunk):
    """--loss_chunk on the card (the fused kernels forward and backward,
    the chunks' recomputed scores): the loss and every gradient of the
    pointer-generator equal the card's materialised loss within 1e-5 *
    max(1, max|g|), and the CPU's streaming loss within 1e-4 (other sum
    orders on the card)."""
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params

    _need_cuda()
    hps = _small_pg(loss_chunk=chunk, device="cuda")
    params = init_numpy_params(hps, hps.vocab_size, 0)
    arrays = _small_batches(hps, 1)[0]
    loss, grads = _loss_and_grads(hps, params, arrays, "cuda")
    m_loss, m_grads = _loss_and_grads(hps.replace(loss_chunk=0), params,
                                      arrays, "cuda")
    c_loss, c_grads = _loss_and_grads(hps, params, arrays, "cpu")
    assert loss == pytest.approx(m_loss, rel=1e-6)
    assert loss == pytest.approx(c_loss, rel=1e-4)
    for g, m, c in zip(grads, m_grads, c_grads):
        assert np.max(np.abs(g - m)) <= 1e-5 * max(1.0, np.max(np.abs(m)))
        assert np.max(np.abs(g - c)) <= 1e-4 * max(1.0, np.max(np.abs(c)))


@pytest.mark.cuda
def test_bf16_train_step_on_card_matches_the_cpu():
    """One train step of the pointer-generator with --compute_dtype=
    bfloat16 --opt_state_dtype=bfloat16 --loss_chunk=5 on the card (the
    fused kernels' bf16 forms, bf16 GEMMs) against --device=cpu: the loss,
    the new params and accumulators within 4 times the CPU's own distance
    between its bf16 and f32 steps (the rule of the CPU tests against the
    JAX package: the card's GEMMs round bf16 at other places), and every
    fused launch on a bf16 stream."""
    from textsummarization_on_flink_tpu_torch.decode.beam_search import (
        _to_device,
    )
    from textsummarization_on_flink_tpu_torch.params import (
        init_numpy_params,
        tree_leaves,
    )
    from textsummarization_on_flink_tpu_torch.train import trainer

    _need_cuda()
    hps = _small_pg(compute_dtype="bfloat16", opt_state_dtype="bfloat16",
                    loss_chunk=5)
    params = init_numpy_params(hps, hps.vocab_size, 1)
    params["embedding"] *= 4.0
    arrays = _small_batches(hps, 1)[0]
    runs = {}
    for dev, h in (("cuda", hps), ("cpu", hps),
                   ("cpu32", hps.replace(compute_dtype="float32",
                                         opt_state_dtype="float32"))):
        d = "cpu" if dev == "cpu32" else dev
        h = h.replace(device=d)
        state = trainer.init_train_state(h, h.vocab_size, params=params)
        counts = (fa.launches_bf16, fa.launches_bwd_bf16)
        state, m = trainer.train_step(h, state, _to_device(arrays, d))
        launched = (fa.launches_bf16 - counts[0],
                    fa.launches_bwd_bf16 - counts[1])
        runs[dev] = (float(m.loss), [
            x.detach().float().cpu().numpy() for x in
            tree_leaves(state.params) + tree_leaves(
                state.opt_state.accumulators)], launched)
    (g_loss, g_leaves, launched), (c_loss, c_leaves, _), (f_loss, f_leaves,
                                                          _) = (
        runs["cuda"], runs["cpu"], runs["cpu32"])
    assert launched == (hps.max_dec_steps, hps.max_dec_steps)
    assert abs(g_loss - c_loss) <= 4 * abs(c_loss - f_loss) + 1e-5
    for g, c, f in zip(g_leaves, c_leaves, f_leaves):
        bound = 4 * float(np.max(np.abs(c - f))) + 1e-5 * max(
            1.0, float(np.max(np.abs(c))))
        assert float(np.max(np.abs(g - c))) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [255, 400, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_takes_wide_pointer_generators_on_card(hidden,
                                                              dtype):
    """Encoder widths D = 2 * hidden_dim the kernels refused before (odd
    hidden_dim: D not a multiple of 4 in f32 or 8 in bf16; D past the
    8-chunk ring's shared memory): the beam-decode shape (16 articles x 4
    beams, T 400) and the per-row training shape with its backward
    through FusedAttention (16 x 400), then 2 articles x 4 beams (the
    wide clusters, whose ring steps down at these widths), each against
    the plain version, one launch per call."""
    _need_cuda()
    D = 2 * hidden
    for B, K in ((16, 4), (2, 4)):
        args = _inputs(B, K, 400, D, dtype, seed=hidden)
        before = fa.launches
        ctx, attn = fa.fused_attention_shared(*args, True)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        ctx_p, attn_p = fa._attention_plain(*args, True)
        np.testing.assert_allclose(ctx.cpu().numpy(), ctx_p.cpu().numpy(),
                                   **TOL)
        np.testing.assert_allclose(attn.cpu().numpy(), attn_p.cpu().numpy(),
                                   **TOL)
    es, ef, mask, df, cov, v, w_c = _inputs(16, 1, 400, D, dtype,
                                            seed=hidden)
    df, cov = df[:, 0].contiguous(), cov[:, 0].contiguous()
    leaves = [x.clone().requires_grad_() for x in (es, ef, df, cov, v, w_c)]
    gen = torch.Generator(device="cuda").manual_seed(hidden)
    g_ctx = torch.randn(16, D, generator=gen, device="cuda")
    g_attn = torch.randn(16, 400, generator=gen, device="cuda")
    counts = (fa.launches, fa.launches_bwd)
    ctx, attn = fa.fused_attention(leaves[0], leaves[1], mask, *leaves[2:],
                                   True)
    got = torch.autograd.grad((ctx * g_ctx).sum() + (attn * g_attn).sum(),
                              leaves)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_bwd) == (counts[0] + 1, counts[1] + 1)
    _, attn_p = fa._attention_plain(es, ef, mask, df[:, None], cov[:, None],
                                    v, w_c, True)
    want = fa._attention_bwd_plain(es, ef, mask, df, cov, v, w_c,
                                   attn_p[:, 0].contiguous(), g_ctx, g_attn,
                                   True)
    if dtype == torch.bfloat16:
        _close_bf16(got, want)
    else:
        _close_scaled(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [255, 400, 512])
def test_wide_pointer_generator_train_step_on_card_matches_the_cpu(hidden):
    """The pointer-generator's loss and every gradient at hidden_dim 255,
    400 and 512 (the fused kernels at D = 510 padded to 512, 800 and
    1,024) on the card against --device=cpu: within 1e-4 relative, and 1
    fused forward and 1 backward launch per decoder step."""
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params

    _need_cuda()
    hps = _small_pg(hidden_dim=hidden, device="cuda")
    hps.validate()
    params = init_numpy_params(hps, hps.vocab_size, 0)
    arrays = _small_batches(hps, 1)[0]
    counts = (fa.launches, fa.launches_bwd)
    loss, grads = _loss_and_grads(hps, params, arrays, "cuda")
    assert (fa.launches - counts[0], fa.launches_bwd - counts[1]) == \
        (hps.max_dec_steps, hps.max_dec_steps)
    c_loss, c_grads = _loss_and_grads(hps, params, arrays, "cpu")
    assert loss == pytest.approx(c_loss, rel=1e-4)
    for g, c in zip(grads, c_grads):
        assert np.max(np.abs(g - c)) <= 1e-4 * max(1.0, np.max(np.abs(c)))


def _serve_setup(**kw):
    """A small pointer-generator with its params and 8 seeded articles,
    for the serve layer on the card."""
    from textsummarization_on_flink_tpu_torch.config import HParams
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params

    words = [f"w{i}" for i in range(96)]
    rng = np.random.RandomState(1)
    articles = [" ".join(words[j] if rng.rand() < 0.8 else f"oov{j % 5}"
                         for j in rng.randint(0, len(words),
                                              rng.randint(12, 40))) + " ."
                for _ in range(8)]
    fields = dict(mode="decode", batch_size=8, hidden_dim=32, emb_dim=16,
                  vocab_size=100, max_enc_steps=40, max_dec_steps=12,
                  min_dec_steps=3, beam_size=4, max_oov_buckets=8,
                  coverage=True, trunc_norm_init_std=0.5,
                  rand_unif_init_mag=0.3, serve_buckets="40",
                  serve_max_wait_ms=200.0, **kw)
    params = init_numpy_params(HParams(**fields), 100, 0)
    params["embedding"] *= 4.0
    params["output_projection"]["w"] *= 4.0
    return fields, params, words, articles


def _serve_pinned(hps, params, words, articles, root):
    """The articles submitted before start(): one dispatch."""
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.obs import Registry
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )

    reg = Registry()
    server = ServingServer(hps, Vocab(words=words), params=params,
                           decode_root=root, registry=reg)
    futs = [server.submit(a, uuid=f"u{i}") for i, a in enumerate(articles)]
    with server:
        res = [f.result(timeout=300) for f in futs]
    return [r.decoded_words for r in res], reg


@pytest.mark.cuda
def test_serving_server_matches_the_cpu_on_card(tmp_path):
    """A pinned group of 8 through the ServingServer on the card and on
    the CPU (device="cpu"): the same summaries, token for token, in one
    dispatch each."""
    from textsummarization_on_flink_tpu_torch.config import HParams

    _need_cuda()
    fields, params, words, articles = _serve_setup()
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = _serve_pinned(HParams(device=dev, **fields), params,
                                 words, articles, str(tmp_path / dev))
    assert out["cuda"][0] == out["cpu"][0]
    assert any(out["cuda"][0])
    for _, reg in out.values():
        fill = reg.histogram("serve/batch_fill")
        assert (fill.count, fill.sum) == (1, 8.0)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["beam", "greedy"])
def test_serve_dispatch_runs_the_fused_kernel_on_card(tmp_path, tier):
    """Every beam step of a serve dispatch launches the fused attention
    kernel twice, at the beam tier and at the greedy tier (K = 1)."""
    from textsummarization_on_flink_tpu_torch.config import HParams
    from textsummarization_on_flink_tpu_torch.decode import beam_search

    _need_cuda()
    fields, params, words, articles = _serve_setup(serve_default_tier=tier)
    counts, steps = fa.launches, beam_search.steps_run
    got, reg = _serve_pinned(HParams(device="cuda", **fields), params, words,
                             articles, str(tmp_path))
    launched, beam_steps = fa.launches - counts, beam_search.steps_run - steps
    assert beam_steps > 0 and launched == 2 * beam_steps
    assert reg.counter(f"serve/tier_{tier}_total").value == 8
    assert len(got) == 8


# ---------------------------------------------------------------------------
# the flash kernels' bf16 forms (the transformer under compute_dtype=
# bfloat16): within FLASH_BF16_ULPS bf16 ulps of the tensor's largest
# |value| of their plain bf16 versions
# ---------------------------------------------------------------------------

#: kernel and plain version round P (and dS) to bf16 at the same points,
#: but the forward rounds P against the online softmax's running max and
#: the plain version against the row max, and the f32 sums before each
#: final rounding run in other orders
FLASH_BF16_ULPS = 2


def _within_bf16_ulps(got, want, ulps=FLASH_BF16_ULPS):
    assert got.dtype == want.dtype == torch.bfloat16
    bound = ulps * float(_bf16_ulp(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= bound, (err, bound)


def _flash_bf16_inputs(B, T, nh, hd, seed=0):
    q, k, v, mask = _flash_inputs(B, T, nh, hd, seed=seed)
    return (*(x.to(torch.bfloat16) for x in (q, k, v)), mask)


#: the product checks of the bf16 kernels' building blocks
#: (ts_flash_wgmma_check): (hd, ny, x0, col0) at the kernels' (hd, tile
#: rows), each warpgroup's row offset, and both column halves at hd 256:
#: the backward's (32, 64), (128, 32), (128, 64), (256, 32) and the
#: forward's (hd, keys per tile), (32, 128), (128, 128), (256, 64)
WGMMA_CHECKS = [(32, 64, 0, 0), (32, 64, 64, 0), (128, 32, 0, 0),
                (128, 32, 64, 0), (128, 64, 0, 0), (128, 64, 64, 0),
                (256, 32, 0, 0), (256, 32, 64, 128), (32, 128, 0, 0),
                (32, 128, 64, 0), (128, 128, 0, 0), (128, 128, 64, 0),
                (256, 64, 0, 0), (256, 64, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,ny,x0,col0", WGMMA_CHECKS)
def test_wgmma_bf16_products_on_card(hd, ny, x0, col0):
    """One warpgroup's wgmma products from TMA-copied tiles
    (kernels/wgmma_bf16.cuh), the bf16 kernels' building blocks: d1 =
    X[x0:x0+64] Y^T with both operands K-major in the copy's 64- or
    128-byte swizzle (S^T = K Q^T, S = Q K^T), then d2 = bf16(d1)
    Z[:, col0:col0+128] with A from the accumulator's registers and Z
    M|N-major (O += P V, dV += P^T dO, dQ += dS K).  Small integers
    (|d1| <= hd <= 256 is exact in bf16), so every product and sum is
    exact and both must equal torch.matmul in f32."""
    import ctypes

    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(hd + ny + x0 + col0)
    x = torch.randint(-1, 2, (128, hd), generator=g, device="cuda")
    y = torch.randint(-1, 2, (ny, hd), generator=g, device="cuda")
    z = torch.randint(-4, 5, (ny, hd), generator=g, device="cuda")
    x, y, z = (a.to(torch.bfloat16) for a in (x, y, z))
    od = min(hd, 128)
    d1 = torch.empty(64, ny, device="cuda")
    d2 = torch.empty(64, od, device="cuda")
    lib = fl._load_bwd_library()
    fn = lib.ts_flash_wgmma_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    err = fn(x.data_ptr(), y.data_ptr(), z.data_ptr(), d1.data_ptr(),
             d2.data_ptr(), hd, ny, x0, col0,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want1 = x[x0:x0 + 64].float() @ y.float().T
    assert torch.equal(d1, want1)
    assert torch.equal(d2, want1 @ z[:, col0:col0 + od].float())


#: T at the bf16 backward's TMA and tile edges (128-row blocks of two
#: warpgroups, 32- and 64-row ring tiles), beside EDGE_T
BF16_EDGE_T = (127, 2049)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,nh,hd,causal,masked", [
    (16, 400, 8, 32, False, True), (16, 100, 8, 32, True, False),
    (4, 2048, 8, 128, False, True), (4, 2048, 8, 128, True, False),
    (16, 400, 2, 256, False, True), (16, 100, 2, 256, True, False),
    (3, 77, 4, 128, True, True), (1, 1, 1, 32, False, False)]
    + [(2, T, 2, hd, causal, True) for T in EDGE_T + BF16_EDGE_T
       for hd in (32, 128, 256) for causal in (False, True)])
def test_flash_bf16_kernels_match_plain_on_card(B, T, nh, hd, causal,
                                                masked):
    """The bf16 forms of the forward, dK/dV and dQ kernels at the
    transformer's shapes (the encoder's key mask, the training decoder's
    causal form, the long-context shape, head dim 256) and at the tile
    edges: out and the three gradients in bf16 within FLASH_BF16_ULPS of
    the plain bf16 versions, lse (f32) within 1e-5 * max(1, |lse|); one
    launch of each bf16 form, none of the f32 forms; an empty article's
    outputs exact zeros."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_bf16_inputs(B, T, nh, hd, seed=T + hd)
    key_mask = mask if masked else None
    scale = hd ** -0.5
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    counts = (fl.launches, fl.launches_bf16, fl.launches_bwd_dkv_bf16,
              fl.launches_bwd_dq_bf16)
    out = fl.flash_attention(qg, kg, vg, key_mask, causal, scale)
    do = torch.randn(out.shape, device="cuda").to(torch.bfloat16)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert (fl.launches, fl.launches_bf16, fl.launches_bwd_dkv_bf16,
            fl.launches_bwd_dq_bf16) == tuple(c + 1 for c in counts)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in got)
    _within_bf16_ulps(out.detach(),
                      fl._flash_plain(q, k, v, key_mask, causal, scale))
    _, lse = fl._flash_cuda(q, k, v, key_mask, causal, scale, with_lse=True)
    lse_p = fl._flash_lse_plain(q, k, key_mask, causal, scale)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
    fin = torch.isfinite(lse_p)
    assert float((lse - lse_p)[fin].abs().max()) <= 1e-5 * max(
        1.0, float(lse_p[fin].abs().max()))
    want = fl._flash_bwd_plain(q, k, v, out.detach(), lse_p, do, key_mask,
                               causal, scale)
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        _within_bf16_ulps(g, w)
    if masked and B > 1:
        assert not out[1].any() and all(not g[1].any() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_single_key_rows_on_card(hd, causal):
    """T = 1, each copy of a tile one real row and the rest zero-filled:
    out and dv within FLASH_BF16_ULPS of the plain versions.  Every row
    attends its one key with P = 1, so dS = P (dP - D), and with it dq and
    dk, are 0 in exact arithmetic; kernel and plain version both return
    the f32 rounding of dP - D (two sums of hd products in other orders)
    times sm_scale and one row of k or q, held to that rounding's bound.
    An empty article (key mask) gives exact zeros."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_bf16_inputs(2, 1, 2, hd, seed=hd)
    key_mask = None if causal else mask
    scale = hd ** -0.5
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = fl.flash_attention(qg, kg, vg, key_mask, causal, scale)
    do = torch.randn(out.shape, device="cuda").to(torch.bfloat16)
    dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    _within_bf16_ulps(out.detach(), fl._flash_plain(q, k, v, key_mask,
                                                    causal, scale))
    lse_p = fl._flash_lse_plain(q, k, key_mask, causal, scale)
    want = fl._flash_bwd_plain(q, k, v, out.detach(), lse_p, do, key_mask,
                               causal, scale)
    _within_bf16_ulps(dv, want[2])
    terms = float((do.float() * v.float()).abs().sum(-1).max())
    for g, w, other in ((dq, want[0], k), (dk, want[1], q)):
        noise = 2 * hd * 2.0 ** -24 * terms * scale * float(
            other.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= noise
    if key_mask is not None:
        assert not out[1].any() and not any(x[1].any() for x in (dq, dk, dv))


#: the bit-repeat shapes of the bf16 forms: the encoder's, the training
#: decoder's, the long causal form and head dim 256 at a tile edge
BF16_REPEAT_SHAPES = [(16, 400, 8, 32, False), (16, 100, 8, 32, True),
                      (4, 2048, 8, 128, True), (2, 129, 2, 256, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,nh,hd,causal", BF16_REPEAT_SHAPES)
def test_flash_bf16_forward_repeats_its_bits_on_card(B, T, nh, hd, causal):
    """Two runs of the bf16 forward on the same inputs give bitwise-equal
    out and lse (the training form) and out (the serving form, equal to
    the training form's): each block owns its rows and sums in a fixed
    order, with no atomics."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_bf16_inputs(B, T, nh, hd, seed=T)
    key_mask = None if causal else mask
    scale = hd ** -0.5
    first, second = (fl._flash_cuda(q, k, v, key_mask, causal, scale,
                                    with_lse=True) for _ in range(2))
    serve = fl._flash_cuda(q, k, v, key_mask, causal, scale)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])
    assert torch.equal(serve, first[0])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,nh,hd,causal", BF16_REPEAT_SHAPES)
def test_flash_bf16_backward_repeats_its_bits_on_card(B, T, nh, hd, causal):
    """Two runs of the bf16 backward on the same inputs give bitwise-equal
    dq, dk and dv: each block owns its outputs and sums in a fixed order,
    with no atomics."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_bf16_inputs(B, T, nh, hd, seed=T)
    key_mask = None if causal else mask
    scale = hd ** -0.5
    out, lse = fl._flash_cuda(q, k, v, key_mask, causal, scale,
                              with_lse=True)
    do = torch.randn(out.shape, device="cuda").to(torch.bfloat16)
    first, second = (fl._flash_bwd_cuda(q, k, v, out, lse, do, key_mask,
                                        causal, scale) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 160])
def test_flash_bf16_head_dims_padded_on_card(hd):
    """bf16 head dims the kernels are not built for, zero-padded like the
    f32 ones: forward and both gradients within FLASH_BF16_ULPS."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_bf16_inputs(3, 77, 2, hd, seed=hd)
    scale = hd ** -0.5
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = fl.flash_attention(qg, kg, vg, mask, False, scale)
    do = torch.randn(out.shape, device="cuda").to(torch.bfloat16)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    _within_bf16_ulps(out.detach(), fl._flash_plain(q, k, v, mask, False,
                                                    scale))
    lse_p = fl._flash_lse_plain(q, k, mask, False, scale)
    want = fl._flash_bwd_plain(q, k, v, out.detach(), lse_p, do, mask, False,
                               scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _within_bf16_ulps(g, w)


#: head dims above 256 (the wide kernels: a multiple of 128, padded to
#: it), and T ragged and at the 64-row tile edges
WIDE_HEAD_DIMS = (384, 512, 1024)
WIDE_T = (1, 63, 65, 130)


def _wide_grads(fl, q, k, v, key_mask, causal, scale, seed=0):
    """(out, lse, do, (dq, dk, dv)) through flash_attention's Function and
    the forward's lse form on the card, the cotangent do drawn from a
    generator seeded with ``seed``; checks one launch of each wide
    kernel."""
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    counts = (fl.launches_wide, fl.launches_bwd_dkv_wide,
              fl.launches_bwd_dq_wide)
    out = fl.flash_attention(qg, kg, vg, key_mask, causal, scale)
    g = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn(out.shape, generator=g, device="cuda").to(q.dtype)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert (fl.launches_wide, fl.launches_bwd_dkv_wide,
            fl.launches_bwd_dq_wide) == tuple(c + 1 for c in counts)
    _, lse = fl._flash_cuda(q, k, v, key_mask, causal, scale, with_lse=True)
    return out.detach(), lse, do, grads


def _single_key_noise_bound(q, k, v, do, scale):
    """The bound on |dq| and |dk| at T = 1, where both are 0 in exact
    arithmetic: dS = P (dO . v - dO . out) with out = v is the rounding
    noise of two f32 dot products over the head dim, at most hd * 2^-24
    * sum_i |dO_i v_i| each (the f32 sums' accumulated error, which grows
    with hd); dq = scale * dS * k and dk = scale * dS * q scale it by the
    largest |k| or |q|, and the factor 4 covers both products and the
    final rounding of dq and dk."""
    hd = q.shape[-1]
    dot = float((do.double().abs() * v.double().abs()).sum(-1).max())
    big = max(float(q.double().abs().max()), float(k.double().abs().max()))
    return 4 * hd * 2.0 ** -24 * scale * dot * big


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("T", WIDE_T)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_kernels_match_plain_on_card(hd, T, causal, dtype):
    """The wide forward, dK/dV and dQ kernels (head dims above 256) with a
    ragged key mask, article 1 fully masked, causal on and off: f32
    within 1e-5 (relative to the gradient's size, as the other kernels'),
    bf16 within FLASH_BF16_ULPS of the plain bf16 versions; lse within
    1e-5 * max(1, |lse|), +inf on the same rows; the empty article's
    outputs exact zeros.  At T = 1 dq and dk are 0 in exact arithmetic (a
    softmax over one key) and both sides give the rounding noise of
    dP - D, which no bound in ulps of that noise holds: there they are
    held to the f32 tolerance."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(3, T, 2, hd, seed=T + hd)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    scale = hd ** -0.5
    out, lse, do, got = _wide_grads(fl, q, k, v, mask, causal, scale,
                                    seed=T + hd)
    want_out = fl._flash_plain(q, k, v, mask, causal, scale)
    lse_p = fl._flash_lse_plain(q, k, mask, causal, scale)
    want = fl._flash_bwd_plain(q, k, v, out, lse_p, do, mask, causal, scale)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
    fin = torch.isfinite(lse_p)
    assert float((lse - lse_p)[fin].abs().max()) <= 1e-5 * max(
        1.0, float(lse_p[fin].abs().max()))
    if T == 1:
        # dq and dk are 0 in exact arithmetic: kernel and plain version
        # are each held to the float64 reference within the noise bound
        f64 = [x.double() for x in (q, k, v, out, do)]
        ref = fl._flash_bwd_plain(f64[0], f64[1], f64[2], f64[3],
                                  lse_p.double(), f64[4], mask.double(),
                                  causal, scale)
        bound = _single_key_noise_bound(q.float(), k.float(), v.float(),
                                        do.float(), scale)
        for i in (0, 1):
            for side in (got[i], want[i]):
                err = float((side.double() - ref[i]).abs().max())
                assert err <= bound, (i, err, bound)
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out, *got),
                          (want_out, *want)):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.isfinite(g.float()).all()
        if T == 1 and name in ("dq", "dk"):
            pass  # held to the float64 reference above
        elif dtype == torch.bfloat16:
            _within_bf16_ulps(g, w)
        else:
            tol = 1e-5 * max(1.0, float(w.abs().max()))
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       w.float().cpu().numpy(), rtol=0,
                                       atol=tol)
        assert not g[1].any()  # the empty article


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_kernels_repeat_their_bits_on_card(hd, dtype):
    """The wide kernels use no atomics: two runs of the forward and of
    the backward on the same inputs give the same bits."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(2, 130, 2, hd, seed=hd)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    scale = hd ** -0.5
    runs = [fl._flash_cuda(q, k, v, mask, False, scale, with_lse=True)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out, lse = runs[0]
    g = torch.Generator(device="cuda").manual_seed(hd)
    do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    first, second = (fl._flash_bwd_cuda(q, k, v, out, lse, do, mask, False,
                                        scale) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [320, 640, 1000])
def test_flash_wide_head_dims_padded_on_card(hd):
    """Head dims above 256 that are not a multiple of 128 pad to the next
    one (320 -> 384, 640 -> 640, 1000 -> 1024) and match the plain
    versions at the true head dim, forward and backward."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(3, 77, 1, hd, seed=hd)
    scale = hd ** -0.5
    out, _, do, got = _wide_grads(fl, q, k, v, mask, True, scale)
    lse_p = fl._flash_lse_plain(q, k, mask, True, scale)
    want = fl._flash_bwd_plain(q, k, v, out, lse_p, do, mask, True, scale)
    np.testing.assert_allclose(
        out.cpu().numpy(),
        fl._flash_plain(q, k, v, mask, True, scale).cpu().numpy(), **TOL)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)


#: the wide dQ's cluster form against its SIMT form: (Tq, Tk, nh, causal)
#: at T ragged against the f32 form's 64-row and the bf16 form's 128-row
#: blocks, 2 and 3 heads (clusters of hd / 128 blocks beside nh in the
#: grid), causal, and query blocks (Tq < Tk)
WIDE_DQ_CASES = ([(T, T, nh, c) for T in (65, 130, 400) for nh in (2, 3)
                  for c in (False, True)]
                 + [(65, 130, 2, False), (200, 400, 3, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (384, 512))
@pytest.mark.parametrize("tq,tk,nh,causal", WIDE_DQ_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_dq_cluster_matches_simt_and_plain_on_card(hd, tq, tk, nh,
                                                              causal, dtype):
    """The wide dQ's cluster form and the SIMT form it replaced
    (``simt=True``) on the same lse and D (the plain versions'), each
    held to the plain dQ: f32 within 1e-5 relative to the output's size,
    bf16 within FLASH_BF16_ULPS; article 1, fully masked, exact zeros;
    one wide dQ launch each."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(3, tk, nh, hd, seed=tq + nh + hd)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    q = q[:, tk - tq:].contiguous()
    scale = hd ** -0.5
    g = torch.Generator(device="cuda").manual_seed(tq + hd)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    out = fl._flash_plain(q, k, v, mask, causal, scale)
    lse = fl._flash_lse_plain(q, k, mask, causal, scale)
    dsum = torch.sum(do.float() * out.float(), dim=-1)
    want = fl._flash_bwd_plain(q, k, v, out, lse, do, mask, causal,
                               scale)[0]
    before = fl.launches_bwd_dq_wide
    got = [fl._bwd_dq_cuda(q, k, v, do, lse, dsum, mask, causal, scale,
                           simt=simt) for simt in (False, True)]
    torch.cuda.synchronize()
    assert fl.launches_bwd_dq_wide == before + 2
    for dq in got:
        assert dq.shape == want.shape and dq.dtype == dtype
        if dtype == torch.bfloat16:
            _within_bf16_ulps(dq, want)
        else:
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            np.testing.assert_allclose(dq.cpu().numpy(), want.cpu().numpy(),
                                       rtol=0, atol=tol)
        assert not dq[1].any()  # the empty article


#: the clusters past the portable 8 blocks: 9, 12 and 16 blocks
WIDE_CLUSTER_HEAD_DIMS = (1152, 1536, 2048)
#: (Tq, Tk, causal): a ragged key mask, causal, and query blocks (Tq < Tk)
WIDE_CLUSTER_CASES = [(130, 130, False), (130, 130, True), (65, 130, False),
                      (200, 400, False)]


def _held_to(got, want, dtype):
    """f32 within 1e-5 of the plain version relative to its size, bf16
    within FLASH_BF16_ULPS; article 1 (fully masked) exact zeros."""
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.bfloat16:
        _within_bf16_ulps(got, want)
    else:
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=tol)
    assert not got[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WIDE_CLUSTER_HEAD_DIMS)
@pytest.mark.parametrize("tq,tk,causal", WIDE_CLUSTER_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_16_block_clusters_match_simt_and_plain_on_card(
        hd, tq, tk, causal, dtype):
    """The forward, dK/dV and dQ cluster forms of 9 to 16 blocks, and the
    SIMT forms they replaced (``simt=True``), each held to the plain
    versions (``_held_to``; the backward on the plain lse and D); lse
    within 1e-5 * max(1, |lse|), +inf on the same rows; each launch
    counted, the cluster forms' by the cluster counters and the SIMT
    forms' not."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(3, tk, 2, hd, seed=tq + hd)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    q = q[:, tk - tq:].contiguous()
    scale = hd ** -0.5
    g = torch.Generator(device="cuda").manual_seed(tq + hd)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    want_out = fl._flash_plain(q, k, v, mask, causal, scale)
    lse_p = fl._flash_lse_plain(q, k, mask, causal, scale)
    want = fl._flash_bwd_plain(q, k, v, want_out, lse_p, do, mask, causal,
                               scale)
    dsum = torch.sum(do.float() * want_out.float(), dim=-1)
    counters = ("launches_wide", "launches_wide_cluster",
                "launches_bwd_dkv_wide", "launches_bwd_dkv_wide_cluster",
                "launches_bwd_dq_wide", "launches_bwd_dq_wide_cluster")
    before = [getattr(fl, c) for c in counters]
    for simt in (False, True):
        out, lse = fl._flash_cuda(q, k, v, mask, causal, scale,
                                  with_lse=True, simt=simt)
        dk, dv = fl._bwd_dkv_cuda(q, k, v, do, lse_p, dsum, mask, causal,
                                  scale, simt=simt)
        dq = fl._bwd_dq_cuda(q, k, v, do, lse_p, dsum, mask, causal, scale,
                             simt=simt)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
        fin = torch.isfinite(lse_p)
        assert float((lse - lse_p)[fin].abs().max()) <= 1e-5 * max(
            1.0, float(lse_p[fin].abs().max()))
        for got_x, want_x in ((out, want_out), (dq, want[0]),
                              (dk, want[1]), (dv, want[2])):
            _held_to(got_x, want_x, dtype)
    assert [getattr(fl, c) - b for c, b in zip(counters, before)] == [
        2, 1, 2, 1, 2, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WIDE_CLUSTER_HEAD_DIMS)
@pytest.mark.parametrize("tq,tk,causal", [(200, 200, False),
                                          (130, 130, True),
                                          (100, 200, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_16_block_clusters_repeat_their_bits_on_card(
        hd, tq, tk, causal, dtype):
    """The exchange sums in rank order, no atomics: two runs of the
    forward (with lse) and of the backward (dQ, dK and dV) on the same
    inputs give the same bits, with a key mask, causal, and on a query
    block (Tq < Tk)."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(2, tk, 2, hd, seed=hd)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    q = q[:, tk - tq:].contiguous()
    scale = hd ** -0.5
    runs = [fl._flash_cuda(q, k, v, mask, causal, scale, with_lse=True)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out, lse = runs[0]
    g = torch.Generator(device="cuda").manual_seed(hd)
    do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    first, second = (fl._flash_bwd_cuda(q, k, v, out, lse, do, mask, causal,
                                        scale) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


#: the multi-slab cluster forms of the forward, dK/dV and dQ: (slabs a
#: block, blocks) (2, 9) with the last block owning one slab, (2, 9), (2,
#: 12), (2, 16), (3, 11) and (3, 16)
MULTI_SLAB_HEAD_DIMS = (2176, 2304, 3072, 4096, 4224, 6144)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", MULTI_SLAB_HEAD_DIMS)
@pytest.mark.parametrize("tq,tk,causal", WIDE_CLUSTER_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_multi_slab_clusters_match_simt_and_plain_on_card(
        hd, tq, tk, causal, dtype):
    """The forward (with and without lse), dK/dV and dQ above head dim
    2048, clusters whose blocks own 2 or 3 slabs, each held to the plain
    versions and to the SIMT forms (``simt=True``) they replace
    (``_held_to``; dK/dV and dQ on the plain lse and D); lse within 1e-5
    * max(1, |lse|), +inf on the same rows; the serving forward (no lse)
    bit-equal to the training one; the new forms' kernel launches (one
    per slab a block owns) counted by the cluster counters, the SIMT
    forms' not."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(3, tk, 2, hd, seed=tq + hd)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    q = q[:, tk - tq:].contiguous()
    scale = hd ** -0.5
    g = torch.Generator(device="cuda").manual_seed(tq + hd)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    want_out = fl._flash_plain(q, k, v, mask, causal, scale)
    lse_p = fl._flash_lse_plain(q, k, mask, causal, scale)
    want = fl._flash_bwd_plain(q, k, v, want_out, lse_p, do, mask, causal,
                               scale)
    dsum = torch.sum(do.float() * want_out.float(), dim=-1)
    counters = ("launches_wide", "launches_wide_cluster",
                "launches_bwd_dkv_wide", "launches_bwd_dkv_wide_cluster",
                "launches_bwd_dq_wide", "launches_bwd_dq_wide_cluster")
    before = [getattr(fl, c) for c in counters]
    got = {}
    for simt in (False, True):
        out, lse = fl._flash_cuda(q, k, v, mask, causal, scale,
                                  with_lse=True, simt=simt)
        dk, dv = fl._bwd_dkv_cuda(q, k, v, do, lse_p, dsum, mask, causal,
                                  scale, simt=simt)
        dq = fl._bwd_dq_cuda(q, k, v, do, lse_p, dsum, mask, causal, scale,
                             simt=simt)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
        fin = torch.isfinite(lse_p)
        assert float((lse - lse_p)[fin].abs().max()) <= 1e-5 * max(
            1.0, float(lse_p[fin].abs().max()))
        for got_x, want_x in ((out, want_out), (dk, want[1]),
                              (dv, want[2]), (dq, want[0])):
            _held_to(got_x, want_x, dtype)
        got[simt] = (out, dk, dv, dq)
    for new_x, simt_x in zip(got[False], got[True]):
        _held_to(new_x, simt_x, dtype)
    serve = fl._flash_cuda(q, k, v, mask, causal, scale)
    torch.cuda.synchronize()
    assert torch.equal(serve, got[False][0])
    # a multi-slab call launches its kernel once per slab a block owns
    s = -(-hd // 128 // 16)
    assert [getattr(fl, c) - b for c, b in zip(counters, before)] == [
        2 * s + 1, 2 * s, s + 1, s, s + 1, s]


#: the multi-slab forms at 4 slabs a block: (4, 13) with the last block
#: owning one slab of four, and (4, 16) at hd 8192, the largest
FOUR_SLAB_HEAD_DIMS = (6272, 8192)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", FOUR_SLAB_HEAD_DIMS)
@pytest.mark.parametrize("tq,tk,causal", WIDE_CLUSTER_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_four_slab_clusters_match_float64_on_card(
        hd, tq, tk, causal, dtype):
    """The forward (with lse), dK/dV and dQ at 4 slabs a block: f32 held
    within 1e-5 * max(1, |value|) of the plain version in float64 (at
    these head dims the plain f32 version itself strays past that bound
    from float64 (PERF.md), so it is no yardstick; the backward's
    float64 reference takes the plain f32 out for D and float64's lse, the
    kernels the plain f32 lse and D), bf16 held to the plain bf16
    version (``_held_to``); lse within 1e-5 * max(1, |lse|), +inf on the
    same rows; one launch per slab, counted by the cluster counters."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(3, tk, 2, hd, seed=tq + hd)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    q = q[:, tk - tq:].contiguous()
    scale = hd ** -0.5
    g = torch.Generator(device="cuda").manual_seed(tq + hd)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    want_out = fl._flash_plain(q, k, v, mask, causal, scale)
    lse_p = fl._flash_lse_plain(q, k, mask, causal, scale)
    dsum = torch.sum(do.float() * want_out.float(), dim=-1)
    if dtype == torch.float32:
        q64, k64, v64, do64, out64 = (x.double() for x in (q, k, v, do,
                                                           want_out))
        m64 = mask.double()
        want_out = fl._flash_plain(q64, k64, v64, m64, causal, scale)
        want = fl._flash_bwd_plain(q64, k64, v64, out64, fl._flash_lse_plain(
            q64, k64, m64, causal, scale), do64, m64, causal, scale)
    else:
        want = fl._flash_bwd_plain(q, k, v, want_out, lse_p, do, mask,
                                   causal, scale)
    counters = ("launches_wide_cluster", "launches_bwd_dkv_wide_cluster",
                "launches_bwd_dq_wide_cluster")
    before = [getattr(fl, c) for c in counters]
    out, lse = fl._flash_cuda(q, k, v, mask, causal, scale, with_lse=True)
    dk, dv = fl._bwd_dkv_cuda(q, k, v, do, lse_p, dsum, mask, causal, scale)
    dq = fl._bwd_dq_cuda(q, k, v, do, lse_p, dsum, mask, causal, scale)
    torch.cuda.synchronize()
    assert [getattr(fl, c) - b for c, b in zip(counters, before)] == [4] * 3
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
    fin = torch.isfinite(lse_p)
    assert float((lse - lse_p)[fin].abs().max()) <= 1e-5 * max(
        1.0, float(lse_p[fin].abs().max()))
    for got_x, want_x in ((out, want_out), (dk, want[1]), (dv, want[2]),
                          (dq, want[0])):
        if dtype == torch.float32:
            assert got_x.shape == want_x.shape and got_x.dtype == dtype
            err = float((got_x.double() - want_x).abs().max())
            assert err <= 1e-5 * max(1.0, float(want_x.abs().max())), err
            assert not got_x[1].any()
        else:
            _held_to(got_x, want_x, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (2176, 4224, 6272))
@pytest.mark.parametrize("tq,tk,causal", [(200, 200, False),
                                          (130, 130, True),
                                          (100, 200, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_multi_slab_clusters_repeat_their_bits_on_card(
        hd, tq, tk, causal, dtype):
    """Sums over the slabs in order, then over the ranks, no atomics: two
    runs of the multi-slab forward (with lse), dK/dV and dQ on the same
    inputs give the same bits, with a key mask, causal, and on a query
    block."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(2, tk, 2, hd, seed=hd)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    q = q[:, tk - tq:].contiguous()
    scale = hd ** -0.5
    runs = [fl._flash_cuda(q, k, v, mask, causal, scale, with_lse=True)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out, lse = runs[0]
    g = torch.Generator(device="cuda").manual_seed(hd)
    do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    dsum = torch.sum(do.float() * out.float(), dim=-1)
    first, second = ((*fl._bwd_dkv_cuda(q, k, v, do, lse, dsum, mask,
                                        causal, scale),
                      fl._bwd_dq_cuda(q, k, v, do, lse, dsum, mask, causal,
                                      scale)) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


#: the largest head dim at which each wide kernel takes its cluster form:
#: every kind in clusters of up to 16 blocks owning up to 4 slabs each
CLUSTER_UP_TO = dict(fwd=8192, dkv=8192, dq=8192)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "dkv", "dq"])
def test_flash_wide_forms_follow_the_rule_on_card(kind):
    """For every padded head dim from 384 to 8448 the library's own form
    (ts_flash_wide_form, which the launch counters read) is the cluster
    form up to CLUSTER_UP_TO and the SIMT form above, and a head dim
    that is not a multiple of 128 has none; the geometry it reports is
    one slab a block and hd / 128 blocks up to 2048, above it ceil(C /
    16) slabs and ceil(C / slabs) blocks, and a call launches the kernel
    once per slab (once for the SIMT form); where it is a cluster, at
    least one cluster of the instance a launch takes is resident on this
    card at that many blocks in both dtypes
    (ts_flash_wide_active_clusters_at, the check each launch makes at
    first use; up to 2048 the same as ts_flash_wide_active_clusters at
    those blocks)."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    lib = fl._load_wide_library()
    i = fl.WIDE_KINDS.index(kind)
    for hd in range(384, 8449, fl.WIDE_STEP):
        cluster = hd <= CLUSTER_UP_TO[kind]
        assert lib.ts_flash_wide_form(i, hd, None, None) == int(cluster), hd
        C = hd // 128
        slabs = -(-C // 16)
        want = (slabs, -(-C // slabs)) if cluster else (0, 0)
        assert fl._wide_geometry(kind, hd) == want, hd
        assert fl._wide_launches(kind, hd) == (want[0] or 1, cluster)
        assert fl._wide_launches(kind, hd, simt=True) == (1, False)
        if cluster:
            for bf16 in (0, 1):
                n = lib.ts_flash_wide_active_clusters_at(i, bf16, hd)
                assert n >= 1, (hd, bf16, n)
                if slabs == 1:
                    assert lib.ts_flash_wide_active_clusters(
                        i, bf16, want[1]) == n
        else:
            assert lib.ts_flash_wide_active_clusters_at(i, 0, hd) < 0
    assert lib.ts_flash_wide_form(i, 8200, None, None) == -1
    with pytest.raises(ValueError, match="8200"):
        fl._wide_geometry(kind, 8200)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [0, 1])
def test_flash_wide_dq_clusters_fit_at_9_to_16_blocks_on_card(bf16):
    """At least one cluster of each dQ form is resident at once on this
    card at every size past the portable 8 blocks, 9 to 16
    (ts_flash_wide_active_clusters: the f32 form at two blocks an SM, the
    bf16 form at one; the check each launch makes at first use)."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    lib = fl._load_wide_library()
    fits = {C: lib.ts_flash_wide_active_clusters(fl.WIDE_KINDS.index("dq"),
                                                 bf16, C)
            for C in range(9, 17)}
    assert all(n >= 1 for n in fits.values()), fits


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("bf16", [0, 1])
def test_flash_wide_occupancy_refuses_32_blocks_on_card(kind, bf16):
    """The occupancy check a cluster launch makes at first use
    (cudaOccupancyMaxActiveClusters, through ts_flash_wide_active_clusters)
    finds no cluster of 32 blocks, more than one of the H100's GPCs
    holds (it finds none from 20 blocks on; at 17 and 18 it still counts
    some, so the launches' own limit, 16, is not its): where it finds none
    a launch returns an error, which the wrappers raise."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    lib = fl._load_wide_library()
    n = lib.ts_flash_wide_active_clusters(fl.WIDE_KINDS.index(kind), bf16,
                                          32)
    assert n < 1, n


#: one sp rank's block of query rows against every key: (Tq, Tk) with Tq
#: half and a third of Tk, ragged against the 64- and 128-row blocks
QUERY_BLOCKS = ((50, 100), (33, 100), (65, 130), (200, 400))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 128, 256, 384, 512, 1024, 1152, 2304])
@pytest.mark.parametrize("tq,tk", QUERY_BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_query_block_matches_plain_on_card(hd, tq, tk, dtype):
    """Every flash kernel (forward with and without lse, dK/dV, dQ; f32,
    bf16 and wide, the cluster forms up to hd 1024; at 1152 the 9-block
    clusters; at 2304 the 9-block clusters of two slabs a block) on a
    block of Tq query
    rows (rows [Tq, 2 Tq) of the article's queries) against all Tk keys,
    a ragged key mask and article 1 fully masked: f32 within 1e-5 of the
    plain versions relative to each output's size, bf16 within
    FLASH_BF16_ULPS; one launch of each, each counted by the query-block
    counters too."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(3, tk, 2, hd, seed=tq + hd)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    q = q[:, tq:2 * tq].contiguous()
    scale = hd ** -0.5
    g = torch.Generator(device="cuda").manual_seed(tk)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    counters = ("launches", "launches_bwd_dkv", "launches_bwd_dq",
                "launches_block", "launches_bwd_dkv_block",
                "launches_bwd_dq_block")
    before = [getattr(fl, c) for c in counters]
    serve = fl._flash_cuda(q, k, v, mask, False, scale)
    out, lse = fl._flash_cuda(q, k, v, mask, False, scale, with_lse=True)
    got = fl._flash_bwd_cuda(q, k, v, out, lse, do, mask, False, scale)
    torch.cuda.synchronize()
    # above 2048 each call launches its kernel once per slab
    s = -(-hd // 128 // 16) if hd > 256 else 1
    assert [getattr(fl, c) - b for c, b in zip(counters, before)] == [
        2 * s, s, s, 2 * s, s, s]
    assert torch.equal(serve, out)
    want_out = fl._flash_plain(q, k, v, mask, False, scale)
    lse_p = fl._flash_lse_plain(q, k, mask, False, scale)
    want = fl._flash_bwd_plain(q, k, v, out, lse_p, do, mask, False, scale)
    assert lse.shape == (3, tq, 2)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
    fin = torch.isfinite(lse_p)
    assert float((lse - lse_p)[fin].abs().max()) <= 1e-5 * max(
        1.0, float(lse_p[fin].abs().max()))
    for name, got_x, want_x in zip(("out", "dq", "dk", "dv"), (out, *got),
                                   (want_out, *want)):
        assert got_x.shape == want_x.shape and got_x.dtype == dtype, name
        if dtype == torch.bfloat16:
            _within_bf16_ulps(got_x, want_x)
        else:
            tol = 1e-5 * max(1.0, float(want_x.abs().max()))
            np.testing.assert_allclose(got_x.cpu().numpy(),
                                       want_x.cpu().numpy(), rtol=0,
                                       atol=tol, err_msg=name)
        assert not got_x[1].any()  # the empty article


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 512])
def test_flash_causal_query_block_refused_on_card(hd):
    """A causal call with fewer query rows than keys raises ValueError
    before any launch (no path asks for one)."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(2, 64, 1, hd)
    with pytest.raises(ValueError, match="causal"):
        fl.flash_attention(q[:, :32].contiguous(), k, v, mask, True,
                           hd ** -0.5)


@pytest.mark.cuda
def test_flash_kernels_refuse_mixed_dtypes_on_card():
    """An f32/bf16 mix raises before any launch, in the forward and the
    backward's entry point; a bf16 key mask is refused too."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    _need_cuda()
    q, k, v, mask = _flash_inputs(2, 40, 4, 32)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    before = (fl.launches, fl.launches_bwd_dkv, fl.launches_bwd_dq)
    for args in ((qb, k, v), (q, kb, v), (qb, kb, v), (q, k, vb)):
        with pytest.raises(ValueError, match="dtype"):
            fl.flash_attention(*args, mask, False, 0.2)
    with pytest.raises(ValueError, match="key_mask"):
        fl.flash_attention(qb, kb, vb, mask.to(torch.bfloat16), False, 0.2)
    lse = torch.zeros(2, 40, 4, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        fl._flash_bwd_cuda(qb, kb, vb, qb, lse, q, mask, False, 0.2)
    assert (fl.launches, fl.launches_bwd_dkv, fl.launches_bwd_dq) == before


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_bf16_transformer_train_step_on_card_matches_the_cpu(remat):
    """One train step of a small transformer with --compute_dtype=bfloat16
    --loss_chunk=5 on the card (the flash kernels' bf16 forms, bf16 GEMMs)
    against --device=cpu: the loss, the new params and accumulators within
    4 times the CPU's own distance between its bf16 and f32 steps (as the
    pointer-generator's bf16 step above); every flash launch a bf16 one,
    one forward per layer (two under --remat) and one dK/dV and dQ."""
    from textsummarization_on_flink_tpu_torch.config import HParams
    from textsummarization_on_flink_tpu_torch.decode.beam_search import (
        _to_device,
    )
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
    from textsummarization_on_flink_tpu_torch.params import (
        init_numpy_params,
        tree_leaves,
    )
    from textsummarization_on_flink_tpu_torch.train import trainer

    _need_cuda()
    hps = HParams(model_family="transformer", hidden_dim=64, num_heads=2,
                  enc_layers=2, dec_layers=2, batch_size=4, vocab_size=200,
                  max_enc_steps=40, max_dec_steps=12, min_dec_steps=3,
                  beam_size=4, max_oov_buckets=8, mode="train",
                  coverage=True, compute_dtype="bfloat16", loss_chunk=5,
                  remat=remat)
    params = init_numpy_params(hps, hps.vocab_size, 1)
    arrays = _small_batches(hps, 1)[0]
    runs = {}
    for dev, h in (("cuda", hps), ("cpu", hps),
                   ("cpu32", hps.replace(compute_dtype="float32"))):
        d = "cpu" if dev == "cpu32" else dev
        h = h.replace(device=d)
        state = trainer.init_train_state(h, h.vocab_size, params=params)
        counts = (fl.launches, fl.launches_bf16, fl.launches_bwd_dkv_bf16,
                  fl.launches_bwd_dq_bf16)
        state, m = trainer.train_step(h, state, _to_device(arrays, d))
        launched = tuple(a - b for a, b in zip(
            (fl.launches, fl.launches_bf16, fl.launches_bwd_dkv_bf16,
             fl.launches_bwd_dq_bf16), counts))
        runs[dev] = (float(m.loss), [
            x.detach().float().cpu().numpy() for x in
            tree_leaves(state.params) + tree_leaves(
                state.opt_state.accumulators)], launched)
    (g_loss, g_leaves, launched), (c_loss, c_leaves, _), (f_loss, f_leaves,
                                                          _) = (
        runs["cuda"], runs["cpu"], runs["cpu32"])
    layers = hps.enc_layers + hps.dec_layers
    fwd = 2 * layers if remat else layers
    assert launched == (fwd, fwd, layers, layers)
    assert abs(g_loss - c_loss) <= 4 * abs(c_loss - f_loss) + 1e-5
    for g, c, f in zip(g_leaves, c_leaves, f_leaves):
        bound = 4 * float(np.max(np.abs(c - f))) + 1e-5 * max(
            1.0, float(np.max(np.abs(c))))
        assert float(np.max(np.abs(g - c))) <= bound


# -- the fused attention's length bound (the slot engine's step) -----------

#: t_active at one position, the 8-position chunk's edges, a cluster of 8
#: one-chunk blocks' edges, and one short of T
BOUND_T_ACTIVE = (1, 7, 8, 9, 63, 64, 65, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [400, 4096])
@pytest.mark.parametrize("t_act", BOUND_T_ACTIVE)
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_cov", [False, True])
def test_bounded_fused_attention_on_card(T, t_act, K, dtype, use_cov):
    """The kernel with t_active against the plain version with t_active
    (1e-5), attn exactly 0 past the bound, the same bits on a rerun.
    Article 1 is empty; the others are valid past the bound."""
    _need_cuda()
    t_act = T - 1 if t_act < 0 else t_act
    args = _inputs(4, K, T, 64, dtype, seed=t_act)
    before = fa.launches
    ctx, attn = fa.fused_attention_shared(*args, use_cov, t_active=t_act)
    again = fa.fused_attention_shared(*args, use_cov, t_active=t_act)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    ctx_p, attn_p = fa._attention_plain(*args, use_cov, t_active=t_act)
    np.testing.assert_allclose(ctx.cpu().numpy(), ctx_p.cpu().numpy(), **TOL)
    np.testing.assert_allclose(attn.cpu().numpy(), attn_p.cpu().numpy(),
                               **TOL)
    assert not attn[:, :, t_act:].any()
    assert not attn[1].any() and not ctx[1].any()
    assert torch.equal(ctx, again[0]) and torch.equal(attn, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unbounded_call_is_the_dense_launch_on_card(dtype):
    """t_active=None and t_active=T launch the same kernel on the same
    geometry: the same bits (the dense path's numbers are unchanged by
    the argument)."""
    _need_cuda()
    args = _inputs(16, 4, 400, 512, dtype)
    dense = fa.fused_attention_shared(*args, True)
    at_t = fa.fused_attention_shared(*args, True, t_active=400)
    assert all(torch.equal(a, b) for a, b in zip(dense, at_t))


@pytest.mark.cuda
def test_bounded_fused_attention_refuses_a_bad_bound_on_card():
    _need_cuda()
    args = _inputs(2, 4, 40, 64, torch.float32)
    before = fa.launches
    for bad in (0, 41):
        with pytest.raises(ValueError, match="t_active"):
            fa.fused_attention_shared(*args, True, t_active=bad)
    assert fa.launches == before


@pytest.mark.cuda
def test_debug_nans_raises_in_the_card_backward():
    """--debug's op-level check reaches the autograd backward on the card:
    a tiny pointer-generator step whose loss is finite and whose
    gradient goes NaN (one inf in W_h, no padding; see
    tests/test_torch_debug_nans.py) raises FloatingPointError naming the
    op; without the mode the step runs to NaN params."""
    _need_cuda()
    from textsummarization_on_flink_tpu_torch.config import HParams
    from textsummarization_on_flink_tpu_torch.data import batching
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.params import (
        init_numpy_params,
        tree_leaves,
    )
    from textsummarization_on_flink_tpu_torch.train import trainer

    words = "the a cat dog sat ran mat home big small quick fox".split()
    vocab = Vocab(words=words)
    hps = HParams(batch_size=2, hidden_dim=16, emb_dim=8,
                  vocab_size=vocab.size(), max_enc_steps=8, max_dec_steps=6,
                  min_dec_steps=1, max_oov_buckets=4, mode="train",
                  device="cuda")
    p = init_numpy_params(hps, vocab.size(), 5)
    p["decoder"]["attention"]["W_h"][0, 3] = np.inf
    exs = [batching.SummaryExample.build(" ".join(words[i:] + words[:i]),
                                         ["the cat sat ."], vocab, hps)
           for i in range(2)]
    dev = trainer.batch_to_device(
        batching.Batch(exs, hps, vocab).as_arrays(), torch.device("cuda"))
    assert bool(dev["enc_padding_mask"].all())
    state = trainer.init_train_state(hps, vocab.size(), params=p)
    new, m = trainer.train_step(hps, state, dev, inplace=False)
    assert np.isfinite(float(m.loss))
    assert any(torch.isnan(x).any() for x in tree_leaves(new.params))
    with pytest.raises(FloatingPointError, match="aten"):
        with trainer.DebugNans():
            trainer.train_step(hps, state, dev, inplace=False)


def _spec_case(family):
    """A small model of ``family`` and a batch for the speculative tier:
    peaked scores (embedding x30, a STOP bias), articles of ragged
    lengths with OOVs, the AAN draft mapped (transformer) or fresh."""
    from textsummarization_on_flink_tpu_torch.config import HParams
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params

    common = dict(batch_size=4, vocab_size=200, max_enc_steps=40,
                  max_dec_steps=12, beam_size=1, min_dec_steps=3,
                  max_oov_buckets=8, mode="decode", spec_k=3,
                  draft_dec_layers=1)
    if family == "transformer":
        hps = HParams(model_family=family, hidden_dim=64, num_heads=2,
                      enc_layers=2, dec_layers=2, spec_draft="map", **common)
    elif family == "avg_attention":
        hps = HParams(model_family=family, hidden_dim=64, num_heads=2,
                      enc_layers=2, dec_layers=2, spec_draft="fresh",
                      **dict(common, draft_dec_layers=0))
    else:
        hps = HParams(hidden_dim=32, emb_dim=16, coverage=True,
                      spec_draft="fresh", **common)
    p = init_numpy_params(hps, hps.vocab_size, 5)
    if family == "pointer_generator":
        p["output_projection"]["w"] *= 4.0
        p["output_projection"]["v"][3] = 3.5  # STOP: some rows end early
    else:
        p["embedding"] *= 30.0
        p["out_bias"][3] = 12.0  # STOP
    rng = np.random.RandomState(1)
    B, T = hps.batch_size, hps.max_enc_steps
    lens = rng.randint(T // 2, T + 1, B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    ids = np.where(mask > 0, rng.randint(4, hps.vocab_size, (B, T)), 1)
    ext = np.where((rng.rand(B, T) < 0.2) & (mask > 0),
                   hps.vocab_size + rng.randint(0, 4, (B, T)), ids)
    arrays = dict(enc_batch=ids.astype(np.int32),
                  enc_lens=lens.astype(np.int32), enc_padding_mask=mask,
                  enc_batch_extend_vocab=ext.astype(np.int32))
    return hps, p, arrays


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["transformer", "pointer_generator"])
def test_spec_tier_equals_greedy_on_card(family):
    """The speculative tier through the kernels (both models' encoders on
    the flash forward; the pointer-generator's verify steps on the fused
    attention) gives the greedy tier's tokens, on the card, and the CPU's
    spec tokens and counts."""
    _need_cuda()
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode import speculative
    from textsummarization_on_flink_tpu_torch.models import avg_attention
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
    from textsummarization_on_flink_tpu_torch.params import from_numpy_tree

    hps, p, arrays = _spec_case(family)
    out = {}
    for dev in ("cpu", "cuda"):
        params = from_numpy_tree(p, torch.device(dev))
        draft = avg_attention.make_draft_params(hps, params, seed=3)
        before = fl.launches
        spec = speculative.run_spec_decode(params, draft, hps, arrays)
        if dev == "cuda":
            assert fl.launches - before == (
                2 * hps.enc_layers if family == "transformer"
                else hps.enc_layers)
        greedy = beam_search.run_beam_search(params, hps, arrays)
        for b in range(hps.batch_size):
            n = int(greedy.length[b])
            assert int(spec.length[b]) == n
            assert list(spec.tokens[b][:n]) == list(greedy.tokens[b][:n])
        out[dev] = spec
    for f in ("tokens", "length", "cycles", "accepted", "accept_hist"):
        np.testing.assert_array_equal(getattr(out["cuda"], f),
                                      getattr(out["cpu"], f), err_msg=f)


@pytest.mark.cuda
def test_aan_tokens_on_card_equal_the_cpu():
    """The AAN family's beam search (beam 4) with its encoder on the flash
    kernel: the CPU's tokens and lengths, average log-probs within
    1e-4."""
    _need_cuda()
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.params import from_numpy_tree

    hps, p, arrays = _spec_case("avg_attention")
    hps = hps.replace(beam_size=4)
    cpu = beam_search.run_beam_search(from_numpy_tree(p, "cpu"), hps, arrays)
    gpu = beam_search.run_beam_search(
        from_numpy_tree(p, torch.device("cuda")), hps, arrays)
    np.testing.assert_array_equal(gpu.tokens, cpu.tokens)
    np.testing.assert_array_equal(gpu.length, cpu.length)
    np.testing.assert_allclose(gpu.avg_log_prob, cpu.avg_log_prob, atol=1e-4)
