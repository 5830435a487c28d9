"""The fused attention's slab and sp-block forms against the JAX package.

* The slab form (the kernels' loop over D, for widths whose dense form
  does not fit one block on the card) has the formula as its plain
  version: at D 2400 in f32 and bf16 the port's forward and backward are
  held against the JAX package's ``_attention_xla_shared`` and the
  ``jax.vjp`` of ``_attention_xla`` its custom_vjp takes.
* The sp-block form: T split into 2 and 3 blocks, each block on its own
  thread standing for an sp rank (``_SimPlan``: the collectives of
  ops/fused_attention.py exchange the blocks' tensors between the
  threads, summing in rank order as the gloo all-reduce does).  The
  merged context and the blocks' attention equal JAX's whole-row
  formula; with each rank minimising 1/sp of the objective, as the
  sharded trainer does, the gradients summed over the ranks (df, v,
  w_c) or taken per block (es, ef, cov) equal ``jax.vjp`` of the whole
  row.  The inputs include a row masked on every block and a row whose
  later blocks hold only padding.

Tolerance 1e-5 (relative and absolute; gradients scaled by their
largest magnitude) in f32: both sides compute in f32 and differ only in
the order of their sums and in the merge's rescaling.  bf16 streams are
rounded once on both sides; their gradients d_es and d_ef within one
bf16 ulp beside that.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n
from textsummarization_on_flink_tpu.ops import pallas_attention as pa
from textsummarization_on_flink_tpu_torch.ops import attention as torch_attn
from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa
from textsummarization_on_flink_tpu_torch.parallel import collectives

TOL = dict(rtol=1e-5, atol=1e-5)


def make_inputs(B=3, T=24, D=16, K=1, seed=0, scale=1.0):
    """Row 0 valid over its first 7 positions (the later blocks of T all
    padding), row 1 masked everywhere, the rest full length."""
    rng = np.random.RandomState(seed)
    es = rng.randn(B, T, D).astype(np.float32)
    ef = (rng.randn(B, T, D) * scale).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, 7:] = 0.0
    mask[1] = 0.0
    df = (rng.randn(B, K, D) * scale).astype(np.float32)
    cov = (np.abs(rng.randn(B, K, T)) * mask[:, None, :]).astype(np.float32)
    lim = (6.0 / (2 * D)) ** 0.5 if scale < 1 else 1.0
    v = (rng.uniform(-1, 1, D) * lim).astype(np.float32)
    w_c = (rng.uniform(-1, 1, D) * lim).astype(np.float32)
    return es, ef, mask, df, cov, v, w_c


def _close_scaled(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _bf16(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16).float().numpy()


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(np.asarray(x, np.float32)))
    return np.ldexp(np.ones_like(x, dtype=np.float32), e - 8)


# --------------------------------------------------------------------------
# The slab form's widths
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_cov", [False, True])
def test_slab_width_forward_matches_jax(dtype, use_cov):
    """D 2400 (hidden_dim 1200, which the card refused before) at K = 3
    queries per article, against JAX's shared-encoder formula per
    article; bf16 streams rounded once on both sides."""
    es, ef, mask, df, cov, v, w_c = make_inputs(B=2, T=20, D=2400, K=3,
                                                scale=0.05)
    if dtype == torch.bfloat16:
        es, ef = _bf16(es), _bf16(ef)
    ctx, attn = fa.fused_attention_shared(
        torch.from_numpy(es).to(dtype), torch.from_numpy(ef).to(dtype),
        torch.from_numpy(mask), torch.from_numpy(df), torch.from_numpy(cov),
        torch.from_numpy(v), torch.from_numpy(w_c), use_cov)
    want = jax.vmap(lambda a, b, c, d, e: pa._attention_xla_shared(
        a, b, c, d, e, v, w_c, use_cov))(es, ef, mask, df, cov)
    np.testing.assert_allclose(n(ctx), n(want[0]), **TOL)
    np.testing.assert_allclose(n(attn), n(want[1]), **TOL)
    assert not n(attn)[1].any() and not n(ctx)[1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_cov", [False, True])
def test_slab_width_backward_matches_jax_vjp(dtype, use_cov):
    """The per-row backward at D 2400 (past the old backward's 2,308)
    through FusedAttention against jax.vjp of _attention_xla."""
    es, ef, mask, df, cov, v, w_c = make_inputs(B=3, T=20, D=2400,
                                                scale=0.05, seed=1)
    df, cov = df[:, 0], cov[:, 0]
    if dtype == torch.bfloat16:
        es, ef = _bf16(es), _bf16(ef)
    rng = np.random.RandomState(5)
    g_ctx = rng.randn(3, 2400).astype(np.float32)
    g_attn = rng.randn(3, 20).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (es, ef, df, cov, v, w_c)]
    t_es, t_ef, t_df, t_cov, t_v, t_wc = leaves
    ctx, attn = fa.fused_attention(
        t_es.to(dtype), t_ef.to(dtype), torch.from_numpy(mask), t_df, t_cov,
        t_v, t_wc, use_cov)
    got = torch.autograd.grad(
        (ctx * torch.from_numpy(g_ctx)).sum()
        + (attn * torch.from_numpy(g_attn)).sum(), leaves)

    def f(es_, ef_, df_, cov_, v_, wc_):
        return pa._attention_xla(es_, ef_, mask, df_, cov_, v_, wc_, use_cov)

    _, vjp = jax.vjp(f, es, ef, df, cov, v, w_c)
    want = vjp((jnp.asarray(g_ctx), jnp.asarray(g_attn)))
    names = ("d_es", "d_ef", "d_df", "d_cov", "d_v", "d_w_c")
    for name, a, b in zip(names, got, want):
        if dtype == torch.bfloat16 and name in ("d_es", "d_ef"):
            # rounded once to the stream's dtype by both
            b = _bf16(np.asarray(b))
            diff = np.abs(n(a) - b)
            assert (diff <= _bf16_ulp(b)
                    + 1e-5 * max(1.0, np.abs(b).max())).all(), name
        else:
            _close_scaled(n(a), np.asarray(b))


# --------------------------------------------------------------------------
# The sp-block form: sp ranks as threads of one process
# --------------------------------------------------------------------------

class _Group:
    """The exchange of n threads standing for the sp ranks of one dp
    index."""

    def __init__(self, size):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots = [None] * size

    def exchange(self, rank, t):
        self.slots[rank] = t
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _SimPlan:
    """The plan of one simulated sp rank (every other axis of one rank)."""

    def __init__(self, group, rank):
        self.group, self.rank_sp = group, rank

    def size(self, axis):
        return self.group.size if axis == "sp" else 1

    def coord(self, axis):
        return self.rank_sp if axis == "sp" else 0


@pytest.fixture
def simulated(monkeypatch):
    """collectives.all_gather and all_reduce over the threads of a
    _SimPlan (the rest as they are)."""
    gather, reduce = collectives.all_gather, collectives.all_reduce

    def all_gather(plan, t, axis, dim=0):
        if not isinstance(plan, _SimPlan):
            return gather(plan, t, axis, dim)
        return torch.cat(plan.group.exchange(plan.rank_sp, t), dim=dim)

    def all_reduce(plan, t, axis, op="sum"):
        if not isinstance(plan, _SimPlan):
            return reduce(plan, t, axis, op)
        parts = plan.group.exchange(plan.rank_sp, t)
        out = parts[0].clone()
        for p in parts[1:]:
            out = out + p  # rank order
        return out

    monkeypatch.setattr(collectives, "all_gather", all_gather)
    monkeypatch.setattr(collectives, "all_reduce", all_reduce)


def _on_ranks(sp, fn):
    """fn(plan, rank) on sp threads; their results in rank order."""
    group, out, errs = _Group(sp), [None] * sp, []

    def run(r):
        try:
            out[r] = fn(_SimPlan(group, r), r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(sp)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    return out


def _block(x, r, sp, axis):
    return np.ascontiguousarray(np.split(x, sp, axis=axis)[r])


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("use_cov", [False, True])
def test_sp_blocks_forward_and_backward_match_the_whole_row(simulated, sp,
                                                            use_cov):
    """The per-row form (training): FusedAttentionSP on each rank's block
    of T.  The context is the whole row's on every rank, the blocks'
    attention is the row's attention split; each rank takes 1/sp of the
    context's objective (replicated) and its own block's attention
    term, and the gradients, summed over the ranks where the input is
    replicated, are jax.vjp's of the whole row.  Row 1 is masked on every
    rank (zero attention, context and gradients); row 0's later blocks
    are all padding (m at NEG, l 0: weight exactly 0, no NaN)."""
    es, ef, mask, df, cov, v, w_c = make_inputs()
    df, cov = df[:, 0], cov[:, 0]
    rng = np.random.RandomState(3)
    g_ctx = rng.randn(*df.shape).astype(np.float32)
    g_attn = rng.randn(*mask.shape).astype(np.float32)

    def rank(plan, r):
        blk = [torch.from_numpy(_block(x, r, sp, 1)).requires_grad_(True)
               for x in (es, ef, cov)]
        rep = [torch.from_numpy(x.copy()).requires_grad_(True)
               for x in (df, v, w_c)]
        m_blk = torch.from_numpy(_block(mask, r, sp, 1))
        ctx, attn = fa.fused_attention(blk[0], blk[1], m_blk, rep[0], blk[2],
                                       rep[1], rep[2], use_cov, plan)
        objective = ((ctx * torch.from_numpy(g_ctx)).sum() / sp
                     + (attn * torch.from_numpy(
                         _block(g_attn, r, sp, 1))).sum())
        grads = torch.autograd.grad(objective, blk + rep)
        return n(ctx), n(attn), [n(g) for g in grads]

    out = _on_ranks(sp, rank)
    want_ctx, want_attn = pa._attention_xla(es, ef, mask, df, cov, v, w_c,
                                            use_cov)
    for ctx, _, _ in out:
        np.testing.assert_allclose(ctx, n(want_ctx), **TOL)
    attn = np.concatenate([a for _, a, _ in out], axis=1)
    np.testing.assert_allclose(attn, n(want_attn), **TOL)
    assert not attn[1].any() and not out[0][0][1].any()

    def f(es_, ef_, df_, cov_, v_, wc_):
        return pa._attention_xla(es_, ef_, mask, df_, cov_, v_, wc_, use_cov)

    _, vjp = jax.vjp(f, es, ef, df, cov, v, w_c)
    want = [n(x) for x in vjp((jnp.asarray(g_ctx), jnp.asarray(g_attn)))]
    for i in range(3):  # es, ef, cov: each rank's block
        got = np.concatenate([g[i] for _, _, g in out], axis=1)
        _close_scaled(got, want[(0, 1, 3)[i]])
    for i, w in zip(range(3, 6), (want[2], want[4], want[5])):
        _close_scaled(sum(g[i] for _, _, g in out), w)  # summed over sp
    for _, _, g in out:
        assert all(np.isfinite(x).all() for x in g)
        assert not g[0][1].any() and not g[1][1].any()  # row 1: zeros


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("full_attn", [False, True])
def test_sp_blocks_shared_form_matches_jax(simulated, sp, full_attn):
    """The beam's form (K = 3 queries per article, decode): attend_shared
    with the plan merges the blocks into the whole row's context on every
    rank; the attention comes back as the rank's block, or with
    ``full_attn`` as the whole row (what the copy distribution
    scatters), and the new coverage is the block's."""
    es, ef, mask, df, cov, v, w_c = make_inputs(K=3, seed=2)
    rng = np.random.RandomState(4)
    params = {"v": torch.from_numpy(v), "w_c": torch.from_numpy(w_c),
              "linear_kernel": torch.from_numpy(
                  rng.randn(16, 16).astype(np.float32) * 0.3),
              "linear_bias": torch.zeros(16)}
    dec = tuple(torch.from_numpy(rng.randn(3, 3, 8).astype(np.float32))
                for _ in range(2))
    df = n(torch_attn._dec_feats(params, dec))

    def rank(plan, r):
        blk = [torch.from_numpy(_block(x, r, sp, axis))
               for x, axis in ((es, 1), (ef, 1), (mask, 1), (cov, 2))]
        return [n(x) for x in torch_attn.attend_shared(
            params, blk[0], blk[1], blk[2], dec, blk[3], True, plan=plan,
            full_attn=full_attn)]

    out = _on_ranks(sp, rank)
    want_ctx, want_attn = jax.vmap(
        lambda a, b, m, d, e: pa._attention_xla_shared(a, b, m, d, e, v, w_c,
                                                       True))(
        es, ef, mask, df, cov)
    for r, (ctx, attn, new_cov) in enumerate(out):
        np.testing.assert_allclose(ctx, n(want_ctx), **TOL)
        blk = _block(n(want_attn), r, sp, 2)
        np.testing.assert_allclose(attn, n(want_attn) if full_attn else blk,
                                   **TOL)
        np.testing.assert_allclose(new_cov, _block(cov, r, sp, 2) + blk,
                                   **TOL)


def test_merge_gives_every_rank_the_same_bits(simulated):
    """The merge sums in sp-rank order on every rank: the ranks' contexts
    are the same bits, and a rerun gives them again."""
    es, ef, mask, df, cov, v, w_c = make_inputs(K=2, seed=6)

    def rank(plan, r):
        blk = [torch.from_numpy(_block(x, r, 3, axis))
               for x, axis in ((es, 1), (ef, 1), (mask, 1), (cov, 2))]
        out = fa.merge_sp_blocks(plan, *fa.fused_attention_block(
            blk[0], blk[1], blk[2], torch.from_numpy(df), blk[3],
            torch.from_numpy(v), torch.from_numpy(w_c), True))
        return n(out[0])

    first, again = _on_ranks(3, rank), _on_ranks(3, rank)
    for ctx in first + again:
        assert np.array_equal(ctx, first[0])


def test_block_plain_statistics_are_the_blocks_own():
    """fused_attention_block's plain version: the block's own softmax
    (ctx and attn normalised over the block), its row max, and its
    unfloored row sum; a block with no valid position has m at NEG and
    l exactly 0."""
    es, ef, mask, df, cov, v, w_c = make_inputs(K=2, seed=7)
    args = [torch.from_numpy(x) for x in (es, ef, mask, df, cov, v, w_c)]
    ctx, attn, m, l = fa.fused_attention_block(*args, True)
    want_ctx, want_attn = fa._attention_plain(*args, True)
    np.testing.assert_allclose(n(ctx), n(want_ctx), **TOL)
    np.testing.assert_allclose(n(attn), n(want_attn), **TOL)
    assert (n(m)[1] == np.float32(fa.NEG)).all() and not n(l)[1].any()
    # the block's max is the largest valid energy: exp(e - m) <= 1, and
    # the largest is 1
    p = n(attn) * n(l)[..., None]
    np.testing.assert_allclose(p.max(axis=-1)[[0, 2]], 1.0, **TOL)
