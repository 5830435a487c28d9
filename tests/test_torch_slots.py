"""The port's slot engine (continuous serving) against the JAX package's
and against the port's own batch search, on the CPU.

Mirrors the JAX package's tests/test_beam_search.py:243 and :274 (slot
search against the batch search, refill of a retired slot),
tests/test_beam_backtrack.py:198 and :256 (both families, articles
prefilled at their buckets and decoded together under the length bound)
and tests/test_serve.py:954 (the continuous ServingServer against the
micro-batch one) without that test's jit-cache claim: eager PyTorch has
no jit cache (SlotDecodeEngine.cache_sizes reports the resident
shapes, which must not change across requests).

Tolerances: tokens and lengths exactly equal everywhere; average
log-probs within 1e-5 relative and attention rows within 1e-5 absolute
(f32 on both sides; the bounded step sums over a shorter axis, so only
the order of sums differs); the bounded plain attention within 1e-5
absolute and relative of the JAX package's _attend_shared_blocked."""

import numpy as np
import pytest
import torch

from _torch_parity import (
    WORDS,
    abstract,
    article,
    decode_params,
    make_hps,
    n,
    numpy_params,
    t,
)
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu.obs import Registry as JaxRegistry
from textsummarization_on_flink_tpu.ops import attention as jax_attention
from textsummarization_on_flink_tpu.serve.server import (
    ServingServer as JaxServingServer,
)
from textsummarization_on_flink_tpu_torch import config
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.obs import Registry
from textsummarization_on_flink_tpu_torch.ops import attention
from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
)
from textsummarization_on_flink_tpu_torch.serve.server import ServingServer

TOL = dict(rtol=1e-5, atol=1e-5)
VSIZE = len(WORDS) + 4
#: true article lengths against decode_enc_block 4 and buckets 4, 8, 12,
#: 24: a one-token article, one exactly a block (and a bucket), one that
#: straddles a block and sits mid-bucket, and one at the full width
LENS = (1, 4, 9, 24)
BUCKETS = "4,8,12,24"
TF = dict(model_family="transformer", hidden_dim=32, num_heads=4,
          enc_layers=2, dec_layers=2)


def family_case(family):
    """(JAX hps, port hps, numpy params) shaped for beam parity (peaked
    distributions, a STOP bias: some beams end before the horizon)."""
    kw = dict(batch_size=len(LENS), decode_enc_block=4, serve_buckets=BUCKETS,
              coverage=True)
    if family == "transformer":
        jhps, thps = make_hps(**dict(TF, **kw))
        p = init_numpy_params(thps, VSIZE, 11)
        p["embedding"] *= 30.0
        p["out_bias"][3] = 3.0  # STOP_ID
    else:
        jhps, thps = make_hps(**kw)
        p = decode_params(thps, VSIZE)
    return jhps, thps, p


def articles(lens, offset=0):
    """Articles of the given token counts (n words and the final '.')."""
    return [article(i + offset, n_words=max(L - 1, 0))
            if L > 1 else "." for i, L in enumerate(lens)]


def batch_arrays(thps, lens, offset=0):
    vocab = Vocab(words=WORDS)
    exs = [batching.SummaryExample.build(a, [abstract(i)], vocab, thps)
           for i, a in enumerate(articles(lens, offset))]
    arrays = batching.Batch(exs, thps, vocab).as_arrays()
    np.testing.assert_array_equal(arrays["enc_lens"],
                                  np.minimum(lens, thps.max_enc_steps))
    return {k: v for k, v in arrays.items() if k.startswith("enc_")}


def bucket_of(thps, L):
    return config.bucket_for(
        config.parse_bucket_spec(thps.serve_buckets, thps.max_enc_steps), L)


def one_article(arrays, i, bucket):
    return {k: (v[i:i + 1, :bucket] if v.ndim == 2 else v[i:i + 1])
            for k, v in arrays.items()}


def port_slots(thps, params, arrays, placement, chunk=3, slots=None):
    """Prefill each article at its bucket, pack it into its slot
    (placement: slot -> article), step until all finish, unpack."""
    slots = slots or len(arrays["enc_lens"])
    pres = {s: beam_search.prefill(
        params, thps, one_article(arrays, a, bucket_of(
            thps, int(arrays["enc_lens"][a]))))
        for s, a in placement.items()}
    state = beam_search.init_slots(params, thps, slots,
                                   next(iter(pres.values())))
    for s, pre in pres.items():
        beam_search.pack_slot(params, thps, state, s, pre)
    np.testing.assert_array_equal(
        state.enc_valid_len[list(placement)],
        arrays["enc_lens"][list(placement.values())])
    active = np.zeros(slots, bool)
    active[list(placement)] = True
    done = {}
    for _ in range(20):
        fin = beam_search.step_slots(params, thps, state, active, chunk)
        assert not fin[~active].any()  # an inactive slot stays silent
        for s in np.nonzero(fin)[0]:
            done[int(s)] = beam_search.unpack_slot(thps, state, int(s))
            active[s] = False
        if not active.any():
            return done, state
    raise AssertionError("slots never finished")


def jax_slots(jhps, params, arrays, placement, chunk=3):
    slots = len(arrays["enc_lens"])
    zero = {k: np.zeros((slots,) + v.shape[1:], v.dtype)
            for k, v in arrays.items()}
    state = jax_bs.init_slots_jit(params, jhps, zero)
    for s, a in placement.items():
        pre = jax_bs.prefill_jit(params, jhps, one_article(
            arrays, a, bucket_of(jhps, int(arrays["enc_lens"][a]))))
        state = jax_bs.pack_slot_jit(params, jhps, state, s, pre)
    active = np.zeros(slots, bool)
    active[list(placement)] = True
    done = {}
    for _ in range(20):
        state, fin = jax_bs.step_slots_jit(params, jhps, state, active,
                                           chunk)
        for s in np.nonzero(np.asarray(fin))[0]:
            done[int(s)] = jax_bs.unpack_slot_jit(jhps, state, int(s))
            active[s] = False
        if not active.any():
            return done
    raise AssertionError("JAX slots never finished")


def assert_same_hypothesis(got, want_tokens, want_len, want_avg=None,
                           want_attn=None):
    n_tok = int(got.length)
    assert n_tok == int(want_len)
    np.testing.assert_array_equal(np.asarray(got.tokens)[:n_tok],
                                  np.asarray(want_tokens)[:n_tok])
    if want_avg is not None:
        np.testing.assert_allclose(float(got.avg_log_prob), float(want_avg),
                                   rtol=1e-5)
    if want_attn is not None:
        np.testing.assert_allclose(got.attn_dists, np.asarray(want_attn),
                                   atol=1e-5)


#: slot -> article: out of order, one slot left empty
PLACEMENT = {4: 0, 0: 1, 2: 2, 1: 3}


@pytest.mark.parametrize("family", ["pointer_generator", "transformer"])
def test_slot_search_equals_the_port_batch_search(family):
    """Mixed lengths prefilled at their buckets, packed out of order with
    an empty slot, stepped with a chunk that does not divide
    max_dec_steps: each slot's hypothesis is the batch search's."""
    _, thps, p = family_case(family)
    arrays = batch_arrays(thps, LENS)
    params = from_numpy_tree(p)
    ref = beam_search.run_beam_search(params, thps, arrays)
    done, _ = port_slots(thps, params, arrays, PLACEMENT, slots=5)
    assert sorted(done) == sorted(PLACEMENT)
    for s, a in PLACEMENT.items():
        assert_same_hypothesis(done[s], ref.tokens[a], ref.length[a],
                               ref.avg_log_prob[a], ref.attn_dists[a])


@pytest.mark.parametrize("family", ["pointer_generator", "transformer"])
def test_slot_search_equals_the_jax_slot_search(family):
    jhps, thps, p = family_case(family)
    arrays = batch_arrays(thps, LENS, offset=5)
    placement = {3: 0, 1: 1, 0: 2, 2: 3}
    done, _ = port_slots(thps, from_numpy_tree(p), arrays, placement)
    want = jax_slots(jhps, p, arrays, placement)
    assert sorted(done) == sorted(want)
    for s in placement:
        w = want[s]
        assert_same_hypothesis(done[s], w.tokens, w.length, w.avg_log_prob,
                               w.attn_dists)


def test_the_parity_articles_exercise_stop_and_the_bound():
    """The parity above is only as strong as its articles: some beams end
    on STOP before the horizon and some run to it, and the longest
    article's blocks differ from the shortest's."""
    _, thps, p = family_case("pointer_generator")
    arrays = batch_arrays(thps, LENS)
    ref = beam_search.run_beam_search(from_numpy_tree(p), thps, arrays)
    T1 = thps.max_dec_steps + 1
    assert (ref.length < T1).any() and (ref.length == T1).any()
    act = np.array([True, True, False, False])
    assert beam_search.active_blocks(thps, arrays["enc_lens"], act) == 1
    assert beam_search.active_blocks(thps, arrays["enc_lens"], ~act) == 6


@pytest.mark.parametrize("family", ["pointer_generator", "transformer"])
def test_refill_of_a_retired_slot_is_exact(family):
    """Retire a slot, pack another article into it: its hypothesis is the
    batch search's (the refill contract the scheduler relies on)."""
    _, thps, p = family_case(family)
    arrays = batch_arrays(thps, LENS, offset=2)
    params = from_numpy_tree(p)
    ref = beam_search.run_beam_search(params, thps, arrays)
    done, state = port_slots(thps, params, arrays, {1: 3}, chunk=2, slots=2)
    assert_same_hypothesis(done[1], ref.tokens[3], ref.length[3])
    pre = beam_search.prefill(params, thps, one_article(arrays, 0, 4))
    beam_search.pack_slot(params, thps, state, 1, pre)
    active = np.array([False, True])
    for _ in range(20):
        fin = beam_search.step_slots(params, thps, state, active, 2)
        if fin[1]:
            break
    assert_same_hypothesis(beam_search.unpack_slot(thps, state, 1),
                           ref.tokens[0], ref.length[0], ref.avg_log_prob[0],
                           ref.attn_dists[0])


# -- the bounded attention ------------------------------------------------

def attention_inputs(B=3, K=2, T=24, D=8, seed=0):
    rng = np.random.RandomState(seed)
    es = rng.randn(B, T, D).astype(np.float32)
    ef = rng.randn(B, T, D).astype(np.float32)
    df = rng.randn(B, K, D).astype(np.float32)
    cov = (rng.rand(B, K, T) * 2).astype(np.float32)
    v = rng.randn(D).astype(np.float32) * 0.5
    w_c = rng.randn(D).astype(np.float32) * 0.5
    return es, ef, df, cov, v, w_c


#: (block, nb): t_active at 1, a block edge, two blocks, exactly T, a
#: bound clamped to T, a block that does not divide T
BOUNDS = [(1, 1), (8, 1), (8, 2), (8, 3), (7, 4), (5, 3)]


@pytest.mark.parametrize("block,nb", BOUNDS)
@pytest.mark.parametrize("use_cov", [True, False])
def test_bounded_plain_attention_matches_jax_blocked(block, nb, use_cov):
    """fa._attention_plain(t_active=min(nb * block, T)) against JAX
    _attend_shared_blocked(nb, block), article by article: the prefix's
    weights and context within 1e-5, exact zeros past the bound.  Every
    article has a valid position inside the bound (the engine's bound
    covers every active resident); article 2 is valid past it."""
    es, ef, df, cov, v, w_c = attention_inputs()
    T = es.shape[1]
    t_act = min(nb * block, T)
    lens = np.array([t_act, max(1, t_act // 2), T])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    ctx, attn = fa._attention_plain(t(es), t(ef), t(mask), t(df), t(cov),
                                    t(v), t(w_c), use_cov, t_active=t_act)
    for b in range(3):
        jctx, jattn = jax_attention._attend_shared_blocked(
            es[b], ef[b], mask[b], df[b], cov[b], v, w_c, use_cov, nb, block)
        np.testing.assert_allclose(n(ctx[b]), n(jctx), **TOL)
        np.testing.assert_allclose(n(attn[b]), n(jattn), **TOL)
    assert not attn[:, :, t_act:].any()
    if t_act == T:  # the bound at T is the dense form, bit for bit
        dense = fa._attention_plain(t(es), t(ef), t(mask), t(df), t(cov),
                                    t(v), t(w_c), use_cov)
        assert all(torch.equal(a, b) for a, b in zip((ctx, attn), dense))


@pytest.mark.parametrize("block,nb", [(4, 1), (4, 3), (8, 3)])
def test_attend_shared_nb_matches_jax(block, nb):
    """ops/attention.attend_shared(nb, block) against the JAX package's
    attend_shared on each article (its decoder-state projection and
    coverage update included)."""
    _, thps = make_hps(coverage=True)
    p = numpy_params(thps, VSIZE, seed=3)["decoder"]["attention"]
    rng = np.random.RandomState(1)
    B, K, T, H = 2, 3, 24, thps.hidden_dim
    es = rng.randn(B, T, 2 * H).astype(np.float32)
    ef = rng.randn(B, T, 2 * H).astype(np.float32)
    c, h = (rng.randn(B, K, H).astype(np.float32) for _ in range(2))
    cov = rng.rand(B, K, T).astype(np.float32)
    lens = np.array([min(nb * block, T), 3])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    tp = {k: t(x) for k, x in p.items()}
    ctx, attn, new_cov = attention.attend_shared(
        tp, t(es), t(ef), t(mask), (t(c), t(h)), t(cov), True, nb=nb,
        block=block)
    for b in range(B):
        jctx, jattn, jcov = jax_attention.attend_shared(
            p, es[b], ef[b], mask[b], (c[b], h[b]), cov[b], True, nb=nb,
            block=block)
        for got, want in ((ctx, jctx), (attn, jattn), (new_cov, jcov)):
            np.testing.assert_allclose(n(got[b]), n(want), **TOL)


# -- the continuous ServingServer -------------------------------------------

SERVE_LENS = (3, 9, 24, 1, 14, 6, 20, 4, 11, 24)


def _serve(server, texts):
    with server:
        futs = [server.submit(a, uuid=f"u{i}") for i, a in enumerate(texts)]
        return [f.result(timeout=300) for f in futs]


@pytest.fixture(scope="module", params=["pointer_generator", "transformer"])
def served(request, tmp_path_factory):
    """The same articles through the port's micro-batch server, its
    continuous server (dense and paged; the paged arena holds 8 pages,
    under the 10 the three slots' residents can want) and the JAX
    package's continuous server."""
    family = request.param
    jhps, thps, p = family_case(family)
    root = tmp_path_factory.mktemp(family)
    texts = articles(SERVE_LENS)
    cont = dict(serve_mode="continuous", serve_slots=3, serve_refill_chunk=2)
    out = dict(family=family)
    out["mb"] = _serve(ServingServer(thps, Vocab(words=WORDS), params=p,
                                     decode_root=str(root / "mb"),
                                     registry=Registry()), texts)
    for name, extra in (("dense", {}), ("paged", dict(serve_arena_pages=8))):
        reg = Registry()
        server = ServingServer(thps.replace(**cont, **extra),
                               Vocab(words=WORDS), params=p,
                               decode_root=str(root / name), registry=reg)
        engine = server._cont._engine
        out[name] = _serve(server, texts)
        out[name + "_reg"] = reg
        out[name + "_engine"] = engine
    out["jax"] = _serve(JaxServingServer(
        jhps.replace(**cont), JaxVocab(words=WORDS), params=p,
        decode_root=str(root / "jax"), registry=JaxRegistry()), texts)
    return out


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_continuous_server_equals_micro_batch_and_jax(served, mode):
    got = served[mode]
    assert [r.uuid for r in got] == [f"u{i}" for i in range(len(SERVE_LENS))]
    words = [r.decoded_words for r in got]
    assert words == [r.decoded_words for r in served["mb"]]
    assert words == [r.decoded_words for r in served["jax"]]
    assert any(words)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_continuous_telemetry_and_fixed_resident_shapes(served, mode):
    """Every request was a refill, the occupancy histogram saw each
    chunk, and the resident state kept one shape throughout (the port's
    stand-in for the JAX test's bounded jit cache)."""
    reg, engine = served[mode + "_reg"], served[mode + "_engine"]
    assert reg.counter("serve/slot_refills_total").value == len(SERVE_LENS)
    assert reg.histogram("serve/slot_occupancy").count > 0
    assert reg.histogram("serve/request_resident_chunks").count == \
        len(SERVE_LENS)
    sizes = engine.cache_sizes()
    T = engine._hps.max_enc_steps
    assert sizes["enc_mask.0"] == (3, T)
    assert all(v[0] == 3 for k, v in sizes.items() if k.startswith("beam."))
    assert engine.active_count() == 0
    if mode == "paged":
        assert engine.paged and engine.arena_stats()["in_use"] == 0
        assert reg.counter("serve/arena_alloc_failures_total").value > 0
    else:
        assert not engine.paged and engine.arena_stats() is None
