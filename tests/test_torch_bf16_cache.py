"""``--decode_cache_dtype=bfloat16`` in the port against the JAX
package's, on the CPU: the transformer's decode self-attention KV cache
stored in bf16 and widened to f32 where it is read.

Mirrors the JAX package's tests/test_beam_backtrack.py:291-366 (the
pointer-generator unchanged, the drift envelope against the f32 cache,
one adapter step) and runs the bf16-cache paths of both packages on the
same numpy inputs: the beam batch, the dense and paged slot engines and
the speculative verifier.

Tolerances: tokens, lengths and the spec counts exactly equal; average
log-probs within 1e-5 relative and attention rows within 1e-5 absolute
(the f32 tests' tolerance: both packages round the same f32 projections
to bf16 and widen them back exactly, so only the order of f32 sums
differs); a cache entry within one bf16 unit in the last place (the f32
projection before the rounding may differ in its last bits, which can
move the rounding by one unit); the drift against the f32 cache within
JAX's envelope, avg log-prob atol 2e-2.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import WORDS, article
from test_speculative import TF_HPS, make_arrays
from test_torch_paged import BLOCK, B_MAX, drive_paged, pages_for, row_of
from test_torch_slots import (
    LENS,
    assert_same_hypothesis,
    batch_arrays,
    bucket_of,
    family_case,
    jax_slots,
    one_article,
    port_slots,
)
from test_torch_speculative import (
    assert_spec_matches_jax,
    jax_models,
    port_hps,
    run_both,
)
from test_torch_transformer_bf16 import (
    _decode_batch,
    _tf_decode_hps,
    _tf_decode_params,
)
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu.models import get_family as jax_family
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode import decoder as dec_lib
from textsummarization_on_flink_tpu_torch.decode.arena import PageArena
from textsummarization_on_flink_tpu_torch.models import transformer as tfm
from textsummarization_on_flink_tpu_torch.params import from_numpy_tree

TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = torch.bfloat16
BF16_CACHE = dict(decode_cache_dtype="bfloat16")


def bf16_case(family="transformer"):
    """test_torch_slots' parity case with the bf16 cache on both sides."""
    jhps, thps, p = family_case(family)
    return jhps.replace(**BF16_CACHE), thps.replace(**BF16_CACHE), p


def assert_cache_close(got, want):
    """Cache entries within one bf16 ulp of the larger magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(got), np.abs(want)))[1]
                   - 8)
    assert np.all(np.abs(got - want) <= ulp)


def cache_dtypes(state):
    return {k: v.dtype for k, v in state.items()}


def test_beam_batch_matches_jax():
    """The batch search with the bf16 cache: JAX's tokens and lengths,
    and its scores and attention at the f32 tests' tolerance."""
    jhps, thps, p = bf16_case()
    arrays = batch_arrays(thps, LENS)
    got = beam_search.run_beam_search(from_numpy_tree(p), thps, arrays)
    want = jax_bs.run_beam_search(p, jhps, arrays)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length, np.asarray(want.length))
    np.testing.assert_allclose(got.avg_log_prob,
                               np.asarray(want.avg_log_prob), rtol=1e-5)
    np.testing.assert_allclose(got.attn_dists, np.asarray(want.attn_dists),
                               atol=1e-5)


@pytest.mark.parametrize("pointer_gen", [True, False])
def test_beam_batch_in_bf16_compute_matches_jax(pointer_gen):
    """Under --compute_dtype=bfloat16 too: JAX's tokens and lengths from
    the sharpened checkpoint of the bf16 transformer tests."""
    jhps, thps = _tf_decode_hps(pointer_gen=pointer_gen, **BF16_CACHE)
    ja, ta = _decode_batch(jhps, thps, 3)
    p = _tf_decode_params(thps)
    want = jax_bs.run_beam_search(p, jhps, ja)
    got = beam_search.run_beam_search(from_numpy_tree(p), thps, ta)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length, np.asarray(want.length))


def test_single_adapter_step_matches_jax():
    """One adapter step from each article's encoder view (JAX's
    test_bf16_cache_single_step_envelope, held against JAX's own step):
    the top-2K ids, log-probs and attention, and a bf16 cache whose
    written entries are JAX's."""
    jhps, thps, p = bf16_case()
    arrays = batch_arrays(thps, LENS)
    params = from_numpy_tree(p)
    dev = beam_search._to_device(arrays, "cpu")
    enc = tfm.beam_encode(params, thps, dev)
    init_state, step = tfm.beam_adapter(thps)
    state = init_state(params, enc)
    assert set(cache_dtypes(state).values()) == {BF16}
    B, K = len(LENS), thps.beam_size
    latest = torch.full((B, K), 2, dtype=torch.long)
    got = step(params, enc, dev["enc_padding_mask"],
               dev["enc_batch_extend_vocab"], torch.zeros(B, dtype=torch.long),
               latest, state)
    assert set(cache_dtypes(got.state).values()) == {BF16}
    jfam = jax_family("transformer")
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, p)
    jenc = jfam.beam_encode(jparams, jhps, arrays)
    jinit, jstep = jfam.beam_adapter(jhps)
    for b in range(B):
        one = jax.tree_util.tree_map(lambda x, b=b: x[b], jenc)
        want = jstep(jparams, one, arrays["enc_padding_mask"][b],
                     arrays["enc_batch_extend_vocab"][b], np.int32(0),
                     np.full((K,), 2, np.int32), jinit(jparams, one))
        np.testing.assert_array_equal(got.topk_ids[b].numpy(),
                                      np.asarray(want.topk_ids))
        np.testing.assert_allclose(got.topk_log_probs[b].numpy(),
                                   np.asarray(want.topk_log_probs), **TOL)
        np.testing.assert_allclose(got.attn_dist[b].numpy(),
                                   np.asarray(want.attn_dist), **TOL)
        for name in ("cache_k", "cache_v"):
            assert want.state[name].dtype == jax.numpy.bfloat16
            assert_cache_close(got.state[name][b].float().numpy(),
                               np.asarray(want.state[name], np.float32))


def test_drift_envelope_against_the_f32_cache():
    """JAX's envelope (test_bf16_cache_drift_envelope): the same params
    and articles through the f32 and the bf16 cache agree within 2e-2
    in each article's average log-prob, and the narrowed cache's
    attention rows stay distributions."""
    _, thps, p = family_case("transformer")
    arrays = batch_arrays(thps, LENS)
    params = from_numpy_tree(p)
    a = beam_search.run_beam_search(params, thps, arrays)
    b = beam_search.run_beam_search(params, thps.replace(**BF16_CACHE),
                                    arrays)
    np.testing.assert_allclose(a.avg_log_prob, b.avg_log_prob, atol=2e-2)
    assert b.length.min() >= 2
    for row, n_tok in zip(b.attn_dists, b.length):
        np.testing.assert_allclose(row[:n_tok - 1].sum(axis=-1), 1.0,
                                   atol=1e-4)


def test_pointer_generator_ignores_the_cache_dtype():
    """The LSTM family has no KV cache: the option changes nothing
    (JAX's test_pg_family_ignores_cache_dtype)."""
    _, thps, p = family_case("pointer_generator")
    arrays = batch_arrays(thps, LENS)
    params = from_numpy_tree(p)
    a = beam_search.run_beam_search(params, thps, arrays)
    b = beam_search.run_beam_search(params, thps.replace(**BF16_CACHE),
                                    arrays)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.avg_log_prob, b.avg_log_prob)


def test_dense_slot_search_matches_jax_and_keeps_bf16_leaves():
    """The dense slot engine with the bf16 cache: each slot's hypothesis
    is the JAX slot search's; the cache leaves are bf16 after the packs
    and after every chunk (steps, the gather by parent, the masked
    carry of finished articles)."""
    jhps, thps, p = bf16_case()
    arrays = batch_arrays(thps, LENS, offset=5)
    placement = {3: 0, 1: 1, 0: 2, 2: 3}
    done, state = port_slots(thps, from_numpy_tree(p), arrays, placement)
    assert set(cache_dtypes(state.beam.dec_state).values()) == {BF16}
    want = jax_slots(jhps, p, arrays, placement)
    assert sorted(done) == sorted(want)
    for s in placement:
        w = want[s]
        assert_same_hypothesis(done[s], w.tokens, w.length, w.avg_log_prob,
                               w.attn_dists)


def test_paged_slot_search_matches_jax():
    """The paged slot engine with the bf16 cache (the dec_state stays
    dense and bf16; the encoder side is paged): JAX's paged search's
    hypotheses, articles at the page boundaries."""
    jhps, thps, p = bf16_case()
    arrays = batch_arrays(thps, LENS)
    params = from_numpy_tree(p)
    arena = PageArena(14)
    slots = len(LENS)
    pres = [beam_search.prefill(params, thps, one_article(
        arrays, i, bucket_of(thps, L))) for i, L in enumerate(LENS)]
    state = beam_search.init_slots_paged(params, thps, slots, pres[0],
                                         arena.capacity)
    table = np.full((slots, B_MAX), arena.capacity, np.int64)
    jzero = {k: np.zeros((slots,) + v.shape[1:], v.dtype)
             for k, v in arrays.items()}
    jstate = jax_bs.init_slots_paged_jit(p, jhps, jzero, arena.capacity)
    for i, L in enumerate(LENS):
        table[i] = row_of(arena.alloc(pages_for(L)), arena.capacity)
        beam_search.pack_slot_paged(params, thps, state, i, pres[i],
                                    table[i])
        jpre = jax_bs.prefill_jit(p, jhps, one_article(
            arrays, i, bucket_of(thps, L)))
        jstate = jax_bs.pack_slot_paged_jit(p, jhps, jstate, i, jpre,
                                            table[i].astype(np.int32))
    assert thps.decode_enc_block == BLOCK
    done = drive_paged(thps, params, state, table, np.ones(slots, bool))
    assert set(cache_dtypes(state.beam.dec_state).values()) == {BF16}
    active = np.ones(slots, bool)
    jdone = {}
    for _ in range(20):
        jstate, fin = jax_bs.step_slots_paged_jit(
            p, jhps, jstate, active, table.astype(np.int32), 3)
        for s in np.nonzero(np.asarray(fin))[0]:
            jdone[int(s)] = jax_bs.unpack_slot_paged_jit(
                jhps, jstate, int(s), table[s].astype(np.int32))
            active[s] = False
        if not active.any():
            break
    for i in range(slots):
        w = jdone[i]
        assert_same_hypothesis(done[i], w.tokens, w.length, w.avg_log_prob,
                               w.attn_dists)


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_decode_with_a_bf16_cache_matches_jax(seed):
    """The speculative tier over the transformer's verifier with the bf16
    cache: JAX's tokens, cycles, drafted, accepted and histograms
    exactly, its scores at the f32 tests' tolerance."""
    params, draft = jax_models(TF_HPS, seed=seed)
    spec, want, _ = run_both(TF_HPS, params, draft,
                             make_arrays(TF_HPS, 3, seed=seed), **BF16_CACHE)
    assert_spec_matches_jax(spec, want)


def test_spec_verify_with_a_bf16_cache_matches_jax_per_position():
    """One verify block of S positions per row (each row at its own
    step) against JAX's spec_verify of each article alone, bf16 caches
    on both sides."""
    jhps = TF_HPS.replace(beam_size=1, **BF16_CACHE)
    thps = port_hps(jhps)
    params, _ = jax_models(TF_HPS)
    arrays = make_arrays(jhps, 3, seed=2)
    S = jhps.spec_k + 1
    tokens = np.random.RandomState(0).randint(
        4, jhps.vocab_size, size=(3, S)).astype(np.int32)
    t0 = np.array([0, 3, jhps.max_dec_steps - 1], np.int32)
    tp = from_numpy_tree(params)
    dev = beam_search._to_device(arrays, "cpu")
    state = tfm.spec_init_state(thps, jhps.spec_k, 3, "cpu")
    assert set(cache_dtypes(state).values()) == {BF16}
    got = tfm.spec_verify(tp, thps, tfm.beam_encode(tp, thps, dev),
                          dev["enc_padding_mask"],
                          dev["enc_batch_extend_vocab"],
                          torch.as_tensor(t0).long(),
                          torch.as_tensor(tokens).long(), state)
    assert set(cache_dtypes(got[4]).values()) == {BF16}
    jfam = jax_family("transformer")
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jenc = jfam.beam_encode(jparams, jhps, arrays)
    for b in range(3):
        one = jax.tree_util.tree_map(lambda x, b=b: x[b], jenc)
        want = jfam.spec_verify(
            jparams, jhps, one, arrays["enc_padding_mask"][b],
            arrays["enc_batch_extend_vocab"][b], np.int32(t0[b]),
            tokens[b], jfam.spec_init_state(jhps, jhps.spec_k))
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:4], want[1:4]):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), **TOL)
        assert want[4]["cache_k"].dtype == jax.numpy.bfloat16
        assert_cache_close(got[4]["cache_k"][b].float().numpy(),
                           np.asarray(want[4]["cache_k"], np.float32))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_resident_bytes_per_slot_drop_by_the_cache_half(paged, tmp_path):
    """SlotDecodeEngine.resident_bytes_per_slot counts the cache at its
    stored size: the bf16 engine holds exactly 2 (K and V) * K * L * T *
    H * 2 bytes (f32 to bf16) less per slot than the f32 engine over the
    same residents, dense or paged (the cache stays dense in a paged
    engine)."""
    _, thps, p = family_case("transformer")
    extra = dict(serve_arena_pages=8) if paged else {}
    vocab = Vocab(words=WORDS)
    exs = [batching.SummaryExample.build(article(i, n_words=3), [], vocab,
                                         thps) for i in range(3)]
    held = {}
    for dtype in ("float32", "bfloat16"):
        dec = dec_lib.BeamSearchDecoder(
            thps.replace(decode_cache_dtype=dtype, **extra), vocab, None,
            params=p, decode_root=str(tmp_path / dtype))
        engine = dec.slot_engine(slots=3, chunk=2)
        for i, ex in enumerate(exs):
            engine.pack(i, engine.prefill(ex))
        held[dtype] = engine.resident_bytes_per_slot()
    K, L, T, H = (thps.beam_size, thps.dec_layers, thps.max_dec_steps + 1,
                  thps.hidden_dim)
    assert held["float32"] - held["bfloat16"] == 2 * K * L * T * H * 2
