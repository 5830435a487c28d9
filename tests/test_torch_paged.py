"""The port's paged slot state and page arena against the JAX package's,
on the CPU.

Mirrors the JAX package's tests/test_beam_backtrack.py:534 (paged
kernels at page boundaries) and :575 (arena-full backpressure, then the
freed pages recycled into another slot) for both families, and its
decode/arena.py contract.  Tolerances as in test_torch_slots.py: tokens
and lengths exact, average log-probs within 1e-5 relative, attention
rows within 1e-5 absolute."""

import numpy as np
import pytest

from test_torch_slots import (
    LENS,
    assert_same_hypothesis,
    batch_arrays,
    bucket_of,
    family_case,
    one_article,
)
from textsummarization_on_flink_tpu import config as jax_config
from textsummarization_on_flink_tpu.decode import arena as jax_arena
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu_torch import config
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode import decoder as dec_lib
from textsummarization_on_flink_tpu_torch.decode.arena import (
    ArenaExhaustedError,
    PageArena,
)
from textsummarization_on_flink_tpu_torch.params import from_numpy_tree
from _torch_parity import WORDS, article

BLOCK, B_MAX = 4, 6  # decode_enc_block 4 over max_enc_steps 24


def row_of(ids, pages):
    row = np.full(B_MAX, pages, np.int64)
    row[:len(ids)] = ids
    return row


def pages_for(L):
    return max(1, -(-L // BLOCK))


def drive_paged(thps, params, state, table, active, chunk=3):
    done = {}
    for _ in range(20):
        fin = beam_search.step_slots_paged(params, thps, state, active,
                                           table, chunk)
        assert not fin[~active].any()
        for s in np.nonzero(fin)[0]:
            done[int(s)] = beam_search.unpack_slot_paged(thps, state, int(s),
                                                         table[s])
            active[s] = False
        if not active.any():
            return done
    raise AssertionError("slots never finished")


@pytest.mark.parametrize("family", ["pointer_generator", "transformer"])
def test_paged_search_at_page_boundaries(family):
    """Articles of one page exactly, a page and one position, one
    position and the full six pages, each given ceil(len / block) arena
    pages, decoded together through the page table: each hypothesis is
    the port's batch search's and the JAX package's paged search's."""
    jhps, thps, p = family_case(family)
    arrays = batch_arrays(thps, LENS)
    params = from_numpy_tree(p)
    ref = beam_search.run_beam_search(params, thps, arrays)
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
    assert arena.pages_in_use == sum(pages_for(L) for L in LENS) == 11
    done = drive_paged(thps, params, state, table, np.ones(slots, bool))
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
        assert_same_hypothesis(done[i], ref.tokens[i], ref.length[i],
                               ref.avg_log_prob[i], ref.attn_dists[i])
        w = jdone[i]
        assert_same_hypothesis(done[i], w.tokens, w.length, w.avg_log_prob,
                               w.attn_dists)


@pytest.mark.parametrize("family", ["pointer_generator", "transformer"])
def test_arena_backpressure_then_recycled_pages_are_exact(family):
    """An arena of one full-length resident: the second full-length
    admission fails typed and allocates nothing; once the first is
    unpacked and freed, the same page ids go to another slot, whose
    hypothesis is still the batch search's (a recycled page keeps no
    trace of its last tenant; the retired slot's row reads scratch)."""
    _, thps, p = family_case(family)
    thps = thps.replace(batch_size=2)
    arrays = batch_arrays(thps, (24, 24), offset=4)
    params = from_numpy_tree(p)
    ref = beam_search.run_beam_search(params, thps, arrays)
    arena = PageArena(B_MAX)
    pres = [beam_search.prefill(params, thps, one_article(arrays, i, 24))
            for i in range(2)]
    state = beam_search.init_slots_paged(params, thps, 2, pres[0],
                                         arena.capacity)
    table = np.full((2, B_MAX), arena.capacity, np.int64)
    ids_a = arena.alloc(B_MAX)
    table[0] = row_of(ids_a, arena.capacity)
    beam_search.pack_slot_paged(params, thps, state, 0, pres[0], table[0])
    with pytest.raises(ArenaExhaustedError) as exc:
        arena.alloc(B_MAX)
    assert (exc.value.needed, exc.value.free) == (B_MAX, 0)
    assert arena.pages_in_use == B_MAX
    done = drive_paged(thps, params, state, table, np.array([True, False]))
    assert_same_hypothesis(done[0], ref.tokens[0], ref.length[0],
                           ref.avg_log_prob[0], ref.attn_dists[0])
    arena.free(ids_a)
    table[0] = arena.capacity
    ids_b = arena.alloc(B_MAX)
    assert sorted(ids_b) == sorted(ids_a)
    table[1] = row_of(ids_b, arena.capacity)
    beam_search.pack_slot_paged(params, thps, state, 1, pres[1], table[1])
    done = drive_paged(thps, params, state, table, np.array([False, True]))
    assert_same_hypothesis(done[1], ref.tokens[1], ref.length[1],
                           ref.avg_log_prob[1], ref.attn_dists[1])


def test_page_bytes_and_time_axes():
    """One page spans block positions of the encoder view's time-axis
    leaves, the ids (int64 in the port, int32 in the JAX package) and
    the attention history; the leaves' time axes are found by the meta
    probe."""
    for family in ("pointer_generator", "transformer"):
        jhps, thps, p = family_case(family)
        got = beam_search.paged_page_bytes(from_numpy_tree(p), thps)
        want = jax_bs.paged_page_bytes(p, jhps)
        assert got == want + BLOCK * 4  # the ids' wider pages
    _, thps, p = family_case("transformer")
    params = from_numpy_tree(p)
    arrays = batch_arrays(thps, LENS)
    pre = beam_search.prefill(params, thps, one_article(arrays, 0, 4))
    assert beam_search._enc_time_axes(thps, pre.enc_view) == (2, 2)
    _, thps, p = family_case("pointer_generator")
    pre = beam_search.prefill(from_numpy_tree(p), thps,
                              one_article(batch_arrays(thps, LENS), 0, 4))
    assert beam_search._enc_time_axes(thps, pre.enc_view) == \
        (1, 1, None, None)


# -- the arena, op for op against the JAX package's --------------------------

def _both(fn):
    """fn(arena class, error class) on each package's arena: results or
    the error's type name, for comparison."""
    out = []
    for cls, err in ((PageArena, ArenaExhaustedError),
                     (jax_arena.PageArena, jax_arena.ArenaExhaustedError)):
        try:
            out.append(fn(cls, err))
        except Exception as e:  # compared by type below
            out.append(type(e).__name__)
    return out


def test_arena_lifo_reuse_and_fill():
    def run(cls, err):
        a = cls(5)
        x = a.alloc(2).tolist()
        y = a.alloc(3).tolist()
        a.free(x)
        z = a.alloc(1).tolist()
        return x, y, z, a.free_pages, a.pages_in_use, a.fill
    port, jax = _both(run)
    assert port == jax
    assert port[0] == [0, 1] and port[2] == [1]  # LIFO: 1 came back last


@pytest.mark.parametrize("case", ["exhausted", "double_free", "out_of_range",
                                  "negative", "empty_arena"])
def test_arena_refusals(case):
    def run(cls, err):
        if case == "empty_arena":
            cls(0)
        a = cls(3)
        if case == "exhausted":
            a.alloc(2)
            try:
                a.alloc(2)
            except err as e:
                return "typed", e.needed, e.free, a.free_pages
        if case == "double_free":
            ids = a.alloc(1)
            a.free(ids)
            a.free(ids)
        if case == "out_of_range":
            a.free([3])
        if case == "negative":
            a.alloc(-1)
        return "no error"
    port, jax = _both(run)
    assert port == jax
    if case == "exhausted":
        assert port == ("typed", 2, 1, 1)  # all or nothing
    else:
        assert port == "ValueError"


@pytest.mark.parametrize("kw", [
    dict(), dict(serve_arena_pages=9), dict(serve_arena_pages=3),
    dict(serve_arena_mb=0.5), dict(serve_arena_mb=0.001),
    dict(serve_arena_pages=9, decode_enc_block=8)])
def test_resolve_arena_pages_matches_jax(kw):
    base = dict(max_enc_steps=24, decode_enc_block=4)
    base.update(kw)
    got, want = [], []
    for cfg, out in ((config, got), (jax_config, want)):
        try:
            out.append(cfg.resolve_arena_pages(cfg.HParams(**base), 4096))
        except ValueError as e:
            out.append(str(e))
    assert got == want


# -- the engine ------------------------------------------------------------

def test_paged_engine_holds_fewer_bytes_per_resident(tmp_path):
    """Short residents in a paged engine hold their pages, not the widest
    article's width: resident bytes per slot fall below the dense
    engine's, and the arena's counters follow packs and unpacks."""
    _, thps, p = family_case("pointer_generator")
    vocab = Vocab(words=WORDS)
    out = {}
    for name, extra in (("dense", {}), ("paged", dict(serve_arena_pages=8))):
        dec = dec_lib.BeamSearchDecoder(thps.replace(**extra), vocab, None,
                                        params=p,
                                        decode_root=str(tmp_path / name))
        engine = dec.slot_engine(slots=3, chunk=2)
        exs = [batching.SummaryExample.build(article(i, n_words=3), [],
                                             vocab, thps) for i in range(3)]
        for i, ex in enumerate(exs):
            engine.pack(i, engine.prefill(ex))
        out[name] = engine.resident_bytes_per_slot()
        if name == "paged":
            assert engine.pages_needed(exs[0]) == 1
            assert engine.arena_stats()["in_use"] == 3
            assert engine.free_pages() == 5
            while engine.active_count():
                for s in engine.step():
                    engine.unpack(s, exs[s])
            assert engine.arena_stats()["in_use"] == 0
    assert 0 < out["paged"] < out["dense"]
