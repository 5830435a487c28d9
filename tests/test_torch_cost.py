"""obs/cost.py, the port's closed-form price of its dispatches, against
``torch.utils.flop_counter.FlopCounterMode`` over the same dispatch run
on the CPU (the plain versions of the kernels), for each model family at
two small widths: a train step (and its byte-diet options), the batch
search, a slot-engine chunk (at the full and a bounded encoder width)
and a prefill bucket.  Its bytes against figures worked out by hand at
one shape per kind, and its parameter counts against the params trees.

Why not XLA's cost analysis, the JAX package's yardstick
(``__graft_entry__.train_step_cost`` and its siblings): it prices a
compiled XLA program, which the port does not have, and it counts a
loop's body once (__graft_entry__.py:249-252), so its figures are not
the same quantity as a dispatch's work.  The sentinel needs one price
per shape that is the same every time; FlopCounterMode counts the
products the port itself runs.

What FlopCounterMode counts and the model prices: 2 x the multiply-adds
of every matmul, bmm and einsum.  The plain flash forward of training
forms each row's log-sum-exp with a second q k^T product that the
card's kernel does not run (it returns lse from its one pass); the
count here leaves that product out, as the card never runs it.

Tolerance: the FLOPs within 1% (in fact equal: the model writes the
same products); bytes and parameter counts exact."""

import numpy as np
import pytest
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from _torch_parity import WORDS, make_hps
from test_torch_byte_diet import batch_arrays as train_arrays
from test_torch_slots import LENS, batch_arrays, bucket_of, one_article
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode.beam_search import _to_device
from textsummarization_on_flink_tpu_torch.obs import cost
from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    init_numpy_params,
    tree_leaves,
)
from textsummarization_on_flink_tpu_torch.train import trainer

VSIZE = len(WORDS) + 4
#: two small widths per family
WIDTHS = {
    "pointer_generator": [dict(hidden_dim=16, emb_dim=8),
                          dict(hidden_dim=24, emb_dim=12)],
    "transformer": [dict(hidden_dim=32, num_heads=4, enc_layers=2,
                         dec_layers=2),
                    dict(hidden_dim=48, num_heads=3, ffn_dim=80,
                         enc_layers=1, dec_layers=2)],
    "avg_attention": [dict(hidden_dim=32, num_heads=4, enc_layers=2,
                           dec_layers=2),
                      dict(hidden_dim=48, num_heads=3, enc_layers=1,
                           dec_layers=2, draft_hidden=24,
                           draft_vocab_rank=8)],
}
CASES = [pytest.param(f, w, id=f"{f}-{i}") for f, ws in WIDTHS.items()
         for i, w in enumerate(ws)]


@pytest.fixture(autouse=True)
def _lse_uncounted(monkeypatch):
    """The plain training forward's separate lse product, run outside
    the counter (module docstring)."""
    orig = fl._flash_lse_plain

    def lse(*a, **kw):
        with _disable_current_modes():
            return orig(*a, **kw)

    monkeypatch.setattr(fl, "_flash_lse_plain", lse)


def counted(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def assert_priced(price, count):
    assert count > 0
    assert abs(price["flops"] - count) <= 0.01 * count, (price, count)


def hps_of(family, width, **kw):
    _, thps = make_hps(model_family=family, vocab_size=VSIZE,
                       decode_enc_block=4, serve_buckets="4,8,12,24",
                       **dict(width, **kw))
    return thps


TRAIN_OPTIONS = [dict(), dict(loss_chunk=3), dict(remat=True),
                 dict(pointer_gen=False, coverage=True),
                 dict(compute_dtype="bfloat16")]


@pytest.mark.parametrize("family,width", CASES)
@pytest.mark.parametrize("options", TRAIN_OPTIONS,
                         ids=["plain", "loss_chunk", "remat", "no_pointer",
                              "bf16"])
def test_train_step_flops(family, width, options):
    thps = hps_of(family, width, mode="train", **options)
    state = trainer.init_train_state(
        thps, VSIZE, params=init_numpy_params(thps, VSIZE, 0))
    arrays = _to_device(train_arrays(thps, 1), "cpu")
    assert_priced(cost.train_step_cost(thps),
                  counted(trainer.train_step, thps, state, arrays))
    two = cost.train_step_cost(thps, steps=2)
    assert two == {k: 2 * v for k, v in cost.train_step_cost(thps).items()}


def decode_case(family, width, **kw):
    thps = hps_of(family, width, min_dec_steps=3, batch_size=len(LENS),
                  **kw)
    p = init_numpy_params(thps, VSIZE, 3)
    p["embedding"] = p["embedding"] * 4.0
    return thps, from_numpy_tree(p), batch_arrays(thps, LENS)


@pytest.mark.parametrize("family,width", CASES)
def test_batch_search_flops(family, width):
    """The encoder and every step the search ran (steps_run, whole
    chunks of steps; an ended article's steps still compute, masked)."""
    thps, params, arrays = decode_case(family, width)
    s0 = beam_search.steps_run
    n = counted(beam_search.run_beam_search, params, thps, arrays)
    steps = beam_search.steps_run - s0
    assert_priced(cost.decode_step_cost(thps, "batch", chunk=steps), n)


def _slots(thps, params, arrays, lens):
    pres = [beam_search.prefill(params, thps, one_article(
        arrays, i, bucket_of(thps, int(arrays["enc_lens"][i]))))
        for i in range(len(lens))]
    state = beam_search.init_slots(params, thps, len(lens), pres[0])
    for i, pre in enumerate(pres):
        beam_search.pack_slot(params, thps, state, i, pre)
    return state


@pytest.mark.parametrize("family,width", CASES)
@pytest.mark.parametrize("active", [(1, 1, 1, 1), (1, 1, 1, 0)],
                         ids=["full_width", "bounded"])
def test_slot_chunk_flops(family, width, active):
    """One chunk of 3 steps over every resident slot, the
    cross-attention bounded by the longest active article (the last is
    24 positions, the others fit in 12)."""
    thps, params, arrays = decode_case(family, width)
    state = _slots(thps, params, arrays, LENS)
    act = np.array(active, bool)
    nb = beam_search.active_blocks(thps, state.enc_valid_len, act)
    enc_len = min(nb * thps.decode_enc_block, thps.max_enc_steps)
    assert enc_len == (24 if act[-1] else 12)
    n = counted(beam_search.step_slots, params, thps, state, act, 3)
    assert_priced(cost.decode_step_cost(thps, "slot", chunk=3,
                                        enc_len=enc_len), n)


@pytest.mark.parametrize("family,width", CASES)
@pytest.mark.parametrize("article", [0, 2])
def test_prefill_flops(family, width, article):
    thps, params, arrays = decode_case(family, width)
    bucket = bucket_of(thps, LENS[article])
    n = counted(beam_search.prefill, params, thps,
                one_article(arrays, article, bucket))
    assert_priced(cost.prefill_cost(thps, bucket), n)


@pytest.mark.parametrize("family,width", CASES)
def test_param_count_is_the_params_tree(family, width):
    thps = hps_of(family, width)
    assert cost.param_count(thps) == sum(
        x.size for x in tree_leaves(init_numpy_params(thps, VSIZE, 0)))


def test_train_bytes_by_hand():
    """The JAX chaos tests' tiny pointer-generator (H 4, E 3, V 11, batch
    2, 6 encoder and 5 decoder steps).  Its 804 parameters: embedding
    11*3 = 33; two encoder LSTMs 2*((3+4)*16 + 16) = 256; reduce
    2*(8*4 + 4) = 72; attention 8*8 + 8*8 + 8 + 8 + 8 = 152; input
    linear 11*3 + 3 = 36; cell 7*16 + 16 = 128; p_gen 19 + 1 = 20;
    output linear 12*4 + 4 = 52; projection 4*11 + 11 = 55.  Bytes: the
    params read, the gradients written and the f32 accumulators read
    and written, 804 * 16 = 12864; the f32 encoder states 2*6*8*4 = 384;
    the f32 scores 5*2*11*4 = 440."""
    thps = make_hps(batch_size=2, max_enc_steps=6, max_dec_steps=5,
                    hidden_dim=4, emb_dim=3, vocab_size=11,
                    min_dec_steps=1)[1]
    assert cost.param_count(thps) == 804
    assert cost.train_step_cost(thps)["bytes"] == 12864 + 384 + 440
    # bf16 accumulators: 804 * (4 + 4 + 2 * 2)
    assert cost.train_step_cost(thps.replace(opt_state_dtype="bfloat16"))[
        "bytes"] == 804 * 12 + 384 + 440
    # --loss_chunk streams the scores: they leave the bytes
    assert cost.train_step_cost(thps.replace(loss_chunk=2))["bytes"] == \
        12864 + 384


def test_slot_chunk_bytes_by_hand():
    """A transformer slot chunk (H 8 = 2 heads x 4, FFN 32, 2 decoder
    layers, V 20, 3 slots x beam 2, 10 encoder positions, 6 decoder
    steps, chunk 2).  Per step, the weights its products read, f32:
    per layer q, k, v, o, cross q and o 6*64 and the FFN 2*8*32, so
    2*(384 + 512) = 1792, plus the tied projection 8*20 = 160 and p_gen
    16: 1968 * 4 = 7872; the cross K/V it reads, f32: 2*2*3*10*8*4 =
    3840; the KV cache it reads, 2*2*3*2*7*8 = 1344 elements: 5376
    bytes in f32, 2688 in bf16.  Two steps."""
    thps = make_hps(model_family="transformer", hidden_dim=8, num_heads=2,
                    ffn_dim=32, enc_layers=1, dec_layers=2, vocab_size=20,
                    batch_size=3, beam_size=2, max_enc_steps=10,
                    max_dec_steps=6, min_dec_steps=1)[1]
    f32 = cost.decode_step_cost(thps, "slot", chunk=2)["bytes"]
    bf16 = cost.decode_step_cost(
        thps.replace(decode_cache_dtype="bfloat16"), "slot", chunk=2)["bytes"]
    assert f32 == 2 * (7872 + 3840 + 5376)
    assert bf16 == 2 * (7872 + 3840 + 2688)


def test_a_rank_is_priced_at_its_share():
    """On a dp x tp mesh the products and activations split over the
    ranks, the parameters over tp."""
    thps = make_hps(batch_size=4, vocab_size=VSIZE)[1]
    one = cost.decode_step_cost(thps, "slot")
    four = cost.decode_step_cost(thps.replace(dp=2, tp=2), "slot")
    assert four["flops"] == one["flops"] / 4
    assert four["bytes"] < one["bytes"]
    with pytest.raises(ValueError, match="path"):
        cost.decode_step_cost(thps, "beam")
