"""``--debug``'s op-level NaN check in the port against the JAX package's
``jax_debug_nans`` (ROADMAP.md, port fault 6).

The case: a tiny pointer-generator whose articles fill the encoder (no
padding) and whose attention weight W_h holds one +inf.  The forward is
finite (the infinite encoder features saturate tanh at +-1), so the loss
is finite; the backward multiplies tanh's zero derivative there by the
inf (0 * inf) and the gradient of the encoder states is NaN.  Under
--debug both packages must raise NonFiniteLossError from the
FloatingPointError of the first NaN op and dump the batch; without
--debug the port's step runs on (the loss is finite).  The JAX side
runs through ``utils.apply_debug_mode``, restored after."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import WORDS, article, make_hps, numpy_params
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu.utils import apply_debug_mode
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib

VSIZE = len(WORDS) + 4


class _Batch:
    def __init__(self, arrays):
        self.arrays = arrays

    def as_arrays(self):
        return self.arrays


class _Batcher:
    def __init__(self, arrays, n):
        self.items = [_Batch(arrays) for _ in range(n)]

    def next_batch(self):
        return self.items.pop(0) if self.items else None


def _case(debug):
    """(JAX hps, port hps, numpy params with the inf, batch arrays): every
    article longer than max_enc_steps, so no encoder position is
    padding."""
    jhps, thps = make_hps(mode="train", debug=debug, max_enc_steps=8,
                          max_dec_steps=6, min_dec_steps=1)
    p = numpy_params(thps, VSIZE, seed=5)
    p["decoder"]["attention"]["W_h"][0, 3] = np.inf
    vocab = Vocab(words=WORDS)
    exs = [batching.SummaryExample.build(article(i, n_words=20),
                                         ["the cat sat ."], vocab, thps)
           for i in range(thps.batch_size)]
    arrays = batching.Batch(exs, thps, vocab).as_arrays()
    assert arrays["enc_padding_mask"].all()
    return jhps, thps, p, arrays


def _port_trainer(thps, p, arrays, root):
    return trainer_lib.Trainer(
        thps.replace(log_root=str(root), exp_name="t"), VSIZE,
        _Batcher(arrays, 3),
        state=trainer_lib.init_train_state(thps, VSIZE, params=p))


def test_the_case_has_a_finite_loss_and_a_nan_gradient(tmp_path):
    """Without --debug the port's step runs: finite loss, NaN params."""
    _, thps, p, arrays = _case(debug=False)
    tr = _port_trainer(thps, p, arrays, tmp_path)
    state, metrics = trainer_lib.train_step(
        thps, tr.state, trainer_lib.batch_to_device(arrays, "cpu"),
        trainer_lib.make_loss_fn(thps), inplace=False)
    assert np.isfinite(float(metrics.loss))
    assert any(torch.isnan(x).any() for x in
               trainer_lib.tree_leaves(state.params))


def test_port_debug_raises_on_the_nan_gradient(tmp_path):
    _, thps, p, arrays = _case(debug=True)
    tr = _port_trainer(thps, p, arrays, tmp_path)
    with pytest.raises(trainer_lib.NonFiniteLossError) as exc:
        tr.train(num_steps=3)
    assert isinstance(exc.value.__cause__, FloatingPointError)
    assert "NaN in the output of aten." in str(exc.value)
    dumps = glob.glob(os.path.join(tr.train_dir, "nan_batch_step*.npz"))
    assert [os.path.basename(d) for d in dumps] == ["nan_batch_step0.npz"]
    assert set(np.load(dumps[0]).files) == set(arrays)
    assert tr.state.step == 0


def test_port_debug_recovery_skips_then_raises(tmp_path):
    """Armed recovery takes the op-level NaN as a bad step: skip, and
    NanLossError once the budget is spent."""
    _, thps, p, arrays = _case(debug=True)
    thps = thps.replace(nan_skip_steps=1)
    tr = _port_trainer(thps, p, arrays, tmp_path)
    with pytest.raises(trainer_lib.NanLossError) as exc:
        tr.train(num_steps=3)
    assert isinstance(exc.value.__cause__, FloatingPointError)


def test_jax_debug_raises_on_the_same_case(tmp_path):
    jhps, _, p, arrays = _case(debug=True)
    prev = jax.config.jax_debug_nans
    try:
        apply_debug_mode(jhps)
        jtr = jtrainer.Trainer(
            jhps.replace(log_root=str(tmp_path), exp_name="j"), VSIZE,
            _Batcher(arrays, 3),
            state=jtrainer.init_train_state(
                jhps, VSIZE, params=jax.tree_util.tree_map(jnp.asarray, p)))
        with pytest.raises(jtrainer.NonFiniteLossError) as exc:
            jtr.train(num_steps=3)
    finally:
        jax.config.update("jax_debug_nans", prev)
    assert isinstance(exc.value.__cause__, FloatingPointError)
    assert glob.glob(os.path.join(jtr.train_dir, "nan_batch_step*.npz"))


def test_debug_off_costs_no_mode(tmp_path):
    """--debug off: the step runs in no dispatch mode."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    seen = []
    _, thps, p, arrays = _case(debug=False)
    tr = _port_trainer(thps, p, arrays, tmp_path)
    orig = tr._dispatch
    tr._dispatch = lambda items: (seen.append(_get_current_dispatch_mode()),
                                  orig(items))[1]
    with pytest.raises(trainer_lib.NonFiniteLossError):
        tr.train(num_steps=3)  # the NaN params give a NaN loss next step
    assert seen and all(m is None for m in seen)
