"""The port's sequence-level distillation of the AAN draft
(train/distill.py) against the JAX package's, on the CPU.

At the committed BYTE_BUDGET.json ``spec.distill`` scale (transformer
teacher hidden 16, narrow draft hidden 8 with a rank-4 factored head):
the teacher's distillation triple equals the JAX package's on the same
numpy teacher; one DistillTrainer step from the same draft state gives
the JAX step's loss (rtol 1e-5) and params (rtol 1e-4 / atol 1e-6: f32
Adagrad on both sides after gradients summed in different orders); the
teacher sidecar refuses a mismatched teacher; the watchdog raises on a
non-finite loss.  Then the budget's gate, as tests/test_distill.py runs
it, on the port alone: a teacher trained on the learnable copy task, a
draft distilled on its greedy outputs, whose held-out acceptance clears
the committed floor while a fresh draft's stays below its ceiling, and
whose spec output is the teacher's greedy output.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_distill import copy_task_arrays
from tests.test_speculative import make_arrays
from textsummarization_on_flink_tpu.config import HParams as JaxHParams
from textsummarization_on_flink_tpu.models import transformer as jax_tfm
from textsummarization_on_flink_tpu.train import distill as jax_distill
from textsummarization_on_flink_tpu_torch import config, obs
from textsummarization_on_flink_tpu_torch.checkpoint.checkpointer import (
    Checkpointer,
)
from textsummarization_on_flink_tpu_torch.decode import beam_search
from textsummarization_on_flink_tpu_torch.decode import speculative
from textsummarization_on_flink_tpu_torch.models import avg_attention
from textsummarization_on_flink_tpu_torch.obs import Registry
from textsummarization_on_flink_tpu_torch.params import (
    from_numpy_tree,
    tree_leaves,
)
from textsummarization_on_flink_tpu_torch.train import distill
from textsummarization_on_flink_tpu_torch.train import trainer

BUDGET_PATH = os.path.join(os.path.dirname(__file__), "..",
                           "BYTE_BUDGET.json")


@pytest.fixture(autouse=True)
def _isolated_obs():
    with obs.use_registry(Registry()) as reg:
        yield reg


@pytest.fixture(scope="module")
def dbudget():
    with open(BUDGET_PATH) as f:
        return json.load(f)["spec"]["distill"]


@pytest.fixture(scope="module")
def hps_pair(dbudget):
    """(JAX HParams, port HParams) of the committed distillation scale."""
    jhps = JaxHParams(**dbudget["scale"])
    jhps.validate()
    thps = config.HParams(device="cpu", **dbudget["scale"])
    thps.validate()
    return jhps, thps


class _ArraysBatch:
    """A next_batch payload: distillation reads as_arrays() only."""

    def __init__(self, arrays):
        self._arrays = arrays

    def as_arrays(self):
        return self._arrays


class _CycleBatcher:
    def __init__(self, batches):
        self._batches = batches
        self._i = 0

    def next_batch(self):
        b = self._batches[self._i % len(self._batches)]
        self._i += 1
        return b


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_teacher(hps_pair):
    """A JAX-initialised teacher with a peaked vocab (so its greedy
    outputs vary and some stop early), as numpy."""
    jhps, _ = hps_pair
    p = numpy_tree(jax_tfm.init_params(jhps, jhps.vocab_size,
                                       jax.random.PRNGKey(3)))
    p["embedding"] = p["embedding"] * 30.0
    p["out_bias"] = p["out_bias"].copy()
    p["out_bias"][3] = 2.0  # STOP_ID
    return p


def test_teacher_arrays_match_jax(hps_pair, jax_teacher):
    jhps, thps = hps_pair
    arrays = make_arrays(jhps, jhps.batch_size, seed=3)
    got = distill.teacher_arrays(from_numpy_tree(jax_teacher), thps, arrays)
    want = jax_distill.teacher_arrays(jax_teacher, jhps, arrays)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    n = got["dec_padding_mask"].sum(axis=1)
    assert n.min() < thps.max_dec_steps  # a row stopped early
    assert (got["dec_batch"] < thps.vocab_size).all()


def test_one_step_matches_jax(hps_pair, jax_teacher):
    """One DistillTrainer step from the JAX trainer's initial draft state:
    the loss and every updated param and accumulator."""
    jhps, thps = hps_pair
    arrays = make_arrays(jhps, jhps.batch_size, seed=5)
    with jax_distill.obs.use_registry(jax_distill.obs.Registry()):
        jt = jax_distill.DistillTrainer(jhps, jhps.vocab_size,
                                        _CycleBatcher([_ArraysBatch(arrays)]),
                                        jax_teacher, seed=7)
        init = numpy_tree(jt.state)
        jt.distill(1)
        want = numpy_tree(jt.state)
        want_loss = float(jt._g_loss.value)
    start = trainer.make_train_state(
        init.params, init.opt_state.accumulators, int(init.step), "cpu")
    dt = distill.DistillTrainer(thps, thps.vocab_size,
                                _CycleBatcher([_ArraysBatch(arrays)]),
                                jax_teacher, state=start)
    dt.distill(1)
    assert int(dt.state.step) == int(want.step) == 1
    np.testing.assert_allclose(dt._g_loss.value, want_loss, rtol=1e-5)
    for got, w in zip(tree_leaves(dt.state.params),
                      jax.tree_util.tree_leaves(want.params)):
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-6)
    for got, w in zip(tree_leaves(dt.state.opt_state.accumulators),
                      jax.tree_util.tree_leaves(want.opt_state.accumulators)):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-6)


def test_checkpoint_pair_and_teacher_guard(tmp_path, hps_pair, jax_teacher):
    """The draft's checkpoint and its teacher sidecar: a new trainer
    resumes the saved state, the loader hands back its params, a
    mismatched teacher is refused (on restore and on load), and the
    JAX package's loader reads the port's directory."""
    _, thps = hps_pair
    batches = [_ArraysBatch(make_arrays(thps, thps.batch_size, seed=s))
               for s in range(2)]
    d = str(tmp_path / "draft")
    dt = distill.DistillTrainer(thps, thps.vocab_size, _CycleBatcher(batches),
                                jax_teacher, checkpointer=Checkpointer(d),
                                cache_teacher=True, seed=7)
    dt.distill(3)
    assert os.path.exists(os.path.join(d, distill.TEACHER_SIDECAR))
    dt2 = distill.DistillTrainer(thps, thps.vocab_size,
                                 _CycleBatcher(batches), jax_teacher,
                                 checkpointer=Checkpointer(d), seed=99)
    assert int(dt2.state.step) == 3
    for a, b in zip(tree_leaves(dt.draft_params()),
                    tree_leaves(dt2.draft_params())):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    loaded = distill.load_distilled_draft(d, full_params=jax_teacher)
    np.testing.assert_array_equal(loaded["out_bias"].numpy(),
                                  dt.draft_params()["out_bias"].detach()
                                  .numpy())
    jax_loaded = jax_distill.load_distilled_draft(d, full_params=jax_teacher)
    np.testing.assert_array_equal(np.asarray(jax_loaded["out_bias"]),
                                  loaded["out_bias"].numpy())
    wrong = dict(jax_teacher, out_bias=jax_teacher["out_bias"] + 1.0)
    with pytest.raises(ValueError, match="teacher"):
        distill.load_distilled_draft(d, full_params=wrong)
    with pytest.raises(ValueError, match="teacher"):
        distill.DistillTrainer(thps, thps.vocab_size, _CycleBatcher(batches),
                               wrong, checkpointer=Checkpointer(d))


def test_metrics_and_nan_watchdog(hps_pair, jax_teacher, _isolated_obs):
    _, thps = hps_pair
    batches = [_ArraysBatch(make_arrays(thps, thps.batch_size, seed=0))]
    dt = distill.DistillTrainer(thps, thps.vocab_size, _CycleBatcher(batches),
                                jax_teacher, cache_teacher=True, seed=7,
                                metrics_every=2)
    dt.distill(3)
    assert _isolated_obs.counter("train/distill_steps_total").value == 3
    assert _isolated_obs.histogram("train/distill_teacher_seconds").count == 1
    with torch.no_grad():
        dt.state.params["out_bias"].fill_(float("nan"))
    with pytest.raises(trainer.NonFiniteLossError):
        dt.distill(2)


# -- the committed gate, on the port ------------------------------------------

@pytest.fixture(scope="module")
def teacher(dbudget, hps_pair):
    """The port's teacher: the transformer trained on the copy task for
    the committed step count, from the port's numpy init."""
    _, thps = hps_pair
    hps = thps.replace(mode="train")
    state = trainer.init_train_state(hps.replace(seed=0), hps.vocab_size)
    n_batches = int(dbudget["teacher_batches"])
    data = [beam_search._to_device(copy_task_arrays(
        make_arrays(thps, thps.batch_size, seed=1000 + s), thps), "cpu")
        for s in range(n_batches)]
    loss_fn = trainer.make_loss_fn(hps)
    for i in range(int(dbudget["teacher_task_steps"])):
        state, _ = trainer.train_step(hps, state, data[i % n_batches],
                                      loss_fn=loss_fn)
    return {k: v for k, v in state.params.items()}


@pytest.fixture(scope="module")
def heldout(hps_pair):
    _, thps = hps_pair
    return make_arrays(thps, thps.batch_size, seed=100)


@pytest.fixture(scope="module")
def distilled(dbudget, hps_pair, teacher):
    _, thps = hps_pair
    batches = [_ArraysBatch(make_arrays(thps, thps.batch_size, seed=s))
               for s in range(int(dbudget["distill_batches"]))]
    with obs.use_registry(Registry()):
        dt = distill.DistillTrainer(thps, thps.vocab_size,
                                    _CycleBatcher(batches), teacher,
                                    cache_teacher=True, seed=7)
        dt.distill(int(dbudget["distill_steps"]))
    return dt.draft_params()


def test_distilled_acceptance_clears_the_floor_and_fresh_does_not(
        dbudget, hps_pair, teacher, heldout, distilled):
    _, thps = hps_pair
    got = distill.acceptance_rate(teacher, distilled, thps, heldout)
    assert got >= float(dbudget["min_accept_rate"]), got
    fresh = from_numpy_tree(avg_attention.init_params(
        config.derive_draft_hps(thps), thps.vocab_size, 7))
    fresh_rate = distill.acceptance_rate(teacher, fresh, thps, heldout)
    assert fresh_rate <= float(dbudget["max_fresh_accept_rate"]), fresh_rate


def test_distilled_spec_output_is_greedy(hps_pair, teacher, heldout,
                                         distilled):
    _, thps = hps_pair
    spec = speculative.run_spec_decode(teacher, distilled, thps, heldout)
    greedy = beam_search.run_beam_search(teacher, thps.replace(beam_size=1),
                                         heldout)
    np.testing.assert_array_equal(spec.length, greedy.length)
    for b in range(len(spec.length)):
        n = int(spec.length[b])
        assert list(spec.tokens[b][:n]) == list(greedy.tokens[b][:n])
    np.testing.assert_allclose(spec.avg_log_prob, greedy.avg_log_prob,
                               rtol=1e-5, atol=1e-6)
