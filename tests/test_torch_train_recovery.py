"""The port's long-run trainer options against the JAX package's, on the
CPU: divergence recovery (skip, roll back with an LR cut, then
``NanLossError``) driven by the seeded ``train.step_nan`` fault point,
the ``ckpt.load`` fault point, ``steps_per_dispatch``, the windowed
``metrics_every`` watchdog, the ``DevicePrefetcher``, the ``profile_dir``
capture, and the new flags through ``cli.main --mode=train`` and the
pipeline's ``fit``.  Mirrors the JAX package's tests/test_chaos.py:85-130,
tests/test_training.py:98-110, :202, :370 and
tests/test_obs_integration.py:208-230.

Sizes: the JAX chaos tests' tiny model (hidden 4, embedding 3, 6/5
steps, batch 2) for the recovery ladder, tests/_torch_parity.py's
(hidden 16, V 60) where the two packages are compared.

Tolerances: params and accumulators within 1e-5 * max(1, max|x|) of the
JAX package's (f32 on both sides, only the order of sums differs; the
fault plans fire on the same call indices, so both take the same
skips and rollbacks); the port against itself (steps_per_dispatch,
recovery armed but never firing) bit for bit.  bf16 compute through the
entry points within the JAX-gap bound of tests/test_torch_byte_diet.py.
"""

import glob
import json
import os
import shlex
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import WORDS, abstract, article, make_hps, numpy_params
from textsummarization_on_flink_tpu import cli as jax_cli
from textsummarization_on_flink_tpu import obs as jax_obs
from textsummarization_on_flink_tpu.checkpoint import checkpointer as jckpt
from textsummarization_on_flink_tpu.resilience import faultinject as jfault
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch import cli, obs
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data import batching, chunks
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.params import tree_leaves
from textsummarization_on_flink_tpu_torch.resilience import faultinject
from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib

from test_torch_byte_diet import BF16_GAP_FACTOR

VSIZE = len(WORDS) + 4
TINY_WORDS = ["a", "b", "c", "d", "e", "f", "."]


@pytest.fixture(autouse=True)
def _isolated_registries():
    """A fresh registry in both packages, and no fault plan left behind."""
    with obs.use_registry(obs.Registry()) as reg, \
            jax_obs.use_registry(jax_obs.Registry()) as jreg:
        yield reg, jreg
    faultinject.set_default_plan(None)
    jfault.set_default_plan(None)


def hps_tiny(**kw):
    """The JAX chaos tests' tiny model (tests/test_chaos.py:59-65)."""
    base = dict(batch_size=2, max_enc_steps=6, max_dec_steps=5,
                min_dec_steps=1, hidden_dim=4, emb_dim=3, max_oov_buckets=2,
                vocab_size=0, lr=0.15, adagrad_init_acc=0.1,
                max_grad_norm=2.0, device="cpu")
    base.update(kw)
    return HParams(**base)


class FixedBatcher:
    """The same batch ``n`` times, then None."""

    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def next_batch(self):
        if self.n <= 0:
            return None
        self.n -= 1
        return self.batch


class ArraysBatch:
    """A batch both packages' trainers take: they read as_arrays() only."""

    def __init__(self, arrays):
        self.arrays = arrays

    def as_arrays(self):
        return self.arrays


class ListBatcher:
    def __init__(self, batches):
        self.batches = list(batches)

    def next_batch(self):
        return self.batches.pop(0) if self.batches else None


def tiny_batch(hps):
    vocab = Vocab(words=TINY_WORDS)
    exs = [batching.SummaryExample.build("a b c d", ["b c ."], vocab, hps),
           batching.SummaryExample.build("c d e f", ["d e ."], vocab, hps)]
    return batching.Batch(exs, hps, vocab), vocab.size()


def batch_arrays(thps, seed):
    rng = np.random.RandomState(seed)
    vocab = Vocab(words=WORDS)
    exs = []
    for i in range(thps.batch_size):
        art = article(seed * 7 + i, n_words=int(rng.randint(8, 30))).split()
        abs_ = [art[j] for j in rng.randint(0, len(art), rng.randint(3, 13))]
        exs.append(batching.SummaryExample.build(
            " ".join(art), [" ".join(abs_)], vocab, thps))
    return batching.Batch(exs, thps, vocab).as_arrays()


def _leaves_close(got, want, tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert float(np.max(np.abs(g - w))) <= \
            tol * max(1.0, float(np.max(np.abs(w))))


def _np_leaves(tree):
    return [x.detach().float().numpy() for x in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# divergence recovery
# ---------------------------------------------------------------------------

def test_injected_nan_skips_then_rolls_back_then_completes(
        tmp_path, _isolated_registries):
    """train.step_nan injected 3 times at p=1.0 (JAX
    tests/test_chaos.py:85-112): the trainer burns its 2-skip budget,
    rolls back once with an LR cut, and completes its 6 steps."""
    reg, _ = _isolated_registries
    hps = hps_tiny(log_root=str(tmp_path), exp_name="t", nan_skip_steps=2,
                   nan_max_rollbacks=1, faults="train.step_nan:1.0:7:3")
    batch, vsize = tiny_batch(hps)
    ck = ckpt_lib.Checkpointer(str(tmp_path / "ckpt"), hps=hps)
    tr = trainer_lib.Trainer(hps, vsize, FixedBatcher(batch, 30),
                             checkpointer=ck, checkpoint_secs=1e9)
    state = tr.train(num_steps=6)
    assert state.step == 6
    assert reg.counter("resilience/train/nan_skips_total").value == 2
    assert reg.counter("resilience/train/rollbacks_total").value == 1
    assert reg.counter("train/nan_watchdog_total").value == 3
    assert reg.gauge("resilience/train/lr_scale").value == 0.5
    assert tr._faults.stats()["train.step_nan"]["fires"] == 3
    assert tr._step_hps.lr == pytest.approx(0.075)  # the cut, from then on


def test_budgets_exhausted_raises_nan_loss_error(tmp_path):
    hps = hps_tiny(log_root=str(tmp_path), exp_name="t", nan_skip_steps=1,
                   nan_max_rollbacks=1, faults="train.step_nan:1.0:7")
    batch, vsize = tiny_batch(hps)
    tr = trainer_lib.Trainer(hps, vsize, FixedBatcher(batch, 30))
    with pytest.raises(trainer_lib.NanLossError, match="exhausted"):
        tr.train(num_steps=6)


def test_unarmed_injection_keeps_hard_abort(tmp_path):
    """Both budgets 0 (the defaults): the reference's fail-fast watchdog
    holds, an injected divergence aborts the run."""
    hps = hps_tiny(log_root=str(tmp_path), exp_name="t",
                   faults="train.step_nan:1.0:7:1")
    batch, vsize = tiny_batch(hps)
    tr = trainer_lib.Trainer(hps, vsize, FixedBatcher(batch, 10))
    with pytest.raises(trainer_lib.NonFiniteLossError, match="injected"):
        tr.train(num_steps=4)


def test_a_real_nan_is_skipped_and_the_pre_step_state_kept(tmp_path):
    """Armed recovery updates out of place: a dispatch whose loss is not
    finite leaves the params and accumulators as they were."""
    hps = hps_tiny(log_root=str(tmp_path), exp_name="t", nan_skip_steps=1,
                   lr=1e6)
    batch, vsize = tiny_batch(hps)
    tr = trainer_lib.Trainer(hps, vsize, FixedBatcher(batch, 40))
    with pytest.raises(trainer_lib.NanLossError):
        tr.train(num_steps=30)
    assert all(np.isfinite(x).all() for x in _np_leaves(tr.state.params))


def test_armed_recovery_that_never_fires_changes_nothing(tmp_path):
    """Out-of-place updates give the in-place updates' bits: a run armed
    for recovery with no fault ends with the unarmed run's params."""
    _, thps = make_hps(mode="train", max_oov_buckets=8, coverage=True)
    p = numpy_params(thps, VSIZE, 2)
    batches = [batch_arrays(thps, s) for s in range(4)]
    out = []
    for armed in (0, 2):
        h = thps.replace(nan_skip_steps=armed, log_root=str(tmp_path / f"{armed}"))
        tr = trainer_lib.Trainer(
            h, VSIZE, ListBatcher(ArraysBatch(a) for a in batches),
            state=trainer_lib.init_train_state(h, VSIZE, params=p))
        out.append(_np_leaves(tr.train(num_steps=4).params))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec,skips,rollbacks,ckpt_steps", [
    ("train.step_nan:0.35:5", 2, 2, 3),
    ("train.step_nan:1.0:7:3", 2, 1, 0),
    ("train.step_nan:0.5:11", 3, 1, 2),
])
def test_recovery_matches_the_jax_trainer(tmp_path, _isolated_registries,
                                          spec, skips, rollbacks, ckpt_steps):
    """One fault spec, one params tree, one batch sequence through both
    trainers: the plan fires on the same call indices in both packages
    (its seeded random.Random per point), both take the same skips and
    rollbacks (from checkpoints every ``ckpt_steps`` steps, or from the
    initial snapshot), and the final params and accumulators agree
    within 1e-5."""
    reg, jreg = _isolated_registries
    jhps, thps = make_hps(mode="train", max_oov_buckets=8, coverage=True,
                          faults=spec, nan_skip_steps=skips,
                          nan_max_rollbacks=rollbacks,
                          checkpoint_steps=ckpt_steps)
    p = numpy_params(thps, VSIZE, 2)
    batches = [batch_arrays(thps, s) for s in range(14)]
    jtr = jtrainer.Trainer(
        jhps.replace(log_root=str(tmp_path / "j")), VSIZE,
        ListBatcher(ArraysBatch(a) for a in batches),
        state=jtrainer.init_train_state(
            jhps, VSIZE, params=jax.tree_util.tree_map(jnp.asarray, p)),
        checkpointer=jckpt.Checkpointer(str(tmp_path / "j" / "ck"),
                                        hps=jhps),
        checkpoint_secs=1e9, train_dir=str(tmp_path / "j" / "train"))
    tr = trainer_lib.Trainer(
        thps.replace(log_root=str(tmp_path / "t")), VSIZE,
        ListBatcher(ArraysBatch(a) for a in batches),
        state=trainer_lib.init_train_state(thps, VSIZE, params=p),
        checkpointer=ckpt_lib.Checkpointer(str(tmp_path / "t" / "ck"),
                                           hps=thps),
        checkpoint_secs=1e9, train_dir=str(tmp_path / "t" / "train"))
    outcome = []
    for t_ in (jtr, tr):
        try:
            s = t_.train(num_steps=8)
            outcome.append(("done", int(np.asarray(s.step))))
        except jtrainer.NanLossError:
            outcome.append(("raised", None))
        except trainer_lib.NanLossError:
            outcome.append(("raised", None))
    assert outcome[0] == outcome[1]
    assert tr._faults.stats() == jtr._faults.stats()
    for name in ("resilience/train/nan_skips_total",
                 "resilience/train/rollbacks_total",
                 "train/nan_watchdog_total"):
        assert reg.counter(name).value == jreg.counter(name).value, name
    assert reg.gauge("resilience/train/lr_scale").value == \
        jreg.gauge("resilience/train/lr_scale").value
    _leaves_close(_np_leaves(tr.state.params),
                  jax.tree_util.tree_leaves(jtr.state.params))
    _leaves_close(_np_leaves(tr.state.opt_state.accumulators),
                  jax.tree_util.tree_leaves(jtr.state.opt_state.accumulators))


def test_ckpt_load_fault_falls_back_to_the_older_checkpoint(
        tmp_path, _isolated_registries):
    """ckpt.load fires on the newest checkpoint once: restore falls back
    to the next-older one (resilience/ckpt_fallbacks_total), as the JAX
    package's does on the same spec."""
    reg, jreg = _isolated_registries
    jhps, thps = make_hps(mode="train", max_oov_buckets=8,
                          faults="ckpt.load:1.0:0:1")
    p = numpy_params(thps, VSIZE, 2)
    state = trainer_lib.init_train_state(thps, VSIZE, params=p)
    ck = ckpt_lib.Checkpointer(str(tmp_path), hps=thps)
    for step in (3, 5):
        ck.save(state._replace(step=step))
    assert ck.restore().step == 3
    assert reg.counter("resilience/ckpt_fallbacks_total").value == 1
    assert ck.restore().step == 5  # the budget of one fire is spent
    jck = jckpt.Checkpointer(str(tmp_path), hps=jhps)
    assert int(jck.restore().step) == 3
    assert jreg.counter("resilience/ckpt_fallbacks_total").value == 1


# ---------------------------------------------------------------------------
# the trainer loop: dispatches, windows, the prefetcher, the profiler
# ---------------------------------------------------------------------------

def test_steps_per_dispatch_matches_one_step_dispatches(tmp_path):
    """steps_per_dispatch=3: 6 steps in 2 dispatches give the params of 6
    dispatches of one step, bit for bit (the same operations in the same
    order), and one summary record per step."""
    _, thps = make_hps(mode="train", max_oov_buckets=8, coverage=True)
    p = numpy_params(thps, VSIZE, 2)
    batches = [batch_arrays(thps, s) for s in range(6)]
    out = []
    for k in (1, 3):
        h = thps.replace(steps_per_dispatch=k, log_root=str(tmp_path / f"k{k}"))
        tr = trainer_lib.Trainer(
            h, VSIZE, ListBatcher(ArraysBatch(a) for a in batches),
            state=trainer_lib.init_train_state(h, VSIZE, params=p))
        assert tr.steps_per_dispatch == k
        out.append(_np_leaves(tr.train(num_steps=6).params))
        recs = [json.loads(x) for x in
                open(os.path.join(tr.train_dir, "events.jsonl"))]
        assert [r["step"] for r in recs] == list(range(1, 7))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_the_trainer_counts_the_batches_and_target_tokens_it_takes(
        tmp_path):
    """train/batches_total and train/target_tokens_total count the
    batches the loop took and the target tokens in them (the sum of their
    dec_padding_mask), at one step per dispatch and at three (a dispatch
    of 3, then one clipped to the 2 steps left)."""
    _, thps = make_hps(mode="train", max_oov_buckets=8, coverage=True)
    batches = [batch_arrays(thps, s) for s in range(6)]
    want = sum(float(a["dec_padding_mask"].sum()) for a in batches[:5])
    for k in (1, 3):
        h = thps.replace(steps_per_dispatch=k,
                         log_root=str(tmp_path / f"k{k}"))
        with obs.use_registry(obs.Registry()) as reg:
            tr = trainer_lib.Trainer(
                h, VSIZE, ListBatcher(ArraysBatch(a) for a in batches),
                state=trainer_lib.init_train_state(h, VSIZE))
            tr.train(num_steps=5)
        assert reg.counter("train/batches_total").value == 5
        assert reg.counter("train/target_tokens_total").value == want


def test_debug_forces_one_step_per_dispatch():
    hps = hps_tiny(steps_per_dispatch=8, debug=True)
    batch, vsize = tiny_batch(hps)
    tr = trainer_lib.Trainer(hps, vsize, FixedBatcher(batch, 2))
    assert tr.steps_per_dispatch == 1
    assert tr.metrics_every == 1
    assert trainer_lib.Trainer(hps.replace(debug=False), vsize,
                               None).metrics_every == 10


def test_watchdog_fires_inside_a_window(tmp_path):
    """NaN params, 4 steps per dispatch, metrics every 4: the watchdog
    reads the window and raises, saying detection is windowed (JAX
    tests/test_training.py:370)."""
    hps = hps_tiny(log_root=str(tmp_path), exp_name="nan",
                   steps_per_dispatch=4)
    batch, vsize = tiny_batch(hps)
    tr = trainer_lib.Trainer(hps, vsize, FixedBatcher(batch, 20),
                             metrics_every=4)
    with torch.no_grad():
        for x in tree_leaves(tr.state.params):
            x.fill_(float("nan"))
    with pytest.raises(trainer_lib.NonFiniteLossError, match="windowed"):
        tr.train(num_steps=12)


def test_nan_watchdog_debug_dumps_batch(tmp_path):
    """--debug pins the window to one step and dumps the offending batch
    (JAX tests/test_training.py:202)."""
    hps = hps_tiny(log_root=str(tmp_path), exp_name="t", lr=1e6, debug=True)
    batch, vsize = tiny_batch(hps)
    tr = trainer_lib.Trainer(hps, vsize, FixedBatcher(batch, 50))
    with pytest.raises(trainer_lib.NonFiniteLossError):
        tr.train()
    dumps = glob.glob(os.path.join(tr.train_dir, "nan_batch_step*.npz"))
    assert len(dumps) == 1
    assert set(np.load(dumps[0]).files) == set(batch.as_arrays())


def test_prefetcher_keeps_order_and_stops():
    """The batcher's batches, in order, then None; stop() joins the
    thread."""
    batches = [ArraysBatch({"x": np.full((2,), i, np.float32)})
               for i in range(5)]
    pf = trainer_lib.DevicePrefetcher(
        ListBatcher(batches), trainer_lib.make_transfer(torch.device("cpu")))
    got = []
    while True:
        item = pf.next_batch()
        if item is None:
            break
        b, arrays = item
        assert isinstance(arrays["x"], torch.Tensor)
        got.append((b, float(arrays["x"][0])))
    assert got == [(b, float(i)) for i, b in enumerate(batches)]
    pf.stop()
    assert not pf._thread.is_alive()


def test_prefetcher_under_thread_switch_stress():
    """One producer thread, the consumer here, a switch interval of 1 µs:
    every batch arrives once and in order (a lost or doubled hand-off
    would break the sequence), the count matches the counter, and the
    thread is gone after stop()."""
    import sys
    import time

    n = 2000
    batches = [ArraysBatch({"x": np.full((1,), i, np.float32)})
               for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.use_registry(obs.Registry()) as reg:
            pf = trainer_lib.DevicePrefetcher(
                ListBatcher(batches),
                trainer_lib.make_transfer(torch.device("cpu")), depth=3)
            got, t0 = [], time.monotonic()
            while time.monotonic() - t0 < 60:
                item = pf.next_batch()
                if item is None:
                    break
                got.append(int(item[1]["x"][0]))
            pf.stop()
            assert reg.counter("train/prefetch_batches_total").value == n
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(n))
    assert not pf._thread.is_alive()


def test_prefetcher_surfaces_a_batcher_failure(_isolated_registries):
    """A batcher that raises: the consumer gets PrefetchError chained to
    the cause (never a hang), counted in train/prefetch_errors_total."""
    reg, _ = _isolated_registries

    class Failing:
        def __init__(self):
            self.calls = 0

        def next_batch(self):
            self.calls += 1
            if self.calls > 2:
                raise OSError("disk gone")
            return ArraysBatch({"x": np.zeros(1, np.float32)})

    pf = trainer_lib.DevicePrefetcher(
        Failing(), trainer_lib.make_transfer(torch.device("cpu")))
    assert pf.next_batch() is not None
    assert pf.next_batch() is not None
    with pytest.raises(trainer_lib.PrefetchError) as e:
        pf.next_batch()
    assert isinstance(e.value.__cause__, OSError)
    assert reg.counter("train/prefetch_errors_total").value == 1
    pf.stop()


@pytest.mark.parametrize("where", ["batcher", "transfer"])
def test_trainer_loop_surfaces_prefetch_error(tmp_path, where):
    """A failure of the batcher, or of a batch's transfer to the device,
    in the prefetcher's thread reaches Trainer.train as PrefetchError (a
    RuntimeError, so handlers of the JAX package's hierarchy catch it;
    JAX tests/test_obs_integration.py:208-230)."""
    assert issubclass(trainer_lib.PrefetchError, RuntimeError)
    hps = hps_tiny(log_root=str(tmp_path), exp_name="x")

    class Boom:
        def next_batch(self):
            if where == "batcher":
                raise ValueError("stream corrupted")
            return ArraysBatch({"enc_batch": object()})  # not an array

    tr = trainer_lib.Trainer(hps, len(TINY_WORDS) + 4, Boom())
    with pytest.raises(trainer_lib.PrefetchError) as e:
        tr.train(num_steps=3)
    assert isinstance(e.value.__cause__, (ValueError, TypeError))


def test_prefetcher_stop_leaves_an_endless_batcher(tmp_path):
    """A limit reached before the batcher ends: train returns and the
    prefetcher's thread is gone."""
    hps = hps_tiny(log_root=str(tmp_path), exp_name="t")
    batch, vsize = tiny_batch(hps)
    tr = trainer_lib.Trainer(hps, vsize, FixedBatcher(batch, 10**6))
    tr.train(num_steps=3)
    assert not [t for t in threading.enumerate()
                if t.name == "device-prefetcher" and t.is_alive()]


@pytest.mark.parametrize("via", ["hparam", "env"])
def test_profile_dir_writes_a_trace(tmp_path, monkeypatch, via):
    """profile_dir (or the TS_PROFILE_DIR fallback) traces steps 2-7 of
    the run with torch.profiler and writes one Chrome trace (JAX
    tests/test_training.py:202)."""
    prof = tmp_path / "prof"
    kw = {}
    if via == "env":
        monkeypatch.setenv("TS_PROFILE_DIR", str(prof))
    else:
        kw["profile_dir"] = str(prof)
    hps = hps_tiny(**kw)
    batch, vsize = tiny_batch(hps)
    tr = trainer_lib.Trainer(hps, vsize, FixedBatcher(batch, 12),
                             train_dir=str(tmp_path / "train"),
                             metrics_every=3)
    tr.train(num_steps=10)
    traces = list(prof.glob("*.json"))
    assert [x.name for x in traces] == ["train_steps_2-7.pt.trace.json"]
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


# ---------------------------------------------------------------------------
# through the entry points, against the JAX package
# ---------------------------------------------------------------------------

ENTRY_FLAGS = {
    "loss_chunk": dict(loss_chunk=3),
    "loss_chunk_transformer": dict(loss_chunk=4, model_family="transformer",
                                   hidden_dim=16, num_heads=2, enc_layers=2,
                                   dec_layers=2),
    "remat": dict(remat=True),
    "remat_transformer": dict(remat=True, model_family="transformer",
                              hidden_dim=16, num_heads=2, enc_layers=2,
                              dec_layers=2),
    "bf16": dict(compute_dtype="bfloat16", loss_chunk=3),
    "long_run": dict(opt_state_dtype="bfloat16", steps_per_dispatch=2,
                     metrics_every=3),
    # f32 state: after a rollback to a checkpoint (f32 on disk) the JAX
    # package goes on with f32 accumulators, where the port narrows them
    # to --opt_state_dtype again, as it does on every restore
    "recovery": dict(steps_per_dispatch=2, nan_skip_steps=1,
                     nan_max_rollbacks=1, faults="train.step_nan:1.0:3:2"),
}


def _write_data(root):
    chunks.write_chunk_file(
        os.path.join(root, "train_000.bin"),
        [{"article": [article(i)], "abstract": [abstract(i)]}
         for i in range(8)])
    with open(os.path.join(root, "vocab"), "w") as f:
        f.write("".join(f"{w} {100 - i}\n" for i, w in enumerate(WORDS)))


def _initial_checkpoint(train_dir, thps):
    """model.ckpt-0 with fresh accumulators, read by both packages."""
    state = trainer_lib.make_train_state(
        numpy_params(thps, VSIZE, 4), None, 0, "cpu",
        init_acc=thps.adagrad_init_acc)
    ckpt_lib.Checkpointer(train_dir).save(state)


def _final(train_dir):
    flat = ckpt_lib.load_arrays(ckpt_lib.latest_checkpoint(train_dir))
    return {k: v for k, v in flat.items() if k != "step"}, int(flat["step"])


def _compare(name, port, jax_flat, jax_f32=None):
    (got, g_step), (want, w_step) = port, jax_flat
    assert g_step == w_step
    assert sorted(got) == sorted(want)
    for k in want:
        if jax_f32 is None:
            _leaves_close([got[k]], [want[k]])
        else:  # bf16: the JAX package's own f32-to-bf16 distance
            gap = float(np.max(np.abs(want[k] - jax_f32[0][k])))
            assert float(np.max(np.abs(got[k] - want[k]))) <= \
                BF16_GAP_FACTOR * gap + 1e-5 * max(
                    1.0, float(np.max(np.abs(want[k])))), (name, k)


@pytest.mark.parametrize("name", sorted(ENTRY_FLAGS))
def test_cli_train_with_the_new_flags_matches_jax(tmp_path, name):
    """cli.main --mode=train (single pass over one chunk file, 3 steps)
    in both packages from one initial checkpoint: the final checkpoint's
    params and accumulators agree within 1e-5 (f32), or within the
    JAX-gap bound (bf16 compute)."""
    _write_data(str(tmp_path))
    flags = dict(mode="train", num_steps=3, single_pass=1, coverage=1,
                 data_path=str(tmp_path / "train_*.bin"),
                 vocab_path=str(tmp_path / "vocab"), batch_size=2,
                 hidden_dim=16, emb_dim=8, max_enc_steps=24,
                 max_dec_steps=10, min_dec_steps=3, vocab_size=VSIZE,
                 max_oov_buckets=6)
    flags.update(ENTRY_FLAGS[name])
    runs = {}
    dtypes = (["float32", "bfloat16"] if name == "bf16" else [None])
    for pkg in ("jax", "port"):
        for dt in dtypes:
            root = tmp_path / f"{pkg}_{dt}"
            f = dict(flags, log_root=str(root), exp_name="exp")
            if dt:
                f["compute_dtype"] = dt
            argv = [f"--{k}={v}" for k, v in f.items()]
            if pkg == "port":
                argv.append("--device=cpu")
            thps = HParams.from_argv(argv)
            train_dir = os.path.join(str(root), "exp", "train")
            _initial_checkpoint(train_dir, thps)
            rc = (cli.main(argv) if pkg == "port"
                  else jax_cli.main(argv))
            assert rc in (0, None)
            runs[(pkg, dt)] = _final(train_dir)
    if name == "bf16":
        _compare(name, runs[("port", "bfloat16")], runs[("jax", "bfloat16")],
                 runs[("jax", "float32")])
    else:
        _compare(name, runs[("port", None)], runs[("jax", None)])


@pytest.mark.parametrize("name", ["loss_chunk", "remat_transformer", "bf16",
                                  "long_run", "recovery"])
def test_pipeline_fit_with_the_new_flags_matches_jax(tmp_path, name):
    """SummarizationEstimator.fit in both packages (the JAX package's
    pipeline widths, 2 steps) with the new flags in its hyperparameter
    string (set_train_hyper_params), from one initial checkpoint: the
    params and accumulators within 1e-5 (f32) or the JAX-gap bound
    (bf16)."""
    import test_torch_pipeline as tp

    extra = dict(ENTRY_FLAGS[name])
    if extra.get("model_family") == "transformer":
        extra.update(hidden_dim=8, num_heads=2)
    dtypes = ["float32", "bfloat16"] if name == "bf16" else [None]
    runs = {}
    for pkg in ("jax", "port"):
        for dt in dtypes:
            root = tmp_path / f"{pkg}_{dt}"
            kw = dict(extra)
            if dt:
                kw["compute_dtype"] = dt
            thps = tp.hps("port", root, "train", **kw)
            train_dir = os.path.join(str(root), "exp", "train")
            state = trainer_lib.make_train_state(
                tp.initial_params() if "model_family" not in kw else
                numpy_params(thps, tp.VSIZE, 4), None, 0, "cpu",
                init_acc=thps.adagrad_init_acc)
            ckpt_lib.Checkpointer(train_dir).save(state)
            e = tp.make_estimator(pkg, root)
            e.set_train_hyper_params(shlex.split(
                tp.hps(pkg, root, "train", **kw).to_argv()))
            e.fit(tp.PKGS[pkg].io.CollectionSource(tp.rows()))
            runs[(pkg, dt)] = _final(train_dir)
    if name == "bf16":
        _compare(name, runs[("port", "bfloat16")], runs[("jax", "bfloat16")],
                 runs[("jax", "float32")])
    else:
        _compare(name, runs[("port", None)], runs[("jax", None)])
