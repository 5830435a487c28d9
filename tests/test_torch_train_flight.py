"""The port's trainer in the flight recorder and the profiler, against the
JAX trainer on the CPU: the ``train_step`` frames and the ``train_nan``
and ``nan_rollback`` dumps, the phase ledger's train phases and
``train/round`` walls, the ``profiler_capture`` note, the
``train/host_wait_seconds`` histogram, the analytic price of the step
dispatch, and a dark registry that records nothing.

Mirrors the JAX package's tests/test_chaos.py:807-850 (the injected NaN
dumps the frames before it) and :85-112 (the skip-then-rollback ladder),
tests/test_obs_integration.py:82 (host wait) and :88-100 (a dark run).

Sizes: the JAX chaos tests' tiny model (hidden 4, embedding 3, 6/5
steps, batch 2), both trainers from one numpy params tree.

Tolerances: file names, header contexts, frame steps and frame fields
exactly equal; the frames' losses and global norms within 1e-4 relative
(f32 on both sides, only the order of sums differs); a frame's step
time and prefetch depth are the run's own host measurements and are
compared by field name only."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import numpy_params
from textsummarization_on_flink_tpu import obs as jax_obs
from textsummarization_on_flink_tpu.checkpoint import checkpointer as jckpt
from textsummarization_on_flink_tpu.config import HParams as JaxHParams
from textsummarization_on_flink_tpu.data import batching as jbatching
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.obs import profile as jax_profile
from textsummarization_on_flink_tpu.resilience import faultinject as jfault
from textsummarization_on_flink_tpu.train import trainer as jtrainer
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.obs import cost
from textsummarization_on_flink_tpu_torch.obs import profile
from textsummarization_on_flink_tpu_torch.resilience import faultinject
from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib

TINY_WORDS = ["a", "b", "c", "d", "e", "f", "."]
#: tests/test_chaos.py's fault: p=0.35 with seed 5 first fires on the
#: 7th call, so a ring of 4 is full of frames before the trigger
FAULT_PROB, FAULT_SEED = 0.35, 5
TRAIN_PHASES = ("train/host_wait", "train/step_dispatch",
                "train/metrics_flush")


@pytest.fixture(autouse=True)
def _registries():
    """A fresh registry in both packages, and no fault plan left behind."""
    with obs.use_registry(obs.Registry()) as reg, \
            jax_obs.use_registry(jax_obs.Registry()) as jreg:
        yield reg, jreg
    faultinject.set_default_plan(None)
    jfault.set_default_plan(None)


def tiny(**kw):
    """(JAX HParams, port HParams) of the JAX chaos tests' tiny model."""
    base = dict(batch_size=2, max_enc_steps=6, max_dec_steps=5,
                min_dec_steps=1, hidden_dim=4, emb_dim=3, max_oov_buckets=2,
                vocab_size=0, lr=0.15, adagrad_init_acc=0.1,
                max_grad_norm=2.0)
    base.update(kw)
    return JaxHParams(**base), HParams(device="cpu", **base)


class FixedBatcher:
    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def next_batch(self):
        if self.n <= 0:
            return None
        self.n -= 1
        return self.batch


def trainers(tmp_path, jhps, thps, n_batches=30, ckpt=False):
    """Both trainers on one params tree, each over its own package's
    batch of the same two articles, in train dirs of their own."""
    jv, tv = JaxVocab(words=TINY_WORDS), Vocab(words=TINY_WORDS)
    texts = [("a b c d", "b c ."), ("c d e f", "d e .")]
    jb = jbatching.Batch([jbatching.SummaryExample.build(a, [s], jv, jhps)
                          for a, s in texts], jhps, jv)
    tb = batching.Batch([batching.SummaryExample.build(a, [s], tv, thps)
                         for a, s in texts], thps, tv)
    vsize = tv.size()
    p = numpy_params(thps, vsize, 3)
    out = []
    for name, lib, hps, batch, state in (
            ("j", jtrainer, jhps, jb, jtrainer.init_train_state(
                jhps, vsize,
                params=jax.tree_util.tree_map(jnp.asarray, p))),
            ("t", trainer_lib, thps, tb, trainer_lib.init_train_state(
                thps, vsize, params=p))):
        kw = {}
        if ckpt:
            ck = (jckpt if lib is jtrainer else ckpt_lib).Checkpointer(
                str(tmp_path / name / "ck"), hps=hps)
            kw = dict(checkpointer=ck, checkpoint_secs=1e9)
        out.append(lib.Trainer(
            hps.replace(log_root=str(tmp_path / name)), vsize,
            FixedBatcher(batch, n_batches), state=state,
            train_dir=str(tmp_path / name / "train"), **kw))
    return out


def dumps(train_dir):
    """{file name: [header, frames...]} of a train dir's flight dumps."""
    return {f: [json.loads(ln) for ln in open(os.path.join(train_dir, f),
                                              encoding="utf-8")]
            for f in sorted(os.listdir(train_dir))
            if f.startswith("flight_")}


def assert_same_dumps(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        (gh, *gf), (wh, *wf) = got[name], want[name]
        for k in ("kind", "reason", "dump", "frames", "capacity"):
            assert gh[k] == wh[k], (name, k)
        assert gh.get("context") == wh.get("context"), name
        assert [f["step"] for f in gf] == [f["step"] for f in wf], name
        assert [sorted(f) for f in gf] == [sorted(f) for f in wf], name
        for g, w in zip(gf, wf):
            assert g["kind"] == w["kind"] == "train_step"
            np.testing.assert_allclose(
                [g["loss"], g["global_norm"]], [w["loss"], w["global_norm"]],
                rtol=1e-4)


def phase_counts(payload):
    return ({p["phase"]: p["count"] for p in payload["phases"]},
            {w["wall"]: w["count"] for w in payload["walls"]})


def test_injected_train_nan_dumps_the_jax_frames(tmp_path, _registries):
    """tests/test_chaos.py:824-850 in both packages: six clean steps
    frame the ring; the injected NaN at step 6 dumps the newest 4 of them
    to flight_train_nan.jsonl with the context {step: 6, injected: True};
    both dump the same file, header and frames, and book the same phases
    and walls."""
    reg, jreg = _registries
    jhps, thps = tiny(metrics_every=1, flight_frames=4,
                      faults=f"train.step_nan:{FAULT_PROB}:{FAULT_SEED}:1")
    jtr, tr = trainers(tmp_path, jhps, thps)
    with pytest.raises(jtrainer.NonFiniteLossError, match="injected"):
        jtr.train(num_steps=12)
    with pytest.raises(trainer_lib.NonFiniteLossError, match="injected"):
        tr.train(num_steps=12)
    got, want = dumps(tr.train_dir), dumps(jtr.train_dir)
    assert sorted(got) == ["flight_train_nan.jsonl"]
    assert_same_dumps(got, want)
    header, *frames = got["flight_train_nan.jsonl"]
    assert header["context"] == {"step": 6, "injected": True}
    assert [f["step"] for f in frames] == [2, 3, 4, 5]
    # the same phases, counts and walls: 7 rounds took a batch and
    # dispatched, 6 flushed and closed their wall
    assert phase_counts(profile.profile_payload(reg)) == phase_counts(
        jax_profile.profile_payload(jreg))
    phases, walls = phase_counts(profile.profile_payload(reg))
    assert phases == {"train/host_wait": 7, "train/step_dispatch": 7,
                      "train/metrics_flush": 6}
    assert walls == {"train/round": 6}
    # tests/test_obs_integration.py:82: one host-wait sample per round
    assert reg.histogram("train/host_wait_seconds").count == \
        jreg.histogram("train/host_wait_seconds").count == 7


def test_rollback_dumps_and_checkpoint_phase_match_jax(tmp_path, _registries):
    """The skip-then-rollback ladder (tests/test_chaos.py:85-112) with a
    ring of 4 and a checkpoint every 2 steps: three train_nan dumps
    (injected=True), one nan_rollback dump with rollbacks_left 0, the
    same files, headers and frames as the JAX trainer's, and the same
    phases, train/checkpoint among them."""
    reg, jreg = _registries
    jhps, thps = tiny(flight_frames=4, nan_skip_steps=2, nan_max_rollbacks=1,
                      checkpoint_steps=2, faults="train.step_nan:1.0:7:3")
    jtr, tr = trainers(tmp_path, jhps, thps, ckpt=True)
    assert int(np.asarray(jtr.train(num_steps=6).step)) == 6
    assert tr.train(num_steps=6).step == 6
    got, want = dumps(tr.train_dir), dumps(jtr.train_dir)
    assert sorted(got) == ["flight_nan_rollback.jsonl",
                           "flight_train_nan-2.jsonl",
                           "flight_train_nan-3.jsonl",
                           "flight_train_nan.jsonl"]
    assert_same_dumps(got, want)
    rollback = got["flight_nan_rollback.jsonl"][0]["context"]
    assert rollback["rollbacks_left"] == 0
    assert got["flight_train_nan.jsonl"][0]["context"]["injected"] is True
    g, w = (phase_counts(profile.profile_payload(r)) for r in (reg, jreg))
    assert g == w
    assert set(g[0]) == set(TRAIN_PHASES) | {"train/checkpoint"}
    assert g[1]["train/round"] > 0


def test_profiler_capture_note_and_round_walls(tmp_path, _registries):
    """--profile_dir: the capture's opening edge is a profiler_capture
    note with the JAX trainer's fields (dir, start_step 2, stop_step 7),
    also framed in the flight ring; every completed round closes a
    train/round wall, and the phases sum to at most the walls."""
    reg, _ = _registries
    _, thps = tiny(metrics_every=1, flight_frames=64,
                   profile_dir=str(tmp_path / "prof"))
    _, tr = trainers(tmp_path, thps, thps)
    tr.train(num_steps=9)
    body = profile.profile_payload(reg)
    notes = body["notes"]
    assert [(n["note"], n["dir"], n["start_step"], n["stop_step"])
            for n in notes] == [("profiler_capture", str(tmp_path / "prof"),
                                 2, 7)]
    assert any(f["kind"] == "profile_note" for f in reg.flight.frames())
    walls = {w["wall"]: w["count"] for w in body["walls"]}
    assert walls == {"train/round": 9}
    assert 0.0 < body["coverage"] <= 1.0
    assert reg.histogram("train/host_wait_seconds").count == 9


def test_analytic_price_of_the_step_dispatch(tmp_path, _registries):
    """--profile_analytic: train/step_dispatch / "step" is priced by
    obs/cost.py (steps_per_dispatch steps a dispatch), and each
    dispatch publishes the achieved rates against it."""
    reg, _ = _registries
    _, thps = tiny(metrics_every=2, steps_per_dispatch=2,
                   profile_analytic=True)
    _, tr = trainers(tmp_path, thps, thps, n_batches=40)
    tr.train(num_steps=20)
    rows = {(r["site"], r["key"]): r
            for r in profile.profile_payload(reg)["divergence"]}
    row = rows[("train/step_dispatch", "step")]
    want = cost.train_step_cost(thps, steps=2)
    assert (row["flops"], row["bytes"]) == (want["flops"], want["bytes"])
    assert row["samples"] >= 1
    snap = reg.snapshot()
    assert "profile/achieved_flops_per_second" in snap
    assert "profile/achieved_bytes_per_second" in snap


def test_a_dark_run_records_nothing(tmp_path, _registries):
    """obs=False (tests/test_obs_integration.py:88-100): no flight dump
    even on the injected NaN, no profiler, nothing in the registry."""
    reg, _ = _registries
    _, thps = tiny(obs=False, metrics_every=1, flight_frames=4,
                   profile_analytic=True,
                   faults=f"train.step_nan:{FAULT_PROB}:{FAULT_SEED}:1")
    _, tr = trainers(tmp_path, thps, thps)
    assert tr._prof is profile.NULL_PROFILER
    with pytest.raises(trainer_lib.NonFiniteLossError, match="injected"):
        tr.train(num_steps=12)
    assert dumps(tr.train_dir) == {}
    assert not profile.profile_payload(reg)["installed"]
    assert reg.flight is None
