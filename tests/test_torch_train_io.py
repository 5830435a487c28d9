"""What training writes and reads, shared by the two packages: training
checkpoints (params, Adagrad accumulators, step) cross-load in both
directions with equal params fingerprints; retention and the best-model
track; chunk files written by either package read back identically in
the other; and the port's ``--mode=train`` / ``--mode=eval`` through
``cli.main`` on the CPU."""

import json
import struct

import jax
import numpy as np
import pytest
import torch

from _torch_parity import WORDS, abstract, article, make_hps, n
from textsummarization_on_flink_tpu.checkpoint import checkpointer as jax_ckpt
from textsummarization_on_flink_tpu.data import chunks as jax_chunks
from textsummarization_on_flink_tpu.data.tfexample import Example
from textsummarization_on_flink_tpu.train import trainer as jax_trainer
from textsummarization_on_flink_tpu_torch import cli
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import chunks
from textsummarization_on_flink_tpu_torch.params import (
    init_numpy_params,
    tree_leaves,
)
from textsummarization_on_flink_tpu_torch.train import trainer

VSIZE = len(WORDS) + 4
TF = dict(model_family="transformer", hidden_dim=32, num_heads=1,
          enc_layers=2, dec_layers=2, batch_size=2, mode="train")


def _port_state(thps, seed=4, step=7):
    """A port TrainState with accumulators that differ from their init."""
    state = trainer.init_train_state(thps, VSIZE, params=init_numpy_params(
        thps, VSIZE, seed))
    rng = np.random.RandomState(seed)
    for a in tree_leaves(state.opt_state.accumulators):
        a.add_(torch.from_numpy(rng.rand(*a.shape).astype(np.float32)))
    return state._replace(step=step)


def test_port_training_checkpoint_restores_in_jax(tmp_path):
    jhps, thps = make_hps(**TF)
    state = _port_state(thps)
    path = ckpt_lib.Checkpointer(str(tmp_path), hps=thps).save(state)
    assert path.endswith("model.ckpt-7.npz")
    flat = ckpt_lib.load_arrays(path)
    assert flat["step"].dtype == np.int32
    assert any(k.startswith("opt_state/accumulators/") for k in flat)
    jstate = jax_ckpt.Checkpointer(str(tmp_path), hps=jhps).restore()
    assert int(jstate.step) == 7
    for got, want in ((jstate.params, state.params),
                      (jstate.opt_state.accumulators,
                       state.opt_state.accumulators)):
        g = jax.tree_util.tree_leaves(got)
        w = tree_leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), n(b))
    assert jax_ckpt.content_fingerprint(jstate.params) == \
        ckpt_lib.content_fingerprint(state.params)
    assert json.loads((tmp_path / "hparams.json").read_text())[
        "model_family"] == "transformer"


def test_jax_training_checkpoint_restores_in_port(tmp_path):
    jhps, thps = make_hps(**TF)
    p = init_numpy_params(thps, VSIZE, 9)
    jstate = jax_trainer.init_train_state(jhps, VSIZE, params=p)
    jstate = jstate._replace(step=np.int32(12))
    jax_ckpt.Checkpointer(str(tmp_path), hps=jhps).save(jstate)
    state = ckpt_lib.Checkpointer(str(tmp_path)).restore()
    assert state.step == 12
    assert all(x.requires_grad for x in tree_leaves(state.params))
    for got, want in ((state.params, jstate.params),
                      (state.opt_state.accumulators,
                       jstate.opt_state.accumulators)):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(n(a), np.asarray(b))
    assert ckpt_lib.content_fingerprint(state.params) == \
        jax_ckpt.content_fingerprint(jstate.params)


def test_retention_keeps_three_and_restore_falls_back(tmp_path):
    _, thps = make_hps(**TF)
    state = _port_state(thps)
    ck = ckpt_lib.Checkpointer(str(tmp_path), hps=thps)
    for step in range(1, 6):
        ck.save(state._replace(step=step))
    names = sorted(p.name for p in tmp_path.glob("model.ckpt-*.npz"))
    assert names == ["model.ckpt-3.npz", "model.ckpt-4.npz",
                     "model.ckpt-5.npz"]
    assert not (tmp_path / "model.ckpt-1.npz.sum").exists()
    with open(tmp_path / "model.ckpt-5.npz", "r+b") as f:  # corrupt newest
        f.seek(100)
        f.write(b"\x00\xff\x00\xff")
    assert ck.restore().step == 4
    with pytest.raises(ckpt_lib.CheckpointCorruptError):
        ck.restore(str(tmp_path / "model.ckpt-5.npz"))


def test_best_model_saver_keeps_one_indexed_best(tmp_path):
    _, thps = make_hps(**TF)
    state = _port_state(thps)
    saver = ckpt_lib.BestModelSaver(str(tmp_path))
    saver(state.params, 3.5, 10)
    saver(state.params, 3.1, 20)
    assert sorted(p.name for p in tmp_path.glob("bestmodel-*.npz")) == \
        ["bestmodel-20.npz"]
    assert ckpt_lib.latest_checkpoint(
        str(tmp_path), ckpt_lib.BEST_INDEX_FILE).endswith("bestmodel-20.npz")
    path, flat = jax_ckpt.load_ckpt(str(tmp_path), jax_ckpt.BEST_INDEX_FILE,
                                    max_retries=0)
    assert jax_ckpt.content_fingerprint(
        jax_ckpt._unflatten_dicts(flat)["params"]) == \
        ckpt_lib.content_fingerprint(state.params)


def test_chunk_files_cross_read_between_packages(tmp_path):
    feats = [{"article": [article(i)], "abstract": [abstract(i)],
              "tags": [b"x", "yé"], "empty": []} for i in range(3)]
    chunks.write_chunk_file(str(tmp_path / "port.bin"), feats)
    got = [ex.features for ex in
           jax_chunks.read_chunk_file(str(tmp_path / "port.bin"))]
    want = [{k: [v.encode() if isinstance(v, str) else v for v in vs]
             for k, vs in f.items()} for f in feats]
    assert got == want
    exs = [Example().set_bytes("article", article(i))
           .set_bytes("abstract", abstract(i)) for i in range(3)]
    jax_chunks.write_chunk_file(str(tmp_path / "jax.bin"), exs)
    assert list(chunks.read_chunk_file(str(tmp_path / "jax.bin"))) == \
        [ex.features for ex in exs]
    # byte for byte the JAX package's encoding of the same bytes features
    blobs = [chunks.serialize_bytes_features(ex.features) for ex in exs]
    assert (tmp_path / "jax.bin").read_bytes() == b"".join(
        struct.pack("<q", len(b)) + b for b in blobs)


def _train_flags(tmp_path, **extra):
    _, thps = make_hps(**TF)
    flags = dict(mode="train", device="cpu", log_root=str(tmp_path),
                 exp_name="exp", data_path=str(tmp_path / "train_*.bin"),
                 vocab_path=str(tmp_path / "vocab"), coverage=1,
                 **{k: getattr(thps, k) for k in (
                     "model_family", "hidden_dim", "num_heads", "enc_layers",
                     "dec_layers", "batch_size", "vocab_size",
                     "max_enc_steps", "max_dec_steps", "min_dec_steps",
                     "max_oov_buckets")})
    flags.update(extra)
    return [f"--{k}={v}" for k, v in flags.items()]


def test_cli_trains_resumes_and_evals_on_cpu(tmp_path):
    chunks.write_chunk_file(
        str(tmp_path / "train_000.bin"),
        [{"article": [article(i)], "abstract": [abstract(i)]}
         for i in range(5)])
    (tmp_path / "vocab").write_text("".join(f"{w} {100 - i}\n"
                                            for i, w in enumerate(WORDS)))
    train_dir = tmp_path / "exp" / "train"
    assert cli.main(_train_flags(tmp_path, num_steps=3)) == 0
    assert (train_dir / "model.ckpt-3.npz").exists()
    assert cli.main(_train_flags(tmp_path, num_steps=5)) == 0
    records = [json.loads(line) for line in
               (train_dir / "events.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3, 4, 5]  # resumed at 3
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["coverage_loss"])
               for r in records)
    assert int(ckpt_lib.load_arrays(str(train_dir / "model.ckpt-5.npz"))
               ["step"]) == 5
    hps = cli.HParams.from_argv(_train_flags(tmp_path, mode="eval"))
    loss = cli.run_eval(hps, cli.Vocab(hps.vocab_path, hps.vocab_size),
                        max_iters=1)
    assert np.isfinite(loss)
    eval_dir = tmp_path / "exp" / "eval"
    assert [p.name for p in eval_dir.glob("bestmodel-*.npz")] == \
        ["bestmodel-5.npz"]
    assert (eval_dir / "checkpoint_best").exists()
    # the pointer-generator trains through the same entry point (its own
    # experiment: the transformer's checkpoints do not fit it)
    assert cli.main(_train_flags(tmp_path, model_family="pointer_generator",
                                 exp_name="pg", emb_dim=8, num_steps=2)) == 0
    assert (tmp_path / "pg" / "train" / "model.ckpt-2.npz").exists()
