"""Checkpoints shared by the two packages: a checkpoint written by the
JAX package's Checkpointer serves in the port with the same tokens and
the same params fingerprint, and the port's writer is read back by the
JAX package."""

import numpy as np
import pytest

from _torch_parity import WORDS, abstract, article, decode_params, make_hps
from textsummarization_on_flink_tpu.checkpoint import checkpointer as jax_ckpt
from textsummarization_on_flink_tpu.data import batching as jax_batching
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.decode import decoder as jax_dec
from textsummarization_on_flink_tpu.train import trainer as jax_trainer
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import decoder as dec_lib
from textsummarization_on_flink_tpu_torch.params import from_numpy_tree
from textsummarization_on_flink_tpu_torch.resilience import errors


@pytest.fixture()
def jax_train_dir(tmp_path):
    jhps, thps = make_hps(coverage=True)
    p = decode_params(thps, JaxVocab(words=WORDS).size(), seed=21)
    state = jax_trainer.init_train_state(jhps, len(WORDS) + 4, params=p)
    d = tmp_path / "train"
    jax_ckpt.Checkpointer(str(d), hps=jhps).save(state)
    return str(d)


def _batch(hps, vocab_cls, batching_mod):
    v = vocab_cls(words=WORDS)
    exs = [batching_mod.SummaryExample.build(article(i), [abstract(i)], v, hps)
           for i in range(hps.batch_size)]
    return batching_mod.Batch(exs, hps, v), v


def test_jax_checkpoint_serves_in_port(tmp_path, jax_train_dir):
    jhps, thps = make_hps(coverage=True)
    jb, jv = _batch(jhps, JaxVocab, jax_batching)
    tb, tv = _batch(thps, Vocab, batching)
    jd = jax_dec.BeamSearchDecoder(jhps, jv, None, train_dir=jax_train_dir,
                                   decode_root=str(tmp_path / "j"),
                                   max_ckpt_retries=0)
    td = dec_lib.BeamSearchDecoder(thps, tv, None, train_dir=jax_train_dir,
                                   decode_root=str(tmp_path / "t"),
                                   max_ckpt_retries=0)
    assert td.params_fingerprint == jd.params_fingerprint
    want = jd.decode_batch(jb)
    got = td.decode_batch(tb)
    assert [r.decoded_words for r in got] == [r.decoded_words for r in want]
    assert any(r.decoded_words for r in got)


def test_port_writes_what_jax_reads(tmp_path):
    _, thps = make_hps()
    p = from_numpy_tree(decode_params(thps, 30, seed=22))
    path = str(tmp_path / "train" / "model.ckpt-7.npz")
    ckpt_lib.save_arrays(path, ckpt_lib._flatten({"params": p}, ""))
    ckpt_lib.write_index(str(tmp_path / "train"), path)
    assert jax_ckpt.verify_manifest(path)
    got_path, flat = jax_ckpt.load_ckpt(str(tmp_path / "train"),
                                        max_retries=0)
    assert got_path == path
    tree = jax_ckpt._unflatten_dicts(flat)["params"]
    want = ckpt_lib._flatten(p)
    got = jax_ckpt._flatten(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert jax_ckpt.content_fingerprint(tree) == \
        ckpt_lib.content_fingerprint(p)


def test_corrupt_latest_falls_back_to_older(tmp_path):
    _, thps = make_hps()
    d = tmp_path / "train"
    flat = ckpt_lib._flatten({"params": decode_params(thps, 30)}, "")
    for step in (1, 2):
        path = str(d / f"model.ckpt-{step}.npz")
        ckpt_lib.save_arrays(path, flat)
        ckpt_lib.write_index(str(d), path)
    with open(d / "model.ckpt-2.npz", "r+b") as f:  # flip bytes in place
        f.seek(100)
        f.write(b"\x00\xff\x00\xff")
    with pytest.raises(ckpt_lib.CheckpointCorruptError):
        ckpt_lib.verify_manifest(str(d / "model.ckpt-2.npz"))
    path, _ = ckpt_lib.load_ckpt(str(d), max_retries=0)
    assert path.endswith("model.ckpt-1.npz")
    assert ckpt_lib.latest_checkpoint(str(d)).endswith("model.ckpt-2.npz")


def test_a_corrupt_checkpoint_is_a_resilience_error(tmp_path):
    """The checkpointer raises the resilience package's one class, as the
    JAX checkpointer does, so `except ResilienceError` catches it."""
    _, thps = make_hps()
    d = tmp_path / "train"
    path = str(d / "model.ckpt-1.npz")
    ckpt_lib.save_arrays(path, ckpt_lib._flatten(
        {"params": decode_params(thps, 30)}, ""))
    ckpt_lib.write_index(str(d), path)
    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\xff\x00\xff")
    assert ckpt_lib.CheckpointCorruptError is errors.CheckpointCorruptError
    with pytest.raises(errors.ResilienceError):
        ckpt_lib.verify_manifest(path)
    with pytest.raises(errors.CheckpointCorruptError):
        ckpt_lib.load_arrays_verified(path)


def test_flatten_round_trip_keeps_key_scheme():
    tree = {"params": {"a": {"b": np.ones(2, np.float32)},
                       "layers": [np.zeros(1), np.ones(1)]},
            "step": np.int32(3)}
    flat = ckpt_lib._flatten(tree)
    assert sorted(flat) == sorted(jax_ckpt._flatten(tree))
    back = ckpt_lib._unflatten_dicts(flat)
    assert isinstance(back["params"]["layers"], list)
    np.testing.assert_array_equal(back["params"]["a"]["b"], np.ones(2))
