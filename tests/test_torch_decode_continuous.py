"""The port's continuous decode (decode/decoder.py, single_pass off) on
the CPU: the checkpoint reload (maybe_reload_checkpoint) picks up a
newer checkpoint written mid-run, and each result's attention-visualizer
file has the JAX package's field layout, byte for byte the file the JAX
decoder's writer makes of the same result."""

import json
import types

import numpy as np
import pytest

from _torch_parity import WORDS, abstract, article, decode_params, make_hps
from textsummarization_on_flink_tpu.decode import decoder as jax_decoder
from textsummarization_on_flink_tpu_torch import cli, obs
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import chunks
from textsummarization_on_flink_tpu_torch.data.batcher import Batcher
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import decoder as dec_lib

VSIZE = len(WORDS) + 4


def _save(train_dir, thps, step, seed):
    flat = ckpt_lib._flatten({"params": decode_params(thps, VSIZE,
                                                      seed=seed)}, "")
    path = str(train_dir / f"model.ckpt-{step}.npz")
    ckpt_lib.save_arrays(path, flat)
    ckpt_lib.write_index(str(train_dir), path)
    return path


def _setup(tmp_path, thps):
    train_dir = tmp_path / "exp" / "train"
    _save(train_dir, thps, 5, seed=11)
    (tmp_path / "vocab").write_text("".join(f"{w} {100 - i}\n"
                                            for i, w in enumerate(WORDS)))
    chunks.write_chunk_file(str(tmp_path / "test_000.bin"), [
        {"article": [article(i)], "abstract": [abstract(i)]}
        for i in range(5)])
    flags = dict(mode="decode", device="cpu", single_pass=0,
                 log_root=str(tmp_path), exp_name="exp",
                 data_path=str(tmp_path / "test_*.bin"),
                 vocab_path=str(tmp_path / "vocab"), **{
                     k: getattr(thps, k) for k in (
                         "batch_size", "hidden_dim", "emb_dim", "vocab_size",
                         "max_enc_steps", "max_dec_steps", "beam_size",
                         "min_dec_steps", "max_oov_buckets", "pointer_gen")})
    hps = cli.HParams.from_argv([f"--{k}={v}" for k, v in flags.items()])
    return hps, train_dir


def test_continuous_decode_reloads_a_newer_checkpoint(tmp_path, monkeypatch):
    """With the reload interval at 0, a checkpoint written while the
    first batch's results come out is loaded after that batch (one
    reload, counted), and the later results come from its params; every
    result rewrites attn_vis_data.json, which equals the JAX writer's
    file for the last result."""
    jhps, thps = make_hps(batch_size=2)
    hps, train_dir = _setup(tmp_path, thps)
    monkeypatch.setattr(dec_lib, "SECS_UNTIL_NEW_CKPT", 0)
    vocab = Vocab(hps.vocab_path, hps.vocab_size)
    batcher = Batcher(hps.data_path, vocab, hps, single_pass=False)
    results = []

    def sink(res):
        if not results:  # a trainer saves while the first batch decodes
            _save(train_dir, thps, 6, seed=12)
        results.append(res)

    reg = obs.Registry()
    with obs.use_registry(reg):
        decoder = dec_lib.BeamSearchDecoder(hps, vocab, batcher,
                                            train_dir=str(train_dir))
        assert decoder.decode(result_sink=sink, max_batches=3) is None
    assert reg.counter("decode/ckpt_reloads_total").value == 1
    assert decoder._params_snapshot()[1].endswith("model.ckpt-6.npz")
    # the first batch from checkpoint 5, the two after it from 6
    fps = [r.params_fingerprint for r in results]
    switch = fps.index(fps[-1])
    assert 0 < switch < len(fps) and len(set(fps)) == 2
    assert fps[:switch] == [fps[0]] * switch
    ddir = tmp_path / "exp" / "decode"
    got = (ddir / "attn_vis_data.json").read_bytes()
    assert set(json.loads(got)) == {"article_lst", "decoded_lst",
                                    "abstract_str", "attn_dists", "p_gens"}
    (tmp_path / "jax").mkdir()
    jax_decoder.BeamSearchDecoder.write_for_attnvis(
        types.SimpleNamespace(_hps=jhps, _decode_dir=str(tmp_path / "jax")),
        results[-1])
    assert got == (tmp_path / "jax" / "attn_vis_data.json").read_bytes()
    assert not (ddir / "reference").exists()


@pytest.mark.parametrize("pointer_gen", [True, False])
def test_attnvis_file_equals_the_jax_writers(tmp_path, pointer_gen):
    """The field layout with and without the copy gate's p_gens."""
    jhps, thps = make_hps(batch_size=2, pointer_gen=pointer_gen)
    hps, train_dir = _setup(tmp_path, thps)
    vocab = Vocab(hps.vocab_path, hps.vocab_size)
    decoder = cli.run_decode(hps, vocab, max_batches=1)
    assert decoder.rouge_results is None
    ddir = tmp_path / "exp" / "decode"
    got = json.loads((ddir / "attn_vis_data.json").read_text())
    assert ("p_gens" in got) == pointer_gen
    res = types.SimpleNamespace(
        article=" ".join(got["article_lst"]),
        decoded_words=got["decoded_lst"],
        abstract_sents=[got["abstract_str"]],
        attn_dists=np.asarray(got["attn_dists"]),
        p_gens=np.asarray(got["p_gens"]) if pointer_gen else None)
    (tmp_path / "jax").mkdir()
    jax_decoder.BeamSearchDecoder.write_for_attnvis(
        types.SimpleNamespace(_hps=jhps, _decode_dir=str(tmp_path / "jax")),
        res)
    assert json.loads((tmp_path / "jax" / "attn_vis_data.json").read_text()) \
        == got
