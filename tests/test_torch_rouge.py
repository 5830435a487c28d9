"""The port's native ROUGE (evaluate/rouge.py) against the JAX package's,
and the single-pass decode that scores with it, on the CPU.  Tolerance
0: the same pure-Python arithmetic and the same seeded bootstrap give
the same floats."""

import numpy as np
import pytest

from _torch_parity import WORDS, abstract, article, decode_params, make_hps
from textsummarization_on_flink_tpu.evaluate import rouge as jax_rouge
from textsummarization_on_flink_tpu_torch import cli
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import chunks
from textsummarization_on_flink_tpu_torch.decode import decoder as dec_lib
from textsummarization_on_flink_tpu_torch.evaluate import rouge


def _sentences(rng, n):
    return [" ".join(rng.choice(WORDS + ["The", "A,", "x1"], rng.randint(
        1, 12))) + " ." for _ in range(n)]


def _write_dirs(tmp_path, n_docs, seed):
    """pyrouge-layout reference/decoded files of random sentences, one
    empty decoded summary among them."""
    rng = np.random.RandomState(seed)
    ref, dec = tmp_path / "reference", tmp_path / "decoded"
    ref.mkdir()
    dec.mkdir()
    for i in range(n_docs):
        (ref / f"{i:06d}_reference.txt").write_text(
            "\n".join(_sentences(rng, rng.randint(1, 4))))
        (dec / f"{i:06d}_decoded.txt").write_text(
            "" if i == 1 else "\n".join(_sentences(rng, rng.randint(1, 4))))
    return str(ref), str(dec)


@pytest.mark.parametrize("n_docs,seed", [(1, 0), (3, 1), (12, 2), (40, 3)])
def test_rouge_eval_equals_the_jax_module(tmp_path, n_docs, seed):
    """rouge_eval's dict (ROUGE-1/2/L f, recall, precision and their
    bootstrap bounds) is the JAX module's, exactly; rouge_log writes the
    same ROUGE_results.txt."""
    ref, dec = _write_dirs(tmp_path, n_docs, seed)
    got = rouge.rouge_eval(ref, dec)
    want = jax_rouge.rouge_eval(ref, dec)
    assert got == want
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    text = rouge.rouge_log(got, str(tmp_path / "port"))
    assert text == jax_rouge.rouge_log(want, str(tmp_path / "jax"))
    assert (tmp_path / "port" / "ROUGE_results.txt").read_bytes() == \
        (tmp_path / "jax" / "ROUGE_results.txt").read_bytes()


@pytest.mark.parametrize("peer,model", [
    (["the cat sat ."], ["the cat sat ."]),
    (["a b c d", "e f"], ["b d f", "a e"]),
    ([], ["x y"]),
    (["Police killed 2, the man said ."], ["police killed two men ."]),
])
def test_document_scores_equal_the_jax_module(peer, model):
    """ROUGE-1/2 clipped n-grams and union-LCS ROUGE-L of one document."""
    got = rouge.score_document(peer, model)
    want = jax_rouge.score_document(peer, model)
    assert {k: (s.recall, s.precision, s.f) for k, s in got.items()} == \
        {k: (s.recall, s.precision, s.f) for k, s in want.items()}


def _model(root, thps):
    """A checkpoint of sharpened random params (ckpt 5), the vocab and 5
    articles as a chunk file under ``root``."""
    train_dir = root / "exp" / "train"
    vsize = len(WORDS) + 4
    flat = ckpt_lib._flatten({"params": decode_params(thps, vsize)}, "")
    path = str(train_dir / "model.ckpt-5.npz")
    ckpt_lib.save_arrays(path, flat)
    ckpt_lib.write_index(str(train_dir), path)
    (root / "vocab").write_text("".join(f"{w} {100 - i}\n"
                                        for i, w in enumerate(WORDS)))
    chunks.write_chunk_file(str(root / "test_000.bin"), [
        {"article": [article(i)], "abstract": [abstract(i)]}
        for i in range(5)])


def _flags(root, thps, **extra):
    fields = dict(mode="decode", device="cpu", log_root=str(root),
                  exp_name="exp", data_path=str(root / "test_*.bin"),
                  vocab_path=str(root / "vocab"), **{
                      k: getattr(thps, k) for k in (
                          "batch_size", "hidden_dim", "emb_dim", "vocab_size",
                          "max_enc_steps", "max_dec_steps", "beam_size",
                          "min_dec_steps", "max_oov_buckets")})
    fields.update(extra)
    return [f"--{k}={v}" for k, v in fields.items()]


def test_single_pass_decode_scores_its_files_with_rouge(tmp_path):
    """cli.main --mode=decode --single_pass=1 over chunk files writes the
    pyrouge files and ROUGE_results.txt into the decode dir, as the JAX
    module writes it for the same files; run_decode's decoder holds the
    scores, equal to the JAX module's over its files."""
    _, thps = make_hps(batch_size=2)
    for name in ("main", "run_decode"):
        (tmp_path / name).mkdir()
        _model(tmp_path / name, thps)
    root = tmp_path / "main"
    assert cli.main(_flags(root, thps, single_pass=1)) == 0
    ddir = root / "exp" / dec_lib.get_decode_dir_name(thps,
                                                       "model.ckpt-5.npz")
    assert len(list((ddir / "decoded").iterdir())) == 5
    want = jax_rouge.rouge_eval(str(ddir / "reference"), str(ddir / "decoded"))
    assert (ddir / "ROUGE_results.txt").read_text() == \
        jax_rouge.rouge_log(want, str(tmp_path / "jax"))
    root = tmp_path / "run_decode"
    hps = cli.HParams.from_argv(_flags(root, thps, single_pass=1))
    decoder = cli.run_decode(hps, cli.Vocab(hps.vocab_path, hps.vocab_size))
    ddir = root / "exp" / dec_lib.get_decode_dir_name(thps,
                                                       "model.ckpt-5.npz")
    assert decoder.rouge_results == jax_rouge.rouge_eval(
        str(ddir / "reference"), str(ddir / "decoded"))
    assert decoder.rouge_results == want  # the same tokens, the same files
