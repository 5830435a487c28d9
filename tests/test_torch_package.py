"""The port as a package: import purity, device policy, config parsing,
and the decode entry point end to end on the CPU."""

import ast
import os
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_parity import WORDS, abstract, article, decode_params, make_hps
from textsummarization_on_flink_tpu import config as jax_config
from textsummarization_on_flink_tpu.data import chunks as jax_chunks
from textsummarization_on_flink_tpu.data.tfexample import Example
from textsummarization_on_flink_tpu_torch import cli
from textsummarization_on_flink_tpu_torch import config as torch_config
from textsummarization_on_flink_tpu_torch import device as device_lib
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import chunks, etl
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.models import get_family

PKG = pathlib.Path(__file__).resolve().parent.parent / \
    "textsummarization_on_flink_tpu_torch"


def _imported_modules(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """The port's modules, chip_smoke.py (and its mesh ranks'
    chip_smoke_mesh.py) and the port's scripts."""
    repo = PKG.parent
    files = sorted(PKG.rglob("*.py")) + [repo / "chip_smoke.py",
                                         repo / "chip_smoke_mesh.py"] + \
        sorted((repo / "scripts").glob("torch_*.py"))
    assert len(files) > 10
    scanned = {f.relative_to(PKG).as_posix() for f in files if PKG in f.parents}
    assert {"resilience/errors.py", "data/tfexample.py",
            "pipeline/estimator.py", "pipeline/io.py", "pipeline/app.py",
            "pipeline/raw_driver.py", "resilience/policy.py"} <= scanned
    assert {f"obs/{m}.py" for m in (
        "__init__", "registry", "spans", "export", "flightrec", "locksan",
        "profile", "slo", "http")} <= scanned
    assert {f"serve/{m}.py" for m in (
        "__init__", "errors", "queue", "batcher", "frontdoor",
        "server")} <= scanned
    assert {f"parallel/{m}.py" for m in (
        "__init__", "distributed", "sharding", "mesh", "collectives",
        "ring_attention")} | {"utils.py"} <= scanned
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "flax", "optax") or \
                    root == "textsummarization_on_flink_tpu":
                bad.append(f"{f.relative_to(repo)}: {mod}")
    assert not bad, bad


def test_cli_without_cpu_request_raises_when_no_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--mode=decode", f"--log_root={tmp_path}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lib.resolve_device("cuda")
    assert device_lib.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.\
        allow_bf16_reduced_precision_reduction is False


def test_from_argv_matches_jax_on_shared_fields():
    argv = ("--mode=decode --single_pass --coverage=1 --beam_size 5 "
            "--max_enc_steps=120 --vocab_path=/v --pointer_gen=false "
            "--device=cpu --unknown_flag=3").split()
    j = jax_config.HParams.from_argv(argv)
    tt = torch_config.HParams.from_argv(argv)
    assert tt.device == "cpu"
    for f in ("mode", "single_pass", "coverage", "beam_size",
              "max_enc_steps", "vocab_path", "pointer_gen",
              "max_oov_buckets", "min_dec_steps", "hidden_dim"):
        assert getattr(tt, f) == getattr(j, f), f


def test_validate_refuses_unported_options():
    """bf16 compute is taken for every family (the transformer's flash
    kernels have their bf16 forms), the AAN family too; the bf16 KV cache
    validates in either compute dtype, and a cache dtype JAX refuses is
    refused with JAX's message."""
    torch_config.HParams(compute_dtype="bfloat16").validate()
    torch_config.HParams(compute_dtype="bfloat16",
                         model_family="transformer").validate()
    torch_config.HParams(compute_dtype="bfloat16",
                         model_family="avg_attention").validate()
    for dt in ("float32", "bfloat16"):
        torch_config.HParams(model_family="transformer", compute_dtype=dt,
                             decode_cache_dtype="bfloat16").validate()
    with pytest.raises(ValueError, match=re.escape(
            "bad decode_cache_dtype 'float16' (float32/bfloat16)")):
        torch_config.HParams(model_family="transformer",
                             decode_cache_dtype="float16").validate()
    with pytest.raises(ValueError):
        get_family("nope")
    with pytest.raises(ValueError, match="device"):
        torch_config.HParams(device="tpu").validate()


def test_cli_refuses_train_and_eval(tmp_path):
    """Both families train and evaluate now, and the checkpoint-surgery
    flags run and exit: pointer-generator (the default family) training
    and eval through the CLI on the CPU, then ``--convert_to_coverage_model``
    on its checkpoint.  The transformer in bf16 with ``--loss_chunk``
    trains too (it raised before its flash kernels had bf16 forms), in
    an experiment of its own."""
    chunks.write_chunk_file(
        str(tmp_path / "train_000.bin"),
        [{"article": [article(i)], "abstract": [abstract(i)]}
         for i in range(4)])
    (tmp_path / "vocab").write_text("".join(f"{w} {100 - i}\n"
                                            for i, w in enumerate(WORDS)))
    flags = ["--device=cpu", f"--log_root={tmp_path}",
             f"--data_path={tmp_path / 'train_*.bin'}",
             f"--vocab_path={tmp_path / 'vocab'}", "--hidden_dim=8",
             "--emb_dim=8", "--batch_size=2", "--max_enc_steps=16",
             "--max_dec_steps=6", "--min_dec_steps=2",
             f"--vocab_size={len(WORDS) + 4}", "--max_oov_buckets=6"]
    train_dir = tmp_path / "exp" / "train"
    assert cli.main(["--mode=train", "--num_steps=2", *flags]) == 0
    assert (train_dir / "model.ckpt-2.npz").exists()
    hps = torch_config.HParams.from_argv(["--mode=eval", *flags])
    assert np.isfinite(cli.run_eval(hps, cli.Vocab(hps.vocab_path,
                                                   hps.vocab_size),
                                    max_iters=1))
    assert cli.main(["--mode=train", "--convert_to_coverage_model=1",
                     *flags]) == 0
    assert (train_dir / "model.ckpt-2_cov_init.npz").exists()
    assert cli.main(["--mode=train", "--num_steps=1", *flags,
                     "--exp_name=transformer_bf16",
                     "--model_family=transformer", "--num_heads=2",
                     "--enc_layers=1", "--dec_layers=1",
                     "--compute_dtype=bfloat16", "--loss_chunk=8"]) == 0
    assert (tmp_path / "transformer_bf16" / "train" /
            "model.ckpt-1.npz").exists()


def test_tokenizer_matches_jax():
    from textsummarization_on_flink_tpu.data import etl as jax_etl

    text = "The U.S. didn't say 1,000.5 things -- it's Bob's well-known cat."
    assert etl.tokenize_text(text) == jax_etl.tokenize_text(text)


def _write_model(tmp_path, hps, vsize):
    train_dir = tmp_path / "exp" / "train"
    flat = ckpt_lib._flatten({"params": decode_params(hps, vsize)}, "")
    path = str(train_dir / "model.ckpt-5.npz")
    ckpt_lib.save_arrays(path, flat)
    ckpt_lib.write_index(str(train_dir), path)
    vocab_path = tmp_path / "vocab"
    vocab_path.write_text("".join(f"{w} {100 - i}\n"
                                  for i, w in enumerate(WORDS)))
    return str(vocab_path)


def _flags(hps, tmp_path, vocab_path, data_path, **extra):
    flags = dict(mode="decode", data_path=data_path, vocab_path=vocab_path,
                 log_root=str(tmp_path), exp_name="exp", single_pass=1,
                 device="cpu", batch_size=hps.batch_size,
                 hidden_dim=hps.hidden_dim, emb_dim=hps.emb_dim,
                 vocab_size=hps.vocab_size, max_enc_steps=hps.max_enc_steps,
                 max_dec_steps=hps.max_dec_steps, beam_size=hps.beam_size,
                 min_dec_steps=hps.min_dec_steps,
                 max_oov_buckets=hps.max_oov_buckets, **extra)
    return [f"--{k}={v}" for k, v in flags.items()]


def _decoded_files(tmp_path, hps):
    d = tmp_path / "exp" / ("decode_ckpt-5_%dmaxenc_%dbeam_%dmindec_%dmaxdec"
                            % (hps.max_enc_steps, hps.beam_size,
                               hps.min_dec_steps, hps.max_dec_steps))
    return sorted((d / "decoded").iterdir())


def test_cli_inference_decodes_every_raw_text_file(tmp_path):
    _, hps = make_hps(coverage=True)
    vocab_path = _write_model(tmp_path, hps, len(WORDS) + 4)
    (tmp_path / "articles").mkdir()
    for i in range(5):  # 5 articles, batch 2: a padded tail batch
        (tmp_path / "articles" / f"a{i}.txt").write_text(article(i))
    argv = _flags(hps, tmp_path, vocab_path,
                  str(tmp_path / "articles" / "*.txt"), inference=1,
                  coverage=1)
    assert cli.main(argv) == 0
    files = _decoded_files(tmp_path, hps)
    assert [f.name for f in files] == [f"{i:06d}_decoded.txt"
                                       for i in range(5)]
    vocab = Vocab(vocab_path, hps.vocab_size)
    words = " ".join(f.read_text() for f in files).split()
    assert words and all(w in vocab or w.startswith("zz") for w in words)


def test_cli_decodes_chunk_files_written_by_the_jax_etl(tmp_path):
    _, hps = make_hps()
    vocab_path = _write_model(tmp_path, hps, len(WORDS) + 4)
    exs = [Example().set_bytes("article", article(i))
           .set_bytes("abstract", abstract(i)).set_ints("n", i)
           for i in range(3)]
    exs.append(Example().set_bytes("article", "").set_bytes("abstract", "x"))
    jax_chunks.write_chunked(str(tmp_path / "test"), exs, chunk_size=2)
    pairs = list(chunks.text_pairs(str(tmp_path / "test_*.bin")))
    assert pairs == [(article(i), abstract(i)) for i in range(3)]
    argv = _flags(hps, tmp_path, vocab_path, str(tmp_path / "test_*.bin"))
    assert cli.main(argv) == 0
    assert len(_decoded_files(tmp_path, hps)) == 3
    refs = sorted((_decoded_files(tmp_path, hps)[0].parent.parent
                   / "reference").iterdir())
    assert refs[0].read_text() == "the the sat ."


def test_init_params_shapes_match_jax():
    from textsummarization_on_flink_tpu.models import pointer_generator as jpg
    import jax

    jhps, thps = make_hps()
    want = jax.eval_shape(lambda: jpg.init_params(
        jhps, 40, jax.random.PRNGKey(0)))
    got = decode_params(thps, 40)
    flat_w = ckpt_lib._flatten(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), want))
    flat_g = ckpt_lib._flatten(got)
    assert {k: v.shape for k, v in flat_g.items()} == \
        {k: v.shape for k, v in flat_w.items()}
    assert os.path.basename(str(PKG)) == "textsummarization_on_flink_tpu_torch"
