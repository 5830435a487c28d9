"""The pointer-generator's checkpoint tools against the JAX package's, on
the CPU: checkpoint surgery (``convert_to_coverage_model``,
``restore_best_model``) writes the same file names and index files and
cross-loads with equal fingerprints; the TF1 importer maps synthetic
TF1-named arrays to the same tree; the NaN/Inf inspector gives the same
report; ``--mode=train`` writes the same vocabulary metadata; and the
flash wrapper's head-dim padding is exact."""

import shutil

import numpy as np
import pytest
import torch

from _torch_parity import WORDS, abstract, article, make_hps, n, numpy_params
from textsummarization_on_flink_tpu.checkpoint import checkpointer as jax_ckpt
from textsummarization_on_flink_tpu.checkpoint import inspect as jax_inspect
from textsummarization_on_flink_tpu.checkpoint import tf1_import as jax_tf1
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu_torch import cli
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.checkpoint import inspect
from textsummarization_on_flink_tpu_torch.checkpoint import tf1_import
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data import chunks
from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
from textsummarization_on_flink_tpu_torch.params import (
    add_coverage_params,
    tree_leaves,
)
from textsummarization_on_flink_tpu_torch.train import trainer

VSIZE = len(WORDS) + 4


def _state(thps, seed=4, step=9):
    """A port TrainState whose accumulators differ from their init."""
    state = trainer.init_train_state(thps, VSIZE,
                                     params=numpy_params(thps, VSIZE, seed))
    rng = np.random.RandomState(seed)
    for a in tree_leaves(state.opt_state.accumulators):
        a.add_(torch.from_numpy(rng.rand(*a.shape).astype(np.float32)))
    return state._replace(step=step)


def _flat_equal(a, b, skip=()):
    assert sorted(a) == sorted(b)
    for k in a:
        if k not in skip:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_restore_best_model_cross_loads_with_jax(tmp_path):
    _, thps = make_hps(mode="train", coverage=True)
    state = _state(thps)
    eval_dir = tmp_path / "eval"
    ckpt_lib.BestModelSaver(str(eval_dir))(state.params, 2.5, 17)
    port_train, jax_train = tmp_path / "port", tmp_path / "jax"
    port_train.mkdir()
    jax_train.mkdir()
    out = ckpt_lib.restore_best_model(str(eval_dir), str(port_train), thps)
    jout = jax_ckpt.restore_best_model(str(eval_dir), str(jax_train), thps)
    assert out.endswith("model.ckpt-17_restored.npz")
    assert jout.endswith("model.ckpt-17_restored.npz")
    _flat_equal(ckpt_lib.load_arrays(out), jax_ckpt.load_arrays(jout))
    # each package restores the other's, step and fresh accumulators kept
    jstate = jax_ckpt.Checkpointer(str(port_train)).restore()
    pstate = ckpt_lib.Checkpointer(str(jax_train)).restore()
    assert int(jstate.step) == pstate.step == 17
    assert jax_ckpt.content_fingerprint(jstate.params) == \
        ckpt_lib.content_fingerprint(pstate.params) == \
        ckpt_lib.content_fingerprint(state.params)
    assert all(np.all(n(a) == thps.adagrad_init_acc)
               for a in tree_leaves(pstate.opt_state.accumulators))
    assert ckpt_lib.latest_checkpoint(str(port_train)) == out


def test_convert_to_coverage_model_keeps_every_leaf_but_w_c(tmp_path):
    _, thps = make_hps(mode="train", coverage=False)
    state = _state(thps)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    path = ckpt_lib.Checkpointer(str(port_dir), hps=thps).save(state)
    shutil.copytree(port_dir, jax_dir)
    out = ckpt_lib.convert_to_coverage_model(str(port_dir), thps, seed=3)
    jout = jax_ckpt.convert_to_coverage_model(str(jax_dir), thps, seed=3)
    assert out == path[:-len(".npz")] + "_cov_init.npz"
    assert jout.endswith("model.ckpt-9_cov_init.npz")
    got, want = ckpt_lib.load_arrays(out), jax_ckpt.load_arrays(jout)
    before = ckpt_lib.load_arrays(path)
    w_c = "params/decoder/attention/w_c"
    acc_w_c = "opt_state/accumulators/decoder/attention/w_c"
    _flat_equal(got, want, skip=(w_c,))
    _flat_equal(got, before, skip=(w_c, acc_w_c))
    assert np.all(got[acc_w_c] == thps.adagrad_init_acc)
    D = got[w_c].shape[0]
    limit = (6.0 / (2 * D)) ** 0.5  # glorot on [D]
    assert not np.array_equal(got[w_c], before[w_c])
    assert np.all(np.abs(got[w_c]) <= limit) and got[w_c].std() > 0
    # the newest checkpoint is the conversion: JAX resumes from it
    jstate = jax_ckpt.Checkpointer(str(port_dir)).restore()
    assert int(jstate.step) == 9
    np.testing.assert_array_equal(
        np.asarray(jstate.params["decoder"]["attention"]["w_c"]), got[w_c])
    # a second conversion would destroy trained coverage params
    with pytest.raises(RuntimeError, match="already a coverage conversion"):
        ckpt_lib.convert_to_coverage_model(str(port_dir), thps)
    again = ckpt_lib.convert_to_coverage_model(str(port_dir), thps, seed=4,
                                               force=True)
    assert again.endswith("model.ckpt-9_cov_init_cov_init.npz")


def test_convert_to_coverage_model_refuses_the_transformer(tmp_path):
    _, thps = make_hps(model_family="transformer", hidden_dim=32,
                       num_heads=1, enc_layers=1, dec_layers=1, mode="train")
    ckpt_lib.Checkpointer(str(tmp_path), hps=thps).save(_state(thps))
    with pytest.raises(ValueError, match="pointer_generator family only"):
        ckpt_lib.convert_to_coverage_model(str(tmp_path), thps)
    with pytest.raises(FileNotFoundError):
        ckpt_lib.convert_to_coverage_model(str(tmp_path / "none"), thps)


def test_add_coverage_params_draws_a_fresh_w_c_only():
    _, thps = make_hps()
    p = numpy_params(thps, VSIZE, 1)
    q = add_coverage_params(p, seed=5)
    w_c = q["decoder"]["attention"]["w_c"]
    assert w_c is not p["decoder"]["attention"]["w_c"]
    np.testing.assert_array_equal(w_c, add_coverage_params(p, 5)[
        "decoder"]["attention"]["w_c"])  # seeded
    assert q["decoder"]["attention"]["W_h"] is p["decoder"]["attention"]["W_h"]
    assert w_c.shape == (2 * thps.hidden_dim,) and w_c.dtype == np.float32


def _tf1_arrays(thps, seed=0, with_cov=True):
    """Synthetic TF1-named arrays: the tree's leaves under their TF1 names
    (W_h and w_c conv-shaped), plus Adagrad slots and bookkeeping."""
    p = numpy_params(thps, VSIZE, seed)
    out = {}
    for name, (path, squeeze) in jax_tf1.TF1_NAME_MAP.items():
        if name.endswith("coverage/w_c") and not with_cov:
            continue
        v = p
        for k in path:
            v = v[k]
        out[name] = v.reshape((1, 1) + (() if v.ndim == 2 else (1,))
                              + v.shape) if squeeze else v
        out[name + "/Adagrad"] = np.ones_like(out[name])
    out["global_step"] = np.asarray(1234)
    return out


@pytest.mark.parametrize("with_cov", [True, False])
def test_import_tf1_arrays_matches_jax(with_cov):
    _, thps = make_hps()
    arrays = _tf1_arrays(thps, with_cov=with_cov)
    got = tf1_import.import_tf1_arrays(arrays)
    want = jax_tf1.import_tf1_arrays(arrays)
    assert ckpt_lib._flatten(got).keys() == ckpt_lib._flatten(want).keys()
    _flat_equal(ckpt_lib._flatten(got), ckpt_lib._flatten(want))
    assert ("w_c" in got["decoder"]["attention"]) == with_cov
    assert got["decoder"]["attention"]["W_h"].ndim == 2
    for base in (None, HParams(coverage=True, max_enc_steps=77)):
        h = tf1_import.infer_hps_from_params(got, base=base)
        jh = jax_tf1.infer_hps_from_params(want, base=base)
        for f in ("vocab_size", "emb_dim", "hidden_dim", "coverage",
                  "max_enc_steps"):
            assert getattr(h, f) == getattr(jh, f), f
    assert h.vocab_size == VSIZE and h.hidden_dim == thps.hidden_dim


def test_import_tf1_arrays_refuses_like_jax():
    _, thps = make_hps()
    arrays = _tf1_arrays(thps)
    extra = dict(arrays, **{"seq2seq/unknown": np.zeros(3)})
    for mod in (tf1_import, jax_tf1):
        with pytest.raises(KeyError, match="unmapped"):
            mod.import_tf1_arrays(extra)
        assert "embedding" in mod.import_tf1_arrays(extra, strict=False)
        missing = dict(arrays)
        del missing["seq2seq/embedding/embedding"]
        with pytest.raises(KeyError, match="missing"):
            mod.import_tf1_arrays(missing)


def test_import_to_train_dir_without_and_with_tensorflow(tmp_path,
                                                         monkeypatch):
    """With no TensorFlow the bundle reader raises, as the JAX package's
    does; given the arrays, the import writes a training checkpoint with
    fresh coverage params and accumulators."""
    try:
        import tensorflow  # noqa: F401
        have_tf = True
    except ImportError:
        have_tf = False
    if not have_tf:
        with pytest.raises(ImportError, match="import_tf1_arrays"):
            tf1_import.import_tf1_checkpoint(str(tmp_path / "bundle"))
    _, thps = make_hps()
    arrays = _tf1_arrays(thps, with_cov=False)
    monkeypatch.setattr(tf1_import, "import_tf1_checkpoint",
                        lambda path, strict=True:
                        tf1_import.import_tf1_arrays(arrays, strict))
    path = tf1_import.import_to_train_dir(
        "bundle", str(tmp_path / "train"),
        hps=HParams(coverage=True, device="cpu"), seed=2)
    assert path.endswith("model.ckpt-0.npz")
    jstate = jax_ckpt.Checkpointer(str(tmp_path / "train")).restore()
    assert "w_c" in jstate.params["decoder"]["attention"]
    np.testing.assert_array_equal(
        np.asarray(jstate.params["embedding"]),
        arrays["seq2seq/embedding/embedding"])


def test_inspect_arrays_and_main_match_jax(tmp_path, capsys):
    flat = {"a/ok": np.ones(3, np.float32), "b/some": np.array([1.0, np.nan]),
            "c/all": np.full(2, np.inf), "d/int": np.arange(3),
            "e/empty": np.zeros(0)}
    assert inspect.inspect_arrays(flat) == jax_inspect.inspect_arrays(flat)
    for name, arrays in (("bad.npz", flat),
                         ("good.npz", {"a/ok": flat["a/ok"]})):
        path = str(tmp_path / name)
        ckpt_lib.save_arrays(path, arrays)
        rc = inspect.main([path])
        port_out = capsys.readouterr().out
        assert rc == jax_inspect.main([path])
        assert port_out == capsys.readouterr().out
        assert rc == (1 if name == "bad.npz" else 0)
    assert inspect.main([]) == 2


def test_cli_training_writes_the_jax_vocab_metadata(tmp_path):
    """--mode=train writes <train_dir>/vocab_metadata.tsv, byte for byte
    the JAX package's file for the same vocab (JAX cli.py:64-66)."""
    chunks.write_chunk_file(
        str(tmp_path / "train_000.bin"),
        [{"article": [article(i)], "abstract": [abstract(i)]}
         for i in range(3)])
    vocab_path = tmp_path / "vocab"
    vocab_path.write_text("".join(f"{w} {100 - i}\n"
                                  for i, w in enumerate(WORDS)))
    assert cli.main(["--mode=train", "--device=cpu", "--num_steps=1",
                     f"--log_root={tmp_path}",
                     f"--data_path={tmp_path / 'train_*.bin'}",
                     f"--vocab_path={vocab_path}", "--hidden_dim=8",
                     "--emb_dim=8", "--batch_size=2", "--max_enc_steps=16",
                     "--max_dec_steps=6", "--min_dec_steps=2",
                     f"--vocab_size={VSIZE}"]) == 0
    JaxVocab(str(vocab_path), VSIZE).write_metadata(str(tmp_path / "j.tsv"))
    got = (tmp_path / "exp" / "train" / "vocab_metadata.tsv").read_bytes()
    assert got == (tmp_path / "j.tsv").read_bytes()
    assert got.decode().splitlines()[:5] == ["[UNK]", "[PAD]", "[START]",
                                             "[STOP]", WORDS[0]]


@pytest.mark.parametrize("hd,width", [(16, 32), (32, 32), (64, 128),
                                      (100, 128), (128, 128), (160, 256),
                                      (256, 256), (320, 384)])
def test_flash_head_dim_padding_is_exact(hd, width):
    """The card pads a head dim up to the kernels' width: the plain
    versions at the padded width, with the true head dim's scale, give
    the unpadded output and gradients in their first hd columns."""
    assert fl._padded_head_dim(hd) == width
    g = torch.Generator().manual_seed(hd)
    q, k, v, do = (torch.randn(2, 9, 2, hd, generator=g) for _ in range(4))
    mask = torch.ones(2, 9)
    mask[1, 5:] = 0
    scale = hd ** -0.5
    qp, kp, vp, dop = fl._pad_head_dim(width, q, k, v, do)
    out = fl._flash_plain(q, k, v, mask, True, scale)
    outp = fl._flash_plain(qp, kp, vp, mask, True, scale)
    torch.testing.assert_close(outp[..., :hd], out, rtol=1e-6, atol=1e-6)
    assert not outp[..., hd:].any()
    lse = fl._flash_lse_plain(q, k, mask, True, scale)
    torch.testing.assert_close(fl._flash_lse_plain(qp, kp, mask, True, scale),
                               lse, rtol=1e-6, atol=1e-6)
    grads = fl._flash_bwd_plain(q, k, v, out, lse, do, mask, True, scale)
    gradsp = fl._flash_bwd_plain(qp, kp, vp, outp, lse, dop, mask, True,
                                 scale)
    for a, b in zip(gradsp, grads):
        torch.testing.assert_close(a[..., :hd], b, rtol=1e-6, atol=1e-6)
        assert not a[..., hd:].any()


def test_head_dims_above_128_are_refused_on_the_card():
    """Head dims 129-256 pad to the kernels' 256; above 256 the card no
    longer refuses them: they pad to the next multiple of 128 for the
    wide kernels, as the JAX package pads them for the library kernel."""
    assert fl._padded_head_dim(160) == 256
    assert fl._padded_head_dim(320) == 384
    assert fl._is_wide(384) and not fl._is_wide(256)
    tfm = dict(model_family="transformer", hidden_dim=640, num_heads=2)
    HParams(**tfm).validate()  # head dim 320 on the card
    HParams(device="cpu", **tfm).validate()  # the CPU runs any head dim
    HParams(hidden_dim=512, num_heads=8, model_family="transformer"
            ).validate()  # head dim 64: padded on the card
    HParams(hidden_dim=512, num_heads=2, model_family="transformer"
            ).validate()  # head dim 256: the kernels' own width
