"""The port's sharded batch beam decode on spawned gloo ranks (CPU)
against the JAX package's single-device search: the tokens and lengths
EXACTLY equal, the average log-probabilities within 1e-5.

dp=4 (each rank searches two of the eight articles), dp2 x tp2 (the
vocab-sharded embedding and projection, one scores all-gather per step),
sp=4 and dp2 x sp2 with coverage (each sp rank's attention on its block
of T, merged over sp every step) for the pointer-generator, dp2 x tp2
(its heads sharded too, with the f32 and with the bf16 KV cache, against
the JAX search with the same cache) and dp2 x sp2 under
--sp_attention=ring (the encoder's T sharded, ring attention) for the
transformer; the BeamSearchDecoder on a mesh (the chief's results
equal the single-rank decoder's words, other tiers refused, the slot
engine built over dp); continuous decode (``single_pass=0``)
reloading a newer checkpoint at the chief's call when the ranks' clocks
disagree on whether a reload is due; and ``python -m textsummarization_on_flink_tpu_torch
--mode=decode --single_pass=1 --dp=2`` on two ranks writing the same
decode files and ROUGE results as one rank."""

import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_mesh import (
    free_port,
    load_json,
    load_npz,
    rank_env,
    run_ranks,
    save_npz,
    save_params,
)
from _torch_parity import WORDS, abstract, article, decode_params, make_hps
from textsummarization_on_flink_tpu.data import batching as jax_batching
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.decode import beam_search as jax_bs
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import batching, chunks
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import decoder as dec_lib
from textsummarization_on_flink_tpu_torch.params import init_numpy_params

N_ART = 8
FIELDS = ("batch_size", "hidden_dim", "emb_dim", "vocab_size",
          "max_enc_steps", "max_dec_steps", "beam_size", "min_dec_steps",
          "max_oov_buckets", "trunc_norm_init_std", "rand_unif_init_mag",
          "model_family", "num_heads", "enc_layers", "dec_layers")
FAMILIES = {"pointer_generator": {},
            "transformer": dict(num_heads=2, enc_layers=2, dec_layers=2)}
#: the 4-rank meshes each family searches on (the sp ranks shard T: the
#: pointer-generator's attention, the transformer's encoder under
#: --sp_attention)
MESHES = {"pointer_generator": {"dp4": dict(dp=4), "dp2_tp2": dict(dp=2,
                                                                  tp=2),
                                "sp4": dict(sp=4),
                                "dp2_sp2_cov": dict(dp=2, sp=2,
                                                    coverage=True),
                                # T = 22 is no multiple of sp = 4: the
                                # search pads it with masked positions
                                "sp4_t22": dict(sp=4, max_enc_steps=22)},
          "transformer": {"dp2_tp2": dict(dp=2, tp=2),
                          "dp2_tp2_bf16_cache": dict(
                              dp=2, tp=2, decode_cache_dtype="bfloat16"),
                          "dp2_sp2_ring": dict(dp=2, sp=2,
                                               sp_attention="ring")}}
#: which ranks' own clocks say a checkpoint reload is due
CONTINUOUS = ("chief", "followers")


def _setup(family, max_enc_steps=None):
    jhps, thps = make_hps(batch_size=N_ART, model_family=family,
                          **FAMILIES[family])
    if max_enc_steps is not None:
        jhps = jhps.replace(max_enc_steps=max_enc_steps)
        thps = thps.replace(max_enc_steps=max_enc_steps)
    jv = JaxVocab(words=WORDS)
    exs = [jax_batching.SummaryExample.build(article(i), [abstract(i)], jv,
                                             jhps) for i in range(N_ART)]
    batch = jax_batching.Batch(exs, jhps, jv)
    if family == "pointer_generator":
        params = decode_params(thps, jv.size())
    else:
        params = init_numpy_params(thps, jv.size(), 4)
    return jhps, thps, batch, params


def _hps_fields(thps, **kw):
    return dict({k: getattr(thps, k) for k in FIELDS}, **kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("decode4")
    cases = []
    for family in FAMILIES:
        _, thps, batch, params = _setup(family)
        save_params(work, f"params_{family}", params)
        for name, kw in MESHES[family].items():
            batch = _setup(family, kw.get("max_enc_steps"))[2]
            save_npz(work, f"batch_{family}_{name}", batch.as_arrays())
            cases.append({"name": f"{family}_{name}", "kind": "search",
                          "params": f"params_{family}",
                          "batch": f"batch_{family}_{name}",
                          "hps": _hps_fields(thps, mode="decode", **kw)})
    _, thps, _, _ = _setup("pointer_generator")
    cases.append({"name": "decoder", "kind": "decoder",
                  "params": "params_pointer_generator", "words": list(WORDS),
                  "articles": [article(i) for i in range(N_ART)],
                  "abstracts": [abstract(i) for i in range(N_ART)],
                  "hps": _hps_fields(thps, mode="decode", dp=2, tp=2)})
    flat = ckpt_lib._flatten({"params": decode_params(thps, len(WORDS) + 4)},
                             "")
    save_npz(work, "newer", {k: v * np.float32(0.5) for k, v in flat.items()})
    for due_on in CONTINUOUS:
        name = f"continuous_{due_on}"
        ckpt_lib.save_arrays(str(work / name / "model.ckpt-5.npz"), flat)
        ckpt_lib.write_index(str(work / name),
                             str(work / name / "model.ckpt-5.npz"))
        cases.append({"name": name, "kind": "continuous", "due_on": due_on,
                      "newer": "newer", "batches": 3, "words": list(WORDS),
                      "articles": [article(i) for i in range(N_ART)],
                      "abstracts": [abstract(i) for i in range(N_ART)],
                      "hps": _hps_fields(thps, mode="decode", dp=2, tp=2)})
    run_ranks(work, 4, cases)
    return work


@pytest.mark.parametrize("family,name", [
    (f, n) for f, meshes in MESHES.items() for n in meshes])
def test_sharded_beam_search_tokens_equal_jax(ranks, family, name):
    kw = MESHES[family][name]
    jhps, _, batch, params = _setup(family, kw.get("max_enc_steps"))
    want = jax_bs.run_beam_search(
        params, jhps.replace(
            decode_cache_dtype=kw.get("decode_cache_dtype", "float32"),
            coverage=kw.get("coverage", False)), batch.as_arrays())
    for r in range(4):  # every rank holds the whole batch's outputs
        got = load_npz(ranks, f"{family}_{name}.rank{r}")
        np.testing.assert_array_equal(got["tokens"], want.tokens)
        np.testing.assert_array_equal(got["length"], want.length)
        np.testing.assert_allclose(got["avg_log_prob"], want.avg_log_prob,
                                   rtol=1e-5, atol=1e-5)


def test_decoder_on_a_mesh(ranks, tmp_path):
    """The chief's results are the single-rank decoder's words (held
    against the JAX decoder in tests/test_torch_beam_search.py); the
    other ranks return none; a tier other than beam is refused on every
    rank, and the slot engine builds with its slots sharded over dp
    (served in tests/test_torch_mesh_serve.py)."""
    _, thps, _, params = _setup("pointer_generator")
    tv = Vocab(words=WORDS)
    exs = [batching.SummaryExample.build(article(i), [abstract(i)], tv,
                                         thps.replace(mode="decode"))
           for i in range(N_ART)]
    single = dec_lib.BeamSearchDecoder(
        thps.replace(mode="decode"), tv, batcher=None, params=params,
        decode_root=str(tmp_path)).decode_batch(
            batching.Batch(exs, thps.replace(mode="decode"), tv))
    chief = load_json(ranks, "decoder.rank0")
    assert chief["sharded"]
    assert chief["words"] == [r.decoded_words for r in single]
    for r in range(1, 4):
        assert load_json(ranks, f"decoder.rank{r}")["words"] == []
    for r in range(4):
        info = load_json(ranks, f"decoder.rank{r}")
        refused = info["refused"]
        assert len(refused) == 1
        assert refused[0].startswith("ValueError") and "beam tier" in \
            refused[0]
        assert info["engine_local_slots"] == 2  # 4 slots over dp=2


@pytest.mark.parametrize("due_on", CONTINUOUS)
def test_continuous_decode_reloads_at_the_chiefs_call(ranks, due_on):
    """Whether a reload is due is the chief's call: when only the chief's
    clock says so, every rank reloads the newer checkpoint once; when
    only the followers' clocks say so, none does.  Either way the ranks
    stay in step and hold the same params."""
    infos = [load_json(ranks, f"continuous_{due_on}.rank{r}")
             for r in range(4)]
    reloaded = due_on == "chief"
    for info in infos:
        assert info["first"] == "model.ckpt-5.npz"
        assert info["last"] == ("model.ckpt-6.npz" if reloaded
                                else "model.ckpt-5.npz")
        assert info["reloads"] == int(reloaded)
        assert info["fingerprint"] == infos[0]["fingerprint"]
    assert infos[0]["results"] == 3 * N_ART
    assert all(info["results"] == 0 for info in infos[1:])


def _model(root, thps):
    train_dir = root / "exp" / "train"
    flat = ckpt_lib._flatten({"params": decode_params(thps, len(WORDS) + 4)},
                             "")
    path = str(train_dir / "model.ckpt-5.npz")
    ckpt_lib.save_arrays(path, flat)
    ckpt_lib.write_index(str(train_dir), path)
    (root / "vocab").write_text("".join(f"{w} {100 - i}\n"
                                        for i, w in enumerate(WORDS)))
    chunks.write_chunk_file(str(root / "test_000.bin"), [
        {"article": [article(i)], "abstract": [abstract(i)]}
        for i in range(6)])


def _cli(root, thps, world, timeout=120):
    flags = dict(mode="decode", device="cpu", single_pass=1,
                 log_root=str(root), exp_name="exp",
                 data_path=str(root / "test_*.bin"),
                 vocab_path=str(root / "vocab"), dp=world,
                 **{k: getattr(thps, k) for k in FIELDS[:9]})
    cmd = [sys.executable, "-m", "textsummarization_on_flink_tpu_torch"] + [
        f"--{k}={v}" for k, v in flags.items()]
    port = free_port()
    procs = [subprocess.Popen(cmd, env=rank_env(r, world, port),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("decode ranks hung")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def test_cli_decode_on_two_ranks_writes_what_one_rank_writes(tmp_path):
    _, thps = make_hps(batch_size=4)
    for world in (1, 2):
        root = tmp_path / f"w{world}"
        root.mkdir()
        _model(root, thps)
        _cli(root, thps, world)
    name = dec_lib.get_decode_dir_name(thps, "model.ckpt-5.npz")
    one, two = (tmp_path / f"w{w}" / "exp" / name for w in (1, 2))
    files = sorted(os.listdir(one / "decoded"))
    assert len(files) == 6 and sorted(os.listdir(two / "decoded")) == files
    for sub in ("decoded", "reference"):
        for f in os.listdir(one / sub):
            assert (one / sub / f).read_text() == (two / sub / f).read_text()
    assert (one / "ROUGE_results.txt").read_text() == \
        (two / "ROUGE_results.txt").read_text()
