"""The port's pipeline layer end to end against the JAX package's, on the
CPU: ``SummarizationEstimator.fit`` then ``SummarizationModel.transform``,
``Pipeline``, ``App.main`` and the deprecated raw driver, plus the
failure paths (a source that fails mid-stream, a consumer that stops
early, a row the codec cannot encode), a trickling source, and the
refusals of what is not ported yet.

Width: the JAX package's own pipeline tests
(tests/test_pipeline_estimator.py:37-44: batch 4, hidden 8, embedding 6,
V 24, 12/6 steps, beam 2).  Both packages start from one initial
checkpoint written from the same numpy params (tests/_torch_parity.py,
scaled so that the random model's choices are not decided by rounding,
with a STOP bias of 1 so that summaries run to several words)
into each run's train directory; checkpoints cross-load, so each
``fit`` resumes from it.  The rows carry out-of-vocabulary words, so the
summaries exercise the copy path.

Tolerances: after 2 train steps every parameter and Adagrad accumulator
within 1e-5 of the JAX estimator's, relative to max(1, max|x|) (f32 on
both sides, only the order of sums differs); the output rows, summaries
included, equal as strings."""

import json
import os
import shlex
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import decode_params
from textsummarization_on_flink_tpu import config as jax_config
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.pipeline import app as jax_app
from textsummarization_on_flink_tpu.pipeline import estimator as jax_est
from textsummarization_on_flink_tpu.pipeline import io as jax_io
from textsummarization_on_flink_tpu.pipeline import raw_driver as jax_raw
from textsummarization_on_flink_tpu.train import trainer as jax_trainer
from textsummarization_on_flink_tpu_torch import config as torch_config
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import batcher
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.pipeline import app
from textsummarization_on_flink_tpu_torch.pipeline import estimator as est
from textsummarization_on_flink_tpu_torch.pipeline import io
from textsummarization_on_flink_tpu_torch.pipeline import raw_driver
from textsummarization_on_flink_tpu_torch.train import trainer

# tests/test_pipeline_estimator.py's vocabulary and widths
WORDS = ("article reference the a quick brown fox jumped over lazy dog "
         "0 1 2 3 4 5 6 7").split()
VSIZE = len(WORDS) + 4
FIELDS = dict(batch_size=4, hidden_dim=8, emb_dim=6, vocab_size=VSIZE,
              max_enc_steps=12, max_dec_steps=6, beam_size=2,
              min_dec_steps=1, max_oov_buckets=4, exp_name="exp")
COLS = ["uuid", "article", "reference"]

PKGS = {
    "jax": types.SimpleNamespace(
        est=jax_est, io=jax_io, app=jax_app, raw=jax_raw, vocab=JaxVocab,
        hps=lambda **kw: jax_config.HParams(**kw)),
    "port": types.SimpleNamespace(
        est=est, io=io, app=app, raw=raw_driver, vocab=Vocab,
        hps=lambda **kw: torch_config.HParams(device="cpu", **kw)),
}


def rows(n=8, start=0):
    """(uuid, article, summary, reference) rows: ragged articles of the
    vocabulary's words and ~30% out-of-vocabulary ones, each reference
    the article's first four words."""
    out = []
    for i in range(start, start + n):
        rng = np.random.RandomState(i)
        words = [WORDS[j] if rng.rand() < 0.7 else f"zz{j % 4}"
                 for j in rng.randint(0, len(WORDS), rng.randint(6, 16))]
        out.append((f"uuid-{i}", " ".join(words) + " .", "",
                    " ".join(words[:4]) + " ."))
    return out


def hps(pkg, root, mode, num_steps=2, **kw):
    return PKGS[pkg].hps(mode=mode, num_steps=num_steps, log_root=str(root),
                         **dict(FIELDS, **kw))


def initial_params():
    """The one numpy params tree both packages start from."""
    return decode_params(hps("port", "", "train"), VSIZE, stop_bias=1.0)


def write_initial_checkpoint(root):
    """model.ckpt-0 of initial_params() with fresh accumulators in
    <root>/exp/train, read by both packages."""
    thps = hps("port", root, "train")
    state = trainer.make_train_state(initial_params(), None, 0, "cpu",
                                     init_acc=thps.adagrad_init_acc)
    ckpt_lib.Checkpointer(est.train_dir_for(thps)).save(state)


def make_estimator(pkg, root, num_steps=2):
    m = PKGS[pkg]
    e = m.est.SummarizationEstimator()
    (e.set_train_selected_cols(COLS)
     .set_train_output_cols(["uuid"])
     .set_train_output_types([m.io.DataTypes.STRING]))
    e.set_train_hyper_params(shlex.split(
        hps(pkg, root, "train", num_steps).to_argv()))
    (e.set_inference_selected_cols(COLS)
     .set_inference_output_cols(["uuid", "article", "summary", "reference"])
     .set_inference_output_types([m.io.DataTypes.STRING] * 4))
    e.set_inference_hyper_params(shlex.split(
        hps(pkg, root, "decode").to_argv()))
    return e.with_vocab(m.vocab(words=WORDS))


def final_arrays(root):
    path = ckpt_lib.latest_checkpoint(os.path.join(str(root), "exp", "train"))
    return ckpt_lib.load_arrays(path)


def run_estimator(pkg, root):
    write_initial_checkpoint(root)
    src = PKGS[pkg].io.CollectionSource
    model = make_estimator(pkg, root).fit(src(rows()))
    sink = model.transform(src(rows()))
    return dict(rows=sorted(sink.rows), arrays=final_arrays(root),
                model=model)


def run_pipeline(pkg, root):
    write_initial_checkpoint(root)
    src = PKGS[pkg].io.CollectionSource
    fitted = PKGS[pkg].est.Pipeline([make_estimator(pkg, root)]).fit(
        src(rows()))
    return sorted(fitted.transform(src(rows(4))).rows)


def run_app(pkg, root):
    m = PKGS[pkg]
    write_initial_checkpoint(root)
    a = m.app.App(train_hps=hps(pkg, root, "train"),
                  inference_hps=hps(pkg, root, "decode"),
                  vocab=m.vocab(words=WORDS))
    sink = m.io.CollectionSink()
    out = a.main(train_source=m.io.CollectionSource(rows()),
                 infer_source=m.io.CollectionSource(rows(5, start=8)),
                 sink=sink)
    assert out is sink
    return sorted(sink.rows)


def run_raw_driver(pkg, root, monkeypatch):
    """raw_driver.training starts from fresh params in both packages:
    their initialisers (jax.random against numpy) are swapped for the one
    numpy tree here."""
    m = PKGS[pkg]
    p = initial_params()
    if pkg == "jax":
        orig = jax_trainer.init_train_state
        monkeypatch.setattr(
            jax_trainer, "init_train_state",
            lambda h, vsize, **kw: orig(h, vsize, params=jax.tree_util.
                                        tree_map(jnp.asarray, p)))
    else:
        orig_t = trainer.init_train_state
        monkeypatch.setattr(
            trainer, "init_train_state",
            lambda h, vsize, **kw: orig_t(h, vsize, params=p, **kw))
    h = hps(pkg, root, "train", num_steps=2)
    vocab = m.vocab(words=WORDS)
    with pytest.warns(DeprecationWarning):
        state = m.raw.training(h, m.io.CollectionSource(rows()), vocab=vocab)
    assert int(state.step) == 2
    with pytest.warns(DeprecationWarning):
        sink = m.raw.inference(h, m.io.CollectionSource(rows(3)),
                               vocab=vocab)
    return sorted(sink.rows)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's estimator, Pipeline, App and raw driver, once."""
    with pytest.MonkeyPatch.context() as mp:
        return dict(
            estimator=run_estimator("jax", tmp_path_factory.mktemp("jax_e")),
            pipeline=run_pipeline("jax", tmp_path_factory.mktemp("jax_p")),
            app=run_app("jax", tmp_path_factory.mktemp("jax_a")),
            raw=run_raw_driver("jax", tmp_path_factory.mktemp("jax_r"), mp))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's estimator once, its metrics in a registry of its own."""
    root = tmp_path_factory.mktemp("port_e")
    reg = obs.Registry()
    with obs.use_registry(reg):
        out = run_estimator("port", root)
    return dict(out, root=root, registry=reg)


def test_fit_tracks_the_jax_estimator(jax_runs, port_run):
    got, want = port_run["arrays"], jax_runs["estimator"]["arrays"]
    assert sorted(got) == sorted(want)
    assert int(got["step"]) == int(want["step"]) == 2
    assert any(k.startswith("opt_state") for k in got)
    init = ckpt_lib._flatten({"params": initial_params()})
    for k, w in want.items():
        if k == "step":
            continue
        err = float(np.max(np.abs(got[k] - w)))
        assert err <= 1e-5 * max(1.0, float(np.max(np.abs(w)))), (k, err)
        if k in init and k.endswith("embedding"):
            assert np.max(np.abs(w - init[k])) > 1e-4  # training moved it


def test_transform_gives_the_jax_rows(jax_runs, port_run):
    got, want = port_run["rows"], jax_runs["estimator"]["rows"]
    assert [r[0] for r in got] == [f"uuid-{i}" for i in range(8)]
    assert got == want
    assert all(r[2] for r in got)  # every article got a summary
    assert max(len(r[2].split()) for r in got) > 1


def test_model_carries_configuration_only(jax_runs, port_run):
    model = port_run["model"]
    j = model.to_json()
    # the same params as the JAX model's; the argv strings differ only
    # by each package's own fields
    assert json.loads(j).keys() == \
        json.loads(jax_runs["estimator"]["model"].to_json()).keys()
    assert len(j) < 10_000 and all(
        isinstance(v, (str, int, float, bool, list, type(None)))
        for v in json.loads(j).values())
    train_dir = os.path.join(str(port_run["root"]), "exp", "train")
    assert os.path.exists(os.path.join(train_dir, "model.ckpt-2.npz"))
    again = est.SummarizationModel().load_json(j).with_vocab(
        Vocab(words=WORDS))
    assert sorted(again.transform(io.CollectionSource(rows(3))).rows) == \
        port_run["rows"][:3]


def _span_count(reg, name):
    """The finished spans of ``name`` in the registry's tracer."""
    return sum(r.name == name for r in obs.tracer_for(reg).finished())


def test_pipeline_metrics(port_run):
    reg = port_run["registry"]
    counts = {k: reg.counter("pipeline/" + k).value for k in (
        "rows_in_total", "rows_out_total", "source_rows_total",
        "codec_errors_total", "feeder_errors_total")}
    assert counts == dict(rows_in_total=16, rows_out_total=8,
                          source_rows_total=16, codec_errors_total=0,
                          feeder_errors_total=0)
    assert _span_count(reg, "pipeline/fit") == 1
    assert _span_count(reg, "pipeline/transform") == 1


def test_pipeline_gives_the_jax_rows(jax_runs, tmp_path):
    got = run_pipeline("port", tmp_path)
    assert len(got) == 4 and got == jax_runs["pipeline"]


def test_app_main_gives_the_jax_rows(jax_runs, tmp_path):
    reg = obs.Registry()
    with obs.use_registry(reg):
        got = run_app("port", tmp_path)
    assert [r[0] for r in got] == sorted(f"uuid-{i}" for i in range(8, 13))
    assert got == jax_runs["app"]
    assert reg.counter("pipeline/train_jobs_total").value == 1
    assert reg.counter("pipeline/inference_jobs_total").value == 1
    assert _span_count(reg, "pipeline/train_job") == 1
    assert _span_count(reg, "pipeline/inference_job") == 1


def test_raw_driver_gives_the_jax_rows(jax_runs, tmp_path, monkeypatch):
    got = run_raw_driver("port", tmp_path, monkeypatch)
    assert len(got) == 3 and got == jax_runs["raw"]


def test_fit_resumes_from_its_checkpoint(port_run, tmp_path):
    """One step on the first four rows, then a second fit that resumes
    at step 1 and takes one more on the next four: the state of two
    steps in one fit over all eight (the same two batches)."""
    write_initial_checkpoint(tmp_path)
    make_estimator("port", tmp_path, num_steps=1).fit(
        io.CollectionSource(rows(4)))
    assert int(final_arrays(tmp_path)["step"]) == 1
    make_estimator("port", tmp_path, num_steps=2).fit(
        io.CollectionSource(rows(4, start=4)))
    got = final_arrays(tmp_path)
    assert int(got["step"]) == 2
    for k, w in port_run["arrays"].items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


class _FailingSource(io.Source):
    schema = io.ARTICLE_INPUT_SCHEMA

    def rows(self):
        yield from rows(4)
        raise ConnectionError("stream dropped")


def test_a_source_that_fails_mid_stream_fails_fit(tmp_path):
    reg = obs.Registry()
    with obs.use_registry(reg), \
            pytest.raises(RuntimeError, match="source stream failed") as e:
        make_estimator("port", tmp_path).fit(_FailingSource())
    assert isinstance(e.value.__cause__, ConnectionError)
    assert reg.counter("pipeline/feeder_errors_total").value == 1
    assert reg.counter("pipeline/rows_in_total").value == 4


def _feeder_threads():
    return [t for t in threading.enumerate() if t.is_alive()
            and "_BridgeFeeder" in str(getattr(t, "_target", ""))]


def test_a_consumer_that_stops_early_cancels_the_feeder(port_run, tmp_path,
                                                      monkeypatch):
    """fit stops at num_steps and transform at max_batches while the
    source would go on forever: each returns, the feeder stops reading.
    The transform half waits for a whole batch: a trickle wait no loaded
    run reaches keeps a slow feeder from shipping a partial one."""
    def endless():
        i = 0
        while True:
            yield rows(1, start=i % 50)[0]
            i += 1

    reg = obs.Registry()
    with obs.use_registry(reg):
        make_estimator("port", tmp_path).fit(io.IteratorSource(endless))
        assert not _feeder_threads()
        fed = reg.counter("pipeline/rows_in_total").value
        # two batches trained, the trainer's prefetcher ahead by at most
        # its queue's 2 batches and the one it holds (of 4 rows each),
        # the threaded batcher's example and batch queues (100 batches'
        # worth each), the batch it is bucketing and the example it is
        # building, the record queue's bound and one row in flight
        cap = batcher.Batcher.BATCH_QUEUE_MAX * 4
        assert 8 <= fed <= 8 + 3 * 4 + 2 * cap + 4 + 1 + 1024 + 1
        model = make_estimator("port", port_run["root"])._model()
        monkeypatch.setattr(batcher, "TRICKLE_WAIT_S", 30.0)
        sink = model.transform(io.IteratorSource(endless), max_batches=1)
    assert len(sink.rows) == 4
    assert not _feeder_threads()


def test_a_row_the_codec_cannot_encode_fails_the_job(tmp_path):
    # the reference column declared INT_64: its text cannot be encoded
    schema = io.RowSchema(["uuid", "article", "summary", "reference"],
                          [io.DataTypes.STRING] * 3 + [io.DataTypes.INT_64])
    reg = obs.Registry()
    with obs.use_registry(reg), \
            pytest.raises(RuntimeError, match="source stream failed") as e:
        make_estimator("port", tmp_path).fit(
            io.CollectionSource(rows(), schema=schema))
    assert isinstance(e.value.__cause__, ValueError)
    assert reg.counter("pipeline/codec_errors_total").value == 1
    assert reg.counter("pipeline/feeder_errors_total").value == 1


def test_a_trickled_row_is_summarized_before_the_stream_goes_on(port_run):
    """One row, then the source blocks: its summary reaches the sink
    while the source is still blocked (a partial batch after the
    trickle wait, not a batch held for three more articles)."""
    go_on = threading.Event()

    def trickle():
        yield rows(1)[0]
        go_on.wait(60)

    model = make_estimator("port", port_run["root"])._model()
    sink = io.QueueSink()
    t = threading.Thread(target=model.transform,
                         args=(io.IteratorSource(trickle), sink))
    t.start()
    try:
        row = sink.queue.get(timeout=30)
        assert not go_on.is_set()
        assert row == port_run["rows"][0]
    finally:
        go_on.set()
        t.join(timeout=30)
    assert not t.is_alive() and sink.queue.empty()


def test_what_is_not_ported_yet_raises(port_run):
    """Hierarchical transforms (item 7, landed) write one row per
    document revision; serving with the continuous
    engine (item 4, landed) transforms the rows as the micro-batch engine
    does, and so (item 5, landed) do the spec tier, with a fresh AAN
    draft, and an App whose degrade tier is draft; a spec tier without a
    draft model is refused at its first submit."""
    model = make_estimator("port", port_run["root"])._model()
    src = io.CollectionSource(rows(1))
    hier = model.transform(src, hierarchical=True)
    (uuid, article, _, reference), = hier.rows
    assert (uuid, article, reference) == (
        rows(1)[0][0] + "@r1", rows(1)[0][1], rows(1)[0][3])
    argv = model.get_inference_hyper_params()
    want = io.CollectionSink()
    model.transform(io.CollectionSource(rows(2)), want, serving=True)
    model.set_inference_hyper_params(argv + ["--serve_mode=continuous"])
    got = io.CollectionSink()
    model.transform(io.CollectionSource(rows(2)), got, serving=True)
    assert len(got.rows) == 2 and sorted(got.rows) == sorted(want.rows)
    model.set_inference_hyper_params(argv + ["--serve_default_tier=greedy"])
    greedy = io.CollectionSink()
    model.transform(io.CollectionSource(rows(2)), greedy, serving=True)
    model.set_inference_hyper_params(argv + ["--serve_default_tier=spec",
                                             "--spec_draft=fresh"])
    spec = io.CollectionSink()
    model.transform(io.CollectionSource(rows(2)), spec, serving=True)
    assert sorted(spec.rows) == sorted(greedy.rows)
    model.set_inference_hyper_params(argv + ["--serve_default_tier=spec"])
    with pytest.raises(ValueError, match="draft model"):
        model.transform(src, serving=True)
    a = app.App(hps("port", port_run["root"], "train"),
                hps("port", port_run["root"], "decode").replace(
                    serve_degrade_tier="draft"),
                vocab=Vocab(words=WORDS))
    out = a.start_inference(source=io.CollectionSource(rows(2)),
                            sink=io.CollectionSink(), serving=True)
    assert sorted(out.rows) == sorted(want.rows)
    assert not _feeder_threads()


def test_without_a_card_fit_and_transform_raise(port_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    e = make_estimator("port", port_run["root"])
    for key in ("train", "inference"):
        argv = [a for a in getattr(e, f"get_{key}_hyper_params")()
                if not a.startswith("--device=")]
        getattr(e, f"set_{key}_hyper_params")(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e.fit(io.CollectionSource(rows()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e._model().transform(io.CollectionSource(rows()))
    assert not _feeder_threads()
    assert app.default_train_hps("x").device == "cuda"
    assert app.default_inference_hps("x").device == "cuda"


def test_app_defaults_match_the_jax_app():
    for name in ("default_train_hps", "default_inference_hps"):
        mine, theirs = getattr(app, name)("root"), getattr(jax_app, name)(
            "root")
        for f in torch_config.HParams.__dataclass_fields__:
            if f != "device":
                assert getattr(mine, f) == getattr(theirs, f), (name, f)
    assert (app.TRAIN_TOPIC, app.INPUT_TOPIC, app.OUTPUT_TOPIC) == \
        (jax_app.TRAIN_TOPIC, jax_app.INPUT_TOPIC, jax_app.OUTPUT_TOPIC)
