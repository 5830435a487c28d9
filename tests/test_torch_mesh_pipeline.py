"""The pipeline on a mesh: ``App.main`` (SummarizationEstimator.fit, then
SummarizationModel.transform) and the inference job through the serve
layer (transform(serving=True)) on two spawned gloo ranks at dp=2 (CPU),
against the same jobs on one rank, at tests/test_torch_pipeline.py's
widths and rows.

On the mesh every rank calls the jobs; the chief alone reads the sources
and writes the sinks, and each global batch of 4 rows is split over dp
(2 rows per rank), so the sharded fit is the single-rank fit on the same
rows.  Tolerances: the params after the two steps within rtol 1e-4 /
atol 1e-6 (PR 19's sharded-step tolerance); the rows exactly equal."""

import os

import numpy as np
import pytest

from _torch_mesh import load_json, run_ranks
from test_torch_pipeline import (
    WORDS,
    final_arrays,
    hps,
    rows,
    run_app,
    write_initial_checkpoint,
)
from textsummarization_on_flink_tpu_torch.pipeline import app as app_lib
from textsummarization_on_flink_tpu_torch.pipeline import io
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab

INFER = dict(n=5, start=8)


def _fields(h):
    import dataclasses

    return {f.name: getattr(h, f.name) for f in dataclasses.fields(h)
            if f.name != "device"}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipe2")
    root = work / "pipeline_dp2"
    write_initial_checkpoint(root)
    run_ranks(work, 2, [{
        "name": "pipeline_dp2", "kind": "pipeline",
        "hps": _fields(hps("port", root, "train", dp=2)),
        "decode": _fields(hps("port", root, "decode", dp=2)),
        "words": list(WORDS), "rows": [list(r) for r in rows()],
        "infer_rows": [list(r) for r in rows(**INFER)]}], timeout=240.0)
    return work, root


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe1")
    got = run_app("port", root)
    a = app_lib.App(train_hps=hps("port", root, "train"),
                    inference_hps=hps("port", root, "decode"),
                    vocab=Vocab(words=WORDS))
    served = io.CollectionSink()
    a.start_inference(None, io.CollectionSource(rows(**INFER)), served,
                      serving=True)
    return dict(rows=got, served=sorted(served.rows),
                arrays=final_arrays(root))


def test_mesh_fit_equals_the_single_rank_fit(mesh_run, single_run):
    _, root = mesh_run
    got = final_arrays(root)
    want = single_run["arrays"]
    assert int(got["step"]) == int(want["step"]) == 2
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("params/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_mesh_transform_rows_equal_the_single_rank_rows(mesh_run,
                                                        single_run):
    work, _ = mesh_run
    chief = load_json(work, "pipeline_dp2.rank0")
    want = [list(r) for r in single_run["rows"]]
    assert len(want) == INFER["n"]
    assert chief["rows"] == want
    assert chief["served"] == [list(r) for r in single_run["served"]]
    assert chief["served"] == want
    follower = load_json(work, "pipeline_dp2.rank1")
    assert follower["rows"] == [] and follower["served"] == []


def test_only_the_chief_writes_the_checkpoints(mesh_run):
    _, root = mesh_run
    train_dir = os.path.join(str(root), "exp", "train")
    assert sorted(p for p in os.listdir(train_dir) if p.endswith(".npz")) \
        == ["model.ckpt-0.npz", "model.ckpt-2.npz"]
