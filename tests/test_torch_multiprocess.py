"""The port's Trainer and Checkpointer on a mesh of four spawned gloo
ranks (the counterpart of tests/test_multiprocess.py, whose two JAX
processes hold two virtual devices each).

For the meshes "4,1" (dp 4, replicated params), "2,2" (dp 2 x tp 2: the
vocabulary tensors sharded over tp, so a save must gather them) and
"2,2,bfloat16" (the same with the bf16 gradient wire): the ranks train 5
steps with a checkpoint every 3, restore the chief-written checkpoint,
and resume to step 7 with two steps per dispatch.  Checked: the ranks'
cluster view, one events.jsonl record per step (only the chief writes),
the step-3 and step-5 checkpoints, the same restored params on every
rank (bit for bit), the resumed step, V/tp embedding rows per rank, and
``restore_sharded``: the chief-written checkpoint placed on the mesh and
gathered back bit for bit, its accumulators narrowed to bf16 under
``--opt_state_dtype=bfloat16``; the Evaluator on the mesh: one loss on
every rank, one summary record and one best model, the chief's.
"""

import json

import pytest

from _torch_mesh import load_json, run_ranks

MESHES = {"4,1": dict(dp=4, tp=1), "2,2": dict(dp=2, tp=2),
          "2,2,bfloat16": dict(dp=2, tp=2, grad_allreduce_dtype="bfloat16")}
HPS = dict(batch_size=8, max_enc_steps=6, max_dec_steps=5, min_dec_steps=1,
           hidden_dim=4, emb_dim=3, max_oov_buckets=2, vocab_size=0,
           checkpoint_steps=3)


def _name(mesh):
    return "mesh_" + mesh.replace(",", "_")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    work = tmp_path_factory.mktemp("mp")
    cases = [{"name": _name(m), "kind": "trainer", "hps": dict(HPS, **kw)}
             for m, kw in MESHES.items()]
    run_ranks(work, 4, cases, timeout=200)
    return work


@pytest.mark.parametrize("mesh", list(MESHES))
def test_four_rank_train_checkpoint_resume(trained, mesh):
    infos = [load_json(trained, f"{_name(mesh)}.rank{r}") for r in range(4)]
    assert [i["is_chief"] for i in infos] == [True, False, False, False]
    assert all(i["final_step"] == 5 for i in infos), infos
    assert all(i["restored_step"] == 5 for i in infos), infos
    assert len({i["param_checksum"] for i in infos}) == 1, \
        "ranks restored different parameters from the shared checkpoint"
    assert all(i["resumed_step"] == 7 for i in infos), infos
    tp = MESHES[mesh]["tp"]
    assert all(i["local_vocab"] == 12 // tp for i in infos)
    train_dir = trained / _name(mesh) / "train"
    with open(train_dir / "events.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f if line.strip()]
    assert len(steps) == len(set(steps)), \
        f"duplicate per-step records: a non-chief rank wrote too: {steps}"
    assert set(steps) == set(range(1, 8)), steps
    ckpts = infos[0]["ckpt_files"]
    assert all(i["ckpt_files"] == ckpts for i in infos)
    assert "model.ckpt-3.npz" in ckpts and "model.ckpt-5.npz" in ckpts
    # Checkpointer.restore_sharded: the full checkpoint on this mesh's
    # shards, gathered back bit for bit; bf16 accumulators narrowed
    assert all(i["restore_sharded_bitwise"] for i in infos)
    assert all(i["local_vocab_restored"] == 12 // tp for i in infos)
    assert all(i["narrowed_acc_dtypes"] == ["torch.bfloat16"] for i in infos)
    # the Evaluator: one loss on every rank, one record and one best model
    # (the chief's)
    assert len({i["eval_loss"] for i in infos}) == 1
    eval_dir = trained / _name(mesh) / "eval"
    assert len((eval_dir / "events.jsonl").read_text().splitlines()) == 1
    assert sorted(p.name for p in eval_dir.glob("bestmodel-*.npz")) == [
        "bestmodel-5.npz"]
