"""The port's sharding registry, mesh checks and process-group bring-up
against the JAX package's parallel/ (in-process; the multi-rank paths are
in tests/test_torch_mesh_*.py).

The registry's per-leaf rule and batch rule give the JAX package's specs
leaf by leaf on both families' trees, its table covers the same roles,
``analytic_comms`` gives exactly the JAX numbers (43.0 MB/step of bf16
dp wire at the reference scale, 86.0 in f32, and the tp shards), and
``validate_divisibility`` raises the JAX messages."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textsummarization_on_flink_tpu.config import HParams as JHParams
from textsummarization_on_flink_tpu.parallel import mesh as jmesh
from textsummarization_on_flink_tpu.parallel import sharding as jsharding
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.parallel import (
    distributed,
    mesh,
    sharding,
)
from textsummarization_on_flink_tpu_torch.params import init_numpy_params
from textsummarization_on_flink_tpu_torch.utils import local_batch_hps

TINY = dict(hidden_dim=8, emb_dim=6, batch_size=8, max_enc_steps=16,
            max_dec_steps=6, beam_size=2, min_dec_steps=2, vocab_size=64,
            max_oov_buckets=8)
FAMILIES = {"pointer_generator": {},
            "transformer": dict(num_heads=2, enc_layers=2, dec_layers=2)}


def _trees(family):
    kw = dict(TINY, model_family=family, **FAMILIES[family])
    params = init_numpy_params(HParams(**kw), 64, 0)
    return params, jax.tree_util.tree_map(jnp.asarray, params)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_spec_matches_jax_leaf_by_leaf(family):
    params, jparams = _trees(family)
    got = [tuple(s) for s in jax.tree_util.tree_leaves(
        sharding.param_specs(params), is_leaf=lambda x: isinstance(
            x, sharding.Spec))]
    want = [tuple(s) for s in jax.tree_util.tree_leaves(
        jsharding.param_specs(jparams), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))]
    assert got == want
    assert any("tp" in s for s in got)


def test_batch_specs_roles_and_axes_match_jax():
    assert sharding.MESH_AXES == jsharding.MESH_AXES
    assert sharding.BATCH_NAMES == jsharding.BATCH_NAMES
    assert sharding.ENC_BATCH_NAMES == jsharding.ENC_BATCH_NAMES
    assert sharding.ROLES == jsharding.ROLES
    for name in sharding.BATCH_NAMES:
        assert tuple(sharding.batch_spec(name)) == tuple(
            jsharding.batch_spec(name))


def _registry(**kw):
    hps = HParams(**dict(TINY, **kw))
    plan = types.SimpleNamespace(hps=hps, dp=hps.dp, tp=hps.tp, sp=hps.sp)
    return sharding.ShardingRegistry(plan)


def test_table_covers_every_role_and_names_the_wire():
    reg = _registry(dp=4, tp=2, grad_allreduce_dtype="bfloat16")
    rows = reg.table()
    assert {r["role"] for r in rows} == set(sharding.ROLES)
    assert {r["role"]: r["wire"] for r in rows}["grads"] == "bfloat16"
    assert reg.wire_dtype("grads") is torch.bfloat16
    assert _registry(dp=4).wire_dtype("grads") is None


def test_shard_and_gather_rule_of_a_tp_rank():
    """shard_params slices each tp leaf along its spec's axis: the
    rank's V/tp rows of the embedding, columns of w, entries of v."""
    params, _ = _trees("pointer_generator")
    reg = _registry(dp=1, tp=2)
    reg.plan.coord = lambda axis: 1
    got = reg.shard_params(params)
    np.testing.assert_array_equal(got["embedding"], params["embedding"][32:])
    np.testing.assert_array_equal(got["output_projection"]["w"],
                                  params["output_projection"]["w"][:, 32:])
    np.testing.assert_array_equal(got["output_projection"]["v"],
                                  params["output_projection"]["v"][32:])
    np.testing.assert_array_equal(got["encoder"]["fw"]["kernel"],
                                  params["encoder"]["fw"]["kernel"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("tp,wire", [(1, "float32"), (2, "float32"),
                                     (2, "bfloat16"), (4, "bfloat16")])
def test_analytic_comms_equals_jax(family, tp, wire):
    params, jparams = _trees(family)
    kw = dict(TINY, model_family=family, tp=tp, grad_allreduce_dtype=wire,
              **FAMILIES[family])
    got = sharding.analytic_comms(HParams(**kw), params=params)
    want = jsharding.analytic_comms(JHParams(**kw), params=jparams)
    assert got == want


def test_analytic_comms_ref_scale_pins_43mb():
    """The JAX package's committed number at the reference scale."""
    ref = HParams(batch_size=16, compute_dtype="bfloat16",
                  grad_allreduce_dtype="bfloat16")
    comms = sharding.analytic_comms(ref)
    assert round(comms["dp_wire_bytes"] / 1e6, 1) == 43.0
    assert comms["dp_grad_elements"] == comms["param_elements"]
    f32 = sharding.analytic_comms(ref.replace(grad_allreduce_dtype="float32"))
    assert round(f32["dp_wire_bytes"] / 1e6, 1) == 86.0
    jref = JHParams(batch_size=16, compute_dtype="bfloat16",
                    grad_allreduce_dtype="bfloat16")
    assert comms == jsharding.analytic_comms(jref)


BAD_MESHES = [
    dict(dp=3),
    dict(tp=3),
    dict(sp=3),
    dict(sp=2, sp_attention="ulysses", model_family="transformer",
         num_heads=3, hidden_dim=9),
    dict(tp=2, model_family="transformer", num_heads=3, hidden_dim=9),
    dict(tp=2, model_family="transformer", num_heads=2, ffn_dim=7),
    dict(tp=2, sp=2, model_family="transformer", num_heads=2,
         sp_attention="ring"),
]


@pytest.mark.parametrize("kw", BAD_MESHES,
                         ids=[",".join(f"{k}={v}" for k, v in kw.items())
                              for kw in BAD_MESHES])
def test_validate_divisibility_raises_the_jax_messages(kw):
    params = {"embedding": np.zeros((62, 4), np.float32)}
    fields = dict(TINY, **kw)
    with pytest.raises(ValueError) as got:
        mesh.validate_divisibility(HParams(**fields), params)
    with pytest.raises(ValueError) as want:
        jmesh.validate_divisibility(JHParams(**fields), params)
    assert str(got.value) == str(want.value)


def test_validate_divisibility_accepts_dividing_meshes():
    params = {"embedding": np.zeros((64, 4), np.float32)}
    mesh.validate_divisibility(HParams(**dict(TINY, dp=4, tp=2, sp=2)),
                               params)


def test_make_mesh_refuses_a_world_of_another_size():
    assert distributed.world_size() == 1
    with pytest.raises(ValueError, match="dp\\*tp\\*sp=4 ranks"):
        mesh.make_mesh(HParams(**dict(TINY, dp=2, tp=2)))
    plan = mesh.make_mesh(HParams(**TINY))
    assert (plan.size("dp"), plan.size("tp"), plan.size("sp")) == (1, 1, 1)


def test_hparams_refuse_what_the_jax_hparams_refuse():
    for kw, match in ((dict(dp=2, sp=2, grad_allreduce_dtype="bfloat16"),
                       "sp=1"),
                      (dict(dp=2, pointer_gen=False,
                            grad_allreduce_dtype="bfloat16"), "pointer_gen"),
                      (dict(sp_attention="rings"), "sp_attention"),
                      (dict(grad_allreduce_dtype="float16"),
                       "grad_allreduce_dtype")):
        with pytest.raises(ValueError, match=match):
            HParams(device="cpu", **kw).validate()
        with pytest.raises(ValueError, match=match):
            JHParams(**kw).validate()
    HParams(device="cpu", dp=2, tp=2,
            grad_allreduce_dtype="bfloat16").validate()


def test_local_batch_hps_splits_per_dp_index():
    """batch_size / dp rows per rank, whatever tp and sp are: the tp and
    sp ranks of one dp index hold the same rows."""
    hps = HParams(batch_size=16, dp=2, tp=2, sp=2, device="cpu")
    assert local_batch_hps(hps).batch_size == 8
    assert local_batch_hps(hps.replace(dp=1)).batch_size == 16
    with pytest.raises(ValueError, match="divisible by dp=3"):
        local_batch_hps(hps.replace(dp=3))


def test_backend_follows_the_layout():
    assert distributed.choose_backend("cuda:0", 1, 1) == "nccl"
    assert distributed.choose_backend("cuda:1", 2, 2) == "nccl"
    assert distributed.choose_backend("cuda:0", 2, 1) == "gloo"
    assert distributed.choose_backend("cuda:0", 4, 1) == "gloo"
    assert distributed.choose_backend("cpu", 2, 0) == "gloo"


def test_initialize_is_a_no_op_at_world_one_and_refuses_nccl_on_a_shared_device():
    assert distributed.initialize(num_processes=1, process_id=0) is None
    assert distributed.backend() is None and distributed.is_chief()
    with pytest.raises(ValueError, match="Duplicate GPU detected"):
        distributed.check_backend("nccl", "cuda:0", 2, 1)
    assert distributed.check_backend("nccl", "cuda:1", 2, 2) == "nccl"
    assert distributed.check_backend(None, "cuda:0", 2, 1) == "gloo"
    with pytest.raises(ValueError, match="needs CUDA devices"):
        distributed.initialize(num_processes=2, process_id=0,
                               backend="nccl", device="cpu",
                               coordinator_address="localhost:1")
    assert not torch.distributed.is_initialized()


def test_single_rank_sharded_step_is_the_train_step():
    """The sharded step on the one-rank plan is trainer.train_step, bit
    for bit, and the deprecated bf16 builder delegates with a warning."""
    from textsummarization_on_flink_tpu.data.batching import (
        Batch,
        SummaryExample,
    )
    from textsummarization_on_flink_tpu.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode.beam_search import (
        _to_device,
    )
    from textsummarization_on_flink_tpu_torch.train import trainer

    hps = HParams(device="cpu", **TINY)
    vocab = Vocab(words=[f"w{i}" for i in range(60)], max_size=64)
    exs = [SummaryExample.build(f"w{i} w{i + 1} w3 w9 zz", ["w1 w2"], vocab,
                                JHParams(**TINY)) for i in range(8)]
    arrays = _to_device(Batch(exs, JHParams(**TINY), vocab).as_arrays(),
                        "cpu")
    params = init_numpy_params(hps, 64, 3)
    plan = mesh.make_mesh(hps)
    s1, m1 = trainer.train_step(hps, trainer.init_train_state(
        hps, 64, params=params), arrays)
    s2, m2 = mesh.make_sharded_train_step(plan)(
        trainer.init_train_state(hps, 64, params=params), arrays)
    for a, b in zip(m1, m2):
        assert torch.equal(a, b)
    for a, b in zip(trainer.tree_leaves(s1.params),
                    trainer.tree_leaves(s2.params)):
        assert torch.equal(a, b)
    with pytest.warns(DeprecationWarning, match="unified"):
        mesh.make_lowp_allreduce_train_step(plan)


def test_recovery_and_serving_refuse_a_mesh():
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )
    from textsummarization_on_flink_tpu_torch.train import trainer

    hps = HParams(device="cpu", dp=2, nan_skip_steps=1, **TINY)
    with pytest.raises(ValueError, match="single-host, default-mesh only"):
        trainer.Trainer(hps, 64, batcher=None,
                        state=trainer.init_train_state(
                            hps, 64, params=init_numpy_params(hps, 64, 0)))
    # serving takes a mesh (tests/test_torch_mesh_serve.py); like every
    # mesh path it needs the world of dp*tp*sp ranks
    with pytest.raises(ValueError, match="mesh needs dp\\*tp\\*sp=2 ranks"):
        ServingServer(hps.replace(nan_skip_steps=0), vocab=None,
                      params={})
