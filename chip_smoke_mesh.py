#!/usr/bin/env python3
"""One rank of chip_smoke.py's mesh phase (``phase_mesh``); not run by hand.

    python3 chip_smoke_mesh.py case <workdir> [<job file>]
    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        chip_smoke_mesh.py cli <the port's command-line flags>
    python -m torch.distributed.run --standalone --nproc_per_node=2 \\
        chip_smoke_mesh.py app <workdir>

``case``: the rank joins the world from torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT; the
parent sets them), runs every case of ``<workdir>/<job file>`` (default
``job.json``) on the card
and writes ``<workdir>/<case>.rank<r>.json`` (and the chief the case's
gathered params, ``<case>.npz``): a sharded train step of
chip_smoke.mesh_inputs' fixed batch, the sharded decode of the mesh
phase's articles (the AAN's and the transformer's too), a train step
at the long-context width with this rank's memory, or a ServingServer
on the mesh (the chief serves, the other ranks follow), with this rank's
kernel launches, seconds, collective and host-staged bytes.

``app``: ``App.main`` (the pipeline joins torchrun's world itself) on
chip_smoke.mesh_app_inputs, writing ``<workdir>/app.rank<r>.json``.

``cli``: ``cli.main`` with the given flags (the port's own entry point,
which joins the mesh itself), then this rank's kernel launches and the
params fingerprints the restores logged, written to
``<log_root>/cli.rank<r>.steps<num_steps>.json``.

Imports torch, numpy, chip_smoke.py's helpers and the port, never jax.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

import numpy as np

import chip_smoke as cs


def _dump(path, obj):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)


def _sync(job):
    if job["device"] == "cuda":
        import torch

        torch.cuda.synchronize()


def _rank_facts():
    from textsummarization_on_flink_tpu_torch.parallel import distributed

    layout = distributed.rank_layout()
    return dict(rank=layout.rank, backend=layout.backend,
                device=layout.device,
                ranks_per_device=layout.ranks_per_device)


def run_train(case, work, job):
    """One sharded train step of the fixed batch."""
    import torch

    from textsummarization_on_flink_tpu_torch import obs, ops
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.parallel import (
        collectives,
        mesh,
    )
    from textsummarization_on_flink_tpu_torch.train import trainer

    hps, params, batch = cs.mesh_inputs(case["family"], job["seed"],
                                        job["widths"].get(case["family"]))
    hps = hps.replace(device=job["device"], **case["hps"])
    hps.validate()
    plan = mesh.make_mesh(hps)
    mesh.validate_divisibility(hps, params)
    device = torch.device(job["device"])
    state = mesh.shard_train_state(plan, trainer.init_train_state(
        hps, hps.vocab_size, params=params, device=device))
    step = mesh.make_sharded_train_step(plan)
    arrays = trainer.batch_to_device(mesh.shard_batch(plan, batch), device)
    reg = obs.Registry()
    with obs.use_registry(reg):
        cs.reset_launch_counts()
        _sync(job)
        t0 = time.perf_counter()
        state, m = step(state, arrays)
        _sync(job)
        step_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        moved = collectives.counted_bytes(hps)
        flat = ckpt_lib.state_to_arrays(state, plan)
    out = dict(_rank_facts(), case=case["name"], step_s=step_s,
               launches=launches, bytes=moved,
               metrics=[float(x) for x in m],
               local_embedding_rows=int(state.params["embedding"].shape[0]))
    if "output_projection" in state.params:
        out["local_w_cols"] = int(
            state.params["output_projection"]["w"].shape[1])
    if plan.is_chief:
        np.savez(os.path.join(work, case["name"] + ".npz"),
                 **{k: v for k, v in flat.items() if k.startswith("params/")})
    return out


def run_decode(case, work, job):
    """BeamSearchDecoder.decode_batch on the mesh: the chief's tokens."""
    from textsummarization_on_flink_tpu_torch import obs, ops
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode.decoder import (
        BeamSearchDecoder,
    )
    from textsummarization_on_flink_tpu_torch.parallel import collectives

    hps, vocab, batch = cs.mesh_decode_inputs(
        job["seed"], job["widths"].get("pointer_generator"))
    hps = hps.replace(device=job["device"], **case["hps"])
    params = ckpt_lib._unflatten_dicts(ckpt_lib.load_arrays(
        os.path.join(work, "decode_params.npz")))["params"]
    dec = BeamSearchDecoder(hps, vocab, batcher=None, params=params,
                            decode_root=os.path.join(work, "dec_" + case[
                                "name"]))
    reg = obs.Registry()
    with obs.use_registry(reg):
        cs.reset_launch_counts()
        steps0 = beam_search.steps_run
        _sync(job)
        t0 = time.perf_counter()
        results = dec.decode_batch(batch)
        _sync(job)
        out = dict(_rank_facts(), case=case["name"],
                   decode_s=time.perf_counter() - t0,
                   launches=ops.launch_counts(),
                   beam_steps=beam_search.steps_run - steps0,
                   bytes=collectives.counted_bytes(hps),
                   sharded=dec.sharded)
    out["summaries"] = [r.decoded_words for r in results]
    return out


def run_search(case, work, job):
    """parallel.mesh.make_sharded_beam_search on the mesh: every rank's
    tokens and average log-probabilities of the whole batch."""
    import torch

    from textsummarization_on_flink_tpu_torch import obs, ops
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.parallel import (
        collectives,
        mesh,
    )
    from textsummarization_on_flink_tpu_torch.params import from_numpy_tree

    hps, _, batch = cs.mesh_decode_inputs(
        job["seed"], job["widths"].get("pointer_generator"))
    hps = hps.replace(device=job["device"], **case["hps"])
    params = ckpt_lib._unflatten_dicts(ckpt_lib.load_arrays(
        os.path.join(work, "decode_params.npz")))["params"]
    plan = mesh.make_mesh(hps)
    shards = plan.registry.shard_params(
        from_numpy_tree(params, torch.device(job["device"])))
    search = mesh.make_sharded_beam_search(plan)
    reg = obs.Registry()
    with obs.use_registry(reg):
        cs.reset_launch_counts()
        steps0 = beam_search.steps_run
        _sync(job)
        t0 = time.perf_counter()
        got = search(shards, batch.as_arrays())
        out = dict(_rank_facts(), case=case["name"],
                   decode_s=time.perf_counter() - t0,
                   launches=ops.launch_counts(),
                   beam_steps=beam_search.steps_run - steps0,
                   bytes=collectives.counted_bytes(hps))
    out["tokens"] = got.tokens.tolist()
    out["avg_log_prob"] = got.avg_log_prob.tolist()
    return out


def run_model_search(case, work, job):
    """The sharded beam search of the AAN family or the transformer
    (random params from the seed, chip_smoke.aan_decode_inputs): every
    rank's tokens."""
    import torch

    from textsummarization_on_flink_tpu_torch import obs, ops
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.parallel import (
        collectives,
        mesh,
    )
    from textsummarization_on_flink_tpu_torch.params import from_numpy_tree

    hps, params, batch = cs.aan_decode_inputs(
        job["seed"], job["widths"].get(case["family"]), family=case["family"])
    hps = hps.replace(device=job["device"], **case["hps"])
    plan = mesh.make_mesh(hps)
    shards = plan.registry.shard_params(
        from_numpy_tree(params, torch.device(job["device"])))
    search = mesh.make_sharded_beam_search(plan)
    reg = obs.Registry()
    with obs.use_registry(reg):
        cs.reset_launch_counts()
        steps0 = beam_search.steps_run
        _sync(job)
        t0 = time.perf_counter()
        got = search(shards, batch)
        out = dict(_rank_facts(), case=case["name"],
                   decode_s=time.perf_counter() - t0,
                   launches=ops.launch_counts(),
                   beam_steps=beam_search.steps_run - steps0,
                   bytes=collectives.counted_bytes(hps))
    out["tokens"] = got.tokens.tolist()
    out["avg_log_prob"] = got.avg_log_prob.tolist()
    return out


def run_memory(case, work, job):
    """One sharded train step at chip_smoke.MEM_WIDTHS (the JAX package's
    long-context width): the loss, this rank's peak device bytes above
    what it held before the step, and the bytes and shapes of the es and
    ef its fused attention saved (chip_smoke.memory_step)."""
    from textsummarization_on_flink_tpu_torch import obs, ops
    from textsummarization_on_flink_tpu_torch.parallel import (
        collectives,
        mesh,
    )

    widths = dict(job["widths"].get(case["family"], {}), **cs.MEM_WIDTHS)
    hps, _, _ = cs.mesh_inputs(case["family"], job["seed"], widths)
    hps = hps.replace(device=job["device"], **case["hps"])
    hps.validate()
    plan = mesh.make_mesh(hps)
    reg = obs.Registry()
    with obs.use_registry(reg):
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        loss, peak, saved = cs.memory_step(case["family"], job["seed"],
                                           job["device"], job["widths"],
                                           plan=plan)
        _sync(job)
        return dict(_rank_facts(), case=case["name"],
                    step_s=time.perf_counter() - t0, loss=loss,
                    peak_bytes=peak, saved_bytes=saved.bytes,
                    saved_shapes=saved.shapes, launches=ops.launch_counts(),
                    bytes=collectives.counted_bytes(hps))


def run_serve(case, work, job):
    """A ServingServer on the mesh over the ROUGE phase's trained
    pointer-generator (every rank builds it; the chief serves the
    continuous phase's bimodal articles, the other rank follows): the
    chief's summaries, and each rank's launches, engine steps, seconds
    and bytes."""
    from textsummarization_on_flink_tpu_torch import obs, ops
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.parallel import collectives
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )

    hps, vocab, rows = cs.mesh_serve_inputs(
        job["seed"], job["widths"].get("pointer_generator"))
    hps = hps.replace(device=job["device"], **case["hps"])
    rows = rows[:case["requests"]]
    params = ckpt_lib._unflatten_dicts(ckpt_lib.load_arrays(
        os.path.join(work, "decode_params.npz")))["params"]
    reg = obs.Registry()
    with obs.use_registry(reg):
        server = ServingServer(hps, vocab, params=params, registry=reg,
                               decode_root=os.path.join(work, "serve_" + case[
                                   "name"]))
        engine = server._cont._engine if server._cont is not None else None
        cs.reset_launch_counts()
        steps0 = beam_search.steps_run
        _sync(job)
        t0 = time.perf_counter()
        out = dict(_rank_facts(), case=case["name"])
        if server._decoder.plan.is_chief:
            server.start()
            try:
                server.submit(rows[0][1], uuid="greedy", tier="greedy")
                out["greedy"] = "accepted"
            except ValueError as e:
                out["greedy"] = str(e)
            futs = [server.submit(r[1], uuid=r[0], reference=r[3],
                                  block=True) for r in rows]
            out["words"] = {f.uuid: f.result(timeout=900).decoded_words
                            for f in futs}
            server.stop()
            out["arena_alloc_failures"] = reg.counter(
                "serve/arena_alloc_failures_total").value
        else:
            out["ops"] = server.follow()
        _sync(job)
        out.update(seconds=time.perf_counter() - t0,
                   launches=ops.launch_counts(),
                   beam_steps=beam_search.steps_run - steps0,
                   bytes=collectives.counted_bytes(hps))
        if engine is not None:
            out["local_slots"] = engine._local
    return out


def main_cases(work, job_name="job.json"):
    from textsummarization_on_flink_tpu_torch.device import resolve_device
    from textsummarization_on_flink_tpu_torch.parallel import distributed

    with open(os.path.join(work, job_name), encoding="utf-8") as f:
        job = json.load(f)
    resolve_device(job["device"])  # TF32 off, as every entry point does
    distributed.initialize(device=job["device"])
    me = distributed.rank()
    for case in job["cases"]:
        fn = dict(train=run_train, decode=run_decode, search=run_search,
                  model_search=run_model_search, memory=run_memory,
                  serve=run_serve)[case["kind"]]
        res = fn(case, work, job)
        _dump(os.path.join(work, f"{case['name']}.rank{me}.json"), res)
        distributed.barrier(case["name"])
    distributed.destroy()
    return 0


class _Restores(logging.Handler):
    """The cli's "rank R restored training from step S (params F)"."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if "restored training from step" in msg:
            self.lines.append(msg)


def main_cli(argv):
    from textsummarization_on_flink_tpu_torch import cli, ops
    from textsummarization_on_flink_tpu_torch.config import HParams

    hps = HParams.from_argv(argv)
    handler = _Restores()
    cli_log = logging.getLogger("textsummarization_on_flink_tpu_torch.cli")
    cli_log.setLevel(logging.INFO)
    cli_log.addHandler(handler)
    rank = int(os.environ["RANK"])
    t0 = time.perf_counter()
    rc = cli.main(argv)
    _dump(os.path.join(hps.log_root,
                       f"cli.rank{rank}.steps{hps.num_steps}.json"),
          dict(rank=rank, rc=rc, wall_s=time.perf_counter() - t0,
               launches=ops.launch_counts(), restores=handler.lines))
    return rc


def main_app(work):
    """App.main on the mesh (torchrun sets the world; the pipeline joins
    it): chip_smoke.mesh_app_inputs' 2 fit steps and 4-row transform;
    this rank's rows, launches and seconds."""
    from textsummarization_on_flink_tpu_torch import ops
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.pipeline import app as app_lib
    from textsummarization_on_flink_tpu_torch.pipeline import io

    with open(os.path.join(work, "app.json"), encoding="utf-8") as f:
        job = json.load(f)
    train_hps, infer_hps, words, train_rows, infer_rows = cs.mesh_app_inputs(
        job["root"], job["seed"], job["device"], job["widths"],
        **job["mesh"])
    rank = int(os.environ["RANK"])
    app = app_lib.App(train_hps, infer_hps, vocab=Vocab(words=words))
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    sink = app.main(train_source=io.CollectionSource(train_rows),
                    infer_source=io.CollectionSource(infer_rows),
                    sink=io.CollectionSink())
    _dump(os.path.join(work, f"app.rank{rank}.json"), dict(
        rank=rank, wall_s=time.perf_counter() - t0,
        launches=ops.launch_counts(), rows=sorted(sink.rows)))
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "case":
        sys.exit(main_cases(*sys.argv[2:4]))
    if sys.argv[1] == "app":
        sys.exit(main_app(sys.argv[2]))
    sys.exit(main_cli(sys.argv[2:]))
