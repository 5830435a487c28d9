"""Spawn the port's ranks for the mesh tests (tests/test_torch_mesh_*.py,
test_torch_sp_attention.py, test_torch_multiprocess.py).

``run_ranks(workdir, world, cases)`` writes ``job.json`` and starts
``world`` processes of tests/_torch_mesh_worker.py with torchrun's
environment on a free port (as tests/test_multiprocess.py picks one);
each joins a gloo world on the CPU.  A rank that fails, or a world that
does not finish within ``timeout`` seconds (a hung collective), fails the
test with the ranks' output.  Inputs go in as npz files written with
``save_npz``; results come back as the files the worker writes."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from textsummarization_on_flink_tpu_torch.checkpoint import checkpointer

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_mesh_worker.py")
_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    pypath = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([_REPO] + pypath)
    return env


def save_npz(workdir, name, arrays) -> str:
    np.savez(os.path.join(str(workdir), name + ".npz"), **arrays)
    return name


def save_params(workdir, name, params) -> str:
    """A numpy params tree as the worker reads it."""
    return save_npz(workdir, name, checkpointer._flatten(params, "params"))


def run_ranks(workdir, world, cases, timeout=150.0):
    workdir = str(workdir)
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump({"cases": cases}, f)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, _WORKER, workdir],
                              env=rank_env(r, world, port),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("mesh ranks hung (a collective out of step?):\n"
                    + "\n---\n".join((p.communicate()[0] or "")[-3000:]
                                     for p in procs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}:\n{out[-6000:]}"
    return [json.load(open(os.path.join(workdir, f"done.rank{r}")))
            for r in range(world)]


def load_npz(workdir, name) -> dict:
    with np.load(os.path.join(str(workdir), name + ".npz")) as z:
        return {k: z[k] for k in z.files}


def load_json(workdir, name) -> dict:
    with open(os.path.join(str(workdir), name + ".json")) as f:
        return json.load(f)


def params_of(flat) -> dict:
    """The params subtree of a flat checkpoint dict (numpy)."""
    return checkpointer._unflatten_dicts(flat)["params"]
