"""Process-group bring-up: one process per rank on ``torch.distributed``.

Port of the JAX package's parallel/distributed.py.  JAX runs its whole
mesh from one process over many devices and ``jax.distributed`` is the
rendezvous of hosts; PyTorch runs one process per rank, so here every
rank of the (dp, tp, sp) mesh is a process and ``initialize`` joins it to
the world's process group.  With no arguments it reads torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), the
counterpart of JAX's auto-detect, and it is a no-op at world 1, as JAX's
is.  The entry point is

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m textsummarization_on_flink_tpu_torch --dp=... --tp=... --sp=...

Each rank takes the card ``cuda:(LOCAL_RANK % device_count)``, or the
CPU when the caller asks for it.  The backend follows from that layout,
decided before ``init_process_group`` and never swapped after a failure:

  * NCCL when every local rank has a card of its own;
  * gloo when local ranks share a card (NCCL refuses two ranks of one
    communicator on one device: its "Duplicate GPU detected" check), or
    on the CPU.  Under gloo a CUDA operand goes through pinned host
    memory (parallel/collectives.py), so ranks that share a card run
    right but their collectives are host copies, not a speed.

``backend="nccl"`` with two local ranks on one card raises here, naming
the cause, before NCCL's own error.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

#: what ``initialize`` chose, read back by ``backend()`` and
#: ``rank_layout()``
_LAYOUT: Optional["RankLayout"] = None

#: how long a collective may wait for its peers before the process group
#: raises (a rank that died or fell out of step)
TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """One rank's place: its global and local rank, the world's and the
    node's rank counts, its device and the backend."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    device: str  # "cuda:<i>" or "cpu"
    backend: str  # "nccl" or "gloo"

    @property
    def ranks_per_device(self) -> int:
        """Local ranks that share this rank's device (all of them on the
        CPU)."""
        if self.device == "cpu":
            return self.local_world_size
        n_dev = max(torch.cuda.device_count(), 1)
        return -(-self.local_world_size // n_dev)


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else default


def choose_backend(device: str, local_world_size: int,
                   device_count: int) -> str:
    """The backend of a layout: NCCL when each of the ``local_world_size``
    ranks of this node has a card of its own, gloo when they share cards
    or run on the CPU."""
    if device == "cpu" or local_world_size > device_count:
        return "gloo"
    return "nccl"


def check_backend(backend: Optional[str], device: str,
                  local_world_size: int, device_count: int) -> str:
    """The backend asked for (``choose_backend``'s when None), or a
    ValueError naming why the layout cannot take it."""
    chosen = choose_backend(device, local_world_size, device_count)
    if backend is None:
        return chosen
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and device == "cpu":
        raise ValueError("backend='nccl' needs CUDA devices; ranks on the "
                         "CPU run over gloo")
    if backend == "nccl" and chosen == "gloo":
        raise ValueError(
            f"backend='nccl' needs a card per rank: {local_world_size} local "
            f"ranks on {device_count} device(s) would put two ranks of one "
            f"communicator on one device, which NCCL refuses (\"Duplicate "
            f"GPU detected\"); use gloo, which the layout picks when "
            f"backend is None")
    return backend


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: str = "cuda") -> Optional[RankLayout]:
    """Join this process to the world's process group (idempotent).

    Arguments left None come from torchrun's environment:
    ``coordinator_address`` ("host:port") from MASTER_ADDR/MASTER_PORT,
    ``num_processes`` from WORLD_SIZE, ``process_id`` from RANK.  A world
    of one with no ``backend`` asked for is a no-op returning None; an
    explicit ``backend`` brings up even a world of one (a proof that the
    backend builds and runs).  ``device="cpu"`` runs the rank on the CPU
    (gloo).  Returns the rank's layout."""
    global _LAYOUT
    if dist.is_available() and dist.is_initialized():
        return _LAYOUT
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE", 1)
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    if world <= 1 and backend is None:
        log.info("single-process run; no process group")
        return None
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device=cpu on the command line) to run the ranks on "
                "the CPU")
        n_dev = torch.cuda.device_count()
        dev = f"cuda:{local_rank % n_dev}"
    elif device == "cpu":
        n_dev = 0
        dev = "cpu"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    chosen = check_backend(backend, dev, local_world, n_dev)
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init_method = "env://"
    else:
        raise RuntimeError(
            f"a world of {world} ranks needs a rendezvous: run under "
            f"torchrun (MASTER_ADDR/MASTER_PORT) or pass "
            f"coordinator_address='host:port'")
    dist.init_process_group(
        backend=chosen, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _LAYOUT = RankLayout(rank=rank, world_size=world, local_rank=local_rank,
                         local_world_size=local_world, device=dev,
                         backend=chosen)
    log.info("torch.distributed up: rank %d/%d on %s over %s (%d rank(s) "
             "per device)", rank, world, dev, chosen,
             _LAYOUT.ranks_per_device)
    return _LAYOUT


def backend() -> Optional[str]:
    """The backend ``initialize`` chose, or None with no process group."""
    return _LAYOUT.backend if _LAYOUT is not None else None


def rank_layout() -> Optional[RankLayout]:
    """This rank's layout, or None with no process group."""
    return _LAYOUT


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_chief() -> bool:
    """The rank that writes checkpoints and summaries (the reference's
    ``is_chief=True`` MonitoredTrainingSession role, train.py:74-81)."""
    return rank() == 0


def barrier(name: str = "barrier") -> None:
    """A sync point of every rank (around checkpoint save and restore);
    a no-op without a process group."""
    if not _initialized():
        return
    log.debug("barrier %s", name)
    if backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def destroy() -> None:
    """Leave the process group (idempotent)."""
    global _LAYOUT
    if _initialized():
        dist.destroy_process_group()
    _LAYOUT = None
