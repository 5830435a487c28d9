"""The port's collectives: the one module that calls ``torch.distributed``.

The JAX package lets GSPMD insert its collectives; the port writes them
out, in the Megatron form, as autograd ``Function``s over the process
groups of a ``parallel.mesh.MeshPlan``:

  * ``copy_to_tp``: forward the identity, backward an all-reduce over tp
    (the input of a vocab- or head-sharded product, whose gradient each
    tp rank holds a part of);
  * ``reduce_from_tp``: forward an all-reduce over tp, backward the
    identity (the output of a row-sharded product, or of the masked
    vocab-parallel embedding);
  * ``gather_vocab``: forward an all-gather over tp along the last
    (vocab) axis; the backward takes the rank's own slice, because the
    computation after the gather is the same on every tp rank;
  * ``gather_sp``: the same gather over sp along the encoder's time
    axis, whose backward is a reduce-scatter: the sharded trainer gives
    each sp rank 1/sp of the objective (parallel/mesh.py), so every
    leaf's gradient is a part over sp and all of them are summed;
    ``sp_block_of`` takes this rank's block of a whole tensor (its
    gradient zero elsewhere: each rank's block is its own);
  * the pointer-generator's attention over sp blocks
    (ops/fused_attention.py): ``merge_sp_blocks`` all-gathers each
    rank's (row max, row sum, context) over sp, and
    ``FusedAttentionSP``'s backward all-reduces (g_ctx, the block's
    sum of attn . g_attn) over sp;
  * ``all_to_all_sp`` (Ulysses) and ``ring_pass`` (ring attention's
    neighbour exchange), and the plain all-reduce, all-gather and
    broadcast of the trainer's gradients, metrics and batches;
  * serving on a mesh (decode/decoder.py, serve/mesh.py): ``command``,
    the chief's stream of ops to every rank; ``all_ok``, the ranks'
    agreement that an op succeeded everywhere; ``send_between``, a
    prefilled article's state to the dp index that packs it and an
    unpacked result to the chief, as tensors.

Model code reaches the mesh through ``bound(plan)``, a context the
sharded steps enter around the model's forward (the counterpart of the
JAX package's ``ring_attention.mesh_context``); outside it, and on a mesh
whose axis has one rank, every function here is the identity and the
model runs its single-device arithmetic unchanged.  A ``Function``
keeps its plan on ``ctx``: a backward runs on autograd's own thread.

Under NCCL device tensors go straight to the collective.  Under gloo a
CUDA operand goes through pinned host memory explicitly (gloo's CUDA
support covers broadcast and all-reduce only), and a CPU operand
straight; every call adds its bytes to
``parallel/collective_bytes_total{op,axis}`` of the plan's obs registry
(the full tensor a rank contributes or receives: the operand of an
all-reduce, broadcast, send or all-to-all, the gathered output of an
all-gather, the full input of a reduce-scatter), and the staging copies
add theirs, both ways, to ``parallel/host_staged_bytes_total``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import pickle
from typing import Any, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from textsummarization_on_flink_tpu_torch import obs

_PLAN: contextvars.ContextVar = contextvars.ContextVar("mesh_plan",
                                                       default=None)


@contextlib.contextmanager
def bound(plan: Any) -> Iterator[Any]:
    """Model code in this block runs on ``plan``'s mesh."""
    token = _PLAN.set(plan)
    try:
        yield plan
    finally:
        _PLAN.reset(token)


def current() -> Any:
    """The bound plan, or None."""
    return _PLAN.get()


def axis_size(axis: str, plan: Any = None) -> int:
    plan = plan if plan is not None else current()
    return 1 if plan is None else plan.size(axis)


def tp_size() -> int:
    return axis_size("tp")


def _active(plan: Any, axis: str) -> bool:
    return plan is not None and plan.size(axis) > 1


# --------------------------------------------------------------------------
# Accounting and staging
# --------------------------------------------------------------------------

def _count(plan: Any, op: str, axis: str, nbytes: int) -> None:
    obs.registry_for(plan.hps).counter(
        "parallel/collective_bytes_total").labels(op=op, axis=axis).inc(
        float(nbytes))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_wire(plan: Any, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: a pinned host copy of a CUDA
    tensor under gloo, a device copy of a CPU tensor under NCCL, else
    ``t`` itself (contiguous)."""
    t = t.contiguous()
    if plan.backend == "gloo" and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        obs.registry_for(plan.hps).counter(
            "parallel/host_staged_bytes_total").inc(float(_nbytes(t)))
        return host
    if plan.backend == "nccl" and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _from_wire(plan: Any, w: torch.Tensor, like: torch.Tensor,
               ) -> torch.Tensor:
    """A wire tensor back on ``like``'s device."""
    if w.device == like.device:
        return w
    if plan.backend == "gloo" and like.is_cuda:
        obs.registry_for(plan.hps).counter(
            "parallel/host_staged_bytes_total").inc(float(_nbytes(w)))
    return w.to(like.device)


def _wire_empty(plan: Any, shape, dtype, like: torch.Tensor) -> torch.Tensor:
    """An output buffer on the wire's device."""
    if plan.backend == "gloo":
        return torch.empty(shape, dtype=dtype, pin_memory=like.is_cuda)
    return torch.empty(shape, dtype=dtype,
                       device=torch.device("cuda",
                                           torch.cuda.current_device()))


# --------------------------------------------------------------------------
# Plain collectives (no autograd)
# --------------------------------------------------------------------------

def all_reduce(plan: Any, t: torch.Tensor, axis: str, op: str = "sum",
               ) -> torch.Tensor:
    """A new tensor: ``t`` summed (or maxed, ``op="max"``) over ``axis``;
    ``t`` itself on an axis of one rank."""
    if not _active(plan, axis):
        return t
    w = _to_wire(plan, t)
    if w is t:
        w = t.clone()
    rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    dist.all_reduce(w, op=rop, group=plan.group(axis))
    _count(plan, "all_reduce", axis, _nbytes(t))
    return _from_wire(plan, w, t)


def all_gather(plan: Any, t: torch.Tensor, axis: str, dim: int = 0,
               ) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    if not _active(plan, axis):
        return t
    n = plan.size(axis)
    w = _to_wire(plan, t)
    out = _wire_empty(plan, (n * t.numel(),), t.dtype, t)
    dist.all_gather_into_tensor(out, w.reshape(-1), group=plan.group(axis))
    _count(plan, "all_gather", axis, _nbytes(out))
    parts = out.reshape((n,) + tuple(t.shape)).unbind(0)
    return _from_wire(plan, torch.cat(parts, dim=dim), t)


def reduce_scatter(plan: Any, t: torch.Tensor, axis: str, dim: int,
                   ) -> torch.Tensor:
    """``t`` summed over ``axis`` and cut into equal blocks along
    ``dim``; the rank's own block."""
    if not _active(plan, axis):
        return t
    n = plan.size(axis)
    blocks = torch.stack(t.chunk(n, dim=dim)).contiguous()
    w = _to_wire(plan, blocks)
    out = _wire_empty(plan, (blocks[0].numel(),), t.dtype, t)
    dist.reduce_scatter_tensor(out, w.reshape(-1), group=plan.group(axis))
    _count(plan, "reduce_scatter", axis, _nbytes(t))
    return _from_wire(plan, out.reshape(blocks.shape[1:]), t)


def broadcast(plan: Any, t: torch.Tensor, axis: str) -> torch.Tensor:
    """The first rank of this rank's ``axis`` group's ``t``, on every rank
    of the group (``t``'s shape and dtype on all of them)."""
    if not _active(plan, axis):
        return t
    w = _to_wire(plan, t)
    if w is t:
        w = t.clone()
    dist.broadcast(w, src=plan.members(axis)[0], group=plan.group(axis))
    _count(plan, "broadcast", axis, _nbytes(t))
    return _from_wire(plan, w, t)


def broadcast_arrays(plan: Any, arrays: dict, axis: str) -> dict:
    """A dict of tensors, each broadcast from the group's first rank."""
    return {k: broadcast(plan, v, axis) for k, v in arrays.items()}


def broadcast_object(plan: Any, obj: Any, axis: str = "world") -> Any:
    """A picklable object of the group's first rank on every rank (the
    decoder's batches, whose shape only that rank knows).  Only ranks of
    this program pickle what is unpickled here."""
    if not _active(plan, axis):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=plan.members(axis)[0],
                               group=plan.group(axis))
    return box[0]


def command(plan: Any, cmd: Any = None) -> Any:
    """The chief's command stream: the chief passes ``cmd`` (a small
    picklable tuple naming one op and its host arguments) and every rank
    returns it, in the order the chief sent them.  Pickled into a byte
    tensor and broadcast over the world (its length first), counted as
    ``command/world``; tensors go through ``send_between`` or the
    gathers, never through here."""
    if not _active(plan, "world"):
        return cmd
    src = plan.members("world")[0]
    chief = plan.rank == src
    if chief:
        data = torch.frombuffer(bytearray(pickle.dumps(cmd)),
                                dtype=torch.uint8)
        n = torch.tensor([data.numel()], dtype=torch.int64)
    else:
        n = torch.zeros(1, dtype=torch.int64)
    w = _to_wire(plan, n)
    dist.broadcast(w, src=src, group=plan.group("world"))
    if not chief:
        data = torch.empty(int(w.cpu()[0]), dtype=torch.uint8)
    w = _to_wire(plan, data)
    dist.broadcast(w, src=src, group=plan.group("world"))
    _count(plan, "command", "world", 8 + data.numel())
    # only ranks of this program pickle what is unpickled here
    return cmd if chief else pickle.loads(w.cpu().numpy().tobytes())


def all_ok(plan: Any, ok: bool) -> bool:
    """True when ``ok`` holds on every rank of the world: the lockstep
    ops' failure agreement, so that one rank's error reaches the others
    before they wait on it in a collective."""
    if not _active(plan, "world"):
        return ok
    w = _to_wire(plan, torch.tensor([0 if ok else 1], dtype=torch.int32))
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=plan.group("world"))
    _count(plan, "all_reduce", "world", 4)
    return int(w.cpu()[0]) == 0


def send_between(plan: Any, tensors: Optional[Sequence[torch.Tensor]],
                 axis: str, src: int, dst: int,
                 like: Optional[Sequence[torch.Tensor]] = None,
                 ) -> Optional[List[torch.Tensor]]:
    """Tensors from the rank at ``src`` along ``axis`` to the rank at
    ``dst`` of the same group (point to point, the staged path under
    gloo): the sender passes ``tensors`` and gets them back, the receiver
    passes ``like`` (tensors of the shapes, dtypes and device to receive
    into) and gets what was sent; every other rank of the group takes no
    part and gets None.  Counted as ``send_recv/<axis>`` on both ends."""
    if src == dst or not _active(plan, axis):
        return list(tensors) if tensors is not None else None
    me = plan.coord(axis)
    members = plan.members(axis)
    if me == src:
        for t in tensors:
            dist.send(_to_wire(plan, t), dst=members[dst],
                      group=plan.group(axis))
            _count(plan, "send_recv", axis, _nbytes(t))
        return list(tensors)
    if me != dst:
        return None
    out = []
    for t in like:
        w = _wire_empty(plan, tuple(t.shape), t.dtype, t)
        dist.recv(w, src=members[src], group=plan.group(axis))
        _count(plan, "send_recv", axis, _nbytes(t))
        out.append(_from_wire(plan, w, t))
    return out


def with_own_world(plan: Any) -> Any:
    """``plan`` with a world group of its own (collective: every rank
    calls it, in the same order), for a stream of collectives another
    thread issues while the plan's own groups are in use."""
    if not _active(plan, "world"):
        return plan
    members = plan.members("world")
    groups = dict(plan.groups, world=(dist.new_group(list(members)),
                                      members))
    return dataclasses.replace(plan, groups=groups)


def agree_any(flag: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """``flag`` (a bool tensor) true on any rank of the bound plan's
    ``axis``: the beam search's loop test, so the ranks of one tp group,
    which exchange scores every step, leave the loop together."""
    plan = current()
    if not _active(plan, axis):
        return flag
    return all_reduce(plan, flag.to(torch.int32), axis, op="max") > 0


def ring_pass(plan: Any, t: torch.Tensor, axis: str = "sp") -> torch.Tensor:
    """Send ``t`` to the next rank of the ring over ``axis`` and return
    what the previous rank sent (one ``batch_isend_irecv``)."""
    if not _active(plan, axis):
        return t
    w = _to_wire(plan, t)
    recv = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, plan.peer(axis, +1), plan.group(axis)),
           dist.P2POp(dist.irecv, recv, plan.peer(axis, -1),
                      plan.group(axis))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count(plan, "send_recv", axis, _nbytes(t))
    return _from_wire(plan, recv, t)


def _all_to_all(plan: Any, t: torch.Tensor, axis: str) -> torch.Tensor:
    """all_to_all_single over ``axis`` of ``t`` [n, ...]: block j goes to
    rank j, and block i of the result came from rank i."""
    w = _to_wire(plan, t)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=plan.group(axis))
    _count(plan, "all_to_all", axis, _nbytes(t))
    return _from_wire(plan, out, t)


# --------------------------------------------------------------------------
# Autograd collectives (the Megatron forms)
# --------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.plan, g, "tp"), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        return all_reduce(plan, x, "tp")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """all-gather along ``dim``; the backward is the rank's own slice
    (``scatter=False``) or a reduce-scatter (``scatter=True``)."""

    @staticmethod
    def forward(ctx, x, plan, axis, dim, scatter):
        ctx.plan, ctx.axis, ctx.dim, ctx.scatter = plan, axis, dim, scatter
        ctx.block = x.shape[dim]
        return all_gather(plan, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        plan, axis, dim = ctx.plan, ctx.axis, ctx.dim
        if ctx.scatter:
            d = reduce_scatter(plan, g, axis, dim)
        else:
            d = g.narrow(dim, plan.coord(axis) * ctx.block,
                         ctx.block).contiguous()
        return d, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """reduce-scatter along ``dim``; the backward all-gathers (the summed
    parts' gradient is the whole one on every rank)."""

    @staticmethod
    def forward(ctx, x, plan, axis, dim):
        ctx.plan, ctx.axis, ctx.dim = plan, axis, dim
        return reduce_scatter(plan, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(ctx.plan, g.contiguous(), ctx.axis, ctx.dim), \
            None, None, None


class _AllToAll(torch.autograd.Function):
    """all_to_all_single with equal blocks: its own adjoint."""

    @staticmethod
    def forward(ctx, x, plan, axis):
        ctx.plan, ctx.axis = plan, axis
        return _all_to_all(plan, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.plan, g, ctx.axis), None, None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    plan = current()
    return _CopyToTP.apply(x, plan) if _active(plan, "tp") else x


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    plan = current()
    return _ReduceFromTP.apply(x, plan) if _active(plan, "tp") else x


def gather_vocab(x: torch.Tensor) -> torch.Tensor:
    """[..., V/tp] vocab-sharded scores -> [..., V] on every tp rank."""
    plan = current()
    if not _active(plan, "tp"):
        return x
    return _Gather.apply(x, plan, "tp", x.dim() - 1, False)


def reduce_scatter_tp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The tp ranks' parts of ``x`` summed, this rank's block along
    ``dim``; the backward all-gathers."""
    plan = current()
    if not _active(plan, "tp"):
        return x
    return _ReduceScatter.apply(x, plan, "tp", dim)


def gather_sp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sp blocks of ``x`` along ``dim`` joined on every sp rank; the
    backward reduce-scatters (see the module docstring)."""
    plan = current()
    if not _active(plan, "sp"):
        return x
    return _Gather.apply(x, plan, "sp", dim, True)


def gather_sp_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``gather_sp`` of a tensor that carries no gradient (ids, masks)."""
    plan = current()
    return all_gather(plan, x, "sp", dim) if _active(plan, "sp") else x


def sp_block_of(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This sp rank's block of ``x`` along ``dim`` (equal blocks in rank
    order; a view), or ``x`` off an sp mesh.  The gradient of the rest is
    zero: each rank's block is its own."""
    plan = current()
    if not _active(plan, "sp"):
        return x
    n = x.shape[dim] // plan.size("sp")
    return x.narrow(dim, plan.coord("sp") * n, n)


def all_to_all_sp(x: torch.Tensor) -> torch.Tensor:
    """Differentiable all_to_all over sp of ``x`` [sp, ...]."""
    plan = current()
    return _AllToAll.apply(x, plan, "sp") if _active(plan, "sp") else x


# --------------------------------------------------------------------------
# The model's sharded pieces
# --------------------------------------------------------------------------

def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  Under tp the table holds this rank's V/tp rows:
    ids outside them look up zeros and the rows are summed over tp
    (exactly one rank holds each id, so the sum is exact)."""
    plan = current()
    if not _active(plan, "tp"):
        return table[ids]
    n = table.shape[0]
    local = ids - plan.coord("tp") * n
    ok = (local >= 0) & (local < n)
    rows = table[torch.where(ok, local, torch.zeros_like(local))]
    return reduce_from_tp(torch.where(ok[..., None], rows,
                                      torch.zeros_like(rows)))


def head_mean(probs: torch.Tensor, dim: int, num_heads: int) -> torch.Tensor:
    """The mean over all ``num_heads`` heads of head-sharded ``probs``
    (this rank's ceil(num_heads / tp) heads on ``dim``).  Where tp does
    not divide num_heads the last ranks' trailing heads are zero pad
    heads (sharding.pad_heads), whose softmax is uniform over the keys,
    not zero: only this rank's real heads enter the sum."""
    plan = current()
    if not _active(plan, "tp"):
        return torch.mean(probs, dim=dim)
    held = probs.shape[dim]
    real = min(max(num_heads - plan.coord("tp") * held, 0), held)
    return reduce_from_tp(torch.sum(probs.narrow(dim, 0, real),
                                    dim=dim)) / num_heads


def dp_share(count: torch.Tensor) -> torch.Tensor:
    """A global count as this dp rank's share, sum over dp / dp: a loss
    normalised by it is, averaged over dp, the loss of the global batch
    normalised by the global count (the baseline cross-entropy)."""
    plan = current()
    if not _active(plan, "dp"):
        return count
    return all_gather(plan, count.detach().reshape(1), "dp").sum() / plan.dp


def flat_all_reduce(plan: Any, tensors: Sequence[torch.Tensor], axis: str,
                    dtype: Optional[torch.dtype] = None,
                    ) -> List[torch.Tensor]:
    """The tensors summed over ``axis`` in one all-reduce of their
    concatenation, carried in ``dtype`` (None: their own) and returned
    in their own dtype."""
    if not _active(plan, axis) or not tensors:
        return list(tensors)
    wire = dtype or tensors[0].dtype
    flat = torch.cat([t.reshape(-1).to(wire) for t in tensors])
    flat = all_reduce(plan, flat, axis)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def counted_bytes(hps: Any) -> dict:
    """{"<op>/<axis>": bytes} of ``parallel/collective_bytes_total`` in
    ``hps``'s obs registry, and "host_staged" for
    ``parallel/host_staged_bytes_total``."""
    reg = obs.registry_for(hps)
    out = {}
    for child in reg.counter("parallel/collective_bytes_total"
                             ).label_children():
        kv = dict(child.labels_kv)
        out[f"{kv['op']}/{kv['axis']}"] = child.value
    out["host_staged"] = reg.counter("parallel/host_staged_bytes_total").value
    return out
