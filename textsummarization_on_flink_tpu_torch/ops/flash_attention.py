"""Flash self-attention: the CUDA kernel and its plain version.

Port of the library Pallas kernel the JAX package's transformer calls
for self-attention (``jax.experimental.pallas.ops.tpu.flash_attention``,
called at models/transformer.py:285).  Per article, head and query row,

    s_j  = (q . k_j) * sm_scale     for the keys the row may attend
    out  = sum_j softmax(s)_j v_j

where a row may attend key j when ``key_mask[j] > 0`` and, if
``causal``, j <= the row's position.  This is exactly what the einsum
path ``_mha`` computes for self-attention (transformer.py:149-180, masks
built at :291-295): masked logits at -1e30, a softmax in f32, and a row
with no key to attend gives zeros.  Every query row attends the real
keys, padding rows included; the JAX flash branch's SegmentIds instead
let a padding query attend the padding keys.  Only padding rows differ
between the two, and the cross-attention masks those rows out, so the
tokens do not change.

q is [B, Tq, nh, hd], k and v [B, Tk, nh, hd] (the layout
``_split_heads`` gives, so no transposes), all float32 or all bfloat16,
key_mask [B, Tk] float32 (1 = real token) or None (every key real); the
output is the context [B, Tq, nh, hd] before ``wo``, in the inputs'
dtype.  Tq = Tk is self-attention; Tq < Tk is one sp rank's block of the
encoder's queries against every key (the transformer's and the AAN's
encoder on an sp mesh without --sp_attention, models/transformer.py),
and takes no ``causal``: a causal call with Tq != Tk raises ValueError
(no path of either package makes one).

bfloat16 (the transformer under ``--compute_dtype=bfloat16``, whose JAX
package hands bf16 q, k, v to the library kernel) rounds where the
library rounds (flash_attention.py of the installed jax): S from bf16
values with f32 sums (:396), P = exp(S - m) in f32 rounded to bf16
before P V with f32 sums (:471), the output rounded once to bf16, lse in
f32; in the backward D = rowsum(dO * O) in f32 (:273-275), P rounded to
bf16 for dV = P^T dO (:900), dP = dO V^T with f32 sums, dS = P (dP - D)
* sm_scale rounded to bf16 for dK and dQ (:918, :1258), each gradient
rounded once to bf16.  The plain versions form those products from f32
copies of the bf16 values (exact products, f32 sums), never from CPU
bf16 GEMMs, whose internal rounding is the library's own; the kernels
multiply bf16 on the tensor cores with f32 accumulators (the forward,
dK/dV and dQ kernels all with Hopper's ``wgmma`` on tiles copied by
TMA, behind the same entry points).  A bf16 row rounds P
against the online softmax's running max in the kernel and against the
row max in the plain version, so the two differ by about a bf16 ulp of
P.

Training differentiates through ``FlashAttention``, a
``torch.autograd.Function``: its forward also writes each row's
log-sum-exp ``lse`` [B, Tq, nh] (+inf for a row with no key to attend),
and its backward computes ``D = rowsum(dO * O)`` in PyTorch, as the
library does outside its kernels (flash_attention.py:273-275 of the
installed jax), then launches the dK/dV kernel and the dQ kernel
(kernels/flash_attention_bwd.cu; the library's
``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``).
``_flash_bwd_plain`` is the explicit backward formula in plain PyTorch,
the plain version of both backward kernels.

Head dims: the kernels of flash_attention.cu and flash_attention_bwd.cu
are built for 32, 128 and 256 (at 256 each kernel splits its output's
columns over two blocks; see the sources); those of
flash_attention_wide.cu take any multiple of 128 and run every head dim
above 256: up to 2048 the forward, dK/dV and dQ (the library's rule,
``ts_flash_wide_form``) are a thread block cluster of hd / 128 blocks
on the tensor cores, each block a 128-column slab, their partial S (and
dP) summed over the cluster once per tile; above 2048, up to 8192, the
forward, dK/dV and dQ are clusters of at most 16 blocks each owning 2
to 4 slabs (``_wide_geometry``; one kernel launch per output slab a
block owns, inside the one C call), and above 8192 every kind is a
SIMT kernel that keeps one 128-column slab of the output a block and
forms S over the whole head dim in 32-column chunks (``simt=True``
takes the SIMT kernels for the forward, dK/dV and dQ at any wide head
dim, to time the cluster forms against them). On the
card any other head dim is zero-padded to the next of 32, 128, 256 or,
above 256, to the next multiple of 128 on the way in (q, k, v, and for
the backward out and dO) and the outputs and gradients are sliced back:
zero columns add nothing to q . k, give zero output columns and zero
gradient columns, and ``sm_scale`` is passed by the caller from the true
head dim (the JAX package pads the same way for the library kernel,
models/transformer.py:262-272). No head dim is refused.

Dispatch: a CPU tensor goes to the plain versions; a CUDA tensor goes to
the kernels (kernels/flash_attention.cu, kernels/flash_attention_bwd.cu,
above head dim 256 kernels/flash_attention_wide.cu; f32 tensors to their
f32 forms, bf16 tensors to their bf16 forms, a mix raises), or the
wrapper raises.  There is no fallback from one to the other.
``launches``, ``launches_bwd_dkv`` and ``launches_bwd_dq`` count kernel
launches of every form (one a call, but a multi-slab cluster form's
call launches its kernel once per slab a block owns:
``_wide_launches``), ``launches_bf16``, ``launches_bwd_dkv_bf16`` and
``launches_bwd_dq_bf16`` those of the bf16 forms, ``launches_wide``,
``launches_bwd_dkv_wide`` and ``launches_bwd_dq_wide`` those of the wide
kernels (either dtype), ``launches_wide_cluster``,
``launches_bwd_dkv_wide_cluster`` and ``launches_bwd_dq_wide_cluster``
those of the wide kernels' cluster forms (the form each call took, as
the library reports it: ``_wide_launches``), ``launches_block``,
``launches_bwd_dkv_block``
and ``launches_bwd_dq_block`` those on a block of query rows shorter
than the keys (Tq != Tk).  ``flash_attention`` takes the Function only
when a gradient is needed; under ``torch.no_grad`` (serving) it
launches the forward alone, without ``lse``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from textsummarization_on_flink_tpu_torch.ops.fused_attention import _check

NEG = -1e30  # masked-logit floor (transformer._mha), never -inf

#: head dims the kernel is built for (the switch in ts_flash_attention);
#: the others up to the largest are zero-padded to the next one, those
#: above it to the next multiple of WIDE_STEP for the wide kernels
HEAD_DIMS = (32, 128, 256)
WIDE_STEP = 128

#: kernel launches so far (one per forward on CUDA tensors, one per
#: backward for each backward kernel; a multi-slab cluster form's call
#: launches its kernel once per slab), and of those the launches of the
#: bf16 forms; set them to 0 before a run whose launches are to be counted
launches = 0
launches_bwd_dkv = 0
launches_bwd_dq = 0
launches_bf16 = 0
launches_bwd_dkv_bf16 = 0
launches_bwd_dq_bf16 = 0
launches_wide = 0
launches_bwd_dkv_wide = 0
launches_bwd_dq_wide = 0
launches_wide_cluster = 0
launches_bwd_dkv_wide_cluster = 0
launches_bwd_dq_wide_cluster = 0
launches_block = 0
launches_bwd_dkv_block = 0
launches_bwd_dq_block = 0

#: the wide kernels' kinds as the C entries number them
WIDE_KINDS = ("fwd", "dkv", "dq")

#: the dtypes the kernels take (all of q, k, v, out and dO in one of them)
DTYPES = (torch.float32, torch.bfloat16)

_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None
_wide_lib: Optional[ctypes.CDLL] = None


def _allowed(key_mask: Optional[torch.Tensor], causal: bool, B: int,
             Tq: int, Tk: int, device) -> torch.Tensor:
    """[B, 1, Tq, Tk] boolean: may query row i attend key j.  Causal
    needs Tq == Tk (``_check_block`` refuses the rest)."""
    if key_mask is None:
        ok = torch.ones((B, 1, 1, Tk), dtype=torch.bool, device=device)
    else:
        ok = (key_mask > 0)[:, None, None, :]
    if causal:
        ok = ok & torch.ones((Tq, Tk), dtype=torch.bool, device=device).tril()
    return ok.expand(B, 1, Tq, Tk)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x widened to f32 if it is bf16 (exact), else x itself."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _check_block(q: torch.Tensor, k: torch.Tensor, causal: bool) -> None:
    """A query block shorter (or longer) than the keys is taken only
    without ``causal``: no path of either package asks for a causal
    block, and its diagonal would need the block's offset."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal flash attention needs as many query rows "
                         f"as keys, got Tq={q.shape[1]}, Tk={k.shape[1]}")


def _masked_logits(q, k, key_mask, causal, sm_scale):
    """([B, nh, Tq, Tk] scores at NEG where a row may not attend, the
    [B, 1, Tq, Tk] attend mask).  bf16 q and k are widened first: exact
    products, f32 sums."""
    _check_block(q, k, causal)
    B, Tq = q.shape[:2]
    logits = torch.einsum("bqnd,bknd->bnqk", _wide(q), _wide(k)) * sm_scale
    ok = _allowed(key_mask, causal, B, Tq, k.shape[1], q.device)
    return torch.where(ok, logits, NEG), ok


def _flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_mask: Optional[torch.Tensor], causal: bool,
                 sm_scale: float) -> torch.Tensor:
    """The einsum formula in plain PyTorch (the [B, nh, T, T] scores are
    materialised).  Returns [B, T, nh, hd] in q's dtype."""
    logits, ok = _masked_logits(q, k, key_mask, causal, sm_scale)
    row_ok = ok.any(dim=-1, keepdim=True)
    if q.dtype == torch.bfloat16:
        # the library's rounding: P = exp(s - m) rounded to bf16 for P V
        # (f32 sums), divided by the f32 sum of the unrounded P
        m = torch.amax(logits, dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp(logits - m), 0.0)
        l = torch.sum(p, dim=-1, keepdim=True)
        ctx = torch.einsum("bnqk,bknd->bnqd", p.to(torch.bfloat16).float(),
                           v.float())
        ctx = torch.where(row_ok, ctx / torch.where(row_ok, l, 1.0), 0.0)
        return ctx.transpose(1, 2).to(torch.bfloat16)
    probs = torch.softmax(logits, dim=-1)
    # a row with no key to attend: uniform over -1e30 logits -> zeros
    probs = torch.where(row_ok, probs, 0.0)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def _flash_lse_plain(q: torch.Tensor, k: torch.Tensor,
                     key_mask: Optional[torch.Tensor], causal: bool,
                     sm_scale: float) -> torch.Tensor:
    """Each row's log-sum-exp of its attended scores, [B, T, nh] float32;
    +inf for a row with no key to attend (the forward kernel's lse)."""
    logits, ok = _masked_logits(q, k, key_mask, causal, sm_scale)
    lse = torch.logsumexp(logits, dim=-1)  # [B, nh, T]
    lse = torch.where(ok.any(dim=-1), lse, float("inf"))
    return lse.transpose(1, 2).contiguous()


def _flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     key_mask: Optional[torch.Tensor], causal: bool,
                     sm_scale: float,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward formula in plain PyTorch, the plain version of both
    backward kernels: (dq, dk, dv), each [B, T, nh, hd] in q's dtype.

    P = exp(s - lse) on the pairs a row may attend (0 elsewhere, and on
    a whole row whose lse is +inf), D = rowsum(dO * O),
    dS = P * (dO . v - D); dv = P^T dO, dk = scale * dS^T q,
    dq = scale * dS k.  In bf16 (module docstring) D and dS are f32, P
    and scale * dS are rounded to bf16 before their products, and each
    gradient is rounded once."""
    logits, ok = _masked_logits(q, k, key_mask, causal, sm_scale)
    lse_r = lse.transpose(1, 2)[..., None]  # [B, nh, T, 1]
    row_ok = torch.isfinite(lse_r)
    p = torch.where(ok & row_ok, torch.exp(logits - torch.where(
        row_ok, lse_r, 0.0)), 0.0)
    if q.dtype == torch.bfloat16:
        qf, kf, vf, dof = (_wide(x) for x in (q, k, v, do))
        d = torch.sum(dof * _wide(out), dim=-1).transpose(1, 2)[..., None]
        dp = torch.einsum("bqnd,bknd->bnqk", dof, vf)
        ds = (p * (dp - d) * sm_scale).to(torch.bfloat16).float()
        pb = p.to(torch.bfloat16).float()
        dv = torch.einsum("bnqk,bqnd->bknd", pb, dof)
        dk = torch.einsum("bnqk,bqnd->bknd", ds, qf)
        dq = torch.einsum("bnqk,bknd->bqnd", ds, kf)
        return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))
    d = torch.sum(do * out, dim=-1).transpose(1, 2)[..., None]
    dp = torch.einsum("bqnd,bknd->bnqk", do, v)
    ds = p * (dp - d)
    dv = torch.einsum("bnqk,bqnd->bknd", p, do)
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q) * sm_scale
    dq = torch.einsum("bnqk,bknd->bqnd", ds, k) * sm_scale
    return dq, dk, dv


def _padded_head_dim(hd: int) -> int:
    """The head dim the kernels run at for a head dim of ``hd``: the next
    of HEAD_DIMS, or above them the next multiple of WIDE_STEP (the wide
    kernels')."""
    for width in HEAD_DIMS:
        if hd <= width:
            return width
    return -(-hd // WIDE_STEP) * WIDE_STEP


def _is_wide(width: int) -> bool:
    """Does a padded head dim run on the wide kernels."""
    return width > HEAD_DIMS[-1]


def _wide_geometry(kind: str, width: int) -> Tuple[int, int]:
    """(slabs a block owns, blocks of the cluster) of the cluster form the
    wide kernel ``kind`` ("fwd", "dkv" or "dq") takes at a padded head
    dim ``width`` above 256, as the library's own dispatch decides
    (``ts_flash_wide_form``): (1, width / 128) up to 2048, above it up to
    8192 (ceil(C / 16), ceil(C / slabs)), C = width / 128; (0, 0) for the
    SIMT form (every kind above 8192).  Raises ValueError where no wide
    kernel takes ``width``."""
    slabs, blocks = ctypes.c_int(), ctypes.c_int()
    form = _load_wide_library().ts_flash_wide_form(
        WIDE_KINDS.index(kind), width, ctypes.byref(slabs),
        ctypes.byref(blocks))
    if form < 0:
        raise ValueError(f"no wide flash kernel takes head dim {width}")
    return slabs.value, blocks.value


def _wide_launches(kind: str, width: int, simt: bool = False
                   ) -> Tuple[int, bool]:
    """(kernel launches, cluster form?) of one call of the wide kernel
    ``kind`` at a padded head dim ``width``: with ``simt`` or where the
    library takes the SIMT form, one launch of it; else its cluster form,
    launched once per slab a block owns (``_wide_geometry``)."""
    slabs = 0 if simt else _wide_geometry(kind, width)[0]
    return max(slabs, 1), slabs > 0


def _pad_head_dim(width: int, *xs: torch.Tensor):
    """Each [..., hd] tensor with zero columns up to ``width``."""
    return tuple(x if x.shape[-1] == width else
                 F.pad(x, (0, width - x.shape[-1])) for x in xs)


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from textsummarization_on_flink_tpu_torch.kernels import build

        lib = ctypes.CDLL(build.build("flash_attention"))
        for fn in (lib.ts_flash_attention, lib.ts_flash_attention_bf16):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
                + [ctypes.c_float, ctypes.c_void_p]
        lib.ts_flash_error_string.restype = ctypes.c_char_p
        lib.ts_flash_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _load_bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        from textsummarization_on_flink_tpu_torch.kernels import build

        lib = ctypes.CDLL(build.build("flash_attention_bwd"))
        tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        for fn in (lib.ts_flash_bwd_dkv, lib.ts_flash_bwd_dkv_bf16):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 9 + tail
        for fn in (lib.ts_flash_bwd_dq, lib.ts_flash_bwd_dq_bf16):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 8 + tail
        lib.ts_flash_bwd_error_string.restype = ctypes.c_char_p
        lib.ts_flash_bwd_error_string.argtypes = [ctypes.c_int]
        _bwd_lib = lib
    return _bwd_lib


def _load_wide_library() -> ctypes.CDLL:
    global _wide_lib
    if _wide_lib is None:
        from textsummarization_on_flink_tpu_torch.kernels import build

        lib = ctypes.CDLL(build.build("flash_attention_wide"))
        tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        for fn in (lib.ts_flash_wide, lib.ts_flash_wide_bf16,
                   lib.ts_flash_wide_simt, lib.ts_flash_wide_simt_bf16):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + tail
        for fn in (lib.ts_flash_wide_bwd_dkv, lib.ts_flash_wide_bwd_dkv_bf16,
                   lib.ts_flash_wide_bwd_dkv_simt,
                   lib.ts_flash_wide_bwd_dkv_simt_bf16):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 9 + tail
        for fn in (lib.ts_flash_wide_bwd_dq, lib.ts_flash_wide_bwd_dq_bf16,
                   lib.ts_flash_wide_bwd_dq_simt,
                   lib.ts_flash_wide_bwd_dq_simt_bf16):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 8 + tail
        lib.ts_flash_wide_error_string.restype = ctypes.c_char_p
        lib.ts_flash_wide_error_string.argtypes = [ctypes.c_int]
        lib.ts_flash_wide_form.restype = ctypes.c_int
        lib.ts_flash_wide_form.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        lib.ts_flash_wide_active_clusters.restype = ctypes.c_int
        lib.ts_flash_wide_active_clusters.argtypes = [ctypes.c_int] * 3
        lib.ts_flash_wide_active_clusters_at.restype = ctypes.c_int
        lib.ts_flash_wide_active_clusters_at.argtypes = [ctypes.c_int] * 3
        _wide_lib = lib
    return _wide_lib


def _entry(kind: str, bf16: bool, wide: bool, simt: bool = False):
    """(the C entry point, its library's error string) of the forward
    (``kind`` "fwd"), dK/dV ("dkv") or dQ ("dq") kernel: the wide
    library's above head dim 256, else flash_attention's (the forward)
    or flash_attention_bwd's; the _bf16 entry for bf16 operands.
    ``simt`` (the wide kernels only) takes the SIMT design the cluster
    forms replaced (``_wide_launches``), for timing them against it; no path
    of the port sets it."""
    if simt and not wide:
        raise ValueError("only the wide kernels have a SIMT form")
    if wide:
        lib = _load_wide_library()
        name = ("ts_flash_wide" + ("" if kind == "fwd" else f"_bwd_{kind}")
                + ("_simt" if simt else ""))
        error_string = lib.ts_flash_wide_error_string
    elif kind == "fwd":
        lib, name = _load_library(), "ts_flash_attention"
        error_string = lib.ts_flash_error_string
    else:
        lib, name = _load_bwd_library(), f"ts_flash_bwd_{kind}"
        error_string = lib.ts_flash_bwd_error_string
    return getattr(lib, name + ("_bf16" if bf16 else "")), error_string


def _check_inputs(what: str, queries, keys, key_mask, causal) -> None:
    """Device, type, shape, contiguity and alignment of the [B, Tq, nh,
    hd] query-side inputs ``queries`` (q, and for the backward out and
    dO) and the [B, Tk, nh, hd] key-side ones ``keys`` (k, v), all
    float32 or all bfloat16 (q sets the dtype and B, nh, hd), and the
    float32 key mask [B, Tk]."""
    q = queries[0][1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel needs CUDA tensors, got {dev}")
    if q.dim() != 4 or keys[0][1].dim() != 4:
        raise ValueError(f"q and k must be [B, T, nh, hd], got "
                         f"{tuple(q.shape)} and {tuple(keys[0][1].shape)}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must have dtype float32 or bfloat16, got "
                         f"{q.dtype}")
    _check_block(q, keys[0][1], causal)
    B, Tq, nh, hd = q.shape
    Tk = keys[0][1].shape[1]
    for tensors, T in ((queries, Tq), (keys, Tk)):
        for name, x in tensors:
            if x.dtype != q.dtype and x.dtype in DTYPES:
                raise ValueError(f"{name} has dtype {x.dtype} but q has "
                                 f"{q.dtype}: the kernels take one dtype")
            _check(name, x, (B, T, nh, hd), (q.dtype,), dev)
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned (16-byte "
                                 f"loads)")
    if key_mask is not None:
        _check("key_mask", key_mask, (B, Tk), (torch.float32,), dev)
    if B == 0 or Tq == 0 or Tk == 0 or nh == 0:
        raise ValueError(f"empty attention input (B={B}, Tq={Tq}, Tk={Tk}, "
                         f"nh={nh})")


def _flash_cuda(q, k, v, key_mask, causal, sm_scale, with_lse=False,
                simt=False):
    """Launch the forward kernel (its bf16 form for bf16 inputs; the wide
    kernel's above head dim 256, its SIMT form with ``simt``: _entry);
    same contract as _flash_plain.  With ``with_lse`` returns (out, lse
    [B, Tq, nh] float32)."""
    global launches, launches_bf16, launches_wide, launches_block
    global launches_wide_cluster
    _check_inputs("flash attention", (("q", q),), (("k", k), ("v", v)),
                  key_mask, causal)
    dev = q.device
    hd = q.shape[-1]
    width = _padded_head_dim(hd)
    q, k, v = _pad_head_dim(width, q, k, v)
    B, Tq, nh, _ = q.shape
    Tk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((B, Tq, nh), device=dev) if with_lse else None
    bf16 = q.dtype == torch.bfloat16
    wide = _is_wide(width)
    fn, error_string = _entry("fwd", bf16, wide, simt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if key_mask is None else key_mask.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(),
            B, Tq, Tk, nh, width, int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError("flash attention kernel launch failed: "
                           + error_string(err).decode())
    n, cluster = _wide_launches("fwd", width, simt) if wide else (1, False)
    launches += n
    launches_bf16 += bf16 * n
    launches_wide += wide * n
    launches_wide_cluster += cluster * n
    launches_block += (Tq != Tk) * n
    if width != hd:
        out = out[..., :hd].contiguous()
    return (out, lse) if with_lse else out


def _bwd_dkv_cuda(q, k, v, do, lse, dsum, key_mask, causal, sm_scale,
                  simt=False):
    """Launch the dK/dV kernel (its bf16 form for bf16 inputs; the wide
    kernel's above head dim 256, its SIMT form with ``simt``): (dk, dv),
    [B, Tk, nh, hd].  dsum = rowsum(dO * O) [B, Tq, nh] float32."""
    global launches_bwd_dkv, launches_bwd_dkv_bf16, launches_bwd_dkv_wide
    global launches_bwd_dkv_block, launches_bwd_dkv_wide_cluster
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    bf16 = q.dtype == torch.bfloat16
    B, Tq, nh, hd = q.shape
    wide = _is_wide(hd)
    fn, error_string = _entry("dkv", bf16, wide, simt)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(),
            0 if key_mask is None else key_mask.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, Tq, k.shape[1], nh, hd, int(bool(causal)),
            float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash attention dK/dV kernel launch failed: "
                           + error_string(err).decode())
    n, cluster = _wide_launches("dkv", hd, simt) if wide else (1, False)
    launches_bwd_dkv += n
    launches_bwd_dkv_bf16 += bf16 * n
    launches_bwd_dkv_wide += wide * n
    launches_bwd_dkv_wide_cluster += cluster * n
    launches_bwd_dkv_block += (Tq != k.shape[1]) * n
    return dk, dv


def _bwd_dq_cuda(q, k, v, do, lse, dsum, key_mask, causal, sm_scale,
                 simt=False):
    """Launch the dQ kernel (its bf16 form for bf16 inputs; the wide
    kernel's above head dim 256, its SIMT form with ``simt``): dq, [B, Tq,
    nh, hd]."""
    global launches_bwd_dq, launches_bwd_dq_bf16, launches_bwd_dq_wide
    global launches_bwd_dq_block, launches_bwd_dq_wide_cluster
    dq = torch.empty_like(q)
    bf16 = q.dtype == torch.bfloat16
    B, Tq, nh, hd = q.shape
    wide = _is_wide(hd)
    fn, error_string = _entry("dq", bf16, wide, simt)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(),
            0 if key_mask is None else key_mask.data_ptr(), dq.data_ptr(),
            B, Tq, k.shape[1], nh, hd, int(bool(causal)), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash attention dQ kernel launch failed: "
                           + error_string(err).decode())
    n, cluster = _wide_launches("dq", hd, simt) if wide else (1, False)
    launches_bwd_dq += n
    launches_bwd_dq_bf16 += bf16 * n
    launches_bwd_dq_wide += wide * n
    launches_bwd_dq_wide_cluster += cluster * n
    launches_bwd_dq_block += (Tq != k.shape[1]) * n
    return dq


def _flash_bwd_cuda(q, k, v, out, lse, do, key_mask, causal, sm_scale):
    """D = rowsum(dO * O) in PyTorch (flash_attention.py:273-275 of the
    installed jax), then the dK/dV kernel and the dQ kernel; same contract
    as _flash_bwd_plain."""
    _check_inputs("flash attention backward",
                  (("q", q), ("out", out), ("do", do)), (("k", k), ("v", v)),
                  key_mask, causal)
    B, Tq, nh, hd = q.shape
    _check("lse", lse, (B, Tq, nh), (torch.float32,), q.device)
    width = _padded_head_dim(hd)
    q, k, v, out, do = _pad_head_dim(width, q, k, v, out, do)
    # [B, Tq, nh] f32, contiguous; bf16 dO and O widened first
    dsum = torch.sum(_wide(do) * _wide(out), dim=-1)
    dk, dv = _bwd_dkv_cuda(q, k, v, do, lse, dsum, key_mask, causal,
                           sm_scale)
    dq = _bwd_dq_cuda(q, k, v, do, lse, dsum, key_mask, causal, sm_scale)
    if width != hd:
        dq, dk, dv = (x[..., :hd].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Self-attention context with a kernel backward (the library's
    custom_vjp, flash_attention.py:254-318).  CPU tensors take the plain
    forward and backward, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, sm_scale):
        if q.device.type == "cpu":
            out = _flash_plain(q, k, v, key_mask, causal, sm_scale)
            lse = _flash_lse_plain(q, k, key_mask, causal, sm_scale)
        else:
            out, lse = _flash_cuda(q, k, v, key_mask, causal, sm_scale,
                                   with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, key_mask)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, key_mask = ctx.saved_tensors
        # the cotangent may arrive strided (from _merge_heads and the wo
        # matmul's backward); the kernels read contiguous rows
        do = do.contiguous()
        bwd = _flash_bwd_plain if q.device.type == "cpu" else _flash_bwd_cuda
        dq, dk, dv = bwd(q, k, v, out, lse, do, key_mask, ctx.causal,
                         ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor], causal: bool,
                    sm_scale: float) -> torch.Tensor:
    """Self-attention context [B, T, nh, hd] (see the module docstring).
    CPU tensors take the plain versions, CUDA tensors the kernels; the
    autograd Function only when a gradient is needed."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, key_mask, causal, sm_scale)
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, key_mask, causal, sm_scale)
    return _flash_cuda(q, k, v, key_mask, causal, sm_scale)
