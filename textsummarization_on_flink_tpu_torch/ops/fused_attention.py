"""Fused additive attention + coverage: the CUDA kernel and its plain version.

Port of the JAX package's ops/pallas_attention.py.  Per query row,

    e_i  = v . tanh(ef_i + df [+ cov_i * w_c])
    a    = masked_softmax(e)          (energies at NEG where mask == 0)
    ctx  = sum_i a_i es_i

The kernel (kernels/fused_attention.cu) replaces the TPU kernels
``pallas_attention.py::_kernel`` (:58) and ``::_blocked_kernel`` (:199).
It is written for the beam search's shared-encoder form: the K
hypotheses of an article attend against ONE copy of its encoder, so
``es``/``ef`` are [B, T, D] and the queries ``df`` [B, K, D]; with K=1 it
is the per-row form.  It is bound by memory on the card (each article's
encoder is read once per call for all K queries, by one thread block
cluster per article; see the source's header for the numbers and the
design).  The wrapper refuses, before it looks at the device, the shapes
the kernel does not take (``_shape_refusal``: empty inputs, rows that
are not a multiple of 16 bytes, more articles than the grid takes).

Widths: the kernels stage 16-byte pieces of each encoder row, so D must
be a multiple of 4 in f32 and of 8 in bf16.  On the card the entry
points (``fused_attention_shared`` and ``FusedAttention``'s backward)
zero-pad any other D up to that multiple on the way in (es, ef, df, v,
w_c and, for the backward, g_ctx) and slice ctx and the D-wide gradients
back (``_padded_forward``, ``_padded_backward``): a zero column adds
v . tanh(0) = 0 to every energy and gives zero context and gradient
columns, so the result is exact.  Every width runs: where the dense
form's per-block constants do not fit one block's shared memory, both
kernels take their slab form, a loop over slabs of D (``_launch_form``
and ``_bwd_form`` mirror the choice; counted by ``launches_slab`` and
``launches_bwd_slab``).

Sequence parallelism (the pointer-generator on an sp mesh, as the JAX
package's parallel/mesh.py:17-22 lays it out): each sp rank holds a
block of T.  ``fused_attention_block`` is the kernel's sp-block form: it
also returns the block's row max and row sum, and ``merge_sp_blocks``
(plain PyTorch over ``parallel.collectives``) merges the ranks' blocks
as ring attention's online softmax does.  Training takes
``FusedAttentionSP``, whose backward launches the backward kernel's
sp-block form with the softmax correction all-reduced over sp.  The
sp-block forms are counted by ``launches_sp`` and ``launches_bwd_sp``.

Length bound: ``t_active`` (the slot engine's decode step) limits the
work to the first ``t_active`` positions of the article axis; ``attn`` is
exactly 0 past them, as at a masked position, and ``None`` (every
position) is the dense form, whose launch and numbers are unchanged.
The bound is a host int: the engine knows its residents' lengths.

Dispatch: a CPU tensor goes to ``_attention_plain`` (the formula of
``_attention_xla_shared`` / ``_attention_xla``, pallas_attention.py:96-132);
a CUDA tensor goes to the kernel, or the wrapper raises.  There is no
fallback from one to the other.  ``launches`` counts kernel launches.

Training differentiates the per-row form through ``FusedAttention``, a
``torch.autograd.Function`` (the JAX package's custom_vjp,
pallas_attention.py:335-372): its forward is the forward above and saves
its inputs and the ``attn`` output; its backward is
``_attention_bwd_plain`` on the CPU (the explicit gradient formulas) and
kernels/fused_attention_bwd.cu on the card (``_attention_bwd_cuda``,
counted by ``launches_bwd``).  Both take f32 or bf16 encoder streams (es,
ef), as the forward does: the arithmetic is f32, and d_es, d_ef come back
in the stream's dtype, rounded once (the JAX package's custom_vjp takes
``jax.vjp`` of the formula, which promotes bf16 es/ef to f32 and casts
their cotangents back).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30  # masked-energy floor (pallas_attention.NEG), never -inf

#: kernel launches so far (one per wrapper call on CUDA tensors: the
#: forward, and the backward), and of those the launches on a bf16
#: encoder stream, of the slab form (a D whose dense form does not fit)
#: and of the sp-block form; set them to 0 before a run whose launches
#: are to be counted
launches = 0
launches_bwd = 0
launches_bf16 = 0
launches_bwd_bf16 = 0
launches_slab = 0
launches_bwd_slab = 0
launches_sp = 0
launches_bwd_sp = 0

_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def _attention_plain(es: torch.Tensor, ef: torch.Tensor, mask: torch.Tensor,
                     df: torch.Tensor, cov: torch.Tensor, v: torch.Tensor,
                     w_c: torch.Tensor, use_coverage: bool,
                     t_active: Optional[int] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference formula in plain PyTorch.

    es, ef [B, T, D] (f32 or bf16, upcast here); mask [B, T]; df [B, K, D];
    cov [B, K, T] (read only when use_coverage); v, w_c [D].
    Returns (ctx [B, K, D], attn [B, K, T]), both f32.  With ``t_active``
    the formula runs over the first t_active positions and attn is 0 past
    them (the JAX package's _attend_shared_blocked, where blocks past the
    bound sit at the masked floor)."""
    T = es.shape[1]
    if t_active is not None and t_active < T:
        ctx, attn = _attention_plain(
            es[:, :t_active], ef[:, :t_active], mask[:, :t_active], df,
            cov[:, :, :t_active], v, w_c, use_coverage)
        return ctx, F.pad(attn, (0, T - t_active))
    ctx, attn, _, _ = _attention_block_plain(es, ef, mask, df, cov, v, w_c,
                                             use_coverage)
    return ctx, attn


def _attention_block_plain(es: torch.Tensor, ef: torch.Tensor,
                           mask: torch.Tensor, df: torch.Tensor,
                           cov: torch.Tensor, v: torch.Tensor,
                           w_c: torch.Tensor, use_coverage: bool,
                           ) -> Tuple[torch.Tensor, ...]:
    """The formula over the positions given (the sp-block form's plain
    version when they are one block of T): (ctx, attn) as
    ``_attention_plain``'s, and the row max ``m`` and unfloored row sum
    ``l`` [B, K] of the softmax (m at NEG and l 0 where no position is
    valid)."""
    feats = ef.float()[:, None, :, :] + df[:, :, None, :]  # [B, K, T, D]
    if use_coverage:
        feats = feats + cov[:, :, :, None] * w_c
    e = torch.sum(v * torch.tanh(feats), dim=-1)  # [B, K, T]
    valid = (mask > 0)[:, None, :]
    e = torch.where(valid, e, NEG)
    m = torch.amax(e, dim=-1)
    p = torch.exp(e - m[..., None]) * valid
    l = torch.sum(p, dim=-1)
    # fully-masked row: clamp the 0 denominator -> zero attention, not NaN
    attn = p / torch.clamp(l, min=1e-30)[..., None]
    return attn @ es.float(), attn, m, l  # [B, K, T] @ [B, T, D]


def _attention_bwd_plain(es: torch.Tensor, ef: torch.Tensor,
                         mask: torch.Tensor, df: torch.Tensor,
                         cov: torch.Tensor, v: torch.Tensor, w_c: torch.Tensor,
                         attn: torch.Tensor, g_ctx: torch.Tensor,
                         g_attn: torch.Tensor, use_coverage: bool,
                         correction: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, ...]:
    """The backward of the per-row form as explicit formulas, the plain
    version of kernels/fused_attention_bwd.cu.

    es, ef [B, T, D], f32 or bf16 (widened here); mask, cov, attn (the
    forward's), g_attn [B, T]; df, g_ctx [B, D]; v, w_c [D], f32.  With
    u = tanh(ef + df [+ cov w_c]) recomputed, all in f32:

        d_es[t] = attn[t] g_ctx
        ga[t]   = g_attn[t] + es[t] . g_ctx
        d_e[t]  = attn[t] (ga[t] - sum_s attn[s] ga[s])   (0 where masked)
        d_f[t]  = d_e[t] v (1 - u[t]^2)
        d_ef = d_f, d_df = sum_t d_f, d_cov[t] = d_f[t] . w_c,
        d_v = sum_{b,t} d_e u, d_w_c = sum_{b,t} d_f cov

    The max shift is not differentiated (stop_gradient in the JAX
    formula) and the denominator's 1e-30 clamp is not passed through: a
    fully masked row has attn 0, so its gradients are 0, never NaN.
    ``correction`` [B] (the sp-block form): sum_s attn[s] ga[s] over the
    whole row, of which these rows are one block, in place of the
    block's own sum.
    Returns (d_es, d_ef, d_df, d_cov, d_v, d_w_c); d_es and d_ef in es's
    dtype (rounded once from f32, the cast of jax.vjp's cotangents), the
    rest f32 sums of the unrounded d_f; d_cov and d_w_c are zeros when
    coverage is off."""
    stream_dtype = es.dtype
    es, ef = es.float(), ef.float()
    feats = ef + df[:, None, :]
    if use_coverage:
        feats = feats + cov[:, :, None] * w_c
    u = torch.tanh(feats)  # [B, T, D]
    ga = g_attn + torch.einsum("btd,bd->bt", es, g_ctx)
    if correction is None:
        correction = torch.sum(attn * ga, dim=-1)
    d_e = attn * (ga - correction[:, None])
    d_e = torch.where(mask > 0, d_e, 0.0)
    d_f = d_e[:, :, None] * v * (1.0 - u * u)
    d_es = attn[:, :, None] * g_ctx[:, None, :]
    d_v = torch.sum(d_e[:, :, None] * u, dim=(0, 1))
    if use_coverage:
        d_cov = torch.sum(d_f * w_c, dim=-1)
        d_w_c = torch.sum(d_f * cov[:, :, None], dim=(0, 1))
    else:
        d_cov, d_w_c = torch.zeros_like(attn), torch.zeros_like(v)
    return (d_es.to(stream_dtype), d_f.to(stream_dtype), torch.sum(d_f, dim=1),
            d_cov, d_v, d_w_c)


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from textsummarization_on_flink_tpu_torch.kernels import build

        lib = ctypes.CDLL(build.build("fused_attention"))
        fn = lib.ts_fused_attention_shared
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        lib.ts_cuda_error_string.restype = ctypes.c_char_p
        lib.ts_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _bind_bwd(path: str) -> ctypes.CDLL:
    """The backward kernel's library at ``path``, its entry points typed."""
    lib = ctypes.CDLL(path)
    fn = lib.ts_fused_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.ts_fused_attention_bwd_part.restype = ctypes.c_longlong
    lib.ts_fused_attention_bwd_part.argtypes = [ctypes.c_int] * 4
    lib.ts_fused_attention_bwd_error_string.restype = ctypes.c_char_p
    lib.ts_fused_attention_bwd_error_string.argtypes = [ctypes.c_int]
    return lib


def _load_bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        from textsummarization_on_flink_tpu_torch.kernels import build

        _bwd_lib = _bind_bwd(build.build("fused_attention_bwd"))
    return _bwd_lib


def _check(name: str, x: torch.Tensor, shape, dtypes, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {x.dtype}, expected one of "
                         f"{dtypes}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# The kernel's geometry (kernels/fused_attention.cu): chunks of 8 staged
# positions; clusters of 8 blocks per article with a ring of 4 chunks, or
# of 16 with a ring of 8 (the wide form, for few articles); a ring halves,
# down to 2 chunks, while a wide D leaves no room for it; past that the
# slab form: a ring of 4 chunks of slabs of 512 columns, the slab halved
# (down to 64) while K queries' slabs do not fit
_CHUNK = 8
_CLUSTER, _RING, _WIDE_CLUSTER, _WIDE_RING = 8, 4, 16, 8
_MIN_RING = 2
_SLAB, _MIN_SLAB, _SLAB_RING = 512, 64, 4
_BAR_FLOATS = 16  # the ring's mbarriers, ahead of it
_SMEM_MAX = 232_448  # bytes of shared memory a block may use on Hopper
_MAX_ARTICLES = 65_535  # the grid's y extent
_H100_SMS = 132  # the SM count a refusal assumes for a tensor off the card


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _geometry(T: int, wide: bool) -> Tuple[int, int]:
    """(C blocks per article, P positions per block) for T positions."""
    C = min(_ceil_div(T, _CHUNK), _WIDE_CLUSTER if wide else _CLUSTER)
    return C, _ceil_div(_ceil_div(T, C), _CHUNK) * _CHUNK


def _smem_bytes(T: int, D: int, K: int, elt: int, wide: bool = True,
                state: bool = False, stages: Optional[int] = None) -> int:
    """Dynamic shared memory of one block of the dense form (smem_floats
    in the source), in the wide or the narrow form, with a ring of
    ``stages`` chunks (None: the form's full ring), with or without the
    per-position state (mask, coverage, energies).  Past the state's
    room it moves to device memory, so T is not bounded."""
    C, P = _geometry(T, wide)
    if stages is None:
        stages = _WIDE_RING if wide else _RING
    floats = (_BAR_FLOATS + stages * _CHUNK * D * elt // 4 + 2 * K * D
              + 2 * D + (P * (2 * K + 1) if state else 0) + (3 + 2 * C) * K)
    return 4 * floats


def _slab_smem_bytes(T: int, K: int, elt: int, wide: bool, state: bool,
                     slab: int) -> int:
    """Dynamic shared memory of one block of the slab form
    (slab_smem_floats in the source) with slabs of ``slab`` columns."""
    C, P = _geometry(T, wide)
    floats = (_BAR_FLOATS + _SLAB_RING * _CHUNK * slab * elt // 4
              + 2 * K * slab + 2 * slab + (P * (2 * K + 1) if state else 0)
              + (3 + 2 * C) * K)
    return 4 * floats


def _launch_form(B: int, T: int, D: int, K: int, elt: int,
                 sms: int) -> Optional[Tuple[bool, int, bool, int]]:
    """The form launch() in the source takes on a card with ``sms`` SMs
    for T positions processed (the length bound): (wide clusters, ring
    chunks, state in shared memory, slab columns).  Slab columns 0 is the
    dense form, where a ring of at least 2 chunks of whole rows fits
    beside the block's constants; past that the slab form, its slab
    halved while K queries' slabs do not fit.  None when not even slabs
    of 64 columns fit (a K in the hundreds)."""
    wide = B * _WIDE_CLUSTER * 2 <= sms
    stages = _WIDE_RING if wide else _RING
    while (stages > _MIN_RING
           and _smem_bytes(T, D, K, elt, wide, stages=stages) > _SMEM_MAX):
        stages //= 2
    if _smem_bytes(T, D, K, elt, wide, stages=stages) <= _SMEM_MAX:
        return wide, stages, _smem_bytes(T, D, K, elt, wide, True,
                                         stages) <= _SMEM_MAX, 0
    slab = _SLAB
    while (slab > _MIN_SLAB
           and _slab_smem_bytes(T, K, elt, wide, False, slab) > _SMEM_MAX):
        slab //= 2
    if _slab_smem_bytes(T, K, elt, wide, False, slab) > _SMEM_MAX:
        return None
    return wide, _SLAB_RING, _slab_smem_bytes(T, K, elt, wide, True,
                                              slab) <= _SMEM_MAX, slab


def _state_in_smem(B: int, T: int, D: int, K: int, elt: int,
                   sms: int) -> bool:
    """Whether the kernel keeps the per-position state in shared memory
    (else in device memory) on a card with ``sms`` SMs: the choice of
    launch() in the source."""
    form = _launch_form(B, T, D, K, elt, sms)
    return form is not None and form[2]


def _sm_count(dev: torch.device) -> int:
    """SMs of the card a tensor lies on (the H100's for other devices)."""
    if dev.type != "cuda":
        return _H100_SMS
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _shape_refusal(es: torch.Tensor, df: torch.Tensor,
                   sms: int = _H100_SMS,
                   t_active: Optional[int] = None) -> Optional[str]:
    """Why the kernel does not take these shapes (and this length bound)
    on a card with ``sms`` SMs (None when it does).  Checked before the
    device, so it holds for tensors anywhere.  No width is refused."""
    if es.dim() != 3 or df.dim() != 3:
        return (f"es must be [B, T, D] and df [B, K, D], got "
                f"{tuple(es.shape)} and {tuple(df.shape)}")
    B, T, D = es.shape
    K = df.shape[1]
    if B == 0 or T == 0 or K == 0 or D == 0:
        return f"empty attention input (B={B}, T={T}, K={K}, D={D})"
    if t_active is not None:
        if not 1 <= t_active <= T:
            return f"t_active={t_active} is outside [1, T={T}]"
        T = t_active  # the blocks split the bound
    elt = 2 if es.dtype == torch.bfloat16 else 4
    if D % (16 // elt):
        return (f"D={D} is not a multiple of {16 // elt}: the kernel stages "
                f"16-byte pieces of each {es.dtype} encoder row")
    if B > _MAX_ARTICLES:
        return f"B={B} articles exceed the grid's {_MAX_ARTICLES}"
    if _launch_form(B, T, D, K, elt, sms) is None:
        wide = B * _WIDE_CLUSTER * 2 <= sms
        need = _slab_smem_bytes(T, K, elt, wide, False, _MIN_SLAB)
        return (f"K={K} queries exceed one block's shared memory even in "
                f"slabs of {_MIN_SLAB} columns ({need} > {_SMEM_MAX} bytes)")
    return None


def _attention_cuda(es, ef, mask, df, cov, v, w_c, use_coverage,
                    t_active=None, stats=False):
    """Launch the kernel; same contract as _attention_plain, for a D the
    kernel takes (``_padded_forward`` pads the others).  ``stats``: the
    sp-block form, whose (ctx, attn, m, l) are _attention_block_plain's."""
    global launches, launches_bf16, launches_slab, launches_sp
    sms = _sm_count(es.device)
    refusal = _shape_refusal(es, df, sms, t_active)
    if refusal is not None:
        raise ValueError(refusal)
    dev = es.device
    if dev.type != "cuda":
        raise ValueError(f"the fused attention kernel needs CUDA tensors, "
                         f"got {dev}")
    B, T, D = es.shape
    K = df.shape[1]
    _check("es", es, (B, T, D), (torch.float32, torch.bfloat16), dev)
    _check("ef", ef, (B, T, D), (es.dtype,), dev)
    _check("mask", mask, (B, T), (torch.float32,), dev)
    _check("df", df, (B, K, D), (torch.float32,), dev)
    _check("cov", cov, (B, K, T), (torch.float32,), dev)
    _check("v", v, (D,), (torch.float32,), dev)
    _check("w_c", w_c, (D,), (torch.float32,), dev)
    for name, x in (("es", es), ("ef", ef), ("df", df), ("v", v),
                    ("w_c", w_c)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (cp.async)")
    ctx = torch.empty((B, K, D), device=dev, dtype=torch.float32)
    attn = torch.empty((B, K, T), device=dev, dtype=torch.float32)
    m = l = None
    if stats:
        m = torch.empty((B, K), device=dev, dtype=torch.float32)
        l = torch.empty((B, K), device=dev, dtype=torch.float32)
    t_act = T if t_active is None else int(t_active)
    lib = _load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ts_fused_attention_shared(
            es.data_ptr(), ef.data_ptr(), mask.data_ptr(), df.data_ptr(),
            cov.data_ptr(), v.data_ptr(), w_c.data_ptr(), ctx.data_ptr(),
            attn.data_ptr(), m.data_ptr() if stats else None,
            l.data_ptr() if stats else None, B, T, t_act, D, K,
            int(bool(use_coverage)), int(es.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("fused attention kernel launch failed: "
                           + lib.ts_cuda_error_string(err).decode())
    launches += 1
    if es.dtype == torch.bfloat16:
        launches_bf16 += 1
    if _launch_form(B, t_act, D, K, 2 if es.dtype == torch.bfloat16 else 4,
                    sms)[3]:
        launches_slab += 1
    if stats:
        launches_sp += 1
        return ctx, attn, m, l
    return ctx, attn


# The backward kernel's sizes: kernels/fused_attention_bwd.cu's kThreads,
# kChunk, kMinStages, kMaxStages, kRingBytes and kMaxGroups (keep them in
# step; a card test holds the form against the kernel's).  Its dense
# form's shared memory: a ring of 8-row chunks of the stream's dtype, as
# many as fit in 96 KB (3 to 12), with the mbarriers (2 floats each of
# kMaxStages) ahead of it; g_ctx [D]; the row scalars' ring (5 x 8 x 4
# floats), the d_cov warp sums (2 x 8 x warps) and warps + 16 floats of
# the block's scalars.  Past its room, or past 3 column groups of 4 a
# thread, the slab form.
_BWD_THREADS, _BWD_CHUNK, _BWD_MIN_STAGES, _BWD_MAX_STAGES = 256, 8, 3, 12
_BWD_RING_BYTES, _BWD_MAX_GROUPS = 96 * 1024, 3
_BWD_WARPS = _BWD_THREADS // 32
_BWD_FIXED_FLOATS = (2 * _BWD_MAX_STAGES + 5 * _BWD_CHUNK * 4
                     + 2 * _BWD_CHUNK * _BWD_WARPS + _BWD_WARPS + 16)
#: part's first 16 bytes: the kernel's ticket (an unsigned, 0 between
#: launches), then the per-article partials of d_v and d_w_c (and in the
#: slab form d_cov's running sums)
_BWD_TICKET_FLOATS = 4


def _bwd_stages(D: int, elt: int = 4) -> int:
    """Chunks in the backward kernel's dense ring at width D, rows of
    ``elt``-byte elements (ring_stages)."""
    fit = _BWD_RING_BYTES // (_BWD_CHUNK * D * elt)
    return min(max(fit, _BWD_MIN_STAGES), _BWD_MAX_STAGES)


def _bwd_smem_bytes(D: int, elt: int = 4) -> int:
    """Dynamic shared memory of one block of the dense backward
    (smem_floats)."""
    ring = _bwd_stages(D, elt) * _BWD_CHUNK * D * elt // 4
    return 4 * (_BWD_FIXED_FLOATS + ring + D)


def _bwd_form(D: int, elt: int = 4) -> str:
    """"dense" where the dense backward takes width D (at most 3 column
    groups of 4 a thread, its ring of 3 chunks of whole rows in one
    block), else "slab" (dense_form in the source)."""
    dense = (D <= 4 * _BWD_THREADS * _BWD_MAX_GROUPS
             and _bwd_smem_bytes(D, elt) <= _SMEM_MAX)
    return "dense" if dense else "slab"


def _bwd_part_floats(B: int, T: int, D: int, elt: int = 4) -> int:
    """Floats of the backward's scratch (ts_fused_attention_bwd_part)."""
    base = _BWD_TICKET_FLOATS + 2 * B * D
    return base if _bwd_form(D, elt) == "dense" else base + B * T


def _bwd_shape_refusal(es: torch.Tensor) -> Optional[str]:
    """Why the backward kernel does not take encoder streams of this shape
    (None when it does).  Checked before the device, as _shape_refusal is
    for the forward.  No width is refused."""
    if es.dim() != 3:
        return f"es must be [B, T, D], got {tuple(es.shape)}"
    B, T, D = es.shape
    if B == 0 or T == 0 or D == 0:
        return f"empty attention input (B={B}, T={T}, D={D})"
    if es.dtype not in (torch.float32, torch.bfloat16):
        return (f"es has dtype {es.dtype}: the kernel takes float32 or "
                f"bfloat16 encoder streams")
    elt = 2 if es.dtype == torch.bfloat16 else 4
    if D % (16 // elt):
        return (f"D={D} is not a multiple of {16 // elt}: the kernel copies "
                f"16-byte pieces of each {es.dtype} row")
    if B > _MAX_ARTICLES:
        return f"B={B} articles exceed the grid's {_MAX_ARTICLES}"
    return None


#: the backward's scratch per (device, stream): its ticket must be 0 at a
#: launch, and every launch leaves it 0 (the last cluster resets it; a
#: launch the kernel refuses does not touch it, and one that faults leaves
#: the CUDA context unusable), so launches on one stream (which run in
#: turn) share one buffer, grown when a shape needs more.  A zeroed buffer
#: per call would cost a fill kernel, as much as the second launch the
#: ticket saves (PERF.md, the backward's findings)
_bwd_scratch_cache: dict = {}


def _bwd_scratch(dev: torch.device, stream: int, floats: int) -> torch.Tensor:
    key = (dev.index, stream)
    part = _bwd_scratch_cache.get(key)
    if part is None or part.numel() < floats:
        part = torch.zeros(floats, device=dev, dtype=torch.float32)
        _bwd_scratch_cache[key] = part
    return part


def _attention_bwd_cuda(es, ef, mask, df, cov, v, w_c, attn, g_ctx, g_attn,
                        use_coverage, correction=None):
    """Launch the backward kernel; same contract as _attention_bwd_plain,
    for a D the kernel takes (``_padded_backward`` pads the others);
    ``correction`` [B] launches the sp-block form."""
    global launches_bwd, launches_bwd_bf16, launches_bwd_slab, \
        launches_bwd_sp
    refusal = _bwd_shape_refusal(es)
    if refusal is not None:
        raise ValueError(refusal)
    dev = es.device
    if dev.type != "cuda":
        raise ValueError(f"the fused attention backward kernel needs CUDA "
                         f"tensors, got {dev}")
    B, T, D = es.shape
    _check("es", es, (B, T, D), (torch.float32, torch.bfloat16), dev)
    for name, x, shape, dtype in (
            ("ef", ef, (B, T, D), es.dtype), ("mask", mask, (B, T), None),
            ("df", df, (B, D), None), ("cov", cov, (B, T), None),
            ("v", v, (D,), None), ("w_c", w_c, (D,), None),
            ("attn", attn, (B, T), None), ("g_ctx", g_ctx, (B, D), None),
            ("g_attn", g_attn, (B, T), None)):
        _check(name, x, shape, (dtype or torch.float32,), dev)
    if correction is not None:
        _check("correction", correction, (B,), (torch.float32,), dev)
    for name, x in (("es", es), ("ef", ef)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA copies)")
    # df, g_ctx, v and w_c are read in float4 groups too: a view that
    # starts off a 16-byte boundary is copied to one that does not
    df, g_ctx, v, w_c = (x if x.data_ptr() % 16 == 0 else x.clone()
                         for x in (df, g_ctx, v, w_c))
    d_es, d_ef = torch.empty_like(es), torch.empty_like(ef)
    d_df, d_cov = torch.empty_like(df), torch.empty_like(attn)
    d_v, d_w_c = torch.empty_like(v), torch.empty_like(w_c)
    elt = 2 if es.dtype == torch.bfloat16 else 4
    lib = _load_bwd_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part = _bwd_scratch(dev, stream, _bwd_part_floats(B, T, D, elt))
        err = lib.ts_fused_attention_bwd(
            es.data_ptr(), ef.data_ptr(), mask.data_ptr(), df.data_ptr(),
            cov.data_ptr(), v.data_ptr(), w_c.data_ptr(), attn.data_ptr(),
            g_ctx.data_ptr(), g_attn.data_ptr(),
            None if correction is None else correction.data_ptr(),
            d_es.data_ptr(), d_ef.data_ptr(), d_df.data_ptr(),
            d_cov.data_ptr(), d_v.data_ptr(), d_w_c.data_ptr(),
            part.data_ptr(), B, T, D, int(bool(use_coverage)),
            int(elt == 2), stream)
    if err != 0:
        raise RuntimeError(
            "fused attention backward kernel launch failed: "
            + lib.ts_fused_attention_bwd_error_string(err).decode())
    launches_bwd += 1
    if elt == 2:
        launches_bwd_bf16 += 1
    if _bwd_form(D, elt) == "slab":
        launches_bwd_slab += 1
    if correction is not None:
        launches_bwd_sp += 1
    return d_es, d_ef, d_df, d_cov, d_v, d_w_c


def _padded_width(D: int, dtype: torch.dtype) -> int:
    """D rounded up to the kernels' 16-byte multiple for encoder rows of
    ``dtype`` (4 columns in f32, 8 in bf16)."""
    step = 8 if dtype == torch.bfloat16 else 4
    return -(-D // step) * step


def _pad_columns(width: int, *xs: torch.Tensor):
    """Each [..., D] tensor with zero columns up to ``width``."""
    return tuple(F.pad(x, (0, width - x.shape[-1])) for x in xs)


def _padded_forward(kernel, es, ef, mask, df, cov, v, w_c, use_coverage,
                    *rest):
    """``kernel`` (the CUDA launch, or the plain version in a test) at D
    padded to the 16-byte multiple, ctx (its first output) sliced back to
    D: exact, since a zero column adds v . tanh(0) = 0 to every energy
    and gives a zero context column.  ``rest``: the kernel's further
    arguments (t_active, stats).  No copy when D is a multiple already."""
    D = es.shape[-1]
    width = _padded_width(D, es.dtype)
    if width == D:
        return kernel(es, ef, mask, df, cov, v, w_c, use_coverage, *rest)
    es, ef, df, v, w_c = _pad_columns(width, es, ef, df, v, w_c)
    out = kernel(es, ef, mask, df, cov, v, w_c, use_coverage, *rest)
    return (out[0][..., :D].contiguous(),) + tuple(out[1:])


def _padded_backward(kernel, es, ef, mask, df, cov, v, w_c, attn, g_ctx,
                     g_attn, use_coverage, correction=None):
    """``kernel`` (the backward launch, or the plain version in a test) at
    D padded as in _padded_forward, the D-wide gradients (d_es, d_ef,
    d_df, d_v, d_w_c) sliced back: the zero columns' energies terms are
    0 and their gradient columns are dropped, so the rest is exact."""
    D = es.shape[-1]
    width = _padded_width(D, es.dtype)
    if width == D:
        return kernel(es, ef, mask, df, cov, v, w_c, attn, g_ctx, g_attn,
                      use_coverage, correction)
    es, ef, df, v, w_c, g_ctx = _pad_columns(width, es, ef, df, v, w_c,
                                             g_ctx)
    d_es, d_ef, d_df, d_cov, d_v, d_w_c = kernel(
        es, ef, mask, df, cov, v, w_c, attn, g_ctx, g_attn, use_coverage,
        correction)
    d_es, d_ef, d_df, d_v, d_w_c = (x[..., :D].contiguous() for x in
                                    (d_es, d_ef, d_df, d_v, d_w_c))
    return d_es, d_ef, d_df, d_cov, d_v, d_w_c


def fused_attention_shared(es: torch.Tensor, ef: torch.Tensor,
                           mask: torch.Tensor, df: torch.Tensor,
                           cov: torch.Tensor, v: torch.Tensor,
                           w_c: torch.Tensor, use_coverage: bool,
                           t_active: Optional[int] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx [B, K, D], attn [B, K, T]) for K queries per article against
    the article's one encoder copy (es/ef [B, T, D], mask [B, T],
    df [B, K, D], cov [B, K, T]).  cov is read only when use_coverage
    (pass zeros otherwise).  ``t_active`` bounds the work to the first
    t_active positions (attn 0 past them); None is every position.  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if es.device.type == "cpu":
        return _attention_plain(es, ef, mask, df, cov, v, w_c, use_coverage,
                                t_active)
    return _padded_forward(_attention_cuda, es, ef, mask, df, cov, v, w_c,
                           use_coverage, t_active)


def fused_attention_block(es: torch.Tensor, ef: torch.Tensor,
                          mask: torch.Tensor, df: torch.Tensor,
                          cov: torch.Tensor, v: torch.Tensor,
                          w_c: torch.Tensor, use_coverage: bool,
                          ) -> Tuple[torch.Tensor, ...]:
    """The sp-block form of fused_attention_shared: es/ef/mask/cov hold
    one block of T.  Returns (ctx, attn) normalised over the block and
    the block's row max and unfloored row sum (m, l [B, K]).  CPU tensors
    take the plain version, CUDA tensors the kernel."""
    if es.device.type == "cpu":
        return _attention_block_plain(es, ef, mask, df, cov, v, w_c,
                                      use_coverage)
    return _padded_forward(_attention_cuda, es, ef, mask, df, cov, v, w_c,
                           use_coverage, None, True)


def merge_sp_blocks(plan, ctx: torch.Tensor, attn: torch.Tensor,
                    m: torch.Tensor, l: torch.Tensor, full_attn: bool = False,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sp ranks' blocks (this rank's ``fused_attention_block``
    outputs, ctx [B, K, D], attn [B, K, T_blk], m, l [B, K]) merged into
    the row's attention: one all-gather over sp of (m, l, ctx) (and of
    attn with ``full_attn``), then M = max m, w_r = l_r e^(m_r - M), L =
    sum_r w_r and each rank's scale w_r / max(L, 1e-30).  Returns (ctx
    [B, K, D], the same on every sp rank, and this rank's attn block
    rescaled, or with ``full_attn`` the whole row's [B, K, T]).  Every
    sum runs in sp-rank order, so the result is the same bits on every
    rank and run.  A block with no valid position has m at NEG and l 0:
    its weight is exactly 0, and a row masked on every rank gives zero
    ctx and attn, as the whole row's formula does."""
    from textsummarization_on_flink_tpu_torch.parallel import collectives

    parts = [m[..., None], l[..., None], ctx]
    if full_attn:
        parts.append(attn)
    packed = torch.cat(parts, dim=-1)
    sp = plan.size("sp")
    got = collectives.all_gather(plan, packed[None], "sp", 0)  # [sp, ...]
    ms, ls = got[..., 0], got[..., 1]
    M = torch.amax(ms, dim=0)
    w = ls * torch.exp(ms - M)
    L = w[0]
    for r in range(1, sp):
        L = L + w[r]
    scale = w / torch.clamp(L, min=1e-30)  # [sp, B, K]
    D = ctx.shape[-1]
    out = got[0, ..., 2:2 + D] * scale[0, ..., None]
    for r in range(1, sp):
        out = out + got[r, ..., 2:2 + D] * scale[r, ..., None]
    if full_attn:
        blocks = [got[r, ..., 2 + D:] * scale[r, ..., None]
                  for r in range(sp)]
        return out, torch.cat(blocks, dim=-1)
    return out, attn * scale[plan.coord("sp"), ..., None]


def _attention_rows(es, ef, mask, df, cov, v, w_c, use_coverage):
    """The per-row forward: df [B, D], cov [B, T] -> (ctx [B, D],
    attn [B, T])."""
    ctx, attn = fused_attention_shared(
        es, ef, mask, df[:, None, :].contiguous(),
        cov[:, None, :].contiguous(), v, w_c, use_coverage)
    return ctx[:, 0], attn[:, 0]


def _backward(es, ef, mask, df, cov, v, w_c, attn, g_ctx, g_attn,
              use_coverage, correction=None):
    """The per-row backward: the plain formulas on the CPU, the kernel on
    the card."""
    args = (es, ef, mask, df, cov, v, w_c, attn, g_ctx.contiguous(),
            g_attn.contiguous(), use_coverage, correction)
    if es.device.type == "cpu":
        return _attention_bwd_plain(*args)
    return _padded_backward(_attention_bwd_cuda, *args)


class FusedAttention(torch.autograd.Function):
    """The per-row form with a kernel backward (the custom_vjp of
    pallas_attention.fused_attention).  CPU tensors take the plain forward
    and backward, CUDA tensors the kernels.  Saves its inputs and the
    attn output (references, not copies)."""

    @staticmethod
    def forward(ctx, es, ef, mask, df, cov, v, w_c, use_coverage):
        context, attn = _attention_rows(es, ef, mask, df, cov, v, w_c,
                                        use_coverage)
        ctx.save_for_backward(es, ef, mask, df, cov, v, w_c, attn)
        ctx.use_coverage = use_coverage
        return context, attn

    @staticmethod
    def backward(ctx, g_ctx, g_attn):
        es, ef, mask, df, cov, v, w_c, attn = ctx.saved_tensors
        d_es, d_ef, d_df, d_cov, d_v, d_w_c = _backward(
            es, ef, mask, df, cov, v, w_c, attn, g_ctx, g_attn,
            ctx.use_coverage)
        return d_es, d_ef, None, d_df, d_cov, d_v, d_w_c, None


def _attention_rows_sp(plan, es, ef, mask, df, cov, v, w_c, use_coverage):
    """The per-row forward over this sp rank's block of T, merged over
    the sp ranks: (ctx [B, D], the same on every rank; this rank's attn
    block [B, T_blk])."""
    context, attn, m, l = fused_attention_block(
        es, ef, mask, df[:, None, :].contiguous(),
        cov[:, None, :].contiguous(), v, w_c, use_coverage)
    context, attn = merge_sp_blocks(plan, context, attn, m, l)
    return context[:, 0], attn[:, 0]


class FusedAttentionSP(torch.autograd.Function):
    """The per-row form with T sharded over sp (es, ef, mask, cov: this
    rank's block; df, v, w_c: replicated).  Forward: the sp-block form
    and the merge.  Backward, with the mesh's rule that each sp rank
    minimises 1/sp of the objective and every gradient is summed over
    sp (parallel/mesh.py): the row's true g_ctx is the sum of the ranks'
    (all-reduced), and the softmax correction sum_s attn[s] ga[s] over
    the whole row is sum_s attn[s] g_attn[s] (each rank's block, summed
    in the same all-reduce) + g_ctx . ctx (sum_s attn[s] es[s] = ctx);
    the backward kernel's sp-block form takes it from outside.  d_df is
    this block's share (this rank's df feeds only its block), d_v and
    d_w_c too; reduce_grads sums them over sp."""

    @staticmethod
    def forward(ctx, es, ef, mask, df, cov, v, w_c, use_coverage, plan):
        context, attn = _attention_rows_sp(plan, es, ef, mask, df, cov, v,
                                           w_c, use_coverage)
        ctx.save_for_backward(es, ef, mask, df, cov, v, w_c, attn, context)
        ctx.use_coverage, ctx.plan = use_coverage, plan
        return context, attn

    @staticmethod
    def backward(ctx, g_ctx, g_attn):
        from textsummarization_on_flink_tpu_torch.parallel import (
            collectives,
        )

        es, ef, mask, df, cov, v, w_c, attn, context = ctx.saved_tensors
        own = torch.sum(attn * g_attn, dim=-1)  # [B]
        summed = collectives.all_reduce(
            ctx.plan, torch.cat([g_ctx, own[:, None]], dim=-1), "sp")
        g_row = summed[:, :-1].contiguous()
        correction = summed[:, -1] + torch.sum(g_row * context, dim=-1)
        d_es, d_ef, d_df, d_cov, d_v, d_w_c = _backward(
            es, ef, mask, df, cov, v, w_c, attn, g_row, g_attn,
            ctx.use_coverage, correction.contiguous())
        return d_es, d_ef, None, d_df, d_cov, d_v, d_w_c, None, None


def fused_attention(es: torch.Tensor, ef: torch.Tensor, mask: torch.Tensor,
                    df: torch.Tensor, cov: torch.Tensor, v: torch.Tensor,
                    w_c: torch.Tensor, use_coverage: bool, plan=None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-row form (one query per row, pallas_attention.fused_attention):
    df [B, D], cov [B, T] -> (ctx [B, D], attn [B, T]).  Through the
    autograd Function when a gradient is needed; under no grad (decode)
    the forward alone.  With ``plan`` (a mesh whose sp axis shards T)
    es, ef, mask and cov are this rank's block and attn comes back as
    this rank's block of the merged row."""
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (es, ef, df, cov, v, w_c))
    if plan is not None:
        if grad:
            return FusedAttentionSP.apply(es, ef, mask, df, cov, v, w_c,
                                          use_coverage, plan)
        return _attention_rows_sp(plan, es, ef, mask, df, cov, v, w_c,
                                  use_coverage)
    if grad:
        return FusedAttention.apply(es, ef, mask, df, cov, v, w_c,
                                    use_coverage)
    return _attention_rows(es, ef, mask, df, cov, v, w_c, use_coverage)
