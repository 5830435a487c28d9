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
the kernel does not take (``_shape_refusal``).

Dispatch: a CPU tensor goes to ``_attention_plain`` (the formula of
``_attention_xla_shared`` / ``_attention_xla``, pallas_attention.py:96-132);
a CUDA tensor goes to the kernel, or the wrapper raises.  There is no
fallback from one to the other.  ``launches`` counts kernel launches.
Forward only: serving never differentiates; the backward comes with
the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG = -1e30  # masked-energy floor (pallas_attention.NEG), never -inf

#: kernel launches so far (one per wrapper call on CUDA tensors); set it
#: to 0 before a run whose launches are to be counted
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _attention_plain(es: torch.Tensor, ef: torch.Tensor, mask: torch.Tensor,
                     df: torch.Tensor, cov: torch.Tensor, v: torch.Tensor,
                     w_c: torch.Tensor, use_coverage: bool,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference formula in plain PyTorch.

    es, ef [B, T, D] (f32 or bf16, upcast here); mask [B, T]; df [B, K, D];
    cov [B, K, T] (read only when use_coverage); v, w_c [D].
    Returns (ctx [B, K, D], attn [B, K, T]), both f32."""
    feats = ef.float()[:, None, :, :] + df[:, :, None, :]  # [B, K, T, D]
    if use_coverage:
        feats = feats + cov[:, :, :, None] * w_c
    e = torch.sum(v * torch.tanh(feats), dim=-1)  # [B, K, T]
    valid = (mask > 0)[:, None, :]
    e = torch.where(valid, e, NEG)
    e = e - torch.amax(e, dim=-1, keepdim=True)
    p = torch.exp(e) * valid
    # fully-masked row: clamp the 0 denominator -> zero attention, not NaN
    attn = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    ctx = attn @ es.float()  # [B, K, T] @ [B, T, D]
    return ctx, attn


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from textsummarization_on_flink_tpu_torch.kernels import build

        lib = ctypes.CDLL(build.build("fused_attention"))
        fn = lib.ts_fused_attention_shared
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.ts_cuda_error_string.restype = ctypes.c_char_p
        lib.ts_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


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
# positions, a ring of at most 8 chunks, clusters of up to 8 blocks per
# article (16 for few articles, which only makes a block's share of T
# smaller)
_CHUNK, _STAGES, _CLUSTER = 8, 8, 8
_BAR_FLOATS = 16  # the ring's mbarriers, ahead of it
_SMEM_MAX = 232_448  # bytes of shared memory a block may use on Hopper


def _smem_bytes(T: int, D: int, K: int, elt: int) -> int:
    """Dynamic shared memory of one block (smem_floats in the source)."""
    def ceil_div(a, b):
        return -(-a // b)

    C = min(ceil_div(T, _CHUNK), _CLUSTER)  # blocks per article
    P = ceil_div(ceil_div(T, C), _CHUNK) * _CHUNK  # positions per block
    floats = (_BAR_FLOATS + _STAGES * _CHUNK * D * elt // 4 + 2 * K * D
              + 2 * D + P * (2 * K + 1) + (3 + 2 * C) * K)
    return 4 * floats


def _shape_refusal(es: torch.Tensor, df: torch.Tensor) -> Optional[str]:
    """Why the kernel does not take these shapes (None when it does).
    Checked before the device, so it holds for tensors anywhere."""
    if es.dim() != 3 or df.dim() != 3:
        return (f"es must be [B, T, D] and df [B, K, D], got "
                f"{tuple(es.shape)} and {tuple(df.shape)}")
    B, T, D = es.shape
    K = df.shape[1]
    if B == 0 or T == 0 or K == 0 or D == 0:
        return f"empty attention input (B={B}, T={T}, K={K}, D={D})"
    elt = 2 if es.dtype == torch.bfloat16 else 4
    if D % (16 // elt):
        return (f"D={D} is not a multiple of {16 // elt}: the kernel stages "
                f"16-byte pieces of each {es.dtype} encoder row")
    if _smem_bytes(T, D, K, elt) > _SMEM_MAX:
        return (f"T={T}, K={K}, D={D} exceed one block's shared memory "
                f"({_smem_bytes(T, D, K, elt)} > {_SMEM_MAX} bytes)")
    return None


def _attention_cuda(es, ef, mask, df, cov, v, w_c, use_coverage):
    """Launch the kernel; same contract as _attention_plain."""
    global launches
    refusal = _shape_refusal(es, df)
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
    lib = _load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ts_fused_attention_shared(
            es.data_ptr(), ef.data_ptr(), mask.data_ptr(), df.data_ptr(),
            cov.data_ptr(), v.data_ptr(), w_c.data_ptr(), ctx.data_ptr(),
            attn.data_ptr(), B, T, D, K, int(bool(use_coverage)),
            int(es.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("fused attention kernel launch failed: "
                           + lib.ts_cuda_error_string(err).decode())
    launches += 1
    return ctx, attn


def fused_attention_shared(es: torch.Tensor, ef: torch.Tensor,
                           mask: torch.Tensor, df: torch.Tensor,
                           cov: torch.Tensor, v: torch.Tensor,
                           w_c: torch.Tensor, use_coverage: bool,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx [B, K, D], attn [B, K, T]) for K queries per article against
    the article's one encoder copy (es/ef [B, T, D], mask [B, T],
    df [B, K, D], cov [B, K, T]).  cov is read only when use_coverage
    (pass zeros otherwise).  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if es.device.type == "cpu":
        return _attention_plain(es, ef, mask, df, cov, v, w_c, use_coverage)
    return _attention_cuda(es, ef, mask, df, cov, v, w_c, use_coverage)


def fused_attention(es: torch.Tensor, ef: torch.Tensor, mask: torch.Tensor,
                    df: torch.Tensor, cov: torch.Tensor, v: torch.Tensor,
                    w_c: torch.Tensor, use_coverage: bool,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-row form (one query per row, pallas_attention.fused_attention):
    df [B, D], cov [B, T] -> (ctx [B, D], attn [B, T])."""
    ctx, attn = fused_attention_shared(
        es, ef, mask, df[:, None, :].contiguous(),
        cov[:, None, :].contiguous(), v, w_c, use_coverage)
    return ctx[:, 0], attn[:, 0]
