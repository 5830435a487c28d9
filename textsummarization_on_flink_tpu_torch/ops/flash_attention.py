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

q, k, v are [B, T, nh, hd] float32 (the layout ``_split_heads`` gives, so
no transposes), key_mask [B, T] float32 (1 = real token) or None (every
key real); the output is the context [B, T, nh, hd] before ``wo``.

Dispatch: a CPU tensor goes to ``_flash_plain``; a CUDA tensor goes to
the kernel (kernels/flash_attention.cu), or the wrapper raises.  There is
no fallback from one to the other.  ``launches`` counts kernel launches.
Forward only: serving never differentiates; the backward (dK/dV and dQ)
comes with the transformer's training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from textsummarization_on_flink_tpu_torch.ops.fused_attention import _check

NEG = -1e30  # masked-logit floor (transformer._mha), never -inf

#: head dims the kernel is built for (the switch in ts_flash_attention)
HEAD_DIMS = (32, 128)

#: kernel launches so far (one per wrapper call on CUDA tensors); set it
#: to 0 before a run whose launches are to be counted
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _allowed(key_mask: Optional[torch.Tensor], causal: bool, B: int, T: int,
             device) -> torch.Tensor:
    """[B, 1, T, T] boolean: may query row i attend key j."""
    if key_mask is None:
        ok = torch.ones((B, 1, 1, T), dtype=torch.bool, device=device)
    else:
        ok = (key_mask > 0)[:, None, None, :]
    if causal:
        ok = ok & torch.ones((T, T), dtype=torch.bool, device=device).tril()
    return ok.expand(B, 1, T, T)


def _flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_mask: Optional[torch.Tensor], causal: bool,
                 sm_scale: float) -> torch.Tensor:
    """The einsum formula in plain PyTorch (the [B, nh, T, T] scores are
    materialised).  Returns [B, T, nh, hd] float32."""
    B, T = q.shape[:2]
    logits = torch.einsum("bqnd,bknd->bnqk", q, k) * sm_scale
    ok = _allowed(key_mask, causal, B, T, q.device)
    logits = torch.where(ok, logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    # a row with no key to attend: uniform over -1e30 logits -> zeros
    probs = torch.where(ok.any(dim=-1, keepdim=True), probs, 0.0)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from textsummarization_on_flink_tpu_torch.kernels import build

        lib = ctypes.CDLL(build.build("flash_attention"))
        fn = lib.ts_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        lib.ts_flash_error_string.restype = ctypes.c_char_p
        lib.ts_flash_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _flash_cuda(q, k, v, key_mask, causal, sm_scale):
    """Launch the kernel; same contract as _flash_plain."""
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash attention kernel needs CUDA tensors, "
                         f"got {dev}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, nh, hd], got {tuple(q.shape)}")
    B, T, nh, hd = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, (B, T, nh, hd), (torch.float32,), dev)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    if key_mask is not None:
        _check("key_mask", key_mask, (B, T), (torch.float32,), dev)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if B == 0 or T == 0 or nh == 0:
        raise ValueError(f"empty attention input (B={B}, T={T}, nh={nh})")
    out = torch.empty_like(q)
    lib = _load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ts_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if key_mask is None else key_mask.data_ptr(), out.data_ptr(),
            B, T, nh, hd, int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.ts_flash_error_string(err).decode())
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor], causal: bool,
                    sm_scale: float) -> torch.Tensor:
    """Self-attention context [B, T, nh, hd] (see the module docstring).
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, key_mask, causal, sm_scale)
    return _flash_cuda(q, k, v, key_mask, causal, sm_scale)
