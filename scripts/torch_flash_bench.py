#!/usr/bin/env python3
"""CUDA-event times of the port's flash kernels at chip_smoke.py's
phase-3 shapes, for comparing two checkouts on one card.

    python3 scripts/torch_flash_bench.py [--seed N] [--iters N] [--tag T]
        [--dtype float32|bfloat16] [--which times|wide|digests]
        [--head-dims HD ...] [--kernels K ...]

Needs one CUDA card.  It times whichever package comes first on the
import path: put another checkout on PYTHONPATH to time its kernels with
this script (the repo root is appended to sys.path, so a PYTHONPATH
checkout wins).  Shapes (as in chip_smoke.py phase 3): the forward
without lse at 16x400x8x32 (key mask; causal) and 4x2048x8x128 (key
mask; causal); the forward with lse at 16x400x8x32 (key mask) and
16x100x8x32 (causal); the dK/dV and dQ kernels at those two and at
4x2048x8x128 (key mask; causal).  With --dtype bfloat16 the kernels'
bf16 forms at chip_smoke.py's phase_flash_bf16 shapes (16x400x8x32 key
mask, 16x100x8x32 causal, 4x2048x8x128 key mask and causal, 16x400x2x256
key mask): the forward without lse (the serving form) and with it (the
training form, forward_lse), and the dK/dV and dQ kernels, each also
with its host microseconds per call (the wrapper's enqueue, the tensor
maps' encoding included, averaged over --iters calls without a
synchronize).  ``--which wide``: the wide kernels (head dims above 256)
at chip_smoke.py's WIDE_FLASH_CASES (16x400x1x384, x512, x1024 with a
key mask, 16x100x1x512 causal) in f32 and bf16 (--dtype is not read):
the forward without and with lse, the dK/dV and the dQ kernels, and
the SIMT forms the cluster forms replaced where the checkout's wrappers
take ``simt`` (the dQ's only where its wrapper has the flag), so one
call times the SIMT design beside the cluster forms; ``--head-dims HD
...`` times those head dims only: WIDE_FLASH_CASES' cases at them, and
16x400x1xHD with a key mask where the cases have none; ``--kernels K
...`` times those of forward, forward_lse, bwd_dkv, bwd_dq and their
``_simt`` forms only.  Each cluster form's line also has
``active_clusters``: the clusters of its instance resident at once on
the card (``ts_flash_wide_active_clusters_at``).
``--which digests`` prints one JSON line of chip_smoke.flash_digests:
the digests of every flash kernel's outputs at the launch forms with as
many query rows as keys (chip_smoke.FLASH_DIGEST_CASES, inputs made with
numpy), which chip_smoke.py holds against its FLASH_PARENT_DIGESTS; run
it with the parent checkout on PYTHONPATH to print those; and ("c16")
those of the clusters past 8 blocks at
FLASH_C16_DIGEST_CASES through their default launch, which
FLASH_C16_DIGESTS holds, and ("slabs") those of the multi-slab forms
above head dim 2048 at FLASH_SLAB_DIGEST_CASES, which FLASH_SLAB_DIGESTS
holds.  Each time is
the median of --iters
launches, each after a write of 96 MB (more than the L2 cache), timed
with CUDA events by this checkout's chip_smoke.time_cuda (also when the
kernels come from another checkout).  Prints the card's name and power
limit, the package's path, and one JSON line per (kernel, shape).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)  # a PYTHONPATH checkout of the package comes first


def _this_chip_smoke():
    """chip_smoke.py beside this script, whatever is on PYTHONPATH: both
    checkouts are timed with the same harness."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

FWD = [(16, 400, 8, 32, False), (16, 400, 8, 32, True),
       (4, 2048, 8, 128, False), (4, 2048, 8, 128, True)]
LSE = [(16, 400, 8, 32, False), (16, 100, 8, 32, True)]
BWD = LSE + [(4, 2048, 8, 128, False), (4, 2048, 8, 128, True)]
BF16 = [(16, 400, 8, 32, False), (16, 100, 8, 32, True),
        (4, 2048, 8, 128, False), (4, 2048, 8, 128, True),
        (16, 400, 2, 256, False)]
#: the wide library's kind (fl.WIDE_KINDS) of each timed kernel
KIND = dict(forward="fwd", forward_lse="fwd", bwd_dkv="dkv", bwd_dq="dq")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--tag", default="")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--which", choices=("times", "wide", "digests"),
                    default="times")
    ap.add_argument("--head-dims", type=int, nargs="*", default=None)
    ap.add_argument("--kernels", nargs="*", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke = _this_chip_smoke()
    from textsummarization_on_flink_tpu_torch.device import resolve_device
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    resolve_device("cuda")
    print(chip_smoke.card_line())
    print(os.path.dirname(os.path.dirname(os.path.abspath(fl.__file__))))
    flush = torch.empty(96 * 2**20 // 4, device="cuda")

    def emit(kernel, shape, ms, **extra):
        B, T, nh, hd, causal = shape
        print(json.dumps(dict(tag=args.tag, dtype=args.dtype, kernel=kernel,
                              shape=f"{B}x{T}x{nh}x{hd}", causal=causal,
                              key_mask=not causal, ms=ms, **extra)))

    if args.which == "digests":
        print(json.dumps(dict(
            tag=args.tag, digests=chip_smoke.flash_digests(fl),
            c16=chip_smoke.flash_digests(
                fl, chip_smoke.FLASH_C16_DIGEST_CASES, simt=False),
            slabs=chip_smoke.flash_digests(
                fl, chip_smoke.FLASH_SLAB_DIGEST_CASES, simt=False))))
        return 0
    if args.which == "wide":
        bench_wide(args, chip_smoke, fl, flush, emit)
        return 0
    if args.dtype == "bfloat16":
        bench_bf16(args, chip_smoke, fl, flush, emit)
        return 0
    for shape in FWD:
        B, T, nh, hd, causal = shape
        q, k, v, mask = chip_smoke.flash_inputs(B, T, nh, hd, args.seed,
                                                not causal)
        emit("forward", shape, chip_smoke.time_cuda(
            lambda: fl._flash_cuda(q, k, v, mask, causal, hd ** -0.5),
            args.iters, flush))
    for shape in BWD:
        B, T, nh, hd, causal = shape
        q, k, v, mask = chip_smoke.flash_inputs(B, T, nh, hd, args.seed,
                                                not causal)
        scale = hd ** -0.5
        if shape in LSE:
            emit("forward_lse", shape, chip_smoke.time_cuda(
                lambda: fl._flash_cuda(q, k, v, mask, causal, scale,
                                       with_lse=True), args.iters, flush))
        out, lse = fl._flash_cuda(q, k, v, mask, causal, scale,
                                  with_lse=True)
        do = torch.randn_like(q)
        dsum = torch.sum(do * out, dim=-1)
        emit("bwd_dkv", shape, chip_smoke.time_cuda(
            lambda: fl._bwd_dkv_cuda(q, k, v, do, lse, dsum, mask, causal,
                                     scale), args.iters, flush))
        emit("bwd_dq", shape, chip_smoke.time_cuda(
            lambda: fl._bwd_dq_cuda(q, k, v, do, lse, dsum, mask, causal,
                                    scale), args.iters, flush))
    return 0


def host_us(fn, iters):
    """Host microseconds per call of fn, enqueued back to back."""
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def bench_wide(args, chip_smoke, fl, flush, emit):
    """The wide kernels at chip_smoke.WIDE_FLASH_CASES (or --head-dims)
    in both dtypes; a
    checkout whose wrappers take ``simt`` also times its SIMT forward and
    dK/dV, and its SIMT dQ where the dQ's wrapper takes the flag."""
    import inspect

    import torch

    simt = "simt" in inspect.signature(fl._flash_cuda).parameters
    simt_dq = "simt" in inspect.signature(fl._bwd_dq_cuda).parameters
    cases = chip_smoke.WIDE_FLASH_CASES
    if args.head_dims:
        cases = [c for c in cases if c[3] in args.head_dims] + [
            (16, 400, 1, hd, False) for hd in args.head_dims
            if (16, 400, 1, hd, False) not in cases]
    for dtype in (torch.float32, torch.bfloat16):
        args.dtype = str(dtype).replace("torch.", "")
        for shape in cases:
            B, T, nh, hd, causal = shape
            q, k, v, mask = chip_smoke.flash_inputs(B, T, nh, hd, args.seed,
                                                    not causal)
            q, k, v = (x.to(dtype) for x in (q, k, v))
            scale = hd ** -0.5
            out, lse = fl._flash_cuda(q, k, v, mask, causal, scale,
                                      with_lse=True)
            g = torch.Generator(device="cuda").manual_seed(args.seed)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            dsum = torch.sum(do.float() * out.float(), dim=-1)
            runs = [("forward", lambda: fl._flash_cuda(q, k, v, mask, causal,
                                                       scale)),
                    ("forward_lse", lambda: fl._flash_cuda(
                        q, k, v, mask, causal, scale, with_lse=True)),
                    ("bwd_dkv", lambda: fl._bwd_dkv_cuda(
                        q, k, v, do, lse, dsum, mask, causal, scale)),
                    ("bwd_dq", lambda: fl._bwd_dq_cuda(
                        q, k, v, do, lse, dsum, mask, causal, scale))]
            if simt:  # the SIMT design the cluster forms replaced
                runs += [("forward_simt", lambda: fl._flash_cuda(
                    q, k, v, mask, causal, scale, simt=True)),
                         ("bwd_dkv_simt", lambda: fl._bwd_dkv_cuda(
                             q, k, v, do, lse, dsum, mask, causal, scale,
                             simt=True))]
            if simt_dq:
                runs.append(("bwd_dq_simt", lambda: fl._bwd_dq_cuda(
                    q, k, v, do, lse, dsum, mask, causal, scale, simt=True)))
            for kernel, fn in runs:
                if args.kernels and kernel not in args.kernels:
                    continue
                extra = {}
                if not kernel.endswith("_simt"):
                    # the clusters of the launch's instance resident at once
                    extra["active_clusters"] = (
                        fl._load_wide_library()
                        .ts_flash_wide_active_clusters_at(
                            fl.WIDE_KINDS.index(KIND[kernel]),
                            dtype == torch.bfloat16, hd))
                emit(kernel, shape, chip_smoke.time_cuda(fn, args.iters,
                                                         flush), **extra)


def bench_bf16(args, chip_smoke, fl, flush, emit):
    """The bf16 forms at phase_flash_bf16's shapes."""
    import torch

    for shape in BF16:
        B, T, nh, hd, causal = shape
        q, k, v, mask = chip_smoke.flash_inputs(B, T, nh, hd, args.seed,
                                                not causal)
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        scale = hd ** -0.5
        out, lse = fl._flash_cuda(q, k, v, mask, causal, scale,
                                  with_lse=True)
        do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
        dsum = torch.sum(do.float() * out.float(), dim=-1)
        for kernel, fn in (
                ("forward", lambda: fl._flash_cuda(q, k, v, mask, causal,
                                                   scale)),
                ("forward_lse", lambda: fl._flash_cuda(
                    q, k, v, mask, causal, scale, with_lse=True)),
                ("bwd_dkv", lambda: fl._bwd_dkv_cuda(
                    q, k, v, do, lse, dsum, mask, causal, scale)),
                ("bwd_dq", lambda: fl._bwd_dq_cuda(
                    q, k, v, do, lse, dsum, mask, causal, scale))):
            emit(kernel, shape, chip_smoke.time_cuda(fn, args.iters, flush),
                 host_us=host_us(fn, args.iters))


if __name__ == "__main__":
    sys.exit(main())
