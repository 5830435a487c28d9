#!/usr/bin/env python3
"""CUDA-event times of the port's fused additive attention kernel and
its backward at chip_smoke.py's phase-3 shapes, for comparing two
checkouts on one card.

    python3 scripts/torch_attention_bench.py [--seed N] [--iters N] [--tag T]
        [--which forward|backward|both|digests]

Needs one CUDA card.  It times whichever package comes first on the
import path: put another checkout on PYTHONPATH to time its kernel with
this script (the repo root is appended to sys.path, so a PYTHONPATH
checkout wins), as scripts/torch_flash_bench.py does for the flash
kernels.  Shapes (as in chip_smoke.py phase 3): 16 articles x 4 beams x
T 400 x D 512 (the beam-decode shape), 4 x 1 x 4096 x 512 (the long
form) and 16 x 1 x 400 x 512 (the pointer-generator's training shape),
each in f32 and bf16, coverage on and off, with chip_smoke's
inputs (ragged lengths, article 1 fully masked).  The backward
(``_attention_bwd_cuda``, whose signature has not changed since it was
ported) at chip_smoke's phase-3b shapes: 16 x 1 x 400 x 512 with
coverage on and off, and 4 x 1 x 4096 x 512, with chip_smoke's
attention_bwd_args and attention_bwd_bound_ms.  Each time is the
median of --iters launches, each after a write of 96 MB (more than the L2
cache), timed with CUDA events by this checkout's chip_smoke.time_cuda.
Prints the card's name and power limit, the package's path, and one JSON
line per (kernel, shape, dtype, coverage) with the time and the bound;
a forward line also carries ``digest``, a hash of the outputs' bytes
(ctx, attn), so two checkouts' lines show whether their kernels give
the same bits.  ``--which digests`` prints one JSON line of
chip_smoke.fused_digests: the forward's and the backward's output
digests at every launch form the tree before the slab and sp-block
forms took, on inputs made with numpy (chip_smoke.digest_inputs), which
chip_smoke.py holds against its PARENT_DIGESTS.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)  # a PYTHONPATH checkout of the package comes first

SHAPES = [(16, 4, 400, 512), (4, 1, 4096, 512), (16, 1, 400, 512)]


def _this_chip_smoke():
    """chip_smoke.py beside this script, whatever is on PYTHONPATH: both
    checkouts are timed with the same harness."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--tag", default="")
    ap.add_argument("--which",
                    choices=("forward", "backward", "both", "digests"),
                    default="both")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_attention_bench: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke = _this_chip_smoke()
    from textsummarization_on_flink_tpu_torch.device import resolve_device
    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    resolve_device("cuda")
    print(chip_smoke.card_line())
    print(os.path.dirname(os.path.dirname(os.path.abspath(fa.__file__))))
    if args.which == "digests":
        print(json.dumps(dict(tag=args.tag,
                              digests=chip_smoke.fused_digests(fa))))
        return 0
    flush = torch.empty(96 * 2**20 // 4, device="cuda")
    if args.which != "backward":
        _bench_forward(chip_smoke, fa, flush, args)
    if args.which != "forward":
        _bench_backward(chip_smoke, fa, flush, args)
    return 0


def _bench_forward(chip_smoke, fa, flush, args):
    import torch

    for (B, K, T, D) in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for use_cov in (True, False):
                inputs = chip_smoke.attention_inputs(B, K, T, D, dtype,
                                                     args.seed)
                ctx, attn = fa._attention_cuda(*inputs, use_cov)
                digest = hashlib.sha256(
                    ctx.cpu().numpy().tobytes()
                    + attn.cpu().numpy().tobytes()).hexdigest()[:16]
                ms = chip_smoke.time_cuda(
                    lambda: fa._attention_cuda(*inputs, use_cov), args.iters,
                    flush)
                elt = 2 if dtype == torch.bfloat16 else 4
                bound, by, _, _ = chip_smoke.attention_bound_ms(
                    B, K, T, D, elt, use_cov)
                print(json.dumps(dict(
                    tag=args.tag, kernel="fused_attention",
                    shape=f"{B}x{K}x{T}x{D}",
                    dtype=str(dtype).replace("torch.", ""),
                    coverage=use_cov, ms=ms, bound_ms=bound, bound_by=by,
                    digest=digest)))


def _bench_backward(chip_smoke, fa, flush, args):
    for (B, T, D, use_cov) in chip_smoke.ATTENTION_BWD_CASES:
        bwd_args = chip_smoke.attention_bwd_args(fa, B, T, D, use_cov,
                                                 args.seed)
        ms = chip_smoke.time_cuda(lambda: fa._attention_bwd_cuda(*bwd_args),
                                  args.iters, flush)
        bound, by, _, _ = chip_smoke.attention_bwd_bound_ms(B, T, D, use_cov)
        print(json.dumps(dict(
            tag=args.tag, kernel="fused_attention_bwd",
            shape=f"{B}x1x{T}x{D}", dtype="float32", coverage=use_cov,
            ms=ms, bound_ms=bound, bound_by=by)))


if __name__ == "__main__":
    sys.exit(main())
