#!/usr/bin/env python3
"""Accuracy of the port's flash kernels against float64, beside the plain
f32 version's.

    python3 scripts/torch_flash_precision.py [--seed N] [--long]
        [--head-dims HD ...] [--json PATH]

Needs one CUDA card.  For head dims 32 and 128 (or --head-dims': above
256 the wide kernels, e.g. 6272 8192), q and k of std 1 (unit
scale) and 2 (|s| up to ~20, as in a trained model), causal off (with a
ragged key mask, article 1 empty) and on, at 3 articles x 200 positions x
2 heads, and with --long also at chip_smoke.py's long-context shape
(4 x 2048 x 8 heads x hd 128, unit scale, both forms), it runs the
forward (with lse), the dK/dV and the dQ kernels and prints one JSON
line per case: for out, lse, dq, dk and dv the largest
absolute error of the kernel and of the plain f32 version (on the card,
TF32 off) against the plain version in float64 on the same inputs, and
the largest |value|.  The backward's float64 reference takes the
kernel's own out (D = rowsum(dO * out)) and float64's lse, so the
gradient errors include what the forward's lse error carries in.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)  # a PYTHONPATH checkout of the package comes first


def _inputs(torch, seed, B, T, nh, hd, qk_std, causal):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, T, nh, hd, generator=g, device="cuda")
               for _ in range(3))
    q, k = q * qk_std, k * qk_std
    if causal:
        return q, k, v, None
    lens = torch.randint(T // 3, T + 1, (B,), generator=g, device="cuda")
    lens[0] = T
    mask = (torch.arange(T, device="cuda")[None] < lens[:, None]).float()
    mask[1] = 0.0
    return q, k, v, mask


def case(torch, fl, seed, hd, qk_std, causal, B=3, T=200, nh=2):
    q, k, v, mask = _inputs(torch, seed, B, T, nh, hd, qk_std, causal)
    scale = hd ** -0.5
    out, lse = fl._flash_cuda(q, k, v, mask, causal, scale, with_lse=True)
    do = torch.randn_like(out)
    dsum = torch.sum(do * out, dim=-1)
    dk, dv = fl._bwd_dkv_cuda(q, k, v, do, lse, dsum, mask, causal, scale)
    dq = fl._bwd_dq_cuda(q, k, v, do, lse, dsum, mask, causal, scale)

    def f64(x):
        return None if x is None else x.double()

    out64 = fl._flash_plain(f64(q), f64(k), f64(v), f64(mask), causal, scale)
    lse64 = fl._flash_lse_plain(f64(q), f64(k), f64(mask), causal, scale)
    grads64 = fl._flash_bwd_plain(f64(q), f64(k), f64(v), f64(out), lse64,
                                  f64(do), f64(mask), causal, scale)
    out32 = fl._flash_plain(q, k, v, mask, causal, scale)
    lse32 = fl._flash_lse_plain(q, k, mask, causal, scale)
    grads32 = fl._flash_bwd_plain(q, k, v, out, lse32, do, mask, causal,
                                  scale)
    finite = torch.isfinite(lse64)

    def err(x, ref, keep=None):
        d = (x.double() - ref).abs()
        if keep is not None:
            d = torch.where(keep, d, 0.0)
        return float(d.max())

    row = dict(shape=f"{B}x{T}x{nh}x{hd}", qk_std=qk_std, causal=causal,
               max_abs_s=float((torch.einsum("bqnd,bknd->bnqk", q, k)
                                * scale).abs().max()))
    row["out"] = dict(kernel=err(out, out64), plain_f32=err(out32, out64),
                      max_abs=float(out64.abs().max()))
    row["lse"] = dict(kernel=err(lse, lse64, finite),
                      plain_f32=err(lse32, lse64, finite),
                      max_abs=float(torch.where(finite, lse64, 0.0)
                                    .abs().max()))
    for name, got, p32, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                   grads32, grads64):
        row[name] = dict(kernel=err(got, ref), plain_f32=err(p32, ref),
                         max_abs=float(ref.abs().max()))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--long", action="store_true",
                    help="also the 4 x 2048 x 8 x 128 shape")
    ap.add_argument("--head-dims", type=int, nargs="+", default=[32, 128],
                    help="the head dims of the 3 x 200 x 2 cases")
    ap.add_argument("--json", default=None,
                    help="also write the rows to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_precision: no CUDA device", file=sys.stderr)
        return 1
    from textsummarization_on_flink_tpu_torch.device import resolve_device
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    resolve_device("cuda")  # TF32 off for the plain version's products
    cases = [(hd, qk_std, causal, 3, 200, 2) for hd in args.head_dims
             for qk_std in (1.0, 2.0) for causal in (False, True)]
    if args.long:
        cases += [(128, 1.0, causal, 4, 2048, 8) for causal in (False, True)]
    rows = []
    for hd, qk_std, causal, B, T, nh in cases:
        row = case(torch, fl, args.seed, hd, qk_std, causal, B, T, nh)
        print("precision " + json.dumps(row))
        rows.append(row)
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
