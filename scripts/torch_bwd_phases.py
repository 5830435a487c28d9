#!/usr/bin/env python3
"""Where the fused attention's backward kernel spends its time, phase by
phase, on one CUDA card.

    python3 scripts/torch_bwd_phases.py [--seed N] [--iters N]

Builds kernels/fused_attention_bwd.cu a second time with -DTS_BWD_TRACE
(kernels/build.py, into the git-ignored kernels/_build/) and has
ops/fused_attention.py's wrapper launch that build.  In it thread 0 of
every block records its SM, the global timer at its start and at its
last mark, and its SM clock at each of the kernel's marks: 1 the first
es chunk landed, 2 pass one done, 3 S known, 4 pass two done, 5 the
column sums written, 6 the ticket taken, 7 (the last cluster) d_v and
d_w_c written, 8 the cluster's blocks all done with pass one.  Runs the
traced kernel at chip_smoke's phase-3b shapes (16 x 400 x 512 with
coverage on and off, 4 x 4096 x 512), each launch after the same L2
flush and spin as chip_smoke.time_cuda, and prints one JSON line per
shape: the medians over --iters launches of each mark's median over the
blocks, in microseconds at the SM clock measured from the blocks' own
timer and clock; the spread of the blocks' start times; the SMs the
blocks ran on (their count and the most blocks on one); the kernel's
CUDA-event time; and its largest error against the plain backward,
scaled by max(1, max|want|) per output.  The traced build is for
reading the phases only: its marks cost a few stores per block.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MARKS = ("first_chunk", "pass_one", "S", "pass_two", "column_sums",
         "ticket", "last_cluster", "cluster_sync_S")
SLOTS = 12  # kTraceSlots in the source
BLOCKS = 4096  # kTraceBlocks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from textsummarization_on_flink_tpu_torch.device import resolve_device
    from textsummarization_on_flink_tpu_torch.kernels import build
    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    resolve_device("cuda")
    print(chip_smoke.card_line())
    dll = fa._bind_bwd(build.build("fused_attention_bwd",
                                   defines=("-DTS_BWD_TRACE",)))
    dll.ts_fused_attention_bwd_trace.restype = ctypes.c_int
    dll.ts_fused_attention_bwd_trace.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
    fa._bwd_lib = dll  # the wrapper launches the traced build
    flush = torch.empty(96 * 2**20 // 4, device="cuda")
    trace = (ctypes.c_ulonglong * (BLOCKS * SLOTS))()
    for B, T, D, use_cov in chip_smoke.ATTENTION_BWD_CASES:
        a = chip_smoke.attention_bwd_args(fa, B, T, D, use_cov, args.seed)
        per_mark = {m: [] for m in MARKS}
        spread, span, event_ms, clocks = [], [], [], []
        sms_used, most_per_sm = [], []
        for it in range(args.iters + 3):
            flush.zero_()
            torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs = fa._attention_bwd_cuda(*a)
            end.record()
            end.synchronize()
            if it < 3:  # warm-up: its marks are cleared
                dll.ts_fused_attention_bwd_trace(trace, BLOCKS * SLOTS)
                continue
            event_ms.append(start.elapsed_time(end))
            n = dll.ts_fused_attention_bwd_trace(trace, BLOCKS * SLOTS)
            if n:
                raise RuntimeError(f"trace read failed: {n}")
            blocks = [trace[i * SLOTS:(i + 1) * SLOTS] for i in range(BLOCKS)
                      if trace[i * SLOTS]]
            t0 = min(row[0] for row in blocks)
            spread.append((max(row[0] for row in blocks) - t0) / 1e3)
            span.append((max(row[1] for row in blocks) - t0) / 1e3)
            # SM clocks per microsecond: each block's last mark against
            # the global timer (ns) over the same interval
            mhz = statistics.median(
                max(row[3:11]) / ((row[1] - row[0]) / 1e3) for row in blocks
                if row[1] > row[0])
            clocks.append(mhz)
            per_sm = collections.Counter(row[11] for row in blocks)
            sms_used.append(len(per_sm))
            most_per_sm.append(max(per_sm.values()))
            for k, m in enumerate(MARKS):
                vals = [row[k + 3] / mhz for row in blocks if row[k + 3]]
                if vals:
                    per_mark[m].append(statistics.median(vals))
        want = fa._attention_bwd_plain(*a)
        err = max(float((x - w).abs().max()) / max(1.0, float(w.abs().max()))
                  for x, w in zip(outs, want))
        print(json.dumps(dict(
            scaled_err=err, shape=f"{B}x1x{T}x{D}",
            coverage=use_cov,
            blocks=len(blocks), sms_used=statistics.median(sms_used),
            most_blocks_per_sm=max(most_per_sm),
            event_ms=statistics.median(event_ms),
            block_start_spread_us=statistics.median(spread),
            first_start_to_last_mark_us=statistics.median(span),
            mark_us={m: statistics.median(v) for m, v in per_mark.items()
                     if v}, sm_clock_mhz=statistics.median(clocks))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
