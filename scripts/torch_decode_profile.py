#!/usr/bin/env python3
"""Where a full-width beam-decode batch of the PyTorch port spends its time.

    python3 scripts/torch_decode_profile.py [--seed N] [--batches N]
        [--family pointer_generator|transformer]
        [--compute_dtype float32|bfloat16]

Needs one CUDA card.  Builds full-width params of the family from --seed
(V=50,000, 400 encoder steps, 100 decoder steps, beam 4, batch 16;
pointer-generator H=256, E=128, coverage on; transformer H=256, 8 heads,
6 + 6 layers, FFN 1024; --compute_dtype as the decoder's flag, f32 by
default), decodes one warm-up batch, then decodes
--batches batches under torch.profiler and prints one JSON line:

  * batch_ms: host wall time per batch (ends in a device sync);
  * phase_ms: host time of the labelled phases (decode/encode,
    decode/search, decode/finalize in decode/beam_search.py);
  * device_busy_ms / device_busy_share: summed CUDA kernel time over the
    profiled wall time (kernels do not overlap on one stream, so the sum
    is the time the card was busy); idle share = 1 - busy share;
  * kernels_per_step: CUDA kernel launches per decode step;
  * attention_launches / flash_launches: the port's own kernels'
    launch counts over the profiled batches;
  * top_kernels: the device time by kernel name, largest first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--family", default="pointer_generator",
                    choices=("pointer_generator", "transformer"))
    ap.add_argument("--compute_dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from textsummarization_on_flink_tpu_torch.config import HParams
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.device import resolve_device
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa
    from textsummarization_on_flink_tpu_torch.params import (
        from_numpy_tree,
        init_numpy_params,
    )

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    hps = HParams(hidden_dim=256, emb_dim=128, vocab_size=50000,
                  max_enc_steps=400, max_dec_steps=100, min_dec_steps=35,
                  beam_size=4, batch_size=16, coverage=True, mode="decode",
                  compute_dtype=args.compute_dtype)
    if args.family == "transformer":
        hps = hps.replace(model_family="transformer", coverage=False,
                          num_heads=8, enc_layers=6, dec_layers=6,
                          ffn_dim=1024)
    params = from_numpy_tree(
        init_numpy_params(hps, hps.vocab_size, args.seed), dev)
    rng = np.random.default_rng(args.seed)
    B, T = hps.batch_size, hps.max_enc_steps

    def batch():
        lens = rng.integers(T // 2, T + 1, B)
        mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
        ids = np.where(mask > 0, rng.integers(4, hps.vocab_size, (B, T)), 1)
        ext = np.where((rng.random((B, T)) < 0.05) & (mask > 0),
                       hps.vocab_size + rng.integers(0, 20, (B, T)), ids)
        return dict(enc_batch=ids.astype(np.int32),
                    enc_lens=lens.astype(np.int32), enc_padding_mask=mask,
                    enc_batch_extend_vocab=ext.astype(np.int32))

    beam_search.run_beam_search(params, hps, batch())  # warm-up
    torch.cuda.synchronize()
    batches = [batch() for _ in range(args.batches)]
    beam_search.steps_run = 0
    fa.launches = 0
    fl.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for arrays in batches:
            beam_search.run_beam_search(params, hps, arrays)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = beam_search.steps_run

    kernel_us = {}
    n_kernels = 0
    phase_ms = {}
    for evt in prof.events():
        on_card = "CUDA" in str(getattr(evt, "device_type", ""))
        if evt.name.startswith("decode/"):
            if not on_card:  # the host range, not its mirror on the card
                phase_ms[evt.name] = phase_ms.get(evt.name, 0.0) + \
                    evt.cpu_time_total / 1e3 / args.batches
            continue
        if on_card:
            n_kernels += 1
            kernel_us[evt.name] = kernel_us.get(evt.name, 0.0) + \
                evt.time_range.elapsed_us()
    busy_ms = sum(kernel_us.values()) / 1e3
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:15]
    out = dict(
        card=card, torch=torch.__version__, family=args.family,
        compute_dtype=args.compute_dtype, batches=args.batches,
        batch_size=B, decode_steps_per_batch=steps / args.batches,
        batch_ms=wall_ms / args.batches, phase_ms=phase_ms,
        device_busy_ms=busy_ms / args.batches,
        device_busy_share=busy_ms / wall_ms,
        kernels_per_step=n_kernels / max(steps, 1),
        attention_launches=fa.launches, flash_launches=fl.launches,
        top_kernels=[dict(name=k[:80], ms_per_batch=v / 1e3 / args.batches,
                          share_of_busy=v / 1e3 / busy_ms if busy_ms else 0.0)
                     for k, v in top])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
