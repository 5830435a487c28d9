#!/usr/bin/env python3
"""Per-step trace and device profile of the PyTorch port's training at
the reference width.

    python3 scripts/torch_train_trace.py [--family F] [--seed N]
        [--steps N] [--lr X [X ...]] [--profile_steps N]
        [--compute_dtype float32|bfloat16]

Needs one CUDA card.  For each --lr it trains --family (transformer, the
default: hidden 256, 8 heads of 32, 6 + 6 layers, FFN 1024, tied
V=50,000; pointer_generator: hidden 256, embedding 128, V=50,000; both
with 400 encoder and 100 decoder steps, batch 16, pointer_gen and
coverage on, in --compute_dtype, f32 by default) from fresh params of --seed on the synthetic chunk
files chip_smoke.py writes, for --steps train steps, and prints one JSON
line per lr:

  * per step: loss, coverage_loss, the pre-clip global gradient norm,
    the mean p_gen over the real target positions, the three params with
    the largest gradient norms, and the step's host wall time (ending in
    the loss read, a device sync);

then, with --profile_steps > 0, profiles that many further steps at the
first lr under torch.profiler and prints one JSON line:

  * step_ms: host wall time per step; device_busy_ms / device_busy_share:
    summed CUDA kernel time over the profiled wall time; kernels_per_step;
  * kernel launches per step (the fused attention's forward and
    backward, the flash forward, dK/dV and dQ);
  * top_kernels: the device time by kernel name, largest first.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="transformer",
                    choices=["transformer", "pointer_generator"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, nargs="+", default=[0.15, 0.015])
    ap.add_argument("--profile_steps", type=int, default=3)
    ap.add_argument("--compute_dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from textsummarization_on_flink_tpu_torch.data.batcher import Batcher
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode.beam_search import (
        _to_device,
    )
    from textsummarization_on_flink_tpu_torch.device import resolve_device
    from textsummarization_on_flink_tpu_torch.params import tree_leaves
    from textsummarization_on_flink_tpu_torch.train import optim, trainer

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    base = chip_smoke.main_path_hps(args.family).replace(
        mode="train", coverage=True, seed=args.seed,
        compute_dtype=args.compute_dtype)
    work = tempfile.mkdtemp(prefix="train_trace_", dir=ROOT)
    try:
        vocab_path, data_path = chip_smoke.write_train_chunks(
            work, base, args.seed, 64)
        vocab = Vocab(vocab_path, base.vocab_size)
        names = _leaf_names(base)
        for lr in args.lr:
            hps = base.replace(lr=lr)
            batcher = Batcher(data_path, vocab, hps, single_pass=False)
            state = trainer.init_train_state(hps, hps.vocab_size, device=dev)
            loss_fn = trainer.make_loss_fn(hps)
            steps = []
            for _ in range(args.steps):
                arrays = _to_device(batcher.next_batch().as_arrays(), dev)
                t0 = time.perf_counter()
                objective, out = loss_fn(state.params, arrays)
                grads = torch.autograd.grad(objective, tree_leaves(
                    state.params), materialize_grads=True)
                norms = [float(g.norm()) for g in grads]
                mask = arrays["dec_padding_mask"]
                p_gen = float((out.p_gens.detach() * mask).sum() / mask.sum())
                grads, gnorm = optim.clip_by_global_norm(
                    list(grads), hps.max_grad_norm)
                optim.adagrad_update(grads, state.opt_state, state.params,
                                     hps.lr)
                loss = float(out.loss.detach())
                dt = time.perf_counter() - t0
                top = sorted(range(len(norms)), key=lambda i: -norms[i])[:3]
                steps.append(dict(
                    loss=loss, coverage_loss=float(out.coverage_loss.detach()),
                    global_norm=float(gnorm), p_gen=p_gen, seconds=dt,
                    top_grads=[[names[i], norms[i]] for i in top]))
                state = state._replace(step=state.step + 1)
            print(json.dumps(dict(card=card, torch=torch.__version__,
                                  family=args.family,
                                  compute_dtype=args.compute_dtype, lr=lr,
                                  steps=steps)))
        if args.profile_steps > 0:
            hps = base.replace(lr=args.lr[0])
            batcher = Batcher(data_path, vocab, hps, single_pass=False)
            state = trainer.init_train_state(hps, hps.vocab_size, device=dev)
            batches = [_to_device(batcher.next_batch().as_arrays(), dev)
                       for _ in range(args.profile_steps + 1)]
            state, _ = trainer.train_step(hps, state, batches[0])  # warm-up
            torch.cuda.synchronize()
            chip_smoke.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for arrays in batches[1:]:
                    state, m = trainer.train_step(hps, state, arrays)
                    float(m.loss)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            n = args.profile_steps
            kernel_us, n_kernels = {}, 0
            for evt in prof.events():
                if "CUDA" in str(getattr(evt, "device_type", "")):
                    n_kernels += 1
                    kernel_us[evt.name] = kernel_us.get(evt.name, 0.0) + \
                        evt.time_range.elapsed_us()
            busy_ms = sum(kernel_us.values()) / 1e3
            top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:15]
            print(json.dumps(dict(
                card=card, torch=torch.__version__, family=args.family,
                compute_dtype=args.compute_dtype, lr=hps.lr,
                profiled_steps=n, step_ms=wall_ms / n,
                device_busy_ms=busy_ms / n,
                device_busy_share=busy_ms / wall_ms,
                kernels_per_step=n_kernels / n,
                launches_per_step={
                    k: c / n for k, c in chip_smoke.launch_counts().items()},
                top_kernels=[dict(name=k[:80], ms_per_step=v / 1e3 / n,
                                  share_of_busy=v / 1e3 / busy_ms
                                  if busy_ms else 0.0)
                             for k, v in top])))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def _leaf_names(hps):
    """Slash-joined names of the params in tree_leaves order."""
    from textsummarization_on_flink_tpu_torch.params import (
        init_numpy_params,
        tree_leaves,
    )

    tiny = hps.replace(vocab_size=8, hidden_dim=8, emb_dim=8, num_heads=1,
                       ffn_dim=8, max_enc_steps=2, max_dec_steps=2)
    tree = init_numpy_params(tiny, 8, 0)

    def named(node, path):
        if isinstance(node, dict):
            return {k: named(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [named(v, f"{path}/{i}") for i, v in enumerate(node)]
        return path[1:]

    return tree_leaves(named(tree, ""))


if __name__ == "__main__":
    sys.exit(main())
