#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--articles N]

Run from the root of a checkout, on a machine with one CUDA card.  It
imports only torch, numpy and the port (textsummarization_on_flink_tpu_torch),
never jax, and fails (exit code != 0, no result line) without a CUDA
device or without the port's sources beside it.  Phases, each fatal:

  1. print the card (nvidia-smi name, power limit);
  2. build every CUDA kernel of the port from the checkout's sources
     (one nvcc per source, all at once) and time the build;
  3. hold each kernel against its plain PyTorch version on the card at
     the main paths' shapes; print errors, CUDA-event times, the bound
     and, where one PyTorch call computes the same function, its time:
     a. the fused additive attention, both dtypes, coverage on and off,
        with a fully masked row;
     b. the flash self-attention at the transformer encoder's shape
        (16 x 400 x 8 heads x hd 32) and the long-context shape
        (4 x 2048 x 8 x 128), causal on and off, a fully masked article
        and ragged key masks;
  4. check the beam search on the card against the plain CPU path on a
     small input (same tokens), for each model family;
  5. drive each main path, the launch counts set to 0 just before it and
     read just after: full-width params from --seed saved as an npz
     checkpoint, a synthetic 50k vocab and --articles raw-text articles,
     ``cli.main(--mode=decode --inference=1 --single_pass=1)``, each in its
     own log_root; check that every article got a decoded file and the
     kernel launch counts
     a. pointer-generator: the fused attention twice per decode step;
     b. transformer (--model_family=transformer, 6 + 6 layers, 8 heads):
        the flash kernel once per encoder layer per batch;
     and print per-batch latency and tokens/s;
  6. print the kernels' JSON line, then, last, the device JSON line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# (non-tensor-core) operations/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

ATTN_TOL = 1e-5  # f32 math on both sides; only the order of sums differs


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


def time_cuda(fn, iters: int, flush) -> float:
    """Median milliseconds of fn() over iters launches, each timed with
    CUDA events and preceded by a write of a buffer larger than the L2
    cache (the decode step's other traffic evicts the encoder, so the
    kernel meets it cold)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(B, K, T, D, dtype, seed):
    """Inputs at model scale (v, w_c glorot-sized): ragged lengths, row 1
    fully masked (an empty article)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    es = torch.randn(B, T, D, generator=g, device=dev).to(dtype)
    ef = torch.randn(B, T, D, generator=g, device=dev).to(dtype)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev)
    lens[0] = T
    mask = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
    if B > 1:
        mask[1] = 0.0
    df = torch.randn(B, K, D, generator=g, device=dev)
    cov = torch.rand(B, K, T, generator=g, device=dev) * mask[:, None] * 3.0
    lim = (6.0 / (2 * D)) ** 0.5
    v = (torch.rand(D, generator=g, device=dev) * 2 - 1) * lim
    w_c = (torch.rand(D, generator=g, device=dev) * 2 - 1) * lim
    return es, ef, mask, df, cov, v, w_c


def attention_bound_ms(B, K, T, D, elt_bytes, use_cov):
    """Least time for the function on an H100: the larger of bytes moved
    (each input read once, each output written once) over the memory
    rate and f32 operations over the f32 peak.  Per (article, query,
    position, column): add the query, fused-multiply-add the coverage
    term when on (2), tanh (counted as 1), multiply-add with v (2), and
    the context's multiply-add (2)."""
    bytes_in = 2 * B * T * D * elt_bytes + 4 * (B * T + B * K * D + 2 * D)
    if use_cov:
        bytes_in += 4 * B * K * T
    bytes_out = 4 * (B * K * D + B * K * T)
    ops = B * K * T * D * (1 + (2 if use_cov else 0) + 1 + 2 + 2)
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_in + bytes_out, ops)


def phase_attention(seed):
    """Kernel vs plain at the beam-decode shape and the long-context shape."""
    import torch

    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # 96 MB > 50 MB L2
    rows = []
    worst = 0.0
    main = None
    cases = [(16, 4, 400, 512), (4, 1, 4096, 512)]
    for (B, K, T, D) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for use_cov in (True, False):
                args = attention_inputs(B, K, T, D, dtype, seed)
                ctx, attn = fa._attention_cuda(*args, use_cov)
                ctx_p, attn_p = fa._attention_plain(*args, use_cov)
                torch.cuda.synchronize()
                err = max(float((ctx - ctx_p).abs().max()),
                          float((attn - attn_p).abs().max()))
                finite = bool(torch.isfinite(ctx).all()) and \
                    bool(torch.isfinite(attn).all())
                masked_zero = B < 2 or (
                    float(attn[1].abs().max()) == 0.0
                    and float(ctx[1].abs().max()) == 0.0)
                ms = time_cuda(lambda: fa._attention_cuda(*args, use_cov),
                               20, flush)
                plain_ms = time_cuda(
                    lambda: fa._attention_plain(*args, use_cov), 10, flush)
                elt = 2 if dtype == torch.bfloat16 else 4
                bound, by, nbytes, ops = attention_bound_ms(B, K, T, D, elt,
                                                            use_cov)
                row = dict(shape=f"{B}x{K}x{T}x{D}",
                           dtype=str(dtype).replace("torch.", ""),
                           coverage=use_cov, max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                           bytes=nbytes, ops=ops)
                print("attention " + json.dumps(row))
                check(finite, f"non-finite kernel output at {row}")
                check(masked_zero, f"fully masked row not zero at {row}")
                check(err <= ATTN_TOL,
                      f"kernel disagrees with plain (err {err} > "
                      f"{ATTN_TOL}) at {row}")
                worst = max(worst, err)
                rows.append(row)
                if (B, K, T, D) == cases[0] and dtype == torch.float32 \
                        and use_cov:
                    main = row
    return main, worst


def flash_inputs(B, T, nh, hd, seed, masked):
    """q, k, v [B, T, nh, hd] at attention scale; with ``masked`` a ragged
    key mask [B, T] whose article 1 is fully masked (else None)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, T, nh, hd, generator=g, device="cuda")
               for _ in range(3))
    if not masked:
        return q, k, v, None
    lens = torch.randint(T // 2, T + 1, (B,), generator=g, device="cuda")
    lens[0] = T
    mask = (torch.arange(T, device="cuda")[None] < lens[:, None]).float()
    mask[1] = 0.0
    return q, k, v, mask


def flash_bound_ms(q, key_mask, causal):
    """Least time for the function on an H100: the larger of bytes moved
    (q, k, v and the mask read once, the output written once) over the
    memory rate and the operations this run's data needs over the f32
    peak: 4 * hd operations (two multiply-adds) per (query row, head, key
    it may attend), counted from the mask and the causal triangle."""
    import torch

    B, T, nh, hd = q.shape
    keys = (key_mask > 0).float() if key_mask is not None \
        else torch.ones((B, T), device=q.device)
    if causal:  # key j is attended by the rows j .. T-1
        pairs = float((keys * (T - torch.arange(T, device=q.device))).sum())
    else:
        pairs = float(keys.sum()) * T
    ops = 4 * hd * nh * pairs
    nbytes = 4 * 4 * B * T * nh * hd + (4 * B * T if key_mask is not None
                                        else 0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def phase_flash(seed):
    """Flash kernel vs plain (and vs scaled_dot_product_attention's time)
    at the encoder's shape and the long-context shape, causal on and
    off.  The encoder calls it with its padding mask and causal off; the
    causal form (the training decoder's) is held here only."""
    import torch
    import torch.nn.functional as F

    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # 96 MB > 50 MB L2
    worst = 0.0
    main = None
    cases = [(16, 400, 8, 32), (4, 2048, 8, 128)]
    for (B, T, nh, hd) in cases:
        for causal in (False, True):
            # the encoder masks padding keys; the causal decoder has none
            q, k, v, mask = flash_inputs(B, T, nh, hd, seed, not causal)
            scale = hd ** -0.5
            out = fl._flash_cuda(q, k, v, mask, causal, scale)
            ref = fl._flash_plain(q, k, v, mask, causal, scale)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            finite = bool(torch.isfinite(out).all())
            masked_zero = mask is None or float(out[1].abs().max()) == 0.0
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B,nh,T,hd]
            bool_mask = None if mask is None else (mask > 0)[:, None, None, :]
            ms = time_cuda(lambda: fl._flash_cuda(q, k, v, mask, causal,
                                                  scale), 20, flush)
            plain_ms = time_cuda(lambda: fl._flash_plain(q, k, v, mask,
                                                         causal, scale),
                                 10, flush)
            library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bool_mask, is_causal=causal,
                scale=scale), 20, flush)
            bound, by, nbytes, ops = flash_bound_ms(q, mask, causal)
            row = dict(shape=f"{B}x{T}x{nh}x{hd}", causal=causal,
                       key_mask=mask is not None, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops)
            print("flash " + json.dumps(row))
            check(finite, f"non-finite flash output at {row}")
            check(masked_zero, f"fully masked article not zero at {row}")
            check(err <= ATTN_TOL,
                  f"flash kernel disagrees with plain (err {err} > "
                  f"{ATTN_TOL}) at {row}")
            worst = max(worst, err)
            if (B, T, nh, hd) == cases[0] and not causal:
                main = row
    return main, worst


def kernel_module(family):
    """The ops module whose kernel the family's decode path launches."""
    if family == "transformer":
        from textsummarization_on_flink_tpu_torch.ops import flash_attention
        return flash_attention
    from textsummarization_on_flink_tpu_torch.ops import fused_attention
    return fused_attention


def small_hps(family):
    """A small model whose beams differ, copy OOVs and finish at mixed
    steps (the card-vs-CPU token check)."""
    from textsummarization_on_flink_tpu_torch.config import HParams

    common = dict(batch_size=4, vocab_size=200, max_enc_steps=40,
                  max_dec_steps=12, beam_size=4, min_dec_steps=3,
                  max_oov_buckets=8, mode="decode")
    if family == "transformer":
        # hd 32: the flash kernel's head width at the reference
        return HParams(model_family="transformer", hidden_dim=64,
                       num_heads=2, enc_layers=2, dec_layers=2, **common)
    return HParams(hidden_dim=32, emb_dim=16, coverage=True,
                   trunc_norm_init_std=0.5, rand_unif_init_mag=0.3, **common)


def phase_small_reference(seed, family):
    """The beam search through the kernels on the card gives the plain
    CPU path's tokens on a small input."""
    import torch

    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.params import (
        from_numpy_tree,
        init_numpy_params,
    )

    hps = small_hps(family)
    p = init_numpy_params(hps, hps.vocab_size, seed)
    if family == "transformer":
        p["embedding"] *= 30.0  # tied: also sharpens the vocab scores
        p["out_bias"][3] = 3.0  # STOP
    else:
        p["embedding"] *= 4.0
        p["output_projection"]["w"] *= 4.0
        p["output_projection"]["v"][:] = 0.0
        p["output_projection"]["v"][3] = 2.5  # STOP
    rng = np.random.default_rng(seed)
    B, T = hps.batch_size, hps.max_enc_steps
    lens = rng.integers(T // 2, T + 1, B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    ids = np.where(mask > 0, rng.integers(4, hps.vocab_size, (B, T)), 1)
    ext = np.where((rng.random((B, T)) < 0.2) & (mask > 0),
                   hps.vocab_size + rng.integers(0, 4, (B, T)), ids)
    arrays = dict(enc_batch=ids.astype(np.int32), enc_lens=lens.astype(np.int32),
                  enc_padding_mask=mask,
                  enc_batch_extend_vocab=ext.astype(np.int32))
    cpu = beam_search.run_beam_search(from_numpy_tree(p, "cpu"), hps, arrays)
    counter = kernel_module(family)
    before = counter.launches
    gpu = beam_search.run_beam_search(
        from_numpy_tree(p, torch.device("cuda")), hps, arrays)
    launched = counter.launches - before
    print("small_reference " + json.dumps(dict(
        family=family, kernel_launches=launched,
        tokens_equal=bool(np.array_equal(cpu.tokens, gpu.tokens)),
        lengths=gpu.length.tolist(),
        max_avg_log_prob_diff=float(np.abs(cpu.avg_log_prob
                                           - gpu.avg_log_prob).max()))))
    check(launched > 0, f"the {family} search on the card launched no kernel")
    check(np.array_equal(cpu.tokens, gpu.tokens),
          f"{family} beam search on the card differs from the CPU reference")
    check(np.array_equal(cpu.length, gpu.length), "lengths differ")
    check(np.allclose(cpu.avg_log_prob, gpu.avg_log_prob, atol=1e-4),
          "average log-probs differ beyond 1e-4")


class _BatchLog(logging.Handler):
    """Collects the decoder's per-batch (articles, seconds) records."""

    def __init__(self):
        super().__init__()
        self.batches = []

    def emit(self, record):
        if record.msg.startswith("decoded batch of"):
            self.batches.append(record.args)


def main_path_hps(family):
    """The reference width of each family (bench.py's reference preset;
    BENCH_FAMILY=transformer for the second): V=50k, 400 encoder and 100
    decoder steps (min 35), beam 4, batch 16, pointer_gen on, f32."""
    from textsummarization_on_flink_tpu_torch.config import HParams

    common = dict(hidden_dim=256, vocab_size=50000, max_enc_steps=400,
                  max_dec_steps=100, min_dec_steps=35, beam_size=4,
                  batch_size=16, pointer_gen=True)
    if family == "transformer":
        return HParams(model_family="transformer", num_heads=8, enc_layers=6,
                       dec_layers=6, ffn_dim=1024, **common)
    return HParams(emb_dim=128, coverage=True, **common)


def phase_main_path(seed, n_articles, work, device="cuda",
                    family="pointer_generator"):
    """cli.main at full width; returns the launch and timing summary.
    (device="cpu" rehearses the control flow without a card.)"""
    from textsummarization_on_flink_tpu_torch import cli
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode.decoder import (
        get_decode_dir_name,
    )
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params

    hps = main_path_hps(family)
    rng = np.random.default_rng(seed)
    # vocab: 49,996 words + 4 specials = the reference's 50k
    words = [f"w{i:05d}" for i in range(hps.vocab_size - 4)]
    vocab_path = os.path.join(work, "vocab")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.writelines(f"{w} {len(words) - i}\n" for i, w in enumerate(words))
    art_dir = os.path.join(work, "articles")
    os.makedirs(art_dir)
    for a in range(n_articles):
        n = int(rng.integers(300, 800))  # some longer than max_enc_steps
        ranks = np.minimum(rng.zipf(1.2, n), len(words)) - 1
        toks = [words[r] if rng.random() > 0.05 else f"oov{rng.integers(50)}"
                for r in ranks]
        with open(os.path.join(art_dir, f"article_{a:03d}.txt"), "w",
                  encoding="utf-8") as f:
            f.write(" ".join(toks) + " .")
    train_dir = os.path.join(work, "exp", "train")
    t0 = time.perf_counter()
    params = init_numpy_params(hps, hps.vocab_size, seed)
    path = os.path.join(train_dir, "model.ckpt-0.npz")
    ckpt_lib.save_arrays(path, ckpt_lib._flatten({"params": params}))
    ckpt_lib.write_index(train_dir, path)
    setup_s = time.perf_counter() - t0

    handler = _BatchLog()
    dec_log = logging.getLogger(
        "textsummarization_on_flink_tpu_torch.decode.decoder")
    dec_log.setLevel(logging.INFO)
    dec_log.addHandler(handler)
    flags = dict(mode="decode", inference=1, single_pass=1,
                 data_path=f"{art_dir}/*.txt", vocab_path=vocab_path,
                 log_root=work, exp_name="exp", device=device,
                 model_family=family, pointer_gen=1,
                 coverage=int(hps.coverage),
                 **{k: getattr(hps, k) for k in (
                     "hidden_dim", "emb_dim", "vocab_size", "max_enc_steps",
                     "max_dec_steps", "min_dec_steps", "beam_size",
                     "batch_size")})
    if family == "transformer":
        flags.update(num_heads=hps.num_heads, enc_layers=hps.enc_layers,
                     dec_layers=hps.dec_layers, ffn_dim=hps.ffn_dim)
    argv = [f"--{k}={v}" for k, v in flags.items()]
    try:
        fa.launches = 0
        fl.launches = 0
        beam_search.steps_run = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        fused, flash = fa.launches, fl.launches
        steps = beam_search.steps_run
    finally:
        dec_log.removeHandler(handler)
    check(rc == 0, f"cli.main returned {rc}")

    dec_dir = os.path.join(work, "exp", get_decode_dir_name(hps, path),
                           "decoded")
    files = sorted(os.listdir(dec_dir))
    check(len(files) == n_articles,
          f"{len(files)} decoded files for {n_articles} articles")
    n_tokens = 0
    vocab_set = set(words)
    for name in files:
        with open(os.path.join(dec_dir, name), encoding="utf-8") as f:
            toks = f.read().split()
        check(bool(toks), f"{name} is empty")
        check(all(t in vocab_set or t.startswith("oov") or t == "."
                  or t in ("[UNK]", "[PAD]", "[START]") for t in toks),
              f"{name} holds words outside the vocab and its article")
        n_tokens += len(toks)
    batch_s = [float(s) for _, s in handler.batches]
    n_batches = len(batch_s)
    if family == "transformer":
        launches = flash
        check(flash > 0, "the flash attention kernel never launched")
        check(flash == hps.enc_layers * n_batches,
              f"{flash} flash launches for {n_batches} batches (expected "
              f"{hps.enc_layers} per batch, one per encoder layer)")
        check(fused == 0, f"{fused} fused-attention launches in the "
                          f"transformer path")
    else:
        launches = fused
        check(fused > 0, "the fused attention kernel never launched")
        check(fused == 2 * steps,
              f"{fused} kernel launches for {steps} decode steps "
              f"(expected 2 per step)")
        check(flash == 0, f"{flash} flash launches in the "
                          f"pointer-generator path")
    summary = dict(family=family, articles=n_articles, batches=n_batches,
                   batch_seconds=batch_s, decode_steps=steps,
                   kernel_launches=launches,
                   launches_per_batch=launches / max(n_batches, 1),
                   decoded_tokens=n_tokens,
                   tokens_per_s=n_tokens / sum(batch_s),
                   cli_wall_s=wall, setup_s=setup_s)
    print("main_path " + json.dumps(summary))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--articles", type=int, default=32)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from textsummarization_on_flink_tpu_torch.device import resolve_device
    from textsummarization_on_flink_tpu_torch.kernels import build

    resolve_device("cuda")  # also turns TF32 off
    print(card_line())
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          python=sys.version.split()[0])))

    t0 = time.perf_counter()
    libs = build.build_all()
    print(json.dumps(dict(build_seconds=time.perf_counter() - t0,
                          kernels=sorted(libs))))
    for name in libs:
        sys.stdout.write(build.build_log(name))

    main_row, worst = phase_attention(args.seed)
    flash_row, flash_worst = phase_flash(args.seed)
    for family in ("pointer_generator", "transformer"):
        phase_small_reference(args.seed, family)

    summaries = {}
    for family in ("pointer_generator", "transformer"):
        work = os.path.join(HERE, ".smoke_work", family)  # own log_root
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            summaries[family] = phase_main_path(args.seed, args.articles,
                                                work, family=family)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(os.path.join(HERE, ".smoke_work"), ignore_errors=True)

    kernels = [dict(
        name="fused_attention", route="cuda",
        source="textsummarization_on_flink_tpu_torch/kernels/fused_attention.cu",
        replaces="textsummarization_on_flink_tpu/ops/pallas_attention.py:58",
        launches=summaries["pointer_generator"]["kernel_launches"],
        max_abs_err=worst, ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None), dict(
        name="flash_attention", route="cuda",
        source="textsummarization_on_flink_tpu_torch/kernels/flash_attention.cu",
        # the library Pallas kernel, at its call site in the repo
        replaces="textsummarization_on_flink_tpu/models/transformer.py:285",
        launches=summaries["transformer"]["kernel_launches"],
        max_abs_err=flash_worst, ms=flash_row["ms"],
        plain_ms=flash_row["plain_ms"], bound_ms=flash_row["bound_ms"],
        bound_by=flash_row["bound_by"], library_ms=flash_row["library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
