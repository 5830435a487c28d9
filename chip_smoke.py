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
     (the flash kernels' operations at the f32-accurate tensor-core rate,
     PEAK_TF32X3_OPS_PER_S, their bf16 forms' at PEAK_BF16_OPS_PER_S)
     and, where one PyTorch call computes the same
     function, its time; then the largest errors of the redesigned
     kernels beside those of the kernels they replaced (the flash
     kernels' f32 SIMT designs, the fused attention's two-launch design):
     a. the fused additive attention, both dtypes, coverage on and off,
        with a fully masked row, at the beam-decode shape (and there
        with the slot engine's length bound, t_active 64, 128, 256 and
        400, f32 and bf16: attn exactly 0 past it; timed beside the
        bound at t_active, phase_attention_bounded), the long form,
        the training shape (K = 1; in bf16 the byte-diet run's), the
        App's decode shape (4 articles x 4 beams, f32) and the wide
        pointer-generators (D 800 at 16 x 4, D 860 at 16 x 1, f32); then
        long encoders
        whose per-position state lives in device memory (16 x 16 x 2000
        and 4 x 4 x 17,856 and 20,000 positions), with a bitwise repeat;
     b. the fused attention's backward kernel (one launch) at the
        training shape (16 x 400 x 512, coverage on and off) and a long
        encoder (4 x 4096), on f32 and on bf16 encoder streams, and at
        D 860 (f32), against the plain backward, with a bitwise repeat
        and zero gradients for the empty article;
     c. the flash self-attention at the transformer encoder's shape
        (16 x 400 x 8 heads x hd 32), the long-context shape
        (4 x 2048 x 8 x 128) and head dim 256 (16 x 400 x 2 x 256),
        causal on and off, a fully masked article and ragged key masks;
     d. the flash backward (the dK/dV and dQ kernels) against its plain
        version at the training encoder's shape (16 x 400 x 8 x 32, key
        mask, article 1 empty), the training decoder's (16 x 100 x 8 x
        32, causal), the long-context shape (4 x 2048 x 8 x 128, both
        forms) and head dim 256 (16 x 400 and 16 x 100 x 2 x 256), and
        the forward's lse output at the training shapes;
     e. the flash kernels' bf16 forms (forward, dK/dV, dQ; the
        transformer under --compute_dtype=bfloat16) against their plain
        bf16 versions within FLASH_BF16_ULPS bf16 ulps at 16 x 400 x 8 x
        32 (key mask), 16 x 100 x 8 x 32 (causal), 4 x 2048 x 8 x 128
        (both) and 16 x 400 x 2 x 256, timed beside
        scaled_dot_product_attention in bf16 (phase_flash_bf16); the
        three bf16 kernels' SASS (bf16_flash_sass): wgmma (HGMMA) and
        TMA copies (UTMALDG) in every instantiation, no bf16 mma.sync
        (HMMA.16816), no spill, no wgmma serialized by ptxas;
     f. the wide flash kernels (head dims above 256, f32 and bf16:
        forward, dK/dV, dQ; the cluster forms on the tensor cores up to
        head dim 2048, their multi-slab cluster forms above it) against
        their plain versions
        at 16 x 400 x 1 x 384, 512, 1024, 1152, 1536, 2048, 2304 and
        4096 (key mask) and 16 x 100 x 1 x 512, 1152, 1536, 2048 and
        2304 (causal), a rerun
        the same bits, each launch's form counted, timed beside the SIMT
        forward, dK/dV and dQ they replaced (the cluster forms at least
        WIDE_MIN_GAIN times faster at head dim 512, WIDE16_MIN_GAIN at
        1152, the multi-slab forward, dK/dV and dQ WIDE16_MIN_GAIN at 2304
        and 4096) and scaled_dot_product_attention with the backend it took
        (phase_flash_wide); their SASS and ptxas report
        (wide_flash_sass): 0 bytes of spill in every one of
        WIDE_FLASH_INSTANCES,
        3xTF32 HMMA in the f32 cluster forms, HGMMA and UTMALDG and no
        serialized wgmma in the bf16 ones; every flash kernel on a block
        of query rows against all the keys (Tq = Tk / 2, the sp=2
        encoder's form; QUERY_BLOCK_CASES, both dtypes) against its plain
        version, timed beside scaled_dot_product_attention on the block
        (phase_flash_query_block); every launch form of the parent (Tq =
        Tk; the redesigned wide forward, dK/dV and dQ aside, the wide
        kernels' digests taken from their SIMT forms) giving the parent's
        output digests (FLASH_PARENT_DIGESTS, phase_flash_digests);
     g. the fused kernels' slab forms (D in slabs: 16 x 4 x 400 x 2400
        and 4 x 1 x 400 x 4096 f32, 16 x 4 x 400 x 4096 bf16; the
        backward at 16 x 1 x 400 x 2400, 4 x 1 x 400 x 4096 and bf16
        16 x 1 x 400 x 4096) and sp-block forms (the reference block at
        sp = 2, 16 x 4 x 200 x 512 and 16 x 1 x 200 x 512, with the row
        max and sum; the backward with an outside correction) against
        their plain versions, reruns bit-equal, timed beside their bounds
        (phase_attention_forms); the parent's launch forms' output
        digests equal to the parent's (PARENT_DIGESTS); every dense and
        slab instantiation's ptxas report, 0 bytes of spill (fused_sass);
  4. for each model family, check the beam search on the card against the
     plain CPU path on a small input (same tokens), and three train steps
     of a small model on the card against the CPU (same losses within
     1e-4 relative, the exact kernel launches), the transformer also
     under --remat (its flash forward twice per layer);
  5. drive each main path, the launch counts set to 0 just before it and
     read just after: full-width params from --seed saved as an npz
     checkpoint, a synthetic 50k vocab and --articles raw-text articles,
     ``cli.main(--mode=decode --inference=1 --single_pass=1)``, each in its
     own log_root; check that every article got a decoded file and the
     kernel launch counts (no backward kernel)
     a. pointer-generator: the fused attention twice per decode step;
     b. transformer (--model_family=transformer, 6 + 6 layers, 8 heads):
        the flash kernel once per encoder layer per batch;
     and print per-batch latency and tokens/s; then each family's
     training: 64 synthetic article/abstract pairs written as chunk
     files, ``cli.main(--mode=train --num_steps=10)`` at the same width
     (the pointer-generator at lr 0.15, the transformer at 0.015: see
     train_main_path_hps); check the launches (pointer-generator: 100
     fused forward and 100 fused backward per step; transformer: 12
     flash forward, 12 dK/dV and 12 dQ per step, 6 encoder + 6 decoder
     layers), finite losses, the objective lower after the run than
     before on one fixed batch (fixed_batch_losses), a restorable
     ``model.ckpt-10.npz`` and the vocabulary metadata; print the warm
     step time, target tokens/s and the peak device memory; then the
     transformer under --compute_dtype=bfloat16 (phase_transformer_bf16):
     a decode of 16 articles (6 bf16 flash launches per batch, no f32
     one), 10 train steps with --loss_chunk=10 (12 + 12 + 12 bf16
     launches per step; peak memory and warm step beside the f32 run's),
     2 steps under --remat (24 bf16 forward launches per step) and a
     small-width card-vs-CPU check of a bf16 train step and of a bf16
     decode's first-step distributions;
  6. drive the pipeline layer, the reference's own main path, through
     ``App``: ``start_training`` fits the pointer-generator at the
     training width from a CollectionSource of 64 synthetic rows (4
     steps), ``start_inference`` transforms 16 more rows with the App's
     decode defaults (batch 4, beam 4) into a CollectionSink; check the
     rows, the checkpoint, the config-only model JSON, the launches (100
     fused forward and 100 backward per train step, 2 fused per beam
     step) and the first 4 summaries against a transform on the CPU from
     the same checkpoint; print fit and transform seconds, the median
     train step, seconds per decoded batch and the launches;
  7. the pointer-generator's byte-diet and long-run options through
     ``cli.main`` at the training width (phase_byte_diet): 10 steps with
     BYTE_DIET_FLAGS (the streaming loss, bf16 compute and Adagrad state,
     2 steps per dispatch, metrics every 2; every fused launch on a bf16
     stream, the peak memory beside the materialised run's), 3 steps of
     the f32 streaming loss against the materialised run's losses, the
     recovery run (RECOVERY_FLAGS: 2 skips, 1 rollback, lr_scale 0.5;
     its flight dumps' headers equal to a small CPU run's, the trainer's
     four phases and train/round walls, train/step_dispatch priced by
     obs/cost.py, the sentinel's achieved rates printed beside the card)
     and a bf16 beam decode of 16 articles (2 bf16 fused launches per
     step);
  8. the decoder's scoring and continuous mode (phase_rouge_decode,
     phase_continuous_decode): a single-pass decode of 16 chunk-file
     articles through ``cli.main`` scored with ROUGE, equal to the
     scores of a --device=cpu decode; a continuous decode of 3 batches
     through ``cli.run_decode`` that reloads a checkpoint written
     mid-run and writes the attention-visualizer file;
  9. the widths the card refused before (phase_wide_widths): the
     pointer-generator at hidden_dim 400 (decode) and 430 (a train
     step), the transformer at head dim 256 (a small beam search and a
     train step against the CPU, a decode through cli.main); head dims
     above 256 on the wide kernels (phase_wide_heads): head dim 512 at
     full width (a decode of 16 articles, 3 train steps on the card and
     one with --device=cpu, in f32 and in bf16, 12 + 12 + 12 wide
     launches per step, 6 per decode batch), head dim 320 (a small beam
     search and a train step against the CPU), head dim 1152 at 2 + 2
     layers (the forward's, dK/dV's and dQ's 9-block clusters: a
     decode, 3 train steps in each dtype, the first loss against the
     CPU's) and head dim 2304 at full width (the forward's, dK/dV's and
     dQ's 9 blocks of 2 slabs each, one launch per slab: a decode
     at 6 + 6 layers, about 1.0 B parameters, and 3 train steps in each
     dtype at 2 + 2 layers and 100 encoder steps, the first loss against
     the CPU's); the
     --device=cpu reference steps
     (wide_cpu_steps) run in a child process (CpuSteps) beside the
     kernel builds and phase 3, and are done before phase 4 starts
     (no phase that prints a host time runs beside them); and past the
     fused
     kernels' dense forms, the pointer-generator at hidden_dim 1200 (a
     decode of 8 articles on the slab forward, a train step on the
     slab backward, its loss within 1e-4 of --device=cpu's);
 10. online serving (phase_serve): the micro-batch ServingServer at the
     reference width over the ROUGE phase's trained checkpoint: a pinned
     group of 16 equal to a CPU ServingServer's summaries token for
     token, 32 concurrent requests from 8 threads (each resolved once,
     mean fill above 1), a request whose deadline is below the warm
     full-beam estimate re-tiered to greedy (equal to
     decode_batch(tier="greedy")), and App.start_inference(serving=True)
     over 16 rows; 2 fused launches per beam step throughout; prints
     e2e latency p50/p99, time in queue p50, the mean fill and
     requests/s;
 11. continuous serving (phase_continuous_serve): the ServingServer with
     serve_mode=continuous (the slot engine: 16 slots, serve buckets
     100/200/400, decode_enc_block 64) at the reference width over the
     ROUGE phase's checkpoint, 32 requests from 8 threads, 16 articles of
     50-120 words and 16 of 300-400: each resolved once, summaries equal
     to a micro-batch server's, exactly 2 fused launches per decode step
     in every chunk; again over a page arena of 56 pages (backpressure,
     the same summaries); the transformer over its train phase's
     checkpoint, 8 requests equal to its micro-batch server's, then with
     the bf16 decode KV cache (--decode_cache_dtype=bfloat16, priced by
     the sentinel): resident bytes per slot 2 * K * L * (T + 1) * H * 2
     below the f32 cache's, the average log-probs of the summaries it
     left equal within 2e-2 of the f32 cache's, serve/dispatch and
     serve/prefill priced, the achieved rates printed; prints
     e2e p50/p99, queue p50, requests/s, mean occupancy and resident
     bytes per slot beside the micro-batch numbers;
 12. the speculative tier (phase_spec): through decode_batch(tier=...)
     on 16 articles, the transformer over its train phase's checkpoint
     (greedy; spec with the mapped AAN draft, spec_k 4; spec with
     spec_k_adaptive; the draft tier) and the pointer-generator over the
     ROUGE phase's with a fresh AAN draft (greedy, spec); every spec
     row's summary equal to greedy's; 6 flash forward launches per
     greedy and draft batch and 12 per spec batch (both encoders), the
     pointer-generator's fused attention twice per verify step; a
     micro-batch ServingServer with 8 spec and 8 greedy requests, equal
     summaries; prints seconds, cycles, accept rate, tokens per cycle
     and tokens/s per tier;
 13. distillation (phase_distill): DistillTrainer takes 5 steps of the
     narrow draft (hidden 128, a rank-64 factored head, 1 layer) against
     the frozen transformer on the 64 synthetic pairs, exactly 6 + 6 + 6
     flash launches per draft step and 6 forward per teacher decode; the
     losses and the acceptance before and after; a small width's step
     on the card against the CPU (loss within 1e-4 relative); the
     distilled draft loaded with its teacher check into the spec tier,
     equal to greedy;
 14. the fleet layer at the continuous phase's decode width over the
     ROUGE phase's checkpoint: phase_fleet (3 continuous replicas behind a
     FleetRouter, 48 requests from 8 threads, r1 killed mid-decode: its
     residents requeue, every future resolves once, summaries equal a
     single server's; a rolling swap to a second checkpoint with 16 in
     flight, at most one replica out at any tick; hedging capped at a
     quarter of admissions; 2 transformer replicas equal to a single
     server), phase_hiersum (a 2,000-word document as framed rows through
     transform(hierarchical=True), then a 400-word append that decodes
     only its 2 tail chunks and one reduce; the summary equal to its
     chunks decoded one at a time and reduced, and to a fleet's) and
     phase_procfleet (two serve-replica children on the card, listed by
     nvidia-smi, one SIGKILLed mid-decode: requeue, restart, readmission,
     summaries equal to the single server's, no child left behind);
     fused attention twice per decode step and the flash forward six
     times per transformer prefill, summed over the replicas (the process
     fleet's children write their counts beside their logs);
 15. the mesh (phase_mesh; parallel/ on ranks that share this card over
     gloo, started as chip_smoke_mesh.py processes): one train step of a
     fixed batch of 16 at dp=2 (f32, then the bf16 gradient wire), at
     dp=2 x tp=2, and of the transformer at sp=2 (ring, Ulysses) and
     tp=2, each against the single-rank step on the card at the JAX
     package's tolerances, the dp all-reduce moving exactly
     analytic_comms' bytes (86.0 MB f32, 43.0 bf16); a dp=2 decode of 16
     articles equal to the single-rank decode_batch and a tp=2 search;
     the AAN, among its cases at one head on tp=2 (rank 1 holding a
     zero pad head: a step and a search against the single rank); the
     pointer-generator with T sharded over sp (a train step at sp=2 and
     at dp=2 x sp=2, a search of 16 articles at sp=2 with tokens exact,
     every fused launch the sp-block form), the transformer's search at
     sp=2 under --sp_attention=ring (tokens exact) and, at the JAX
     package's long-context width (hidden_dim 512, 800 encoder steps),
     each sp=2 rank's peak memory and the es and ef its fused attention
     saved (half the single rank's); the transformer and the AAN with T
     sharded over sp=2 without --sp_attention (the flash kernels'
     query-block form): a train step equal to the single rank's, a
     search with tokens exact, and at the long-context width each
     rank's peak memory and the bytes its encoder saved (at most half
     the single rank's plus the keys, values and mask gathered over
     sp);
     then ``torchrun`` on the entry point (3 train steps at dp=2, a
     resume to 5) and a world-1 NCCL all-reduce; every rank's kernel
     launches checked, and summed into the kernels line;
 16. print the kernels' JSON line, then, last, the device JSON line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import json
import logging
import os
import re
import shlex
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
# The flash kernels' products run on the tensor cores at f32 accuracy
# (3xTF32, kernels/mma_tf32x3.cuh): three TF32 products per f32 product,
# so the least time for their operations is at 495 TFLOP/s (dense TF32)
# over 3.  The f32 rate above would let a 3xTF32 kernel beat its bound.
PEAK_TF32X3_OPS_PER_S = 495e12 / 3
# The flash kernels' bf16 forms multiply bf16 operands on the tensor cores
# (kernels/wgmma_bf16.cuh): dense bf16, 989 TFLOP/s
PEAK_BF16_OPS_PER_S = 989e12

# each flash kernel's largest error against its plain version over phase
# 3's shapes with the f32 SIMT kernels, before the 3xTF32 redesign
# (PERF.md), printed beside this run's
SIMT_MAX_ABS_ERR = dict(forward=1.6e-6, dq=3.2e-6, dk=2.9e-6, dv=2.4e-6)
# the fused attention's largest error over phase 3a's shapes with the
# two-launch kernel the cluster design replaced (PR 1's kernel, unchanged
# through PR 4: this script's phase 3a in PR 1; PERF.md), printed beside
# this run's
PR4_FUSED_MAX_ABS_ERR = 1.79e-7

ATTN_TOL = 1e-5  # f32 math on both sides; only the order of sums differs
# the flash kernels' bf16 forms against their plain bf16 versions: within
# this many bf16 ulps of the tensor's largest |value| (both round P and
# dS to bf16 at the same points, the forward against the online
# softmax's running max where the plain version takes the row max, and
# the f32 sums before each final rounding run in other orders)
FLASH_BF16_ULPS = 2


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


#: clock cycles the card spins between the L2 flush and the start event
#: (~0.25 ms): long enough for the host to enqueue the timed launch
SPIN_CYCLES = 500_000


def time_cuda(fn, iters: int, flush) -> float:
    """Median milliseconds of fn() over iters launches, each timed with
    CUDA events and preceded by a write of a buffer larger than the L2
    cache (the decode step's other traffic evicts the encoder, so the
    kernel meets it cold).  Between the flush and the start event the
    card spins (torch.cuda._sleep) while the host enqueues the launch, so
    the time is the card's alone: without the spin the card, done with the
    flush, waited for the host's wrapper, and a kernel of a few tens of
    microseconds was timed with its launch overhead (PERF.md: the
    harness)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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


def attention_bound_ms(B, K, T, D, elt_bytes, use_cov, t_active=None):
    """Least time for the function on an H100: the larger of bytes moved
    (each input read once, each output written once) over the memory
    rate and f32 operations over the f32 peak.  Per (article, query,
    position, column): add the query, fused-multiply-add the coverage
    term when on (2), tanh (counted as 1), multiply-add with v (2), and
    the context's multiply-add (2).  With a length bound t_active the
    inputs' prefix of t_active positions is read and worked on; attn is
    written whole (its zeros past the bound too)."""
    t = T if t_active is None else t_active
    bytes_in = 2 * B * t * D * elt_bytes + 4 * (B * t + B * K * D + 2 * D)
    if use_cov:
        bytes_in += 4 * B * K * t
    bytes_out = 4 * (B * K * D + B * K * T)
    ops = B * K * t * D * (1 + (2 if use_cov else 0) + 1 + 2 + 2)
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_in + bytes_out, ops)


def phase_attention(seed):
    """Kernel vs plain at the beam-decode shape, the long-context shape,
    the pointer-generator's training shape (K = 1), each on f32 and bf16
    encoder streams, and the App's decode shape (4 articles x 4 beams,
    f32)."""
    import torch

    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # 96 MB > 50 MB L2
    rows = []
    worst = 0.0
    main = main_bf16 = None
    # the beam-decode shape, the long form, the training shape (K = 1),
    # the App's decode shape (batch 4, beam 4: a 16-block cluster), and
    # the wide pointer-generators: decode at hidden_dim 400 (D 800) and
    # training at 430 (D 860, past the 8-chunk ring the kernel refused)
    cases = [(16, 4, 400, 512), (4, 1, 4096, 512), (16, 1, 400, 512),
             (4, 4, 400, 512), (16, 4, 400, 800), (16, 1, 400, 860)]
    rows_k1, rows_app, rows_wide = {}, {}, {}
    for (B, K, T, D) in cases:
        # the App and the wide widths decode and train in f32 only; the
        # training shape also runs on a bf16 stream
        # (--compute_dtype=bfloat16 training)
        dtypes = (torch.float32,) if (B, K) == (4, 4) or D > 512 else (
            torch.float32, torch.bfloat16)
        for dtype in dtypes:
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
                if (B, K, T, D) == cases[0] and use_cov:
                    if dtype == torch.float32:
                        main = row
                    else:
                        main_bf16 = row
                if (B, K, T, D) == cases[2]:
                    rows_k1[(row["dtype"], use_cov)] = row
                if (B, K, T, D) == cases[3]:
                    rows_app[use_cov] = row
                if D > 512 and use_cov:
                    rows_wide[D] = row
    return main, main_bf16, rows_k1, rows_app, rows_wide, worst


#: the length bounds phase_attention_bounded holds the kernel at: the
#: slot engine's bound (ceil(longest active / 64) * 64, clamped to T) for
#: one to four blocks, and T itself
BOUNDED_T_ACTIVE = (64, 128, 256, 400)


def phase_attention_bounded(seed):
    """The fused attention with a length bound (the slot engine's step) at
    the beam-decode shape, 16 x 4 x 400 x 512, coverage on, f32 and bf16
    streams, t_active in BOUNDED_T_ACTIVE: kernel against the plain
    version with the same bound (ATTN_TOL), attn exactly 0 past the
    bound; the kernel's and the plain version's times beside the bound
    at t_active (each input's prefix read once)."""
    import torch

    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    flush = torch.empty(96 * 2**20 // 4, device="cuda")
    B, K, T, D = 16, 4, 400, 512
    rows, worst = [], 0.0
    for dtype in (torch.float32, torch.bfloat16):
        args = attention_inputs(B, K, T, D, dtype, seed)
        for t_act in BOUNDED_T_ACTIVE:
            ctx, attn = fa._attention_cuda(*args, True, t_act)
            ctx_p, attn_p = fa._attention_plain(*args, True, t_act)
            torch.cuda.synchronize()
            err = max(float((ctx - ctx_p).abs().max()),
                      float((attn - attn_p).abs().max()))
            ms = time_cuda(lambda: fa._attention_cuda(*args, True, t_act),
                           20, flush)
            plain_ms = time_cuda(
                lambda: fa._attention_plain(*args, True, t_act), 10, flush)
            elt = 2 if dtype == torch.bfloat16 else 4
            bound, by, nbytes, ops = attention_bound_ms(B, K, T, D, elt, True,
                                                        t_act)
            row = dict(shape=f"{B}x{K}x{T}x{D}", t_active=t_act,
                       dtype=str(dtype).replace("torch.", ""), coverage=True,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops)
            print("attention_bounded " + json.dumps(row))
            check(bool(torch.isfinite(ctx).all()), f"non-finite ctx {row}")
            check(not bool(attn[:, :, t_act:].any()),
                  f"attn not exactly 0 past the bound at {row}")
            check(err <= ATTN_TOL, f"bounded kernel disagrees with plain "
                                   f"(err {err} > {ATTN_TOL}) at {row}")
            worst = max(worst, err)
            rows.append(row)
    return rows, worst


def phase_attention_long(seed):
    """Long encoders the kernel refused before: 16 beams over 2,000
    positions, 4 at the old bound (17,856 positions) and past it, with the
    per-position state still in shared memory, and two shapes whose state
    lives in device memory; against the plain version, and a repeat gives
    the same bits.  Times the kernel only."""
    import torch

    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # 96 MB > 50 MB L2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    # past the old refusal (its bound at K = 16, T 1,792; at K = 4, T
    # 17,856), then past what the state-in-shared-memory form takes
    for (B, K, T, D, in_smem) in [(16, 16, 2000, 512, True),
                                  (4, 4, 17856, 512, True),
                                  (4, 4, 20000, 512, True),
                                  (4, 4, 60000, 512, False),
                                  (16, 16, 8000, 512, False)]:
        check(fa._state_in_smem(B, T, D, K, 4, sms) == in_smem,
              f"{B}x{K}x{T}x{D} does not keep its state where expected")
        args = attention_inputs(B, K, T, D, torch.float32, seed)
        ctx, attn = fa._attention_cuda(*args, True)
        again = fa._attention_cuda(*args, True)
        ctx_p, attn_p = fa._attention_plain(*args, True)
        torch.cuda.synchronize()
        err = max(float((ctx - ctx_p).abs().max()),
                  float((attn - attn_p).abs().max()))
        same = torch.equal(ctx, again[0]) and torch.equal(attn, again[1])
        del ctx_p, attn_p, again
        ms = time_cuda(lambda: fa._attention_cuda(*args, True), 10, flush)
        bound, by, _, _ = attention_bound_ms(B, K, T, D, 4, True)
        row = dict(shape=f"{B}x{K}x{T}x{D}",
                   state="shared memory" if in_smem else "device memory",
                   max_abs_err=err, bitwise_repeat=same, ms=ms,
                   bound_ms=bound, bound_by=by)
        print("attention_long " + json.dumps(row))
        check(err <= ATTN_TOL, f"long-encoder kernel disagrees with plain "
                               f"(err {err}) at {row}")
        check(same, f"long-encoder kernel does not repeat its bits at {row}")
        worst = max(worst, err)
    return worst


def attention_bwd_bound_ms(B, T, D, use_cov, elt_bytes=4):
    """Least time for the backward on an H100: bytes (es, ef, mask, cov,
    attn, g_attn, df, g_ctx, v, w_c read once; d_es, d_ef, d_cov, d_df,
    d_v, d_w_c written once; es, ef, d_es and d_ef of ``elt_bytes`` each,
    2 for a bf16 encoder stream) over the memory rate, and f32 operations
    over the f32 peak: per (article, position, column) es . g_ctx (2),
    the query add (1), the coverage term (2), tanh (counted as 1), 1 - u^2
    (2), d_e v (1 - u^2) (2), d_es (1), d_df (1), d_v (2), and d_cov and
    d_w_c (2 + 2) with coverage."""
    big = elt_bytes * B * T * D
    rows = 4 * B * T * (6 if use_cov else 5)  # mask, cov, attn, g_attn, d_cov
    nbytes = 4 * big + rows + 4 * 3 * B * D + 4 * 4 * D
    ops = B * T * D * (14 + (6 if use_cov else 0))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def attention_bwd_args(fa, B, T, D, use_cov, seed, dtype=None):
    """The backward's arguments at (B, T, D): attention_inputs at K = 1 in
    ``dtype`` (f32 when None; bf16 es and ef are the f32 draws rounded),
    attn from the forward kernel of ``fa`` (the port's
    ops.fused_attention) and gradients of the context and the weights
    from seed + 1."""
    import torch

    es, ef, mask, df, cov, v, w_c = attention_inputs(
        B, 1, T, D, dtype or torch.float32, seed)
    df, cov = df[:, 0].contiguous(), cov[:, 0].contiguous()
    _, attn = fa._attention_rows(es, ef, mask, df, cov, v, w_c, use_cov)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    g_ctx = torch.randn(B, D, generator=g, device="cuda")
    g_attn = torch.randn(B, T, generator=g, device="cuda")
    return (es, ef, mask, df, cov, v, w_c, attn, g_ctx, g_attn, use_cov)


#: the backward's shapes (B, T, D, coverage): the training shape with
#: coverage on and off, a long encoder, and the training shape at
#: hidden_dim 430 (D 860)
ATTENTION_BWD_CASES = [(16, 400, 512, True), (16, 400, 512, False),
                       (4, 4096, 512, True), (16, 400, 860, True)]


def bf16_ulp(x):
    """One bf16 unit in the last place of each value of x (8 significant
    bits), as f32."""
    import torch

    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def phase_attention_bwd(seed):
    """The backward kernel against the plain backward at the training
    shape (16 articles x 400 positions x 512, K = 1, ragged masks, article
    1 empty), coverage on and off, and at a long encoder, on f32 and on
    bf16 encoder streams, and at the training shape of hidden_dim 430
    (D 860, f32); two launches give the same bits.  Tolerances:
    f32 gradients within 1e-5 * max(1, max|g|); in bf16 d_es and d_ef
    (f32 values within that tolerance, rounded once to bf16 by both)
    within one bf16 ulp of the plain version's plus the f32 tolerance,
    the f32 rest as in f32.  The largest absolute error returned per
    dtype covers all six outputs, the bf16 d_es and d_ef included.  No
    single PyTorch call computes this function, so there is no library
    time."""
    import torch

    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # 96 MB > 50 MB L2
    worst, main = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for (B, T, D, use_cov) in ATTENTION_BWD_CASES:
            if D > 512 and dtype == torch.bfloat16:
                continue  # the wide width trains in f32 on the main path
            args = attention_bwd_args(fa, B, T, D, use_cov, seed, dtype)
            got = fa._attention_bwd_cuda(*args)
            again = fa._attention_bwd_cuda(*args)
            want = fa._attention_bwd_plain(*args)
            torch.cuda.synchronize()
            names = ("d_es", "d_ef", "d_df", "d_cov", "d_v", "d_w_c")
            errs = {k: float((a.float() - w.float()).abs().max())
                    for k, a, w in zip(names, got, want)}
            # 1e-5 scaled by the gradient's size, as the CPU tests hold it
            tols = {k: ATTN_TOL * max(1.0, float(w.float().abs().max()))
                    for k, w in zip(names, want)}
            ulps, in_bf16_tol = {}, {}
            if dtype == torch.bfloat16:
                for k, a, w in list(zip(names, got, want))[:2]:
                    diff = (a.float() - w.float()).abs()
                    ulps[k] = float((diff / bf16_ulp(w)).max())
                    in_bf16_tol[k] = bool((diff <= bf16_ulp(w)
                                           + tols[k]).all())
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            empty_zero = all(float(a[1].abs().max()) == 0.0 for a in got[:4])
            right_dtype = got[0].dtype == got[1].dtype == dtype
            ms = time_cuda(lambda: fa._attention_bwd_cuda(*args), 20, flush)
            plain_ms = time_cuda(lambda: fa._attention_bwd_plain(*args), 10,
                                 flush)
            bound, by, nbytes, ops = attention_bwd_bound_ms(
                B, T, D, use_cov, 2 if dtype == torch.bfloat16 else 4)
            row = dict(shape=f"{B}x1x{T}x{D}", dtype=dname, coverage=use_cov,
                       max_abs_err=errs, bf16_ulps=ulps or None,
                       bitwise_repeat=same, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops,
                       library_ms=None)
            print("attention_bwd " + json.dumps(row))
            check(finite, f"non-finite backward at {row}")
            check(right_dtype, f"d_es/d_ef not in {dname} at {row}")
            check(empty_zero, f"empty article's gradients not zero at {row}")
            check(same, f"backward kernel does not repeat its bits at {row}")
            for k in names:
                if k in ulps:
                    check(in_bf16_tol[k], f"backward {k} more than one bf16 "
                                          f"ulp and the f32 tolerance from "
                                          f"plain at {row}")
                else:
                    check(errs[k] <= tols[k],
                          f"backward {k} disagrees with plain (err "
                          f"{errs[k]} > {tols[k]}) at {row}")
            worst[dname] = max(worst.get(dname, 0.0), *errs.values())
            if T == 400:
                main[(dname, use_cov, D)] = row
    return main, worst


#: the slab forms' shapes (B, K, T, D, dtype): the pointer-generator at
#: hidden_dim 1200 at beam 4 (past the dense form's room in f32; in bf16
#: the dense form still takes it), the long form at D 4096, and bf16 past
#: its dense room; the backward's at K = 1
SLAB_CASES = [(16, 4, 400, 2400, "float32"), (4, 1, 400, 4096, "float32"),
              (16, 4, 400, 2400, "bfloat16"), (16, 4, 400, 4096, "bfloat16")]
SLAB_BWD_CASES = [(16, 400, 2400, "float32"), (4, 400, 4096, "float32"),
                  (16, 400, 4096, "bfloat16")]
#: the sp-block forms at the reference shape's block at sp = 2 (200 of
#: the 400 positions), beam 4 (decode) and K = 1 (training)
SP_BLOCK_CASES = [(16, 4, 200, 512), (16, 1, 200, 512)]

#: the launch forms the parent (the tree before the slab and sp-block
#: forms) took, each (B, K, T, D, dtype, t_active) for the forward and
#: (B, T, D, dtype) for the backward; their outputs' digests over
#: digest_inputs must equal the parent's (PARENT_DIGESTS, from
#: scripts/torch_attention_bench.py --which digests on the parent's
#: checkout, NVIDIA H100 80GB HBM3)
DIGEST_FORWARD = [(16, 4, 400, 512, "float32", None),
                  (16, 4, 400, 512, "bfloat16", None),
                  (16, 4, 400, 512, "float32", 128),
                  (4, 1, 4096, 512, "float32", None),
                  (4, 1, 4096, 512, "bfloat16", None),
                  (16, 1, 400, 512, "float32", None),
                  (4, 4, 400, 512, "float32", None),
                  (16, 4, 400, 800, "float32", None),
                  (16, 1, 400, 860, "float32", None),
                  (2, 4, 400, 2048, "float32", None),
                  (16, 4, 400, 2224, "float32", None),
                  (16, 1, 400, 2400, "float32", None),
                  (16, 4, 400, 2400, "bfloat16", None)]
DIGEST_BACKWARD = [(16, 400, 512, "float32"), (16, 400, 512, "bfloat16"),
                   (4, 4096, 512, "float32"), (16, 400, 860, "float32"),
                   (2, 40, 2308, "float32"), (2, 40, 3072, "bfloat16")]
PARENT_DIGESTS = {
    "fwd 16x4x400x512 float32 t_active=None": "3b84344cc79fe661",
    "fwd 16x4x400x512 bfloat16 t_active=None": "c64015ef87b938ef",
    "fwd 16x4x400x512 float32 t_active=128": "4ade2dbb3b1ac109",
    "fwd 4x1x4096x512 float32 t_active=None": "ca2ddc6ef220161e",
    "fwd 4x1x4096x512 bfloat16 t_active=None": "8d7024ca7a06f922",
    "fwd 16x1x400x512 float32 t_active=None": "dcc727f225cab1df",
    "fwd 4x4x400x512 float32 t_active=None": "e6ae78f14d10bd27",
    "fwd 16x4x400x800 float32 t_active=None": "709b8c5e2ddcabb6",
    "fwd 16x1x400x860 float32 t_active=None": "b8ff83b01e91149c",
    "fwd 2x4x400x2048 float32 t_active=None": "722a351aae7283a7",
    "fwd 16x4x400x2224 float32 t_active=None": "32ac66e5363ee532",
    "fwd 16x1x400x2400 float32 t_active=None": "49a6f5fad6cda785",
    "fwd 16x4x400x2400 bfloat16 t_active=None": "8579e433ebed52f1",
    "bwd 16x400x512 float32": "8e56f63593c9b4e6",
    "bwd 16x400x512 bfloat16": "228125dca866177b",
    "bwd 4x4096x512 float32": "cf44c0fda213170d",
    "bwd 16x400x860 float32": "c15dae595067c900",
    "bwd 2x40x2308 float32": "a206e545d6096d27",
    "bwd 2x40x3072 bfloat16": "2dc73e9a5096851f",
}


def digest_inputs(B, K, T, D, dtype, seed):
    """The fused attention's inputs from numpy (the same bits under any
    torch build): ragged lengths, article 1 fully masked, at model
    scale."""
    import torch

    rng = np.random.RandomState(seed)
    lens = rng.randint(T // 2, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    if B > 1:
        mask[1] = 0.0
    lim = (6.0 / (2 * D)) ** 0.5
    arrays = dict(
        es=rng.randn(B, T, D).astype(np.float32),
        ef=rng.randn(B, T, D).astype(np.float32), mask=mask,
        df=rng.randn(B, K, D).astype(np.float32),
        cov=(rng.rand(B, K, T) * mask[:, None] * 3.0).astype(np.float32),
        v=(rng.uniform(-1, 1, D) * lim).astype(np.float32),
        w_c=(rng.uniform(-1, 1, D) * lim).astype(np.float32))
    out = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    for k in ("es", "ef"):
        out[k] = out[k].to(getattr(torch, dtype))
    return [out[k] for k in ("es", "ef", "mask", "df", "cov", "v", "w_c")]


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def fused_digests(fa):
    """{case: digest} of the fused attention's forward (ctx, attn) and
    backward (its six gradients) at the parent's launch forms
    (DIGEST_FORWARD, DIGEST_BACKWARD), through ``fa`` (the port's
    ops.fused_attention, or another checkout's)."""
    import torch

    out = {}
    for (B, K, T, D, dtype, t_act) in DIGEST_FORWARD:
        args = digest_inputs(B, K, T, D, dtype, 1)
        out[f"fwd {B}x{K}x{T}x{D} {dtype} t_active={t_act}"] = _digest(
            fa._attention_cuda(*args, True, t_act))
    for (B, T, D, dtype) in DIGEST_BACKWARD:
        es, ef, mask, df, cov, v, w_c = digest_inputs(B, 1, T, D, dtype, 2)
        df, cov = df[:, 0].contiguous(), cov[:, 0].contiguous()
        _, attn = fa._attention_cuda(es, ef, mask, df[:, None].contiguous(),
                                     cov[:, None].contiguous(), v, w_c, True)
        rng = np.random.RandomState(3)
        g_ctx = torch.from_numpy(rng.randn(B, D).astype(np.float32)).cuda()
        g_attn = torch.from_numpy(rng.randn(B, T).astype(np.float32)).cuda()
        out[f"bwd {B}x{T}x{D} {dtype}"] = _digest(fa._attention_bwd_cuda(
            es, ef, mask, df, cov, v, w_c, attn[:, 0].contiguous(), g_ctx,
            g_attn, True))
    torch.cuda.synchronize()
    return out


#: the flash kernels' launch forms with as many query rows as keys (the
#: only forms the parent took): (B, T, nh, hd, causal, dtype, kernels),
#: whose outputs on flash_digest_inputs must equal the parent's
#: (FLASH_PARENT_DIGESTS, from scripts/torch_flash_bench.py --which
#: digests on the parent's checkout, NVIDIA H100 80GB HBM3): the f32 and
#: bf16 kernels at head dims 32, 128 and 256, masked and causal; the wide
#: dQ's SIMT form (``simt=True``, the design of its digests) at 512; the
#: SIMT wide forward, dK/dV and dQ at 1152 (``simt=True``: the default of
#: all three there is now a 9-block cluster); the SIMT dQ at 2176 (key
#: mask) and 4224 (causal), the parent's default there (``simt=True``:
#: the default is now the multi-slab cluster).  The wide forward, dK/dV
#: and dQ at 384-8192 are new designs (the cluster forms),
#: held to their plain versions by phase_flash_wide and
#: phase_flash_query_block instead
FLASH_ALL = ("fwd", "fwd_lse", "dkv", "dq")
FLASH_DIGEST_CASES = (
    [(3, 200, 2, hd, False, dt, FLASH_ALL) for hd in (32, 128, 256)
     for dt in ("float32", "bfloat16")]
    + [(2, 130, 2, hd, True, dt, FLASH_ALL) for hd in (32, 128, 256)
       for dt in ("float32", "bfloat16")]
    + [(2, 130, 1, 512, c, dt, ("dq",)) for c in (False, True)
       for dt in ("float32", "bfloat16")]
    + [(2, 70, 1, 1152, False, dt, FLASH_ALL)
       for dt in ("float32", "bfloat16")]
    + [(2, 100, 1, 2176, False, dt, ("dq",))
       for dt in ("float32", "bfloat16")]
    + [(2, 130, 1, 4224, True, dt, ("dq",))
       for dt in ("float32", "bfloat16")])
FLASH_PARENT_DIGESTS = {
    "fwd 3x200x2x32 mask float32": "ad16a6f9c7496633",
    "fwd_lse 3x200x2x32 mask float32": "a2317474c00f1989",
    "dkv 3x200x2x32 mask float32": "f6e7513d606dd570",
    "dq 3x200x2x32 mask float32": "b02b32b64b0c72c2",
    "fwd 3x200x2x32 mask bfloat16": "a23477691b9a9d61",
    "fwd_lse 3x200x2x32 mask bfloat16": "ff61051ee3e4e7ee",
    "dkv 3x200x2x32 mask bfloat16": "004a5e320edf13eb",
    "dq 3x200x2x32 mask bfloat16": "8ac731d36e3883c8",
    "fwd 3x200x2x128 mask float32": "3180a81cbaafa288",
    "fwd_lse 3x200x2x128 mask float32": "0a96ddda16e1d2bf",
    "dkv 3x200x2x128 mask float32": "2dd11932eb1d1423",
    "dq 3x200x2x128 mask float32": "5f3989d91948284a",
    "fwd 3x200x2x128 mask bfloat16": "35b737f30aa68351",
    "fwd_lse 3x200x2x128 mask bfloat16": "2fb22cfdff78e337",
    "dkv 3x200x2x128 mask bfloat16": "8e6484f1e7f81fc7",
    "dq 3x200x2x128 mask bfloat16": "0d5b70b46e12d26f",
    "fwd 3x200x2x256 mask float32": "6d4e992fb94d463a",
    "fwd_lse 3x200x2x256 mask float32": "ee862068d89af913",
    "dkv 3x200x2x256 mask float32": "6529575f4c8a055c",
    "dq 3x200x2x256 mask float32": "3dde8b8770574c56",
    "fwd 3x200x2x256 mask bfloat16": "2f4105d729eb3eb3",
    "fwd_lse 3x200x2x256 mask bfloat16": "dcaa491411bf0bc6",
    "dkv 3x200x2x256 mask bfloat16": "4df93a77dbc17797",
    "dq 3x200x2x256 mask bfloat16": "077cdd55dc1afe40",
    "fwd 2x130x2x32 causal float32": "74fdc1762eac115c",
    "fwd_lse 2x130x2x32 causal float32": "86667b758060bad3",
    "dkv 2x130x2x32 causal float32": "760d795008c379e2",
    "dq 2x130x2x32 causal float32": "8f26f0b948c7e2ed",
    "fwd 2x130x2x32 causal bfloat16": "7077523b6bdf4351",
    "fwd_lse 2x130x2x32 causal bfloat16": "aaeb9be5968e8a52",
    "dkv 2x130x2x32 causal bfloat16": "3d5288d063eac5d5",
    "dq 2x130x2x32 causal bfloat16": "591821d2c6855bc3",
    "fwd 2x130x2x128 causal float32": "ab177fac360749d0",
    "fwd_lse 2x130x2x128 causal float32": "1b11643a384b434d",
    "dkv 2x130x2x128 causal float32": "526ff3490e7c9441",
    "dq 2x130x2x128 causal float32": "1e42a630e6823711",
    "fwd 2x130x2x128 causal bfloat16": "d7c5ae6d0adee2fb",
    "fwd_lse 2x130x2x128 causal bfloat16": "fcba9c9da8205e33",
    "dkv 2x130x2x128 causal bfloat16": "567d136ac95680f0",
    "dq 2x130x2x128 causal bfloat16": "f6d03e904af7c84d",
    "fwd 2x130x2x256 causal float32": "05502ddea1e0ff01",
    "fwd_lse 2x130x2x256 causal float32": "2bf9dcdd724b56df",
    "dkv 2x130x2x256 causal float32": "059cb26323754777",
    "dq 2x130x2x256 causal float32": "4e0347cabbed1ef3",
    "fwd 2x130x2x256 causal bfloat16": "ece117c8689415cf",
    "fwd_lse 2x130x2x256 causal bfloat16": "1a04ff3116f695bd",
    "dkv 2x130x2x256 causal bfloat16": "3ca8b2480dde4976",
    "dq 2x130x2x256 causal bfloat16": "8b3662707b09c5e9",
    "dq 2x130x1x512 mask float32": "b7e4d4dfc6693b76",
    "dq 2x130x1x512 mask bfloat16": "1dd8656956636ee2",
    "dq 2x130x1x512 causal float32": "ddd24e7f7c945915",
    "dq 2x130x1x512 causal bfloat16": "5d50d5bef3597bb7",
    "fwd 2x70x1x1152 mask float32": "6b76179fca52ba29",
    "fwd_lse 2x70x1x1152 mask float32": "7eb004f36ddbd277",
    "dkv 2x70x1x1152 mask float32": "5c7151d14692bb59",
    "dq 2x70x1x1152 mask float32": "90d08bdec7bfcaad",
    "fwd 2x70x1x1152 mask bfloat16": "19f85751ea519d48",
    "fwd_lse 2x70x1x1152 mask bfloat16": "1d6023ce745f6e39",
    "dkv 2x70x1x1152 mask bfloat16": "b920ba590c6ff079",
    "dq 2x70x1x1152 mask bfloat16": "23dd75e9f511d651",
    "dq 2x100x1x2176 mask float32": "f570e8af72fff165",
    "dq 2x100x1x2176 mask bfloat16": "8b99c0e6777d78af",
    "dq 2x130x1x4224 causal float32": "abc50e805eb8f106",
    "dq 2x130x1x4224 causal bfloat16": "c3eaa68b91685a16",
}


#: the clusters past 8 blocks (12 blocks with a key mask, 16 causal),
#: through their default launch: no parent took these forms, so their
#: digests (FLASH_C16_DIGESTS) are the bits they gave on an H100 (NVIDIA
#: H100 80GB HBM3) when they were added (the forward's and dK/dV's, then
#: the dQ's), printed by scripts/torch_flash_bench.py --which digests
#: ("c16"), held from then on; the f32 forward's split and one-sum
#: exchanges gave the same bits
FLASH_C16_KERNELS = ("fwd", "fwd_lse", "dkv", "dq")
FLASH_C16_DIGEST_CASES = (
    [(2, 100, 1, 1536, False, dt, FLASH_C16_KERNELS)
     for dt in ("float32", "bfloat16")]
    + [(2, 130, 1, 2048, True, dt, FLASH_C16_KERNELS)
       for dt in ("float32", "bfloat16")])
FLASH_C16_DIGESTS = {
    "fwd 2x100x1x1536 mask float32": "593c4300842dc372",
    "fwd_lse 2x100x1x1536 mask float32": "c2cdbeb184034fb9",
    "dkv 2x100x1x1536 mask float32": "50159a009ce7555b",
    "fwd 2x100x1x1536 mask bfloat16": "35c9425db3ffa5a4",
    "fwd_lse 2x100x1x1536 mask bfloat16": "8e5246c4ad01dc4f",
    "dkv 2x100x1x1536 mask bfloat16": "f2eb63c762a6758e",
    "fwd 2x130x1x2048 causal float32": "c39694a226d5ac8d",
    "fwd_lse 2x130x1x2048 causal float32": "1e07184a8709c4e6",
    "dkv 2x130x1x2048 causal float32": "ec5009585ec7da6d",
    "fwd 2x130x1x2048 causal bfloat16": "2ab073f1e95ce968",
    "fwd_lse 2x130x1x2048 causal bfloat16": "1f3e10c768c61855",
    "dkv 2x130x1x2048 causal bfloat16": "e2f831a83fc342da",
    "dq 2x100x1x1536 mask float32": "36749b92679d1b57",
    "dq 2x100x1x1536 mask bfloat16": "0f10a0bf4c1d87a8",
    "dq 2x130x1x2048 causal float32": "b436eb30e1088877",
    "dq 2x130x1x2048 causal bfloat16": "b624c02514c1c01b",
}


#: the multi-slab cluster forms above head dim 2048 (2176 with a key
#: mask: 9 blocks of 2 slabs, the last block one; 4224 causal: 11 blocks
#: of 3), through their default launch: their digests
#: (FLASH_SLAB_DIGESTS) are the bits they gave on an H100 (NVIDIA H100
#: 80GB HBM3) when they were added (the forward's and dK/dV's, then the
#: dQ's), printed by scripts/torch_flash_bench.py --which digests
#: ("slabs"), held from then on
FLASH_SLAB_KERNELS = ("fwd", "fwd_lse", "dkv", "dq")
FLASH_SLAB_DIGEST_CASES = (
    [(2, 100, 1, 2176, False, dt, FLASH_SLAB_KERNELS)
     for dt in ("float32", "bfloat16")]
    + [(2, 130, 1, 4224, True, dt, FLASH_SLAB_KERNELS)
       for dt in ("float32", "bfloat16")])
FLASH_SLAB_DIGESTS = {
    "fwd 2x100x1x2176 mask float32": "96e2e61ca747f8d7",
    "fwd_lse 2x100x1x2176 mask float32": "7b7b96a8bceb15ee",
    "dkv 2x100x1x2176 mask float32": "e380f8da0a60e5c9",
    "fwd 2x100x1x2176 mask bfloat16": "570ffe5fefa6e601",
    "fwd_lse 2x100x1x2176 mask bfloat16": "5ff7ff0a28629c37",
    "dkv 2x100x1x2176 mask bfloat16": "aacf9f6a5fd64d82",
    "fwd 2x130x1x4224 causal float32": "e414e0190b983011",
    "fwd_lse 2x130x1x4224 causal float32": "16c2e9d33d7cb367",
    "dkv 2x130x1x4224 causal float32": "3bd9ea29449f56f7",
    "fwd 2x130x1x4224 causal bfloat16": "8c77e704522e1d44",
    "fwd_lse 2x130x1x4224 causal bfloat16": "6a31c6677de23fbd",
    "dkv 2x130x1x4224 causal bfloat16": "304d495098b7aad9",
    "dq 2x100x1x2176 mask float32": "73c135eab795b854",
    "dq 2x100x1x2176 mask bfloat16": "123ad49a79c490b3",
    "dq 2x130x1x4224 causal float32": "e227fe3865e4097e",
    "dq 2x130x1x4224 causal bfloat16": "f8cd46f251243290",
}


def flash_digest_inputs(B, T, nh, hd, causal, dtype, seed):
    """q, k, v, dO [B, T, nh, hd] and the key mask (None when causal, else
    ragged with article 1 fully masked) from numpy: the same bits under
    any torch build."""
    import torch

    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(
        rng.randn(B, T, nh, hd).astype(np.float32)).cuda().to(
            getattr(torch, dtype)) for _ in range(4))
    if causal:
        return q, k, v, do, None
    lens = rng.randint(T // 3, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    mask[1] = 0.0
    return q, k, v, do, torch.from_numpy(mask).cuda()


def flash_rows_np(q, k, v, do, mask, causal, scale):
    """lse [B, T, nh] (+inf for a row with no key to attend) and dsum =
    rowsum(dO * O) of the attention, in float64 numpy (np.einsum's own
    loops: the same bits on any machine) rounded to f32 on the card: the
    backward kernels' row inputs, independent of any forward kernel."""
    import torch

    qn, kn, vn, don = (x.float().cpu().numpy().astype(np.float64)
                       for x in (q, k, v, do))
    B, T = qn.shape[:2]
    s = np.einsum("bqnd,bknd->bnqk", qn, kn) * scale
    ok = np.ones((B, 1, T, T), bool)
    if mask is not None:
        ok &= (mask.cpu().numpy() > 0)[:, None, None, :]
    if causal:
        ok &= np.tril(np.ones((T, T), bool))
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    row_ok = np.isfinite(m)
    p = np.where(ok, np.exp(s - np.where(row_ok, m, 0.0)), 0.0)
    l = p.sum(-1, keepdims=True)
    lse = np.where(row_ok, m + np.log(np.where(row_ok, l, 1.0)), np.inf)
    out = np.einsum("bnqk,bknd->bqnd", p / np.where(row_ok, l, 1.0), vn)
    dsum = (don * out).sum(-1)
    return (torch.from_numpy(lse[..., 0].transpose(0, 2, 1).astype(
                np.float32).copy()).cuda(),
            torch.from_numpy(dsum.astype(np.float32)).cuda())


def flash_digests(fl, cases=FLASH_DIGEST_CASES, simt=True):
    """{case: digest} of each flash kernel's outputs at ``cases``
    through ``fl`` (the port's ops.flash_attention, or another
    checkout's): the serving forward (out), the training forward (out,
    lse), and dK/dV and dQ from flash_rows_np's lse and dsum.  With
    ``simt`` every wide launch takes its SIMT form (``simt=True``) where
    ``fl``'s wrapper has the flag: the design whose bits
    FLASH_PARENT_DIGESTS hold at the wide head dims (a checkout without
    the flag has only that form there); without it, the default launch
    (FLASH_C16_DIGEST_CASES)."""
    import inspect

    import torch

    def kw(fn, hd):
        takes = "simt" in inspect.signature(fn).parameters
        return dict(simt=True) if simt and takes and hd > 256 else {}

    out = {}
    for i, (B, T, nh, hd, causal, dtype, kernels) in enumerate(cases):
        q, k, v, do, mask = flash_digest_inputs(B, T, nh, hd, causal, dtype,
                                                i)
        scale = hd ** -0.5
        name = f"{B}x{T}x{nh}x{hd} {'causal' if causal else 'mask'} {dtype}"
        lse, dsum = flash_rows_np(q, k, v, do, mask, causal, scale)
        fwd_kw, dkv_kw, dq_kw = (kw(fn, hd) for fn in (
            fl._flash_cuda, fl._bwd_dkv_cuda, fl._bwd_dq_cuda))
        runs = dict(
            fwd=lambda: (fl._flash_cuda(q, k, v, mask, causal, scale,
                                        **fwd_kw),),
            fwd_lse=lambda: fl._flash_cuda(q, k, v, mask, causal, scale,
                                           with_lse=True, **fwd_kw),
            dkv=lambda: fl._bwd_dkv_cuda(q, k, v, do, lse, dsum, mask, causal,
                                         scale, **dkv_kw),
            dq=lambda: (fl._bwd_dq_cuda(q, k, v, do, lse, dsum, mask, causal,
                                        scale, **dq_kw),))
        for kernel in kernels:
            out[f"{kernel} {name}"] = _digest(runs[kernel]())
    torch.cuda.synchronize()
    return out


FUSED_KERNELS = ("attention_kernel", "attention_slab_kernel",
                 "attention_bwd_kernel", "attention_bwd_slab_kernel")


def fused_sass():
    """The fused attention's ptxas report (scripts/torch_kernel_sass.py
    over both libraries' build logs): registers and spill bytes of every
    instantiation of the dense and slab kernels.  Fails unless every
    one is there with 0 bytes of spill."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_kernel_sass as sass

    from textsummarization_on_flink_tpu_torch.kernels import build

    out, seen = {}, set()
    for lib in ("fused_attention", "fused_attention_bwd"):
        build.build(lib)
        for func, info in sass.ptxas_functions(build.build_log(lib)).items():
            kernel = next((k for k in FUSED_KERNELS[::-1] if k in func),
                          None)
            if kernel is None:
                continue
            seen.add(kernel)
            spill = info.get("spill_stores", -1) + info.get("spill_loads", -1)
            out[func] = dict(registers=info.get("registers"),
                             spill_bytes=spill)
            check(spill == 0, f"fused kernel {func}: ptxas {info} (want 0 "
                              f"bytes of spill)")
    check(seen == set(FUSED_KERNELS),
          f"fused kernels missing from the build logs: {seen}")
    print("fused_sass " + json.dumps(dict(
        instantiations=len(out),
        max_registers=max(v["registers"] or 0 for v in out.values()),
        spill_bytes=sum(v["spill_bytes"] for v in out.values()))))
    return out


def phase_attention_forms(seed):
    """The slab and sp-block forms of both fused kernels against their
    plain versions, timed beside their bounds, and the parent's launch
    forms' digests:

      * the slab forward at SLAB_CASES (coverage on), the slab backward
        at SLAB_BWD_CASES: each launch counted as a slab launch, within
        ATTN_TOL (f32; the backward scaled by its largest gradient, bf16
        d_es and d_ef within one bf16 ulp beside that), a rerun the same
        bits;
      * the sp-block forward at SP_BLOCK_CASES: ctx, attn, the row max
        and the row sum against _attention_block_plain; the sp-block
        backward at the K = 1 block with an outside correction against
        _attention_bwd_plain with the same correction;
      * fused_digests at the parent's forms, equal to PARENT_DIGESTS.

    No single PyTorch call computes these functions: no library time."""
    import torch

    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    flush = torch.empty(96 * 2**20 // 4, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for (B, K, T, D, dname) in SLAB_CASES:
        dtype = getattr(torch, dname)
        elt = 2 if dname == "bfloat16" else 4
        slab = fa._launch_form(B, T, D, K, elt, sms)[3]
        args = attention_inputs(B, K, T, D, dtype, seed)
        before = fa.launches_slab
        got = fa._attention_cuda(*args, True)
        again = fa._attention_cuda(*args, True)
        want = fa._attention_plain(*args, True)
        torch.cuda.synchronize()
        check(fa.launches_slab - before == (2 if slab else 0),
              f"slab launches at {B}x{K}x{T}x{D} {dname}")
        err = max(float((a - w).abs().max()) for a, w in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ms = time_cuda(lambda: fa._attention_cuda(*args, True), 20, flush)
        plain_ms = time_cuda(lambda: fa._attention_plain(*args, True), 5,
                             flush)
        bound, by, nbytes, ops = attention_bound_ms(B, K, T, D, elt, True)
        row = dict(shape=f"{B}x{K}x{T}x{D}", dtype=dname, slab=slab,
                   max_abs_err=err, bitwise_repeat=same, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   bytes=nbytes, ops=ops, library_ms=None)
        print("attention_slab " + json.dumps(row))
        check(err <= ATTN_TOL, f"slab forward disagrees with plain at {row}")
        check(same, f"slab forward does not repeat its bits at {row}")
        rows[("fwd", B, K, T, D, dname)] = row
    for (B, T, D, dname) in SLAB_BWD_CASES:
        dtype = getattr(torch, dname)
        args = attention_bwd_args(fa, B, T, D, True, seed, dtype)
        before = fa.launches_bwd_slab
        got = fa._attention_bwd_cuda(*args)
        again = fa._attention_bwd_cuda(*args)
        want = fa._attention_bwd_plain(*args)
        torch.cuda.synchronize()
        check(fa.launches_bwd_slab - before == 2,
              f"backward slab launches at {B}x{T}x{D} {dname}")
        errs, ok = _bwd_errors(got, want, dname)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ms = time_cuda(lambda: fa._attention_bwd_cuda(*args), 20, flush)
        plain_ms = time_cuda(lambda: fa._attention_bwd_plain(*args), 5,
                             flush)
        bound, by, nbytes, ops = attention_bwd_bound_ms(
            B, T, D, True, 2 if dname == "bfloat16" else 4)
        row = dict(shape=f"{B}x1x{T}x{D}", dtype=dname, slab=True,
                   max_abs_err=max(errs.values()), errors=errs,
                   bitwise_repeat=same, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops,
                   library_ms=None)
        print("attention_bwd_slab " + json.dumps(row))
        check(ok, f"slab backward disagrees with plain at {row}")
        check(same, f"slab backward does not repeat its bits at {row}")
        rows[("bwd", B, T, D, dname)] = row
    for (B, K, T, D) in SP_BLOCK_CASES:
        args = attention_inputs(B, K, T, D, torch.float32, seed)
        before = fa.launches_sp
        got = fa._attention_cuda(*args, True, None, True)
        want = fa._attention_block_plain(*args, True)
        torch.cuda.synchronize()
        check(fa.launches_sp - before == 1, "sp-block launches")
        valid = want[3] > 0  # the row max of a masked row is NEG on both
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()),
                  float(((got[2] - want[2]).abs() * valid).max()),
                  float(((got[3] - want[3]).abs()
                         / want[3].clamp(min=1.0)).max()))
        masked_ok = bool((got[3][~valid] == 0).all()) and bool(
            (got[2][~valid] == fa.NEG).all())
        ms = time_cuda(lambda: fa._attention_cuda(*args, True, None, True),
                       20, flush)
        plain_ms = time_cuda(lambda: fa._attention_block_plain(*args, True),
                             5, flush)
        bound, by, nbytes, ops = attention_bound_ms(B, K, T, D, 4, True)
        nbytes += 8 * B * K  # the row max and sum written
        bound = max(bound, nbytes / PEAK_BYTES_PER_S * 1e3)
        row = dict(shape=f"{B}x{K}x{T}x{D}", dtype="float32",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=by, bytes=nbytes, ops=ops, library_ms=None)
        print("attention_sp_block " + json.dumps(row))
        check(err <= ATTN_TOL and masked_ok,
              f"sp-block forward disagrees with plain at {row}")
        rows[("sp", B, K, T, D)] = row
    B, K, T, D = SP_BLOCK_CASES[1]
    args = list(attention_bwd_args(fa, B, T, D, True, seed))
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    correction = torch.randn(B, generator=g, device="cuda")
    before = fa.launches_bwd_sp
    got = fa._attention_bwd_cuda(*args, correction)
    want = fa._attention_bwd_plain(*args, correction)
    torch.cuda.synchronize()
    check(fa.launches_bwd_sp - before == 1, "sp-block backward launches")
    errs, ok = _bwd_errors(got, want, "float32")
    ms = time_cuda(lambda: fa._attention_bwd_cuda(*args, correction), 20,
                   flush)
    plain_ms = time_cuda(lambda: fa._attention_bwd_plain(*args, correction),
                         5, flush)
    bound, by, nbytes, ops = attention_bwd_bound_ms(B, T, D, True)
    row = dict(shape=f"{B}x1x{T}x{D}", dtype="float32",
               max_abs_err=max(errs.values()), errors=errs, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by, bytes=nbytes,
               ops=ops, library_ms=None)
    print("attention_bwd_sp_block " + json.dumps(row))
    check(ok, f"sp-block backward disagrees with plain at {row}")
    rows[("bwd_sp", B, T, D)] = row
    digests = fused_digests(fa)
    same = {k: PARENT_DIGESTS.get(k) == d for k, d in digests.items()}
    print("fused_digests " + json.dumps(dict(
        digests=digests, compared=len(PARENT_DIGESTS),
        equal_to_parent=sum(same.values()))))
    check(len(PARENT_DIGESTS) == 0 or all(same.values()),
          f"the parent's launch forms changed their bits: {same}")
    return rows


def _bwd_errors(got, want, dname):
    """({gradient: largest abs error}, within tolerance): f32 within
    ATTN_TOL scaled by the gradient's largest magnitude; bf16 d_es and
    d_ef within one bf16 ulp beside that."""
    import torch

    names = ("d_es", "d_ef", "d_df", "d_cov", "d_v", "d_w_c")
    errs, ok = {}, True
    for k, a, w in zip(names, got, want):
        diff = (a.float() - w.float()).abs()
        errs[k] = float(diff.max())
        tol = ATTN_TOL * max(1.0, float(w.float().abs().max()))
        if dname == "bfloat16" and k in ("d_es", "d_ef"):
            ok = ok and bool((diff <= bf16_ulp(w) + tol).all())
        else:
            ok = ok and errs[k] <= tol
        ok = ok and bool(torch.isfinite(a.float()).all())
    return errs, ok


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


def flash_bound_ms(q, key_mask, causal, Tk=None):
    """Least time for the function on an H100: the larger of bytes moved
    (q, k, v and the mask read once, the output written once; q's element
    size for q, k, v and out, 4 bytes for the mask) over the memory rate
    and the operations this run's data needs over the tensor-core rate
    of q's dtype (PEAK_TF32X3_OPS_PER_S for f32, the 3xTF32 rate;
    PEAK_BF16_OPS_PER_S for bf16): 4 * hd operations (two multiply-adds)
    per (query row, head, key it may attend), counted from the mask and
    the causal triangle.  ``Tk``: the keys' length where q is a block of
    fewer rows (q and out then hold Tq rows, k, v and the mask Tk)."""
    import torch

    B, T, nh, hd = q.shape
    Tk = T if Tk is None else Tk
    keys = (key_mask > 0).float() if key_mask is not None \
        else torch.ones((B, Tk), device=q.device)
    if causal:  # key j is attended by the rows j .. T-1
        pairs = float((keys * (T - torch.arange(T, device=q.device))).sum())
    else:
        pairs = float(keys.sum()) * T
    ops = 4 * hd * nh * pairs
    nbytes = 2 * q.element_size() * B * (T + Tk) * nh * hd + (
        4 * B * Tk if key_mask is not None else 0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / flash_peak_ops(q) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def flash_peak_ops(q):
    """The tensor-core rate of the flash kernels' form for q's dtype."""
    import torch

    return (PEAK_BF16_OPS_PER_S if q.dtype == torch.bfloat16
            else PEAK_TF32X3_OPS_PER_S)


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
    main = hd256 = None
    # the encoder's shape, the long-context shape, and the encoder of the
    # transformer at --hidden_dim=512 --num_heads=2 (head dim 256, whose
    # kernels split the output's columns over two blocks)
    cases = [(16, 400, 8, 32), (4, 2048, 8, 128), (16, 400, 2, 256)]
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
            if hd == 256 and not causal:
                hd256 = row
    return main, hd256, worst


def flash_bwd_bounds(q, key_mask, causal, Tk=None):
    """Least times on an H100 for the backward, counted as flash_bound_ms
    does (operations per (row, head, attended key) from the mask and the
    causal triangle; each input read once, each output written once):
    the whole backward, 10 * hd operations (s, dO . v, and the dv, dk, dq
    updates) over q, k, v, out, dO, lse, the mask and dq, dk, dv; the
    dK/dV kernel's function, 8 * hd over q, k, v, dO, lse, D, the mask and
    dk, dv; the dQ kernel's, 6 * hd over q, k, v, dO, lse, D, the mask
    and dq.  Operations at the rate of q's dtype (flash_peak_ops), for
    all three; [B, T, nh, hd] tensors at q's element size, lse, D and the
    mask at 4 bytes.  ``Tk`` as flash_bound_ms's: q, out, dO and dq then
    hold Tq rows, k, v, dk, dv and the mask Tk.  Returns {name: (ms,
    bound_by)}."""
    B, T, nh, hd = q.shape
    Tk = T if Tk is None else Tk
    _, _, _, fwd_ops = flash_bound_ms(q, key_mask, causal, Tk)
    head_pairs = fwd_ops / (4 * hd)  # (row, head, attended key) triples
    # bytes of one [B, T, nh, hd] tensor of the queries' and of the keys'
    big_q = q.element_size() * B * T * nh * hd
    big_k = q.element_size() * B * Tk * nh * hd
    row = 4 * B * T * nh  # one [B, T, nh] f32 tensor
    mask = 4 * B * Tk if key_mask is not None else 0
    out = {}
    # (the queries' tensors: q, out, dO, dq; the keys': k, v, dk, dv)
    for name, n_q, n_k, n_row, ops_per in (("backward", 4, 4, 1, 10),
                                           ("dkv", 2, 4, 2, 8),
                                           ("dq", 3, 2, 2, 6)):
        t_bytes = (n_q * big_q + n_k * big_k + n_row * row + mask) \
            / PEAK_BYTES_PER_S * 1e3
        t_ops = ops_per * hd * head_pairs / flash_peak_ops(q) * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def phase_flash_bwd(seed):
    """The dK/dV and dQ kernels against the plain backward (and the
    backward of scaled_dot_product_attention as the library's time) at
    the training shapes and the long-context shape; the forward's lse
    output against the plain one at the training shapes."""
    import torch
    import torch.nn.functional as F

    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # 96 MB > 50 MB L2
    cases = [(16, 400, 8, 32, False), (16, 100, 8, 32, True),
             (4, 2048, 8, 128, False), (4, 2048, 8, 128, True),
             (16, 400, 2, 256, False), (16, 100, 2, 256, True)]
    rows = []
    worst = dict(dq=0.0, dk=0.0, dv=0.0)
    for (B, T, nh, hd, causal) in cases:
        # the encoder masks padding keys (article 1 empty); the causal
        # decoder has none
        q, k, v, mask = flash_inputs(B, T, nh, hd, seed, not causal)
        scale = hd ** -0.5
        out, lse = fl._flash_cuda(q, k, v, mask, causal, scale,
                                  with_lse=True)
        do = torch.randn_like(q)
        dq, dk, dv = fl._flash_bwd_cuda(q, k, v, out, lse, do, mask, causal,
                                        scale)
        lse_p = fl._flash_lse_plain(q, k, mask, causal, scale)
        want = fl._flash_bwd_plain(q, k, v, out, lse_p, do, mask, causal,
                                   scale)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        errs = {name: float((g - w).abs().max())
                for name, g, w in zip(names, (dq, dk, dv), want)}
        # 1e-5 scaled by the gradient's size, as the CPU tests hold it
        tols = {name: ATTN_TOL * max(1.0, float(w.abs().max()))
                for name, w in zip(names, want)}
        finite = all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
        empty_zero = mask is None or all(
            float(g[1].abs().max()) == 0.0 for g in (dq, dk, dv))
        dsum = torch.sum(do * out, dim=-1)
        dkv_ms = time_cuda(lambda: fl._bwd_dkv_cuda(
            q, k, v, do, lse, dsum, mask, causal, scale), 20, flush)
        dq_ms = time_cuda(lambda: fl._bwd_dq_cuda(
            q, k, v, do, lse, dsum, mask, causal, scale), 20, flush)
        plain_ms = time_cuda(lambda: fl._flash_bwd_plain(
            q, k, v, out, lse_p, do, mask, causal, scale), 10, flush)
        # the library's backward alone: the graph is built once and kept
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        bool_mask = None if mask is None else (mask > 0)[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bool_mask, is_causal=causal, scale=scale)
        do_t = do.transpose(1, 2)
        library_ms = time_cuda(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), do_t, retain_graph=True), 20, flush)
        bounds = flash_bwd_bounds(q, mask, causal)
        row = dict(shape=f"{B}x{T}x{nh}x{hd}", causal=causal,
                   key_mask=mask is not None,
                   max_abs_err_dq=errs["dq"], max_abs_err_dk=errs["dk"],
                   max_abs_err_dv=errs["dv"], dkv_ms=dkv_ms, dq_ms=dq_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bounds["backward"][0],
                   bound_by=bounds["backward"][1],
                   dkv_bound_ms=bounds["dkv"][0], dkv_bound_by=bounds["dkv"][1],
                   dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1])
        print("flash_bwd " + json.dumps(row))
        check(finite, f"non-finite flash backward at {row}")
        check(empty_zero, f"empty article's gradients not zero at {row}")
        for name, err in errs.items():
            check(err <= tols[name], f"flash {name} kernel disagrees with "
                                     f"plain (err {err} > {tols[name]}) at "
                                     f"{row}")
            worst[name] = max(worst[name], err)
        rows.append(row)
        if T <= 400:  # the training shapes: the forward's lse variant
            finite_lse = torch.isfinite(lse_p)
            lse_err = float(torch.where(finite_lse, lse - lse_p, 0.0)
                            .abs().max())
            lse_tol = ATTN_TOL * max(1.0, float(torch.where(
                finite_lse, lse_p, 0.0).abs().max()))
            ms = time_cuda(lambda: fl._flash_cuda(q, k, v, mask, causal,
                                                  scale, with_lse=True),
                           20, flush)
            plain = time_cuda(lambda: (
                fl._flash_plain(q, k, v, mask, causal, scale),
                fl._flash_lse_plain(q, k, mask, causal, scale)), 10, flush)
            _, _, nbytes, ops = flash_bound_ms(q, mask, causal)
            t_bytes = (nbytes + 4 * B * T * nh) / PEAK_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_TF32X3_OPS_PER_S * 1e3
            with torch.no_grad():
                fwd_library_ms = time_cuda(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=bool_mask, is_causal=causal,
                        scale=scale), 20, flush)
            lse_row = dict(shape=f"{B}x{T}x{nh}x{hd}", causal=causal,
                           key_mask=mask is not None, lse_max_abs_err=lse_err,
                           ms=ms, plain_ms=plain, library_ms=fwd_library_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations")
            print("flash_fwd_lse " + json.dumps(lse_row))
            check(bool((torch.isinf(lse) == ~finite_lse).all()),
                  f"lse sentinel rows differ at {lse_row}")
            check(lse_err <= lse_tol, f"lse disagrees at {lse_row}")
    return rows, worst


def flash_bf16_err(got, want):
    """(largest absolute error, the same in bf16 ulps of want's largest
    |value|) of a bf16 kernel output against its plain version."""
    err = float((got.float() - want.float()).abs().max())
    top = bf16_ulp(want.float().abs().max().reshape(1))
    return err, err / float(top[0])


#: the bf16 flash kernels the SASS gate reads: {key: (library, function)}
BF16_FLASH_KERNELS = dict(fwd=("flash_attention", "flash_fwd_bf16_kernel"),
                          dkv=("flash_attention_bwd",
                               "flash_bwd_dkv_bf16_kernel"),
                          dq=("flash_attention_bwd",
                              "flash_bwd_dq_bf16_kernel"))


def bf16_flash_sass():
    """What ts_flash_attention_bf16, ts_flash_bwd_dkv_bf16 and
    ts_flash_bwd_dq_bf16 launch, from the built libraries
    (scripts/torch_kernel_sass.py's cuobjdump counts and ptxas log): per
    kernel, over its head-dim instantiations, the HGMMA (warpgroup
    products) and UTMALDG (tensor copies) counts, their HGMMA opcodes, the
    bf16 mma.sync (HMMA.16816) count, the spill bytes and ptxas's
    warnings that it serialized the wgmma instructions (C7510-C7520: a
    wait after every product).  Fails unless each kernel has its three
    instantiations, every one with HGMMA and UTMALDG and none with
    HMMA.16816, a spill or a serialization warning."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_kernel_sass as sass

    from textsummarization_on_flink_tpu_torch.kernels import build

    out = {}
    for library in sorted({lib for lib, _ in BF16_FLASH_KERNELS.values()}):
        ptxas = sass.ptxas_functions(build.build_log(library))
        for func, ops in sass.sass_counts(build.build(library)).items():
            for key, (lib, kernel) in BF16_FLASH_KERNELS.items():
                if lib != library or kernel not in func:
                    continue
                got = sass.summary(ops)
                spills = ptxas.get(func, {})
                row = out.setdefault(key, dict(
                    instantiations=0, hgmma=0, utmaldg=0, hmma_bf16=0,
                    spill_bytes=0, serialized=0, hgmma_opcodes=[]))
                warned = spills.get("wgmma_serialized", 0)
                row["instantiations"] += 1
                row["serialized"] += warned
                for name in ("hgmma", "utmaldg", "hmma_bf16"):
                    row[name] += got[name]
                row["spill_bytes"] += spills.get("spill_stores", 0) \
                    + spills.get("spill_loads", 0)
                row["hgmma_opcodes"] = sorted(set(row["hgmma_opcodes"])
                                              | set(got["hgmma_opcodes"]))
                check(got["hgmma"] > 0 and got["utmaldg"] > 0
                      and got["hmma_bf16"] == 0 and "spill_stores" in spills
                      and spills["spill_stores"] + spills["spill_loads"] == 0
                      and warned == 0,
                      f"bf16 {key} kernel {func}: SASS {got}, ptxas {spills}, "
                      f"{warned} serialization warnings (want HGMMA and "
                      f"UTMALDG, no HMMA.16816, no spill, no serialization)")
    check(all(out.get(k, {}).get("instantiations") == 3
              for k in BF16_FLASH_KERNELS),
          f"bf16 flash kernels not found in the SASS: {out}")
    print("flash_bf16_sass " + json.dumps(out))
    return out


def phase_flash_bf16(seed):
    """The flash kernels' bf16 forms (the transformer under
    --compute_dtype=bfloat16) against their plain bf16 versions at the
    transformer's shapes: the encoder's (16 x 400 x 8 x 32, key mask,
    article 1 empty), the training decoder's (16 x 100 x 8 x 32, causal),
    the long-context shape (4 x 2048 x 8 x 128, key mask and causal) and
    head dim 256 (16 x 400 x 2 x 256, key mask).  out, dq, dk and dv
    within FLASH_BF16_ULPS bf16 ulps of the tensor's largest |value|,
    lse (f32) within ATTN_TOL * max(1, |lse|); an empty article's
    outputs zeros.  Times: the forward (the serving form, no lse), the
    dK/dV and dQ kernels, the plain forward and whole backward, and
    scaled_dot_product_attention's forward and backward in bf16 (the
    library column, for time only); bounds at PEAK_BF16_OPS_PER_S with
    2-byte q, k, v, out, dO and gradients.  Returns ({shape: row},
    {kernel: (largest error, in ulps)})."""
    import torch
    import torch.nn.functional as F

    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # 96 MB > 50 MB L2
    cases = [(16, 400, 8, 32, False), (16, 100, 8, 32, True),
             (4, 2048, 8, 128, False), (4, 2048, 8, 128, True),
             (16, 400, 2, 256, False)]
    rows = {}
    worst = dict(forward=(0.0, 0.0), dkv=(0.0, 0.0), dq=(0.0, 0.0))
    bf16 = torch.bfloat16
    for (B, T, nh, hd, causal) in cases:
        q, k, v, mask = flash_inputs(B, T, nh, hd, seed, not causal)
        q, k, v = (x.to(bf16) for x in (q, k, v))
        scale = hd ** -0.5
        out, lse = fl._flash_cuda(q, k, v, mask, causal, scale,
                                  with_lse=True)
        serve_out = fl._flash_cuda(q, k, v, mask, causal, scale)
        do = torch.randn(q.shape, device="cuda").to(bf16)
        dq, dk, dv = fl._flash_bwd_cuda(q, k, v, out, lse, do, mask, causal,
                                        scale)
        ref = fl._flash_plain(q, k, v, mask, causal, scale)
        lse_p = fl._flash_lse_plain(q, k, mask, causal, scale)
        want = fl._flash_bwd_plain(q, k, v, out, lse_p, do, mask, causal,
                                   scale)
        torch.cuda.synchronize()
        errs = {name: flash_bf16_err(g, w) for name, g, w in (
            ("out", out, ref), ("serve_out", serve_out, ref),
            ("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2]))}
        finite_lse = torch.isfinite(lse_p)
        lse_err = float(torch.where(finite_lse, lse - lse_p, 0.0)
                        .abs().max())
        lse_tol = ATTN_TOL * max(1.0, float(torch.where(
            finite_lse, lse_p, 0.0).abs().max()))
        outs = (out, serve_out, dq, dk, dv)
        finite = all(bool(torch.isfinite(x.float()).all()) for x in outs)
        right_dtype = all(x.dtype == bf16 for x in outs)
        empty_zero = mask is None or all(float(x[1].float().abs().max())
                                         == 0.0 for x in outs)
        dsum = torch.sum(do.float() * out.float(), dim=-1)
        ms = time_cuda(lambda: fl._flash_cuda(q, k, v, mask, causal, scale),
                       20, flush)
        plain_ms = time_cuda(lambda: fl._flash_plain(q, k, v, mask, causal,
                                                     scale), 10, flush)
        dkv_ms = time_cuda(lambda: fl._bwd_dkv_cuda(
            q, k, v, do, lse, dsum, mask, causal, scale), 20, flush)
        dq_ms = time_cuda(lambda: fl._bwd_dq_cuda(
            q, k, v, do, lse, dsum, mask, causal, scale), 20, flush)
        bwd_plain_ms = time_cuda(lambda: fl._flash_bwd_plain(
            q, k, v, out, lse_p, do, mask, causal, scale), 10, flush)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B,nh,T,hd]
        bool_mask = None if mask is None else (mask > 0)[:, None, None, :]
        with torch.no_grad():
            library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bool_mask, is_causal=causal,
                scale=scale), 20, flush)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=bool_mask, is_causal=causal, scale=scale)
        do_t = do.transpose(1, 2)
        bwd_library_ms = time_cuda(lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), do_t, retain_graph=True), 20, flush)
        bound, by, nbytes, ops = flash_bound_ms(q, mask, causal)
        bounds = flash_bwd_bounds(q, mask, causal)
        row = dict(shape=f"{B}x{T}x{nh}x{hd}", causal=causal,
                   key_mask=mask is not None,
                   max_abs_err={k: e for k, (e, _) in errs.items()},
                   bf16_ulps={k: u for k, (_, u) in errs.items()},
                   lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound, bound_by=by,
                   bytes=nbytes, ops=ops, dkv_ms=dkv_ms, dq_ms=dq_ms,
                   bwd_plain_ms=bwd_plain_ms, bwd_library_ms=bwd_library_ms,
                   dkv_bound_ms=bounds["dkv"][0],
                   dkv_bound_by=bounds["dkv"][1],
                   dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1],
                   bwd_bound_ms=bounds["backward"][0],
                   bwd_bound_by=bounds["backward"][1])
        print("flash_bf16 " + json.dumps(row))
        check(finite, f"non-finite bf16 flash output at {row}")
        check(right_dtype, f"bf16 flash outputs not in bf16 at {row}")
        check(empty_zero, f"empty article's bf16 outputs not zero at {row}")
        check(bool((torch.isinf(lse) == ~finite_lse).all()),
              f"bf16 lse sentinel rows differ at {row}")
        check(lse_err <= lse_tol, f"bf16 lse disagrees at {row}")
        for name, (err, ulps) in errs.items():
            check(ulps <= FLASH_BF16_ULPS,
                  f"bf16 flash {name} {ulps} ulps from plain (> "
                  f"{FLASH_BF16_ULPS}) at {row}")
        for kernel, names in (("forward", ("out", "serve_out")),
                              ("dkv", ("dk", "dv")), ("dq", ("dq",))):
            worst[kernel] = tuple(max(worst[kernel][i],
                                      *(errs[n][i] for n in names))
                                  for i in (0, 1))
        rows[row["shape"] + ("c" if causal else "")] = row
    return rows, worst


#: the wide kernels' shapes (head dims above 256, kernels/
#: flash_attention_wide.cu): the encoder of the transformer at
#: --hidden_dim=hd --num_heads=1 (16 x 400, key mask, article 1 empty) at
#: head dims 384, 512 and 1024, and the training decoder's causal
#: self-attention at head dim 512 (16 x 100); then the clusters of 9, 12
#: and 16 blocks, the encoder's and the decoder's shapes at head dims
#: 1152, 1536 and 2048: (B, T, nh, hd, causal)
#: the largest head dim at which each wide kernel takes its cluster form,
#: as this script expects the library's dispatch to choose: every kind up
#: to 8192 (a cluster of hd / 128 blocks up to 2048, above it at most 16
#: blocks owning up to 4 slabs each; the SIMT forms above)
CLUSTER_UP_TO = dict(fwd=8192, dkv=8192, dq=8192)


def expected_geometry(kind, hd):
    """(slabs a block owns, blocks of the cluster) of the cluster form
    this script expects the wide kernel ``kind`` to take at a padded head
    dim ``hd`` (CLUSTER_UP_TO; ceil(C / 16) slabs above 2048, C = hd /
    128), (0, 0) for the SIMT form; a call launches its kernel once per
    slab (max(slabs, 1) launches)"""
    if hd > CLUSTER_UP_TO[kind]:
        return 0, 0
    slabs = -(-hd // 128 // 16)
    return slabs, -(-hd // 128 // slabs)
#: and the multi-slab forms at 2304 (9 blocks of 2 slabs) and 4096 (16 of
#: 2), the encoder's shape, and 2304 causal, the decoder's
WIDE_FLASH_CASES = [(16, 400, 1, 384, False), (16, 400, 1, 512, False),
                    (16, 400, 1, 1024, False), (16, 100, 1, 512, True),
                    (16, 400, 1, 1152, False), (16, 400, 1, 1536, False),
                    (16, 400, 1, 2048, False), (16, 100, 1, 1152, True),
                    (16, 100, 1, 1536, True), (16, 100, 1, 2048, True),
                    (16, 400, 1, 2304, False), (16, 400, 1, 4096, False),
                    (16, 100, 1, 2304, True)]
#: the multi-slab forms' gate: at least WIDE16_MIN_GAIN times faster than
#: the SIMT forward, dK/dV and dQ at these shapes (B, T, nh, hd), both
#: dtypes
WIDE_SLAB_GATED = ((16, 400, 1, 2304), (16, 400, 1, 4096))


def sdpa_backend(q, k, v, mask, causal, scale):
    """The backend scaled_dot_product_attention picks for these inputs
    ([B, nh, T, hd] q, k, v and a boolean mask): its flash backend takes
    head dims up to 256 only, so above that it falls to another
    (PyTorch's own choice, torch._fused_sdp_choice)."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, mask, 0.0, causal, scale=scale)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


def phase_flash_wide(seed):
    """The wide kernels (head dims above 256; kernels/
    flash_attention_wide.cu: the forward, dK/dV and dQ up to head dim
    2048, a cluster of hd / 128 blocks on the tensor cores,
    3xTF32 mma.sync in f32 and wgmma in bf16; above 2048 clusters of
    blocks owning several slabs) against their plain
    versions at WIDE_FLASH_CASES, in f32 and bf16: out (the serving
    form), lse (the training form), dq, dk and dv; f32 within ATTN_TOL *
    max(1,
    |value|) of the plain version, bf16 within FLASH_BF16_ULPS bf16 ulps
    of the tensor's largest |value|, lse within ATTN_TOL * max(1, |lse|)
    with +inf on the same rows; the empty article's outputs zeros; a
    rerun the same bits.  The SIMT forward, dK/dV and dQ the cluster
    forms replaced (the first design, still built for head dims above
    8192: ``simt=True``) are held to the same plain versions and timed
    in this call beside them: the cluster forms at least WIDE_MIN_GAIN
    times faster at 16 x 400 x 1 x 512 in both dtypes, the forward's,
    dK/dV's and dQ's 9-block clusters at least WIDE16_MIN_GAIN times at
    16 x 400 x 1 x 1152, the multi-slab forward, dK/dV and dQ at
    WIDE_SLAB_GATED.  Times: the forward
    (serving form), the dK/dV and dQ kernels, the SIMT forward, dK/dV and
    dQ,
    the plain forward and whole backward, and
    scaled_dot_product_attention's forward and backward (the library
    column, for time only) with the backend it took.  Bounds as the other
    flash rows' (flash_bound_ms, flash_bwd_bounds).  Returns ({(dtype,
    shape): row}, {kernel key: largest error})."""
    import torch
    import torch.nn.functional as F

    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # 96 MB > 50 MB L2
    lib = fl._load_wide_library()
    # the clusters of each form resident at once on this card, per head
    # dim (the check each cluster launch makes at first use, at the
    # instance and cluster size a launch at that head dim takes)
    active = {f"{kind}_{tag} {hd}": lib.ts_flash_wide_active_clusters_at(
                  i, tag == "bf16", hd)
              for i, kind in enumerate(fl.WIDE_KINDS)
              for tag in ("f32", "bf16")
              for hd in sorted({c[3] for c in WIDE_FLASH_CASES})
              if hd <= CLUSTER_UP_TO[kind]}
    print("flash_wide_active_clusters " + json.dumps(active))
    check(all(n >= 1 for n in active.values()),
          f"a wide cluster form fits no cluster on this card: {active}")
    # the library's dispatch rule (ts_flash_wide_form, which the cluster
    # counters read) and geometry (slabs a block, blocks a cluster) at
    # every wide head dim up to 8448 (the SIMT forms above 8192)
    hds = range(384, 8449, fl.WIDE_STEP)
    rule = {f"{kind} {hd}": (lib.ts_flash_wide_form(i, hd, None, None),
                             fl._wide_geometry(kind, hd))
            for i, kind in enumerate(fl.WIDE_KINDS) for hd in hds}
    want = {f"{kind} {hd}": (int(hd <= CLUSTER_UP_TO[kind]),
                             expected_geometry(kind, hd))
            for kind in fl.WIDE_KINDS for hd in hds}
    check(rule == want,
          f"the library's wide forms differ from CLUSTER_UP_TO: "
          f"{ {k: v for k, v in rule.items() if want[k] != v} }")
    rows, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tag = "bf16" if bf16 else "f32"
        for (B, T, nh, hd, causal) in WIDE_FLASH_CASES:
            q, k, v, mask = flash_inputs(B, T, nh, hd, seed, not causal)
            q, k, v = (x.to(dtype) for x in (q, k, v))
            scale = hd ** -0.5
            out, lse = fl._flash_cuda(q, k, v, mask, causal, scale,
                                      with_lse=True)
            serve_out = fl._flash_cuda(q, k, v, mask, causal, scale)
            g = torch.Generator(device="cuda").manual_seed(seed + hd)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            grads = fl._flash_bwd_cuda(q, k, v, out, lse, do, mask, causal,
                                       scale)
            again = (fl._flash_cuda(q, k, v, mask, causal, scale),
                     *fl._flash_bwd_cuda(q, k, v, out, lse, do, mask,
                                         causal, scale))
            dsum = torch.sum(do.float() * out.float(), dim=-1)
            simt_out = fl._flash_cuda(q, k, v, mask, causal, scale,
                                      simt=True)
            simt_dk, simt_dv = fl._bwd_dkv_cuda(q, k, v, do, lse, dsum, mask,
                                                causal, scale, simt=True)
            simt_dq = fl._bwd_dq_cuda(q, k, v, do, lse, dsum, mask, causal,
                                      scale, simt=True)
            ref = fl._flash_plain(q, k, v, mask, causal, scale)
            lse_p = fl._flash_lse_plain(q, k, mask, causal, scale)
            want = fl._flash_bwd_plain(q, k, v, out, lse_p, do, mask, causal,
                                       scale)
            torch.cuda.synchronize()
            outs = dict(out=(out, ref), serve_out=(serve_out, ref),
                        dq=(grads[0], want[0]), dk=(grads[1], want[1]),
                        dv=(grads[2], want[2]), simt_out=(simt_out, ref),
                        simt_dk=(simt_dk, want[1]), simt_dv=(simt_dv, want[2]),
                        simt_dq=(simt_dq, want[0]))
            errs, ulps, ok = {}, {}, True
            for name, (g, w) in outs.items():
                if bf16:
                    errs[name], ulps[name] = flash_bf16_err(g, w)
                    ok &= ulps[name] <= FLASH_BF16_ULPS
                else:
                    errs[name] = float((g - w).abs().max())
                    ok &= errs[name] <= ATTN_TOL * max(
                        1.0, float(w.abs().max()))
            finite_lse = torch.isfinite(lse_p)
            lse_err = float(torch.where(finite_lse, lse - lse_p, 0.0)
                            .abs().max())
            lse_tol = ATTN_TOL * max(1.0, float(torch.where(
                finite_lse, lse_p, 0.0).abs().max()))
            got = (serve_out, *grads)
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            finite = all(bool(torch.isfinite(x.float()).all()) for x in got)
            empty_zero = mask is None or all(
                float(x[1].float().abs().max()) == 0.0 for x in got)
            before = launch_counts()
            ms = time_cuda(lambda: fl._flash_cuda(q, k, v, mask, causal,
                                                  scale), 10, flush)
            plain_ms = time_cuda(lambda: fl._flash_plain(
                q, k, v, mask, causal, scale), 5, flush)
            dkv_ms = time_cuda(lambda: fl._bwd_dkv_cuda(
                q, k, v, do, lse, dsum, mask, causal, scale), 10, flush)
            dq_ms = time_cuda(lambda: fl._bwd_dq_cuda(
                q, k, v, do, lse, dsum, mask, causal, scale), 10, flush)
            simt_ms = time_cuda(lambda: fl._flash_cuda(
                q, k, v, mask, causal, scale, simt=True), 5, flush)
            simt_dkv_ms = time_cuda(lambda: fl._bwd_dkv_cuda(
                q, k, v, do, lse, dsum, mask, causal, scale, simt=True), 5,
                flush)
            dq_simt_ms = time_cuda(lambda: fl._bwd_dq_cuda(
                q, k, v, do, lse, dsum, mask, causal, scale, simt=True), 5,
                flush)
            after = launch_counts()
            # the form each timed launch took (the cluster counters count
            # the launches the library's dispatch sent to a cluster form)
            # against the forms this script expects: CLUSTER_UP_TO
            forms = {kind: ("cluster" if after[f"{c}_wide_cluster"]
                            > before[f"{c}_wide_cluster"] else "simt")
                     for kind, c in (("fwd", "flash_forward"),
                                     ("dkv", "flash_bwd_dkv"),
                                     ("dq", "flash_bwd_dq"))}
            check(forms == {kind: "cluster" if hd <= CLUSTER_UP_TO[kind]
                            else "simt" for kind in fl.WIDE_KINDS},
                  f"wide launch forms {forms} at head dim {hd}")
            bwd_plain_ms = time_cuda(lambda: fl._flash_bwd_plain(
                q, k, v, out, lse_p, do, mask, causal, scale), 5, flush)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            bool_mask = None if mask is None else (mask > 0)[:, None, None, :]
            backend = sdpa_backend(qt, kt, vt, bool_mask, causal, scale)
            with torch.no_grad():
                library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bool_mask, is_causal=causal,
                    scale=scale), 10, flush)
            qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
            lib_out = F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=bool_mask, is_causal=causal,
                scale=scale)
            bwd_library_ms = time_cuda(lambda: torch.autograd.grad(
                lib_out, (qg, kg, vg), do.transpose(1, 2),
                retain_graph=True), 10, flush)
            bound, by, nbytes, ops = flash_bound_ms(q, mask, causal)
            bounds = flash_bwd_bounds(q, mask, causal)
            row = dict(dtype=tag, shape=f"{B}x{T}x{nh}x{hd}", causal=causal,
                       key_mask=mask is not None, forms=forms,
                       geometry=fl._wide_geometry("fwd", hd),
                       max_abs_err=errs,
                       bf16_ulps=ulps or None, lse_max_abs_err=lse_err,
                       repeat_bits_equal=repeat, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, library_backend=backend,
                       bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops,
                       dkv_ms=dkv_ms, dq_ms=dq_ms, bwd_plain_ms=bwd_plain_ms,
                       bwd_library_ms=bwd_library_ms,
                       simt_ms=simt_ms, simt_dkv_ms=simt_dkv_ms,
                       dq_simt_ms=dq_simt_ms,
                       gain=simt_ms / ms, dkv_gain=simt_dkv_ms / dkv_ms,
                       dq_gain=dq_simt_ms / dq_ms,
                       dkv_bound_ms=bounds["dkv"][0],
                       dkv_bound_by=bounds["dkv"][1],
                       dq_bound_ms=bounds["dq"][0],
                       dq_bound_by=bounds["dq"][1])
            print("flash_wide " + json.dumps(row))
            check(finite, f"non-finite wide flash output at {row}")
            check(empty_zero, f"empty article's wide outputs not zero at "
                              f"{row}")
            check(bool((torch.isinf(lse) == ~finite_lse).all()),
                  f"wide lse sentinel rows differ at {row}")
            check(lse_err <= lse_tol, f"wide lse disagrees at {row}")
            check(ok, f"a wide flash kernel disagrees with its plain "
                      f"version at {row}")
            check(repeat, f"a wide flash kernel's rerun changed bits at "
                          f"{row}")
            if (B, T, nh, hd) == (16, 400, 1, 512):
                check(row["gain"] >= WIDE_MIN_GAIN
                      and row["dkv_gain"] >= WIDE_MIN_GAIN
                      and row["dq_gain"] >= WIDE_MIN_GAIN,
                      f"the cluster forms less than {WIDE_MIN_GAIN} times "
                      f"faster than the SIMT ones at {row}")
            if (B, T, nh, hd) == (16, 400, 1, 1152):
                check(row["gain"] >= WIDE16_MIN_GAIN
                      and row["dkv_gain"] >= WIDE16_MIN_GAIN
                      and row["dq_gain"] >= WIDE16_MIN_GAIN,
                      f"a 9-block cluster form less than {WIDE16_MIN_GAIN} "
                      f"times faster than the SIMT one at {row}")
            if (B, T, nh, hd) in WIDE_SLAB_GATED:
                check(row["gain"] >= WIDE16_MIN_GAIN
                      and row["dkv_gain"] >= WIDE16_MIN_GAIN
                      and row["dq_gain"] >= WIDE16_MIN_GAIN,
                      f"a multi-slab cluster form less than "
                      f"{WIDE16_MIN_GAIN} times faster than the SIMT one at "
                      f"{row}")
            for kernel, names in (("forward", ("out", "serve_out")),
                                  ("dkv", ("dk", "dv")), ("dq", ("dq",))):
                # past hd 1024: the 16-block forms'; past 2048 the
                # multi-slab forms'
                key = (tag, kernel) + (
                    ("past2048",) if hd > 2048 else
                    ("past1024",) if hd > 1024 else ())
                worst[key] = max(worst.get(key, 0.0),
                                 *(errs[n] for n in names))
            rows[(tag, row["shape"])] = row
    return rows, worst


def _row_hd(row):
    """The head dim of a flash_wide row's shape (B x T x nh x hd)."""
    return int(row["shape"].split("x")[-1])


#: the cluster forms' least gain over the SIMT forms they replaced at 16 x
#: 400 x 1 x 512, forward, dK/dV and dQ, both dtypes
WIDE_MIN_GAIN = 3.0
#: the cluster forms' least gain past 8 blocks, at 16 x 400 x 1 x 1152
#: and its query block (16 x 200/400): forward, dK/dV and dQ, both dtypes
WIDE16_MIN_GAIN = 4.0

#: the wide kernels' functions in the SASS and ptxas log: {key: function};
#: the cluster forms (f32 and bf16 kernels of their own) and the SIMT
#: forms (one template, both dtypes)
WIDE_FLASH_KERNELS = dict(
    fwd_f32="flash_fwd_cluster_f32_kernel",
    fwd_bf16="flash_fwd_cluster_bf16_kernel",
    dkv_f32="flash_bwd_dkv_cluster_f32_kernel",
    dkv_bf16="flash_bwd_dkv_cluster_bf16_kernel",
    dq_f32="flash_bwd_dq_cluster_f32_kernel",
    dq_bf16="flash_bwd_dq_cluster_bf16_kernel",
    fwd_simt="flash_fwd_wide_kernel", dkv_simt="flash_bwd_dkv_wide_kernel",
    dq_simt="flash_bwd_dq_wide_kernel",
    fwd_slabs_f32="flash_fwd_slabs_f32_kernel",
    fwd_slabs_bf16="flash_fwd_slabs_bf16_kernel",
    dkv_slabs_f32="flash_bwd_dkv_slabs_f32_kernel",
    dkv_slabs_bf16="flash_bwd_dkv_slabs_bf16_kernel",
    dq_slabs_f32="flash_bwd_dq_slabs_f32_kernel",
    dq_slabs_bf16="flash_bwd_dq_slabs_bf16_kernel")


#: the wide kernels' instantiations wide_flash_sass names: the cluster
#: forms (the one-sum instances, up to 8 blocks, the f32 forward's to 14
#: and the f32 dQ's to 9, and their split instances past them, "_split";
#: the f32 dK/dV's one kernel; the bf16 dQ, split at every size, its
#: instance up to 8 blocks and past them, "_c16") and the SIMT forms' f32
#: and bf16 instances
WIDE_FLASH_INSTANCES = {
    "fwd_f32", "fwd_bf16", "dkv_f32", "dkv_bf16", "dq_f32", "dq_bf16",
    "fwd_f32_split", "fwd_bf16_split", "dkv_bf16_split", "dq_f32_split",
    "dq_bf16_c16",
    "fwd_simt_f32", "fwd_simt_bf16", "dkv_simt_f32", "dkv_simt_bf16",
    "dq_simt_f32", "dq_simt_bf16"} | {
    # the multi-slab forms, per slabs a block ("_s2" .. "_s4"); the f32
    # forward's split exchange from kF32SplitFrom blocks and the f32 dQ's
    # from kF32DqSplitFrom ("_split": every cluster of 3 and 4 slabs a
    # block has 11 blocks or more, so the dQ's one-sum instance is built
    # at 2 slabs only)
    f"{k}_s{n}{x}" for n in (2, 3, 4) for k, x in (
        ("fwd_slabs_f32", ""), ("fwd_slabs_f32", "_split"),
        ("fwd_slabs_bf16", ""), ("dkv_slabs_f32", ""),
        ("dkv_slabs_bf16", ""), ("dq_slabs_f32", "_split"),
        ("dq_slabs_bf16", ""))} | {"dq_slabs_f32_s2"}
#: the multi-slab instances per (kernel, dtype)
WIDE_SLAB_INSTANCES = {
    (key, tag): tuple(sorted(n for n in WIDE_FLASH_INSTANCES
                             if n.startswith(f"{k}_slabs_{tag}_")))
    for key, k in (("forward", "fwd"), ("dkv", "dkv"), ("dq", "dq"))
    for tag in ("f32", "bf16")}
#: the instances the forms past 8 blocks run, per (kernel, dtype): the f32
#: forward one-sum to 14 blocks and split past them, the f32 dK/dV one-sum
#: (its split instance spilled), the f32 dQ one-sum at 9 blocks and split
#: past them, the bf16 forms split
WIDE16_INSTANCES = {
    ("forward", "f32"): ("fwd_f32", "fwd_f32_split"),
    ("dkv", "f32"): ("dkv_f32",),
    ("dq", "f32"): ("dq_f32", "dq_f32_split"),
    ("forward", "bf16"): ("fwd_bf16_split",),
    ("dkv", "bf16"): ("dkv_bf16_split",),
    ("dq", "bf16"): ("dq_bf16_c16",)}


def wide_flash_sass():
    """The wide kernels' SASS and ptxas report (flash_attention_wide's
    library and build log, scripts/torch_kernel_sass.py): per kernel
    instantiation its registers, spill bytes, 3xTF32 tensor-core products
    (HMMA.1688.F32.TF32), warpgroup products (HGMMA), tensor copies
    (UTMALDG) and ptxas's wgmma serialization warnings.  Fails unless
    every one of WIDE_FLASH_INSTANCES is there with 0 bytes of spill, the
    f32 cluster forms with HMMA.1688.F32.TF32, the bf16 ones with HGMMA
    and UTMALDG and no serialization."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_kernel_sass as sass

    from textsummarization_on_flink_tpu_torch.kernels import build

    lib = build.build("flash_attention_wide")
    ptxas = sass.ptxas_functions(build.build_log("flash_attention_wide"))
    counts = sass.sass_counts(lib)
    out = {}
    for func, info in ptxas.items():
        for key, kernel in WIDE_FLASH_KERNELS.items():
            if kernel not in func:
                continue
            cluster = "cluster" in kernel or "slabs" in kernel
            # a templated cluster form's instance past 8 blocks: the split
            # exchange (kSplit true) or the bf16 dQ's (kMaxC 16); a
            # multi-slab form's, its slabs a block (its first argument)
            slabs = re.search(r"slabs_\w+_kernelILi(\d)E", func)
            name = (key + (f"_s{slabs.group(1)}" if slabs else "")
                    + ("_split" if "Lb1E" in func else
                       "_c16" if "ILi16E" in func else "")
                    if cluster else
                    key + ("_bf16" if "bfloat16" in func else "_f32"))
            spill = info.get("spill_stores", -1) + info.get("spill_loads", -1)
            got = sass.summary(counts.get(func, {}))
            out[name] = dict(registers=info.get("registers"),
                             spill_bytes=spill, hmma_tf32=got["hmma_tf32"],
                             hgmma=got["hgmma"], utmaldg=got["utmaldg"],
                             serialized=info.get("wgmma_serialized", 0))
            check(spill == 0, f"wide kernel {func}: ptxas {info} (want 0 "
                              f"bytes of spill)")
            if cluster and "_f32" in name:
                check(got["hmma_tf32"] > 0,
                      f"wide kernel {func}: no 3xTF32 HMMA in {got}")
            if cluster and "_bf16" in name:
                check(got["hgmma"] > 0 and got["utmaldg"] > 0
                      and out[name]["serialized"] == 0,
                      f"wide kernel {func}: SASS {got}, ptxas {info} (want "
                      f"HGMMA and UTMALDG, no serialization)")
    check(set(out) == WIDE_FLASH_INSTANCES,
          f"wide flash kernels in the build log {sorted(out)}, expected "
          f"{sorted(WIDE_FLASH_INSTANCES)}")
    print("flash_wide_sass " + json.dumps(out))
    return out


#: one sp rank's block of the encoder's queries against every key (sp =
#: 2, half the rows): the transformer's reference encoder (16 x 400, 8
#: heads of 32), the long-context shape (4 x 2048 x 8 x 128), head dim
#: 256, the wide cluster forms at head dim 512 and at 1152 the 9-block
#: clusters and at 2304 the multi-slab clusters (timed beside their SIMT
#: forms): (B, Tq, Tk, nh, hd)
QUERY_BLOCK_CASES = [(16, 200, 400, 8, 32), (4, 1024, 2048, 8, 128),
                     (16, 200, 400, 2, 256), (16, 200, 400, 1, 512),
                     (16, 200, 400, 1, 1152), (16, 200, 400, 1, 2304)]


def phase_flash_query_block(seed):
    """Every flash kernel on a block of query rows against all the keys
    (Tq = Tk / 2, rows [Tq, 2 Tq) of the article; the form the
    transformer's and the AAN's encoder run on an sp mesh without
    --sp_attention) at QUERY_BLOCK_CASES in f32 and bf16, with a ragged
    key mask and article 1 empty: the forward (serving and training
    forms), dK/dV and dQ against their plain versions (f32 within
    ATTN_TOL * max(1, |value|), bf16 within FLASH_BF16_ULPS), lse +inf on
    the same rows, the empty article zeros, each launch counted by the
    block counters; times beside scaled_dot_product_attention's forward
    and backward on the same block and bounds from this run's mask
    (flash_bound_ms, flash_bwd_bounds with Tk); past head dim 1024 the
    SIMT forward, dK/dV and dQ timed too, the cluster forms at least
    WIDE16_MIN_GAIN times faster.  Returns ({(dtype, shape): row},
    {(dtype, kernel): largest error})."""
    import torch
    import torch.nn.functional as F

    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # 96 MB > 50 MB L2
    rows, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tag = "bf16" if bf16 else "f32"
        for (B, Tq, Tk, nh, hd) in QUERY_BLOCK_CASES:
            q, k, v, mask = flash_inputs(B, Tk, nh, hd, seed, True)
            q, k, v = (x.to(dtype) for x in (q, k, v))
            q = q[:, Tq:2 * Tq].contiguous()
            scale = hd ** -0.5
            g = torch.Generator(device="cuda").manual_seed(seed + hd)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            before = launch_counts()
            serve = fl._flash_cuda(q, k, v, mask, False, scale)
            out, lse = fl._flash_cuda(q, k, v, mask, False, scale,
                                      with_lse=True)
            grads = fl._flash_bwd_cuda(q, k, v, out, lse, do, mask, False,
                                       scale)
            torch.cuda.synchronize()
            after = launch_counts()
            step = {c: after[c] - before[c] for c in (
                "flash_forward_block", "flash_bwd_dkv_block",
                "flash_bwd_dq_block")}
            # a multi-slab call launches its kernel once per slab
            n = {kind: max(expected_geometry(kind, hd)[0], 1) if hd > 256
                 else 1 for kind in ("fwd", "dkv", "dq")}
            check(step == dict(flash_forward_block=2 * n["fwd"],
                               flash_bwd_dkv_block=n["dkv"],
                               flash_bwd_dq_block=n["dq"]),
                  f"query block launches {step}")
            ref = fl._flash_plain(q, k, v, mask, False, scale)
            lse_p = fl._flash_lse_plain(q, k, mask, False, scale)
            want = fl._flash_bwd_plain(q, k, v, out, lse_p, do, mask, False,
                                       scale)
            outs = dict(out=(out, ref), serve_out=(serve, ref),
                        dq=(grads[0], want[0]), dk=(grads[1], want[1]),
                        dv=(grads[2], want[2]))
            errs, ulps, ok = {}, {}, True
            for name, (got, w) in outs.items():
                if bf16:
                    errs[name], ulps[name] = flash_bf16_err(got, w)
                    ok &= ulps[name] <= FLASH_BF16_ULPS
                else:
                    errs[name] = float((got - w).abs().max())
                    ok &= errs[name] <= ATTN_TOL * max(
                        1.0, float(w.abs().max()))
            finite_lse = torch.isfinite(lse_p)
            lse_err = float(torch.where(finite_lse, lse - lse_p, 0.0)
                            .abs().max())
            empty_zero = all(float(x[1].float().abs().max()) == 0.0
                             for x in (serve, *grads))
            dsum = torch.sum(do.float() * out.float(), dim=-1)
            ms = time_cuda(lambda: fl._flash_cuda(q, k, v, mask, False,
                                                  scale), 10, flush)
            dkv_ms = time_cuda(lambda: fl._bwd_dkv_cuda(
                q, k, v, do, lse, dsum, mask, False, scale), 10, flush)
            dq_ms = time_cuda(lambda: fl._bwd_dq_cuda(
                q, k, v, do, lse, dsum, mask, False, scale), 10, flush)
            plain_ms = time_cuda(lambda: fl._flash_plain(
                q, k, v, mask, False, scale), 5, flush)
            bwd_plain_ms = time_cuda(lambda: fl._flash_bwd_plain(
                q, k, v, out, lse_p, do, mask, False, scale), 5, flush)
            simt = {}
            if hd > 1024:  # the 16-block clusters beside the SIMT forms
                simt = dict(
                    simt_ms=time_cuda(lambda: fl._flash_cuda(
                        q, k, v, mask, False, scale, simt=True), 5, flush),
                    simt_dkv_ms=time_cuda(lambda: fl._bwd_dkv_cuda(
                        q, k, v, do, lse, dsum, mask, False, scale,
                        simt=True), 5, flush),
                    dq_simt_ms=time_cuda(lambda: fl._bwd_dq_cuda(
                        q, k, v, do, lse, dsum, mask, False, scale,
                        simt=True), 5, flush))
                simt.update(gain=simt["simt_ms"] / ms,
                            dkv_gain=simt["simt_dkv_ms"] / dkv_ms,
                            dq_gain=simt["dq_simt_ms"] / dq_ms)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            bool_mask = (mask > 0)[:, None, None, :]
            with torch.no_grad():
                library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bool_mask, scale=scale), 5, flush)
            qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
            lib_out = F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=bool_mask, scale=scale)
            bwd_library_ms = time_cuda(lambda: torch.autograd.grad(
                lib_out, (qg, kg, vg), do.transpose(1, 2),
                retain_graph=True), 5, flush)
            bound, by, nbytes, ops = flash_bound_ms(q, mask, False, Tk)
            bounds = flash_bwd_bounds(q, mask, False, Tk)
            row = dict(dtype=tag, shape=f"{B}x{Tq}/{Tk}x{nh}x{hd}",
                       max_abs_err=errs, bf16_ulps=ulps or None,
                       lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound, bound_by=by,
                       bytes=nbytes, ops=ops, dkv_ms=dkv_ms, dq_ms=dq_ms,
                       bwd_plain_ms=bwd_plain_ms,
                       bwd_library_ms=bwd_library_ms,
                       dkv_bound_ms=bounds["dkv"][0],
                       dkv_bound_by=bounds["dkv"][1],
                       dq_bound_ms=bounds["dq"][0],
                       dq_bound_by=bounds["dq"][1], **simt)
            print("flash_query_block " + json.dumps(row))
            check(not simt or min(
                simt["gain"], simt["dkv_gain"], simt["dq_gain"])
                >= WIDE16_MIN_GAIN,
                  f"query block: a 16-block cluster form less than "
                  f"{WIDE16_MIN_GAIN} times faster than the SIMT one at "
                  f"{row}")
            check(empty_zero, f"query block: the empty article's outputs not "
                              f"zero at {row}")
            check(bool((torch.isinf(lse) == ~finite_lse).all()),
                  f"query block lse sentinel rows differ at {row}")
            check(lse_err <= ATTN_TOL * max(1.0, float(torch.where(
                finite_lse, lse_p, 0.0).abs().max())),
                  f"query block lse disagrees at {row}")
            check(ok, f"a flash kernel disagrees with its plain version on "
                      f"a query block at {row}")
            for kernel, names in (("forward", ("out", "serve_out")),
                                  ("dkv", ("dk", "dv")), ("dq", ("dq",))):
                key = (tag, kernel)
                worst[key] = max(worst.get(key, 0.0),
                                 *(errs[n] for n in names))
            rows[(tag, row["shape"])] = row
    return rows, worst


def phase_flash_digests():
    """Every flash launch form the parent took (as many query rows as
    keys) gives the parent's output bits: flash_digests at
    FLASH_DIGEST_CASES equal to FLASH_PARENT_DIGESTS (the f32 and bf16
    kernels, the wide SIMT forms at head dims 512 and 1152, the SIMT dQ
    at 2176 and 4224); and the
    clusters past 8 blocks give the bits recorded when they were added
    (FLASH_C16_DIGESTS at FLASH_C16_DIGEST_CASES), and so do the
    multi-slab forms above head dim 2048 (FLASH_SLAB_DIGESTS at
    FLASH_SLAB_DIGEST_CASES).
    Returns the number of parent digests compared."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl

    digests = flash_digests(fl)
    c16 = flash_digests(fl, FLASH_C16_DIGEST_CASES, simt=False)
    slabs = flash_digests(fl, FLASH_SLAB_DIGEST_CASES, simt=False)
    slab_differ = sorted(k for k, d in slabs.items()
                         if FLASH_SLAB_DIGESTS.get(k) != d)
    differ = sorted(k for k, d in digests.items()
                    if FLASH_PARENT_DIGESTS.get(k) != d)
    c16_differ = sorted(k for k, d in c16.items()
                        if FLASH_C16_DIGESTS.get(k) != d)
    print("flash_digests " + json.dumps(dict(
        compared=len(digests), parent=len(FLASH_PARENT_DIGESTS),
        differ=differ, c16_compared=len(c16), c16_differ=c16_differ,
        c16=c16, slab_compared=len(slabs), slab_differ=slab_differ,
        slabs=slabs)))
    check(set(digests) == set(FLASH_PARENT_DIGESTS) and not differ,
          f"flash launch forms whose outputs differ from the parent's: "
          f"{differ}")
    check(set(c16) == set(FLASH_C16_DIGESTS) and not c16_differ,
          f"16-block cluster forms whose outputs differ from their "
          f"recorded bits: {c16_differ}")
    check(set(slabs) == set(FLASH_SLAB_DIGESTS) and not slab_differ,
          f"multi-slab cluster forms whose outputs differ from their "
          f"recorded bits: {slab_differ}")
    return len(digests)


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


def phase_small_reference(seed, family, widths=None):
    """The beam search through the kernels on the card gives the plain
    CPU path's tokens on a small input (``widths`` replaces fields of
    small_hps)."""
    import torch

    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.params import (
        from_numpy_tree,
        init_numpy_params,
    )

    hps = small_hps(family).replace(**(widths or {}))
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
        family=family, widths=widths, kernel_launches=launched,
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


def small_train_batches(hps, seed, n):
    """n train batches of ragged articles over a synthetic vocab of
    hps.vocab_size words, abstracts drawn from their article (so targets
    copy article OOVs)."""
    from textsummarization_on_flink_tpu_torch.data import batching
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab

    words = [f"w{i}" for i in range(hps.vocab_size - 4)]
    vocab = Vocab(words=words)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        exs = []
        for _ in range(hps.batch_size):
            art = [words[j] if rng.random() < 0.7 else f"oov{j % 6}"
                   for j in rng.integers(0, len(words),
                                         rng.integers(10, hps.max_enc_steps))]
            abs_ = [art[j] for j in rng.integers(0, len(art),
                                                 rng.integers(3, 14))]
            exs.append(batching.SummaryExample.build(
                " ".join(art), [" ".join(abs_)], vocab, hps))
        out.append(batching.Batch(exs, hps, vocab).as_arrays())
    return out


def launch_counts():
    """Every kernel wrapper's launch count in this process (ops.launch_counts:
    the fused attention's forward and backward and their bf16-stream
    shares, the flash forward, dK/dV and dQ and their bf16 forms')."""
    from textsummarization_on_flink_tpu_torch import ops

    return ops.launch_counts()


def reset_launch_counts():
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    fa.launches = fa.launches_bwd = 0
    fa.launches_bf16 = fa.launches_bwd_bf16 = 0
    fa.launches_slab = fa.launches_bwd_slab = 0
    fa.launches_sp = fa.launches_bwd_sp = 0
    fl.launches = fl.launches_bwd_dkv = fl.launches_bwd_dq = 0
    fl.launches_bf16 = fl.launches_bwd_dkv_bf16 = fl.launches_bwd_dq_bf16 = 0
    fl.launches_wide = fl.launches_bwd_dkv_wide = fl.launches_bwd_dq_wide = 0
    fl.launches_wide_cluster = fl.launches_bwd_dkv_wide_cluster = 0
    fl.launches_bwd_dq_wide_cluster = 0
    fl.launches_block = fl.launches_bwd_dkv_block = 0
    fl.launches_bwd_dq_block = 0


def expected_train_launches(hps, steps):
    """The launches of ``steps`` train steps: the transformer runs the
    three flash kernels once per layer per step, and under --remat the
    forward twice (a non-reentrant checkpoint reruns each layer's forward
    in the backward, tests/test_torch_byte_diet.py counts it); the
    pointer-generator the fused attention forward and backward once per
    decoder step (its --remat recomputes only the loss head).  Under
    --compute_dtype=bfloat16 every launch takes the bf16 form, at a
    head dim above 256 the wide kernels' (their cluster forms up to
    CLUSTER_UP_TO, a call of a multi-slab form launching its kernel once
    per slab: expected_geometry), and at a pointer-generator
    width past the fused kernels' dense forms their slab forms (the
    forward at K = 1 and the backward each by its own room).  One rank,
    no sp: no sp-block launch."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    counts = dict(fused=0, fused_bwd=0, fused_bf16=0, fused_bwd_bf16=0,
                  fused_slab=0, fused_bwd_slab=0, fused_sp=0,
                  fused_bwd_sp=0,
                  flash_forward=0, flash_bwd_dkv=0, flash_bwd_dq=0,
                  flash_forward_bf16=0, flash_bwd_dkv_bf16=0,
                  flash_bwd_dq_bf16=0, flash_forward_wide=0,
                  flash_bwd_dkv_wide=0, flash_bwd_dq_wide=0,
                  flash_forward_wide_cluster=0,
                  flash_bwd_dkv_wide_cluster=0,
                  flash_bwd_dq_wide_cluster=0,
                  flash_forward_block=0, flash_bwd_dkv_block=0,
                  flash_bwd_dq_block=0)
    if hps.model_family in ("transformer", "avg_attention"):
        # the AAN's decoder has no self-attention: its encoder's layers only
        layers = hps.enc_layers + (hps.dec_layers if hps.model_family
                                   == "transformer" else 0)
        width = fl._padded_head_dim(hps.hidden_dim // hps.num_heads)
        wide = fl._is_wide(width)
        for k, kind in (("flash_forward", "fwd"), ("flash_bwd_dkv", "dkv"),
                        ("flash_bwd_dq", "dq")):
            # a wide call launches its cluster form once per slab
            slabs = expected_geometry(kind, width)[0] if wide else 0
            counts[k] = layers * steps * max(slabs, 1)
            if hps.remat and kind == "fwd":
                counts[k] *= 2
            if hps.compute_dtype == "bfloat16":
                counts[k + "_bf16"] = counts[k]
            if wide:
                counts[k + "_wide"] = counts[k]
                if slabs:
                    counts[k + "_wide_cluster"] = counts[k]
    else:
        counts["fused"] = counts["fused_bwd"] = hps.max_dec_steps * steps
        if hps.compute_dtype == "bfloat16":  # every launch on a bf16 stream
            counts["fused_bf16"] = counts["fused_bwd_bf16"] = counts["fused"]
        dtype = torch_dtype(hps.compute_dtype)
        D = fa._padded_width(2 * hps.hidden_dim, dtype)
        elt = 2 if hps.compute_dtype == "bfloat16" else 4
        if fa._launch_form(hps.batch_size, hps.max_enc_steps, D, 1, elt,
                           card_sms())[3]:
            counts["fused_slab"] = counts["fused"]
        if fa._bwd_form(D, elt) == "slab":
            counts["fused_bwd_slab"] = counts["fused_bwd"]
    return counts


def torch_dtype(name):
    import torch

    return getattr(torch, name)


def card_sms():
    """The card's SM count (the H100's where there is no card: a CPU
    rehearsal)."""
    import torch

    if not torch.cuda.is_available():
        return 132
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_small_training(seed, family, remat=False):
    """Three train steps of a small model of ``family`` on the card (its
    kernels forward and backward) against the same steps on the CPU
    (plain versions), from one numpy params tree and the same batches;
    with ``remat`` under --remat (the transformer's flash forward then
    runs twice per layer).  Losses within 1e-4 relative per step: f32 on
    both sides, but the card's GEMMs and kernels sum in other orders than
    the CPU's, and three Adagrad steps carry the differences forward."""
    from textsummarization_on_flink_tpu_torch.decode.beam_search import (
        _to_device,
    )
    from textsummarization_on_flink_tpu_torch.params import (
        init_numpy_params,
        tree_leaves,
    )
    from textsummarization_on_flink_tpu_torch.train import trainer

    hps = small_hps(family).replace(mode="train", coverage=True, remat=remat)
    p = init_numpy_params(hps, hps.vocab_size, seed)
    batches = small_train_batches(hps, seed, 3)
    runs = {}
    for dev in ("cpu", "cuda"):
        hd = hps.replace(device=dev)
        state = trainer.init_train_state(hd, hps.vocab_size, params=p)
        before = launch_counts()
        losses = []
        for arrays in batches:
            state, m = trainer.train_step(hd, state, _to_device(arrays, dev))
            losses.append(float(m.total_loss))
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        runs[dev] = (losses, state, launched)
    (cpu_losses, cpu_state, cpu_launched), (gpu_losses, gpu_state, launched) \
        = runs["cpu"], runs["cuda"]
    param_diff = max(float((a.detach().cpu() - b.detach()).abs().max())
                     for a, b in zip(tree_leaves(gpu_state.params),
                                     tree_leaves(cpu_state.params)))
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu_losses, cpu_losses)]
    print("small_training " + json.dumps(dict(
        family=family, remat=remat, cpu_losses=cpu_losses,
        card_losses=gpu_losses,
        loss_rel_diff=rel, max_param_abs_diff=param_diff,
        card_launches=launched)))
    check(not any(cpu_launched.values()), "the CPU run launched a kernel")
    want = expected_train_launches(hps, len(batches))
    check(launched == want, f"card launches {launched}, expected {want}")
    check(all(np.isfinite(gpu_losses)), "non-finite loss on the card")
    check(max(rel) <= 1e-4, f"card losses differ from the CPU's by {rel}")


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
                    family="pointer_generator", compute_dtype="float32",
                    widths=None):
    """cli.main at full width; returns the launch and timing summary.
    With compute_dtype="bfloat16" the pointer-generator's encoder stream
    is bf16 and every fused launch takes the kernel's bf16 form, and the
    transformer's every flash launch takes the forward's bf16 form.
    ``widths`` replaces fields of main_path_hps (another width of the
    family).  (device="cpu" rehearses the control flow without a
    card.)"""
    from textsummarization_on_flink_tpu_torch import cli
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode.decoder import (
        get_decode_dir_name,
    )
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params

    hps = main_path_hps(family).replace(**(widths or {}))
    rng = np.random.default_rng(seed)
    # vocab: 49,996 words + 4 specials = the reference's 50k
    words = synthetic_words(hps.vocab_size)
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
                 compute_dtype=compute_dtype,
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
        reset_launch_counts()
        beam_search.steps_run = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        launched = launch_counts()
        fused, flash = launched["fused"], launched["flash_forward"]
        steps = beam_search.steps_run
    finally:
        dec_log.removeHandler(handler)
    check(rc == 0, f"cli.main returned {rc}")
    backward = {k: v for k, v in launched.items() if "bwd" in k and v}
    check(not backward, f"decode launched backward kernels: {backward}")

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
    bf16 = compute_dtype == "bfloat16"
    if family == "transformer":
        from textsummarization_on_flink_tpu_torch.ops import (
            flash_attention as fl,
        )

        launches, bf16_launches = flash, launched["flash_forward_bf16"]
        width = fl._padded_head_dim(hps.hidden_dim // hps.num_heads)
        wide = fl._is_wide(width)
        check(launched["flash_forward_wide"] == (flash if wide else 0),
              f"{launched['flash_forward_wide']} of {flash} flash launches "
              f"took the wide kernel at head dim "
              f"{hps.hidden_dim // hps.num_heads}")
        # a multi-slab cluster form launches once per slab a block owns
        slabs = expected_geometry("fwd", width)[0] if wide else 0
        check(launched["flash_forward_wide_cluster"]
              == (flash if slabs else 0),
              f"{launched['flash_forward_wide_cluster']} of {flash} flash "
              f"launches took the wide cluster form at head dim "
              f"{hps.hidden_dim // hps.num_heads}")
        check(flash > 0, "the flash attention kernel never launched")
        check(flash == hps.enc_layers * n_batches * max(slabs, 1),
              f"{flash} flash launches for {n_batches} batches (expected "
              f"{hps.enc_layers * max(slabs, 1)} per batch: one call per "
              f"encoder layer, {max(slabs, 1)} launches a call)")
        check(bf16_launches == (flash if bf16 else 0),
              f"{bf16_launches} of {flash} flash launches took the bf16 "
              f"form in a {compute_dtype} decode")
        check(fused == 0, f"{fused} fused-attention launches in the "
                          f"transformer path")
    else:
        from textsummarization_on_flink_tpu_torch.ops import (
            fused_attention as fa,
        )

        launches = fused
        check(fused > 0, "the fused attention kernel never launched")
        check(fused == 2 * steps,
              f"{fused} kernel launches for {steps} decode steps "
              f"(expected 2 per step)")
        elt = 2 if bf16 else 4
        slab = fa._launch_form(
            hps.batch_size, hps.max_enc_steps, fa._padded_width(
                2 * hps.hidden_dim, torch_dtype(compute_dtype)),
            hps.beam_size, elt, card_sms())[3]
        if device == "cuda":
            check(launched["fused_slab"] == (fused if slab else 0),
                  f"{launched['fused_slab']} of {fused} fused launches took "
                  f"the slab form at hidden_dim {hps.hidden_dim}")
        check(launched["fused_sp"] == 0, "an sp-block launch on one rank")
        check(flash == 0, f"{flash} flash launches in the "
                          f"pointer-generator path")
        bf16_launches = launched["fused_bf16"]
        check(launched["fused_bf16"] == (fused if bf16 else 0),
              f"{launched['fused_bf16']} of {fused} fused launches took a "
              f"bf16 encoder stream in a {compute_dtype} decode")
    summary = dict(family=family, compute_dtype=compute_dtype,
                   widths=widths, articles=n_articles, batches=n_batches,
                   batch_seconds=batch_s, decode_steps=steps,
                   kernel_launches=launches, bf16_launches=bf16_launches,
                   wide_launches=launched["flash_forward_wide"],
                   wide_cluster_launches=launched[
                       "flash_forward_wide_cluster"],
                   slab_launches=launched["fused_slab"],
                   launches_per_batch=launches / max(n_batches, 1),
                   decoded_tokens=n_tokens,
                   tokens_per_s=n_tokens / sum(batch_s),
                   cli_wall_s=wall, setup_s=setup_s)
    print("main_path " + json.dumps(summary))
    return summary


class _TrainLog(logging.Handler):
    """Collects the trainer's seconds per step and losses: one seconds
    line per metrics window (its average over the window's steps),
    repeated here once per step of the window."""

    def __init__(self):
        super().__init__()
        self.seconds, self.losses = [], []

    def emit(self, record):
        if record.msg.startswith("seconds for training step"):
            self.seconds += [float(record.args[0])] * int(record.args[1])
        elif record.msg.startswith("loss:"):
            self.losses.append(float(record.args[0]))


def synthetic_words(vocab_size):
    """The synthetic vocabulary: vocab_size - 4 words, most frequent
    first (the 4 specials complete it)."""
    return [f"w{i:05d}" for i in range(vocab_size - 4)]


def synthetic_pairs(rng, words, n_pairs):
    """n_pairs (article, lead sentences): articles of 300-800
    zipf-ranked words with ~5% OOVs; 3 sentences of 8-20 words taken
    from the article's lead, as news highlights lean on the lead."""
    pairs = []
    for _ in range(n_pairs):
        n = int(rng.integers(300, 800))
        ranks = np.minimum(rng.zipf(1.2, n), len(words)) - 1
        art = [words[r] if rng.random() > 0.05 else f"oov{rng.integers(50)}"
               for r in ranks]
        cuts = np.cumsum(rng.integers(8, 20, 3))
        sents = [" ".join(art[a:b]) + " ."
                 for a, b in zip([0, *cuts[:2]], cuts)]
        pairs.append((" ".join(art) + " .", sents))
    return pairs


def write_train_chunks(work, hps, seed, n_pairs):
    """A synthetic 50k vocab and n_pairs article/abstract pairs
    (synthetic_pairs, the abstract's sentences in <s> ... </s>) as chunk
    files (the port's writer).  Returns (vocab path, data glob)."""
    from textsummarization_on_flink_tpu_torch.data import chunks

    rng = np.random.default_rng(seed)
    words = synthetic_words(hps.vocab_size)
    vocab_path = os.path.join(work, "vocab")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.writelines(f"{w} {len(words) - i}\n" for i, w in enumerate(words))
    pairs = [{"article": [art],
              "abstract": [" ".join(f"<s> {x} </s>" for x in sents)]}
             for art, sents in synthetic_pairs(rng, words, n_pairs)]
    for c in range(0, n_pairs, 16):
        chunks.write_chunk_file(os.path.join(work, f"train_{c // 16:03d}.bin"),
                                pairs[c:c + 16])
    return vocab_path, os.path.join(work, "train_*.bin")


def train_main_path_hps(family):
    """The training configuration of each family's main path: the
    reference width (main_path_hps), coverage on.  The pointer-generator
    trains at the reference's lr 0.15.  The transformer at 0.015, a tenth
    of it: at 0.15 the copy gate (pgen_linear over unit-variance LayerNorm
    outputs) of this random transformer flips between p_gen ~0 and ~1
    from step to step and the loss does not fall in 10 steps, on the card
    as in the JAX package (scripts/torch_train_trace.py prints both;
    PERF.md)."""
    hps = main_path_hps(family).replace(mode="train", coverage=True)
    return hps.replace(lr=0.015) if family == "transformer" else hps


def fixed_batch_losses(argv, params, device):
    """The training objective, under the flags ``argv`` of a cli.main
    training run, of the run's fresh params (from its --seed) and of
    ``params``, on one batch: the first of the run's data, read in one
    pass (one example thread, the files in order).  Returns [fresh,
    params]."""
    import torch

    from textsummarization_on_flink_tpu_torch.config import HParams
    from textsummarization_on_flink_tpu_torch.data.batcher import Batcher
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.train import (
        trainer as trainer_lib,
    )

    hps = HParams.from_argv(argv)
    vocab = Vocab(hps.vocab_path, hps.vocab_size)
    batch = Batcher(hps.data_path, vocab, hps, single_pass=True).next_batch()
    arrays = trainer_lib.batch_to_device(batch.as_arrays(),
                                         torch.device(device))
    fresh = trainer_lib.init_train_state(hps, vocab.size(),
                                         device=torch.device(device)).params
    loss_fn = trainer_lib.make_loss_fn(hps)
    with torch.no_grad():
        return [float(loss_fn(p, arrays)[0]) for p in (fresh, params)]


def phase_train_main_path(seed, work, steps=10, device="cuda",
                          family="transformer", extra=None, fires=0,
                          expect_kernels=True):
    """cli.main(--mode=train) of ``family`` at the reference width, with
    the flags ``extra`` on top (the metrics read every step unless they
    say otherwise); returns the launch and timing summary and the
    trainer's recovery counters.  ``fires``: the dispatches an injected
    train.step_nan fault discards (their kernels ran; no loss is logged
    for them).  Without ``expect_kernels`` (a --device=cpu reference run)
    no kernel may launch.  (device="cpu" rehearses the control flow
    without a card.)"""
    import torch

    from textsummarization_on_flink_tpu_torch import cli, obs
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )

    extra = dict(dict(metrics_every=1), **(extra or {}))
    hps = train_main_path_hps(family).replace(**extra)
    t0 = time.perf_counter()
    vocab_path, data_path = write_train_chunks(work, hps, seed, 64)
    setup_s = time.perf_counter() - t0
    widths = ("hidden_dim", "vocab_size", "max_enc_steps", "max_dec_steps",
              "min_dec_steps", "batch_size")
    widths += (("num_heads", "enc_layers", "dec_layers", "ffn_dim")
               if family == "transformer" else ("emb_dim",))
    flags = dict(mode="train", model_family=family,
                 num_steps=steps, coverage=1, pointer_gen=1,
                 data_path=data_path, vocab_path=vocab_path, log_root=work,
                 exp_name="exp", device=device, seed=seed, lr=hps.lr,
                 **{k: getattr(hps, k) for k in widths})
    flags.update(extra)
    argv = [f"--{k}={v}" for k, v in flags.items()]
    handler = _TrainLog()
    reg = obs.Registry()
    tr_log = logging.getLogger(
        "textsummarization_on_flink_tpu_torch.train.trainer")
    tr_log.setLevel(logging.INFO)
    tr_log.addHandler(handler)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        with obs.use_registry(reg):
            reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            wall = time.perf_counter() - t0
            launched = launch_counts()
    finally:
        tr_log.removeHandler(handler)
    check(rc == 0, f"cli.main returned {rc}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    want = (expected_train_launches(hps, steps + fires) if expect_kernels
            else dict.fromkeys(launched, 0))
    check(launched == want, f"{family} training launched {launched} in "
                            f"{steps} steps, expected {want}")
    losses, seconds = handler.losses, handler.seconds
    check(len(losses) == steps, f"{len(losses)} logged losses for {steps} "
                                f"steps")
    check(all(np.isfinite(losses)), f"non-finite loss in {losses}")
    train_dir = os.path.join(work, "exp", "train")
    path = os.path.join(train_dir, f"model.ckpt-{steps}.npz")
    check(os.path.exists(path), f"{path} was not written")
    restored = ckpt_lib.Checkpointer(train_dir).restore(path, device=device)
    check(restored.step == steps, f"restored step {restored.step}")
    # the logged losses are of a different batch each step, in the
    # threaded batcher's nondeterministic order, and vary more from batch
    # to batch than 10 steps lower them: the fall is read on one batch
    fixed = None
    if steps >= 5:
        fixed = fixed_batch_losses(argv, restored.params, device)
        check(fixed[1] < fixed[0], f"the loss did not fall on a fixed "
                                   f"batch: {fixed[0]} before training, "
                                   f"{fixed[1]} after")
    check(os.path.exists(os.path.join(train_dir, "vocab_metadata.tsv")),
          "no vocab_metadata.tsv beside the checkpoints")
    n_batches = reg.counter("train/batches_total").value
    check(n_batches == steps + fires, f"the trainer took {n_batches} "
                                      f"batches in {steps} steps")
    # the target tokens of the batches the trainer took, per batch
    tokens_per_step = reg.counter(
        "train/target_tokens_total").value / n_batches
    warm = seconds[2:] or seconds  # steps 3 .. 10
    warm_s = statistics.median(warm)
    # the trainer's flight dumps and its /profile body (phases, walls, the
    # sentinel's priced dispatches)
    flight = flight_headers(train_dir)
    prof = profile_summary(reg)
    summary = dict(family=family, lr=hps.lr, steps=steps,
                   flags={k: v for k, v in extra.items()},
                   launches=launched,
                   launches_per_step={k: v / (steps + fires)
                                      for k, v in launched.items()},
                   losses=losses, fixed_batch_losses=fixed,
                   step_seconds=seconds, warm_median_step_s=warm_s,
                   target_tokens_per_step=tokens_per_step,
                   target_tokens_per_s=tokens_per_step / warm_s,
                   max_memory_allocated_bytes=peak, cli_wall_s=wall,
                   setup_s=setup_s,
                   recovery=dict(
                       nan_skips=reg.counter(
                           "resilience/train/nan_skips_total").value,
                       rollbacks=reg.counter(
                           "resilience/train/rollbacks_total").value,
                       watchdog=reg.counter(
                           "train/nan_watchdog_total").value,
                       # None when the run never set it
                       lr_scale=getattr(reg.get(
                           "resilience/train/lr_scale"), "value", None)),
                   flight_dumps=flight, profile=prof,
                   card=card_line() if device == "cuda" else None)
    print("train_main_path " + json.dumps(summary))
    return summary


def phase_small_bf16_transformer(seed):
    """A small transformer under --compute_dtype=bfloat16 on the card (the
    flash kernels' bf16 forms, bf16 GEMMs) against --device=cpu (the plain
    bf16 versions), from one numpy params tree:

      * one train step (--loss_chunk=5, coverage on): the loss and every
        new param and accumulator within 4 times the CPU's own distance
        between its bf16 and f32 steps, the rule of the CPU tests against
        the JAX package (the card's GEMMs round bf16 at other places);
        exactly one bf16 forward, dK/dV and dQ launch per layer;
      * beam decode from a sharpened checkpoint: the first step's top-k
        log-probs (the step's distributions) within 4 times the CPU's own
        bf16-to-f32 distance and the same best ids, and the share of
        equal tokens over whole summaries reported, not held (bf16
        rounding may split near-equal beams later on)."""
    import torch

    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode.beam_search import (
        _to_device,
    )
    from textsummarization_on_flink_tpu_torch.models import transformer as tfm
    from textsummarization_on_flink_tpu_torch.params import (
        from_numpy_tree,
        init_numpy_params,
        tree_leaves,
    )
    from textsummarization_on_flink_tpu_torch.train import trainer

    hps = small_hps("transformer").replace(
        mode="train", coverage=True, compute_dtype="bfloat16", loss_chunk=5)
    p = init_numpy_params(hps, hps.vocab_size, seed)
    arrays = small_train_batches(hps, seed, 1)[0]
    runs = {}
    for name, dev, dt in (("card", "cuda", "bfloat16"),
                          ("cpu", "cpu", "bfloat16"),
                          ("cpu32", "cpu", "float32")):
        h = hps.replace(device=dev, compute_dtype=dt)
        state = trainer.init_train_state(h, h.vocab_size, params=p)
        before = launch_counts()
        state, m = trainer.train_step(h, state, _to_device(arrays, dev))
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        runs[name] = (float(m.loss), [
            x.detach().float().cpu().numpy() for x in
            tree_leaves(state.params)
            + tree_leaves(state.opt_state.accumulators)], launched)
    (g_loss, g_leaves, launched), (c_loss, c_leaves, _), (f_loss, f_leaves,
                                                          _) = (
        runs["card"], runs["cpu"], runs["cpu32"])
    loss_bound = 4 * abs(c_loss - f_loss) + 1e-5
    leaf_ok = all(
        float(np.max(np.abs(g - c))) <= 4 * float(np.max(np.abs(c - f)))
        + 1e-5 * max(1.0, float(np.max(np.abs(c))))
        for g, c, f in zip(g_leaves, c_leaves, f_leaves))
    want = expected_train_launches(hps, 1)

    # decode: the first step's distributions, then whole summaries
    dhps = small_hps("transformer").replace(compute_dtype="bfloat16")
    dp = init_numpy_params(dhps, dhps.vocab_size, seed)
    dp["embedding"] *= 30.0  # tied: also sharpens the vocab scores
    dp["out_bias"][3] = 3.0  # STOP
    rng = np.random.default_rng(seed)
    B, T = dhps.batch_size, dhps.max_enc_steps
    lens = rng.integers(T // 2, T + 1, B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    ids = np.where(mask > 0, rng.integers(4, dhps.vocab_size, (B, T)), 1)
    ext = np.where((rng.random((B, T)) < 0.2) & (mask > 0),
                   dhps.vocab_size + rng.integers(0, 4, (B, T)), ids)
    darrays = dict(enc_batch=ids.astype(np.int32),
                   enc_lens=lens.astype(np.int32), enc_padding_mask=mask,
                   enc_batch_extend_vocab=ext.astype(np.int32))
    first = {}
    for name, dev, dt in (("card", "cuda", "bfloat16"),
                          ("cpu", "cpu", "bfloat16"),
                          ("cpu32", "cpu", "float32")):
        h = dhps.replace(compute_dtype=dt)
        tp = from_numpy_tree(dp, torch.device(dev))
        a = _to_device(darrays, dev)
        with torch.no_grad():
            enc = tfm.beam_encode(tp, h, a)
            init_state, step = tfm.beam_adapter(h)
            o = step(tp, enc, a["enc_padding_mask"],
                     a["enc_batch_extend_vocab"],
                     torch.zeros(B, dtype=torch.long, device=dev),
                     torch.full((B, h.beam_size), 2, dtype=torch.long,
                                device=dev), init_state(tp, enc))
        first[name] = (o.topk_ids.cpu().numpy(),
                       o.topk_log_probs.float().cpu().numpy())
    step_bound = 4 * float(np.max(np.abs(first["cpu"][1]
                                         - first["cpu32"][1]))) + 1e-5
    step_err = float(np.max(np.abs(first["card"][1] - first["cpu"][1])))
    best_equal = bool(np.array_equal(first["card"][0][..., 0],
                                     first["cpu"][0][..., 0]))
    cpu = beam_search.run_beam_search(from_numpy_tree(dp, "cpu"), dhps,
                                      darrays)
    before = launch_counts()
    gpu = beam_search.run_beam_search(
        from_numpy_tree(dp, torch.device("cuda")), dhps, darrays)
    dec_launched = {k: v - before[k] for k, v in launch_counts().items()}
    equal_share = float(np.mean(cpu.tokens == gpu.tokens))
    row = dict(cpu_loss=c_loss, card_loss=g_loss, cpu_f32_loss=f_loss,
               loss_abs_diff=abs(g_loss - c_loss), loss_bound=loss_bound,
               leaves_within_bound=leaf_ok, train_launches=launched,
               first_step_logprob_abs_diff=step_err,
               first_step_bound=step_bound, first_step_best_ids_equal=best_equal,
               decode_launches=dec_launched,
               summary_token_equal_share=equal_share,
               card_lengths=gpu.length.tolist(),
               cpu_lengths=cpu.length.tolist())
    print("small_bf16_transformer " + json.dumps(row))
    check(launched == want, f"bf16 small train step launched {launched}, "
                            f"expected {want}")
    check(abs(g_loss - c_loss) <= loss_bound,
          f"bf16 card loss {g_loss} vs CPU {c_loss} beyond {loss_bound}")
    check(leaf_ok, "bf16 card params or accumulators beyond 4x the CPU's "
                   "own bf16-to-f32 distance")
    check(step_err <= step_bound, f"bf16 first-step log-probs differ by "
                                  f"{step_err} > {step_bound}")
    check(best_equal, "bf16 first-step best ids differ card vs CPU")
    check(dec_launched["flash_forward_bf16"] == dhps.enc_layers
          and dec_launched["flash_forward"] == dhps.enc_layers,
          f"bf16 small decode launched {dec_launched}")
    return row


def phase_transformer_bf16(seed, f32_train, device="cuda"):
    """The transformer under --compute_dtype=bfloat16 at the reference
    width through cli.main, each run with its launch counts set to 0 just
    before and read just after:

      * a decode of 16 articles (phase_main_path): exactly 6 bf16 flash
        forward launches per batch and none of the f32 form;
      * 10 train steps with --loss_chunk=10: exactly 12 + 12 + 12 bf16
        launches per step (forward, dK/dV, dQ) and none of the f32 forms,
        losses finite, falling on a fixed batch; the peak memory and the
        warm median step beside the f32 transformer run's (``f32_train``,
        phase_train_main_path's summary);
      * 2 steps under --remat: 24 bf16 forward launches per step;
      * the small-width card-vs-CPU checks of
        phase_small_bf16_transformer.

    (device="cpu" rehearses the control flow without a card, without the
    card-vs-CPU checks.)"""
    tf = "transformer"
    flags = dict(compute_dtype="bfloat16", loss_chunk=10)
    decode = _in_work("tf_decode_bf16", lambda w: phase_main_path(
        seed, 16, w, device=device, family=tf, compute_dtype="bfloat16"))
    train = _in_work("tf_train_bf16", lambda w: phase_train_main_path(
        seed, w, device=device, family=tf, extra=flags))
    remat = _in_work("tf_remat_bf16", lambda w: phase_train_main_path(
        seed, w, steps=2, device=device, family=tf,
        extra=dict(flags, remat=1)))
    small = phase_small_bf16_transformer(seed) if device == "cuda" else None
    summary = dict(
        decode_batch_seconds=decode["batch_seconds"],
        decode_launches_per_batch=decode["launches_per_batch"],
        decode_bf16_launches=decode["bf16_launches"],
        train_warm_median_step_s=train["warm_median_step_s"],
        f32_train_warm_median_step_s=f32_train["warm_median_step_s"],
        train_target_tokens_per_s=train["target_tokens_per_s"],
        train_peak_bytes=train["max_memory_allocated_bytes"],
        f32_train_peak_bytes=f32_train["max_memory_allocated_bytes"],
        train_launches_per_step=train["launches_per_step"],
        train_losses=train["losses"], remat_losses=remat["losses"],
        remat_launches_per_step=remat["launches_per_step"],
        small=small)
    print("transformer_bf16 " + json.dumps(summary))
    return dict(decode=decode, train=train, remat=remat, small=small)


def pipeline_hps(work, seed, device="cuda"):
    """The App's hyperparameters for the pipeline phase: training at the
    reference width of phase_train_main_path (H 256, E 128, V 50,000,
    400/100 steps, batch 16, coverage on, lr 0.15), 4 steps from fresh
    params of --seed; decoding with the App's defaults (batch 4, 400/100
    steps, beam 4, min 35, V 50,000, coverage on)."""
    from textsummarization_on_flink_tpu_torch.pipeline import app

    train = train_main_path_hps("pointer_generator").replace(
        num_steps=4, log_root=work, exp_name="exp", seed=seed, device=device,
        metrics_every=1)
    infer = app.default_inference_hps(work).replace(device=device)
    return train, infer


def pipeline_rows(seed, words, n, start=0):
    """n (uuid, article, summary, reference) rows of synthetic_pairs, the
    reference the lead sentences, the summary column empty."""
    return [(f"uuid-{start + i}", art, "", " ".join(sents))
            for i, (art, sents) in enumerate(
                synthetic_pairs(np.random.default_rng(seed), words, n))]


def phase_pipeline(seed, work, device="cuda"):
    """``App.main`` through the pipeline layer: ``start_training`` fits
    the estimator on a CollectionSource of 64 rows (4 steps), then
    ``start_inference`` transforms 16 further rows into a CollectionSink
    from the model JSON, each with the launch counts set to 0 just before
    and read just after.  Checks: 16 rows with exactly the input uuids, a
    checkpoint, a model JSON without weights, exactly 100 fused forward
    and 100 fused backward launches per train step and 2 fused launches
    per beam step, and the first 4 summaries equal to a second transform
    of those rows with --device=cpu from the same checkpoint.  (device=
    "cpu" rehearses the control flow without a card.)"""
    import shlex

    import torch

    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.pipeline import app as app_lib
    from textsummarization_on_flink_tpu_torch.pipeline import estimator
    from textsummarization_on_flink_tpu_torch.pipeline import io

    train_hps, infer_hps = pipeline_hps(work, seed, device)
    words = synthetic_words(train_hps.vocab_size)
    vocab = Vocab(words=words)
    train_rows = pipeline_rows(seed, words, 64)
    infer_rows = pipeline_rows(seed + 1, words, 16, start=64)
    app = app_lib.App(train_hps, infer_hps, vocab=vocab)
    train_log, batch_log = _TrainLog(), _BatchLog()
    loggers = [(logging.getLogger(
        "textsummarization_on_flink_tpu_torch." + name), h) for name, h in (
            ("train.trainer", train_log), ("decode.decoder", batch_log))]
    for lg, h in loggers:
        lg.setLevel(logging.INFO)
        lg.addHandler(h)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        model_json = app.start_training(io.CollectionSource(train_rows))
        fit_s = time.perf_counter() - t0
        fit_launches = launch_counts()
        reset_launch_counts()
        beam_search.steps_run = 0
        t0 = time.perf_counter()
        sink = app.start_inference(model_json,
                                   source=io.CollectionSource(infer_rows),
                                   sink=io.CollectionSink())
        transform_s = time.perf_counter() - t0
        transform_launches = launch_counts()
        beam_steps = beam_search.steps_run
    finally:
        for lg, h in loggers:
            lg.removeHandler(h)
    steps = train_hps.num_steps
    check(len(sink.rows) == 16, f"{len(sink.rows)} rows out for 16 in")
    check(sorted(r[0] for r in sink.rows) == sorted(r[0] for r in infer_rows),
          "the output uuids are not the input uuids")
    check(all(r[2] for r in sink.rows), "an empty summary")
    train_dir = estimator.train_dir_for(train_hps)
    check(os.path.exists(os.path.join(train_dir, f"model.ckpt-{steps}.npz")),
          f"no model.ckpt-{steps}.npz in {train_dir}")
    params = json.loads(model_json)
    check(len(model_json) < 10_000 and all(
        isinstance(v, (str, int, float, bool, list, type(None)))
        for v in params.values()), "the model JSON holds more than config")
    want_fit = expected_train_launches(train_hps, steps)
    check(fit_launches == want_fit,
          f"fit launched {fit_launches}, expected {want_fit}")
    want_tf = dict(want_fit, fused=2 * beam_steps, fused_bwd=0)
    check(beam_steps > 0 and transform_launches == want_tf,
          f"transform launched {transform_launches} in {beam_steps} beam "
          f"steps, expected {want_tf}")

    # the first 4 rows again, on the CPU, from the same checkpoint
    first = infer_rows[:4]
    cpu_model = estimator.SummarizationModel().load_json(model_json)
    cpu_model.set_inference_hyper_params(
        shlex.split(infer_hps.replace(device="cpu").to_argv()))
    cpu_model.with_vocab(vocab)
    t0 = time.perf_counter()
    cpu_rows = cpu_model.transform(io.CollectionSource(first)).rows
    cpu_s = time.perf_counter() - t0
    card = {r[0]: r[2] for r in sink.rows}
    differ = [r[0] for r in cpu_rows if card[r[0]] != r[2]]
    check(len(cpu_rows) == 4 and not differ,
          f"card summaries differ from the CPU's for {differ}")
    step_s = train_log.seconds
    batch_s = [float(sec) for _, sec in batch_log.batches]
    summary = dict(
        fit_wall_s=fit_s, transform_wall_s=transform_s,
        train_step_seconds=step_s,
        median_train_step_s=statistics.median(step_s[1:] or step_s),
        losses=train_log.losses, decoded_batches=len(batch_s),
        batch_seconds=batch_s, seconds_per_batch=statistics.median(batch_s),
        rows_out=len(sink.rows), beam_steps=beam_steps,
        fit_launches=fit_launches, transform_launches=transform_launches,
        launches_per_train_step={k: v / steps
                                 for k, v in fit_launches.items()},
        fused_launches_per_beam_step=transform_launches["fused"]
        / beam_steps,
        cpu_check_rows=len(cpu_rows), cpu_check_s=cpu_s,
        summary_words=[len(card[r[0]].split()) for r in first],
        card=card_line() if device == "cuda" else None)
    print("pipeline " + json.dumps(summary))
    if device == "cuda":
        torch.cuda.synchronize()
    return summary


#: the byte-diet training run: the streaming loss in chunks of 10 decoder
#: steps, bf16 compute (a bf16 encoder stream through both fused
#: kernels), bf16 Adagrad state, 2 steps per dispatch, metrics every 2
BYTE_DIET_FLAGS = dict(loss_chunk=10, compute_dtype="bfloat16",
                       opt_state_dtype="bfloat16", steps_per_dispatch=2,
                       metrics_every=2)
#: the recovery run: train.step_nan injected on the first 3 dispatches
#: (seed 7), 2 skips, then 1 rollback with the LR halved
RECOVERY_FLAGS = dict(faults="train.step_nan:1.0:7:3", nan_skip_steps=2,
                      nan_max_rollbacks=1, flight_frames=8,
                      profile_analytic=1, checkpoint_steps=2)
#: the trainer's phases (obs/profile.py) in a run with a checkpoint cadence
TRAIN_PHASES = {"train/host_wait", "train/step_dispatch",
                "train/metrics_flush", "train/checkpoint"}


def flight_headers(directory):
    """{file: header without its write time} of the flight dumps in
    ``directory``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, "flight_*.jsonl"))):
        with open(path, encoding="utf-8") as f:
            header = json.loads(f.readline())
        header.pop("ts_us", None)
        out[os.path.basename(path)] = header
    return out


def profile_summary(reg):
    """The registry's /profile body, short: phase and wall counts and the
    divergence sentinel's rows."""
    from textsummarization_on_flink_tpu_torch.obs import profile as profile_lib

    body = profile_lib.profile_payload(reg)
    return dict(phases={p["phase"]: p["count"] for p in body["phases"]},
                walls={w["wall"]: w["count"] for w in body["walls"]},
                divergence=body["divergence"])


def print_sentinel(what, rows):
    """The sentinel's achieved rates of each priced shape, on a line of
    their own beside the card (a reading, no claim)."""
    print("profile_sentinel " + json.dumps(dict(
        run=what, card=card_line(),
        rows=[{k: r[k] for k in ("site", "key", "flops", "bytes", "samples",
                                 "achieved_bytes_per_s",
                                 "achieved_flops_per_s")} for r in rows])))


def recovery_dumps_cpu(seed):
    """The recovery run's flight-dump headers from a small
    pointer-generator on the CPU (the same flags, 4 steps): which dumps
    fire and their contexts follow the fault plan, not the width."""
    from textsummarization_on_flink_tpu_torch import obs
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.train import trainer

    class Arrays:
        def __init__(self, arrays):
            self.arrays = arrays

        def as_arrays(self):
            return self.arrays

    class Batches:
        def __init__(self, batches):
            self.batches = list(batches)

        def next_batch(self):
            return Arrays(self.batches.pop(0)) if self.batches else None

    hps = small_hps("pointer_generator").replace(
        mode="train", device="cpu", metrics_every=1, **RECOVERY_FLAGS)

    def run(work):
        with obs.use_registry(obs.Registry()):
            tr = trainer.Trainer(
                hps.replace(log_root=work), hps.vocab_size,
                Batches(small_train_batches(hps, seed, 8)),
                checkpointer=ckpt_lib.Checkpointer(
                    os.path.join(work, "ck"), hps=hps),
                checkpoint_secs=1e9, train_dir=os.path.join(work, "train"))
            check(tr.train(num_steps=4).step == 4, "the CPU recovery run "
                                                   "did not reach step 4")
        return flight_headers(os.path.join(work, "train"))

    return _in_work("recovery_cpu", run)


def _in_work(name, fn):
    """fn(work) in a fresh scratch directory .smoke_work/<name> (its own
    log_root), removed afterwards."""
    work = os.path.join(HERE, ".smoke_work", name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        return fn(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_byte_diet(seed, materialised, device="cuda"):
    """The pointer-generator's byte-diet and long-run options at the
    reference width, each run through cli.main with the launch counts set
    to 0 just before and read just after:

      * 10 steps with BYTE_DIET_FLAGS: every fused launch, forward and
        backward, on a bf16 stream (100 + 100 per step); losses finite,
        falling on a fixed batch; the peak memory beside the materialised
        run's, and the median step time of the 2-step metrics windows
        beside the materialised run's over the same windows;
      * 3 steps of the f32 streaming loss (--loss_chunk=10) beside 3
        steps of the materialised loss, both --single_pass=1 (one example
        thread, the files in order, no batch shuffle: the same batches)
        from the same params: the losses within 1e-4 relative;
      * the recovery run (RECOVERY_FLAGS, 4 steps): 2 skips, 1 rollback,
        lr_scale 0.5, the 3 discarded dispatches' launches counted;
      * a bf16 beam decode of 16 articles: 2 fused launches per beam step,
        each on the kernel's bf16 form.

    ``materialised``: phase_train_main_path's pointer-generator summary.
    (device="cpu" rehearses the control flow without a card.)"""
    pg = "pointer_generator"
    diet = _in_work("diet", lambda w: phase_train_main_path(
        seed, w, device=device, family=pg, extra=BYTE_DIET_FLAGS))
    chunked = _in_work("chunk_f32", lambda w: phase_train_main_path(
        seed, w, steps=3, device=device, family=pg,
        extra=dict(loss_chunk=10, single_pass=1)))
    reference = _in_work("materialised_f32", lambda w: phase_train_main_path(
        seed, w, steps=3, device=device, family=pg,
        extra=dict(single_pass=1)))
    rel = [abs(a - b) / abs(b) for a, b in
           zip(chunked["losses"], reference["losses"])]
    check(max(rel) <= 1e-4, f"the f32 streaming loss differs from the "
                            f"materialised one by {rel} (relative)")
    recovery = _in_work("recovery", lambda w: phase_train_main_path(
        seed, w, steps=4, device=device, family=pg, extra=RECOVERY_FLAGS,
        fires=3))
    rec = recovery["recovery"]
    check((rec["nan_skips"], rec["rollbacks"], rec["watchdog"],
           rec["lr_scale"]) == (2.0, 1.0, 3.0, 0.5),
          f"recovery took {rec}, expected 2 skips, 1 rollback, 3 watchdog "
          f"fires, lr_scale 0.5")
    # the flight dumps: the three injected NaNs and the rollback, with the
    # CPU run's headers
    dumps, want = recovery["flight_dumps"], recovery_dumps_cpu(seed)
    check(sorted(dumps) == ["flight_nan_rollback.jsonl",
                            "flight_train_nan-2.jsonl",
                            "flight_train_nan-3.jsonl",
                            "flight_train_nan.jsonl"],
          f"the recovery run dumped {sorted(dumps)}")
    check(dumps == want, f"the recovery run's dump headers {dumps} differ "
                         f"from the CPU run's {want}")
    prof = recovery["profile"]
    check(set(prof["phases"]) == TRAIN_PHASES
          and prof["walls"].get("train/round", 0) > 0,
          f"the recovery run booked {prof['phases']} and {prof['walls']}")
    priced = [r for r in prof["divergence"]
              if (r["site"], r["key"]) == ("train/step_dispatch", "step")]
    check(len(priced) == 1 and priced[0]["samples"] > 0
          and priced[0]["flops"] > 0 and priced[0]["bytes"] > 0,
          f"train/step_dispatch was not priced: {prof['divergence']}")
    if device == "cuda":
        print_sentinel("recovery", priced)
    decode = _in_work("decode_bf16", lambda w: phase_main_path(
        seed, 16, w, device=device, family=pg, compute_dtype="bfloat16"))
    # the byte-diet run's host reads one metrics window of 2 steps at a
    # time, so its step times are window averages; the materialised run
    # (a read per step) is averaged over the same windows to compare
    width = BYTE_DIET_FLAGS["metrics_every"]
    warm = materialised["step_seconds"][2:]
    mat_windows = [statistics.mean(warm[i:i + width])
                   for i in range(0, len(warm), width)]
    summary = dict(
        diet_warm_median_window_step_s=diet["warm_median_step_s"],
        materialised_warm_median_window_step_s=statistics.median(
            mat_windows),
        materialised_warm_median_step_s=materialised["warm_median_step_s"],
        window_steps=width,
        diet_target_tokens_per_s=diet["target_tokens_per_s"],
        diet_peak_bytes=diet["max_memory_allocated_bytes"],
        materialised_peak_bytes=materialised["max_memory_allocated_bytes"],
        diet_launches_per_step=diet["launches_per_step"],
        diet_losses=diet["losses"], chunk_f32_losses=chunked["losses"],
        materialised_f32_losses=reference["losses"],
        chunk_f32_rel_diff=rel, recovery=rec,
        recovery_launches=recovery["launches"],
        recovery_dumps=sorted(dumps), recovery_phases=prof["phases"],
        recovery_walls=prof["walls"],
        decode_bf16_launches_per_step=decode["kernel_launches"]
        / max(decode["decode_steps"], 1),
        decode_bf16_batch_seconds=decode["batch_seconds"])
    print("byte_diet " + json.dumps(summary))
    return dict(diet=diet, chunked=chunked, reference=reference,
                recovery=recovery, decode=decode)


def _decode_flags(hps, **kw):
    """cli flags of a pointer-generator decode at hps's widths."""
    flags = dict(mode="decode", model_family="pointer_generator",
                 pointer_gen=1, coverage=int(hps.coverage), exp_name="exp",
                 **{k: getattr(hps, k) for k in (
                     "hidden_dim", "emb_dim", "vocab_size", "max_enc_steps",
                     "max_dec_steps", "min_dec_steps", "beam_size",
                     "batch_size")})
    flags.update(kw)
    return [f"--{k}={v}" for k, v in flags.items()]


def _save_params(train_dir, params, step):
    """params as checkpoint ``step`` of train_dir; returns its path."""
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )

    path = os.path.join(train_dir, f"model.ckpt-{step}.npz")
    ckpt_lib.save_arrays(path, ckpt_lib._flatten({"params": params}))
    ckpt_lib.write_index(train_dir, path)
    return path


def phase_rouge_decode(seed, work, device="cuda"):
    """``cli.main --mode=decode --single_pass=1`` (chunk files, no
    --inference) of the pointer-generator at the reference width over 16
    synthetic articles whose lead sentences are the abstracts, from a
    checkpoint trained 4 steps (--single_pass=1) on 64 others: the
    decoder writes the pyrouge files and scores them with the port's
    ROUGE into ROUGE_results.txt.  Checks: exactly 2 fused launches per
    beam step, the file equal to rouge_log of rouge_eval over the written
    files, and the scores equal to rouge_eval over a --device=cpu decode
    of the same articles from the same checkpoint, whose decoded files
    equal the card's (trained params, as the pipeline phase's: a random
    model's near-uniform scores leave its beams to rounding).
    (device="cpu" rehearses the control flow without a card.)"""
    from textsummarization_on_flink_tpu_torch import cli
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode.decoder import (
        get_decode_dir_name,
    )
    from textsummarization_on_flink_tpu_torch.evaluate import rouge

    hps = main_path_hps("pointer_generator")
    os.makedirs(os.path.join(work, "train"))
    trained = phase_train_main_path(seed, os.path.join(work, "train"),
                                    steps=4, device=device,
                                    family="pointer_generator",
                                    extra=dict(single_pass=1))
    flat = ckpt_lib.load_arrays(os.path.join(work, "train", "exp", "train",
                                             "model.ckpt-4.npz"))
    params = ckpt_lib._unflatten_dicts(flat)["params"]
    test_dir = os.path.join(work, "test")
    os.makedirs(test_dir)
    vocab_path, data_path = write_train_chunks(test_dir, hps, seed + 1, 16)
    runs = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        root = os.path.join(work, name)
        path = _save_params(os.path.join(root, "exp", "train"), params, 4)
        argv = _decode_flags(hps, single_pass=1, data_path=data_path,
                             vocab_path=vocab_path, log_root=root,
                             device=dev)
        reset_launch_counts()
        beam_search.steps_run = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        launched, steps = launch_counts(), beam_search.steps_run
        check(rc == 0, f"cli.main returned {rc}")
        ddir = os.path.join(root, "exp", get_decode_dir_name(hps, path))
        ref, dec = (os.path.join(ddir, d) for d in ("reference", "decoded"))
        scores = rouge.rouge_eval(ref, dec)
        with open(os.path.join(ddir, "ROUGE_results.txt"),
                  encoding="utf-8") as f:
            written = f.read()
        check(written == rouge.rouge_log(scores, os.path.join(root, "log")),
              "ROUGE_results.txt is not the scores of the written files")
        texts = []
        for fname in sorted(os.listdir(dec)):
            with open(os.path.join(dec, fname), encoding="utf-8") as f:
                texts.append(f.read())
        runs[name] = (scores, texts, launched, steps, wall)
    (scores, texts, launched, steps, wall), (cpu_scores, cpu_texts,
                                             cpu_launched, _, cpu_wall) = (
        runs["card"], runs["cpu"])
    check(len(texts) == 16, f"{len(texts)} decoded files for 16 articles")
    if device == "cuda":
        check(not any(cpu_launched.values()),
              "the CPU decode launched kernels")
        check(steps > 0 and launched == dict(
            dict.fromkeys(launched, 0), fused=2 * steps),
            f"{launched} launches in {steps} beam steps, expected 2 fused "
            f"per step")
    differ = [i for i, (a, b) in enumerate(zip(texts, cpu_texts)) if a != b]
    summary = dict(
        articles=len(texts), beam_steps=steps, launches=launched,
        train_launches=trained["launches"],
        rouge_f={m: scores[m]["f_score"] for m in scores},
        rouge_equal_to_cpu=scores == cpu_scores, files_differing=differ,
        cli_wall_s=wall, cpu_cli_wall_s=cpu_wall)
    print("rouge_decode " + json.dumps(summary))
    check(not differ, f"the card's decoded files {differ} differ from the "
                      f"CPU's")
    check(scores == cpu_scores, "the card's ROUGE differs from rouge_eval "
                                "over the CPU decode")
    # the trained params, for the serve phase's card-vs-CPU check
    return dict(summary, trained_params=params)


class _SaveOnFirstBatch(logging.Handler):
    """Writes a second checkpoint when the decoder logs its first batch,
    as a trainer would while a continuous decoder runs."""

    def __init__(self, save):
        super().__init__()
        self.save, self.batches = save, 0

    def emit(self, record):
        if record.msg.startswith("decoded batch of"):
            self.batches += 1
            if self.batches == 1:
                self.save()


def phase_continuous_decode(seed, work, device="cuda", batches=3):
    """Continuous decode (``--single_pass=0``) of the pointer-generator at
    the reference width through ``cli.run_decode`` with ``max_batches``:
    the streaming batcher reshuffles the 16 articles' chunk file every
    pass; the module's SECS_UNTIL_NEW_CKPT is patched to 0 here and a
    second checkpoint is written when the first batch is decoded.
    Checks: exactly one reload (``decode/ckpt_reloads_total``) onto the
    new checkpoint, attn_vis_data.json with the JAX field layout, no
    ROUGE, and exactly 2 fused launches per beam step.  (device="cpu"
    rehearses the control flow without a card.)"""
    from textsummarization_on_flink_tpu_torch import cli, obs
    from textsummarization_on_flink_tpu_torch.config import HParams
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode import decoder
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params

    hps = main_path_hps("pointer_generator")
    vocab_path, data_path = write_train_chunks(work, hps, seed, 16)
    train_dir = os.path.join(work, "exp", "train")
    _save_params(train_dir, init_numpy_params(hps, hps.vocab_size, seed), 0)
    dhps = HParams.from_argv(_decode_flags(
        hps, single_pass=0, data_path=data_path, vocab_path=vocab_path,
        log_root=work, device=device))
    handler = _SaveOnFirstBatch(
        lambda: _save_params(train_dir, init_numpy_params(
            hps, hps.vocab_size, seed + 1), 1))
    dec_log = logging.getLogger(decoder.__name__)
    level, interval = dec_log.level, decoder.SECS_UNTIL_NEW_CKPT
    dec_log.setLevel(logging.INFO)
    dec_log.addHandler(handler)
    decoder.SECS_UNTIL_NEW_CKPT = 0
    reg = obs.Registry()
    try:
        with obs.use_registry(reg):
            reset_launch_counts()
            beam_search.steps_run = 0
            t0 = time.perf_counter()
            dec = cli.run_decode(dhps, Vocab(vocab_path, hps.vocab_size),
                                 max_batches=batches)
            wall = time.perf_counter() - t0
            launched, steps = launch_counts(), beam_search.steps_run
    finally:
        decoder.SECS_UNTIL_NEW_CKPT = interval
        dec_log.removeHandler(handler)
        dec_log.setLevel(level)
    reloads = reg.counter("decode/ckpt_reloads_total").value
    ckpt = dec._params_snapshot()[1]
    ddir = os.path.join(work, "exp", "decode")
    with open(os.path.join(ddir, "attn_vis_data.json"),
              encoding="utf-8") as f:
        vis = json.load(f)
    check(handler.batches == batches, f"{handler.batches} batches decoded, "
                                      f"expected {batches}")
    check(reloads == 1 and ckpt.endswith("model.ckpt-1.npz"),
          f"{reloads} reloads, decoding from {ckpt}")
    check(set(vis) == {"article_lst", "decoded_lst", "abstract_str",
                       "attn_dists", "p_gens"}
          and len(vis["attn_dists"]) == len(vis["p_gens"])
          == max(len(vis["decoded_lst"]), 1),
          "attn_vis_data.json lacks the JAX field layout")
    check(dec.rouge_results is None and not os.path.exists(
        os.path.join(ddir, "reference")), "a continuous decode scored ROUGE")
    if device == "cuda":
        check(steps > 0 and launched == dict(
            dict.fromkeys(launched, 0), fused=2 * steps),
            f"{launched} launches in {steps} beam steps, expected 2 fused "
            f"per step")
    summary = dict(batches=handler.batches, reloads=reloads,
                   checkpoint=os.path.basename(ckpt), beam_steps=steps,
                   launches=launched, attn_vis_words=len(vis["decoded_lst"]),
                   cli_wall_s=wall)
    print("continuous_decode " + json.dumps(summary))
    return summary


#: the transformer whose head dim is 256 (--hidden_dim=512
#: --num_heads=2): its flash kernels split the output's columns over two
#: blocks; depth cut to 2 + 2 layers (FFN 4 x 512) so that the CPU
#: reference runs stay short
HD256_WIDTHS = dict(hidden_dim=512, num_heads=2, enc_layers=2, dec_layers=2,
                    ffn_dim=2048)
#: head dim 512 at the transformer's full depth (6 + 6 layers; the wide
#: kernels): --hidden_dim=512 --num_heads=1, FFN 4 x 512
HD512_WIDTHS = dict(hidden_dim=512, num_heads=1, ffn_dim=2048)
#: head dim 320 (padded to 384 on the card) at 2 + 2 layers
HD320_WIDTHS = dict(hidden_dim=640, num_heads=2, enc_layers=2, dec_layers=2,
                    ffn_dim=2560)
#: the bf16 flags of the head-dim-512 runs (phase_transformer_bf16's)
HD512_BF16_FLAGS = dict(compute_dtype="bfloat16", loss_chunk=10)
#: head dim 1152: the forward's, dK/dV's and dQ's 9-block clusters;
#: --hidden_dim=1152 --num_heads=1, FFN 4 x 1152 (on the card at
#: HD1152_CUT's depth)
HD1152_WIDTHS = dict(hidden_dim=1152, num_heads=1, ffn_dim=4608)
#: head dim 2304 at the transformer's full depth (6 + 6 layers, about 1.0
#: B parameters): the forward's, dK/dV's and dQ's multi-slab clusters (9
#: blocks of 2 slabs); --hidden_dim=2304 --num_heads=1, FFN 4 x 2304
HD2304_WIDTHS = dict(hidden_dim=2304, num_heads=1, ffn_dim=9216)
#: the depth of the head-dim-1152 path on the card (its decode and its 3
#: train steps a dtype, the first of which is held to the CPU's step) and
#: of the head-dim-2304 train steps held to the CPU's: CPU steps at full
#: depth and these widths do not fit the script's time (the hidden-1200
#: pointer-generator's full-depth CPU step took 102.6 s)
HD1152_CUT = dict(enc_layers=2, dec_layers=2, max_dec_steps=20,
                  min_dec_steps=5)
#: the head-dim-2304 card-against-CPU step's depth: HD1152_CUT and 100
#: encoder steps (at 400 the CPU's bf16 step took 52.3 s and the f32 one
#: 17.2 s on an H100 host, PERF.md); the kernels' forms depend on the
#: head dim alone, so the card twin still takes the multi-slab forms
HD2304_CPU_CUT = dict(HD1152_CUT, max_enc_steps=100)


def wide_cpu_steps():
    """phase_wide_widths' --device=cpu reference train steps: {name:
    (family, flags)}, one step each at --single_pass=1, so that each
    takes the first batch its card run of the same name (``_card`` for
    ``_cpu``) takes.  The hidden-1200 pointer-generator's depth is cut to
    100 encoder and 10 decoder steps: at 400 and 100 the CPU's step took
    102.6 s of the script's time limit on an H100 host, at 400 and 20
    45-59 s (PERF.md); the backward's form depends on D alone, so the
    card twin still takes the slab backward.  The head-dim-1152
    transformer's depth is cut to HD1152_CUT, the head-dim-2304 one's to
    HD2304_CPU_CUT."""
    pg, tf = "pointer_generator", "transformer"
    return {
        "pg_h1200_train_cpu": (pg, dict(hidden_dim=1200, single_pass=1,
                                        max_enc_steps=100, max_dec_steps=10,
                                        min_dec_steps=5)),
        "hd256_train_cpu": (tf, dict(HD256_WIDTHS, single_pass=1)),
        "hd512_train_f32_cpu": (tf, dict(HD512_WIDTHS, single_pass=1)),
        "hd512_train_bf16_cpu": (tf, dict(HD512_WIDTHS, single_pass=1,
                                          **HD512_BF16_FLAGS)),
        "hd320_train_cpu": (tf, dict(HD320_WIDTHS, single_pass=1)),
        "hd1152_train_f32_cpu": (tf, dict(HD1152_WIDTHS, single_pass=1,
                                          **HD1152_CUT)),
        "hd1152_train_bf16_cpu": (tf, dict(HD1152_WIDTHS, single_pass=1,
                                           **HD1152_CUT,
                                           **HD512_BF16_FLAGS)),
        "hd2304_train_f32_cpu": (tf, dict(HD2304_WIDTHS, single_pass=1,
                                          **HD2304_CPU_CUT)),
        "hd2304_train_bf16_cpu": (tf, dict(HD2304_WIDTHS, single_pass=1,
                                           **HD2304_CPU_CUT,
                                           **HD512_BF16_FLAGS))}


def _cpu_step(seed, name, family, extra, cores=None):
    """One step of wide_cpu_steps (phase_train_main_path with
    --device=cpu in .smoke_work/<name>), this process held to ``cores``
    (a thread each), its printed lines captured: (summary, the lines)."""
    import contextlib
    import io

    import torch

    if cores:
        os.sched_setaffinity(0, cores)
        torch.set_num_threads(len(cores))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = _in_work(name, lambda w: phase_train_main_path(
            seed, w, steps=1, device="cpu", family=family, extra=extra,
            expect_kernels=False))
    return out, text.getvalue()


class CpuSteps:
    """wide_cpu_steps run one after another in a child process (spawned:
    no CUDA state) held to all but one of this machine's cores, beside the
    kernel builds and the kernel phases (their numbers CUDA-event times);
    wait() blocks until every step is done, so that no phase that prints
    a host time runs beside the child.  With ``background=False`` each
    step runs here when it is read.  result(name) is a step's
    phase_train_main_path summary, its printed lines printed then;
    close() cancels the steps not started and waits for the child."""

    def __init__(self, seed, background=True):
        import multiprocessing

        self.seed, self.steps = seed, wide_cpu_steps()
        self._pool, self._futures, self._cores = None, {}, None
        if background:
            cores = sorted(os.sched_getaffinity(0))
            self._cores = cores[1:] or cores
            self._pool = concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn"))
            self._futures = {
                name: self._pool.submit(_cpu_step, seed, name, family,
                                        extra, self._cores)
                for name, (family, extra) in self.steps.items()}

    def wait(self, beside):
        """Block until every step is done; print which phases ran beside
        the child (``beside``), on how many cores, and the wait."""
        t0 = time.perf_counter()
        concurrent.futures.wait(list(self._futures.values()))
        print("cpu_reference_steps " + json.dumps(dict(
            steps=list(self._futures), ran_beside=beside,
            child_cores=len(self._cores or ()),
            wait_s=time.perf_counter() - t0)))

    def result(self, name):
        if self._pool is None:
            family, extra = self.steps[name]
            out, text = _cpu_step(self.seed, name, family, extra)
        else:
            out, text = self._futures[name].result()
        sys.stdout.write(text)
        return out

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)


def phase_wide_widths(seed, device="cuda", cpu_steps=None):
    """The widths the card refused before, each on a main path with its
    launch counts set to 0 just before and read just after (and the
    pointer-generator at hidden_dim 1200 on the slab forms):

      * the pointer-generator at hidden_dim 400 (D 800): a beam decode of
        16 articles through cli.main (2 fused launches per beam step) and
        at hidden_dim 430 (D 860) one train step (100 + 100 fused
        launches);
      * the transformer at --hidden_dim=512 --num_heads=2 (head dim 256):
        the beam search of phase_small_reference at that width on the
        card against the CPU (the same tokens); a decode of 8 articles
        through cli.main at HD256_WIDTHS (one flash forward per encoder
        layer per batch); one train step (--single_pass=1) through
        cli.main on the card and with --device=cpu, the losses within
        1e-4 relative (one forward, dK/dV and dQ per layer).

    The --device=cpu reference steps of this phase and of
    phase_wide_heads are ``cpu_steps`` (CpuSteps: run in a child process
    beside the kernel builds and phases, done before the main paths), or
    run here when it is None.
    (device="cpu" rehearses the control flow without a card.)"""
    pg, tf = "pointer_generator", "transformer"
    if cpu_steps is None:
        cpu_steps = CpuSteps(seed, background=False)
    steps = cpu_steps.steps
    out = dict(
        pg_decode=_in_work("pg_h400", lambda w: phase_main_path(
            seed, 16, w, device=device, family=pg,
            widths=dict(hidden_dim=400))),
        pg_train=_in_work("pg_h430", lambda w: phase_train_main_path(
            seed, w, steps=1, device=device, family=pg,
            extra=dict(hidden_dim=430))))
    # past the fused kernels' dense forms: hidden_dim 1200, D
    # 2400, which the card refused before (1,116 at beam 4, 1,154 in
    # training): a beam decode of 8 articles on the slab forward, and one
    # train step (--single_pass=1: the same batch on both) on the dense
    # forward at K = 1 and the slab backward, its loss against
    # --device=cpu within 1e-4 relative (wide_cpu_steps: 100 encoder and
    # 10 decoder steps)
    out["pg_h1200_decode"] = _in_work("pg_h1200", lambda w: phase_main_path(
        seed, 8, w, device=device, family=pg, widths=dict(hidden_dim=1200)))
    out["pg_h1200_train_card"] = _in_work(
        "pg_h1200_train_card", lambda w: phase_train_main_path(
            seed, w, steps=1, device=device, family=pg,
            extra=steps["pg_h1200_train_cpu"][1]))
    out["pg_h1200_train_cpu"] = cpu_steps.result("pg_h1200_train_cpu")
    card_loss, cpu_loss = (out[f"pg_h1200_train_{n}"]["losses"][0]
                           for n in ("card", "cpu"))
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print("pg_hidden_1200 " + json.dumps(dict(
        card_loss=card_loss, cpu_loss=cpu_loss, loss_rel_diff=rel,
        decode_launches=out["pg_h1200_decode"]["kernel_launches"],
        decode_slab_launches=out["pg_h1200_decode"]["slab_launches"],
        train_launches=out["pg_h1200_train_card"]["launches"])))
    check(rel <= 1e-4, f"hidden_dim 1200: the card's loss differs from the "
                       f"CPU's by {rel} (relative)")
    if device == "cuda":  # the same tokens as the CPU's at head dim 256
        phase_small_reference(seed, tf, widths=dict(hidden_dim=512,
                                                    num_heads=2))
    out["hd256_decode"] = _in_work("hd256", lambda w: phase_main_path(
        seed, 8, w, device=device, family=tf, widths=HD256_WIDTHS))
    out["hd256_train_card"] = _in_work(
        "hd256_train_card", lambda w: phase_train_main_path(
            seed, w, steps=1, device=device, family=tf,
            extra=steps["hd256_train_cpu"][1]))
    out["hd256_train_cpu"] = cpu_steps.result("hd256_train_cpu")
    card_loss, cpu_loss = (out[f"hd256_train_{n}"]["losses"][0]
                           for n in ("card", "cpu"))
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print("head_dim_256 " + json.dumps(dict(
        card_loss=card_loss, cpu_loss=cpu_loss, loss_rel_diff=rel)))
    check(rel <= 1e-4, f"head dim 256: the card's loss differs from the "
                       f"CPU's by {rel} (relative)")
    out.update(phase_wide_heads(seed, device, cpu_steps))
    return out


def phase_wide_heads(seed, device="cuda", cpu_steps=None):
    """Head dims above 256, which the card refused before the wide
    kernels (kernels/flash_attention_wide.cu), each run with its launch
    counts set to 0 just before and read just after:

      * head dim 512 at full width (HD512_WIDTHS: 6 + 6 layers, V 50k,
        400/100 steps, batch 16, beam 4, coverage): a decode of 16
        articles through cli.main (6 wide forward launches per batch),
        3 train steps (--single_pass=1) through cli.main on the card
        (12 wide forward, dK/dV and dQ launches per step, none of the
        32/128/256 forms) and one with --device=cpu, the first losses
        within 1e-4 relative; the same under HD512_BF16_FLAGS (every
        launch the wide kernels' bf16 form), the card's first loss within
        4 times the CPU's own bf16-to-f32 distance of the CPU's bf16 loss
        (the rule of the CPU tests against the JAX package) plus 1e-5
        relative;
      * head dim 320 (HD320_WIDTHS, padded to 384): the small beam search
        on the card against the CPU (phase_small_reference, the same
        tokens) and one train step on the card and with --device=cpu,
        the losses within 1e-4 relative;
      * head dim 1152 at HD1152_WIDTHS' widths and HD1152_CUT's depth
        (2 + 2 layers): a decode of 16 articles through cli.main (2 wide
        forward launches per batch, every one the 9-block cluster form),
        3 train steps on the card in f32 and 3 under HD512_BF16_FLAGS (4
        forward, 4 dK/dV and 4 dQ launches per step, all of the cluster
        forms), the first step's loss held to the CPU's in both dtypes,
        with head dim 512's bounds;
      * head dim 2304 (HD2304_WIDTHS): a decode of 16 articles at full
        depth (6 + 6 layers, about 1.0 B parameters; 6 wide forward
        calls per batch, every one the multi-slab cluster form of 2
        slabs a block, so 12 launches), and 3 train steps in f32 and 3
        under HD512_BF16_FLAGS at HD2304_CPU_CUT's depth (4 forward, 4
        dK/dV and 4 dQ calls per step, each of the multi-slab forms: 8
        launches each), the first step's loss held to the CPU's in both
        dtypes.

    The --device=cpu reference steps are ``cpu_steps``' (CpuSteps; run
    here when it is None).  (device="cpu" rehearses the control flow
    without a card.)"""
    tf = "transformer"
    if cpu_steps is None:
        cpu_steps = CpuSteps(seed, background=False)
    steps = cpu_steps.steps
    out = dict(hd512_decode=_in_work("hd512", lambda w: phase_main_path(
        seed, 16, w, device=device, family=tf, widths=HD512_WIDTHS)))
    for tag in ("f32", "bf16"):
        # 3 steps on the card, the first against the CPU's one
        out[f"hd512_train_{tag}_card"] = _in_work(
            f"hd512_train_{tag}_card", lambda w: phase_train_main_path(
                seed, w, steps=3, device=device, family=tf,
                extra=steps[f"hd512_train_{tag}_cpu"][1]))
    if device == "cuda":
        phase_small_reference(seed, tf, widths=dict(hidden_dim=640,
                                                    num_heads=2))
    out["hd320_train_card"] = _in_work(
        "hd320_train_card", lambda w: phase_train_main_path(
            seed, w, steps=1, device=device, family=tf,
            extra=steps["hd320_train_cpu"][1]))
    # head dim 1152 at HD1152_CUT's depth: the 3-step runs are the CPU
    # steps' card twins (the same flags), their first loss held to the
    # CPU's
    out["hd1152_decode"] = _in_work("hd1152", lambda w: phase_main_path(
        seed, 16, w, device=device, family=tf,
        widths=dict(HD1152_WIDTHS, **HD1152_CUT)))
    for tag in ("f32", "bf16"):
        out[f"hd1152_train_{tag}_card"] = _in_work(
            f"hd1152_train_{tag}_card", lambda w: phase_train_main_path(
                seed, w, steps=3, device=device, family=tf,
                extra=steps[f"hd1152_train_{tag}_cpu"][1]))
    # head dim 2304: the decode at full depth; the 3-step runs at
    # HD2304_CPU_CUT's depth are the CPU steps' card twins, as at 1152
    out["hd2304_decode"] = _in_work("hd2304", lambda w: phase_main_path(
        seed, 16, w, device=device, family=tf, widths=HD2304_WIDTHS))
    for tag in ("f32", "bf16"):
        out[f"hd2304_train_{tag}_card"] = _in_work(
            f"hd2304_train_{tag}_card", lambda w: phase_train_main_path(
                seed, w, steps=3, device=device, family=tf,
                extra=steps[f"hd2304_train_{tag}_cpu"][1]))
    for name in ("hd512_train_f32_cpu", "hd512_train_bf16_cpu",
                 "hd320_train_cpu", "hd1152_train_f32_cpu",
                 "hd1152_train_bf16_cpu", "hd2304_train_f32_cpu",
                 "hd2304_train_bf16_cpu"):
        out[name] = cpu_steps.result(name)
    first = {k: v["losses"][0] for k, v in out.items() if "_train_" in k}
    rel = {k: abs(first[f"{k}_card"] - first[f"{k}_cpu"])
           / abs(first[f"{k}_cpu"])
           for k in ("hd512_train_f32", "hd512_train_bf16", "hd320_train",
                     "hd1152_train_f32", "hd1152_train_bf16",
                     "hd2304_train_f32", "hd2304_train_bf16")}
    bf16_bound = {}
    for hd in ("hd512", "hd1152", "hd2304"):
        bf16_loss = first[f"{hd}_train_bf16_cpu"]
        bf16_gap = abs(bf16_loss - first[f"{hd}_train_f32_cpu"])
        bf16_bound[hd] = (4 * bf16_gap + 1e-5 * abs(bf16_loss)) \
            / abs(bf16_loss)
    print("wide_heads " + json.dumps(dict(
        first_losses=first, loss_rel_diff=rel, bf16_rel_bound=bf16_bound,
        decode_wide_launches_per_batch={
            hd: out[f"{hd}_decode"]["launches_per_batch"]
            for hd in ("hd512", "hd1152", "hd2304")},
        decode_cluster_launches={
            hd: out[f"{hd}_decode"]["wide_cluster_launches"]
            for hd in ("hd512", "hd1152", "hd2304")},
        train_launches_per_step={k: v["launches_per_step"]
                                 for k, v in out.items()
                                 if k.endswith("_card")},
        step_seconds={k: v["step_seconds"] for k, v in out.items()
                      if k.endswith("_card")})))
    check(all(rel[k] <= 1e-4 for k in ("hd512_train_f32", "hd320_train",
                                       "hd1152_train_f32",
                                       "hd2304_train_f32")),
          f"wide heads: the card's f32 losses differ from the CPU's by "
          f"{rel} (relative)")
    for hd in ("hd512", "hd1152", "hd2304"):
        check(rel[f"{hd}_train_bf16"] <= bf16_bound[hd],
              f"{hd} in bf16: the card's loss differs from the CPU's by "
              f"{rel[f'{hd}_train_bf16']} (relative), above "
              f"{bf16_bound[hd]}")
    return out


def _serve_latencies(reg):
    """The serve layer's end-to-end metrics of one run, from its
    registry: e2e latency p50/p99, time in queue p50 (estimates within
    the histograms' factor-2 buckets), the mean fill."""
    e2e = reg.histogram("serve/e2e_latency_seconds")
    fill = reg.histogram("serve/batch_fill")
    # percentile() takes q in [0, 100] and interpolates in the bucket
    return dict(
        e2e_p50_s=e2e.percentile(50), e2e_p99_s=e2e.percentile(99),
        queue_p50_s=reg.histogram("serve/time_in_queue_seconds")
        .percentile(50),
        mean_fill=fill.mean, dispatches=fill.count)


def phase_serve(seed, work, params, device="cuda"):
    """The micro-batch ``ServingServer`` (serve/server.py) at the reference
    width (main_path_hps: H 256, E 128, V 50,000, 400/100 steps, min 35,
    beam 4, batch 16, coverage on, f32) over ``params`` (the ROUGE
    phase's checkpoint, trained 4 steps from --seed: a random model's
    near-uniform scores leave its beams to rounding) and the phase's
    synthetic articles, each part with the launch counts set to 0 just
    before and read just after:

      a. one pinned group: 16 articles submitted before start(), one
         serve bucket at max_enc_steps, so the first dispatch takes all
         16; every summary equals a CPU ServingServer's (device="cpu"),
         token for token;
      b. 32 articles from 8 threads: each future resolves exactly once
         with its own uuid, the mean of serve/batch_fill is above 1;
      c. after those warm full-beam dispatches, a request whose budget
         (decode_deadline_secs) is half the decoder's full-beam estimate
         is re-tiered to greedy: serve/degraded_total rises and its
         summary equals decode_batch(tier="greedy") of the same batch;
      d. ``App.start_inference(serving=True)`` at the App's decode
         defaults (batch 4) writes one row per input row for 16 rows.

    Every part launches the fused attention exactly twice per beam step
    (greedy: K = 1).  Prints e2e latency p50/p99 and time in queue p50
    (the server's histograms), the callers' exact e2e p50/p99 in (b),
    the mean fill and requests/s of (b).  (device="cpu" rehearses the control
    flow without a card.)"""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from textsummarization_on_flink_tpu_torch import obs
    from textsummarization_on_flink_tpu_torch.data.batching import (
        SummaryExample,
    )
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode.decoder import (
        BeamSearchDecoder,
    )
    from textsummarization_on_flink_tpu_torch.pipeline import app as app_lib
    from textsummarization_on_flink_tpu_torch.pipeline import estimator
    from textsummarization_on_flink_tpu_torch.pipeline import io
    from textsummarization_on_flink_tpu_torch.serve import (
        MicroBatcher,
        RequestQueue,
        ServeRequest,
    )
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )

    hps = main_path_hps("pointer_generator")
    hps = hps.replace(mode="decode", device=device,
                      serve_buckets=str(hps.max_enc_steps))
    words = synthetic_words(hps.vocab_size)
    vocab = Vocab(words=words)
    summary = {}

    def counted(fn):
        """fn() with the launch counts set to 0 just before; returns
        (result, fused launches, beam steps, other launches, seconds)."""
        reset_launch_counts()
        beam_search.steps_run = 0
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        launched = launch_counts()
        fused = launched.pop("fused")
        return out, fused, beam_search.steps_run, launched, dt

    def check_launches(part, fused, steps, others, dev):
        if dev != "cuda":
            return
        check(steps > 0 and fused == 2 * steps,
              f"serve {part}: {fused} fused launches in {steps} beam steps "
              f"(expected 2 per step)")
        check(not any(others.values()),
              f"serve {part}: other kernels launched: {others}")

    # (a) one pinned group, on the card and on the CPU
    rows = pipeline_rows(seed + 2, words, 16, start=200)

    def pinned(dev):
        reg = obs.Registry()
        server = ServingServer(hps.replace(device=dev), vocab, params=params,
                               decode_root=os.path.join(work, "a_" + dev),
                               registry=reg)
        futs = [server.submit(art, uuid=u, reference=ref)
                for u, art, _, ref in rows]
        with server:
            return {f.uuid: f.result(timeout=900).decoded_words
                    for f in futs}, reg

    (card, reg_a), fused, steps, others, card_s = counted(
        lambda: pinned(device))
    check_launches("a", fused, steps, others, device)
    (cpu, _), _, _, _, cpu_s = counted(lambda: pinned("cpu"))
    fill = reg_a.histogram("serve/batch_fill")
    check((fill.count, fill.sum) == (1, 16.0),
          f"the pinned group took {fill.count} dispatches")
    differ = sorted(u for u in card if card[u] != cpu[u])
    check(len(card) == 16 and all(card.values()), "an empty summary")
    check(not differ, f"card summaries differ from the CPU server's for "
                      f"{differ}")
    summary["pinned"] = dict(articles=16, seconds=card_s, cpu_seconds=cpu_s,
                             launches=fused, beam_steps=steps,
                             **_serve_latencies(reg_a))

    # (b) 32 concurrent requests from 8 threads
    rows_b = pipeline_rows(seed + 3, words, 32, start=300)
    dec = BeamSearchDecoder(hps.replace(single_pass=False), vocab, None,
                            params=params,
                            decode_root=os.path.join(work, "b"))
    reg_b = obs.Registry()
    server = ServingServer(hps, vocab, decoder=dec, registry=reg_b)
    resolutions, waits, lock = {}, [], threading.Lock()

    def submit(row):
        """One caller: submit, and note when its future resolves (the
        exact e2e latency the caller sees; the server's histogram keeps
        bucket counts only)."""
        t0 = time.perf_counter()
        fut = server.submit(row[1], uuid=row[0], reference=row[3])

        def note(f):
            with lock:
                resolutions[f.uuid] = resolutions.get(f.uuid, 0) + 1
                waits.append(time.perf_counter() - t0)

        fut.add_done_callback(note)
        return fut

    def concurrent():
        with server:
            with ThreadPoolExecutor(max_workers=8) as ex:
                futs = list(ex.map(submit, rows_b))
            return [(f.uuid, f.result(timeout=900)) for f in futs]

    results, fused, steps, others, conc_s = counted(concurrent)
    check_launches("b", fused, steps, others, device)
    check(all(u == r.uuid for u, r in results) and len(results) == 32,
          "a future resolved with another request's result")
    check(resolutions == {r[0]: 1 for r in rows_b},
          "not every future resolved exactly once")
    lat_b = _serve_latencies(reg_b)
    check(lat_b["mean_fill"] > 1.0,
          f"mean fill {lat_b['mean_fill']}: no request coalesced")
    summary["concurrent"] = dict(
        requests=32, threads=8, seconds=conc_s, requests_per_s=32 / conc_s,
        launches=fused, beam_steps=steps,
        caller_e2e_p50_s=float(np.percentile(waits, 50)),
        caller_e2e_p99_s=float(np.percentile(waits, 99)), **lat_b)

    # (c) a budget below the warm full-beam estimate degrades to greedy
    check(dec._beam_secs is not None,
          "no full-beam latency estimate after the warm dispatches")
    budget = 0.5 * dec._beam_secs
    reg_c = obs.Registry()
    tight = ServingServer(
        hps.replace(decode_deadline_secs=budget, serve_max_wait_ms=0.0),
        vocab, decoder=dec, registry=reg_c)
    u, art, _, ref = rows_b[0]

    def degraded():
        with tight:
            return tight.submit(art, uuid="tight-" + u,
                                reference=ref).result(timeout=900)

    res, fused, steps, others, deg_s = counted(degraded)
    check_launches("c", fused, steps, others, device)
    check(res.degraded and res.tier == "greedy",
          f"the tight request ran at {res.tier} (degraded={res.degraded})")
    check(reg_c.counter("serve/degraded_total").value == 1,
          "serve/degraded_total did not rise")
    ex = SummaryExample.build(art, [], vocab, hps, uuid="tight-" + u,
                              reference=ref)
    batch = MicroBatcher(hps, vocab, RequestQueue(4),
                         registry=obs.Registry()).build(
        [ServeRequest("tight-" + u, art, ref, ex)])
    want = dec.decode_batch(batch, tier="greedy")[0]
    check(res.decoded_words == want.decoded_words,
          "the degraded summary differs from decode_batch(tier=greedy)")
    summary["deadline"] = dict(budget_s=budget, beam_estimate_s=dec._beam_secs,
                               seconds=deg_s, launches=fused,
                               beam_steps=steps, words=len(res.decoded_words))

    # (d) the App's inference job through the serve layer
    train_hps, infer_hps = pipeline_hps(work, seed, device)
    _save_params(estimator.train_dir_for(infer_hps), params, 4)
    rows_d = pipeline_rows(seed + 4, words, 16, start=400)
    app = app_lib.App(train_hps, infer_hps, vocab=vocab)
    reg_d = obs.Registry()

    def app_serving():
        with obs.use_registry(reg_d):
            return app.start_inference(source=io.CollectionSource(rows_d),
                                       sink=io.CollectionSink(),
                                       serving=True)

    sink, fused, steps, others, app_s = counted(app_serving)
    check_launches("d", fused, steps, others, device)
    check(len(sink.rows) == 16 and sorted(r[0] for r in sink.rows)
          == sorted(r[0] for r in rows_d),
          f"{len(sink.rows)} rows out for 16 in, or other uuids")
    check(all(r[2] for r in sink.rows), "an empty summary")
    summary["app"] = dict(rows=len(sink.rows), seconds=app_s,
                          launches=fused, beam_steps=steps,
                          **_serve_latencies(reg_d))
    summary["launches"] = sum(summary[k]["launches"] for k in (
        "pinned", "concurrent", "deadline", "app"))
    summary["card"] = card_line() if device == "cuda" else None
    print("serve " + json.dumps(summary))
    return summary


def bimodal_rows(seed, words, n_short, n_long):
    """(uuid, article, summary, reference) rows: n_short articles of
    50-120 zipf-ranked words and n_long of 300-400 (~5% OOVs), shuffled
    together; the reference is the first 12 words."""
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(50, 121)) for _ in range(n_short)] + \
        [int(rng.integers(300, 401)) for _ in range(n_long)]
    rng.shuffle(lens)
    rows = []
    for i, n in enumerate(lens):
        ranks = np.minimum(rng.zipf(1.2, n), len(words)) - 1
        art = [words[r] if rng.random() > 0.05 else f"oov{rng.integers(50)}"
               for r in ranks]
        rows.append((f"bimodal-{i}", " ".join(art) + " .", "",
                     " ".join(art[:12]) + " ."))
    return rows


#: the continuous phase's slot engine: 16 slots, the serve buckets, the
#: length bound's block
CONTINUOUS_FLAGS = dict(serve_mode="continuous", serve_slots=16,
                        serve_buckets="100,200,400", decode_enc_block=64)


def phase_continuous_serve(seed, work, params, tf_params, device="cuda"):
    """The continuous ``ServingServer`` (serve_mode=continuous: the slot
    engine of decode/decoder.py) at the reference width, pointer-generator
    (main_path_hps, f32, coverage on) over ``params`` (the ROUGE phase's
    trained checkpoint), CONTINUOUS_FLAGS; 32 requests from 8 threads, a
    bimodal mix of 16 articles of 50-120 words and 16 of 300-400.  Each
    run with the launch counts set to 0 just before and read just after:

      a. every request resolves exactly once, with its own uuid;
      b. the summaries equal, token for token, a micro-batch server's
         (same buckets) on the same 32 articles;
      c. every chunk launches the fused attention exactly twice per
         decode step (counted chunk by chunk) and nothing else launches;
      d. again with serve_arena_pages=56 (half of 16 slots x 7 pages):
         serve/arena_alloc_failures_total rises (backpressure), the
         summaries are the same;
      e. the transformer at its reference width over ``tf_params`` (the
         train phase's checkpoint): 8 requests, summaries equal to its
         micro-batch server's.

    Prints e2e p50/p99, time in queue p50, requests/s, mean slot
    occupancy and resident bytes per slot (the mean over chunks) of the
    dense and the paged runs, beside the micro-batch run's numbers, and
    each run's dispatch-thread seconds by phase (the phase ledger)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from textsummarization_on_flink_tpu_torch import obs
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.obs import profile as profile_lib
    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )

    words = synthetic_words(main_path_hps("pointer_generator").vocab_size)
    vocab = Vocab(words=words)
    rows = bimodal_rows(seed + 5, words, 16, 16)
    summary = {}

    def serve(hps, prm, rows_in, name):
        """rows_in from 8 threads through one server; returns the words
        by uuid and the run's numbers."""
        reg = obs.Registry()
        server = ServingServer(hps, vocab, params=prm,
                               decode_root=os.path.join(work, name),
                               registry=reg)
        engine = server._cont._engine if server._cont is not None else None
        chunks, resident, avg_lp = [], [], {}
        if engine is not None:
            step, unpack, lead = engine.step, engine.unpack, engine._lead

            def counted_step():
                f0, s0 = fa.launches, beam_search.steps_run
                out = step()
                chunks.append((fa.launches - f0, beam_search.steps_run - s0))
                resident.append(engine.resident_bytes_per_slot())
                return out

            def scored_unpack(idx, example):
                """unpack, keeping the hypothesis' average log-prob."""
                got = []

                def kept(*cmd):
                    got.append(lead(*cmd))
                    return got[-1]

                engine._lead = kept
                try:
                    res = unpack(idx, example)
                finally:
                    engine._lead = lead
                avg_lp[example.uuid] = float(got[-1].avg_log_prob)
                return res

            engine.step = counted_step
            engine.unpack = scored_unpack
        resolved, waits, lock = {}, [], threading.Lock()

        def submit(row):
            t0 = time.perf_counter()
            fut = server.submit(row[1], uuid=row[0], reference=row[3])

            def note(f):
                with lock:
                    resolved[f.uuid] = resolved.get(f.uuid, 0) + 1
                    waits.append(time.perf_counter() - t0)

            fut.add_done_callback(note)
            return fut

        reset_launch_counts()
        beam_search.steps_run = 0
        t0 = time.perf_counter()
        with server:
            with ThreadPoolExecutor(max_workers=8) as ex:
                futs = list(ex.map(submit, rows_in))
            results = [(f.uuid, f.result(timeout=900)) for f in futs]
        secs = time.perf_counter() - t0
        launched = launch_counts()
        check(all(u == r.uuid for u, r in results),
              f"{name}: a future resolved with another request's result")
        check(resolved == {r[0]: 1 for r in rows_in},
              f"{name}: not every future resolved exactly once")
        e2e = reg.histogram("serve/e2e_latency_seconds")
        occ = reg.histogram("serve/slot_occupancy")
        out = dict(
            requests=len(rows_in), seconds=secs,
            requests_per_s=len(rows_in) / secs,
            caller_e2e_p50_s=float(np.percentile(waits, 50)),
            caller_e2e_p99_s=float(np.percentile(waits, 99)),
            e2e_p50_s=e2e.percentile(50), e2e_p99_s=e2e.percentile(99),
            queue_p50_s=reg.histogram("serve/time_in_queue_seconds")
            .percentile(50), launches=launched["fused"],
            beam_steps=beam_search.steps_run)
        if engine is None:
            out["mean_fill"] = reg.histogram("serve/batch_fill").mean
        else:
            out.update(
                chunks=len(chunks), chunk_steps=engine.chunk,
                mean_occupancy=occ.mean,
                resident_bytes_per_slot=float(np.mean(resident)),
                paged=engine.paged,
                arena_alloc_failures=reg.counter(
                    "serve/arena_alloc_failures_total").value,
                arena_pages=engine._arena_pages if engine.paged else None,
                avg_log_prob=avg_lp,
                priced=profile_lib.profile_payload(reg)["divergence"])
            if device == "cuda" and hps.model_family == "pointer_generator":
                bad = [c for c in chunks if c[0] != 2 * c[1] or c[1] == 0]
                check(not bad, f"{name}: chunks with other than 2 fused "
                               f"launches per step: {bad[:5]}")
                check(out["launches"] == 2 * out["beam_steps"],
                      f"{name}: {out['launches']} fused launches in "
                      f"{out['beam_steps']} steps")
        out["flash_launches"] = launched["flash_forward"]
        # the dispatch thread's seconds by phase (prefill, pack,
        # dispatch, harvest, ...: the serve layer's phase ledger)
        out["phase_s"] = {p["phase"]: p["total_s"] for p in
                          profile_lib.profile_payload(reg)["phases"]}
        if device == "cuda":
            # the pointer-generator's decode runs the fused attention, the
            # transformer's prefill the flash forward
            mine = ("fused" if hps.model_family == "pointer_generator"
                    else "flash_forward")
            others = {k: v for k, v in launched.items() if v and k != mine}
            check(not others, f"{name}: other kernels launched: {others}")
        words_by_uuid = {u: r.decoded_words for u, r in results}
        check(all(words_by_uuid.values()), f"{name}: an empty summary")
        return words_by_uuid, out

    pg = main_path_hps("pointer_generator").replace(
        mode="decode", device=device, serve_buckets="100,200,400")
    mb, summary["micro_batch"] = serve(pg, params, rows, "mb")
    cont, summary["dense"] = serve(pg.replace(**CONTINUOUS_FLAGS), params,
                                   rows, "dense")
    differ = sorted(u for u in mb if mb[u] != cont[u])
    check(not differ, f"continuous summaries differ from the micro-batch "
                      f"server's for {differ}")
    paged, summary["paged"] = serve(
        pg.replace(serve_arena_pages=56, **CONTINUOUS_FLAGS), params, rows,
        "paged")
    check(summary["paged"]["arena_alloc_failures"] > 0,
          "the paged run never hit arena backpressure")
    differ = sorted(u for u in mb if mb[u] != paged[u])
    check(not differ, f"paged summaries differ from the micro-batch "
                      f"server's for {differ}")
    tf = main_path_hps("transformer").replace(
        mode="decode", device=device, serve_buckets="100,200,400")
    tf_rows = rows[:8]
    tf_mb, summary["transformer_micro_batch"] = serve(tf, tf_params,
                                                      tf_rows, "tf_mb")
    tf_cont, summary["transformer"] = serve(
        tf.replace(**CONTINUOUS_FLAGS), tf_params, tf_rows, "tf_dense")
    differ = sorted(u for u in tf_mb if tf_mb[u] != tf_cont[u])
    check(not differ, f"transformer continuous summaries differ from the "
                      f"micro-batch server's for {differ}")
    # the bf16 decode KV cache (--decode_cache_dtype=bfloat16), priced by
    # the sentinel: JAX's drift envelope against the f32 cache's summaries
    # and the cache's half of the resident bytes
    tf_bf16, summary["transformer_bf16_cache"] = serve(
        tf.replace(decode_cache_dtype="bfloat16", profile_analytic=True,
                   **CONTINUOUS_FLAGS), tf_params, tf_rows, "tf_bf16_cache")
    f32_run, bf16_run = summary["transformer"], summary["transformer_bf16_cache"]
    drift = {u: abs(bf16_run["avg_log_prob"][u] - f32_run["avg_log_prob"][u])
             for u in f32_run["avg_log_prob"]}
    # JAX's envelope (2e-2) on every article whose summary the narrowed
    # cache left as it was; where a near-tie split the beams (a barely
    # trained model's are close), the two runs score different
    # hypotheses, and that drift is reported, not held
    same = [u for u in tf_cont if tf_bf16[u] == tf_cont[u]]
    check(sorted(drift) == sorted(bf16_run["avg_log_prob"])
          and 2 * len(same) >= len(tf_cont)
          and max(drift[u] for u in same) <= 2e-2,
          f"bf16-cache average log-probs drift from the f32 cache's by "
          f"{drift}; equal summaries {same}")
    saved = 2 * tf.beam_size * tf.dec_layers * (tf.max_dec_steps + 1) \
        * tf.hidden_dim * 2
    held = (f32_run["resident_bytes_per_slot"]
            - bf16_run["resident_bytes_per_slot"])
    check(held == saved, f"the bf16 cache holds {held} B less per slot, "
                         f"expected {saved}")
    priced = {(r["site"], r["key"]) for r in bf16_run["priced"]
              if r["samples"] > 0}
    want = {("serve/dispatch", f"slot_chunk{bf16_run['chunk_steps']}")}
    check(want <= priced and any(site == "serve/prefill"
                                 for site, _ in priced),
          f"the bf16-cache server priced {sorted(priced)}")
    summary["bf16_cache"] = dict(
        max_avg_log_prob_drift=max(drift.values()),
        max_drift_equal_summaries=max(drift[u] for u in same),
        equal_summaries=len(same), of=len(tf_cont),
        resident_bytes_saved_per_slot=held)
    if device == "cuda":
        print_sentinel("continuous_bf16_cache", bf16_run["priced"])
    summary["lengths"] = sorted(len(r[1].split()) for r in rows)
    summary["launches"] = sum(summary[k]["launches"] for k in (
        "micro_batch", "dense", "paged"))
    summary["slot_launches"] = sum(summary[k]["launches"] for k in (
        "dense", "paged"))
    summary["flash_launches"] = sum(summary[k]["flash_launches"] for k in (
        "transformer_micro_batch", "transformer", "transformer_bf16_cache"))
    summary["card"] = card_line() if device == "cuda" else None
    print("continuous_serve " + json.dumps(summary))
    # the single server's transformer summaries, for phase_fleet, and its
    # pointer-generator summaries, for phase_mesh's servers
    summary["transformer_words"] = tf_cont
    summary["pg_words"] = cont
    return summary


SPEC_K = 4
#: the narrow draft distilled by phase_distill (BYTE_BUDGET.json
#: spec.ref_overrides: H/2 wide, a rank-64 factored head, one layer)
DISTILL_FLAGS = dict(draft_hidden=128, draft_vocab_rank=64,
                     draft_dec_layers=1)


def _batch_of(hps, vocab, articles):
    from textsummarization_on_flink_tpu_torch.data.batching import (
        Batch,
        SummaryExample,
    )

    exs = [SummaryExample.build(a, [], vocab, hps, uuid=f"s{i}")
           for i, a in enumerate(articles)]
    return Batch(exs, hps, vocab)


def phase_spec(seed, work, tf_params, pg_params, device="cuda"):
    """The speculative tier (decode/speculative.py) at the reference width
    through ``BeamSearchDecoder.decode_batch(tier=...)``, one batch of 16
    synthetic articles, the launch counts set to 0 just before each tier
    and read just after:

      a. the transformer (its train phase's checkpoint, 10 steps; H 256,
         8 heads, 6 + 6 layers, V 50,000, 400/100 steps, min 35, f32):
         greedy, spec with the mapped equal-width AAN draft
         (spec_draft=map, spec_k 4), spec with spec_k_adaptive, and the
         draft tier; every spec row's summary equal to greedy's; exactly
         6 flash forward launches per greedy and per draft batch and 12
         per spec batch (6 in each encoder), and no other kernel;
      b. the pointer-generator (the ROUGE phase's checkpoint) with a
         fresh AAN draft (spec_draft=fresh): spec equal to greedy; the
         greedy batch launches the fused attention twice per beam step,
         the spec batch twice per verify step, (spec_k + 1) verify steps
         per lockstep cycle, and the flash forward 6 times (the draft's
         encoder);
      c. one micro-batch ServingServer over the transformer: 8 greedy
         and 8 spec requests pinned before start(); the spec summaries
         equal the greedy ones.

    Prints each tier's batch seconds, cycles, accept rate, mean tokens
    emitted per cycle and tokens/s.  (device="cpu" rehearses the control
    flow without a card; the launch checks run on the card only.)"""
    from textsummarization_on_flink_tpu_torch import obs
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode import speculative
    from textsummarization_on_flink_tpu_torch.decode.decoder import (
        BeamSearchDecoder,
    )
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )

    words = synthetic_words(main_path_hps("transformer").vocab_size)
    vocab = Vocab(words=words)
    articles = [art for art, _ in synthetic_pairs(
        np.random.default_rng(seed + 5), words, 16)]
    summary = {}

    def run_tiers(hps, params, tiers, family):
        """{tier: result} of decode_batch on one decoder per tier
        group (the adaptive controller is a decoder's own)."""
        out, greedy_words = {}, None
        decoders = {}
        spec_counters = ("decode/spec_cycles_total",
                         "decode/spec_draft_tokens_total",
                         "decode/spec_accepted_tokens_total")
        for name, tier, kw in tiers:
            key = tuple(sorted(kw.items()))
            if key not in decoders:  # each decoder in a registry of its own
                reg = obs.Registry()
                with obs.use_registry(reg):
                    decoders[key] = (BeamSearchDecoder(
                        hps.replace(**kw), vocab, None, params=params,
                        decode_root=os.path.join(work, name)), reg)
            dec, reg = decoders[key]
            before = [reg.counter(c).value for c in spec_counters]
            with obs.use_registry(reg):
                batch = _batch_of(hps, vocab, articles)
                reset_launch_counts()
                beam_search.steps_run = 0
                speculative.cycles_run = 0
                if device == "cuda":
                    torch_sync()
                t0 = time.perf_counter()
                res = dec.decode_batch(batch, tier=tier)
                if device == "cuda":
                    torch_sync()
                dt = time.perf_counter() - t0
                launched = launch_counts()
            tokens = sum(len(r.decoded_words) for r in res)
            row = dict(tier=tier, seconds=dt, tokens=tokens,
                       tokens_per_s=tokens / dt, launches=launched,
                       beam_steps=beam_search.steps_run,
                       lockstep_cycles=speculative.cycles_run)
            if tier == "spec":
                cycles, drafted, accepted = (
                    reg.counter(c).value - b
                    for c, b in zip(spec_counters, before))
                row.update(cycles=cycles, drafted=drafted, accepted=accepted,
                           accept_rate=accepted / drafted if drafted else 0.0,
                           tokens_per_cycle=tokens / cycles if cycles else 0.0,
                           spec_k_final=reg.gauge(
                               "decode/spec_k_current").value)
            words_of = [r.decoded_words for r in res]
            check(len(res) == 16 and all(words_of),
                  f"{family} {name}: an empty summary")
            if tier == "greedy":
                greedy_words = words_of
            elif tier == "spec":
                differ = [i for i, (a, b) in enumerate(zip(words_of,
                                                           greedy_words))
                          if a != b]
                check(not differ, f"{family} {name}: spec rows {differ} "
                                  f"differ from greedy")
            out[name] = row
            print("spec_tier " + json.dumps(dict(family=family, name=name,
                                                 **row)))
        return out

    tf = main_path_hps("transformer").replace(
        mode="decode", device=device, spec_draft="map", spec_k=SPEC_K)
    tf_rows = run_tiers(tf, tf_params, [
        ("greedy", "greedy", {}), ("spec", "spec", {}),
        ("spec_adaptive", "spec", dict(spec_k_adaptive=True)),
        ("draft", "draft", {})], "transformer")
    if device == "cuda":
        for name, want in (("greedy", 6), ("spec", 12), ("spec_adaptive", 12),
                           ("draft", 6)):
            got = tf_rows[name]["launches"]
            others = {k: v for k, v in got.items()
                      if v and k != "flash_forward"}
            check(got["flash_forward"] == want and not others,
                  f"transformer {name}: launches {got}, expected "
                  f"{want} flash forward and nothing else")
    summary["transformer"] = tf_rows

    pg = main_path_hps("pointer_generator").replace(
        mode="decode", device=device, spec_draft="fresh", spec_k=SPEC_K)
    pg_rows = run_tiers(pg, pg_params, [
        ("greedy", "greedy", {}), ("spec", "spec", {})], "pointer_generator")
    if device == "cuda":
        g, sp = pg_rows["greedy"], pg_rows["spec"]
        check(g["launches"]["fused"] == 2 * g["beam_steps"] > 0,
              f"pointer_generator greedy: {g['launches']['fused']} fused "
              f"launches in {g['beam_steps']} steps")
        want = 2 * (SPEC_K + 1) * sp["lockstep_cycles"]
        check(sp["launches"]["fused"] == want > 0
              and sp["launches"]["flash_forward"] == 6,
              f"pointer_generator spec: launches {sp['launches']}, "
              f"expected {want} fused (2 x {SPEC_K + 1} x "
              f"{sp['lockstep_cycles']} lockstep cycles) and 6 flash")
    summary["pointer_generator"] = pg_rows

    # c. the serve layer: greedy and spec requests pinned into one group
    reg = obs.Registry()
    srv_hps = tf.replace(serve_buckets=str(tf.max_enc_steps))
    server = ServingServer(srv_hps, vocab, params=tf_params, registry=reg,
                           decode_root=os.path.join(work, "serve"))
    futs = {(tier, i): server.submit(a, uuid=f"{tier}{i}", tier=tier)
            for tier in ("greedy", "spec") for i, a in
            enumerate(articles[:8])}
    reset_launch_counts()
    t0 = time.perf_counter()
    with server:
        got = {k: f.result(timeout=900).decoded_words
               for k, f in futs.items()}
    serve_s = time.perf_counter() - t0
    differ = [i for i in range(8) if got[("spec", i)] != got[("greedy", i)]]
    check(not differ, f"served spec summaries {differ} differ from greedy")
    check(reg.counter("serve/tier_spec_total").value == 8,
          "the server did not count 8 spec requests")
    summary["serve"] = dict(requests=16, seconds=serve_s,
                            launches=launch_counts())
    summary["launches"] = {
        k: sum(r["launches"][k] for rows in (tf_rows, pg_rows)
               for r in rows.values()) + summary["serve"]["launches"][k]
        for k in ("fused", "flash_forward")}
    summary["card"] = card_line() if device == "cuda" else None
    print("spec " + json.dumps(summary))
    return summary


def torch_sync():
    import torch

    torch.cuda.synchronize()


def phase_distill(seed, work, tf_params, device="cuda", steps=5):
    """Sequence-level distillation (train/distill.py): ``DistillTrainer``
    takes ``steps`` steps of the narrow AAN draft (DISTILL_FLAGS: hidden
    128, a rank-64 factored head, one decoder layer) against the frozen
    full transformer (its train phase's checkpoint) at the reference
    width, on the 64 synthetic pairs of the train phases (4 batches of
    16, each teacher-decoded once), the launch counts set to 0 just
    before and read just after: exactly 6 flash forward, 6 dK/dV and 6
    dQ launches per draft step (its encoder) plus 6 forward per teacher
    decode.  Prints the losses and the acceptance of a spec decode of one
    batch before and after.  Then a small width's step on the card
    against the CPU (the teacher's arrays equal, the loss within 1e-4
    relative), and ``load_distilled_draft`` with the teacher check
    feeding the spec tier, whose summaries equal greedy's.  (device="cpu"
    rehearses the control flow without a card.)"""
    import torch

    from textsummarization_on_flink_tpu_torch import obs
    from textsummarization_on_flink_tpu_torch.checkpoint.checkpointer import (
        Checkpointer,
    )
    from textsummarization_on_flink_tpu_torch.data.batcher import Batcher
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode.decoder import (
        BeamSearchDecoder,
    )
    from textsummarization_on_flink_tpu_torch.params import (
        from_numpy_tree,
        init_numpy_params,
    )
    from textsummarization_on_flink_tpu_torch.train import distill

    hps = train_main_path_hps("transformer").replace(
        device=device, seed=seed, metrics_every=1, **DISTILL_FLAGS)
    vocab_path, data_path = write_train_chunks(work, hps, seed, 64)
    vocab = Vocab(vocab_path, hps.vocab_size)
    batcher = Batcher(data_path, vocab, hps, single_pass=True)
    batches = []
    while True:
        b = batcher.next_batch()
        if b is None:
            break
        batches.append(b)
    check(len(batches) == 4, f"{len(batches)} batches of the 64 pairs")

    class Cycle:
        def __init__(self):
            self.i = 0

        def next_batch(self):
            self.i += 1
            return batches[(self.i - 1) % len(batches)]

    dev = torch.device(device)
    teacher = from_numpy_tree(tf_params, dev)
    held = batches[0].as_arrays()
    reg = obs.Registry()
    log_ = logging.getLogger("textsummarization_on_flink_tpu_torch.train."
                             "distill")
    losses = []

    class _Losses(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("distill step"):
                losses.append(float(record.args[1]))

    handler = _Losses()
    log_.setLevel(logging.INFO)
    log_.addHandler(handler)
    ckpt_dir = os.path.join(work, "draft")
    try:
        with obs.use_registry(reg):
            dt = distill.DistillTrainer(
                hps, hps.vocab_size, Cycle(), teacher,
                checkpointer=Checkpointer(ckpt_dir), cache_teacher=True,
                seed=seed)
            spec_hps = hps.replace(mode="decode", spec_k=SPEC_K)
            before = distill.acceptance_rate(teacher, dt.draft_params(),
                                             spec_hps, held)
            reset_launch_counts()
            if device == "cuda":
                torch_sync()
            t0 = time.perf_counter()
            dt.distill(steps)
            if device == "cuda":
                torch_sync()
            distill_s = time.perf_counter() - t0
            launched = launch_counts()
            after = distill.acceptance_rate(teacher, dt.draft_params(),
                                            spec_hps, held)
    finally:
        log_.removeHandler(handler)
    decodes = reg.histogram("train/distill_teacher_seconds").count
    want = dict.fromkeys(launched, 0)
    want.update(flash_forward=6 * steps + 6 * decodes,
                flash_bwd_dkv=6 * steps, flash_bwd_dq=6 * steps)
    if device == "cuda":
        check(launched == want, f"distillation launched {launched}, "
                                f"expected {want}")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"distillation losses {losses}")
    summary = dict(steps=steps, teacher_decodes=decodes, seconds=distill_s,
                   losses=losses, accept_before=before, accept_after=after,
                   launches=launched)

    # the small width: one step on the card against the CPU
    if device == "cuda":
        small = small_hps("transformer").replace(
            mode="train", draft_hidden=32, draft_vocab_rank=16,
            draft_dec_layers=1)
        p = init_numpy_params(small, small.vocab_size, seed)
        p["embedding"] *= 30.0
        p["out_bias"][3] = 3.0  # STOP
        arrays = small_train_batches(small, seed, 1)[0]

        class One:
            def next_batch(self):
                return _Arrays(arrays)

        runs = {}
        for d in ("cpu", "cuda"):
            sd = small.replace(device=d)
            t_arr = distill.teacher_arrays(from_numpy_tree(p, d), sd, arrays)
            with obs.use_registry(obs.Registry()) as r:
                init = distill.DistillTrainer(sd, small.vocab_size, One(), p,
                                              seed=seed)
                reset_launch_counts()
                init.distill(1)
                runs[d] = (t_arr, r.gauge("train/distill_loss").value,
                           launch_counts())
        same = all(np.array_equal(runs["cpu"][0][k], runs["cuda"][0][k])
                   for k in runs["cpu"][0])
        rel = abs(runs["cuda"][1] - runs["cpu"][1]) / abs(runs["cpu"][1])
        summary["small"] = dict(teacher_arrays_equal=same,
                                cpu_loss=runs["cpu"][1],
                                card_loss=runs["cuda"][1], loss_rel_diff=rel,
                                card_launches=runs["cuda"][2])
        check(not any(runs["cpu"][2].values()), "the CPU step launched a "
                                                "kernel")
        check(runs["cuda"][2]["flash_bwd_dq"] == small.enc_layers,
              f"the card step launched {runs['cuda'][2]}")
        check(same, "the teacher's arrays on the card differ from the CPU's")
        check(rel <= 1e-4, f"card distillation loss differs from the CPU's "
                           f"by {rel}")

    # the distilled draft, loaded with the teacher check, in the spec tier
    draft = distill.load_distilled_draft(ckpt_dir, full_params=teacher,
                                         device=dev)
    dec = BeamSearchDecoder(spec_hps.replace(batch_size=16), vocab, None,
                            params=teacher, draft_params=draft,
                            decode_root=os.path.join(work, "decode"))
    greedy = dec.decode_batch(batches[1], tier="greedy")
    spec = dec.decode_batch(batches[1], tier="spec")
    differ = [i for i, (a, b) in enumerate(zip(spec, greedy))
              if a.decoded_words != b.decoded_words]
    check(not differ, f"the distilled draft's spec rows {differ} differ "
                      f"from greedy")
    summary["card"] = card_line() if device == "cuda" else None
    print("distill " + json.dumps(summary))
    return summary


class _Arrays:
    """A next_batch payload of ready arrays (distillation reads
    as_arrays() only)."""

    def __init__(self, arrays):
        self._arrays = arrays

    def as_arrays(self):
        return self._arrays


def fleet_rows(seed, words):
    """The fleet phases' 48 requests: the bimodal 32 of
    phase_continuous_serve and 16 more (8 short, 8 long)."""
    extra = [(f"extra-{i}",) + r[1:]
             for i, r in enumerate(bimodal_rows(seed + 6, words, 8, 8))]
    return bimodal_rows(seed + 5, words, 16, 16) + extra


def _counted_engine(server):
    """Count the decode steps and prefills of one continuous server's slot
    engine (its own dispatch thread is the only caller)."""
    eng = server._cont._engine
    n = dict(steps=0, prefills=0)
    step, prefill = eng.step, eng.prefill

    def counted_step():
        if eng._active.any():
            n["steps"] += eng.chunk  # step_slots runs `chunk` steps
        return step()

    def counted_prefill(example):
        n["prefills"] += 1
        return prefill(example)

    eng.step, eng.prefill = counted_step, counted_prefill
    return n


def _drive(surface, rows_in, threads=8, on_resolve=None):
    """rows_in from `threads` threads through a started server or fleet;
    returns ({uuid: result}, done-callback counts, numbers)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    calls, waits, lock = {}, [], threading.Lock()

    def submit(row):
        t0 = time.perf_counter()
        fut = surface.submit(row[1], uuid=row[0], reference=row[3])

        def note(f):
            with lock:
                calls[f.uuid] = calls.get(f.uuid, 0) + 1
                waits.append(time.perf_counter() - t0)
                n = len(waits)
            if on_resolve is not None:
                on_resolve(n)

        fut.add_done_callback(note)
        return fut

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as ex:
        futs = list(ex.map(submit, rows_in))
    results = {f.uuid: f.result(timeout=900) for f in futs}
    secs = time.perf_counter() - t0
    check(all(u == r.uuid for u, r in results.items()),
          "a future resolved with another request's result")
    return results, calls, dict(
        requests=len(rows_in), seconds=secs,
        requests_per_s=len(rows_in) / secs,
        caller_e2e_p50_s=float(np.percentile(waits, 50)),
        caller_e2e_p99_s=float(np.percentile(waits, 99)))


def phase_fleet(seed, work, params, tf_params, tf_words, device="cuda"):
    """The in-process fleet (serve/fleet.py FleetRouter over continuous
    ServingServers) at phase_continuous_serve's decode width (H 256, E
    128, V 50,000, 400/100 steps, min 35, beam 4, coverage on, f32,
    CONTINUOUS_FLAGS), the pointer-generator over ``params`` (the ROUGE
    phase's checkpoint, read from a train directory), every replica on
    this one card; each part with the launch counts set to 0 just before
    and read just after:

      a. failover: 3 replicas, the 48 fleet_rows from 8 threads; once r1
         has run one chunk of its residents' decode, kill_replica("r1")
         while it holds residents:
         serve/replica_kills_total is 1, serve/requeued_total at least 1,
         every router future resolves exactly once (done callbacks), and
         every summary equals a single continuous server's on the same
         48 (run in this call, its requests/s and e2e p50/p99 printed
         beside the fleet's);
      b. rolling swap: 3 fresh replicas, a second checkpoint written into
         the train directory, rolling_swap() with 16 requests in flight:
         serve/replicas_in_rotation is at least 2 at every router tick,
         every replica ends on the new checkpoint's fingerprint, every
         result carries the old or the new one, every request resolves
         once;
      c. hedging: 3 fresh replicas, serve_hedge_ms half of (a)'s single
         server's median e2e, serve_hedge_max_ratio 0.25, 16 requests:
         hedges at most a quarter of admissions, no future resolves
         twice, the summaries (a)'s; prints the hedges, wins and
         suppressed hedges;
      d. the transformer: 2 replicas over ``tf_params`` on 8 requests,
         summaries equal to ``tf_words`` (phase_continuous_serve's single
         continuous server, same rows and flags).

    The replicas' dispatch threads launch on the card's one stream, so
    the launch counts are checked as totals: the fused attention exactly
    twice per decode step summed over the replicas' engines (the killed
    one included), the flash forward six times per transformer prefill.
    (device="cpu" rehearses the control flow without a card.)"""
    import threading

    from textsummarization_on_flink_tpu_torch import obs
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.serve.fleet import FleetRouter
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )

    words = synthetic_words(main_path_hps("pointer_generator").vocab_size)
    vocab = Vocab(words=words)
    rows = fleet_rows(seed, words)
    train_dir = os.path.join(work, "exp", "train")
    _save_params(train_dir, params, 4)
    pg = main_path_hps("pointer_generator").replace(
        mode="decode", device=device, log_root=work, exp_name="exp",
        **CONTINUOUS_FLAGS)
    summary = {}

    def replicas(hps, n, prm=None, name="r"):
        servers = [ServingServer(
            hps, vocab, params=prm,
            train_dir=train_dir if prm is None else None,
            decode_root=os.path.join(work, f"{name}{i}"),
            registry=obs.Registry()) for i in range(n)]
        return servers, [_counted_engine(s) for s in servers]

    def kernel_check(name, launched, counts, family="pointer_generator"):
        steps = sum(c["steps"] for c in counts)
        prefills = sum(c["prefills"] for c in counts)
        if device == "cuda":
            mine, want = (("fused", 2 * steps)
                          if family == "pointer_generator"
                          else ("flash_forward", 6 * prefills))
            check(launched[mine] == want,
                  f"{name}: {launched[mine]} {mine} launches, expected "
                  f"{want} ({steps} steps, {prefills} prefills)")
            others = {k: v for k, v in launched.items() if v and k != mine}
            check(not others, f"{name}: other kernels launched: {others}")
        return dict(steps=steps, prefills=prefills,
                    fused=launched["fused"],
                    flash_forward=launched["flash_forward"])

    def words_of(results):
        out = {u: r.decoded_words for u, r in results.items()}
        check(all(out.values()), "an empty summary")
        return out

    # (a) the single server's baseline, then the fleet with a kill
    single, counts = replicas(pg, 1, name="single")
    reset_launch_counts()
    with single[0]:
        res, calls, summary["single"] = _drive(single[0], rows)
    summary["single"]["kernels"] = kernel_check("single", launch_counts(),
                                                counts)
    want = words_of(res)
    servers, counts = replicas(pg, 3)
    reg = obs.Registry()
    router = FleetRouter(servers, pg, registry=reg)
    killed = {}

    def maybe_kill(n_resolved):
        # r1 one chunk into its residents' decode: below min_dec_steps,
        # so none of them can finish before the kill (kill() lets the
        # chunk in flight end first; each replica's 16 slots fill in one
        # wave and its residents finish together)
        eng = servers[1]._cont._engine
        if counts[1]["steps"] >= eng.chunk \
                and not killed and servers[1]._cont.active() > 0:
            killed.update(resolved=n_resolved, steps=counts[1]["steps"],
                          resident=servers[1]._cont.active())
            killed["rejected"] = router.kill_replica("r1")

    done = threading.Event()

    def killer():
        # the kill runs off the dispatch threads' callbacks: one resolved
        # request's callback must not join a replica's dispatch thread
        while not done.is_set() and not killed:
            maybe_kill(len(seen))
            time.sleep(0.002)

    seen = []
    reset_launch_counts()
    t = threading.Thread(target=killer, daemon=True)
    with router:
        t.start()
        res, calls, summary["fleet"] = _drive(
            router, rows, on_resolve=lambda n: seen.append(n))
        done.set()
        t.join()
    summary["fleet"]["kernels"] = kernel_check("fleet", launch_counts(),
                                               counts)
    check(bool(killed), "r1 was never killed mid-decode")
    got = words_of(res)
    summary["fleet"].update(
        killed=killed,
        replica_kills=reg.counter("serve/replica_kills_total").value,
        requeued=reg.counter("serve/requeued_total").value)
    check(summary["fleet"]["replica_kills"] == 1, "not exactly one kill")
    check(summary["fleet"]["requeued"] >= 1, "the kill requeued nothing")
    check(calls == {r[0]: 1 for r in rows},
          "not every router future resolved exactly once")
    differ = sorted(u for u in want if want[u] != got[u])
    check(not differ, f"fleet summaries differ from the single server's "
                      f"for {differ}")

    # (b) a rolling swap to a second checkpoint with requests in flight
    servers, counts = replicas(pg, 3, name="swap")
    fp_old = [s.params_fingerprint for s in servers]
    from textsummarization_on_flink_tpu_torch.params import tree_map

    _save_params(train_dir, tree_map(lambda a: np.asarray(a) * np.float32(
        1.01) if np.asarray(a).dtype.kind == "f" else a, params), 5)
    reg = obs.Registry()
    router = FleetRouter(servers, pg, registry=reg)
    ticks = []
    tick = router.tick

    def watched_tick():
        tick()
        ticks.append((reg.gauge("serve/replicas_in_rotation").value,
                      sum(h.draining for h in router.replicas())))

    router.tick = watched_tick
    reset_launch_counts()
    out = {}
    with router:
        runner = threading.Thread(target=lambda: out.update(zip(
            ("res", "calls", "numbers"), _drive(router, rows[:16]))))
        runner.start()
        while not any(s.load() for s in servers):
            time.sleep(0.001)
        t0 = time.perf_counter()
        router.rolling_swap(timeout=600.0)
        swap_s = time.perf_counter() - t0
        runner.join()
    fp_new = [s.params_fingerprint for s in servers]
    summary["swap"] = dict(
        out["numbers"], swap_seconds=swap_s, ticks=len(ticks),
        min_in_rotation=min(g for g, _ in ticks),
        max_draining=max(d for _, d in ticks),
        swaps=reg.counter("serve/fleet_swaps_total").value,
        result_fingerprints=sorted({r.params_fingerprint
                                    for r in out["res"].values()}),
        kernels=kernel_check("swap", launch_counts(), counts))
    check(len(set(fp_old)) == 1 and len(set(fp_new)) == 1
          and fp_new[0] != fp_old[0],
          f"replicas did not all move to the new checkpoint: {fp_old} -> "
          f"{fp_new}")
    check(summary["swap"]["swaps"] == 3, "the swap did not visit 3 replicas")
    check(summary["swap"]["min_in_rotation"] >= 2
          and summary["swap"]["max_draining"] <= 1,
          "more than one replica was out for the swap at a tick")
    check(set(summary["swap"]["result_fingerprints"])
          <= {fp_old[0], fp_new[0]}, "a result of neither checkpoint")
    check(out["calls"] == {r[0]: 1 for r in rows[:16]},
          "swap: not every router future resolved exactly once")

    # (c) hedging at half of (a)'s single-server median e2e (the fleet's
    # own, stretched by the kill's requeues, is above (c)'s whole run),
    # capped at a quarter
    hedge_ms = 500.0 * summary["single"]["caller_e2e_p50_s"]
    hps = pg.replace(serve_hedge_ms=hedge_ms, serve_hedge_max_ratio=0.25)
    servers, counts = replicas(hps, 3, prm=params, name="hedge")
    reg = obs.Registry()
    router = FleetRouter(servers, hps, registry=reg)
    reset_launch_counts()
    with router:
        res, calls, summary["hedge"] = _drive(router, rows[16:32])
    hedges = reg.counter("serve/hedges_total").value
    admitted = reg.counter("serve/fleet_submitted_total").value
    summary["hedge"].update(
        hedge_ms=hedge_ms, hedges=hedges,
        wins=reg.counter("serve/hedge_wins_total").value,
        suppressed=reg.counter("serve/hedge_suppressed_total").value,
        admissions=admitted,
        kernels=kernel_check("hedge", launch_counts(), counts))
    check(hedges <= 0.25 * admitted, f"{hedges} hedges over {admitted} "
                                     f"admissions")
    check(calls == {r[0]: 1 for r in rows[16:32]},
          "hedge: a router future resolved other than once")
    differ = sorted(u for u, r in res.items()
                    if r.decoded_words != want[u])
    check(not differ, f"hedged summaries differ for {differ}")

    # (d) the transformer's replicas
    tf = main_path_hps("transformer").replace(
        mode="decode", device=device, **CONTINUOUS_FLAGS)
    servers, counts = replicas(tf, 2, prm=tf_params, name="tf")
    reg = obs.Registry()
    router = FleetRouter(servers, tf, registry=reg)
    reset_launch_counts()
    with router:
        res, calls, summary["transformer"] = _drive(
            router, bimodal_rows(seed + 5, words, 16, 16)[:8])
    summary["transformer"]["kernels"] = kernel_check(
        "transformer", launch_counts(), counts, family="transformer")
    got = words_of(res)
    differ = sorted(u for u in got if got[u] != tf_words[u])
    check(not differ, f"transformer fleet summaries differ from the single "
                      f"server's for {differ}")
    check(set(calls.values()) == {1}, "transformer: a future resolved "
                                      "other than once")
    summary["launches"] = sum(summary[k]["kernels"]["fused"] for k in (
        "single", "fleet", "swap", "hedge"))
    summary["flash_launches"] = summary["transformer"]["kernels"][
        "flash_forward"]
    summary["card"] = card_line() if device == "cuda" else None
    print("fleet " + json.dumps(summary))
    summary["rows"], summary["single_words"] = rows, want
    return summary


def _hier_document(seed, words, n):
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.2, n), len(words)) - 1
    return " ".join(words[r] if rng.random() > 0.05
                    else f"oov{rng.integers(50)}" for r in ranks)


def phase_hiersum(seed, work, params, device="cuda"):
    """Hierarchical summarization (serve/hiersum.py) through
    ``SummarizationModel.transform(hierarchical=True)`` at the fleet
    phase's decode width over ``params`` (the ROUGE phase's checkpoint),
    a micro-batch server (so the greedy map tier and the beam reduce tier
    both run), serve buckets 100/200/400, the front door's cache on,
    chunks of max_enc_steps (400) words overlapping by 50: a document of
    2,000 synthetic words framed 300 words a frame
    (frame_document_rows), then a revision that appends 400 words.  With
    the launch counts set to 0 just before the transform and read just
    after:

      a. the first revision decodes its 6 chunks and one reduce; the
         second hits the cache for the 5 chunks it kept whole
         (serve/hier_chunk_cache_hits_total is 5) and decodes only its 2
         tail chunks and one reduce (decode/requests_total is 10 in all);
      b. the fused attention launches exactly twice per beam step (2 x
         100 steps for each of the 4 dispatches when every search runs to
         max_dec_steps: 800);
      c. the first revision's summary equals its chunks decoded one at a
         time (greedy) through a single server, assembled by
         assemble_reduce_input and decoded once on beam;
      d. the same document through HierarchicalSummarizer over a
         2-replica micro-batch FleetRouter gives the same summary.
    (device="cpu" rehearses the control flow without a card.)"""
    from textsummarization_on_flink_tpu_torch import obs
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode.reduce import (
        assemble_reduce_input,
    )
    from textsummarization_on_flink_tpu_torch.obs.export import MemorySink
    from textsummarization_on_flink_tpu_torch.pipeline import codec, io
    from textsummarization_on_flink_tpu_torch.pipeline.estimator import (
        SummarizationModel,
    )
    from textsummarization_on_flink_tpu_torch.serve.fleet import FleetRouter
    from textsummarization_on_flink_tpu_torch.serve.hiersum import (
        HierarchicalSummarizer,
        chunk_document,
    )
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )

    hps = main_path_hps("pointer_generator").replace(
        mode="decode", device=device, log_root=work, exp_name="exp",
        serve_buckets="100,200,400", serve_coalesce=True,
        serve_cache_entries=64, hier_overlap_words=50)
    words = synthetic_words(hps.vocab_size)
    vocab = Vocab(words=words)
    _save_params(os.path.join(work, "exp", "train"), params, 4)
    doc = _hier_document(seed + 7, words, 2000)
    tail = _hier_document(seed + 8, words, 400)
    rows = [(u, a, "", r) for u, a, r in
            codec.frame_document_rows("doc", doc, "the ref .", 300)
            + codec.frame_document_rows("doc", tail, "", 300)]
    model = SummarizationModel()
    (model.set_inference_selected_cols(["uuid", "article", "reference"])
     .set_inference_output_cols(["uuid", "article", "summary",
                                 "reference"]))
    model.set_inference_hyper_params(shlex.split(hps.to_argv()))
    reg = obs.Registry()
    events = MemorySink()
    reg.event_sink = events
    reset_launch_counts()
    beam_search.steps_run = 0
    t0 = time.perf_counter()
    with obs.use_registry(reg):
        sink = model.with_vocab(vocab).transform(io.CollectionSource(rows),
                                                 hierarchical=True)
    secs = time.perf_counter() - t0
    launched, steps = launch_counts(), beam_search.steps_run
    by_uuid = {r[0]: r for r in sink.rows}
    check(sorted(by_uuid) == ["doc@r1", "doc@r2"],
          f"rows {sorted(by_uuid)}")
    chunk_events = [e for e in events.records()
                    if e.get("event") == "hier_chunk"]
    rev = {p: [e["attrs"]["cache_hit"] for e in chunk_events
               if e["attrs"]["parent_uuid"] == p]
           for p in ("doc@r1", "doc@r2")}
    summary = dict(
        words=[len(doc.split()), len(doc.split()) + len(tail.split())],
        chunks=[len(rev["doc@r1"]), len(rev["doc@r2"])],
        cache_hits=[sum(rev["doc@r1"]), sum(rev["doc@r2"])],
        hier_chunk_cache_hits=reg.counter(
            "serve/hier_chunk_cache_hits_total").value,
        decoded=reg.counter("decode/requests_total").value,
        reduces=reg.counter("serve/hier_reduce_total").value,
        dispatches=reg.histogram("serve/batch_fill").count,
        beam_steps=steps, launches=launched, seconds=secs,
        copy_fidelity_mean=reg.histogram("serve/hier_copy_fidelity").mean)
    check(summary["chunks"] == [6, 7], f"chunks {summary['chunks']}")
    check(summary["cache_hits"] == [0, 5]
          and summary["hier_chunk_cache_hits"] == 5,
          f"cache hits {summary['cache_hits']}")
    check(summary["decoded"] == 6 + 1 + 2 + 1,
          f"{summary['decoded']} decodes, expected 10")
    if device == "cuda":
        check(steps > 0 and launched == dict(
            dict.fromkeys(launched, 0), fused=2 * steps),
            f"{launched} launches in {steps} beam steps, expected 2 fused "
            f"per step")
    # (c) the same chunks one at a time through a single server, then one
    # beam decode of their assembled summaries
    server = ServingServer(hps.replace(serve_coalesce=False,
                                       serve_cache_entries=0), vocab,
                           params=params,
                           decode_root=os.path.join(work, "one"),
                           registry=obs.Registry())
    chunks = chunk_document(doc, hps.max_enc_steps, hps.hier_overlap_words)
    with server:
        maps = [server.submit(c, uuid=f"c{i}", tier="greedy").result(
            timeout=900).decoded_words for i, c in enumerate(chunks)]
        red = server.submit(assemble_reduce_input(maps, hps.max_enc_steps),
                            uuid="reduce", tier="beam").result(timeout=900)
    check(red.summary == by_uuid["doc@r1"][2],
          "the document's summary is not its chunks' reduce")
    # (d) the same document over a fleet
    servers = [ServingServer(hps, vocab, params=params,
                             decode_root=os.path.join(work, f"f{i}"),
                             registry=obs.Registry()) for i in range(2)]
    router = FleetRouter(servers, hps, registry=obs.Registry())
    with router:
        res = HierarchicalSummarizer(router, hps).summarize(
            doc, uuid="doc").result(timeout=900)
    check(res.summary == by_uuid["doc@r1"][2],
          "the fleet's document summary differs from the transform's")
    summary["card"] = card_line() if device == "cuda" else None
    print("hiersum " + json.dumps(summary))
    return summary


def _compute_pids():
    """The pids holding a context on the card, one per context, as
    nvidia-smi lists them (None when it cannot be asked).  In a container
    whose pid namespace is not the GPU driver's, nvidia-smi lists a context
    under a pid that is not ours."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return sorted(int(x) for x in out.stdout.split() if x.strip().isdigit())


def phase_procfleet(seed, work, params, rows, single_words, device="cuda"):
    """The process fleet (serve/procfleet.py ProcFleet,
    serve_fleet_transport=proc): two children started as ``python -m
    textsummarization_on_flink_tpu_torch.cli serve-replica`` on this card,
    each reading the ROUGE phase's checkpoint (``params``, saved into
    its train directory) and the synthetic vocabulary, continuous
    (CONTINUOUS_FLAGS) at the fleet phase's width:

      a. both pass the readiness handshake (portfile, then /healthz with
         the child's pid); prints each child's seconds to ready;
      b. nvidia-smi lists both children's contexts on the card: their
         pids, or, where nvidia-smi's pids are not this pid namespace's
         (a container), two contexts more than before the start;
      c. 16 of the fleet rows; once one has resolved, the most-loaded
         child is SIGKILLed (ReplicaProcess.kill_now): its requests
         requeue (serve/requeued_total at least 1), every router future
         resolves exactly once, the victim restarts as incarnation 2 and
         is readmitted through the half-open probe (prints its seconds to
         ready again), and every summary equals ``single_words`` (the
         fleet phase's single continuous server) for the same article;
      d. the fleet stops cleanly: every child has exited and nvidia-smi
         lists neither child's context (the count is back to what it was
         before the start).
    The children's kernel launches happen in their own processes: each
    child writes its counts to kernel_launches.<pid>.json in its replica
    directory (the killed incarnation's as of its last poll, 0.2 s at
    most before the kill), and their sum is the summary's "launches".
    (device="cpu" rehearses the control flow without a card.)"""
    from textsummarization_on_flink_tpu_torch import obs
    from textsummarization_on_flink_tpu_torch.serve import procfleet

    words = synthetic_words(main_path_hps("pointer_generator").vocab_size)
    vocab_path = os.path.join(work, "vocab")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.writelines(f"{w} {len(words) - i}\n" for i, w in enumerate(words))
    _save_params(os.path.join(work, "exp", "train"), params, 4)
    hps = main_path_hps("pointer_generator").replace(
        mode="decode", device=device, log_root=work, exp_name="exp",
        vocab_path=vocab_path, serve_fleet_transport="proc",
        serve_replicas=2, **CONTINUOUS_FLAGS)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    state = os.path.join(work, "state")
    os.makedirs(state)
    reg = obs.Registry()
    fleet = procfleet.ProcFleet(hps, registry=reg, state_dir=state,
                                child_env=env, ready_timeout=600.0,
                                replica_reset_secs=0.5)
    summary = {}

    def wait_ready(procs, t0, incarnation):
        ready = {}
        deadline = time.monotonic() + 600.0
        while len(ready) < len(procs) and time.monotonic() < deadline:
            for p in procs:
                if (p.rid not in ready and p.incarnation == incarnation
                        and p.ready()):
                    ready[p.rid] = time.perf_counter() - t0
            time.sleep(0.01)
        return ready

    def contexts_held(pids, listed):
        """Whether nvidia-smi's list holds the children's contexts: their
        pids, or two contexts beyond `before` when no listed pid is one
        of this namespace's processes."""
        if set(pids) <= set(listed):
            return True
        if set(listed) & set(pids + [os.getpid()]):
            return False  # our pid namespace, and a child is missing
        return len(listed) == len(before) + len(pids)

    before = _compute_pids()
    t0 = time.perf_counter()
    fleet.start()
    try:
        summary["ready_s"] = wait_ready(fleet.procs, t0, 1)
        check(len(summary["ready_s"]) == 2, "a child never became ready")
        check(fleet.wait_ready(timeout=60.0), "the rotation never warmed")
        pids = [p.pid() for p in fleet.procs]
        listed = _compute_pids()
        summary.update(pids=pids, compute_pids_before=before,
                       compute_pids=listed)
        if device == "cuda":
            check(before is not None and listed is not None
                  and contexts_held(pids, listed),
                  f"nvidia-smi lists {listed} (before the start: "
                  f"{before}), not both children {pids}")
        import threading

        calls, lock = {}, threading.Lock()
        first = threading.Event()

        def note(f):
            with lock:
                calls[f.uuid] = calls.get(f.uuid, 0) + 1
            first.set()

        futs = []
        t1 = time.perf_counter()
        for row in rows[:16]:
            f = fleet.router.submit(row[1], uuid=row[0], reference=row[3])
            f.add_done_callback(note)
            futs.append(f)
        first.wait(timeout=600)
        victim = max(fleet.remotes, key=lambda r: r.load())
        proc = fleet.procs[fleet.remotes.index(victim)]
        summary["victim"] = dict(rid=proc.rid, load=victim.load(),
                                 pid=proc.pid())
        check(victim.load() > 0 and proc.kill_now(),
              "no child was mid-decode to kill")
        t_kill = time.perf_counter()
        res = {f.uuid: f.result(timeout=900) for f in futs}
        summary["serve_seconds"] = time.perf_counter() - t1
        summary["requeued"] = reg.counter("serve/requeued_total").value
        check(summary["requeued"] >= 1, "the SIGKILL requeued nothing")
        check(calls == {r[0]: 1 for r in rows[:16]},
              "not every router future resolved exactly once")
        differ = sorted(u for u, r in res.items()
                        if r.summary != " ".join(single_words[u]))
        check(not differ, f"child summaries differ from the single "
                          f"server's for {differ}")
        restart = wait_ready([proc], t_kill, 2)
        summary["restart_ready_s"] = restart.get(proc.rid)
        check(proc.rid in restart, "the victim never restarted")
        check(fleet.wait_ready(timeout=60.0),
              "the restarted child was not readmitted")
        summary["victim"]["new_pid"] = proc.pid()
        pids.append(proc.pid())
    finally:
        fleet.stop(timeout=60.0)
    check(all(p.proc is None or p.proc.poll() is not None
              for p in fleet.procs), "a child outlived the fleet")
    listed = _compute_pids()
    summary["compute_pids_after"] = listed
    if device == "cuda":
        check(listed is not None and not set(pids) & set(listed)
              and len(listed) == len(before),
              f"nvidia-smi lists {listed} after the stop (before the "
              f"start: {before})")
    launched = dict.fromkeys(launch_counts(), 0)
    for path in glob.glob(os.path.join(work, "exp", "replica-*",
                                       "kernel_launches.*.json")):
        with open(path, encoding="utf-8") as f:
            for k, v in json.load(f).items():
                launched[k] += v
    summary["launches"] = launched
    if device == "cuda":
        check(launched["fused"] > 0, "the children reported no launches")
    summary["card"] = card_line() if device == "cuda" else None
    print("procfleet " + json.dumps(summary))
    return summary


def mesh_family_hps(family):
    """The training hps of a mesh case's family: train_main_path_hps, the
    AAN (``avg_attention``) at the transformer's reference width, and its
    narrow variant (``aan_narrow``: DISTILL_FLAGS' H/2 decoder and
    rank-64 factored head) and its one-head model (``aan_h1``: head dim
    256, which a tp=2 mesh pads with a zero head)."""
    if family in ("avg_attention", "aan_narrow", "aan_h1"):
        hps = train_main_path_hps("transformer").replace(
            model_family="avg_attention")
        if family == "aan_h1":
            hps = hps.replace(num_heads=1)
        if family == "aan_narrow":
            hps = hps.replace(draft_hidden=DISTILL_FLAGS["draft_hidden"],
                              draft_vocab_rank=DISTILL_FLAGS[
                                  "draft_vocab_rank"])
        return hps
    return train_main_path_hps(family)


def aan_decode_inputs(seed, widths=None, family="avg_attention"):
    """The AAN's (or, with ``family``, the transformer's) mesh decode: 16
    of the mesh phase's articles at the transformer's reference width
    (beam 4, 400/100 steps), params drawn from ``seed``.  Returns (hps,
    numpy params, batch arrays)."""
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params

    _, vocab, batch = mesh_decode_inputs(seed, widths)
    aan = main_path_hps("transformer").replace(
        model_family=family, mode="decode", **(widths or {}))
    batch = _batch_of(aan, vocab, batch.original_articles[:aan.batch_size])
    return aan, init_numpy_params(aan, aan.vocab_size, seed + 29), \
        batch.as_arrays()


def mesh_serve_inputs(seed, widths=None):
    """The mesh servers' inputs: the pointer-generator at the reference
    width as phase_continuous_serve serves it (decode, serve buckets
    100, 200, 400), the vocabulary and its 32 bimodal rows."""
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab

    hps = main_path_hps("pointer_generator").replace(
        mode="decode", serve_buckets="100,200,400", **(widths or {}))
    words = synthetic_words(hps.vocab_size)
    return hps, Vocab(words=words), bimodal_rows(seed + 5, words, 16, 16)


def mesh_app_inputs(root, seed, device, widths=None, dp=1):
    """App.main at dp (pipeline_hps: 2 fit steps, then the App's decode
    defaults) on 32 training rows and 4 to transform.  Returns (train hps,
    inference hps, words, train rows, inference rows)."""
    train, infer = pipeline_hps(root, seed, device)
    train = train.replace(num_steps=2, dp=dp,
                          **(widths or {}).get("pointer_generator", {}))
    infer = infer.replace(dp=dp, **{
        k: v for k, v in (widths or {}).get("pointer_generator", {}).items()
        if k != "batch_size"})
    words = synthetic_words(train.vocab_size)
    return (train, infer, words, pipeline_rows(seed, words, 32),
            pipeline_rows(seed + 1, words, 4, start=32))


def mesh_inputs(family, seed, widths=None):
    """The mesh phase's fixed train batch: the family's training width
    (train_main_path_hps; batch 16 over the synthetic 50k vocabulary;
    ``widths`` replaces fields, for a rehearsal on the CPU), params drawn
    from ``seed``, and one batch of synthetic pairs.  Returns (hps, numpy
    params, batch arrays); every rank and the single-rank reference
    build the same ones."""
    from textsummarization_on_flink_tpu_torch.data import batching
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.params import init_numpy_params

    hps = mesh_family_hps(family).replace(**(widths or {}))
    words = synthetic_words(hps.vocab_size)
    vocab = Vocab(words=words)
    pairs = synthetic_pairs(np.random.default_rng(seed + 19), words,
                            hps.batch_size)
    exs = [batching.SummaryExample.build(art, sents, vocab, hps)
           for art, sents in pairs]
    params = init_numpy_params(hps, hps.vocab_size, seed)
    return hps, params, batching.Batch(exs, hps, vocab).as_arrays()


def mesh_decode_inputs(seed, widths=None):
    """The mesh phase's decode batch: 16 synthetic articles at the
    pointer-generator's reference width (main_path_hps, beam 4; ``widths``
    as in mesh_inputs).  Returns (hps, vocab, Batch)."""
    from textsummarization_on_flink_tpu_torch.data import batching
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab

    hps = main_path_hps("pointer_generator").replace(
        mode="decode", **(widths or {}))
    words = synthetic_words(hps.vocab_size)
    vocab = Vocab(words=words)
    pairs = synthetic_pairs(np.random.default_rng(seed + 23), words,
                            hps.batch_size)
    exs = [batching.SummaryExample.build(art, sents, vocab, hps,
                                         uuid=f"m{i}")
           for i, (art, sents) in enumerate(pairs)]
    return hps, vocab, batching.Batch(exs, hps, vocab)


#: the JAX package's long-context pointer-generator (BASELINE.json
#: configs[3]: hidden_dim 512, 800 encoder steps), where phase_mesh reads
#: each sp rank's memory
MEM_WIDTHS = dict(hidden_dim=512, max_enc_steps=800)


class saved_attention:
    """Within the block, every fused attention autograd Function's saved
    es and ef (FusedAttention, and FusedAttentionSP on an sp mesh):
    ``bytes`` counts each tensor once, ``shapes`` the distinct (es, ef)
    shapes, ``calls`` the Functions."""

    def __enter__(self):
        from textsummarization_on_flink_tpu_torch.ops import (
            fused_attention as fa,
        )

        self.calls, self._seen, self._orig = 0, {}, {}
        self.shapes = set()
        for cls in (fa.FusedAttention, fa.FusedAttentionSP):
            self._orig[cls] = cls.forward

            def forward(ctx, *args, _orig=cls.forward):
                out = _orig(ctx, *args)
                es, ef = ctx.to_save[0], ctx.to_save[1]
                self.calls += 1
                self.shapes.add((tuple(es.shape), tuple(ef.shape)))
                for x in (es, ef):
                    self._seen[x.data_ptr()] = x.numel() * x.element_size()
                return out

            cls.forward = staticmethod(forward)
        return self

    def __exit__(self, *exc):
        for cls, fwd in self._orig.items():
            cls.forward = staticmethod(fwd)
        self.bytes = sum(self._seen.values())
        self.shapes = sorted(self.shapes)
        return False


class saved_encoder:
    """Within the block, what autograd saves for the backward during the
    transformer's (and the AAN's) encoder stack: ``bytes`` counts each
    saved tensor's storage once, parameters (leaves) left out, ``shapes``
    the distinct shapes of the saved [B, T, nh, hd] tensors (the flash
    attention's q, k, v and output)."""

    def __enter__(self):
        import torch

        from textsummarization_on_flink_tpu_torch.models import transformer

        self._seen, self.shapes = {}, set()
        self._orig = transformer._encoder_stack

        def pack(t):
            if not (t.is_leaf and t.requires_grad):
                self._seen[t.untyped_storage().data_ptr()] = \
                    t.untyped_storage().nbytes()
                if t.dim() == 4:
                    self.shapes.add(tuple(t.shape))
            return t

        def stack(*args, _orig=self._orig):
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                return _orig(*args)

        transformer._encoder_stack = stack
        return self

    def __exit__(self, *exc):
        from textsummarization_on_flink_tpu_torch.models import transformer

        transformer._encoder_stack = self._orig
        self.bytes = sum(self._seen.values())
        self.shapes = sorted(self.shapes)
        return False


def memory_step(family, seed, device, widths, plan=None):
    """One train step of mesh_inputs' fixed batch at MEM_WIDTHS (on
    ``plan``'s mesh, this rank's part): (its loss, the peak device bytes
    it allocated above what was allocated before it, what the fused
    attention saved (saved_attention; for the transformer and the AAN
    what their encoder saved: saved_encoder))."""
    import torch

    from textsummarization_on_flink_tpu_torch.parallel import mesh
    from textsummarization_on_flink_tpu_torch.train import trainer

    hps, params, batch = mesh_inputs(family, seed,
                                     dict(widths.get(family, {}),
                                          **MEM_WIDTHS))
    hps = hps.replace(device=device) if plan is None else plan.hps
    dev = torch.device(device)
    state = trainer.init_train_state(hps, hps.vocab_size, params=params,
                                     device=dev)
    if plan is not None:
        state = mesh.shard_train_state(plan, state)
        batch = mesh.shard_batch(plan, batch)
    arrays = trainer.batch_to_device(batch, dev)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    saver = saved_attention() if family == "pointer_generator" \
        else saved_encoder()
    with saver as saved:
        state, m = trainer.train_step(hps, state, arrays, plan=plan)
    peak = (torch.cuda.max_memory_allocated() - base if device == "cuda"
            else None)
    return float(m.loss), peak, saved


#: the mesh phase's fixed-batch cases: name -> (world, kind, family, mesh
#: and option fields)
MESH_CASES = {
    "pg_dp2": (2, "train", "pointer_generator", dict(dp=2)),
    "pg_dp2_bf16_wire": (2, "train", "pointer_generator",
                         dict(dp=2, grad_allreduce_dtype="bfloat16")),
    "tf_sp2_ring": (2, "train", "transformer",
                    dict(sp=2, sp_attention="ring")),
    "tf_sp2_ulysses": (2, "train", "transformer",
                       dict(sp=2, sp_attention="ulysses")),
    "tf_tp2": (2, "train", "transformer", dict(tp=2)),
    "decode_dp2": (2, "decode", "pointer_generator", dict(dp=2)),
    "search_tp2": (2, "search", "pointer_generator", dict(tp=2)),
    "pg_dp2_tp2": (4, "train", "pointer_generator", dict(dp=2, tp=2)),
    # the encoder's T sharded over sp: the pointer-generator's
    # attention on each rank's block, merged over sp every step; the
    # transformer's search under --sp_attention=ring; each rank's memory
    # at the JAX package's long-context width (MEM_WIDTHS)
    "pg_sp2": (2, "train", "pointer_generator", dict(sp=2)),
    "pg_dp2_sp2": (4, "train", "pointer_generator", dict(dp=2, sp=2)),
    "search_sp2": (2, "search", "pointer_generator", dict(sp=2)),
    "tf_search_sp2_ring": (2, "model_search", "transformer",
                           dict(sp=2, sp_attention="ring")),
    "pg_sp2_memory": (2, "memory", "pointer_generator", dict(sp=2)),
    # the transformer's and the AAN's encoder T sharded over sp without
    # --sp_attention: each rank's block of queries against the keys
    # gathered over sp (the flash kernels' query-block form)
    "tf_sp2": (2, "train", "transformer", dict(sp=2)),
    "aan_sp2": (2, "train", "avg_attention", dict(sp=2)),
    "tf_search_sp2": (2, "model_search", "transformer", dict(sp=2)),
    "aan_search_sp2": (2, "model_search", "avg_attention", dict(sp=2)),
    "tf_sp2_memory": (2, "memory", "transformer", dict(sp=2)),
    "aan_sp2_memory": (2, "memory", "avg_attention", dict(sp=2)),
    # serving on a mesh: the AAN's train steps and decode, the continuous
    # server at dp=2 (dense, then over the continuous phase's 56-page
    # arena) and the micro-batch server at tp=2
    "aan_dp2_tp2": (4, "train", "avg_attention", dict(dp=2, tp=2)),
    "aan_narrow_tp2": (2, "train", "aan_narrow", dict(tp=2)),
    "aan_decode_dp2": (2, "model_search", "avg_attention", dict(dp=2)),
    # a head count tp does not divide: one head at tp=2, rank 1 holding
    # only a zero pad head (parallel/sharding.py::pad_heads)
    "aan_h1_tp2": (2, "train", "aan_h1", dict(tp=2)),
    "aan_h1_decode_tp2": (2, "model_search", "avg_attention",
                          dict(tp=2, num_heads=1)),
    "serve_dp2_dense": (2, "serve", "pointer_generator",
                        dict(dp=2, requests=32, **CONTINUOUS_FLAGS)),
    "serve_dp2_paged": (2, "serve", "pointer_generator",
                        dict(dp=2, serve_arena_pages=56, requests=32,
                             **CONTINUOUS_FLAGS)),
    "serve_tp2_microbatch": (2, "serve", "pointer_generator",
                             dict(tp=2, requests=16)),
}


def _visible_devices(n):
    """CUDA_VISIBLE_DEVICES for children that use the first ``n`` of the
    cards this process was given (its own CUDA_VISIBLE_DEVICES, or every
    card when it has none; none when it was given none)."""
    given = os.environ.get("CUDA_VISIBLE_DEVICES")
    names = ([d.strip() for d in given.split(",") if d.strip()]
             if given is not None else [str(i) for i in range(n)])
    if not names:
        return given
    check(len(names) >= n, f"{n} card(s) wanted, CUDA_VISIBLE_DEVICES="
                           f"{given!r} gives {len(names)}")
    return ",".join(names[:n])


def _spawn_ranks(work, world, job, devices=1, timeout=600,
                 job_name="job.json"):
    """Start ``world`` ranks of chip_smoke_mesh.py on ``devices`` cards
    (LOCAL_WORLD_SIZE = world: the ranks pick gloo when they share a card,
    NCCL when each has its own) on ``job`` (written to
    <work>/<job_name>) and wait for all; a rank that fails, or a world
    that does not finish in ``timeout`` seconds, fails the phase.  Every
    process started is waited for or killed."""
    import socket

    cases = job["cases"]
    with open(os.path.join(work, job_name), "w", encoding="utf-8") as f:
        json.dump(job, f)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   CUDA_VISIBLE_DEVICES=_visible_devices(devices))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke_mesh.py"),
             "case", work, job_name], env=env, cwd=HERE,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f"mesh rank {r} exited {p.returncode}:\n{out[-6000:]}")
    return {c["name"]: [json.load(open(os.path.join(
        work, f"{c['name']}.rank{r}.json"))) for r in range(world)]
        for c in cases}


def _params_close(got_npz, want_params, rtol, atol):
    """The largest |got - want| - atol - rtol * |want| over the leaves (<= 0
    when every leaf is within the tolerances)."""
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )

    with np.load(got_npz) as z:
        got = {k: z[k] for k in z.files}
    want = ckpt_lib._flatten({"params": want_params})
    check(set(got) == set(want), "gathered params have other leaves")
    return max(float(np.max(np.abs(got[k] - want[k]) - atol
                            - rtol * np.abs(want[k]))) for k in want)


def _wire_envelope(got_npz, p0, ref_params):
    """The JAX package's bf16-wire single-step envelope
    (tests/test_parallel.py:147-162): each leaf's update within 5% of the
    f32 update's L2 norm + 1e-4.  Returns the worst ratio of error to
    bound."""
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )

    with np.load(got_npz) as z:
        got = {k: z[k] for k in z.files}
    a = ckpt_lib._flatten({"params": p0})
    r = ckpt_lib._flatten({"params": ref_params})
    worst = 0.0
    for k in r:
        ur, ul = r[k] - a[k], got[k] - a[k]
        worst = max(worst, float(np.linalg.norm(ur - ul))
                    / (0.05 * float(np.linalg.norm(ur)) + 1e-4))
    return worst


def _single_step(family, seed, device, widths):
    """The single-rank step of the fixed batch: (metrics, the updated
    params as numpy, the initial params)."""
    import torch

    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.train import trainer

    hps, params, batch = mesh_inputs(family, seed, widths.get(family))
    hps = hps.replace(device=device)
    device = torch.device(device)
    state = trainer.init_train_state(hps, hps.vocab_size, params=params,
                                     device=device)
    state, m = trainer.train_step(hps, state,
                                  trainer.batch_to_device(batch, device))
    flat = ckpt_lib._flatten({"params": state.params})
    return ([float(x) for x in m],
            ckpt_lib._unflatten_dicts(flat)["params"], params)


def _single_serve_words(seed, params, device, widths):
    """The single continuous server's summaries of the mesh servers'
    articles (phase_continuous_serve's dense run gives the same on the
    card; a CPU rehearsal makes them here)."""
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )

    hps, vocab, rows = mesh_serve_inputs(seed, widths.get(
        "pointer_generator"))
    server = ServingServer(hps.replace(device=device, **CONTINUOUS_FLAGS),
                           vocab, params=params)
    with server:
        futs = [server.submit(r[1], uuid=r[0], reference=r[3], block=True)
                for r in rows]
        return {f.uuid: f.result(timeout=900).decoded_words for f in futs}


def _check_mesh_serve(name, ranks, kw, serve_words, on_card):
    """A mesh server's case: the chief's summaries equal the single
    continuous server's, a greedy submit refused, every rank's engine or
    search launching the fused attention twice per decode step it ran
    (and each rank stepping: both dp indices hold residents)."""
    chief = ranks[0]
    want = {u: serve_words[u] for u in chief["words"]}
    check(len(chief["words"]) == kw["requests"],
          f"{name}: {len(chief['words'])} results for {kw['requests']}")
    differ = sorted(u for u in want if chief["words"][u] != want[u])
    check(not differ, f"{name}: summaries differ from the single "
                      f"continuous server's for {differ}")
    check("beam tier only" in chief["greedy"],
          f"{name}: a greedy submit was not refused: {chief['greedy']}")
    for r in ranks:
        check(r["beam_steps"] > 0, f"{name}: rank {r['rank']} never stepped")
        check(r["launches"]["fused"] == 2 * r["beam_steps"] or not on_card,
              f"{name}: rank {r['rank']} launched {r['launches']['fused']} "
              f"fused attentions in {r['beam_steps']} decode steps")
        others = {k: v for k, v in r["launches"].items()
                  if v and k != "fused"}
        check(not others or not on_card,
              f"{name}: rank {r['rank']} launched other kernels {others}")
    for r in ranks[1:]:
        check(r["ops"] > 0, f"{name}: rank {r['rank']} ran no op")
    out = dict(summaries_equal=True, requests=kw["requests"],
               seconds_per_rank=[r["seconds"] for r in ranks],
               beam_steps_per_rank=[r["beam_steps"] for r in ranks],
               greedy_refused=chief["greedy"])
    if kw.get("serve_arena_pages"):
        check(chief["arena_alloc_failures"] > 0,
              f"{name}: the arena never pushed back")
        out["arena_alloc_failures"] = chief["arena_alloc_failures"]
    if "local_slots" in chief:
        out["local_slots"] = [r["local_slots"] for r in ranks]
    return out


#: what phase_mesh's gloo cases, its torchrun entry point and its App
#: print beside their wall seconds: they ran at once on one card
MESH_AT_ONCE_NOTE = ("ranks share one card over gloo, beside the other "
                     "gloo world, the torchrun entry point and the App, "
                     "all at once: times are not a speed")


def _mesh_app(work, seed, device, widths):
    """Case (d): ``App.main`` at dp=2 under torchrun (2 fit steps, a
    4-row transform; chip_smoke_mesh.py app), the rows equal to a
    single-rank App's on the same rows, each rank's launches those of 2
    steps at 8 rows plus 2 fused per beam step."""
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.pipeline import app as app_lib
    from textsummarization_on_flink_tpu_torch.pipeline import io

    single_root = os.path.join(work, "app_single")
    train, infer, words, train_rows, infer_rows = mesh_app_inputs(
        single_root, seed, device, widths)
    reset_launch_counts()
    t0 = time.perf_counter()
    want = sorted(app_lib.App(train, infer, vocab=Vocab(words=words)).main(
        train_source=io.CollectionSource(train_rows),
        infer_source=io.CollectionSource(infer_rows),
        sink=io.CollectionSink()).rows)
    single_s = time.perf_counter() - t0
    single_launches = launch_counts()
    mesh_root = os.path.join(work, "app_mesh")
    with open(os.path.join(work, "app.json"), "w", encoding="utf-8") as f:
        json.dump(dict(root=mesh_root, seed=seed, device=device,
                       widths=widths, mesh=dict(dp=2)), f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", os.path.join(HERE, "chip_smoke_mesh.py"),
           "app", work]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"torchrun App.main exited {run.returncode}:"
                               f"\n{(run.stdout + run.stderr)[-6000:]}")
    ranks = [json.load(open(os.path.join(work, f"app.rank{r}.json")))
             for r in (0, 1)]
    got = [tuple(r) for r in ranks[0]["rows"]]
    check(len(got) == len(infer_rows) and got == [tuple(r) for r in want],
          "the mesh App's rows differ from the single-rank App's")
    check(ranks[1]["rows"] == [], "a follower wrote rows")
    for r in ranks:
        check(r["launches"]["fused"] > 0 and r["launches"]["fused_bwd"] > 0
              or device != "cuda",
              f"App rank {r['rank']} launched {r['launches']}")
    totals = dict.fromkeys(launch_counts(), 0)
    for r in ranks:
        for k, v in r["launches"].items():
            totals[k] += v
    out = dict(rows_equal=True, rows=len(got), torchrun_wall_s=wall,
               rank_wall_s=[r["wall_s"] for r in ranks],
               single_wall_s=single_s,
               launches_per_rank=[{k: v for k, v in r["launches"].items()
                                   if v} for r in ranks],
               single_launches={k: v for k, v in single_launches.items()
                                if v},
               launches=totals)
    print("mesh_app " + json.dumps(dict(
        {k: v for k, v in out.items() if k != "launches"},
        note=MESH_AT_ONCE_NOTE)))
    return out


def phase_mesh(seed, work, decode_params, device="cuda", widths=None,
               serve_words=None):
    """Multi-GPU (parallel/): the port's sharded steps on ranks that share
    this card over gloo, at the reference widths, each case against the
    single-rank result on the card:

      1. dp=2 (2 ranks), the pointer-generator: one train step of a fixed
         batch of 16 (mesh_inputs); loss and global norm within rtol 2e-5
         of the single-rank step, params within rtol 1e-4 / atol 1e-6 (the
         JAX package's tolerances, tests/test_parallel.py:66-76); the dp
         all-reduce moves analytic_comms' dp_wire_bytes (86.0 MB);
      2. the same with --grad_allreduce_dtype=bfloat16: the JAX package's
         envelope (loss rtol 1e-5, norm rtol 1e-2, each leaf's update
         within 5% + 1e-4 of the f32 update's L2), 43.0 MB of wire;
      3. dp=2 x tp=2 (4 ranks): case 1's tolerances, each rank holding
         V/2 rows of the embedding and V/2 columns of w;
      4. the transformer at its reference width (6+6 layers, 8 heads): one
         step each under sp=2 --sp_attention=ring, sp=2 ulysses and tp=2,
         case 1's tolerances; the transformer and the AAN at sp=2 without
         --sp_attention (each rank's block of queries against the keys
         gathered over sp: 6 query-block forward, dK/dV and dQ launches
         per rank), a step within case 1's tolerances, a search of 16
         articles with tokens equal to the single rank's (6 query-block
         forward launches per rank) and, at MEM_WIDTHS, each rank's loss,
         peak memory and saved encoder bytes (saved_encoder) beside the
         single rank's;
      5. decode of 16 articles with the ROUGE phase's trained params: the
         sharded BeamSearchDecoder at dp=2 (summaries equal to the
         single-rank decode_batch) and the sharded search at tp=2 (tokens
         equal, or, where a row differs, average log-probabilities within
         1e-3 of each other: a tie the vocab projection's column split
         decided the other way);
      6. the entry point: ``python -m torch.distributed.run
         --nproc_per_node=2 chip_smoke_mesh.py cli ... --mode=train
         --dp=2`` (chip_smoke_mesh.py runs cli.main, the module's own
         entry) for 3 steps, then a resume to 5: one events.jsonl record
         per step, each checkpoint written once (one "saved checkpoint"
         log), the same restored params (fingerprint) on both ranks;
      7. serving on the mesh, each against the single rank on the card:
         (a) a continuous ServingServer at dp=2 (CONTINUOUS_FLAGS, 8 of
         its 16 slots per rank) on the continuous phase's bimodal 32,
         dense, then over its 56-page arena: every summary equal to the
         single continuous server's (``serve_words``), the arena pushing
         back, each rank 2 fused launches per decode step it ran;
         (b) the micro-batch server at tp=2 on 16 of them: summaries
         equal, a greedy submit refused ("beam tier only"); (c) the AAN
         at the transformer's reference width: a train step at dp2 x tp2
         and the narrow variant (DISTILL_FLAGS' H_d and rank) at tp=2
         within case 1's tolerances, 6 flash forward, dK/dV and dQ per
         rank (its encoder), and a dp=2 decode of 16 articles whose
         tokens equal the single-rank search's; and at one head
         (``aan_h1``, head dim 256) on tp=2, where rank 1 holds only a
         zero pad head: a train step within case 1's tolerances and a
         tp=2 search of the 16 articles whose tokens equal the one-head
         single-rank search's, 6 flash launches per rank in each;
         (d) ``App.main`` at dp=2
         under torchrun (chip_smoke_mesh.py app; 2 fit steps, 4 rows
         transformed): the rows equal a single-rank App's;
    the gloo worlds of 2 and 4 ranks, case 6 and case 7 (d) run at once
    (independent processes on the card); then a world-1 NCCL initialize
    and all-reduce on this card (with two or more cards, the world-2
    cases again one rank per card over NCCL; with four, case 3 too; the
    torchrun case then takes NCCL by itself).  Every case checks each
    rank's kernel launches (the
    pointer-generator: 100 fused forward and backward per step; the
    transformer: 12 flash forward, dK/dV and dQ under tp, 6 under sp,
    whose encoder attention is ring or Ulysses; decode: 2 fused per beam
    step) and prints the backend, ranks per card, per-rank seconds
    (ranks sharing one card over gloo: not a speed), collective and
    host-staged bytes.  Returns the launches summed over every rank.
    (device="cpu" with small ``widths``, {family: fields}, rehearses the
    control flow without a card; the launch checks need the card.)"""
    import torch

    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.decode.decoder import (
        BeamSearchDecoder,
    )
    from textsummarization_on_flink_tpu_torch.params import from_numpy_tree
    from textsummarization_on_flink_tpu_torch.parallel import (
        distributed,
        sharding,
    )

    widths = widths or {}
    on_card = device == "cuda"
    card = card_line() if on_card else None
    t_phase = time.perf_counter()
    ref = {f: _single_step(f, seed, device, widths)
           for f in sorted({c[2] for c in MESH_CASES.values()
                            if c[1] == "train"})}
    np.savez(os.path.join(work, "decode_params.npz"),
             **ckpt_lib._flatten({"params": decode_params}))
    dhps, dvocab, dbatch = mesh_decode_inputs(
        seed, widths.get("pointer_generator"))
    dhps = dhps.replace(device=device)
    single_words = [r.decoded_words for r in BeamSearchDecoder(
        dhps, dvocab, batcher=None, params=decode_params,
        decode_root=os.path.join(work, "dec_single")).decode_batch(dbatch)]
    single = beam_search.run_beam_search(
        from_numpy_tree(decode_params, torch.device(device)), dhps,
        dbatch.as_arrays())
    # the single-rank search of each family and head count a model_search
    # case searches with (the AAN's, the transformer's)
    model_single = {}
    for _, kind, family, kw in MESH_CASES.values():
        if kind != "model_search":
            continue
        mhps, mparams, mbatch = aan_decode_inputs(
            seed, widths.get(family), family=family)
        nh = kw.get("num_heads", mhps.num_heads)
        if (family, nh) not in model_single:
            model_single[family, nh] = beam_search.run_beam_search(
                from_numpy_tree(mparams, torch.device(device)),
                mhps.replace(device=device, num_heads=nh), mbatch)
    # the long-context width's single-rank step of each family a memory
    # case reads: what each sp rank's memory is held against
    mem_single = {f: memory_step(f, seed, device, widths)
                  for f in sorted({c[2] for c in MESH_CASES.values()
                                   if c[1] == "memory"})}
    if serve_words is None:
        serve_words = _single_serve_words(seed, decode_params, device,
                                          widths)
    totals = dict.fromkeys(launch_counts(), 0)
    summary = dict(card=card, cases={})

    def job(world, suffix=""):
        return dict(seed=seed, device=device, widths=widths, cases=[
            dict(name=n + suffix, kind=k, family=f,
                 requests=kw.get("requests"),
                 hps={a: b for a, b in kw.items() if a != "requests"})
            for n, (w, k, f, kw) in MESH_CASES.items() if w == world])

    # the gloo worlds of 2 and 4 ranks sharing the card and the torchrun
    # runs of the entry point are independent processes: they run at once,
    # the App's torchrun case from this thread beside them (the only
    # thread here that runs on the card and reads the launch counters)
    results = {}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        worlds = [pool.submit(_spawn_ranks, work, world, job(world),
                              job_name=f"job{world}.json")
                  for world in (2, 4)]
        cli_run = pool.submit(_mesh_cli, work, seed, device, widths)
        app_summary = _mesh_app(work, seed, device, widths)
        for world in worlds:
            results.update(world.result())
        cli_summary = cli_run.result()
    # with a card per rank the same cases run over NCCL
    n_cards = torch.cuda.device_count() if on_card else 0
    for world in (2, 4):
        if n_cards >= world:
            results.update(_spawn_ranks(work, world, job(world, "_nccl"),
                                        devices=world))
    for name, ranks in results.items():
        base = name[:-5] if name.endswith("_nccl") else name
        world, kind, family, kw = MESH_CASES[base]
        backends = {r["backend"] for r in ranks}
        want_backend = "nccl" if name.endswith("_nccl") else "gloo"
        check(backends == {want_backend}, f"{name}: backends {backends}")
        for r in ranks:
            for k, v in r["launches"].items():
                totals[k] += v
        row = dict(world=world, backend=want_backend,
                   ranks_per_device=ranks[0]["ranks_per_device"],
                   launches_per_rank=[{k: v for k, v in r["launches"].items()
                                       if v} for r in ranks],
                   bytes_per_rank=[r["bytes"] for r in ranks])
        if kind == "serve":
            row.update(_check_mesh_serve(name, ranks, kw, serve_words,
                                         on_card))
        elif kind == "model_search":
            mhps = main_path_hps("transformer").replace(
                model_family=family, **widths.get(family, {}), **kw)
            ref_search = model_single[family, mhps.num_heads]
            # the encoder's flash forward, once per layer (none under
            # --sp_attention with T sharded: ring or Ulysses attention;
            # the query-block form where T is sharded without it); the
            # decoders run no kernel
            sharded = sharding.shards_t(mhps)
            enc_flash = 0 if sharded and mhps.sp_attention \
                else mhps.enc_layers
            want = dict(flash_forward=enc_flash,
                        flash_forward_block=enc_flash if sharded else 0)
            for r in ranks:
                got = {k: v for k, v in r["launches"].items() if v}
                check(got == {k: v for k, v in want.items() if v}
                      or not on_card,
                      f"{name}: rank {r['rank']} launched {r['launches']}")
                check(r["tokens"] == ref_search.tokens.tolist(),
                      f"{name}: rank {r['rank']}'s tokens differ from the "
                      f"single-rank search's")
            row.update(decode_s_per_rank=[r["decode_s"] for r in ranks],
                       beam_steps=[r["beam_steps"] for r in ranks],
                       tokens_equal=True)
        elif kind == "train":
            hps = mesh_family_hps(family).replace(
                **widths.get(family, {}), **kw)
            want = expected_train_launches(hps, 1)
            if sharding.shards_t(hps) and family == "pointer_generator":
                # every launch the sp-block form
                want["fused_sp"], want["fused_bwd_sp"] = \
                    want["fused"], want["fused_bwd"]
            elif sharding.shards_t(hps) and hps.sp_attention:
                # the encoder: ring or Ulysses
                for k in ("flash_forward", "flash_bwd_dkv", "flash_bwd_dq"):
                    want[k] = hps.dec_layers
            elif sharding.shards_t(hps):
                # the encoder: the query-block form, once per layer
                for k in ("flash_forward", "flash_bwd_dkv", "flash_bwd_dq"):
                    want[k + "_block"] = hps.enc_layers
            for r in ranks:
                check(r["launches"] == want or not on_card,
                      f"{name}: rank {r['rank']} launched {r['launches']}, "
                      f"expected {want} (one step)")
            metrics, ref_params, p0 = ref[family]
            loss, _, _, gnorm = ranks[0]["metrics"]
            npz = os.path.join(work, name + ".npz")
            row.update(step_s_per_rank=[r["step_s"] for r in ranks],
                       loss=loss, single_loss=metrics[0],
                       global_norm=gnorm, single_global_norm=metrics[3])
            if kw.get("grad_allreduce_dtype") == "bfloat16":
                check(abs(loss - metrics[0]) <= 1e-5 * abs(metrics[0]),
                      f"{name}: loss {loss} vs {metrics[0]}")
                check(abs(gnorm - metrics[3]) <= 1e-2 * abs(metrics[3]),
                      f"{name}: global norm {gnorm} vs {metrics[3]}")
                row["envelope_worst"] = _wire_envelope(npz, p0, ref_params)
                check(row["envelope_worst"] <= 1.0,
                      f"{name}: an update outside the bf16-wire envelope")
            else:
                check(abs(loss - metrics[0]) <= 2e-5 * abs(metrics[0]),
                      f"{name}: loss {loss} vs {metrics[0]}")
                check(abs(gnorm - metrics[3]) <= 2e-5 * abs(metrics[3]),
                      f"{name}: global norm {gnorm} vs {metrics[3]}")
                row["params_excess"] = _params_close(npz, ref_params, 1e-4,
                                                     1e-6)
                check(row["params_excess"] <= 0.0,
                      f"{name}: params beyond rtol 1e-4 / atol 1e-6")
            comms = sharding.analytic_comms(hps, params=p0)
            if hps.dp > 1:
                row["analytic_dp_wire_bytes"] = comms["dp_wire_bytes"]
                for r in ranks:
                    check(r["bytes"]["all_reduce/dp"]
                          == comms["dp_wire_bytes"],
                          f"{name}: the dp all-reduce moved "
                          f"{r['bytes']['all_reduce/dp']} bytes, analytic "
                          f"{comms['dp_wire_bytes']}")
            if hps.tp > 1:
                for r in ranks:
                    check(r["local_embedding_rows"]
                          == hps.vocab_size // hps.tp,
                          f"{name}: {r['local_embedding_rows']} embedding "
                          f"rows on rank {r['rank']}")
                    if "local_w_cols" in r:
                        check(r["local_w_cols"] == hps.vocab_size // hps.tp,
                              f"{name}: {r['local_w_cols']} columns of w")
        elif kind == "memory":
            loss, peak, saved = mem_single[family]
            row.update(single_loss=loss, single_peak_bytes=peak,
                       single_saved_bytes=saved.bytes,
                       single_saved_shapes=saved.shapes,
                       loss_per_rank=[r["loss"] for r in ranks],
                       peak_bytes_per_rank=[r["peak_bytes"] for r in ranks],
                       saved_bytes_per_rank=[r["saved_bytes"]
                                             for r in ranks],
                       saved_shapes_per_rank=[r["saved_shapes"]
                                              for r in ranks])
            mhps = mesh_family_hps(family).replace(
                **dict(widths.get(family, {}), **MEM_WIDTHS))
            for r in ranks:
                check(abs(r["loss"] - loss) <= 2e-5 * abs(loss),
                      f"{name}: loss {r['loss']} vs {loss}")
                if family == "pointer_generator":
                    check(r["saved_bytes"] * kw["sp"] == saved.bytes,
                          f"{name}: rank {r['rank']} saved "
                          f"{r['saved_bytes']} bytes of es and ef, the "
                          f"single rank {saved.bytes}")
                    check(r["launches"]["fused_sp"] == r["launches"]["fused"]
                          > 0 or not on_card,
                          f"{name}: rank {r['rank']} launched "
                          f"{r['launches']}")
                    continue
                # the encoder's activations scale with the rank's block of
                # T; only each layer's k, v and mask gathered over sp hold
                # the whole T (f32, this rank's batch rows)
                B, T = mhps.batch_size, mhps.max_enc_steps
                whole = mhps.enc_layers * (2 * B * T * mhps.hidden_dim
                                           + B * T) * 4
                row.setdefault("gathered_bytes_bound", whole)
                check(r["saved_bytes"] <= saved.bytes / kw["sp"] + whole
                      and r["saved_bytes"] < saved.bytes,
                      f"{name}: rank {r['rank']} saved {r['saved_bytes']} "
                      f"bytes of its encoder, the single rank {saved.bytes}")
                check(r["launches"]["flash_forward_block"]
                      == mhps.enc_layers or not on_card,
                      f"{name}: rank {r['rank']} launched {r['launches']}")
        else:
            for r in ranks:
                check(r["launches"]["fused"] == 2 * r["beam_steps"] > 0
                      or not on_card,
                      f"{name}: rank {r['rank']} launched "
                      f"{r['launches']['fused']} fused attentions in "
                      f"{r['beam_steps']} beam steps")
                check(r["launches"]["fused_sp"] == (
                    r["launches"]["fused"] if kw.get("sp", 1) > 1 else 0)
                    or not on_card,
                    f"{name}: rank {r['rank']}'s sp-block launches "
                    f"{r['launches']['fused_sp']}")
            row["decode_s_per_rank"] = [r["decode_s"] for r in ranks]
            if kind == "decode":
                check(ranks[0]["sharded"], f"{name}: decoder not sharded")
                check(ranks[0]["summaries"] == single_words,
                      f"{name}: the chief's summaries differ from the "
                      f"single-rank decode_batch")
                check(all(r["summaries"] == [] for r in ranks[1:]),
                      f"{name}: a rank other than the chief made results")
                row["summaries_equal"] = True
            else:
                tokens = np.asarray(ranks[0]["tokens"])
                diff = [b for b in range(len(tokens))
                        if not np.array_equal(tokens[b], single.tokens[b])]
                lp = np.asarray(ranks[0]["avg_log_prob"])
                row["rows_differing"] = diff
                row["max_avg_log_prob_diff"] = float(np.max(np.abs(
                    lp - single.avg_log_prob)))
                # sp changes no product's split: the tokens are exact
                check(not diff or kw.get("sp", 1) == 1,
                      f"{name}: rows {diff} differ from the single rank's")
                for b in diff:
                    check(abs(lp[b] - single.avg_log_prob[b]) <= 1e-3,
                          f"{name}: row {b} differs and its average "
                          f"log-prob {lp[b]} does not tie with "
                          f"{single.avg_log_prob[b]}")
        summary["cases"][name] = row
        print("mesh_case " + json.dumps(dict(
            row, case=name, note=MESH_AT_ONCE_NOTE if want_backend
            == "gloo" else "one rank per card over NCCL"), default=float))
    for k, v in cli_summary.pop("launches").items():
        totals[k] += v
    summary["cli"] = cli_summary
    for k, v in app_summary.pop("launches").items():
        totals[k] += v
    summary["app"] = app_summary
    if on_card:  # the NCCL path on one card: a world of one
        with __import__("socket").socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=1, process_id=0,
                               backend="nccl")
        t = torch.arange(4, dtype=torch.float32, device="cuda")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        check(distributed.backend() == "nccl"
              and t.tolist() == [0, 1, 2, 3], "the world-1 NCCL all-reduce")
        distributed.destroy()
        summary["nccl_world1"] = "ok"
    summary["seconds"] = time.perf_counter() - t_phase
    summary["launches"] = totals
    print("mesh " + json.dumps({k: v for k, v in summary.items()
                                if k != "cases"}, default=float))
    return summary


def _mesh_cli(work, seed, device, widths):
    """Case 6: 3 steps, then a resume to 5, through torchrun."""
    hps = train_main_path_hps("pointer_generator").replace(
        **widths.get("pointer_generator", {}))
    vocab_path, data_path = write_train_chunks(work, hps, seed, 64)
    log_root = os.path.join(work, "cli")
    # checkpoint_steps past the run: the final save only, each run
    flags = dict(mode="train", dp=2, coverage=1, lr=hps.lr, seed=seed,
                 device=device, data_path=data_path, vocab_path=vocab_path,
                 log_root=log_root, exp_name="exp", metrics_every=1,
                 checkpoint_steps=100,
                 **{k: getattr(hps, k) for k in (
                     "hidden_dim", "emb_dim", "vocab_size", "max_enc_steps",
                     "max_dec_steps", "min_dec_steps", "batch_size")})
    out = dict(launches=None, runs=[])
    totals = dict.fromkeys(launch_counts(), 0)
    for steps in (3, 5):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node=2", os.path.join(HERE, "chip_smoke_mesh.py"),
               "cli"] + [f"--{k}={v}" for k, v in dict(
                   flags, num_steps=steps).items()]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                             timeout=600)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, f"torchrun train to {steps} exited "
                                   f"{run.returncode}:\n"
                                   f"{(run.stdout + run.stderr)[-6000:]}")
        logs = run.stdout + run.stderr
        ranks = [json.load(open(os.path.join(
            log_root, f"cli.rank{r}.steps{steps}.json"))) for r in (0, 1)]
        new = steps - (0 if steps == 3 else 3)
        want = expected_train_launches(hps, new)
        for r in ranks:
            check(r["launches"] == want or device != "cuda",
                  f"cli rank {r['rank']} launched {r['launches']}, "
                  f"expected {want}")
            for k, v in r["launches"].items():
                totals[k] += v
        saves = logs.count("saved checkpoint")
        check(saves == 1, f"{saves} 'saved checkpoint' logs in the run to "
                          f"{steps}: only the chief writes, once")
        restores = [r["restores"] for r in ranks]
        if steps == 5:
            fps = {line.split("params ")[-1] for rs in restores for line in rs}
            check(all(len(rs) == 1 for rs in restores) and len(fps) == 1,
                  f"the ranks' restores: {restores}")
        out["runs"].append(dict(steps=steps, wall_s=wall,
                                rank_wall_s=[r["wall_s"] for r in ranks],
                                restores=restores, saves=saves))
    train_dir = os.path.join(log_root, "exp", "train")
    with open(os.path.join(train_dir, "events.jsonl"), encoding="utf-8") as f:
        steps_logged = [json.loads(line)["step"] for line in f
                        if line.strip()]
    check(sorted(steps_logged) == [1, 2, 3, 4, 5],
          f"events.jsonl steps {steps_logged}: one record per step")
    ckpts = sorted(p for p in os.listdir(train_dir) if p.endswith(".npz"))
    check(ckpts == ["model.ckpt-3.npz", "model.ckpt-5.npz"],
          f"checkpoints {ckpts}")
    out["launches"] = totals
    out["checkpoints"] = ckpts
    print("mesh_cli " + json.dumps(dict(out, note=MESH_AT_ONCE_NOTE)))
    return out


def _trained(family, fn):
    """fn(work) -> summary of a train phase, and the numpy params of its
    last checkpoint (model.ckpt-<steps>.npz of work/exp/train)."""
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )

    def run(work):
        out = fn(work)
        flat = ckpt_lib.load_arrays(os.path.join(
            work, "exp", "train", f"model.ckpt-{out['steps']}.npz"))
        return out, ckpt_lib._unflatten_dicts(flat)["params"]

    return _in_work("train_" + family, run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--articles", type=int, default=32)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    # the phases listen to the decoder's and trainer's INFO records; the
    # console shows warnings and errors only
    for h in logging.getLogger().handlers:
        h.setLevel(logging.WARNING)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from textsummarization_on_flink_tpu_torch.device import resolve_device
    from textsummarization_on_flink_tpu_torch.kernels import build

    t_start = time.perf_counter()
    resolve_device("cuda")  # also turns TF32 off
    print(card_line())
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          python=sys.version.split()[0])))

    # wall seconds of each phase, in order (printed before the kernels
    # line): what the script's time limit is spent on
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    # phase_wide_widths' CPU reference steps, in a child process beside
    # the kernel builds and the kernel phases (which print CUDA-event
    # times, no host time); waited for before the first phase that prints
    # a host time
    cpu_steps = CpuSteps(args.seed)
    try:
        t0 = time.perf_counter()
        libs = build.build_all()
        print(json.dumps(dict(build_seconds=time.perf_counter() - t0,
                              kernels=sorted(libs))))
        for name in libs:
            sys.stdout.write(build.build_log(name))
        lap("build")

        main_row, bf16_row, k1_rows, app_rows, wide_rows, worst = \
            phase_attention(args.seed)
        bounded_rows, bounded_worst = phase_attention_bounded(args.seed)
        worst = max(worst, bounded_worst)
        worst = max(worst, phase_attention_long(args.seed))
        bwd_att_rows, bwd_att_worst = phase_attention_bwd(args.seed)
        forms = phase_attention_forms(args.seed)
        fa_sass = fused_sass()
        lap("fused_attention")
        flash_row, flash_hd256, flash_worst = phase_flash(args.seed)
        bwd_rows, bwd_worst = phase_flash_bwd(args.seed)
        fb_rows, fb_worst = phase_flash_bf16(args.seed)
        fb_sass = bf16_flash_sass()
        lap("flash")
        fw_rows, fw_worst = phase_flash_wide(args.seed)
        fw_sass = wide_flash_sass()
        lap("flash_wide")
        qb_rows, qb_worst = phase_flash_query_block(args.seed)
        lap("flash_query_block")
        flash_digest_count = phase_flash_digests()
        lap("flash_digests")
        cpu_steps.wait(list(laps))
        lap("cpu_steps_wait")
        errors = {name: dict(max_abs_err=now, simt=SIMT_MAX_ABS_ERR[name])
                  for name, now in (("forward", flash_worst),
                                    ("dq", bwd_worst["dq"]),
                                    ("dk", bwd_worst["dk"]),
                                    ("dv", bwd_worst["dv"]))}
        errors["fused_attention"] = dict(max_abs_err=worst,
                                         pr4=PR4_FUSED_MAX_ABS_ERR)
        print("errors_vs_simt " + json.dumps(errors))
        for family in ("pointer_generator", "transformer"):
            phase_small_reference(args.seed, family)
            phase_small_training(args.seed, family)
        phase_small_training(args.seed, "transformer", remat=True)
        lap("small")

        summaries, train, trained = {}, {}, {}
        for family in ("pointer_generator", "transformer"):  # own roots
            summaries[family] = _in_work(family, lambda w: phase_main_path(
                args.seed, args.articles, w, family=family))
            train[family], trained[family] = _trained(
                family, lambda w: phase_train_main_path(args.seed, w,
                                                        family=family))
        lap("main_paths")
        tf_bf16 = phase_transformer_bf16(args.seed, train["transformer"])
        lap("transformer_bf16")
        pipe = _in_work("pipeline", lambda w: phase_pipeline(args.seed, w))
        lap("pipeline")
        diet = phase_byte_diet(args.seed, train["pointer_generator"])
        lap("byte_diet")
        scored = _in_work("rouge", lambda w: phase_rouge_decode(args.seed,
                                                                w))
        streamed = _in_work("continuous", lambda w: phase_continuous_decode(
            args.seed, w))
        lap("rouge_continuous")
        wide = phase_wide_widths(args.seed, cpu_steps=cpu_steps)
        lap("wide_widths")
    finally:
        cpu_steps.close()
    served = _in_work("serve", lambda w: phase_serve(
        args.seed, w, scored["trained_params"]))
    cont = _in_work("continuous_serve", lambda w: phase_continuous_serve(
        args.seed, w, scored["trained_params"], trained["transformer"]))
    lap("serve")
    spec = _in_work("spec", lambda w: phase_spec(
        args.seed, w, trained["transformer"], scored["trained_params"]))
    dist = _in_work("distill", lambda w: phase_distill(
        args.seed, w, trained["transformer"]))
    lap("spec_distill")
    fleet = _in_work("fleet", lambda w: phase_fleet(
        args.seed, w, scored["trained_params"], trained["transformer"],
        cont["transformer_words"]))
    hier = _in_work("hiersum", lambda w: phase_hiersum(
        args.seed, w, scored["trained_params"]))
    procs = _in_work("procfleet", lambda w: phase_procfleet(
        args.seed, w, scored["trained_params"], fleet["rows"],
        fleet["single_words"]))
    lap("fleet")
    meshed = _in_work("mesh", lambda w: phase_mesh(
        args.seed, w, scored["trained_params"],
        serve_words=cont["pg_words"]))
    mesh_l = meshed["launches"]  # summed over every rank of every case
    lap("mesh")
    shutil.rmtree(os.path.join(HERE, ".smoke_work"), ignore_errors=True)

    bwd_main = bwd_rows[0]  # the training encoder's shape
    bwd_hd256 = next(r for r in bwd_rows if r["shape"] == "16x400x2x256")
    # the fused attention's backward at the training shape, coverage on
    bwd_f32 = bwd_att_rows[("float32", True, 512)]
    bwd_bf16 = bwd_att_rows[("bfloat16", True, 512)]
    bwd_wide = bwd_att_rows[("float32", True, 860)]
    # the fused attention at the training shape (K = 1), coverage on
    k1_f32, k1_bf16 = k1_rows[("float32", True)], k1_rows[("bfloat16", True)]
    flash_src = "textsummarization_on_flink_tpu_torch/kernels/flash_attention"
    fused_src = "textsummarization_on_flink_tpu_torch/kernels/fused_attention"
    pg_train = train["pointer_generator"]["launches"]
    tf_train = train["transformer"]["launches"]
    # the byte-diet phase's paths: bf16 training, f32 streaming loss,
    # recovery, bf16 decode
    diet_runs = [diet[k]["launches"] for k in ("diet", "chunked", "reference",
                                               "recovery")]
    bf16_bwd = diet["diet"]["launches"]["fused_bwd_bf16"]
    # this slice's paths: ROUGE and continuous decode, and the widths the
    # card refused before (pointer-generator D 800 and 860, head dim 256)
    wide_pg_decode = wide["pg_decode"]["kernel_launches"]
    wide_pg_train = wide["pg_train"]["launches"]
    # hidden_dim 1200: the decode's forward launches (the slab
    # form) and the train step's (the dense forward, the slab backward)
    h1200_decode = wide["pg_h1200_decode"]
    h1200_train = wide["pg_h1200_train_card"]["launches"]
    hd256_train = wide["hd256_train_card"]["launches"]
    hd256_flash = (wide["hd256_decode"]["kernel_launches"]
                   + hd256_train["flash_forward"])
    kernels = [dict(
        name="fused_attention", route="cuda", source=fused_src + ".cu",
        replaces="textsummarization_on_flink_tpu/ops/pallas_attention.py:58",
        # every main path that runs it: decode, training, the pipeline's
        # fit and transform, the byte-diet phase's runs and bf16 decode
        launches=summaries["pointer_generator"]["kernel_launches"]
        + pg_train["fused"] + pipe["fit_launches"]["fused"]
        + pipe["transform_launches"]["fused"]
        + sum(r["fused"] for r in diet_runs)
        + diet["decode"]["kernel_launches"] + scored["launches"]["fused"]
        + scored["train_launches"]["fused"] + streamed["launches"]["fused"]
        + wide_pg_decode + wide_pg_train["fused"]
        + h1200_decode["kernel_launches"] + h1200_train["fused"]
        + served["launches"]
        + cont["launches"] + spec["launches"]["fused"] + fleet["launches"]
        + hier["launches"]["fused"] + procs["launches"]["fused"]
        + mesh_l["fused"],
        max_abs_err=worst, ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        # the bf16 stream at the decode shape and at the training shape
        bf16_stream=dict(
            shape=bf16_row["shape"], ms=bf16_row["ms"],
            plain_ms=bf16_row["plain_ms"], bound_ms=bf16_row["bound_ms"],
            launches=diet["decode"]["bf16_launches"]),
        bf16_training_shape=dict(
            shape=k1_bf16["shape"], ms=k1_bf16["ms"],
            plain_ms=k1_bf16["plain_ms"], bound_ms=k1_bf16["bound_ms"],
            bound_by=k1_bf16["bound_by"],
            launches=diet["diet"]["launches"]["fused_bf16"]),
        training_shape=dict(
            shape=k1_f32["shape"], ms=k1_f32["ms"],
            plain_ms=k1_f32["plain_ms"], bound_ms=k1_f32["bound_ms"],
            launches=pg_train["fused"] + pipe["fit_launches"]["fused"]),
        app_decode_shape=dict(
            shape=app_rows[True]["shape"], ms=app_rows[True]["ms"],
            plain_ms=app_rows[True]["plain_ms"],
            bound_ms=app_rows[True]["bound_ms"],
            launches=pipe["transform_launches"]["fused"]),
        # pointer-generator widths the kernel refused before: decode at
        # hidden_dim 400, training at 430 (a narrow cluster's 4-chunk ring)
        wide_decode=dict(
            shape=wide_rows[800]["shape"], ms=wide_rows[800]["ms"],
            plain_ms=wide_rows[800]["plain_ms"],
            bound_ms=wide_rows[800]["bound_ms"],
            bound_by=wide_rows[800]["bound_by"],
            max_abs_err=wide_rows[800]["max_abs_err"],
            launches=wide_pg_decode),
        wide_training=dict(
            shape=wide_rows[860]["shape"], ms=wide_rows[860]["ms"],
            plain_ms=wide_rows[860]["plain_ms"],
            bound_ms=wide_rows[860]["bound_ms"],
            bound_by=wide_rows[860]["bound_by"],
            max_abs_err=wide_rows[860]["max_abs_err"],
            launches=wide_pg_train["fused"]),
        # the serve phase's launches by shape, each pointing to the entry
        # that times that shape: the beam dispatches of (a) and (b) at
        # the decode shape (this entry's own ms), (c)'s greedy dispatch
        # at K = 1, the App's (d) at 4 x 4
        serve=dict(launches=served["launches"], by_shape=[
            dict(shape=main_row["shape"], timed_in="ms",
                 launches=served["pinned"]["launches"]
                 + served["concurrent"]["launches"]),
            dict(shape=k1_f32["shape"], timed_in="training_shape",
                 launches=served["deadline"]["launches"]),
            dict(shape=app_rows[True]["shape"], timed_in="app_decode_shape",
                 launches=served["app"]["launches"])]),
        # the length bound (the slot engine's step): the continuous
        # phase's dense and paged runs at 16 slots x 4 beams x 400 x 512
        bounded=dict(
            launches=cont["slot_launches"],
            rows=[dict(t_active=r["t_active"], dtype=r["dtype"],
                       ms=r["ms"], plain_ms=r["plain_ms"],
                       bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                       max_abs_err=r["max_abs_err"])
                  for r in bounded_rows],
            shape=bounded_rows[0]["shape"]),
        # the speculative tier (phase_spec): the pointer-generator's greedy
        # batch and its K = 1 verify steps, at the training shape's row
        spec=dict(launches=spec["launches"]["fused"],
                  timed_in="training_shape"),
        # the fleet layer: phase_fleet's continuous replicas (the bounded
        # form, timed in "bounded"), phase_hiersum's micro-batch map
        # (greedy, K = 1: "training_shape") and reduce (beam: "ms")
        # dispatches; phase_procfleet's children launch in their own
        # processes and report their counts (in "procfleet")
        fleet=dict(launches=fleet["launches"], timed_in="bounded"),
        hiersum=dict(launches=hier["launches"]["fused"],
                     timed_in=["training_shape", "ms"]),
        procfleet=dict(children=len(procs["ready_s"]),
                       ready_s=procs["ready_s"],
                       restart_ready_s=procs["restart_ready_s"],
                       launches=procs["launches"]["fused"]),
        # the mesh phase's ranks (their own processes), summed
        mesh=dict(launches=mesh_l["fused"]),
        library_ms=None, redesigned="PR 5"), dict(
        name="fused_attention_bwd", route="cuda", source=fused_src + "_bwd.cu",
        # the custom_vjp's backward (jax.vjp of the XLA formula)
        replaces="textsummarization_on_flink_tpu/ops/pallas_attention.py:360",
        launches=pg_train["fused_bwd"] + pipe["fit_launches"]["fused_bwd"]
        + sum(r["fused_bwd"] - r["fused_bwd_bf16"] for r in diet_runs)
        + scored["train_launches"]["fused_bwd"] + wide_pg_train["fused_bwd"]
        + h1200_train["fused_bwd"] + mesh_l["fused_bwd"],
        mesh=dict(launches=mesh_l["fused_bwd"]),
        max_abs_err=bwd_att_worst["float32"],
        ms=bwd_f32["ms"], plain_ms=bwd_f32["plain_ms"],
        bound_ms=bwd_f32["bound_ms"], bound_by=bwd_f32["bound_by"],
        wide_training=dict(
            shape=bwd_wide["shape"], ms=bwd_wide["ms"],
            plain_ms=bwd_wide["plain_ms"], bound_ms=bwd_wide["bound_ms"],
            bound_by=bwd_wide["bound_by"],
            max_abs_err=max(bwd_wide["max_abs_err"].values()),
            launches=wide_pg_train["fused_bwd"]),
        library_ms=None), dict(
        # the same kernel's bf16 encoder-stream form
        name="fused_attention_bwd_bf16", route="cuda",
        source=fused_src + "_bwd.cu",
        replaces="textsummarization_on_flink_tpu/ops/pallas_attention.py:360",
        launches=bf16_bwd, max_abs_err=bwd_att_worst["bfloat16"],
        bf16_ulps=bwd_bf16["bf16_ulps"], ms=bwd_bf16["ms"],
        plain_ms=bwd_bf16["plain_ms"], bound_ms=bwd_bf16["bound_ms"],
        bound_by=bwd_bf16["bound_by"], library_ms=None), dict(
        name="flash_attention", route="cuda",
        source="textsummarization_on_flink_tpu_torch/kernels/flash_attention.cu",
        # the library Pallas kernel, at its call site in the repo
        replaces="textsummarization_on_flink_tpu/models/transformer.py:285",
        # both main paths that run it: decode and training
        launches=summaries["transformer"]["kernel_launches"]
        + tf_train["flash_forward"] + hd256_flash + cont["flash_launches"]
        + spec["launches"]["flash_forward"]
        + dist["launches"]["flash_forward"] + fleet["flash_launches"]
        + mesh_l["flash_forward"],
        mesh=dict(launches=mesh_l["flash_forward"]),
        # the speculative tier's encoders (both models') and the
        # distillation's teacher decodes and draft steps; the fleet's
        # transformer replicas' prefills
        spec=dict(launches=spec["launches"]["flash_forward"]),
        distill=dict(launches=dist["launches"]["flash_forward"]),
        fleet=dict(launches=fleet["flash_launches"]),
        max_abs_err=flash_worst, ms=flash_row["ms"],
        plain_ms=flash_row["plain_ms"], bound_ms=flash_row["bound_ms"],
        bound_by=flash_row["bound_by"], library_ms=flash_row["library_ms"],
        # head dim 256 (the output's columns split over two blocks)
        head_dim_256=dict(
            shape=flash_hd256["shape"], ms=flash_hd256["ms"],
            plain_ms=flash_hd256["plain_ms"],
            library_ms=flash_hd256["library_ms"],
            bound_ms=flash_hd256["bound_ms"],
            bound_by=flash_hd256["bound_by"],
            max_abs_err=flash_hd256["max_abs_err"], launches=hd256_flash),
        redesigned="PR 4")]
    for name, key in (("flash_attention_bwd_dkv", "dkv"),
                      ("flash_attention_bwd_dq", "dq")):
        # the library's backward kernels, through the custom_vjp of the
        # flash_attention called at transformer.py:285; plain and library
        # times are of the whole backward (both compute dq, dk and dv)
        kernels.append(dict(
            name=name, route="cuda", source=flash_src + "_bwd.cu",
            replaces=("textsummarization_on_flink_tpu/models/transformer.py"
                      f":285 (library _flash_attention_bwd_{key})"),
            launches=tf_train[f"flash_bwd_{key}"]
            + hd256_train[f"flash_bwd_{key}"]
            + dist["launches"][f"flash_bwd_{key}"]
            + mesh_l[f"flash_bwd_{key}"],
            distill=dict(launches=dist["launches"][f"flash_bwd_{key}"]),
            mesh=dict(launches=mesh_l[f"flash_bwd_{key}"]),
            max_abs_err=(max(bwd_worst["dk"], bwd_worst["dv"])
                         if key == "dkv" else bwd_worst["dq"]),
            ms=bwd_main[f"{key}_ms"], plain_ms=bwd_main["plain_ms"],
            bound_ms=bwd_main[f"{key}_bound_ms"],
            bound_by=bwd_main[f"{key}_bound_by"],
            library_ms=bwd_main["library_ms"],
            head_dim_256=dict(
                shape=bwd_hd256["shape"], ms=bwd_hd256[f"{key}_ms"],
                plain_ms=bwd_hd256["plain_ms"],
                library_ms=bwd_hd256["library_ms"],
                bound_ms=bwd_hd256[f"{key}_bound_ms"],
                bound_by=bwd_hd256[f"{key}_bound_by"],
                max_abs_err=(max(bwd_hd256["max_abs_err_dk"],
                                 bwd_hd256["max_abs_err_dv"])
                             if key == "dkv"
                             else bwd_hd256["max_abs_err_dq"]),
                launches=hd256_train[f"flash_bwd_{key}"]),
            redesigned="PR 4" if key == "dkv" else "PR 5"))
    # the bf16 forms (the transformer under --compute_dtype=bfloat16): the
    # encoder's shape as the headline, every shape of phase_flash_bf16
    # beside it, and the f32 form's time at the headline shape
    fb_main = fb_rows["16x400x8x32"]
    bf16_train = tf_bf16["train"]["launches"]
    bf16_remat = tf_bf16["remat"]["launches"]
    lib_call = ("textsummarization_on_flink_tpu/models/transformer.py:285 "
                "(library {} on bf16 q, k, v under compute_dtype=bfloat16)")
    kernels.append(dict(
        name="flash_attention_bf16", route="cuda", source=flash_src + ".cu",
        replaces=lib_call.format("_flash_attention_kernel"),
        launches=tf_bf16["decode"]["bf16_launches"]
        + bf16_train["flash_forward_bf16"] + bf16_remat["flash_forward_bf16"],
        max_abs_err=fb_worst["forward"][0], bf16_ulps=fb_worst["forward"][1],
        ms=fb_main["ms"], plain_ms=fb_main["plain_ms"],
        bound_ms=fb_main["bound_ms"], bound_by=fb_main["bound_by"],
        library_ms=fb_main["library_ms"], f32_form_ms=flash_row["ms"],
        sass=fb_sass["fwd"],
        shapes=[dict(shape=r["shape"], causal=r["causal"], ms=r["ms"],
                     plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                     bound_ms=r["bound_ms"], bound_by=r["bound_by"])
                for r in fb_rows.values()],
        design=("wgmma on TMA-copied tiles: 128 query rows a block in two "
                "consumer warpgroups and a producer warpgroup (setmaxnreg "
                "24/240), q copied once, K and V tiles (128 keys, 64 at hd "
                "256) with their key-flag words through a 2-stage mbarrier "
                "ring, S = Q K^T from shared memory with the warpgroups "
                "taking turns, the online softmax in S's registers, O += "
                "P V with P in registers"),
        added="PR 13", redesigned="PR 15"))
    for name, key in (("flash_attention_bwd_dkv_bf16", "dkv"),
                      ("flash_attention_bwd_dq_bf16", "dq")):
        # plain and library times are of the whole bf16 backward
        kernels.append(dict(
            name=name, route="cuda", source=flash_src + "_bwd.cu",
            replaces=lib_call.format(f"_flash_attention_bwd_{key}"),
            launches=bf16_train[f"flash_bwd_{key}_bf16"]
            + bf16_remat[f"flash_bwd_{key}_bf16"],
            max_abs_err=fb_worst[key][0], bf16_ulps=fb_worst[key][1],
            ms=fb_main[f"{key}_ms"], plain_ms=fb_main["bwd_plain_ms"],
            bound_ms=fb_main[f"{key}_bound_ms"],
            bound_by=fb_main[f"{key}_bound_by"],
            library_ms=fb_main["bwd_library_ms"],
            f32_form_ms=bwd_main[f"{key}_ms"], sass=fb_sass[key],
            shapes=[dict(shape=r["shape"], causal=r["causal"],
                         ms=r[f"{key}_ms"], plain_ms=r["bwd_plain_ms"],
                         library_ms=r["bwd_library_ms"],
                         bound_ms=r[f"{key}_bound_ms"],
                         bound_by=r[f"{key}_bound_by"])
                    for r in fb_rows.values()],
            added="PR 13", redesigned="PR 14"))
    # the wide kernels (head dims above 256): the encoder's shape at head
    # dim 512 as the headline, every shape of phase_flash_wide beside it;
    # launches from phase_wide_heads' main paths (head dims 512 and 320)
    wide_src = flash_src + "_wide.cu"
    wide_runs = dict(f32=[wide["hd512_train_f32_card"],
                          wide["hd320_train_card"]],
                     bf16=[wide["hd512_train_bf16_card"]])
    for key, counter, library in (
            ("forward", "flash_forward", "_flash_attention_kernel"),
            ("dkv", "flash_bwd_dkv", "_flash_attention_bwd_dkv"),
            ("dq", "flash_bwd_dq", "_flash_attention_bwd_dq")):
        for tag in ("f32", "bf16"):
            head = fw_rows[(tag, "16x400x1x512")]
            ms, bound, by, plain, lib = (
                ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms")
                if key == "forward" else
                (f"{key}_ms", f"{key}_bound_ms", f"{key}_bound_by",
                 "bwd_plain_ms", "bwd_library_ms"))
            launched = sum(r["launches"][counter + "_wide"]
                           for r in wide_runs[tag])
            if key == "forward" and tag == "f32":
                launched += wide["hd512_decode"]["wide_launches"]
            suffix = "" if key == "forward" else f"_bwd_{key}"
            # the cluster forms, timed beside the SIMT design they
            # replaced in this run
            simt = {"forward": "simt_ms", "dkv": "simt_dkv_ms",
                    "dq": "dq_simt_ms"}[key]
            entry = dict(
                name="flash_attention_wide" + suffix
                + ("_bf16" if tag == "bf16" else ""),
                route="cuda", source=wide_src,
                replaces=("textsummarization_on_flink_tpu/models/"
                          f"transformer.py:285 (library {library} at head "
                          "dims above 256, padded to a multiple of 128)"),
                launches=launched, max_abs_err=fw_worst[(tag, key)],
                ms=head[ms], plain_ms=head[plain], bound_ms=head[bound],
                bound_by=head[by], library_ms=head[lib],
                library_backend=head["library_backend"],
                shape=head["shape"], sass=fw_sass[
                    ("fwd" if key == "forward" else key) + "_" + tag],
                shapes=[dict(shape=r["shape"], causal=r["causal"],
                             ms=r[ms], plain_ms=r[plain],
                             library_ms=r[lib], bound_ms=r[bound],
                             bound_by=r[by], parent_ms=r[simt])
                        for (t, _), r in fw_rows.items()
                        if t == tag and _row_hd(r) <= 1024],
                parent_ms=head[simt], gain=head[simt] / head[ms],
                design=("a cluster of hd / 128 blocks, each an hd-128 "
                        "flash block on its 128-column slab (3xTF32 "
                        "mma.sync in f32, wgmma on TMA tiles in bf16), "
                        "the partial S (and dP) summed over the cluster "
                        "through distributed shared memory once per tile"))
            kernels.append(entry)
    # past head dim 1024: the clusters of 9 to 16 blocks (their
    # split-exchange instances), on the head-dim-1152 main paths
    # (phase_wide_heads, at HD1152_CUT's depth: the decode and the 3-step
    # runs)
    hd1152_runs = dict(f32=[wide["hd1152_train_f32_card"]],
                       bf16=[wide["hd1152_train_bf16_card"]])
    for key, counter, library in (
            ("forward", "flash_forward", "_flash_attention_kernel"),
            ("dkv", "flash_bwd_dkv", "_flash_attention_bwd_dkv"),
            ("dq", "flash_bwd_dq", "_flash_attention_bwd_dq")):
        for tag in ("f32", "bf16"):
            head = fw_rows[(tag, "16x400x1x1152")]
            ms, bound, by, plain, lib = (
                ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms")
                if key == "forward" else
                (f"{key}_ms", f"{key}_bound_ms", f"{key}_bound_by",
                 "bwd_plain_ms", "bwd_library_ms"))
            # the cluster counter: every wide launch at hd 1152
            launched = sum(r["launches"][counter + "_wide_cluster"]
                           for r in hd1152_runs[tag])
            if key == "forward" and tag == "f32":
                launched += wide["hd1152_decode"]["wide_cluster_launches"]
            suffix = "" if key == "forward" else f"_bwd_{key}"
            simt = {"forward": "simt_ms", "dkv": "simt_dkv_ms",
                    "dq": "dq_simt_ms"}[key]
            entry = dict(
                name="flash_attention_wide_c16" + suffix
                + ("_bf16" if tag == "bf16" else ""),
                route="cuda", source=wide_src,
                replaces=("textsummarization_on_flink_tpu/models/"
                          f"transformer.py:285 (library {library} at head "
                          "dims above 1024, padded to a multiple of 128)"),
                launches=launched,
                max_abs_err=fw_worst[(tag, key, "past1024")],
                ms=head[ms], plain_ms=head[plain], bound_ms=head[bound],
                bound_by=head[by], library_ms=head[lib],
                library_backend=head["library_backend"],
                shape=head["shape"], sass={
                    n: fw_sass[n] for n in WIDE16_INSTANCES[(key, tag)]},
                shapes=[dict(shape=r["shape"], causal=r["causal"],
                             ms=r[ms], plain_ms=r[plain],
                             library_ms=r[lib], bound_ms=r[bound],
                             bound_by=r[by], simt_ms=r[simt])
                        for (t, _), r in fw_rows.items()
                        if t == tag and 1024 < _row_hd(r) <= 2048],
                parent_ms=head[simt], gain=head[simt] / head[ms],
                design=(
                    "a cluster of hd / 128 blocks (9 to 16, the H100's "
                    "non-portable sizes), each the hd-128 flash block of "
                    "the 8-block form on its slab; the exchange "
                    + {("forward", "f32"): "every block's one sum to 14 "
                       "blocks, split over the cluster past them",
                       ("dkv", "f32"): "every block's one sum",
                       ("dq", "f32"): "every block's one sum at 9 blocks, "
                       "split over the cluster past them",
                       }.get((key, tag), "split over the cluster "
                             "(sum_share, then gather_sums behind a second "
                             "barrier)")))
            kernels.append(entry)
    # past head dim 2048: the clusters whose blocks own several slabs, on
    # the head-dim-2304 main paths (phase_wide_heads: the decode at full
    # depth, the 3-step runs at HD2304_CPU_CUT's), each call launching its
    # kernel once per slab (``launches``; ``calls`` the wrapper's calls);
    # ``parent_ms`` the SIMT form each replaced, timed in this run
    hd2304_runs = dict(f32=[wide["hd2304_train_f32_card"]],
                       bf16=[wide["hd2304_train_bf16_card"]])
    for key, counter, library in (
            ("forward", "flash_forward", "_flash_attention_kernel"),
            ("dkv", "flash_bwd_dkv", "_flash_attention_bwd_dkv"),
            ("dq", "flash_bwd_dq", "_flash_attention_bwd_dq")):
        for tag in ("f32", "bf16"):
            head = fw_rows[(tag, "16x400x1x2304")]
            ms, bound, by, plain, lib = (
                ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms")
                if key == "forward" else
                (f"{key}_ms", f"{key}_bound_ms", f"{key}_bound_by",
                 "bwd_plain_ms", "bwd_library_ms"))
            launched = sum(r["launches"][counter + "_wide_cluster"]
                           for r in hd2304_runs[tag])
            if key == "forward" and tag == "f32":
                launched += wide["hd2304_decode"]["wide_cluster_launches"]
            suffix = "" if key == "forward" else f"_bwd_{key}"
            simt = {"forward": "simt_ms", "dkv": "simt_dkv_ms",
                    "dq": "dq_simt_ms"}[key]
            entry = dict(
                name="flash_attention_wide_slabs" + suffix
                + ("_bf16" if tag == "bf16" else ""),
                route="cuda", source=wide_src,
                replaces=("textsummarization_on_flink_tpu/models/"
                          f"transformer.py:285 (library {library} at head "
                          "dims above 2048, padded to a multiple of 128)"),
                launches=launched, calls=launched // head["geometry"][0],
                max_abs_err=fw_worst[(tag, key, "past2048")],
                ms=head[ms], plain_ms=head[plain], bound_ms=head[bound],
                bound_by=head[by], library_ms=head[lib],
                library_backend=head["library_backend"],
                shape=head["shape"], geometry=head["geometry"], sass={
                    n: fw_sass[n] for n in WIDE_SLAB_INSTANCES[(key, tag)]},
                shapes=[dict(shape=r["shape"], causal=r["causal"],
                             geometry=r["geometry"], ms=r[ms],
                             plain_ms=r[plain], library_ms=r[lib],
                             bound_ms=r[bound], bound_by=r[by],
                             simt_ms=r[simt])
                        for (t, _), r in fw_rows.items()
                        if t == tag and _row_hd(r) > 2048],
                parent_ms=head[simt], gain=head[simt] / head[ms],
                design=("a cluster of at most 16 blocks, each owning "
                        "ceil(hd / 2048) 128-column slabs: the partial S "
                        "(and dP) summed over the block's slabs in order "
                        "on the tensor cores, then over the cluster as the "
                        "one-slab forms exchange it; one pass (launch) per "
                        "output slab a block owns, each forming S again"),
                added="PR 29" if key == "dq" else "PR 28")
            kernels.append(entry)
    # the query-block forms (Tq < Tk: one sp rank's block of the
    # encoder's queries against every key; their own counters, each
    # launch also counted in its kernel's total above): the transformer's
    # and the AAN's sp=2 mesh cases without --sp_attention
    qb_main = qb_rows[("f32", "16x200/400x8x32")]
    for key, counter, library, src in (
            ("forward", "flash_forward_block", "_flash_attention_kernel",
             ".cu"),
            ("dkv", "flash_bwd_dkv_block", "_flash_attention_bwd_dkv",
             "_bwd.cu"),
            ("dq", "flash_bwd_dq_block", "_flash_attention_bwd_dq",
             "_bwd.cu")):
        ms, bound, by, plain, lib = (
            ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms")
            if key == "forward" else
            (f"{key}_ms", f"{key}_bound_ms", f"{key}_bound_by",
             "bwd_plain_ms", "bwd_library_ms"))
        kernels.append(dict(
            name="flash_attention_query_block"
            + ("" if key == "forward" else f"_bwd_{key}"),
            route="cuda", source=flash_src + src,
            replaces=("textsummarization_on_flink_tpu/models/transformer.py"
                      f":285 (library {library}; the encoder's einsum "
                      "_mha :290-295 as GSPMD partitions it over sp)"),
            launches=mesh_l[counter], counter=counter,
            form="a block of query rows against every key (Tq != Tk)",
            max_abs_err=max(v for (t, k), v in qb_worst.items()
                            if k == key and t == "f32"),
            ms=qb_main[ms], plain_ms=qb_main[plain],
            bound_ms=qb_main[bound], bound_by=qb_main[by],
            library_ms=qb_main[lib], shape=qb_main["shape"],
            shapes=[dict(dtype=r["dtype"], shape=r["shape"], ms=r[ms],
                         plain_ms=r[plain], library_ms=r[lib],
                         bound_ms=r[bound], bound_by=r[by],
                         max_abs_err=max(r["max_abs_err"][n] for n in (
                             ("out", "serve_out") if key == "forward" else
                             ("dk", "dv") if key == "dkv" else ("dq",))))
                    for r in qb_rows.values()],
            added="PR 24"))
    # every flash launch form of the parent gave the parent's bits
    # (phase_flash_digests), the two redesigned wide kernels aside
    for entry in kernels:
        if entry["name"].startswith("flash_attention") \
                and entry.get("redesigned") != "PR 24":
            entry["parent_digests_compared"] = flash_digest_count
    # the slab and sp-block forms of the two fused kernels: their
    # own counters, each launch also counted in the kernel's total above
    f_slab = forms[("fwd", 16, 4, 400, 2400, "float32")]
    b_slab = forms[("bwd", 16, 400, 2400, "float32")]
    f_sp = forms[("sp", 16, 4, 200, 512)]
    b_sp = forms[("bwd_sp", 16, 200, 512)]
    pallas = "textsummarization_on_flink_tpu/ops/pallas_attention.py"
    for name, src, at, launched, row, counter, form in (
            ("fused_attention_slab", ".cu", 58,
             h1200_decode["slab_launches"] + h1200_train["fused_slab"], f_slab,
             "fused_slab", "D in slabs of 512 columns (the dense form's "
             "constants past one block's shared memory)"),
            ("fused_attention_sp_block", ".cu", 58, mesh_l["fused_sp"], f_sp,
             "fused_sp", "one sp rank's block of T, with the row max and sum "
             "for the merge over sp"),
            ("fused_attention_bwd_slab", "_bwd.cu", 360,
             h1200_train["fused_bwd_slab"], b_slab, "fused_bwd_slab",
             "D in slabs of 512 columns"),
            ("fused_attention_bwd_sp_block", "_bwd.cu", 360,
             mesh_l["fused_bwd_sp"], b_sp, "fused_bwd_sp",
             "one sp rank's block of T, the softmax correction from "
             "outside")):
        kernels.append(dict(
            name=name, route="cuda", source=fused_src + src,
            replaces=f"{pallas}:{at}", launches=launched,
            counter=counter, form=form, shape=row["shape"],
            dtype=row["dtype"], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None,
            shapes=[dict(shape=r["shape"], dtype=r["dtype"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"],
                         max_abs_err=r["max_abs_err"])
                    for k, r in forms.items()
                    if k[0] == {"fused_slab": "fwd", "fused_bwd_slab": "bwd",
                                "fused_sp": "sp",
                                "fused_bwd_sp": "bwd_sp"}[counter]]))
    kernels[0]["sass"] = dict(
        instantiations=len(fa_sass),
        spill_bytes=sum(v["spill_bytes"] for v in fa_sass.values()))
    print(json.dumps(dict(phase_seconds=laps)))
    check(all(e["launches"] > 0 for e in kernels),
          f"kernels no main path launched: "
          f"{[e['name'] for e in kernels if not e['launches'] > 0]}")
    print(json.dumps(dict(total_seconds=time.perf_counter() - t_start)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
