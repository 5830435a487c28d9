// Fused additive attention with coverage, shared-encoder form, for Hopper.
//
// Replaces the TPU kernels of textsummarization_on_flink_tpu/ops/
// pallas_attention.py: `_kernel` (:58, whole row per grid step) and
// `_blocked_kernel` (:199, T streamed in blocks with an online softmax).
// One kernel serves both: it always streams T.  Per article b and query k
// (K beam hypotheses share one article's encoder):
//
//   e[t]   = v . tanh(ef[t] + df[k] (+ cov[k, t] * w_c))      t < T_act
//   e[t]   = NEG (-1e30) where mask[t] == 0
//   attn   = exp(e - max e) * (mask > 0) / max(sum, 1e-30)   t < T_act
//   attn   = 0                                          T_act <= t < T
//   ctx    = attn^T es                                         (true f32)
//
// T is the article axis's length (the stride of es, ef, mask, cov and
// attn); T_act <= T is the length bound: only the first T_act positions
// are read, and the cluster's blocks split those.  The slot engine's
// decode step passes the longest active resident's length, rounded up to
// its encoder block (the JAX package's `nb * block`,
// decode/beam_search.py:684-686 there), so a step over short articles
// streams their prefix only.  T_act = T is the dense form.
//
// What bounds it on an H100: memory, with the tanh close behind.  At the
// beam-decode shape (16 articles x 4 beams, T=400, D=512, f32) es + ef
// are 26 MB per call when each article's encoder is read once for all K
// queries (7.9 us at 3.35 TB/s); the other cost is B*K*T*D = 13 M
// tanh, two MUFU operations each (6.3 us at the MUFU rate; PERF.md counts
// the SASS).  The design:
//
//   * one thread block cluster per article: 8 blocks (the portable size),
//     or 16 when the articles are few enough that their clusters take at
//     most half the SMs (the long form); block r of the cluster owns a
//     contiguous range of positions, so 16 articles give 128 blocks for
//     132 SMs;
//   * a block streams its ef rows, then its es rows, through a ring of
//     chunks of 8 rows in shared memory (4 chunks, so two blocks fit on
//     an SM; 8 with the wide clusters; fewer, down to 2, where a wide D
//     leaves no room for them, so the launch takes every width whose
//     queries and partial context fit): a chunk's rows are contiguous in
//     memory, so one TMA bulk copy (cp.async.bulk) moves it, issued by one
//     thread and completed on the stage's mbarrier; the first es chunks
//     land during the last ef chunks;
//   * the queries, v, w_c and the block's mask and coverage come in one
//     cp.async group at the start, one trip to memory;
//   * energies: a warp takes one position of a chunk; a lane holds 4 of
//     its K energies (a register pass covers 4 queries, so each ef row is
//     read once per pass: once in all for K <= 4) and works on float4
//     groups of columns, reduced over the warp with shuffles;
//   * the block's softmax statistics (max, sum) per query, then its
//     partial context: a thread owns two columns for every query;
//   * the cluster merges the blocks' (max, sum, partial context) through
//     distributed shared memory, every sum in rank order, and each block
//     writes a slice of ctx and the normalised attention of its own
//     positions: one launch, no scratch in device memory, no atomics, so
//     a run's results are the same bits every time;
//   * a block keeps its positions' mask, coverage and energies in shared
//     memory while they fit (P * (2K + 1) floats beside the ring); past
//     that (a long encoder, or many queries) it reads the mask and the
//     coverage from device memory where they lie and keeps the energies
//     in the `attn` output, which is [B, K, T] in device memory already,
//     so every T is taken.  Only the per-block constants (the ring, the
//     queries, the partial context) bound K and D in this, the dense
//     form.
//
// The slab form (attention_slab_kernel) takes every D the dense form
// does not fit in one block's shared memory, and only those: the launch
// picks the dense form wherever it fits, so a shape the dense form took
// gets the same bits as before.  The energies are a sum over D and the
// context a sum over positions column by column, so both passes loop
// over slabs of S columns (512, halved while K queries' slabs do not
// fit, down to 64): the ef pass adds each slab's energies into the
// per-position state (shared memory, or attn in device memory), the
// softmax statistics follow once, and the es pass forms each slab's
// partial context, which the cluster merges through distributed shared
// memory before the next slab reuses the buffer.  Only a slab of the
// queries, v, w_c and the partial context sits in shared memory.  A
// slab's rows are not contiguous, so each ring chunk is one bulk copy
// per row on the stage's mbarrier.  es and ef are still read once, and
// the launch is still one, with no atomics: the same bits every run.
// Splitting D across the cluster's blocks instead would have each block
// read every position's rows and the softmax wait on a cluster sum of
// every energy, which the loop over slabs avoids.
//
// The sp-block form (m_out, l_out not null, in both kernels): the
// arguments hold one sequence-parallel rank's block of T.  The kernel
// writes, beside ctx and attn normalised over the block, the cluster's
// merged row max and (unfloored) row sum [B, K]; the caller merges the
// sp ranks' blocks (ops/fused_attention.py: merge_sp_blocks), the
// additive attention's form of ring attention's online softmax.
//
// Plain f32 FMA, expf, and tanh as 1 - 2 / (1 + 2^(2 f log2 e)) on the
// MUFU (tanh_mufu: within ~5e-7 of tanh; no tensor cores, no fast-math
// flags).  bf16 encoder streams are widened to f32 on load.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry point bound with
// ctypes from ops/fused_attention.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"  // cp.async and allow_smem
#include "tma_ring.cuh"    // the ring's mbarriers and bulk copies

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;         // masked-energy floor, never -inf
constexpr float kDenomFloor = 1e-30f;  // fully masked row -> zero attention
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kWarps;  // positions per staged chunk: one per warp
// chunks in the cp.async ring: 4 (at most ~85 KB of shared memory in
// all at D 512, f32, so two blocks fit on an SM and every cluster of the
// beam-decode shape is resident at once), 8 for the wide clusters
constexpr int kRing = 4, kWideRing = 8;
// the fewest chunks a ring steps down to when D leaves no room for more:
// one chunk lands while the other is read
constexpr int kMinRing = 2;
constexpr int kQ = 4;           // queries held in registers per pass
constexpr int kCluster = 8;     // blocks per article (portable cluster)
constexpr int kWideCluster = 16;  // for few articles (non-portable size)
constexpr size_t kSmemMax = 232448;  // bytes a block may use on Hopper
// floats before the ring: its mbarriers (8 bytes each, at most 8), in
// the dynamic shared memory (a static array would count against the
// dynamic maximum allow_smem asks for), the ring 16-byte aligned after
constexpr int kBarFloats = 16;
// the slab form: columns per slab, at most and at least, and its ring
constexpr int kSlab = 512, kMinSlab = 64, kSlabRing = 4;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// 4 bf16 -> f32 (exact: a bf16 is the top half of an f32)
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

using tma::bulk_load;
using tma::mbar_fence_init;
using tma::mbar_init;
using tma::mbar_wait;
using tf32x3::cp_async4;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// tanh(f) = 1 - 2 / (1 + 2^(2 f log2 e)): one ex2 and one rcp on the
// MUFU (each within about 2^-22 relative), against accurate tanhf's 17
// instructions (PERF.md); within ~5e-7 of tanh absolute, +-1 exactly for
// large |f| (2^x overflows to inf, or flushes to 0).  tanh.approx.f32
// (2^-11) would not hold the 1e-5 tolerance.
__device__ __forceinline__ float tanh_mufu(float f) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(f * 2.885390081777927f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return fmaf(-2.f, r, 1.f);
}

// f += (cov * w_c) when kCov; then acc += v * tanh(f)
template <bool kCov>
__device__ __forceinline__ float energy_term(float acc, float x, float d,
                                             float cv, float w, float vv) {
  float f = x + d;
  if (kCov) f = fmaf(cv, w, f);
  return fmaf(vv, tanh_mufu(f), acc);
}

// The cluster's geometry for T positions and at most max_c blocks per
// article: C blocks of P positions each (P a multiple of kChunk; the last
// block may hold fewer or none).
struct Geometry {
  int C, P;
  Geometry(int T, int max_c) {
    const int chunks = (T + kChunk - 1) / kChunk;
    C = chunks < max_c ? chunks : max_c;
    const int per = (T + C - 1) / C;
    P = (per + kChunk - 1) / kChunk * kChunk;
  }
};

// Dynamic shared memory, in floats: the ring's mbarriers, the ring, df
// [K, D], v and w_c [D], the block's mask [P], coverage [K, P] and
// energies / weights [P, K] (only when state_in_smem), its partial
// context [K, D], and per query its max, sum, denominator and the C
// ranks' maxes (then scales) and sums.  (More blocks per article only
// make P smaller.)
inline size_t smem_floats(const Geometry& geo, int D, int K, int elt_bytes,
                          int stages, bool state_in_smem) {
  return kBarFloats + (size_t)stages * kChunk * D * elt_bytes / 4 +
         2 * (size_t)K * D + 2 * (size_t)D +
         (state_in_smem ? (size_t)geo.P * (2 * K + 1) : 0) +
         (size_t)(3 + 2 * geo.C) * K;
}

// grid (C, B) in clusters of (C, 1, 1): one cluster per article;
// smem_floats(...) * 4 bytes of dynamic shared memory.  kSmemState: the
// block's mask, coverage and energies in shared memory (else the mask
// and coverage are read where they lie and the energies kept in attn)
template <typename TIn, bool kCov, int kStages, bool kSmemState>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const TIn* __restrict__ es, const TIn* __restrict__ ef,
                 const float* __restrict__ mask, const float* __restrict__ df,
                 const float* __restrict__ cov, const float* __restrict__ v,
                 const float* __restrict__ wc, float* __restrict__ ctx,
                 float* __restrict__ attn, float* __restrict__ m_out,
                 float* __restrict__ l_out, int T, int T_act, int D, int K,
                 int P) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int row_floats = D * (int)sizeof(TIn) / 4;  // one staged row
  const int chunk_floats = kChunk * row_floats;

  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [kStages]
  float* ring = smem + kBarFloats;
  float* df_s = ring + kStages * chunk_floats;  // [K, D]
  float* v_s = df_s + K * D;                    // [D]
  float* wc_s = v_s + D;                        // [D]
  const int P_s = kSmemState ? P : 0;  // positions kept in shared memory
  float* mask_s = wc_s + D;       // [P] the block's mask
  float* cov_s = mask_s + P_s;    // [K, P] the block's coverage
  float* pe_s = cov_s + K * P_s;  // [P, K]: energies, then exp(e - max)
  float* ctx_s = pe_s + P_s * K;  // [K, D] the block's partial context
  float* m_s = ctx_s + K * D;   // [K] the block's max
  float* l_s = m_s + K;         // [K] the block's sum
  float* den_s = l_s + K;       // [K] the article's denominator
  float* sc_s = den_s + K;      // [C, K] rank maxes, then exp(max_r - M)
  float* ls_s = sc_s + C * K;   // [C, K] rank sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t_begin = rank * P;
  const int n_pos = max(0, min(T_act, t_begin + P) - t_begin);
  const int n_chunks = (n_pos + kChunk - 1) / kChunk;
  const TIn* ef_b = ef + (size_t)b * T * D;
  const TIn* es_b = es + (size_t)b * T * D;
  const float* mask_b = mask + (size_t)b * T + t_begin;
  const float* cov_b = cov + (size_t)b * K * T + t_begin;
  float* attn_b = attn + (size_t)b * K * T + t_begin;
  // the block's per-position state at local position tl, query k: in
  // shared memory, or where it lies in device memory (the energies in
  // attn, which the last step overwrites with the weights)
  auto mask_at = [&](int tl) -> float {
    if constexpr (kSmemState) return mask_s[tl];
    else return mask_b[tl];
  };
  auto cov_at = [&](int k, int tl) -> float {
    if constexpr (kSmemState) return cov_s[k * P + tl];
    else return cov_b[(size_t)k * T + tl];
  };
  auto pe = [&](int tl, int k) -> float& {
    if constexpr (kSmemState) return pe_s[tl * K + k];
    else return attn_b[(size_t)k * T + tl];
  };

  // the ring's sequence: ef chunks 0 .. n_chunks - 1, then es chunks
  const int n_total = 2 * n_chunks;
  // one bulk copy (TMA) per chunk: its rows are contiguous in memory;
  // thread 0 arms the stage's mbarrier with the byte count and issues it
  auto stage = [&](int i) {
    if (tid == 0 && i < n_total) {
      const TIn* src = i < n_chunks ? ef_b : es_b;
      const int c0 = (i < n_chunks ? i : i - n_chunks) * kChunk;
      const unsigned bytes =
          (unsigned)(min(kChunk, n_pos - c0) * D * (int)sizeof(TIn));
      bulk_load(ring + (i % kStages) * chunk_floats,
                src + (size_t)(t_begin + c0) * D, bytes, &bars[i % kStages]);
    }
  };
  static_assert(2 * kStages <= kBarFloats, "room for the mbarriers");
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bars[i]);
    mbar_fence_init();
  }
  __syncthreads();
  // the queries, v, w_c and the block's mask and coverage: one cp.async
  // group, issued with the ring's first chunks
  for (int i = tid; i < K * D / 4; i += kThreads)
    tf32x3::cp_async16(df_s + 4 * i, df + (size_t)b * K * D + 4 * i, 16);
  for (int i = tid; i < D / 4; i += kThreads) {
    tf32x3::cp_async16(v_s + 4 * i, v + 4 * i, 16);
    tf32x3::cp_async16(wc_s + 4 * i, wc + 4 * i, 16);
  }
  if (kSmemState) {
    for (int tl = tid; tl < n_pos; tl += kThreads)
      cp_async4(mask_s + tl, mask_b + tl);
    if (kCov) {
      for (int k = 0; k < K; ++k)
        for (int tl = tid; tl < n_pos; tl += kThreads)
          cp_async4(cov_s + k * P + tl, cov_b + (size_t)k * T + tl);
    }
  }
  tf32x3::cp_async_commit();
  for (int i = 0; i < kStages - 1; ++i) stage(i);

  for (int i = tid; i < K * D; i += kThreads) ctx_s[i] = 0.f;
  for (int k = tid; k < K; k += kThreads) {  // a block with no positions
    m_s[k] = kNeg;
    l_s[k] = 0.f;
  }

  for (int i = 0; i < n_total; ++i) {
    mbar_wait(&bars[i % kStages], (unsigned)(i / kStages) & 1u);
    if (i == 0) tf32x3::cp_async_wait<0>();
    // chunk i (and the constants) have landed for every thread; every
    // warp is done with chunk i - 1, whose buffer the next stage refills
    __syncthreads();
    stage(i + kStages - 1);
    const float* buf = ring + (i % kStages) * chunk_floats;

    if (i < n_chunks) {
      // 1. energies: warp w takes position w of the chunk
      const int tl = i * kChunk + warp;  // warp-uniform
      if (tl < n_pos) {
        const bool valid = mask_at(tl) > 0.f;
        const TIn* row = reinterpret_cast<const TIn*>(buf + warp * row_floats);
        for (int k0 = 0; k0 < K; k0 += kQ) {
          float acc[kQ], cv[kQ];
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            acc[j] = 0.f;
            cv[j] = (kCov && k0 + j < K) ? cov_at(k0 + j, tl) : 0.f;
          }
#pragma unroll 4
          for (int c = lane; c < D / 4; c += 32) {
            const float4 x = load4(row + 4 * c);
            const float4 vv = *reinterpret_cast<const float4*>(v_s + 4 * c);
            const float4 w = *reinterpret_cast<const float4*>(wc_s + 4 * c);
#pragma unroll
            for (int j = 0; j < kQ; ++j) {
              if (k0 + j < K) {
                const float4 d = *reinterpret_cast<const float4*>(
                    df_s + (k0 + j) * D + 4 * c);
                acc[j] = energy_term<kCov>(acc[j], x.x, d.x, cv[j], w.x, vv.x);
                acc[j] = energy_term<kCov>(acc[j], x.y, d.y, cv[j], w.y, vv.y);
                acc[j] = energy_term<kCov>(acc[j], x.z, d.z, cv[j], w.z, vv.z);
                acc[j] = energy_term<kCov>(acc[j], x.w, d.w, cv[j], w.w, vv.w);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            const float e = warp_sum(acc[j]);
            if (lane == 0 && k0 + j < K) pe(tl, k0 + j) = valid ? e : kNeg;
          }
        }
      }
      continue;
    }

    if (i == n_chunks) {
      // 2. the block's softmax statistics: a warp per query, lanes over
      //    the block's positions (every energy written before the barrier
      //    at the top of this iteration)
      for (int k = warp; k < K; k += kWarps) {
        float m = kNeg;
        for (int tl = lane; tl < n_pos; tl += 32) m = fmaxf(m, pe(tl, k));
        m = warp_max(m);
        float l = 0.f;
        for (int tl = lane; tl < n_pos; tl += 32) {
          const float p = mask_at(tl) > 0.f ? expf(pe(tl, k) - m) : 0.f;
          pe(tl, k) = p;
          l += p;
        }
        l = warp_sum(l);
        if (lane == 0) {
          m_s[k] = m;
          l_s[k] = l;
        }
      }
      __syncthreads();
    }

    // 3. partial context: a thread owns columns 2c, 2c + 1 of every query
    const int c0 = (i - n_chunks) * kChunk;  // the chunk's first position
    const int n_here = min(kChunk, n_pos - c0);
    const TIn* rows = reinterpret_cast<const TIn*>(buf);
    for (int c = tid; c < D / 2; c += kThreads) {
      for (int k0 = 0; k0 < K; k0 += kQ) {
        float a[kQ][2];
#pragma unroll
        for (int j = 0; j < kQ; ++j) a[j][0] = a[j][1] = 0.f;
        for (int r = 0; r < n_here; ++r) {
          const float2 x = load2(rows + (size_t)r * D + 2 * c);
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            if (k0 + j < K) {
              const float pr = pe(c0 + r, k0 + j);
              a[j][0] = fmaf(pr, x.x, a[j][0]);
              a[j][1] = fmaf(pr, x.y, a[j][1]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (k0 + j < K) {
            float2* dst =
                reinterpret_cast<float2*>(ctx_s + (k0 + j) * D + 2 * c);
            const float2 old = *dst;
            *dst = make_float2(old.x + a[j][0], old.y + a[j][1]);
          }
        }
      }
    }
  }
  tf32x3::cp_async_wait<0>();  // no copy may outlive the block (T = 0)

  // 4. merge across the cluster: every block's statistics and partial
  //    context are complete after this barrier
  cluster.sync();
  // every rank's (max, sum) into this block's memory, one remote read
  // per thread, then the article's max, the rank scales and the
  // denominator per query
  for (int i = tid; i < C * K; i += kThreads) {
    sc_s[i] = cluster.map_shared_rank(m_s, i / K)[i % K];
    ls_s[i] = cluster.map_shared_rank(l_s, i / K)[i % K];
  }
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    float M = kNeg;
    for (int r = 0; r < C; ++r) M = fmaxf(M, sc_s[r * K + k]);
    float den = 0.f;
    for (int r = 0; r < C; ++r) {  // rank order: the same bits every run
      const float sc = expf(sc_s[r * K + k] - M);
      sc_s[r * K + k] = sc;
      den = fmaf(ls_s[r * K + k], sc, den);
    }
    den_s[k] = fmaxf(den, kDenomFloor);
    if (m_out != nullptr && rank == 0) {  // the sp-block form
      m_out[(size_t)b * K + k] = M;
      l_out[(size_t)b * K + k] = den;
    }
  }
  __syncthreads();

  // this block's slice of ctx [K, D], summed over the ranks in order
  const int KD = K * D;
  const int per = (KD + C - 1) / C;
  const int hi = min(KD, (rank + 1) * per);
  for (int idx = rank * per + tid; idx < hi; idx += kThreads) {
    const int k = idx / D;
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < C; ++r)  // the loads of an unrolled run overlap
      s = fmaf(cluster.map_shared_rank(ctx_s, r)[idx], sc_s[r * K + k], s);
    ctx[(size_t)b * KD + idx] = s / den_s[k];
  }
  // the normalised attention of this block's positions (a masked one has
  // weight 0, so exactly 0)
  // (read and written by one thread, in place when kept in attn)
  for (int k = 0; k < K; ++k) {
    const float sc = sc_s[rank * K + k], den = den_s[k];
    float* out = attn_b + (size_t)k * T;
    for (int tl = tid; tl < n_pos; tl += kThreads)
      out[tl] = pe(tl, k) * sc / den;
  }
  // the positions past the bound get weight 0, exactly as a masked one
  // does: each block writes its share of [T_act, T) for every query
  const int tail = T - T_act;
  if (tail > 0) {
    const int per_tail = (tail + C - 1) / C;
    const int z_lo = T_act + rank * per_tail;
    const int z_hi = min(T, z_lo + per_tail);
    float* attn_a = attn + (size_t)b * K * T;
    for (int k = 0; k < K; ++k)
      for (int t = z_lo + tid; t < z_hi; t += kThreads)
        attn_a[(size_t)k * T + t] = 0.f;
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// Dynamic shared memory of the slab form, in floats: the mbarriers, a
// ring of kSlabRing chunks of kChunk rows of S columns, a slab of df
// [K, S], v and w_c [S], the state as in the dense form, the slab's
// partial context [K, S] and the per-query scalars.
inline size_t slab_smem_floats(const Geometry& geo, int S, int K, int elt,
                               bool state_in_smem) {
  return kBarFloats + (size_t)kSlabRing * kChunk * S * elt / 4 +
         2 * (size_t)K * S + 2 * (size_t)S +
         (state_in_smem ? (size_t)geo.P * (2 * K + 1) : 0) +
         (size_t)(3 + 2 * geo.C) * K;
}

// The slab form: grid and clusters as the dense kernel's, D in slabs of
// S columns (see the header).  The ring's sequence: ef chunks of slab 0,
// of slab 1, ..., then es chunks slab by slab.
template <typename TIn, bool kCov, bool kSmemState>
__global__ void __launch_bounds__(kThreads, 1)
attention_slab_kernel(const TIn* __restrict__ es, const TIn* __restrict__ ef,
                      const float* __restrict__ mask,
                      const float* __restrict__ df,
                      const float* __restrict__ cov,
                      const float* __restrict__ v,
                      const float* __restrict__ wc, float* __restrict__ ctx,
                      float* __restrict__ attn, float* __restrict__ m_out,
                      float* __restrict__ l_out, int T, int T_act, int D,
                      int K, int P, int S) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int row_floats = S * (int)sizeof(TIn) / 4;  // one staged row slab
  const int chunk_floats = kChunk * row_floats;
  const int nS = (D + S - 1) / S;

  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [kSlabRing]
  float* ring = smem + kBarFloats;
  float* df_s = ring + kSlabRing * chunk_floats;  // [K, S] a slab of df
  float* v_s = df_s + K * S;                      // [S]
  float* wc_s = v_s + S;                          // [S]
  const int P_s = kSmemState ? P : 0;
  float* mask_s = wc_s + S;       // [P]
  float* cov_s = mask_s + P_s;    // [K, P]
  float* pe_s = cov_s + K * P_s;  // [P, K]: energies, then exp(e - max)
  float* ctx_s = pe_s + P_s * K;  // [K, S] the slab's partial context
  float* m_s = ctx_s + K * S;     // [K] the block's max
  float* l_s = m_s + K;           // [K] the block's sum
  float* den_s = l_s + K;         // [K] the article's denominator
  float* sc_s = den_s + K;        // [C, K] rank maxes, then exp(max_r - M)
  float* ls_s = sc_s + C * K;     // [C, K] rank sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t_begin = rank * P;
  const int n_pos = max(0, min(T_act, t_begin + P) - t_begin);
  const int n_chunks = (n_pos + kChunk - 1) / kChunk;
  const TIn* ef_b = ef + (size_t)b * T * D;
  const TIn* es_b = es + (size_t)b * T * D;
  const float* mask_b = mask + (size_t)b * T + t_begin;
  const float* cov_b = cov + (size_t)b * K * T + t_begin;
  float* attn_b = attn + (size_t)b * K * T + t_begin;
  auto mask_at = [&](int tl) -> float {
    if constexpr (kSmemState) return mask_s[tl];
    else return mask_b[tl];
  };
  auto cov_at = [&](int k, int tl) -> float {
    if constexpr (kSmemState) return cov_s[k * P + tl];
    else return cov_b[(size_t)k * T + tl];
  };
  auto pe = [&](int tl, int k) -> float& {
    if constexpr (kSmemState) return pe_s[tl * K + k];
    else return attn_b[(size_t)k * T + tl];
  };
  auto width = [&](int s) { return min(S, D - s * S); };

  const int per_pass = nS * n_chunks;
  const int n_total = 2 * per_pass;
  // chunk i: its rows' slab, one bulk copy per row on the stage's
  // mbarrier, armed once with the chunk's bytes
  auto stage = [&](int i) {
    if (tid == 0 && i < n_total) {
      const bool is_ef = i < per_pass;
      const int q = is_ef ? i : i - per_pass;
      const int s = q / n_chunks, c0 = (q % n_chunks) * kChunk;
      const int rows = min(kChunk, n_pos - c0);
      const unsigned row_bytes = (unsigned)(width(s) * (int)sizeof(TIn));
      float* dst = ring + (i % kSlabRing) * chunk_floats;
      const TIn* src =
          (is_ef ? ef_b : es_b) + (size_t)(t_begin + c0) * D + (size_t)s * S;
      tma::mbar_arrive_tx(&bars[i % kSlabRing], rows * row_bytes);
      for (int r = 0; r < rows; ++r)
        tma::bulk_copy(dst + r * row_floats, src + (size_t)r * D, row_bytes,
                       &bars[i % kSlabRing]);
    }
  };
  static_assert(2 * kSlabRing <= kBarFloats, "room for the mbarriers");
  if (tid == 0) {
    for (int i = 0; i < kSlabRing; ++i) mbar_init(&bars[i]);
    mbar_fence_init();
  }
  __syncthreads();
  if (kSmemState) {
    for (int tl = tid; tl < n_pos; tl += kThreads)
      cp_async4(mask_s + tl, mask_b + tl);
    if (kCov) {
      for (int k = 0; k < K; ++k)
        for (int tl = tid; tl < n_pos; tl += kThreads)
          cp_async4(cov_s + k * P + tl, cov_b + (size_t)k * T + tl);
    }
  }
  tf32x3::cp_async_commit();
  for (int i = 0; i < kSlabRing - 1; ++i) stage(i);
  for (int k = tid; k < K; k += kThreads) {  // a block with no positions
    m_s[k] = kNeg;
    l_s[k] = 0.f;
  }

  // 1. energies, slab by slab, summed into the per-position state; the
  //    mask applied with the last slab
  int i = 0;  // the ring's chunk
  for (int s = 0; s < nS; ++s) {
    const int w4 = width(s) / 4;
    __syncthreads();  // every warp is done with the last slab's queries
    for (int idx = tid; idx < K * w4; idx += kThreads) {
      const int k = idx / w4, c = idx - k * w4;
      *reinterpret_cast<float4*>(df_s + k * S + 4 * c) = load4(
          df + ((size_t)b * K + k) * D + (size_t)s * S + 4 * c);
    }
    for (int c = tid; c < w4; c += kThreads) {
      *reinterpret_cast<float4*>(v_s + 4 * c) = load4(v + s * S + 4 * c);
      *reinterpret_cast<float4*>(wc_s + 4 * c) = load4(wc + s * S + 4 * c);
    }
    for (int j = 0; j < n_chunks; ++j, ++i) {
      mbar_wait(&bars[i % kSlabRing], (unsigned)(i / kSlabRing) & 1u);
      if (i == 0) tf32x3::cp_async_wait<0>();
      // chunk i, the slab's queries and the state have landed for every
      // thread; every warp is done with chunk i - 1
      __syncthreads();
      stage(i + kSlabRing - 1);
      const float* buf = ring + (i % kSlabRing) * chunk_floats;
      const int tl = j * kChunk + warp;  // warp-uniform
      if (tl >= n_pos) continue;
      const bool valid = mask_at(tl) > 0.f;
      const TIn* row = reinterpret_cast<const TIn*>(buf + warp * row_floats);
      for (int k0 = 0; k0 < K; k0 += kQ) {
        float acc[kQ], cv[kQ];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          acc[q] = 0.f;
          cv[q] = (kCov && k0 + q < K) ? cov_at(k0 + q, tl) : 0.f;
        }
#pragma unroll 4
        for (int c = lane; c < w4; c += 32) {
          const float4 x = load4(row + 4 * c);
          const float4 vv = *reinterpret_cast<const float4*>(v_s + 4 * c);
          const float4 w = *reinterpret_cast<const float4*>(wc_s + 4 * c);
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            if (k0 + q < K) {
              const float4 d = *reinterpret_cast<const float4*>(
                  df_s + (k0 + q) * S + 4 * c);
              acc[q] = energy_term<kCov>(acc[q], x.x, d.x, cv[q], w.x, vv.x);
              acc[q] = energy_term<kCov>(acc[q], x.y, d.y, cv[q], w.y, vv.y);
              acc[q] = energy_term<kCov>(acc[q], x.z, d.z, cv[q], w.z, vv.z);
              acc[q] = energy_term<kCov>(acc[q], x.w, d.w, cv[q], w.w, vv.w);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float e = warp_sum(acc[q]);
          if (lane == 0 && k0 + q < K) {
            float& p = pe(tl, k0 + q);
            const float tot = s == 0 ? e : p + e;
            p = (s == nS - 1 && !valid) ? kNeg : tot;
          }
        }
      }
    }
  }
  tf32x3::cp_async_wait<0>();  // no copy may outlive the block (T = 0)
  __syncthreads();             // every energy is written

  // 2. the block's softmax statistics: a warp per query
  for (int k = warp; k < K; k += kWarps) {
    float m = kNeg;
    for (int tl = lane; tl < n_pos; tl += 32) m = fmaxf(m, pe(tl, k));
    m = warp_max(m);
    float l = 0.f;
    for (int tl = lane; tl < n_pos; tl += 32) {
      const float p = mask_at(tl) > 0.f ? expf(pe(tl, k) - m) : 0.f;
      pe(tl, k) = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_s[k] = m;
      l_s[k] = l;
    }
  }
  // 3. the article's max, the rank scales and the denominator per query,
  //    from every rank's statistics (as the dense form's merge)
  cluster.sync();
  for (int idx = tid; idx < C * K; idx += kThreads) {
    sc_s[idx] = cluster.map_shared_rank(m_s, idx / K)[idx % K];
    ls_s[idx] = cluster.map_shared_rank(l_s, idx / K)[idx % K];
  }
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    float M = kNeg;
    for (int r = 0; r < C; ++r) M = fmaxf(M, sc_s[r * K + k]);
    float den = 0.f;
    for (int r = 0; r < C; ++r) {  // rank order: the same bits every run
      const float sc = expf(sc_s[r * K + k] - M);
      sc_s[r * K + k] = sc;
      den = fmaf(ls_s[r * K + k], sc, den);
    }
    den_s[k] = fmaxf(den, kDenomFloor);
    if (m_out != nullptr && rank == 0) {  // the sp-block form
      m_out[(size_t)b * K + k] = M;
      l_out[(size_t)b * K + k] = den;
    }
  }
  __syncthreads();

  // 4. the context, slab by slab: each block's partial context of the
  //    slab (a thread owns columns 2c, 2c + 1 of every query), merged
  //    over the cluster's ranks in order into the slab's columns of ctx
  for (int s = 0; s < nS; ++s) {
    const int w = width(s);
    for (int c = tid; c < w / 2; c += kThreads)
      for (int k = 0; k < K; ++k)
        *reinterpret_cast<float2*>(ctx_s + k * S + 2 * c) =
            make_float2(0.f, 0.f);
    for (int j = 0; j < n_chunks; ++j, ++i) {
      mbar_wait(&bars[i % kSlabRing], (unsigned)(i / kSlabRing) & 1u);
      __syncthreads();
      stage(i + kSlabRing - 1);
      const TIn* rows =
          reinterpret_cast<const TIn*>(ring + (i % kSlabRing) * chunk_floats);
      const int c0 = j * kChunk;
      const int n_here = min(kChunk, n_pos - c0);
      for (int c = tid; c < w / 2; c += kThreads) {
        for (int k0 = 0; k0 < K; k0 += kQ) {
          float a[kQ][2];
#pragma unroll
          for (int q = 0; q < kQ; ++q) a[q][0] = a[q][1] = 0.f;
          for (int r = 0; r < n_here; ++r) {
            const float2 x = load2(rows + (size_t)r * S + 2 * c);
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
              if (k0 + q < K) {
                const float pr = pe(c0 + r, k0 + q);
                a[q][0] = fmaf(pr, x.x, a[q][0]);
                a[q][1] = fmaf(pr, x.y, a[q][1]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            if (k0 + q < K) {
              float2* dst =
                  reinterpret_cast<float2*>(ctx_s + (k0 + q) * S + 2 * c);
              const float2 old = *dst;
              *dst = make_float2(old.x + a[q][0], old.y + a[q][1]);
            }
          }
        }
      }
    }
    cluster.sync();  // every block's partial context of slab s is complete
    const int KW = K * w;
    const int per = (KW + C - 1) / C;
    const int hi = min(KW, (rank + 1) * per);
    for (int idx = rank * per + tid; idx < hi; idx += kThreads) {
      const int k = idx / w, d = idx - k * w;
      float acc = 0.f;
#pragma unroll 8
      for (int r = 0; r < C; ++r)
        acc = fmaf(cluster.map_shared_rank(ctx_s, r)[k * S + d],
                   sc_s[r * K + k], acc);
      ctx[((size_t)b * K + k) * D + (size_t)s * S + d] = acc / den_s[k];
    }
    cluster.sync();  // no block refills its ctx_s while another reads it
  }

  // the normalised attention of this block's positions, and 0 past the
  // bound, as the dense form writes them
  for (int k = 0; k < K; ++k) {
    const float sc = sc_s[rank * K + k], den = den_s[k];
    float* out = attn_b + (size_t)k * T;
    for (int tl = tid; tl < n_pos; tl += kThreads)
      out[tl] = pe(tl, k) * sc / den;
  }
  const int tail = T - T_act;
  if (tail > 0) {
    const int per_tail = (tail + C - 1) / C;
    const int z_lo = T_act + rank * per_tail;
    const int z_hi = min(T, z_lo + per_tail);
    float* attn_a = attn + (size_t)b * K * T;
    for (int k = 0; k < K; ++k)
      for (int t = z_lo + tid; t < z_hi; t += kThreads)
        attn_a[(size_t)k * T + t] = 0.f;
  }
}

// Launch the kernel instantiation kKernel over (C, B) blocks in clusters
// of C, with `smem_bytes` of dynamic shared memory (wide: a non-portable
// cluster of 16 blocks)
template <auto kKernel, typename... Args>
cudaError_t launch_clusters(const Geometry& geo, int B, bool wide,
                            size_t smem_bytes, int dev, cudaStream_t stream,
                            Args... args) {
  auto kernel = kKernel;
  static unsigned smem_set = 0, wide_set = 0;  // per instantiation
  // the attribute is the most any call may ask; each launch asks its own
  cudaError_t err = tf32x3::allow_smem(kernel, kSmemMax, smem_set);
  if (err != cudaSuccess) return err;
  if (wide && !(dev < 32 && (wide_set >> dev) & 1u)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (dev < 32) wide_set |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.C, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TIn, bool kCov>
cudaError_t launch(const void* es, const void* ef, const float* mask,
                   const float* df, const float* cov, const float* v,
                   const float* wc, float* ctx, float* attn, float* m_out,
                   float* l_out, int B, int T, int T_act, int D, int K,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // few articles: 16 blocks each, with a deeper ring, while their clusters
  // take at most half the SMs, so the long form still spreads over the card
  const bool wide = B * kWideCluster * 2 <= sms;
  // the blocks split the bound, so a short one still spreads over the
  // whole cluster
  const Geometry geo(T_act, wide ? kWideCluster : kCluster);
  const TIn* es_t = static_cast<const TIn*>(es);
  const TIn* ef_t = static_cast<const TIn*>(ef);
  // the dense form's ring, halved while the block's constants do not fit
  // beside it (a wide D)
  int stages = wide ? kWideRing : kRing;
  auto bytes_at = [&](int n, bool state) {
    return smem_floats(geo, D, K, sizeof(TIn), n, state) * sizeof(float);
  };
  while (stages > kMinRing && bytes_at(stages, false) > kSmemMax) stages /= 2;
  if (bytes_at(stages, false) > kSmemMax) {
    // the slab form, where even kMinRing chunks of whole rows do not fit
    // beside the queries: slabs of kSlab columns, halved while K
    // queries' slabs do not fit
    int S = kSlab;
    auto slab_bytes = [&](int n, bool state) {
      return slab_smem_floats(geo, n, K, sizeof(TIn), state) * sizeof(float);
    };
    while (S > kMinSlab && slab_bytes(S, false) > kSmemMax) S /= 2;
    if (slab_bytes(S, false) > kSmemMax) return cudaErrorInvalidValue;
    const bool state = slab_bytes(S, true) <= kSmemMax;
#define TS_SLAB(STATE)                                                      \
  launch_clusters<&attention_slab_kernel<TIn, kCov, STATE>>(                \
      geo, B, wide, slab_bytes(S, STATE), dev, stream, es_t, ef_t, mask, df,\
      cov, v, wc, ctx, attn, m_out, l_out, T, T_act, D, K, geo.P, S)
    return state ? TS_SLAB(true) : TS_SLAB(false);
#undef TS_SLAB
  }
  const bool in_smem = bytes_at(stages, true) <= kSmemMax;
#define TS_LAUNCH(STAGES, STATE)                                            \
  launch_clusters<&attention_kernel<TIn, kCov, STAGES, STATE>>(             \
      geo, B, wide, bytes_at(STAGES, STATE), dev, stream, es_t, ef_t, mask, \
      df, cov, v, wc, ctx, attn, m_out, l_out, T, T_act, D, K, geo.P)
  static_assert(kWideRing == 8 && kRing == 4 && kMinRing == 2,
                "the instantiations below");
  switch (stages) {
    case 8:
      return in_smem ? TS_LAUNCH(8, true) : TS_LAUNCH(8, false);
    case 4:
      return in_smem ? TS_LAUNCH(4, true) : TS_LAUNCH(4, false);
    default:
      return in_smem ? TS_LAUNCH(2, true) : TS_LAUNCH(2, false);
  }
#undef TS_LAUNCH
}

}  // namespace

// es, ef [B, T, D] (f32, or bf16 when is_bf16; 16-byte aligned, D a
// multiple of 4, of 8 in bf16); mask [B, T]; df [B, K, D]; cov [B, K, T]
// (read only when use_cov); v, wc [D]; outputs ctx [B, K, D], attn
// [B, K, T]; with m_out and l_out (both, or neither) the sp-block form
// also writes the row max and the unfloored row sum [B, K].  All float32
// unless noted, contiguous, on one device.  Only the first T_act
// positions (1 <= T_act <= T) are read; attn is 0 past them.
// Launches on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape the kernel does not take: more
// articles than the grid's y extent, or so many queries K that even
// their slabs of kMinSlab columns do not fit in shared memory).  Every
// width D is taken: the dense form where its constants fit one block,
// the slab form elsewhere.
extern "C" int ts_fused_attention_shared(const void* es, const void* ef,
                                         const float* mask, const float* df,
                                         const float* cov, const float* v,
                                         const float* wc, float* ctx,
                                         float* attn, float* m_out,
                                         float* l_out, int B, int T,
                                         int T_act, int D, int K, int use_cov,
                                         int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elt = is_bf16 ? 2 : 4;
  if (B <= 0 || T <= 0 || D <= 0 || K <= 0 || B > 65535 ||
      D % (16 / elt) != 0 || T_act < 1 || T_act > T ||
      (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
#define TS_DISPATCH(TIN, COV)                                                \
  launch<TIN, COV>(es, ef, mask, df, cov, v, wc, ctx, attn, m_out, l_out, B, \
                   T, T_act, D, K, st)
  if (is_bf16)
    return (int)(use_cov ? TS_DISPATCH(__nv_bfloat16, true)
                         : TS_DISPATCH(__nv_bfloat16, false));
  return (int)(use_cov ? TS_DISPATCH(float, true) : TS_DISPATCH(float, false));
#undef TS_DISPATCH
}

extern "C" const char* ts_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
