// Flash self-attention at head dims above 256 for Hopper: the forward, the
// dK/dV and the dQ kernels, each for f32 and for bf16 operands.
//
// Replaces the library Pallas kernels the JAX package's transformer calls
// for self-attention (textsummarization_on_flink_tpu/models/transformer.py
// :285) at the head dims the kernels of flash_attention.cu and
// flash_attention_bwd.cu (built for 32, 128 and 256) do not take: the
// forward `_flash_attention_kernel` (flash_attention.py:331 of the
// installed jax, `pl.pallas_call` :758), `_flash_attention_bwd_dkv` (:941,
// :1121) and `_flash_attention_bwd_dq` (:1287, :1456).  The JAX package
// zero-pads any head dim to a multiple of 128 for the library kernel
// (models/transformer.py:262-272); ops/flash_attention.py pads the same way
// and sends a padded head dim above 256 here.  Per article b, head h and
// query row i (q, out, dout, dq [B, Tq, nh, hd], k, v, dk, dv [B, Tk, nh,
// hd], contiguous; Tq < Tk is one sp rank's block of query rows against
// every key, and needs causal off):
//
//   s_j   = (q_i . k_j) * sm_scale   for every key j the row may attend:
//           key_mask[b, j] > 0 (all keys when key_mask is null) and, when
//           causal, j <= i
//   out_i = sum_j softmax(s)_j v_j   (zeros, lse +inf, when it may attend
//                                     none)
//   backward, with P = exp(s - lse) and D = rowsum(dO * O) (taken in
//   PyTorch): dS = P (dO . v - D), dV = P^T dO, dK = scale dS^T Q,
//   dQ = scale dS K.
//
// bf16 operands round where the library rounds (the module docstring of
// ops/flash_attention.py): products of bf16 values are exact in f32 and
// summed in f32; P is rounded to bf16 before P V and before dV = P^T dO,
// scale * dS before dK and dQ, each output once.  f32 operands stay at
// f32 accuracy: 3xTF32 on the tensor cores (mma_tf32x3.cuh), or f32 FMA.
//
// What bounds them on an H100: operations.  At 16 x 400 x 1 x 512 with a
// key mask the forward does 4 * hd per attended pair, 5.24 GFLOP: 0.032
// ms at the 3xTF32 rate of the f32 kernels (165 TFLOP/s), 0.0053 ms at
// the bf16 tensor-core rate, where the 26.2 MB of bf16 q, k, v and out
// (0.0078 ms at 3.35 TB/s) bound it instead; dK/dV does 8 * hd, dQ 6 *
// hd.
//
// Up to head dim 2048: a thread block cluster per (block of rows, head,
// article) splits the head dim.
//
//   * the cluster holds hd / 128 blocks, at most 16 (the H100's limit;
//     past the portable 8 `NonPortableClusterSizeAllowed` is set on the
//     kernel at first use); at first use per kernel and cluster size the
//     launch asks
//     cudaOccupancyMaxActiveClusters whether one cluster fits, and
//     returns an error if none does (no fallback to another form);
//     block r owns the columns [128 r, 128 r + 128) of q, k, v (and dO)
//     and of its output, so its registers and tiles are those of the
//     head-dim-128 kernels of flash_attention.cu and
//     flash_attention_bwd.cu, and the cluster fills the card where the
//     heads are few (16 x 400 x 1 x 512: 448 blocks where 64-row blocks
//     alone would be 112);
//   * per tile of the loop each block forms its partial S = Q K^T (and in
//     the backward the partial dP = dO V^T, transposed in dK/dV) over its
//     128 columns on the tensor cores, writes it to shared memory in its
//     accumulator fragment layout, and after one cluster barrier every
//     block adds the cluster's partials, read through distributed shared
//     memory, in rank order: every block holds the same S, so the softmax
//     (its running max and sum) is the same in each, and S and dP are
//     formed once per tile for all the output's columns.  The partials
//     alternate between two buffers, so one barrier a tile keeps a buffer
//     from being rewritten while a peer reads it.  The bf16 dQ, the bf16
//     forward and dK/dV past 8 blocks, the f32 forward past 14 and the
//     f32 dQ past 9 (the f32 dK/dV spilled with it) split the sum in two
//     (sum_share, gather_sums): block r sums its 1/C of the buffer over
//     the cluster in rank order, and after a second barrier every block
//     reads each sum from its owner; the same bits, with 2 (C - 1) / C
//     of a buffer read from the peers where the one sum reads C - 1
//     buffers (on an H100 the one sum's exchange was 68% of the bf16
//     dQ's time at 16 x 400 x 1 x 512 and 85% at x 1024; in the f32 dQ,
//     whose partials are 8 keys wide, the second barrier cost more than
//     the reads it saved up to 9 blocks).  The forms up to 8 blocks are
//     the templates' one-sum instances (kSplit false; the bf16 dQ's
//     kMaxC 8), built as before the 16-block forms were added;
//   * f32: the geometry of the f32 kernels at hd 128 (4 warps, 64 rows or
//     keys a block; key tiles of 16 (forward) or 8 (dQ), or query tiles
//     of 8 rows, staged by cp.async, double-buffered, split to hi/lo
//     once); S, dP, P V, dV, dK and dQ are m16n8k8 3xTF32 `mma.sync`
//     products (mma_tf32x3.cuh); the forward exchanges the next tile's
//     partial S behind this tile's P V, the cluster barrier split into
//     its arrive and its wait; the dQ's dS K reads the K tile S read;
//   * bf16: two warpgroups of 64 rows or keys a block (128 in all) run
//     their products as `wgmma` (wgmma_bf16.cuh) on tiles the TMA unit
//     copies (128-column boxes of the head: the tensor maps span the whole
//     head dim, each block's copies start at its slab), 2 stages, the
//     next tile's copy issued before the current tile's products; P, dS^T
//     and dS pass to the next product in registers.  No producer
//     warpgroup and no `setmaxnreg`: every thread takes part in the
//     cluster barriers, and thread 0 issues the copies;
//   * a key the row may not attend gets s = -inf (p exactly 0); a tile no
//     key of which is real and unmasked is skipped by the whole cluster
//     (every block reads the same key flags); causal tiles past the
//     block's last row (forward, dQ) or before its first key (dK/dV) are
//     never visited.  No atomics: two runs give the same bits.
//
// Above head dim 2048 the forward, dK/dV and dQ take the multi-slab
// cluster forms (their section below: a block owns up to 4 slabs, up to
// hd 8192), and above 8192 every kind the simple form, SIMT FMA at the
// 67 TFLOP/s f32 rate, each block forming S (and dP) over the whole head
// dim for one 128-wide slab of its output (the SIMT forms also stay
// behind the _simt entry points at any head dim, the design the cluster
// forms replaced, for timing them against it):
//
//   * 256 threads (16 x 16) a block; the block owns 64 rows (query rows
//     in the forward and dQ, keys in dK/dV) and walks 64-wide tiles of
//     the other axis.  A thread holds a 4 x 4 patch of S (rows 4 ty + i,
//     columns tx + 16 j) and a 4 x 8 patch of its output slab;
//   * the head-dim loop: S (and dP) are summed over 32-column chunks of
//     q and k (and dO and v), each chunk staged in shared memory with a
//     padded row (33 floats: the 16 rows a half-warp reads lie in 16
//     banks), so shared memory does not grow with the head dim;
//   * the grid's y axis holds head x slab: each block keeps only its 128
//     columns of O, dK and dV, or dQ;
//   * the forward's online softmax runs on S's registers, the row max and
//     sum reduced over the 16 threads of a half-warp with shuffles; P
//     (and in the backward P and dS) goes through shared memory to the
//     slab product, whose other operand (v, dO and q, or k) is staged 64
//     x 128 in the space the chunks used.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry points (one per
// kernel and dtype) bound with ctypes from ops/flash_attention.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bf16.cuh"  // ex2, align1024, store_rows, wgmma_bf16.cuh
#include "mma_tf32x3.cuh"  // 3xTF32 products, cp.async, allow_smem

namespace {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;
using flash_bf16::align1024;
using flash_bf16::ex2;
using flash_bf16::kLog2e;
using flash_bf16::store_rows;
using tf32x3::FragA;

constexpr float kNeg = -1e30f;  // running-max floor, never -inf
constexpr int kThreads = 256;   // 16 x 16
constexpr int kRows = 64;       // the block's rows (queries, or keys)
constexpr int kCols = 64;       // a tile of the other axis
constexpr int kChunk = 32;      // head-dim columns per chunk of S
constexpr int kCS = kChunk + 1;  // floats per staged chunk row
constexpr int kSlab = 128;      // output columns per block
constexpr int kPS = kCols + 1;  // floats per row of P / dS in shared memory
constexpr int kChunkTile = kRows * kCS;   // floats of one staged chunk
constexpr int kSlabTile = kRows * kSlab;  // floats of one staged slab
constexpr int kPTile = kRows * kPS;       // floats of P or dS
constexpr int kMaxCluster = 8;     // blocks of a portable cluster
constexpr int kMaxClusterNP = 16;  // the H100's largest

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to bf16 (to nearest even) and widened back: exact
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows r0 .. r0 + 63 of one article and head of x (`src` at its position
// 0, `pos_stride` elements between positions), columns c0 .. c0 + W - 1,
// widened to f32 into `dst` (`stride` floats between rows); rows at or
// past T are zeros
template <int W, typename E>
__device__ __forceinline__ void stage(float* dst, int stride, const E* src,
                                      size_t pos_stride, int r0, int T,
                                      int c0, int tid) {
#pragma unroll 4
  for (int e = tid; e < kRows * W; e += kThreads) {
    const int r = e / W, c = e % W;
    const int pos = r0 + r;
    dst[r * stride + c] =
        pos < T ? ld(src + (size_t)pos * pos_stride + c0 + c) : 0.f;
  }
}

// may key `key` of article b (Tk keys) be attended at all (real and
// unmasked)
__device__ __forceinline__ bool key_ok(const float* key_mask, int b, int Tk,
                                       int key) {
  return key < Tk &&
         (key_mask == nullptr || key_mask[(size_t)b * Tk + key] > 0.f);
}
__device__ __forceinline__ float key_flag(const float* key_mask, int b,
                                          int Tk, int key) {
  return key_ok(key_mask, b, Tk, key) ? 1.f : 0.f;
}

// the 16 threads of a half-warp hold one row's columns
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// The cluster forms (head dims up to 128 * kMaxClusterNP).

// acc (kN groups of 4 floats of this thread's fragment, each the
// float4 idx(i) of an exchange buffer) = the cluster's partials at `xb`
// (this block's buffer; the same offset in every block), summed in rank
// order, so every block gets the same bits
template <int kN, class Idx>
__device__ __forceinline__ void sum_partials(float (&acc)[kN][4],
                                             cg::cluster_group& cluster,
                                             float* xb, int C, Idx idx) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int r = 0; r < C; ++r) {
    const float4* px =
        reinterpret_cast<const float4*>(cluster.map_shared_rank(xb, r));
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float4 p = px[idx(i)];
      acc[i][0] += p.x;
      acc[i][1] += p.y;
      acc[i][2] += p.z;
      acc[i][3] += p.w;
    }
  }
}

// The exchange in two halves, each behind a cluster barrier: the float4
// [rank n / C, (rank + 1) n / C) of the cluster's partials at `xb` (n
// float4 in every block, the same offset) summed in rank order over the
// cluster (sum_partials' order: the same bits) and written over this
// block's own partials there, which no peer reads in this half; every
// thread of the block takes part.  C <= kMaxC; the loads of 8 ranks are
// issued before their adds (all of them up to 8 blocks: 32 registers for
// the loads at any cluster size)
template <int kMaxC>
__device__ __forceinline__ void sum_share(cg::cluster_group& cluster,
                                          float* xb, int n, int C,
                                          int threads, int tid) {
  const int rank = (int)cluster.block_rank();
  float4* own = reinterpret_cast<float4*>(xb);
  for (int i = rank * n / C + tid; i < (rank + 1) * n / C; i += threads) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r0 = 0; r0 < kMaxC; r0 += kMaxCluster) {
      float4 p[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r0 + r < C)
          p[r] = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(xb, r0 + r))[i];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r0 + r < C) {
          s.x += p[r].x;
          s.y += p[r].y;
          s.z += p[r].z;
          s.w += p[r].w;
        }
      }
    }
    own[i] = s;
  }
}

// acc (kN float4 idx(i) of the buffers) = the sums sum_share left, each
// read from the block that owns it (the last r with r n / C <= j)
template <int kN, class Idx>
__device__ __forceinline__ void gather_sums(float (&acc)[kN][4],
                                            cg::cluster_group& cluster,
                                            float* xb, int n, int C,
                                            Idx idx) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int j = idx(i);
    const float4 p = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(xb, ((j + 1) * C - 1) / n))[j];
    acc[i][0] = p.x;
    acc[i][1] = p.y;
    acc[i][2] = p.z;
    acc[i][3] = p.w;
  }
}

// The exchange of a forward or dK/dV cluster form, called where its
// partials at `xb` (n float4 in every block) are written and the cluster
// barrier that follows is passed.  kSplit (the bf16 forms past 8 blocks,
// the f32 forward past 12): every thread of the block sums its share
// (sum_share) and waits on a second barrier, then sum_or_gather reads the
// sums (gather_sums); else share_if does nothing and sum_or_gather sums
// all C partials (sum_partials).  The same bits either way
template <bool kSplit>
__device__ __forceinline__ void share_if(cg::cluster_group& cluster,
                                         float* xb, int n, int C,
                                         int threads, int tid) {
  if constexpr (kSplit) {
    sum_share<kMaxClusterNP>(cluster, xb, n, C, threads, tid);
    cluster.sync();
  }
}

template <bool kSplit, int kN, class Idx>
__device__ __forceinline__ void sum_or_gather(float (&acc)[kN][4],
                                              cg::cluster_group& cluster,
                                              float* xb, int n, int C,
                                              Idx idx) {
  if constexpr (kSplit)
    gather_sums<kN>(acc, cluster, xb, n, C, idx);
  else
    sum_partials<kN>(acc, cluster, xb, C, idx);
}

// an accumulator's 4 floats as the float4 of an exchange buffer
__device__ __forceinline__ float4 f4(const float* x) {
  return make_float4(x[0], x[1], x[2], x[3]);
}

// barrier.cluster split in two: a block's threads arrive once their
// partials are written and wait before they read the peers', with other
// work in between
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The f32 forward's block: 64 query rows, 4 warps of 16, key tiles of 16
// keys (the head-dim-128 forward's geometry, flash_attention.cu).  q is
// split once: each warp keeps the TF32 hi parts of its A fragments in
// registers (64 a thread) and writes the lo parts back over the staged
// q, so Q K^T splits nothing per tile (the split at use was a third of
// the instructions).  K and V tiles have rings of their own (hi and lo
// parts, K with the tile's key flags), so that tile it + 1's partial S is
// formed and exchanged while tile it's P V runs; two exchange buffers of
// the warps' S fragments.  109,696 bytes: two blocks an SM.
struct ClusterFwdF32 {
  static constexpr int kThreads = 128;
  static constexpr int kRows = 64;
  static constexpr int kKeys = 16;
  static constexpr int kStride = kSlab + 4;  // floats per shared row
  static constexpr int kKS = kSlab / 8;      // k-steps of Q K^T
  static constexpr int kNT = kKeys / 8;      // 8-key column tiles of S
  static constexpr int kOT = kSlab / 8;      // 8-wide column tiles of O
  static constexpr int kTile = kKeys * kStride;
  static constexpr int kKStage = 2 * kTile + kKeys;  // hi, lo, key flags
  static constexpr int kVStage = 2 * kTile;          // hi, lo
  static constexpr int kQ = kRows * kStride;
  static constexpr int kX = 4 * kNT * 4 * 32;  // floats of a buffer
  static constexpr size_t kSmem =
      (2 * kKStage + 2 * kVStage + kQ + 2 * kX) * sizeof(float);
};

// grid (C * ceil(Tq / 64), nh, B) in clusters of (C, 1, 1), C = hd / 128;
// ClusterFwdF32::kThreads threads, kSmem bytes of dynamic shared memory.
// Iteration it, behind one block barrier: the copy of K(it + 2) and
// V(it + 1) is issued; the warps form K(it + 1)'s partial S, write it and
// arrive on the cluster barrier; run tile it's softmax and P V (its S
// summed in the previous iteration); wait on the barrier and sum tile
// it + 1's partials (kSplit: its share, a second barrier, the sums).  So
// the barrier's latency and the copies overlap the products.
template <bool kSplit>
__global__ void __launch_bounds__(ClusterFwdF32::kThreads, 2)
flash_fwd_cluster_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ key_mask,
                             float* __restrict__ out,
                             float* __restrict__ lse, int Tq, int Tk, int nh,
                             int hd, int causal, float sm_scale) {
  using S = ClusterFwdF32;
  constexpr int kKeys = S::kKeys, kStride = S::kStride, kNT = S::kNT;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * kSlab;
  float* k_ring = smem;                      // 2 x (hi, lo, flags)
  float* v_ring = k_ring + 2 * S::kKStage;   // 2 x (hi, lo)
  float* q_s = v_ring + 2 * S::kVStage;
  float* x_s = q_s + S::kQ;                  // the two exchange buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t base = (size_t)b * Tq * pos_stride + (size_t)h * hd + col0;
  const float* kb = k + (size_t)b * Tk * pos_stride + (size_t)h * hd + col0;
  const float* vb = v + (size_t)b * Tk * pos_stride + (size_t)h * hd + col0;
  const int row0 = qb * S::kRows + warp * 16;  // the warp's first row
  const int rows[2] = {row0 + g, row0 + g + 8};

  // the warp's A fragments of q: hi in registers, lo in q_s (in place)
  float* q_warp = q_s + warp * 16 * kStride;
  uint32_t q_hi[S::kKS][4];
  auto q_at = [&](int kk, int i) {  // A fragment element i of k-step kk
    return q_warp + 8 * kk + (g + 8 * (i & 1)) * kStride + t + 4 * (i >> 1);
  };
  auto q_frag = [&](int kk) -> FragA {
    FragA f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f.hi[i] = q_hi[kk][i];
      f.lo[i] = __float_as_uint(*q_at(kk, i));
    }
    return f;
  };
  float o[S::kOT][4];
#pragma unroll
  for (int n = 0; n < S::kOT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, (qb + 1) * S::kRows) : Tk;
  const int n_tiles = (t_end + kKeys - 1) / kKeys;

  auto stage_k = [&](int tile) {
    float* ks = k_ring + (tile & 1) * S::kKStage;
    const int k0 = tile * kKeys;
    tf32x3::stage_rows<kSlab, S::kThreads>(ks, kStride, kb, pos_stride, k0,
                                           kKeys, Tk, tid);
    for (int j = tid; j < kKeys; j += S::kThreads)
      ks[2 * S::kTile + j] = key_flag(key_mask, b, Tk, k0 + j);
  };
  auto stage_v = [&](int tile) {
    tf32x3::stage_rows<kSlab, S::kThreads>(v_ring + (tile & 1) * S::kVStage,
                                           kStride, vb, pos_stride,
                                           tile * kKeys, kKeys, Tk, tid);
  };
  // each thread splits the chunks it copied (stage_rows' split)
  auto split_k = [&](int tile) {
    float* ks = k_ring + (tile & 1) * S::kKStage;
    tf32x3::split_tile<kSlab, S::kThreads>(ks, ks + S::kTile, kStride, kKeys,
                                           tid);
  };
  auto split_v = [&](int tile) {
    float* vs = v_ring + (tile & 1) * S::kVStage;
    tf32x3::split_tile<kSlab, S::kThreads>(vs, vs + S::kTile, kStride, kKeys,
                                           tid);
  };
  // does the warp run the tile: its rows are real (the last block of an
  // article may hold fewer than 64) and, causal, the last of them does not
  // precede the tile (the same warp of every block)
  auto active = [&](int tile) {
    return row0 < Tq && (!causal || tile * kKeys <= row0 + 15);
  };
  auto xi = [&](int j) { return (warp * kNT + j) * 32 + lane; };
  // this block's partial S of a tile over its 128 columns into exchange
  // buffer `xb`, and this thread's key flags of it (bit 2 j + e: column
  // 8 j + 2 t + e)
  auto partial = [&](int tile, float* xb, unsigned& ok_bits) {
    const float* ks = k_ring + (tile & 1) * S::kKStage;
    float s[kNT][4];
    const tf32x3::SplitTile kt{ks, ks + S::kTile};
    tf32x3::head_dim_product<kNT, S::kKS>(s, q_frag, kt, kStride, g, t);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      reinterpret_cast<float4*>(xb)[xi(j)] = f4(s[j]);
    ok_bits = 0;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ok_bits |= (ks[2 * S::kTile + 8 * j + 2 * t + e] > 0.f ? 1u : 0u)
                   << (2 * j + e);
  };
  // does any key of a staged tile be real and unmasked (every block of the
  // cluster reads the same flags); also the block's barrier
  auto any_key = [&](int tile) {
    return __syncthreads_or(tile < n_tiles && tid < kKeys &&
                            k_ring[(tile & 1) * S::kKStage + 2 * S::kTile +
                                   tid] > 0.f);
  };

  // the first tile: q, K(0), V(0) and K(1) in one copy; tile 0's S
  tf32x3::stage_rows<kSlab, S::kThreads>(q_s, kStride, q + base, pos_stride,
                                         qb * S::kRows, S::kRows, Tq, tid);
  stage_k(0);
  stage_v(0);
  if (n_tiles > 1) stage_k(1);
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<0>();
  split_k(0);
  split_v(0);
  if (n_tiles > 1) split_k(1);
  __syncthreads();  // q has landed for every warp
#pragma unroll
  for (int kk = 0; kk < S::kKS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* x = q_at(kk, i);
      uint32_t lo;
      tf32x3::split(*x, q_hi[kk][i], lo);
      *x = __uint_as_float(lo);  // only this lane reads it
    }
  bool any_cur = any_key(0);
  int ex = 0;  // exchanges so far: their buffers alternate
  float s_cur[kNT][4];
  unsigned ok_cur = 0;
  if (any_cur) {
    float* xb = x_s + (ex & 1) * S::kX;
    if (active(0)) partial(0, xb, ok_cur);
    cluster.sync();
    share_if<kSplit>(cluster, xb, S::kX / 4, C, S::kThreads, tid);
    if (active(0))
      sum_or_gather<kSplit>(s_cur, cluster, xb, S::kX / 4, C, xi);
    ++ex;
  }
  for (int it = 0; it < n_tiles; ++it) {
    if (it > 0) {  // K(it + 1) and V(it), copied during tile it - 1
      tf32x3::cp_async_wait<0>();
      if (it + 1 < n_tiles) split_k(it + 1);
      split_v(it);
    }
    // the copies have landed and every warp is done with tile it - 1
    const bool any_next = any_key(it + 1);
    if (it + 2 < n_tiles) stage_k(it + 2);  // K(it)'s stage: S(it) formed
    if (it + 1 < n_tiles) stage_v(it + 1);  // V(it - 1)'s stage
    tf32x3::cp_async_commit();
    // tile it + 1's partial S, exchanged behind tile it's products
    float* xb = x_s + (ex & 1) * S::kX;
    unsigned ok_next = 0;
    if (any_next) {
      if (active(it + 1)) partial(it + 1, xb, ok_next);
      cluster_arrive();
    }
    if (any_cur && active(it)) {
      const int k0 = it * kKeys;
      const bool diag = causal && k0 + kKeys - 1 > qb * S::kRows;
      float s[kNT][4];
      float cmax[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int r = e >> 1;
          const bool ok = ((ok_cur >> (2 * j + (e & 1))) & 1) &&
                          (!diag || k0 + col <= rows[r]);
          s[j][e] = ok ? s_cur[j][e] * sm_scale : -INFINITY;
          cmax[r] = fmaxf(cmax[r], s[j][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 1));
        cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 2));
        const float m_new = fmaxf(m[r], cmax[r]);
        alpha[r] = expf(m[r] - m_new);  // 0 on the row's first real key
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < S::kOT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m[e >> 1]);  // masked: exactly 0
          s[j][e] = p;
          l[e >> 1] += p;
        }
      }
      // O += P V over this block's columns
      const float* vs = v_ring + (it & 1) * S::kVStage;
      const tf32x3::SplitTile vt{vs, vs + S::kTile};
      tf32x3::tile_product<kNT, S::kOT, kNT>(o, s, vt, kStride, g, t);
    }
    if (any_next) {
      cluster_wait();  // every block's partial of tile it + 1 is written
      share_if<kSplit>(cluster, xb, S::kX / 4, C, S::kThreads, tid);
      if (active(it + 1))
        sum_or_gather<kSplit>(s_cur, cluster, xb, S::kX / 4, C, xi);
      ++ex;
    }
    any_cur = any_next;
    ok_cur = ok_next;
  }
  cluster.sync();  // no block leaves while a peer reads its partials

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Tq) continue;
    float* o_row = out + base + (size_t)rows[r] * pos_stride;
#pragma unroll
    for (int n = 0; n < S::kOT; ++n) {
      float2 val = make_float2(0.f, 0.f);
      if (l[r] > 0.f)
        val = make_float2(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
      *reinterpret_cast<float2*>(o_row + 8 * n + 2 * t) = val;
    }
    if (lse != nullptr && t == 0 && col0 == 0)  // one block of the cluster
      lse[((size_t)b * Tq + rows[r]) * nh + h] =
          l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
  }
}

// The f32 dK/dV's block: 64 keys, 4 warps of 16 (the head-dim-128 dK/dV
// kernel's geometry, flash_attention_bwd.cu): K and V staged once, tiles
// of 8 query rows with their lse and D (8, not 16: dK and dV take 128
// registers a thread, and a wider tile's S^T and dP^T beside them
// spilled); two exchange buffers of the warps' S^T and dP^T fragments.
// 101,376 bytes: two blocks an SM.
struct ClusterDkvF32 {
  static constexpr int kThreads = 128;
  static constexpr int kKeys = 64;
  static constexpr int kQ = 8;               // query rows per tile
  static constexpr int kStride = kSlab + 4;  // floats per shared row
  static constexpr int kKS = kSlab / 8;
  static constexpr int kNT = kQ / 8;         // 8-query column tiles of S^T
  static constexpr int kDT = kSlab / 8;      // 8-wide tiles of dK, dV
  static constexpr int kKV = 2 * kKeys * kStride;
  static constexpr int kTile = kQ * kStride;
  // q, dO (hi after the split), then lse, D, a row flag (+ kQ of padding)
  static constexpr int kStage = 2 * kTile + 4 * kQ;
  static constexpr int kX = 2 * 4 * kNT * 4 * 32;  // floats of a buffer
  static constexpr size_t kSmem =
      (kKV + 2 * kStage + 2 * kTile + 2 * kX) * sizeof(float);
};

// grid (C * ceil(Tk / 64), nh, B) in clusters of (C, 1, 1), C = hd / 128;
// ClusterDkvF32::kThreads threads, kSmem bytes of dynamic shared memory.
// Every block sums the C partials at every cluster size: with the split
// exchange (share_if) ptxas spilled this kernel (dK and dV hold 128
// registers a thread)
__global__ void __launch_bounds__(ClusterDkvF32::kThreads, 2)
flash_bwd_dkv_cluster_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const float* __restrict__ key_mask, float* __restrict__ dk,
    float* __restrict__ dv, int Tq, int Tk, int nh, int hd, int causal,
    float sm_scale) {
  using D = ClusterDkvF32;
  constexpr int kQ = D::kQ, kStride = D::kStride, kNT = D::kNT;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * kSlab;
  float* ks = smem;
  float* vs = smem + D::kKeys * kStride;
  float* stages = smem + D::kKV;
  float* x_s = stages + 2 * D::kStage + 2 * D::kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t base = (size_t)b * Tk * pos_stride + (size_t)h * hd + col0;
  const size_t q_base = (size_t)b * Tq * pos_stride + (size_t)h * hd + col0;
  const size_t row_base = (size_t)b * Tq * nh + h;  // lse/dsum of (b, 0, h)
  const int key0 = kb * D::kKeys + warp * 16;       // the warp's first key
  const int keys[2] = {key0 + g, key0 + g + 8};
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kok[r] = key_ok(key_mask, b, Tk, keys[r]);

  float dka[D::kDT][4], dva[D::kDT][4];
#pragma unroll
  for (int n = 0; n < D::kDT; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  // no key of the block is attended: zeros (the whole cluster agrees)
  const bool any = __syncthreads_or(kok[0] || kok[1]);
  // causal (Tq == Tk): a row before the block's first key attends none
  const int q_begin = causal ? kb * D::kKeys : 0;
  const int n_tiles = any ? (Tq - q_begin + kQ - 1) / kQ : 0;

  auto stage_q = [&](int tile, int buf) {
    float* qs = stages + buf * D::kStage;
    float* dos = qs + D::kTile;
    float* lse_s = dos + D::kTile;
    float* d_s = lse_s + kQ;
    float* rok_s = d_s + kQ;
    const int q0 = q_begin + tile * kQ;
    tf32x3::stage_rows<kSlab, D::kThreads>(qs, kStride, q + q_base,
                                           pos_stride, q0, kQ, Tq, tid);
    tf32x3::stage_rows<kSlab, D::kThreads>(dos, kStride, dout + q_base,
                                           pos_stride, q0, kQ, Tq, tid);
    for (int i = tid; i < kQ; i += D::kThreads) {
      const int row = q0 + i;
      float lv = 0.f, d = 0.f;
      bool ok = false;
      if (row < Tq) {
        lv = lse[row_base + (size_t)row * nh];
        d = dsum[row_base + (size_t)row * nh];
        ok = isfinite(lv);
      }
      lse_s[i] = ok ? lv : 0.f;
      d_s[i] = d;
      rok_s[i] = ok ? 1.f : 0.f;  // a real row with a key to attend
    }
    tf32x3::cp_async_commit();
  };

  if (n_tiles > 0) {
    tf32x3::stage_rows<kSlab, D::kThreads>(ks, kStride, k + base, pos_stride,
                                           kb * D::kKeys, D::kKeys, Tk, tid);
    tf32x3::stage_rows<kSlab, D::kThreads>(vs, kStride, v + base, pos_stride,
                                           kb * D::kKeys, D::kKeys, Tk, tid);
    stage_q(0, 0);  // one group: K, V and the first query tile
  }
  const float* kw = ks + warp * 16 * kStride;
  const float* vw = vs + warp * 16 * kStride;
  auto k_frag = [&](int kk) {
    return tf32x3::load_a(kw + 8 * kk, kStride, g, t);
  };
  auto v_frag = [&](int kk) {
    return tf32x3::load_a(vw + 8 * kk, kStride, g, t);
  };
  float* q_lo = stages + 2 * D::kStage;
  float* do_lo = q_lo + D::kTile;
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage_q(it + 1, (it + 1) & 1);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    float* qs = stages + (it & 1) * D::kStage;
    float* dos = qs + D::kTile;
    tf32x3::split_tile<kSlab, D::kThreads>(qs, q_lo, kStride, kQ, tid);
    tf32x3::split_tile<kSlab, D::kThreads>(dos, do_lo, kStride, kQ, tid);
    __syncthreads();

    const int q0 = q_begin + it * kQ;
    // the warp's keys are real (the last block may hold fewer than 64)
    // and, causal, not every row of the tile precedes its first key (the
    // same warp of every block)
    const bool active = key0 < Tk && (!causal || q0 + kQ - 1 >= key0);
    float* xb = x_s + (ex & 1) * D::kX;
    auto xi = [&](int j) { return (warp * 2 * kNT + j) * 32 + lane; };
    float p[kNT][4], ds[kNT][4];
    if (active) {
      // this block's partial S^T = K Q^T and dP^T = V dO^T
      const tf32x3::SplitTile qt{qs, q_lo}, dot{dos, do_lo};
      tf32x3::head_dim_product<kNT, D::kKS>(p, k_frag, qt, kStride, g, t);
      tf32x3::head_dim_product<kNT, D::kKS>(ds, v_frag, dot, kStride, g, t);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        reinterpret_cast<float4*>(xb)[xi(j)] = f4(p[j]);
        reinterpret_cast<float4*>(xb)[xi(kNT + j)] = f4(ds[j]);
      }
    }
    cluster.sync();
    ++ex;
    if (active) {
      // S^T summed into the partial's registers, then P^T =
      // exp(S^T * scale - lse); exactly 0 where the pair is masked or the
      // row has no key to attend
      sum_partials<kNT>(p, cluster, xb, C, xi);
      const float* lse_s = dos + D::kTile;
      const float* d_s = lse_s + kQ;
      const float* rok_s = d_s + kQ;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int r = e >> 1;
          const bool ok = kok[r] && rok_s[col] > 0.f &&
                          (!causal || keys[r] <= q0 + col);
          p[j][e] = ok ? expf(p[j][e] * sm_scale - lse_s[col]) : 0.f;
        }
      }
      const tf32x3::SplitTile qt{qs, q_lo}, dot{dos, do_lo};
      // dV += P^T dO over this block's columns
      tf32x3::tile_product<kNT, D::kDT, kNT>(dva, p, dot, kStride, g, t);
      // dP^T summed (read after dV's product: fewer registers live), then
      // dS^T = P^T (dP^T - D) and dK += dS^T Q
      sum_partials<kNT>(ds, cluster, xb, C,
                        [&](int j) { return xi(kNT + j); });
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - d_s[8 * j + 2 * t + (e & 1)]);
      }
      tf32x3::tile_product<kNT, D::kDT, kNT>(dka, ds, qt, kStride, g, t);
    }
    __syncthreads();  // every warp is done with buffer it & 1 and the lo
  }
  if (n_tiles > 0) cluster.sync();  // no block leaves while a peer reads

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= Tk) continue;
    float* dk_row = dk + base + (size_t)keys[r] * pos_stride;
    float* dv_row = dv + base + (size_t)keys[r] * pos_stride;
#pragma unroll
    for (int n = 0; n < D::kDT; ++n) {
      *reinterpret_cast<float2*>(dk_row + 8 * n + 2 * t) = make_float2(
          dka[n][2 * r] * sm_scale, dka[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv_row + 8 * n + 2 * t) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// The f32 dQ's block: 64 query rows, 4 warps of 16 (the head-dim-128 dQ
// kernel's geometry, flash_attention_bwd.cu): q and dO staged once and
// split at use; key tiles of 8 keys (K, V and their key flags) staged by
// cp.async, double-buffered and split to hi/lo once (the lo parts of the
// current tile in arrays of their own), so S = Q K^T and dQ += dS K read
// the same split K tile; two exchange buffers of the warps' S and dP
// fragments, both summed in one pass over the ranks (their loads in
// flight together: 1-6% faster on an H100 than S, then dP).  8 keys, as
// the dK/dV's 8 rows: 16 keys take 134,784 bytes, one block an SM, and
// ran 2-27% slower at hd 384-1024.  101,184 bytes: two blocks an SM.
struct ClusterDqF32 {
  static constexpr int kThreads = 128;
  static constexpr int kRows = 64;
  static constexpr int kKeys = 8;            // keys per tile
  static constexpr int kStride = kSlab + 4;  // floats per shared row
  static constexpr int kKS = kSlab / 8;
  static constexpr int kNT = kKeys / 8;      // 8-key column tiles of S
  static constexpr int kDT = kSlab / 8;      // 8-wide tiles of dQ
  static constexpr int kQD = 2 * kRows * kStride;   // q, dO
  static constexpr int kTile = kKeys * kStride;
  static constexpr int kStage = 2 * kTile + kKeys;  // K, V (hi), key flags
  static constexpr int kX = 2 * 4 * kNT * 4 * 32;  // floats of a buffer
  static constexpr size_t kSmem =
      (kQD + 2 * kStage + 2 * kTile + 2 * kX) * sizeof(float);
  static_assert(kStage % 4 == 0, "16-byte aligned stages");
};

// grid (C * ceil(Tq / 64), nh, B) in clusters of (C, 1, 1), C = hd / 128;
// ClusterDqF32::kThreads threads, kSmem bytes of dynamic shared memory.
// Per key tile: each warp forms its partial S = Q K^T and dP = dO V^T
// over the block's 128 columns and writes both; after one cluster
// barrier it sums the cluster's S and dP, forms P = exp(S * scale - lse)
// and dS = P (dP - D), and adds dS K over its columns to dQ.  kSplit:
// share_if's exchange
template <bool kSplit>
__global__ void __launch_bounds__(ClusterDqF32::kThreads, 2)
flash_bwd_dq_cluster_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const float* __restrict__ key_mask, float* __restrict__ dq, int Tq,
    int Tk, int nh, int hd, int causal, float sm_scale) {
  using D = ClusterDqF32;
  constexpr int kKeys = D::kKeys, kStride = D::kStride, kNT = D::kNT;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * kSlab;
  float* q_s = smem;
  float* do_s = q_s + D::kRows * kStride;
  float* stages = smem + D::kQD;           // 2 x (K, V, key flags)
  float* k_lo = stages + 2 * D::kStage;    // lo parts of the current tile
  float* v_lo = k_lo + D::kTile;
  float* x_s = v_lo + D::kTile;            // the two exchange buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t base = (size_t)b * Tq * pos_stride + (size_t)h * hd + col0;
  const size_t k_base = (size_t)b * Tk * pos_stride + (size_t)h * hd + col0;
  const size_t row_base = (size_t)b * Tq * nh + h;  // lse/dsum of (b, 0, h)
  const int row0 = qb * D::kRows + warp * 16;       // the warp's first row
  const int rows[2] = {row0 + g, row0 + g + 8};

  float l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  bool rok[2] = {false, false};  // a real row with a key to attend
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < Tq) {
      l[r] = lse[row_base + (size_t)rows[r] * nh];
      dd[r] = dsum[row_base + (size_t)rows[r] * nh];
      rok[r] = isfinite(l[r]);
      if (!rok[r]) l[r] = 0.f;
    }
  }
  float dqa[D::kDT][4];
#pragma unroll
  for (int n = 0; n < D::kDT; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  // no row of the block attends a key: zeros (the whole cluster agrees)
  const bool any_row = __syncthreads_or(rok[0] || rok[1]);
  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, (qb + 1) * D::kRows) : Tk;
  const int n_tiles = any_row ? (t_end + kKeys - 1) / kKeys : 0;

  auto stage = [&](int tile, int buf) {
    float* ks = stages + buf * D::kStage;
    float* vs = ks + D::kTile;
    float* oks = vs + D::kTile;
    const int k0 = tile * kKeys;
    tf32x3::stage_rows<kSlab, D::kThreads>(ks, kStride, k + k_base,
                                           pos_stride, k0, kKeys, Tk, tid);
    tf32x3::stage_rows<kSlab, D::kThreads>(vs, kStride, v + k_base,
                                           pos_stride, k0, kKeys, Tk, tid);
    for (int j = tid; j < kKeys; j += D::kThreads)
      oks[j] = key_flag(key_mask, b, Tk, k0 + j);
    tf32x3::cp_async_commit();
  };
  if (n_tiles > 0) {  // one group: q, dO and the first key tile
    tf32x3::stage_rows<kSlab, D::kThreads>(q_s, kStride, q + base, pos_stride,
                                           qb * D::kRows, D::kRows, Tq, tid);
    tf32x3::stage_rows<kSlab, D::kThreads>(do_s, kStride, dout + base,
                                           pos_stride, qb * D::kRows,
                                           D::kRows, Tq, tid);
    stage(0, 0);
  }
  const float* qw = q_s + warp * 16 * kStride;
  const float* dow = do_s + warp * 16 * kStride;
  auto q_frag = [&](int kk) {
    return tf32x3::load_a(qw + 8 * kk, kStride, g, t);
  };
  auto do_frag = [&](int kk) {
    return tf32x3::load_a(dow + 8 * kk, kStride, g, t);
  };
  auto xi = [&](int j) { return (warp * 2 * kNT + j) * 32 + lane; };
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1, (it + 1) & 1);  // its buffer was freed at it - 1's end
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    float* ks = stages + (it & 1) * D::kStage;
    float* vs = ks + D::kTile;
    const float* oks = vs + D::kTile;
    // each thread splits the chunks it copied; after the barrier the tile
    // is split and has landed for every warp, and the block knows whether
    // any key of the tile is real and unmasked (the cluster's too)
    tf32x3::split_tile<kSlab, D::kThreads>(ks, k_lo, kStride, kKeys, tid);
    tf32x3::split_tile<kSlab, D::kThreads>(vs, v_lo, kStride, kKeys, tid);
    const bool any = __syncthreads_or(tid < kKeys && oks[tid] > 0.f);
    if (any) {
      const int k0 = it * kKeys;
      // the warp's rows are real (the last block may hold fewer than 64)
      // and, causal, not every key of the tile follows its last row (the
      // same warp of every block)
      const bool active = row0 < Tq && !(causal && k0 > row0 + 15);
      float* xb = x_s + (ex & 1) * D::kX;
      const tf32x3::SplitTile kt{ks, k_lo}, vt{vs, v_lo};
      float p[kNT][4], ds[kNT][4];
      if (active) {
        // this block's partial S = Q K^T and dP = dO V^T
        tf32x3::head_dim_product<kNT, D::kKS>(p, q_frag, kt, kStride, g, t);
        tf32x3::head_dim_product<kNT, D::kKS>(ds, do_frag, vt, kStride, g,
                                              t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          reinterpret_cast<float4*>(xb)[xi(j)] = f4(p[j]);
          reinterpret_cast<float4*>(xb)[xi(kNT + j)] = f4(ds[j]);
        }
      }
      cluster.sync();  // every block's partials are written
      ++ex;
      share_if<kSplit>(cluster, xb, D::kX / 4, C, D::kThreads, tid);
      if (active) {
        // S and dP summed, P = exp(S * scale - lse) (exactly 0 where the
        // pair is masked or the row has no key to attend), dS = P (dP -
        // D); dQ += dS K over this block's columns (the tile's keys in
        // a_from_acc's order)
        float sd[2 * kNT][4];
        sum_or_gather<kSplit>(sd, cluster, xb, D::kX / 4, C, xi);
        const bool diag = causal && k0 + kKeys - 1 > row0;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const int r = e >> 1;
            const bool ok = rok[r] && oks[col] > 0.f &&
                            (!diag || k0 + col <= rows[r]);
            const float pv = ok ? expf(sd[j][e] * sm_scale - l[r]) : 0.f;
            ds[j][e] = pv * (sd[kNT + j][e] - dd[r]);
          }
        }
        tf32x3::tile_product<kNT, D::kDT, kNT>(dqa, ds, kt, kStride, g, t);
      }
    }
    __syncthreads();  // every warp is done with buffer it & 1 and the lo
  }
  if (n_tiles > 0) cluster.sync();  // no block leaves while a peer reads

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Tq) continue;
    float* dq_row = dq + base + (size_t)rows[r] * pos_stride;
#pragma unroll
    for (int n = 0; n < D::kDT; ++n)
      *reinterpret_cast<float2*>(dq_row + 8 * n + 2 * t) = make_float2(
          dqa[n][2 * r] * sm_scale, dqa[n][2 * r + 1] * sm_scale);
  }
}

// The bf16 forms' blocks: two warpgroups of 64 rows (forward, dQ) or
// keys (dK/dV), 128-column slabs as wgmma tiles of 64-column boxes (the
// 128-byte swizzle; wgmma_bf16.cuh)
using SlabTile = wg::Tile<kSlab>;
constexpr int kBf16Threads = 256;
constexpr int kBf16Rows = 128;

struct ClusterFwdBf16 {
  static constexpr int kKeys = 64;  // keys per tile
  static constexpr int kQ = SlabTile::bytes(kBf16Rows);  // the q tile
  static constexpr int kTile = SlabTile::bytes(kKeys);   // a K or V tile
  // a buffer: each thread's S registers, as float4 [kKeys / 8][threads]
  static constexpr int kXFloats = kBf16Threads * kKeys / 2;
  static constexpr int kXOff = kQ + 2 * 2 * kTile;  // q, 2 stages of K, V
  static constexpr int kBarOff = kXOff + 2 * kXFloats * 4;
  static constexpr size_t kSmem = kBarOff + 3 * 8 + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// grid (C * ceil(Tq / 128), nh, B) in clusters of (C, 1, 1), C = hd / 128;
// kBf16Threads threads, ClusterFwdBf16::kSmem bytes of dynamic shared
// memory; the maps' boxes are 128 rows (q) and 64 rows (k, v); kSplit:
// share_if's exchange
template <bool kSplit>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_fwd_cluster_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const float* __restrict__ key_mask,
                              bf16* __restrict__ out, float* __restrict__ lse,
                              int Tq, int Tk, int nh, int hd, int causal,
                              float sm_scale) {
  using S = ClusterFwdBf16;
  constexpr int kKeys = S::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* tiles = smem + S::kQ;  // stage s: K, then V
  float* x_s = reinterpret_cast<float*>(smem + S::kXOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* q_bar = full + 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * kSlab;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const int wgi = warp >> 2;                // the warpgroup
  const int r_blk = qb * kBf16Rows;         // the block's first row
  const int rw = r_blk + 64 * wgi;          // the warpgroup's first row
  const int q_row = rw + 16 * (warp & 3) + g;
  const int rows[2] = {q_row, q_row + 8};   // this thread's rows of O
  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, r_blk + kBf16Rows) : Tk;
  const int n_tiles = (t_end + kKeys - 1) / kKeys;
  auto issue = [&](int it) {  // thread 0: tile it's K and V into its stage
    const int s = it & 1;
    unsigned char* ks = tiles + s * 2 * S::kTile;
    tma::mbar_arrive_tx(&full[s], 2 * S::kTile);
    wg::load_tile<kSlab>(ks, &k_map, kKeys, it * kKeys, h, b, &full[s], col0);
    wg::load_tile<kSlab>(ks + S::kTile, &v_map, kKeys, it * kKeys, h, b,
                         &full[s], col0);
  };
  if (tid == 0) {
    tma::mbar_init(&full[0], 1);
    tma::mbar_init(&full[1], 1);
    tma::mbar_init(q_bar, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma::mbar_arrive_tx(q_bar, S::kQ);
    wg::load_tile<kSlab>(qs, &q_map, kBf16Rows, r_blk, h, b, q_bar, col0);
    if (n_tiles > 0) issue(0);
  }

  const float scale_l2 = sm_scale * kLog2e;
  float oa[kSlab / 2];
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) oa[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // log2 units; this thread's
  tma::mbar_wait(q_bar, 0);
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it & 1;
    // the next tile's stage was freed by the barrier ending tile it - 1
    if (tid == 0 && it + 1 < n_tiles) issue(it + 1);
    const int k0 = it * kKeys;
    // bit 2 i + e: key k0 + 8 i + 2 t + e (this thread's columns of S) is
    // real and unmasked; the block's threads cover the tile's 64 keys
    uint32_t okb = 0;
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        okb |= (uint32_t)key_ok(key_mask, b, Tk, k0 + 8 * i + 2 * t + e)
               << (2 * i + e);
    const bool any = __syncthreads_or(okb != 0);  // the cluster's too
    tma::mbar_wait(&full[s], (it >> 1) & 1);
    if (any) {
      const unsigned char* ks = tiles + s * 2 * S::kTile;
      const unsigned char* vs = ks + S::kTile;
      // causal: every key of the tile follows the warpgroup's last row
      const bool active = rw < Tq && !(causal && k0 > rw + 63);
      float* xb = x_s + (ex & 1) * S::kXFloats;
      auto xi = [&](int i) { return i * kBf16Threads + tid; };
      float sa[kKeys / 2];  // S, then P
      if (active) {
        // this block's partial S = Q K^T over its 128 columns
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)
          wg::Mma<kKeys>::ss(sa,
                             wg::desc_k<kSlab>(qs, kBf16Rows, 64 * wgi, kk),
                             wg::desc_k<kSlab>(ks, kKeys, 0, kk), kk > 0);
        wg::commit();
        wg::wait<0>();
        wg::keep(sa);
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i)
          reinterpret_cast<float4*>(xb)[xi(i)] = f4(sa + 4 * i);
      }
      cluster.sync();  // every block's partial is written
      ++ex;
      share_if<kSplit>(cluster, xb, S::kXFloats / 4, C, kBf16Threads, tid);
      if (active) {
        float sum[kKeys / 8][4];
        sum_or_gather<kSplit>(sum, cluster, xb, S::kXFloats / 4, C, xi);
        // mask and scale (log2 units), the tile's max over this thread's
        // columns
        const bool diag = causal && k0 + kKeys - 1 > rw;
        float cmax[2] = {kNeg, kNeg};
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = 8 * i + 2 * t + (e & 1);
            const bool ok = ((okb >> (2 * i + (e & 1))) & 1) &&
                            (!diag || k0 + c <= rows[r]);
            const float x = ok ? sum[i][e] * scale_l2 : -INFINITY;
            sa[4 * i + e] = x;
            cmax[r] = fmaxf(cmax[r], x);
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 1));
          cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 2));
          const float m_new = fmaxf(m[r], cmax[r]);
          alpha[r] = ex2(m[r] - m_new);  // 0 on the row's first real key
          m[r] = m_new;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < kSlab / 2; ++i) oa[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const float p = ex2(sa[i] - m[(i >> 1) & 1]);  // masked: exactly 0
          sa[i] = p;
          l[(i >> 1) & 1] += p;  // the unrounded P, as the library sums it
        }
        uint32_t pf[kKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wg::a_frag(pf[kk], sa, kk);  // P rounded to bf16
        wg::wgmma_fence();
        // O += P V over the tile's keys (this block's columns)
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wg::Mma<kSlab>::rs(oa, pf[kk], wg::desc_mn<kSlab>(vs, kKeys, kk, 0),
                             1);
        wg::commit();
        wg::wait<0>();
        wg::keep(oa);
        wg::keep(pf);
      }
    }
    __syncthreads();  // stage s is free for tile it + 2
  }
  cluster.sync();  // no block leaves while a peer reads its partials

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) {
    const float li = l[(i >> 1) & 1];
    oa[i] = li > 0.f ? oa[i] / li : 0.f;  // no key to attend: zeros
  }
  const size_t pos_stride = (size_t)nh * hd;
  store_rows<kSlab>(out + (size_t)b * Tq * pos_stride + (size_t)h * hd + col0,
                    pos_stride, rows, Tq, oa, t);
  if (lse != nullptr && t == 0 && col0 == 0) {  // one block of the cluster
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < Tq)
        lse[((size_t)b * Tq + rows[r]) * nh + h] =
            l[r] > 0.f ? m[r] / kLog2e + logf(l[r]) : INFINITY;
  }
}

struct ClusterDkvBf16 {
  static constexpr int kQ = 32;  // query rows per tile
  static constexpr int kKV = SlabTile::bytes(kBf16Rows);  // K or V
  static constexpr int kTile = SlabTile::bytes(kQ);       // a q or dO tile
  // a buffer: each thread's S^T and dP^T registers, float4 [kQ / 4][threads]
  static constexpr int kXFloats = kBf16Threads * kQ;
  // K, V, 2 stages of q and dO, the tile's lse and D, the buffers, barriers
  static constexpr int kRowsOff = 2 * kKV + 2 * 2 * kTile;
  static constexpr int kXOff = kRowsOff + 2 * kQ * 4;
  static constexpr int kBarOff = kXOff + 2 * kXFloats * 4;
  static constexpr size_t kSmem = kBarOff + 3 * 8 + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// grid (C * ceil(Tk / 128), nh, B) in clusters of (C, 1, 1), C = hd / 128;
// kBf16Threads threads, ClusterDkvBf16::kSmem bytes of dynamic shared
// memory; the maps' boxes are 32 rows (q, dO) and 128 rows (k, v);
// kSplit: share_if's exchange
template <bool kSplit>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dkv_cluster_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const float* __restrict__ key_mask, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Tq, int Tk, int nh, int hd, int causal,
    float sm_scale) {
  using D = ClusterDkvBf16;
  constexpr int kQ = D::kQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = smem + D::kKV;
  unsigned char* tiles = smem + 2 * D::kKV;  // stage s: q, then dO
  float* rows_s = reinterpret_cast<float*>(smem + D::kRowsOff);  // lse, D
  float* x_s = reinterpret_cast<float*>(smem + D::kXOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + D::kBarOff);
  uint64_t* kv_bar = full + 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * kSlab;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const int wgi = warp >> 2;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t base = (size_t)b * Tk * pos_stride + (size_t)h * hd + col0;
  const size_t row_base = (size_t)b * Tq * nh + h;
  const int k_blk = kb * kBf16Rows;       // the block's first key
  const int kw = k_blk + 64 * wgi;        // the warpgroup's first key
  const int key0 = kw + 16 * (warp & 3) + g;
  const int keys[2] = {key0, key0 + 8};   // this thread's rows of dK, dV
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kok[r] = key_ok(key_mask, b, Tk, keys[r]);
  float dka[kSlab / 2], dva[kSlab / 2];
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) dka[i] = dva[i] = 0.f;
  // no key of the block is attended: zeros (the whole cluster agrees)
  if (!__syncthreads_or(kok[0] || kok[1])) {
    store_rows<kSlab>(dk + base, pos_stride, keys, Tk, dka, t);
    store_rows<kSlab>(dv + base, pos_stride, keys, Tk, dva, t);
    return;
  }
  // causal (Tq == Tk): a row before the block's first key attends none
  const int q_begin = causal ? k_blk : 0;
  const int n_tiles = (Tq - q_begin + kQ - 1) / kQ;
  auto issue = [&](int it) {  // thread 0: tile it's q and dO into its stage
    const int s = it & 1;
    const int q0 = q_begin + it * kQ;
    unsigned char* qs = tiles + s * 2 * D::kTile;
    tma::mbar_arrive_tx(&full[s], 2 * D::kTile);
    wg::load_tile<kSlab>(qs, &q_map, kQ, q0, h, b, &full[s], col0);
    wg::load_tile<kSlab>(qs + D::kTile, &do_map, kQ, q0, h, b, &full[s],
                         col0);
  };
  if (tid == 0) {
    tma::mbar_init(&full[0], 1);
    tma::mbar_init(&full[1], 1);
    tma::mbar_init(kv_bar, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma::mbar_arrive_tx(kv_bar, 2 * D::kKV);
    wg::load_tile<kSlab>(ks, &k_map, kBf16Rows, k_blk, h, b, kv_bar, col0);
    wg::load_tile<kSlab>(vs, &v_map, kBf16Rows, k_blk, h, b, kv_bar, col0);
    if (n_tiles > 0) issue(0);
  }

  const float scale_l2 = sm_scale * kLog2e;
  tma::mbar_wait(kv_bar, 0);
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it & 1;
    if (tid == 0 && it + 1 < n_tiles) issue(it + 1);
    const int q0 = q_begin + it * kQ;
    if (tid < kQ) {  // the tile's lse (log2 units; +inf: no key) and D
      const int row = q0 + tid;
      float lv = INFINITY, d = 0.f;
      if (row < Tq) {
        const float x = lse[row_base + (size_t)row * nh];
        if (isfinite(x)) lv = x * kLog2e;
        d = dsum[row_base + (size_t)row * nh];
      }
      rows_s[tid] = lv;
      rows_s[kQ + tid] = d;
    }
    tma::mbar_wait(&full[s], (it >> 1) & 1);
    const unsigned char* qs = tiles + s * 2 * D::kTile;
    const unsigned char* dos = qs + D::kTile;
    // causal: every row of the tile precedes the warpgroup's first key
    const bool active = kw < Tk && !(causal && q0 + kQ - 1 < kw);
    float* xb = x_s + (ex & 1) * D::kXFloats;
    auto xi = [&](int i) { return i * kBf16Threads + tid; };
    float sa[kQ / 2], pa[kQ / 2];  // S^T then P^T; dP^T then dS^T
    if (active) {
      // this block's partial S^T = K Q^T and dP^T = V dO^T
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk)
        wg::Mma<kQ>::ss(sa, wg::desc_k<kSlab>(ks, kBf16Rows, 64 * wgi, kk),
                        wg::desc_k<kSlab>(qs, kQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk)
        wg::Mma<kQ>::ss(pa, wg::desc_k<kSlab>(vs, kBf16Rows, 64 * wgi, kk),
                        wg::desc_k<kSlab>(dos, kQ, 0, kk), kk > 0);
      wg::commit();
      wg::wait<0>();
      wg::keep(sa);
      wg::keep(pa);
#pragma unroll
      for (int i = 0; i < kQ / 8; ++i) {
        reinterpret_cast<float4*>(xb)[xi(i)] = f4(sa + 4 * i);
        reinterpret_cast<float4*>(xb)[xi(kQ / 8 + i)] = f4(pa + 4 * i);
      }
    }
    cluster.sync();  // every block's partials (and the tile's rows) are in
    ++ex;
    share_if<kSplit>(cluster, xb, D::kXFloats / 4, C, kBf16Threads, tid);
    if (active) {
      float sum[kQ / 4][4];
      sum_or_gather<kSplit>(sum, cluster, xb, D::kXFloats / 4, C, xi);
      // P^T = exp(S^T * scale - lse), dS^T = P^T (dP^T - D) * scale
      const bool diag = causal && q0 < kw + 63;
#pragma unroll
      for (int i = 0; i < kQ / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * i + 2 * t + (e & 1);
          const float lv = rows_s[c], d = rows_s[kQ + c];
          const bool ok =
              kok[r] && lv != INFINITY && (!diag || keys[r] <= q0 + c);
          const float p = ok ? ex2(fmaf(sum[i][e], scale_l2, -lv)) : 0.f;
          sa[4 * i + e] = p;
          pa[4 * i + e] = p * (sum[kQ / 8 + i][e] - d) * sm_scale;
        }
      }
      uint32_t pf[kQ / 16][4], df[kQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        wg::a_frag(pf[kk], sa, kk);  // P^T rounded to bf16
        wg::a_frag(df[kk], pa, kk);  // dS^T rounded to bf16
      }
      wg::wgmma_fence();
      // dV += P^T dO, dK += dS^T Q over the tile's queries (this block's
      // columns)
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wg::Mma<kSlab>::rs(dva, pf[kk], wg::desc_mn<kSlab>(dos, kQ, kk, 0), 1);
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wg::Mma<kSlab>::rs(dka, df[kk], wg::desc_mn<kSlab>(qs, kQ, kk, 0), 1);
      wg::commit();
      wg::wait<0>();
      wg::keep(dva);
      wg::keep(dka);
      wg::keep(pf);
      wg::keep(df);
    }
    __syncthreads();  // stage s and the rows are free for the next tiles
  }
  cluster.sync();  // no block leaves while a peer reads its partials
  store_rows<kSlab>(dk + base, pos_stride, keys, Tk, dka, t);
  store_rows<kSlab>(dv + base, pos_stride, keys, Tk, dva, t);
}

// The bf16 dQ's block: 128 query rows, q and dO copied once, K and V
// tiles of 32 keys through a 2-stage ring (the head-dim-256 dQ's tile:
// two exchange buffers of S and dP beside q, dO and 64-key tiles would
// take 256 KB); the exchange in two halves (sum_share, gather_sums)
struct ClusterDqBf16 {
  static constexpr int kKeys = 32;  // keys per tile
  static constexpr int kQD = SlabTile::bytes(kBf16Rows);  // q or dO
  static constexpr int kTile = SlabTile::bytes(kKeys);    // a K or V tile
  // a buffer: each thread's S and dP registers, float4 [kKeys / 4][threads]
  static constexpr int kXFloats = kBf16Threads * kKeys;
  static constexpr int kXOff = 2 * kQD + 2 * 2 * kTile;  // q, dO, 2 stages
  static constexpr int kBarOff = kXOff + 2 * kXFloats * 4;
  static constexpr size_t kSmem = kBarOff + 3 * 8 + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// grid (C * ceil(Tq / 128), nh, B) in clusters of (C, 1, 1), C = hd / 128;
// kBf16Threads threads, ClusterDqBf16::kSmem bytes of dynamic shared
// memory; the maps' boxes are 128 rows (q, dO) and 32 rows (k, v).  Per
// key tile: each warpgroup forms its partial S = Q K^T and dP = dO V^T
// over the block's 128 columns and writes both; after a cluster barrier
// the block sums its share of the cluster's partials, and after a second
// one each warpgroup reads its sums, forms dS = P (dP - D) * scale in
// registers, rounds it to bf16 and adds dS K over its columns to dQ, K
// from the staged tile S read.  kMaxC: the largest cluster the instance
// takes (kMaxCluster, or kMaxClusterNP past 8 blocks), sum_share's bound
template <int kMaxC>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dq_cluster_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const float* __restrict__ key_mask, bf16* __restrict__ dq, int Tq,
    int Tk, int nh, int hd, int causal, float sm_scale) {
  using D = ClusterDqBf16;
  constexpr int kKeys = D::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = smem + D::kQD;
  unsigned char* tiles = smem + 2 * D::kQD;  // stage s: K, then V
  float* x_s = reinterpret_cast<float*>(smem + D::kXOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + D::kBarOff);
  uint64_t* qd_bar = full + 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * kSlab;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const int wgi = warp >> 2;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t base = (size_t)b * Tq * pos_stride + (size_t)h * hd + col0;
  const size_t row_base = (size_t)b * Tq * nh + h;
  const int r_blk = qb * kBf16Rows;          // the block's first row
  const int rw = r_blk + 64 * wgi;           // the warpgroup's first row
  const int q_row = rw + 16 * (warp & 3) + g;
  const int rows[2] = {q_row, q_row + 8};    // this thread's rows of dQ
  float l[2] = {INFINITY, INFINITY}, dd[2] = {0.f, 0.f};  // lse * log2 e, D
  bool rok[2] = {false, false};  // a real row with a key to attend
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Tq) continue;
    const float x = lse[row_base + (size_t)rows[r] * nh];
    rok[r] = isfinite(x);
    if (rok[r]) l[r] = x * kLog2e;
    dd[r] = dsum[row_base + (size_t)rows[r] * nh];
  }
  float dqa[kSlab / 2];
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) dqa[i] = 0.f;
  // no row of the block attends a key: zeros (the whole cluster agrees)
  if (!__syncthreads_or(rok[0] || rok[1])) {
    store_rows<kSlab>(dq + base, pos_stride, rows, Tq, dqa, t);
    return;
  }
  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, r_blk + kBf16Rows) : Tk;
  const int n_tiles = (t_end + kKeys - 1) / kKeys;
  auto issue = [&](int it) {  // thread 0: tile it's K and V into its stage
    const int s = it & 1;
    unsigned char* ks = tiles + s * 2 * D::kTile;
    tma::mbar_arrive_tx(&full[s], 2 * D::kTile);
    wg::load_tile<kSlab>(ks, &k_map, kKeys, it * kKeys, h, b, &full[s], col0);
    wg::load_tile<kSlab>(ks + D::kTile, &v_map, kKeys, it * kKeys, h, b,
                         &full[s], col0);
  };
  if (tid == 0) {
    tma::mbar_init(&full[0], 1);
    tma::mbar_init(&full[1], 1);
    tma::mbar_init(qd_bar, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma::mbar_arrive_tx(qd_bar, 2 * D::kQD);
    wg::load_tile<kSlab>(qs, &q_map, kBf16Rows, r_blk, h, b, qd_bar, col0);
    wg::load_tile<kSlab>(dos, &do_map, kBf16Rows, r_blk, h, b, qd_bar, col0);
    issue(0);
  }

  const float scale_l2 = sm_scale * kLog2e;
  tma::mbar_wait(qd_bar, 0);
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it & 1;
    // the next tile's stage was freed by the barrier ending tile it - 1
    if (tid == 0 && it + 1 < n_tiles) issue(it + 1);
    const int k0 = it * kKeys;
    // bit 2 i + e: key k0 + 8 i + 2 t + e (this thread's columns of S) is
    // real and unmasked; the block's threads cover the tile's 32 keys
    uint32_t okb = 0;
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        okb |= (uint32_t)key_ok(key_mask, b, Tk, k0 + 8 * i + 2 * t + e)
               << (2 * i + e);
    const bool any = __syncthreads_or(okb != 0);  // the cluster's too
    tma::mbar_wait(&full[s], (it >> 1) & 1);
    if (any) {
      const unsigned char* ks = tiles + s * 2 * D::kTile;
      const unsigned char* vs = ks + D::kTile;
      // causal: every key of the tile follows the warpgroup's last row
      const bool active = rw < Tq && !(causal && k0 > rw + 63);
      float* xb = x_s + (ex & 1) * D::kXFloats;
      auto xi = [&](int i) { return i * kBf16Threads + tid; };
      float sa[kKeys / 2], pa[kKeys / 2];  // S, dP; then dS in pa
      if (active) {
        // this block's partial S = Q K^T and dP = dO V^T over its columns
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)
          wg::Mma<kKeys>::ss(sa,
                             wg::desc_k<kSlab>(qs, kBf16Rows, 64 * wgi, kk),
                             wg::desc_k<kSlab>(ks, kKeys, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)
          wg::Mma<kKeys>::ss(pa,
                             wg::desc_k<kSlab>(dos, kBf16Rows, 64 * wgi, kk),
                             wg::desc_k<kSlab>(vs, kKeys, 0, kk), kk > 0);
        wg::commit();
        wg::wait<0>();
        wg::keep(sa);
        wg::keep(pa);
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i) {
          reinterpret_cast<float4*>(xb)[xi(i)] = f4(sa + 4 * i);
          reinterpret_cast<float4*>(xb)[xi(kKeys / 8 + i)] = f4(pa + 4 * i);
        }
      }
      cluster.sync();  // every block's partials are written
      ++ex;
      // this block's share summed (by every warpgroup, active or not: a
      // share spans both warpgroups' fragments)
      sum_share<kMaxC>(cluster, xb, D::kXFloats / 4, C, kBf16Threads, tid);
      cluster.sync();  // every share is summed
      if (active) {
        float sum[kKeys / 4][4];
        gather_sums<kKeys / 4>(sum, cluster, xb, D::kXFloats / 4, C, xi);
        // P = exp(S * scale - lse), dS = P (dP - D) * scale
        const bool diag = causal && k0 + kKeys - 1 > rw;
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = 8 * i + 2 * t + (e & 1);
            const bool ok = rok[r] && ((okb >> (2 * i + (e & 1))) & 1) &&
                            (!diag || k0 + c <= rows[r]);
            const float p = ok ? ex2(fmaf(sum[i][e], scale_l2, -l[r])) : 0.f;
            pa[4 * i + e] = p * (sum[kKeys / 8 + i][e] - dd[r]) * sm_scale;
          }
        }
        uint32_t df[kKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wg::a_frag(df[kk], pa, kk);  // dS rounded to bf16
        wg::wgmma_fence();
        // dQ += dS K over the tile's keys (this block's columns)
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wg::Mma<kSlab>::rs(dqa, df[kk], wg::desc_mn<kSlab>(ks, kKeys, kk, 0),
                             1);
        wg::commit();
        wg::wait<0>();
        wg::keep(dqa);
        wg::keep(df);
      }
    }
    __syncthreads();  // stage s is free for tile it + 2
  }
  cluster.sync();  // no block leaves while a peer reads its partials
  store_rows<kSlab>(dq + base, pos_stride, rows, Tq, dqa, t);
}

// ---------------------------------------------------------------------------
// The multi-slab cluster forms of the forward, dK/dV and dQ (head dims
// above 128 * kMaxClusterNP = 2048).
//
// Sixteen blocks is the largest cluster, so past 2048 a block owns kS =
// ceil(C / 16) slabs (C = hd / 128) and the cluster holds C' = ceil(C /
// kS) <= 16 blocks; block r owns the columns [128 kS r, 128 kS (r + 1))
// (the last block fewer where kS does not divide C: its missing slabs are
// staged as zeros, which add exact zeros to every product).  The
// exchange is the one of the forms above (sum_share, gather_sums; every
// multi-slab cluster has 9 to 16 blocks); only the product each block
// forms before it grows: its partial S (and dP) is the sum over its kS
// slabs, one product chain over the slabs in order, so the exchange
// moves what it moves at C' blocks, whatever kS is (the dQ's exchange is
// its one-slab form's at C' blocks: f32 one sum at 9 blocks and split
// from kF32DqSplitFrom, bf16 split).
//
// The outputs take passes (one launch each, `pass` = 0 .. kS - 1): pass p
// keeps slab p of the block's output in registers (the accumulators of
// the one-slab forms: 128 registers of dK and dV in the f32 dK/dV leave
// no room for two) and forms every tile's S (and dP) partial over all kS
// slabs again, the identical sums in every pass (the forward's pass p
// sees pass 0's S bits; pass 0 writes the lse).  So the products on the
// S side cost kS times over: at kS = 2 each block does 3 slab-products a
// tile and pass where the one-slab forms do 2 (the dQ 5 where its
// one-slab form does 3: S, dP over 2 slabs each, dS K over the output
// slab).
//
// Shared memory: the operand a block keeps for the whole loop (q in the
// forward, K and V in dK/dV, q and dO in the dQ) and the tiles of the
// other one are staged
// over all kS slabs in rows of 128 kS columns, so they grow with kS; the
// geometry shrinks with kS to keep 4 slabs (hd 8192, the largest the
// forms take: clustered sends larger head dims to the SIMT forms) within
// 227 KB a block:
//
//   * f32 forward: 64 query rows, 4 warps, key tiles of 8 keys (the f32
//     dQ's tile), q staged once over kS slabs and split at use (as the
//     f32 dQ does), K over kS slabs and V over the output slab
//     double-buffered and split once; 108,352 / 153,408 / 198,464 bytes
//     at kS 2 / 3 / 4 (two blocks an SM at kS 2);
//   * f32 dK/dV: query tiles of 8 rows; 64 keys (4 warps) at kS 2, 32
//     keys (2 warps) from kS 3, the query tiles double-buffered up to kS
//     3 and single at kS 4: 191,488 / 178,176 / 202,368 bytes;
//   * bf16 forward: one warpgroup of 64 query rows, key tiles of 32 keys,
//     q copied once (kS boxes of 128 columns), K (kS boxes) and V (the
//     output slab) through a 2-stage ring: 99,352 / 132,120 / 164,888
//     bytes (two blocks an SM at kS 2);
//   * bf16 dK/dV: one warpgroup of 64 keys, query tiles of 32 rows, K and
//     V copied once over kS slabs, q and dO (kS slabs each) through a
//     2-stage ring, single at kS 4: 165,144 / 230,680 / 230,680 bytes;
//   * f32 dQ: key tiles of 8 keys (K and V over kS slabs, split once,
//     dS K reading the output slab's columns of the split K tile), q and
//     dO staged once over kS slabs and split at use; 32 query rows (2
//     warps), the key tiles single-buffered at kS 2 (103,968 bytes: two
//     blocks an SM) and 4 (202,272), double at kS 3 (177,984): 64 rows
//     at kS 2 (one block an SM) timed slower (PERF.md);
//   * bf16 dQ: one warpgroup of 64 query rows, q and dO copied once (kS
//     boxes of 128 columns each), K and V tiles of 32 keys (kS slabs
//     each) through a 2-stage ring, single at kS 4: 164,888 / 230,424 /
//     230,424 bytes.

// rows [r0, r0 + n_rows) of a [T, nh, hd] head view (row r at src + r *
// row_stride; src at the block's first column), columns [0, W) into a
// shared tile of `stride` floats per row; rows at or past T and columns
// at or past n_cols (the block's real columns, a multiple of 4) are
// zero-filled.  stage_rows' chunks per thread, so split_tile<W> splits
// what a thread copied
template <int W, int kThreads>
__device__ __forceinline__ void stage_cols(float* dst, int stride,
                                           const float* src,
                                           size_t row_stride, int r0,
                                           int n_rows, int T, int n_cols,
                                           int tid) {
  constexpr int kC4 = W / 4;
  for (int idx = tid; idx < n_rows * kC4; idx += kThreads) {
    const int r = idx / kC4, c = idx % kC4;
    const bool in = r0 + r < T && 4 * c < n_cols;
    tf32x3::cp_async16(dst + r * stride + 4 * c,
                       in ? src + (size_t)(r0 + r) * row_stride + 4 * c : src,
                       in ? 16 : 0);
  }
}

// out[0] = A . M^T over the block's kS slabs for 16 rows of A and the 8
// rows of the split tile `bt`: head_dim_product<1, 16 kS>'s sums in its
// order (a fresh accumulator per 16-wide slice of the head dim, added to
// out slice by slice), unrolled within a slab and not across the slabs:
// unrolled over all of them, the f32 dK/dV at 4 slabs and the split
// forward spilled
template <int kS, class AFrag>
__device__ __forceinline__ void slab_product(float (&out)[1][4], AFrag a,
                                             tf32x3::SplitTile bt, int stride,
                                             int g, int t) {
  out[0][0] = out[0][1] = out[0][2] = out[0][3] = 0.f;
#pragma unroll 1
  for (int j = 0; j < kS; ++j) {
#pragma unroll
    for (int k2 = 0; k2 < kSlab / 8; k2 += 2) {
      const int kk = j * (kSlab / 8) + k2;
      const tf32x3::FragA a0 = a(kk), a1 = a(kk + 1);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      tf32x3::mma3(c, a0, tf32x3::load_b_t(bt, 8 * kk, stride, g, t));
      tf32x3::mma3(c, a1, tf32x3::load_b_t(bt, 8 * kk + 8, stride, g, t));
      tf32x3::add4(out[0], c);
    }
  }
}

template <int kS>
struct SlabsFwdF32 {
  static constexpr int kThreads = 128;
  static constexpr int kRows = 64;
  static constexpr int kKeys = 8;
  static constexpr int kW = kS * kSlab;       // the block's columns
  static constexpr int kStride = kW + 4;     // floats per shared row of q, K
  static constexpr int kVStride = kSlab + 4;  // of V (the output slab)
  static constexpr int kOT = kSlab / 8;      // 8-wide column tiles of O
  static constexpr int kQ = kRows * kStride;
  static constexpr int kKTile = kKeys * kStride;
  static constexpr int kVTile = kKeys * kVStride;
  static constexpr int kStage = kKTile + kVTile + kKeys;  // K, V, key flags
  static constexpr int kX = 4 * 4 * 32;  // floats of a buffer
  static constexpr size_t kSmem =
      (kQ + 2 * kStage + kKTile + kVTile + 2 * kX) * sizeof(float);
  static_assert(kStage % 4 == 0, "16-byte aligned stages");
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// grid (C' * ceil(Tq / 64), nh, B) in clusters of (C', 1, 1);
// SlabsFwdF32<kS>::kThreads threads, kSmem bytes of dynamic shared memory;
// output slab `pass` of the block.  Per key tile: each warp forms its
// partial S over the block's kS slabs and writes it; after a cluster
// barrier (kSplit: share_if's exchange) it sums the cluster's, runs the
// online softmax on it and adds P V over its output slab to O
template <int kS, bool kSplit>
__global__ void __launch_bounds__(SlabsFwdF32<kS>::kThreads, 1)
flash_fwd_slabs_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ key_mask,
                           float* __restrict__ out, float* __restrict__ lse,
                           int Tq, int Tk, int nh, int hd, int causal,
                           float sm_scale, int pass) {
  using S = SlabsFwdF32<kS>;
  constexpr int kKeys = S::kKeys, kStride = S::kStride;
  constexpr int kVStride = S::kVStride;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * S::kW;  // the block's first
  const int ocol = col0 + pass * kSlab;                // its output slab's
  const int n_cols = min(S::kW, hd - col0);            // its real columns
  float* q_s = smem;
  float* stages = q_s + S::kQ;               // 2 x (K, V, key flags)
  float* k_lo = stages + 2 * S::kStage;      // lo parts of the current tile
  float* v_lo = k_lo + S::kKTile;
  float* x_s = v_lo + S::kVTile;             // the two exchange buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t head = (size_t)h * hd;
  const float* kb = k + (size_t)b * Tk * pos_stride + head;
  const float* vb = v + (size_t)b * Tk * pos_stride + head;
  // V's output slab, or (a slab past hd) zeros read from the block's first
  const float* v_src = vb + (ocol < hd ? ocol : col0);
  const int v_cols = ocol < hd ? kSlab : 0;
  const int row0 = qb * S::kRows + warp * 16;  // the warp's first row
  const int rows[2] = {row0 + g, row0 + g + 8};

  float o[S::kOT][4];
#pragma unroll
  for (int n = 0; n < S::kOT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, (qb + 1) * S::kRows) : Tk;
  const int n_tiles = (t_end + kKeys - 1) / kKeys;

  auto stage = [&](int tile, int buf) {
    float* ks = stages + buf * S::kStage;
    float* vs = ks + S::kKTile;
    float* oks = vs + S::kVTile;
    const int k0 = tile * kKeys;
    stage_cols<S::kW, S::kThreads>(ks, kStride, kb + col0, pos_stride, k0,
                                   kKeys, Tk, n_cols, tid);
    stage_cols<kSlab, S::kThreads>(vs, kVStride, v_src, pos_stride, k0,
                                   kKeys, Tk, v_cols, tid);
    for (int j = tid; j < kKeys; j += S::kThreads)
      oks[j] = key_flag(key_mask, b, Tk, k0 + j);
    tf32x3::cp_async_commit();
  };
  if (n_tiles > 0) {  // one group: q and the first key tile
    stage_cols<S::kW, S::kThreads>(
        q_s, kStride, q + (size_t)b * Tq * pos_stride + head + col0,
        pos_stride, qb * S::kRows, S::kRows, Tq, n_cols, tid);
    stage(0, 0);
  }
  const float* qw = q_s + warp * 16 * kStride;
  auto q_frag = [&](int kk) {
    return tf32x3::load_a(qw + 8 * kk, kStride, g, t);
  };
  auto xi = [&](int) { return warp * 32 + lane; };
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1, (it + 1) & 1);  // its buffer was freed at it - 1's end
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    float* ks = stages + (it & 1) * S::kStage;
    float* vs = ks + S::kKTile;
    const float* oks = vs + S::kVTile;
    tf32x3::split_tile<S::kW, S::kThreads>(ks, k_lo, kStride, kKeys, tid);
    tf32x3::split_tile<kSlab, S::kThreads>(vs, v_lo, kVStride, kKeys, tid);
    // the tile is split and has landed for every warp; any of its keys
    // real and unmasked (the cluster's answer too)
    const bool any = __syncthreads_or(tid < kKeys && oks[tid] > 0.f);
    if (any) {
      const int k0 = it * kKeys;
      // the warp's rows are real and, causal, not every key of the tile
      // follows its last row (the same warp of every block)
      const bool active = row0 < Tq && !(causal && k0 > row0 + 15);
      float* xb = x_s + (ex & 1) * S::kX;
      if (active) {
        // this block's partial S = Q K^T over its kS slabs, in order
        float p[1][4];
        const tf32x3::SplitTile kt{ks, k_lo};
        slab_product<kS>(p, q_frag, kt, kStride, g, t);
        reinterpret_cast<float4*>(xb)[xi(0)] = f4(p[0]);
      }
      cluster.sync();  // every block's partial is written
      ++ex;
      share_if<kSplit>(cluster, xb, S::kX / 4, C, S::kThreads, tid);
      if (active) {
        float s[1][4];
        sum_or_gather<kSplit>(s, cluster, xb, S::kX / 4, C, xi);
        const bool diag = causal && k0 + kKeys - 1 > row0;
        float cmax[2] = {kNeg, kNeg};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 2 * t + (e & 1);
          const int r = e >> 1;
          const bool ok = oks[col] > 0.f && (!diag || k0 + col <= rows[r]);
          s[0][e] = ok ? s[0][e] * sm_scale : -INFINITY;
          cmax[r] = fmaxf(cmax[r], s[0][e]);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 1));
          cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 2));
          const float m_new = fmaxf(m[r], cmax[r]);
          alpha[r] = expf(m[r] - m_new);  // 0 on the row's first real key
          m[r] = m_new;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < S::kOT; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = expf(s[0][e] - m[e >> 1]);  // masked: exactly 0
          s[0][e] = pe;
          l[e >> 1] += pe;
        }
        // O += P V over the output slab
        const tf32x3::SplitTile vt{vs, v_lo};
        tf32x3::tile_product<1, S::kOT, 1>(o, s, vt, kVStride, g, t);
      }
    }
    __syncthreads();  // every warp is done with buffer it & 1 and the lo
  }
  if (n_tiles > 0) cluster.sync();  // no block leaves while a peer reads

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (ocol >= hd) return;  // the last block's missing slab
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Tq) continue;
    float* o_row = out + (size_t)b * Tq * pos_stride + head + ocol +
                   (size_t)rows[r] * pos_stride;
#pragma unroll
    for (int n = 0; n < S::kOT; ++n) {
      float2 val = make_float2(0.f, 0.f);
      if (l[r] > 0.f)
        val = make_float2(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
      *reinterpret_cast<float2*>(o_row + 8 * n + 2 * t) = val;
    }
    if (lse != nullptr && t == 0 && ocol == 0)  // one block, pass 0
      lse[((size_t)b * Tq + rows[r]) * nh + h] =
          l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
  }
}

template <int kS>
struct SlabsDkvF32 {
  static constexpr int kWarps = kS == 2 ? 4 : 2;
  static constexpr int kStages = kS <= 3 ? 2 : 1;  // query tiles in flight
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKeys = 16 * kWarps;
  static constexpr int kQ = 8;               // query rows per tile
  static constexpr int kW = kS * kSlab;      // the block's columns
  static constexpr int kStride = kW + 4;     // floats per shared row
  static constexpr int kDT = kSlab / 8;      // 8-wide tiles of dK, dV
  static constexpr int kKV = 2 * kKeys * kStride;
  static constexpr int kTile = kQ * kStride;
  // q, dO (hi after the split), then lse, D, a row flag (+ kQ of padding)
  static constexpr int kStage = 2 * kTile + 4 * kQ;
  static constexpr int kX = 2 * kWarps * 4 * 32;  // floats of a buffer
  static constexpr size_t kSmem =
      (kKV + kStages * kStage + 2 * kTile + 2 * kX) * sizeof(float);
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// grid (C' * ceil(Tk / kKeys), nh, B) in clusters of (C', 1, 1);
// SlabsDkvF32<kS>::kThreads threads, kSmem bytes of dynamic shared
// memory; dK and dV of output slab `pass`.  Every block sums the C'
// partials (the one-slab f32 dK/dV's exchange: dK and dV hold 128
// registers a thread)
template <int kS>
__global__ void __launch_bounds__(SlabsDkvF32<kS>::kThreads, 1)
flash_bwd_dkv_slabs_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const float* __restrict__ key_mask, float* __restrict__ dk,
    float* __restrict__ dv, int Tq, int Tk, int nh, int hd, int causal,
    float sm_scale, int pass) {
  using D = SlabsDkvF32<kS>;
  constexpr int kQ = D::kQ, kStride = D::kStride;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * D::kW;
  const int ocol = col0 + pass * kSlab;
  const int n_cols = min(D::kW, hd - col0);
  float* ks = smem;
  float* vs = smem + D::kKeys * kStride;
  float* stages = smem + D::kKV;
  float* q_lo = stages + D::kStages * D::kStage;
  float* do_lo = q_lo + D::kTile;
  float* x_s = do_lo + D::kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t base = (size_t)b * Tk * pos_stride + (size_t)h * hd + col0;
  const size_t q_base = (size_t)b * Tq * pos_stride + (size_t)h * hd + col0;
  const size_t row_base = (size_t)b * Tq * nh + h;  // lse/dsum of (b, 0, h)
  const int key0 = kb * D::kKeys + warp * 16;       // the warp's first key
  const int keys[2] = {key0 + g, key0 + g + 8};
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kok[r] = key_ok(key_mask, b, Tk, keys[r]);

  float dka[D::kDT][4], dva[D::kDT][4];
#pragma unroll
  for (int n = 0; n < D::kDT; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  // no key of the block is attended: zeros (the whole cluster agrees)
  const bool any = __syncthreads_or(kok[0] || kok[1]);
  // causal (Tq == Tk): a row before the block's first key attends none
  const int q_begin = causal ? kb * D::kKeys : 0;
  const int n_tiles = any ? (Tq - q_begin + kQ - 1) / kQ : 0;

  auto stage_q = [&](int tile, int buf) {
    float* qs = stages + buf * D::kStage;
    float* dos = qs + D::kTile;
    float* lse_s = dos + D::kTile;
    float* d_s = lse_s + kQ;
    float* rok_s = d_s + kQ;
    const int q0 = q_begin + tile * kQ;
    stage_cols<D::kW, D::kThreads>(qs, kStride, q + q_base, pos_stride, q0,
                                   kQ, Tq, n_cols, tid);
    stage_cols<D::kW, D::kThreads>(dos, kStride, dout + q_base, pos_stride,
                                   q0, kQ, Tq, n_cols, tid);
    for (int i = tid; i < kQ; i += D::kThreads) {
      const int row = q0 + i;
      float lv = 0.f, d = 0.f;
      bool ok = false;
      if (row < Tq) {
        lv = lse[row_base + (size_t)row * nh];
        d = dsum[row_base + (size_t)row * nh];
        ok = isfinite(lv);
      }
      lse_s[i] = ok ? lv : 0.f;
      d_s[i] = d;
      rok_s[i] = ok ? 1.f : 0.f;  // a real row with a key to attend
    }
    tf32x3::cp_async_commit();
  };

  if (n_tiles > 0) {
    stage_cols<D::kW, D::kThreads>(ks, kStride, k + base, pos_stride,
                                   kb * D::kKeys, D::kKeys, Tk, n_cols, tid);
    stage_cols<D::kW, D::kThreads>(vs, kStride, v + base, pos_stride,
                                   kb * D::kKeys, D::kKeys, Tk, n_cols, tid);
    stage_q(0, 0);  // one group: K, V and the first query tile
  }
  const float* kw = ks + warp * 16 * kStride;
  const float* vw = vs + warp * 16 * kStride;
  auto k_frag = [&](int kk) {
    return tf32x3::load_a(kw + 8 * kk, kStride, g, t);
  };
  auto v_frag = [&](int kk) {
    return tf32x3::load_a(vw + 8 * kk, kStride, g, t);
  };
  auto xi = [&](int j) { return (warp * 2 + j) * 32 + lane; };
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    if constexpr (D::kStages == 2) {
      if (it + 1 < n_tiles) {
        stage_q(it + 1, (it + 1) & 1);
        tf32x3::cp_async_wait<1>();
      } else {
        tf32x3::cp_async_wait<0>();
      }
    } else {
      tf32x3::cp_async_wait<0>();  // copied at the end of tile it - 1
    }
    float* qs = stages + (D::kStages == 2 ? it & 1 : 0) * D::kStage;
    float* dos = qs + D::kTile;
    tf32x3::split_tile<D::kW, D::kThreads>(qs, q_lo, kStride, kQ, tid);
    tf32x3::split_tile<D::kW, D::kThreads>(dos, do_lo, kStride, kQ, tid);
    __syncthreads();

    const int q0 = q_begin + it * kQ;
    // the warp's keys are real and, causal, not every row of the tile
    // precedes its first key (the same warp of every block)
    const bool active = key0 < Tk && (!causal || q0 + kQ - 1 >= key0);
    float* xb = x_s + (ex & 1) * D::kX;
    float p[1][4], ds[1][4];
    if (active) {
      // this block's partial S^T = K Q^T and dP^T = V dO^T over its kS
      // slabs, in order
      const tf32x3::SplitTile qt{qs, q_lo}, dot{dos, do_lo};
      slab_product<kS>(p, k_frag, qt, kStride, g, t);
      slab_product<kS>(ds, v_frag, dot, kStride, g, t);
      reinterpret_cast<float4*>(xb)[xi(0)] = f4(p[0]);
      reinterpret_cast<float4*>(xb)[xi(1)] = f4(ds[0]);
    }
    cluster.sync();
    ++ex;
    if (active) {
      // S^T summed, P^T = exp(S^T * scale - lse); exactly 0 where the
      // pair is masked or the row has no key to attend
      sum_partials<1>(p, cluster, xb, C, xi);
      const float* lse_s = dos + D::kTile;
      const float* d_s = lse_s + kQ;
      const float* rok_s = d_s + kQ;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * t + (e & 1);
        const int r = e >> 1;
        const bool ok =
            kok[r] && rok_s[col] > 0.f && (!causal || keys[r] <= q0 + col);
        p[0][e] = ok ? expf(p[0][e] * sm_scale - lse_s[col]) : 0.f;
      }
      // dV += P^T dO over the output slab
      const tf32x3::SplitTile qt{qs + pass * kSlab, q_lo + pass * kSlab};
      const tf32x3::SplitTile dot{dos + pass * kSlab, do_lo + pass * kSlab};
      tf32x3::tile_product<1, D::kDT, 1>(dva, p, dot, kStride, g, t);
      // dP^T summed, dS^T = P^T (dP^T - D) and dK += dS^T Q
      sum_partials<1>(ds, cluster, xb, C, [&](int) { return xi(1); });
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[0][e] = p[0][e] * (ds[0][e] - d_s[2 * t + (e & 1)]);
      tf32x3::tile_product<1, D::kDT, 1>(dka, ds, qt, kStride, g, t);
    }
    __syncthreads();  // every warp is done with the tile's buffer and lo
    if constexpr (D::kStages == 1)
      if (it + 1 < n_tiles) stage_q(it + 1, 0);
  }
  if (n_tiles > 0) cluster.sync();  // no block leaves while a peer reads

  if (ocol >= hd) return;  // the last block's missing slab
  const size_t o_base = base - col0 + ocol;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= Tk) continue;
    float* dk_row = dk + o_base + (size_t)keys[r] * pos_stride;
    float* dv_row = dv + o_base + (size_t)keys[r] * pos_stride;
#pragma unroll
    for (int n = 0; n < D::kDT; ++n) {
      *reinterpret_cast<float2*>(dk_row + 8 * n + 2 * t) = make_float2(
          dka[n][2 * r] * sm_scale, dka[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv_row + 8 * n + 2 * t) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int kS>
struct SlabsFwdBf16 {
  static constexpr int kThreads = 128;  // one warpgroup
  static constexpr int kRows = 64;
  static constexpr int kKeys = 32;      // keys per tile
  static constexpr int kQ = SlabTile::bytes(kRows);  // one slab of q
  static constexpr int kK = SlabTile::bytes(kKeys);  // one slab of a K or V
  static constexpr int kStage = (kS + 1) * kK;        // K (kS slabs), V
  // a buffer: each thread's S registers, as float4 [kKeys / 8][threads]
  static constexpr int kXFloats = kThreads * kKeys / 2;
  static constexpr int kXOff = kS * kQ + 2 * kStage;
  static constexpr int kBarOff = kXOff + 2 * kXFloats * 4;
  static constexpr size_t kSmem = kBarOff + 3 * 8 + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// grid (C' * ceil(Tq / 64), nh, B) in clusters of (C', 1, 1);
// SlabsFwdBf16<kS>::kThreads threads, kSmem bytes of dynamic shared
// memory; the maps' boxes are 64 rows (q) and 32 rows (k, v); output
// slab `pass`; the exchange split in two (every such cluster has more
// than 8 blocks)
template <int kS>
__global__ void __launch_bounds__(SlabsFwdBf16<kS>::kThreads, 1)
flash_fwd_slabs_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const float* __restrict__ key_mask,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            int Tq, int Tk, int nh, int hd, int causal,
                            float sm_scale, int pass) {
  using S = SlabsFwdBf16<kS>;
  constexpr int kKeys = S::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;                 // kS slabs of q
  unsigned char* tiles = smem + kS * S::kQ;  // stage s: K's kS slabs, V
  float* x_s = reinterpret_cast<float*>(smem + S::kXOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* q_bar = full + 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * kS * kSlab;
  const int ocol = col0 + pass * kSlab;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const int r_blk = qb * S::kRows;          // the block's first row
  const int q_row = r_blk + 16 * warp + g;
  const int rows[2] = {q_row, q_row + 8};   // this thread's rows of O
  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, r_blk + S::kRows) : Tk;
  const int n_tiles = (t_end + kKeys - 1) / kKeys;
  // thread 0: tile it's K (kS slabs) and V (the output slab) into its
  // stage; boxes past hd (the last block's missing slab) are zero-filled
  auto issue = [&](int it) {
    const int s = it & 1;
    unsigned char* ks = tiles + s * S::kStage;
    tma::mbar_arrive_tx(&full[s], S::kStage);
#pragma unroll
    for (int j = 0; j < kS; ++j)
      wg::load_tile<kSlab>(ks + j * S::kK, &k_map, kKeys, it * kKeys, h, b,
                           &full[s], col0 + j * kSlab);
    wg::load_tile<kSlab>(ks + kS * S::kK, &v_map, kKeys, it * kKeys, h, b,
                         &full[s], ocol);
  };
  if (tid == 0) {
    tma::mbar_init(&full[0], 1);
    tma::mbar_init(&full[1], 1);
    tma::mbar_init(q_bar, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma::mbar_arrive_tx(q_bar, kS * S::kQ);
#pragma unroll
    for (int j = 0; j < kS; ++j)
      wg::load_tile<kSlab>(qs + j * S::kQ, &q_map, S::kRows, r_blk, h, b,
                           q_bar, col0 + j * kSlab);
    if (n_tiles > 0) issue(0);
  }

  const float scale_l2 = sm_scale * kLog2e;
  float oa[kSlab / 2];
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) oa[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // log2 units; this thread's
  tma::mbar_wait(q_bar, 0);
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it & 1;
    // the next tile's stage was freed by the barrier ending tile it - 1
    if (tid == 0 && it + 1 < n_tiles) issue(it + 1);
    const int k0 = it * kKeys;
    // bit 2 i + e: key k0 + 8 i + 2 t + e (this thread's columns of S) is
    // real and unmasked
    uint32_t okb = 0;
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        okb |= (uint32_t)key_ok(key_mask, b, Tk, k0 + 8 * i + 2 * t + e)
               << (2 * i + e);
    const bool any = __syncthreads_or(okb != 0);  // the cluster's too
    tma::mbar_wait(&full[s], (it >> 1) & 1);
    if (any) {
      const unsigned char* ks = tiles + s * S::kStage;
      const unsigned char* vs = ks + kS * S::kK;
      // causal: every key of the tile follows the block's last row
      const bool active = r_blk < Tq && !(causal && k0 > r_blk + 63);
      float* xb = x_s + (ex & 1) * S::kXFloats;
      auto xi = [&](int i) { return i * S::kThreads + tid; };
      float sa[kKeys / 2];  // S, then P
      if (active) {
        // this block's partial S = Q K^T over its kS slabs, in order
        wg::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kS; ++j)
#pragma unroll
          for (int kk = 0; kk < kSlab / 16; ++kk)
            wg::Mma<kKeys>::ss(
                sa, wg::desc_k<kSlab>(qs + j * S::kQ, S::kRows, 0, kk),
                wg::desc_k<kSlab>(ks + j * S::kK, kKeys, 0, kk),
                j > 0 || kk > 0);
        wg::commit();
        wg::wait<0>();
        wg::keep(sa);
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i)
          reinterpret_cast<float4*>(xb)[xi(i)] = f4(sa + 4 * i);
      }
      cluster.sync();  // every block's partial is written
      ++ex;
      share_if<true>(cluster, xb, S::kXFloats / 4, C, S::kThreads, tid);
      if (active) {
        float sum[kKeys / 8][4];
        sum_or_gather<true>(sum, cluster, xb, S::kXFloats / 4, C, xi);
        // mask and scale (log2 units), the tile's max over this thread's
        // columns
        const bool diag = causal && k0 + kKeys - 1 > r_blk;
        float cmax[2] = {kNeg, kNeg};
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = 8 * i + 2 * t + (e & 1);
            const bool ok = ((okb >> (2 * i + (e & 1))) & 1) &&
                            (!diag || k0 + c <= rows[r]);
            const float x = ok ? sum[i][e] * scale_l2 : -INFINITY;
            sa[4 * i + e] = x;
            cmax[r] = fmaxf(cmax[r], x);
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 1));
          cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 2));
          const float m_new = fmaxf(m[r], cmax[r]);
          alpha[r] = ex2(m[r] - m_new);  // 0 on the row's first real key
          m[r] = m_new;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < kSlab / 2; ++i) oa[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const float p = ex2(sa[i] - m[(i >> 1) & 1]);  // masked: exactly 0
          sa[i] = p;
          l[(i >> 1) & 1] += p;  // the unrounded P, as the library sums it
        }
        uint32_t pf[kKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wg::a_frag(pf[kk], sa, kk);  // P rounded to bf16
        wg::wgmma_fence();
        // O += P V over the tile's keys (the output slab)
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wg::Mma<kSlab>::rs(oa, pf[kk], wg::desc_mn<kSlab>(vs, kKeys, kk, 0),
                             1);
        wg::commit();
        wg::wait<0>();
        wg::keep(oa);
        wg::keep(pf);
      }
    }
    __syncthreads();  // stage s is free for tile it + 2
  }
  cluster.sync();  // no block leaves while a peer reads its partials

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (ocol >= hd) return;  // the last block's missing slab
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) {
    const float li = l[(i >> 1) & 1];
    oa[i] = li > 0.f ? oa[i] / li : 0.f;  // no key to attend: zeros
  }
  const size_t pos_stride = (size_t)nh * hd;
  store_rows<kSlab>(out + (size_t)b * Tq * pos_stride + (size_t)h * hd + ocol,
                    pos_stride, rows, Tq, oa, t);
  if (lse != nullptr && t == 0 && ocol == 0) {  // one block, pass 0
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < Tq)
        lse[((size_t)b * Tq + rows[r]) * nh + h] =
            l[r] > 0.f ? m[r] / kLog2e + logf(l[r]) : INFINITY;
  }
}

template <int kS>
struct SlabsDkvBf16 {
  static constexpr int kThreads = 128;  // one warpgroup
  static constexpr int kKeys = 64;
  static constexpr int kQ = 32;         // query rows per tile
  static constexpr int kStages = kS <= 3 ? 2 : 1;  // query tiles in flight
  static constexpr int kKV = SlabTile::bytes(kKeys);  // one slab of K or V
  static constexpr int kTile = SlabTile::bytes(kQ);   // one slab of q or dO
  static constexpr int kStage = 2 * kS * kTile;       // q, dO (kS slabs)
  // a buffer: each thread's S^T and dP^T registers, float4 [kQ / 4][threads]
  static constexpr int kXFloats = kThreads * kQ;
  // K, V, the stages of q and dO, the tile's lse and D, the buffers
  static constexpr int kRowsOff = 2 * kS * kKV + kStages * kStage;
  static constexpr int kXOff = kRowsOff + 2 * kQ * 4;
  static constexpr int kBarOff = kXOff + 2 * kXFloats * 4;
  static constexpr size_t kSmem = kBarOff + 3 * 8 + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// grid (C' * ceil(Tk / 64), nh, B) in clusters of (C', 1, 1);
// SlabsDkvBf16<kS>::kThreads threads, kSmem bytes of dynamic shared
// memory; the maps' boxes are 32 rows (q, dO) and 64 rows (k, v); dK and
// dV of output slab `pass`; the exchange split in two
template <int kS>
__global__ void __launch_bounds__(SlabsDkvBf16<kS>::kThreads, 1)
flash_bwd_dkv_slabs_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const float* __restrict__ key_mask, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Tq, int Tk, int nh, int hd, int causal,
    float sm_scale, int pass) {
  using D = SlabsDkvBf16<kS>;
  constexpr int kQ = D::kQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;                   // kS slabs of K
  unsigned char* vs = smem + kS * D::kKV;     // and of V
  unsigned char* tiles = smem + 2 * kS * D::kKV;  // stage s: q, then dO
  float* rows_s = reinterpret_cast<float*>(smem + D::kRowsOff);  // lse, D
  float* x_s = reinterpret_cast<float*>(smem + D::kXOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + D::kBarOff);
  uint64_t* kv_bar = full + 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * kS * kSlab;
  const int ocol = col0 + pass * kSlab;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t o_base = (size_t)b * Tk * pos_stride + (size_t)h * hd + ocol;
  const size_t row_base = (size_t)b * Tq * nh + h;
  const int kw = kb * D::kKeys;           // the block's first key
  const int key0 = kw + 16 * warp + g;
  const int keys[2] = {key0, key0 + 8};   // this thread's rows of dK, dV
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kok[r] = key_ok(key_mask, b, Tk, keys[r]);
  float dka[kSlab / 2], dva[kSlab / 2];
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) dka[i] = dva[i] = 0.f;
  // no key of the block is attended: zeros (the whole cluster agrees)
  if (!__syncthreads_or(kok[0] || kok[1])) {
    if (ocol < hd) {
      store_rows<kSlab>(dk + o_base, pos_stride, keys, Tk, dka, t);
      store_rows<kSlab>(dv + o_base, pos_stride, keys, Tk, dva, t);
    }
    return;
  }
  // causal (Tq == Tk): a row before the block's first key attends none
  const int q_begin = causal ? kw : 0;
  const int n_tiles = (Tq - q_begin + kQ - 1) / kQ;
  // thread 0: tile it's q and dO (kS slabs each; boxes past hd
  // zero-filled) into its stage
  auto issue = [&](int it) {
    const int s = D::kStages == 2 ? it & 1 : 0;
    const int q0 = q_begin + it * kQ;
    unsigned char* qs = tiles + s * D::kStage;
    tma::mbar_arrive_tx(&full[s], D::kStage);
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      wg::load_tile<kSlab>(qs + j * D::kTile, &q_map, kQ, q0, h, b, &full[s],
                           col0 + j * kSlab);
      wg::load_tile<kSlab>(qs + (kS + j) * D::kTile, &do_map, kQ, q0, h, b,
                           &full[s], col0 + j * kSlab);
    }
  };
  if (tid == 0) {
    tma::mbar_init(&full[0], 1);
    tma::mbar_init(&full[1], 1);
    tma::mbar_init(kv_bar, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma::mbar_arrive_tx(kv_bar, 2 * kS * D::kKV);
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      wg::load_tile<kSlab>(ks + j * D::kKV, &k_map, D::kKeys, kw, h, b,
                           kv_bar, col0 + j * kSlab);
      wg::load_tile<kSlab>(vs + j * D::kKV, &v_map, D::kKeys, kw, h, b,
                           kv_bar, col0 + j * kSlab);
    }
    if (n_tiles > 0) issue(0);
  }

  const float scale_l2 = sm_scale * kLog2e;
  tma::mbar_wait(kv_bar, 0);
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = D::kStages == 2 ? it & 1 : 0;
    if constexpr (D::kStages == 2)
      if (tid == 0 && it + 1 < n_tiles) issue(it + 1);
    const int q0 = q_begin + it * kQ;
    if (tid < kQ) {  // the tile's lse (log2 units; +inf: no key) and D
      const int row = q0 + tid;
      float lv = INFINITY, d = 0.f;
      if (row < Tq) {
        const float x = lse[row_base + (size_t)row * nh];
        if (isfinite(x)) lv = x * kLog2e;
        d = dsum[row_base + (size_t)row * nh];
      }
      rows_s[tid] = lv;
      rows_s[kQ + tid] = d;
    }
    tma::mbar_wait(&full[s], D::kStages == 2 ? (it >> 1) & 1 : it & 1);
    const unsigned char* qs = tiles + s * D::kStage;
    const unsigned char* dos = qs + kS * D::kTile;
    // causal: every row of the tile precedes the block's first key
    const bool active = kw < Tk && !(causal && q0 + kQ - 1 < kw);
    float* xb = x_s + (ex & 1) * D::kXFloats;
    auto xi = [&](int i) { return i * D::kThreads + tid; };
    float sa[kQ / 2], pa[kQ / 2];  // S^T then P^T; dP^T then dS^T
    if (active) {
      // this block's partial S^T = K Q^T and dP^T = V dO^T over its kS
      // slabs, in order
      wg::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kS; ++j)
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)
          wg::Mma<kQ>::ss(sa,
                          wg::desc_k<kSlab>(ks + j * D::kKV, D::kKeys, 0, kk),
                          wg::desc_k<kSlab>(qs + j * D::kTile, kQ, 0, kk),
                          j > 0 || kk > 0);
#pragma unroll
      for (int j = 0; j < kS; ++j)
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)
          wg::Mma<kQ>::ss(pa,
                          wg::desc_k<kSlab>(vs + j * D::kKV, D::kKeys, 0, kk),
                          wg::desc_k<kSlab>(dos + j * D::kTile, kQ, 0, kk),
                          j > 0 || kk > 0);
      wg::commit();
      wg::wait<0>();
      wg::keep(sa);
      wg::keep(pa);
#pragma unroll
      for (int i = 0; i < kQ / 8; ++i) {
        reinterpret_cast<float4*>(xb)[xi(i)] = f4(sa + 4 * i);
        reinterpret_cast<float4*>(xb)[xi(kQ / 8 + i)] = f4(pa + 4 * i);
      }
    }
    cluster.sync();  // every block's partials (and the tile's rows) are in
    ++ex;
    share_if<true>(cluster, xb, D::kXFloats / 4, C, D::kThreads, tid);
    if (active) {
      float sum[kQ / 4][4];
      sum_or_gather<true>(sum, cluster, xb, D::kXFloats / 4, C, xi);
      // P^T = exp(S^T * scale - lse), dS^T = P^T (dP^T - D) * scale
      const bool diag = causal && q0 < kw + D::kKeys - 1;
#pragma unroll
      for (int i = 0; i < kQ / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * i + 2 * t + (e & 1);
          const float lv = rows_s[c], d = rows_s[kQ + c];
          const bool ok =
              kok[r] && lv != INFINITY && (!diag || keys[r] <= q0 + c);
          const float p = ok ? ex2(fmaf(sum[i][e], scale_l2, -lv)) : 0.f;
          sa[4 * i + e] = p;
          pa[4 * i + e] = p * (sum[kQ / 8 + i][e] - d) * sm_scale;
        }
      }
      uint32_t pf[kQ / 16][4], df[kQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        wg::a_frag(pf[kk], sa, kk);  // P^T rounded to bf16
        wg::a_frag(df[kk], pa, kk);  // dS^T rounded to bf16
      }
      const unsigned char* q_out = qs + pass * D::kTile;  // output slab
      const unsigned char* do_out = dos + pass * D::kTile;
      wg::wgmma_fence();
      // dV += P^T dO, dK += dS^T Q over the tile's queries (the output
      // slab)
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wg::Mma<kSlab>::rs(dva, pf[kk], wg::desc_mn<kSlab>(do_out, kQ, kk, 0),
                           1);
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wg::Mma<kSlab>::rs(dka, df[kk], wg::desc_mn<kSlab>(q_out, kQ, kk, 0),
                           1);
      wg::commit();
      wg::wait<0>();
      wg::keep(dva);
      wg::keep(dka);
      wg::keep(pf);
      wg::keep(df);
    }
    __syncthreads();  // the stage and the rows are free for the next tiles
    if constexpr (D::kStages == 1)
      if (tid == 0 && it + 1 < n_tiles) issue(it + 1);
  }
  cluster.sync();  // no block leaves while a peer reads its partials
  if (ocol >= hd) return;  // the last block's missing slab
  store_rows<kSlab>(dk + o_base, pos_stride, keys, Tk, dka, t);
  store_rows<kSlab>(dv + o_base, pos_stride, keys, Tk, dva, t);
}

template <int kS>
struct SlabsDqF32 {
  static constexpr int kWarps = 2;
  static constexpr int kStages = kS == 3 ? 2 : 1;  // K tiles
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kKeys = 8;            // keys per tile
  static constexpr int kW = kS * kSlab;      // the block's columns
  static constexpr int kStride = kW + 4;     // floats per shared row
  static constexpr int kDT = kSlab / 8;      // 8-wide tiles of dQ
  static constexpr int kQD = 2 * kRows * kStride;   // q, dO
  static constexpr int kTile = kKeys * kStride;
  static constexpr int kStage = 2 * kTile + kKeys;  // K, V (hi), key flags
  static constexpr int kX = 2 * kWarps * 4 * 32;   // floats of a buffer
  static constexpr size_t kSmem =
      (kQD + kStages * kStage + 2 * kTile + 2 * kX) * sizeof(float);
  static_assert(kStage % 4 == 0, "16-byte aligned stages");
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// grid (C' * ceil(Tq / kRows), nh, B) in clusters of (C', 1, 1);
// SlabsDqF32<kS>::kThreads threads, kSmem bytes of dynamic shared memory;
// dQ of output slab `pass`.  Per key tile: each warp forms its partial S
// = Q K^T and dP = dO V^T over the block's kS slabs and writes both;
// after a cluster barrier (kSplit: share_if's exchange) it sums the
// cluster's, forms P = exp(S * scale - lse) and dS = P (dP - D), and adds
// dS K over the output slab to dQ
template <int kS, bool kSplit>
__global__ void __launch_bounds__(SlabsDqF32<kS>::kThreads, 1)
flash_bwd_dq_slabs_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const float* __restrict__ key_mask, float* __restrict__ dq, int Tq,
    int Tk, int nh, int hd, int causal, float sm_scale, int pass) {
  using D = SlabsDqF32<kS>;
  constexpr int kKeys = D::kKeys, kStride = D::kStride;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * D::kW;
  const int ocol = col0 + pass * kSlab;
  const int n_cols = min(D::kW, hd - col0);
  float* q_s = smem;
  float* do_s = q_s + D::kRows * kStride;
  float* stages = smem + D::kQD;              // K, V, key flags
  float* k_lo = stages + D::kStages * D::kStage;  // lo parts of the tile
  float* v_lo = k_lo + D::kTile;
  float* x_s = v_lo + D::kTile;               // the two exchange buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t base = (size_t)b * Tq * pos_stride + (size_t)h * hd + col0;
  const size_t k_base = (size_t)b * Tk * pos_stride + (size_t)h * hd + col0;
  const size_t row_base = (size_t)b * Tq * nh + h;  // lse/dsum of (b, 0, h)
  const int row0 = qb * D::kRows + warp * 16;       // the warp's first row
  const int rows[2] = {row0 + g, row0 + g + 8};

  float l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  bool rok[2] = {false, false};  // a real row with a key to attend
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < Tq) {
      l[r] = lse[row_base + (size_t)rows[r] * nh];
      dd[r] = dsum[row_base + (size_t)rows[r] * nh];
      rok[r] = isfinite(l[r]);
      if (!rok[r]) l[r] = 0.f;
    }
  }
  float dqa[D::kDT][4];
#pragma unroll
  for (int n = 0; n < D::kDT; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  // no row of the block attends a key: zeros (the whole cluster agrees)
  const bool any_row = __syncthreads_or(rok[0] || rok[1]);
  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, (qb + 1) * D::kRows) : Tk;
  const int n_tiles = any_row ? (t_end + kKeys - 1) / kKeys : 0;

  auto stage = [&](int tile, int buf) {
    float* ks = stages + buf * D::kStage;
    float* vs = ks + D::kTile;
    float* oks = vs + D::kTile;
    const int k0 = tile * kKeys;
    stage_cols<D::kW, D::kThreads>(ks, kStride, k + k_base, pos_stride, k0,
                                   kKeys, Tk, n_cols, tid);
    stage_cols<D::kW, D::kThreads>(vs, kStride, v + k_base, pos_stride, k0,
                                   kKeys, Tk, n_cols, tid);
    for (int j = tid; j < kKeys; j += D::kThreads)
      oks[j] = key_flag(key_mask, b, Tk, k0 + j);
    tf32x3::cp_async_commit();
  };
  if (n_tiles > 0) {  // one group: q, dO and the first key tile
    stage_cols<D::kW, D::kThreads>(q_s, kStride, q + base, pos_stride,
                                   qb * D::kRows, D::kRows, Tq, n_cols, tid);
    stage_cols<D::kW, D::kThreads>(do_s, kStride, dout + base, pos_stride,
                                   qb * D::kRows, D::kRows, Tq, n_cols, tid);
    stage(0, 0);
  }
  const float* qw = q_s + warp * 16 * kStride;
  const float* dow = do_s + warp * 16 * kStride;
  auto q_frag = [&](int kk) {
    return tf32x3::load_a(qw + 8 * kk, kStride, g, t);
  };
  auto do_frag = [&](int kk) {
    return tf32x3::load_a(dow + 8 * kk, kStride, g, t);
  };
  auto xi = [&](int j) { return (warp * 2 + j) * 32 + lane; };
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    if constexpr (D::kStages == 2) {
      if (it + 1 < n_tiles) {
        stage(it + 1, (it + 1) & 1);  // its buffer was freed at it - 1's end
        tf32x3::cp_async_wait<1>();
      } else {
        tf32x3::cp_async_wait<0>();
      }
    } else {
      tf32x3::cp_async_wait<0>();  // copied at the end of tile it - 1
    }
    float* ks = stages + (D::kStages == 2 ? it & 1 : 0) * D::kStage;
    float* vs = ks + D::kTile;
    const float* oks = vs + D::kTile;
    // the tile is split and has landed for every warp; any of its keys
    // real and unmasked (the cluster's answer too)
    tf32x3::split_tile<D::kW, D::kThreads>(ks, k_lo, kStride, kKeys, tid);
    tf32x3::split_tile<D::kW, D::kThreads>(vs, v_lo, kStride, kKeys, tid);
    const bool any = __syncthreads_or(tid < kKeys && oks[tid] > 0.f);
    if (any) {
      const int k0 = it * kKeys;
      // the warp's rows are real and, causal, not every key of the tile
      // follows its last row (the same warp of every block)
      const bool active = row0 < Tq && !(causal && k0 > row0 + 15);
      float* xb = x_s + (ex & 1) * D::kX;
      float p[1][4], ds[1][4];
      if (active) {
        // this block's partial S = Q K^T and dP = dO V^T over its kS
        // slabs, in order
        const tf32x3::SplitTile kt{ks, k_lo}, vt{vs, v_lo};
        slab_product<kS>(p, q_frag, kt, kStride, g, t);
        slab_product<kS>(ds, do_frag, vt, kStride, g, t);
        reinterpret_cast<float4*>(xb)[xi(0)] = f4(p[0]);
        reinterpret_cast<float4*>(xb)[xi(1)] = f4(ds[0]);
      }
      cluster.sync();  // every block's partials are written
      ++ex;
      share_if<kSplit>(cluster, xb, D::kX / 4, C, D::kThreads, tid);
      if (active) {
        // S and dP summed, P = exp(S * scale - lse) (exactly 0 where the
        // pair is masked or the row has no key to attend), dS = P (dP -
        // D); dQ += dS K over the output slab's columns of the tile
        float sd[2][4];
        sum_or_gather<kSplit>(sd, cluster, xb, D::kX / 4, C, xi);
        const bool diag = causal && k0 + kKeys - 1 > row0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 2 * t + (e & 1);
          const int r = e >> 1;
          const bool ok =
              rok[r] && oks[col] > 0.f && (!diag || k0 + col <= rows[r]);
          const float pv = ok ? expf(sd[0][e] * sm_scale - l[r]) : 0.f;
          ds[0][e] = pv * (sd[1][e] - dd[r]);
        }
        const tf32x3::SplitTile ko{ks + pass * kSlab, k_lo + pass * kSlab};
        tf32x3::tile_product<1, D::kDT, 1>(dqa, ds, ko, kStride, g, t);
      }
    }
    __syncthreads();  // every warp is done with the tile's buffer and lo
    if constexpr (D::kStages == 1)
      if (it + 1 < n_tiles) stage(it + 1, 0);
  }
  if (n_tiles > 0) cluster.sync();  // no block leaves while a peer reads

  if (ocol >= hd) return;  // the last block's missing slab
  const size_t o_base = base - col0 + ocol;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Tq) continue;
    float* dq_row = dq + o_base + (size_t)rows[r] * pos_stride;
#pragma unroll
    for (int n = 0; n < D::kDT; ++n)
      *reinterpret_cast<float2*>(dq_row + 8 * n + 2 * t) = make_float2(
          dqa[n][2 * r] * sm_scale, dqa[n][2 * r + 1] * sm_scale);
  }
}

template <int kS>
struct SlabsDqBf16 {
  static constexpr int kThreads = 128;  // one warpgroup
  static constexpr int kRows = 64;
  static constexpr int kKeys = 32;      // keys per tile
  static constexpr int kStages = kS <= 3 ? 2 : 1;    // key tiles in flight
  static constexpr int kQ = SlabTile::bytes(kRows);  // one slab of q or dO
  static constexpr int kK = SlabTile::bytes(kKeys);  // one slab of K or V
  static constexpr int kStage = 2 * kS * kK;          // K, V (kS slabs)
  // a buffer: each thread's S and dP registers, float4 [kKeys / 4][threads]
  static constexpr int kXFloats = kThreads * kKeys;
  static constexpr int kXOff = 2 * kS * kQ + kStages * kStage;
  static constexpr int kBarOff = kXOff + 2 * kXFloats * 4;
  static constexpr size_t kSmem = kBarOff + 3 * 8 + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// grid (C' * ceil(Tq / 64), nh, B) in clusters of (C', 1, 1);
// SlabsDqBf16<kS>::kThreads threads, kSmem bytes of dynamic shared
// memory; the maps' boxes are 64 rows (q, dO) and 32 rows (k, v); dQ of
// output slab `pass`; the exchange split in two.  Per key tile: the
// warpgroup forms its partial S = Q K^T and dP = dO V^T over the block's
// kS slabs and writes both; after a cluster barrier the block sums its
// share of the cluster's partials, and after a second one reads the sums,
// forms dS = P (dP - D) * scale in registers, rounds it to bf16 and adds
// dS K over the output slab to dQ, K from the staged tile S read
template <int kS>
__global__ void __launch_bounds__(SlabsDqBf16<kS>::kThreads, 1)
flash_bwd_dq_slabs_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const float* __restrict__ key_mask, bf16* __restrict__ dq, int Tq,
    int Tk, int nh, int hd, int causal, float sm_scale, int pass) {
  using D = SlabsDqBf16<kS>;
  constexpr int kKeys = D::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;                     // kS slabs of q
  unsigned char* dos = smem + kS * D::kQ;       // and of dO
  unsigned char* tiles = smem + 2 * kS * D::kQ;  // stage s: K's, V's slabs
  float* x_s = reinterpret_cast<float*>(smem + D::kXOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + D::kBarOff);
  uint64_t* qd_bar = full + 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col0 = (int)cluster.block_rank() * kS * kSlab;
  const int ocol = col0 + pass * kSlab;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qb = blockIdx.x / C, h = blockIdx.y, b = blockIdx.z;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t o_base = (size_t)b * Tq * pos_stride + (size_t)h * hd + ocol;
  const size_t row_base = (size_t)b * Tq * nh + h;
  const int r_blk = qb * D::kRows;          // the block's first row
  const int q_row = r_blk + 16 * warp + g;
  const int rows[2] = {q_row, q_row + 8};   // this thread's rows of dQ
  float l[2] = {INFINITY, INFINITY}, dd[2] = {0.f, 0.f};  // lse * log2 e, D
  bool rok[2] = {false, false};  // a real row with a key to attend
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Tq) continue;
    const float x = lse[row_base + (size_t)rows[r] * nh];
    rok[r] = isfinite(x);
    if (rok[r]) l[r] = x * kLog2e;
    dd[r] = dsum[row_base + (size_t)rows[r] * nh];
  }
  float dqa[kSlab / 2];
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) dqa[i] = 0.f;
  // no row of the block attends a key: zeros (the whole cluster agrees)
  if (!__syncthreads_or(rok[0] || rok[1])) {
    if (ocol < hd)
      store_rows<kSlab>(dq + o_base, pos_stride, rows, Tq, dqa, t);
    return;
  }
  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, r_blk + D::kRows) : Tk;
  const int n_tiles = (t_end + kKeys - 1) / kKeys;
  // thread 0: tile it's K and V (kS slabs each; boxes past hd
  // zero-filled) into its stage
  auto issue = [&](int it) {
    const int s = D::kStages == 2 ? it & 1 : 0;
    unsigned char* ks = tiles + s * D::kStage;
    tma::mbar_arrive_tx(&full[s], D::kStage);
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      wg::load_tile<kSlab>(ks + j * D::kK, &k_map, kKeys, it * kKeys, h, b,
                           &full[s], col0 + j * kSlab);
      wg::load_tile<kSlab>(ks + (kS + j) * D::kK, &v_map, kKeys, it * kKeys,
                           h, b, &full[s], col0 + j * kSlab);
    }
  };
  if (tid == 0) {
    tma::mbar_init(&full[0], 1);
    tma::mbar_init(&full[1], 1);
    tma::mbar_init(qd_bar, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma::mbar_arrive_tx(qd_bar, 2 * kS * D::kQ);
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      wg::load_tile<kSlab>(qs + j * D::kQ, &q_map, D::kRows, r_blk, h, b,
                           qd_bar, col0 + j * kSlab);
      wg::load_tile<kSlab>(dos + j * D::kQ, &do_map, D::kRows, r_blk, h, b,
                           qd_bar, col0 + j * kSlab);
    }
    issue(0);
  }

  const float scale_l2 = sm_scale * kLog2e;
  tma::mbar_wait(qd_bar, 0);
  int ex = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = D::kStages == 2 ? it & 1 : 0;
    // the next tile's stage was freed by the barrier ending tile it - 1
    if constexpr (D::kStages == 2)
      if (tid == 0 && it + 1 < n_tiles) issue(it + 1);
    const int k0 = it * kKeys;
    // bit 2 i + e: key k0 + 8 i + 2 t + e (this thread's columns of S) is
    // real and unmasked
    uint32_t okb = 0;
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        okb |= (uint32_t)key_ok(key_mask, b, Tk, k0 + 8 * i + 2 * t + e)
               << (2 * i + e);
    const bool any = __syncthreads_or(okb != 0);  // the cluster's too
    tma::mbar_wait(&full[s], D::kStages == 2 ? (it >> 1) & 1 : it & 1);
    if (any) {
      const unsigned char* ks = tiles + s * D::kStage;
      const unsigned char* vs = ks + kS * D::kK;
      // causal: every key of the tile follows the block's last row
      const bool active = r_blk < Tq && !(causal && k0 > r_blk + 63);
      float* xb = x_s + (ex & 1) * D::kXFloats;
      auto xi = [&](int i) { return i * D::kThreads + tid; };
      float sa[kKeys / 2], pa[kKeys / 2];  // S, dP; then dS in pa
      if (active) {
        // this block's partial S = Q K^T and dP = dO V^T over its kS
        // slabs, in order
        wg::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kS; ++j)
#pragma unroll
          for (int kk = 0; kk < kSlab / 16; ++kk)
            wg::Mma<kKeys>::ss(
                sa, wg::desc_k<kSlab>(qs + j * D::kQ, D::kRows, 0, kk),
                wg::desc_k<kSlab>(ks + j * D::kK, kKeys, 0, kk),
                j > 0 || kk > 0);
#pragma unroll
        for (int j = 0; j < kS; ++j)
#pragma unroll
          for (int kk = 0; kk < kSlab / 16; ++kk)
            wg::Mma<kKeys>::ss(
                pa, wg::desc_k<kSlab>(dos + j * D::kQ, D::kRows, 0, kk),
                wg::desc_k<kSlab>(vs + j * D::kK, kKeys, 0, kk),
                j > 0 || kk > 0);
        wg::commit();
        wg::wait<0>();
        wg::keep(sa);
        wg::keep(pa);
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i) {
          reinterpret_cast<float4*>(xb)[xi(i)] = f4(sa + 4 * i);
          reinterpret_cast<float4*>(xb)[xi(kKeys / 8 + i)] = f4(pa + 4 * i);
        }
      }
      cluster.sync();  // every block's partials are written
      ++ex;
      share_if<true>(cluster, xb, D::kXFloats / 4, C, D::kThreads, tid);
      if (active) {
        float sum[kKeys / 4][4];
        sum_or_gather<true>(sum, cluster, xb, D::kXFloats / 4, C, xi);
        // P = exp(S * scale - lse), dS = P (dP - D) * scale
        const bool diag = causal && k0 + kKeys - 1 > r_blk;
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = 8 * i + 2 * t + (e & 1);
            const bool ok = rok[r] && ((okb >> (2 * i + (e & 1))) & 1) &&
                            (!diag || k0 + c <= rows[r]);
            const float p = ok ? ex2(fmaf(sum[i][e], scale_l2, -l[r])) : 0.f;
            pa[4 * i + e] = p * (sum[kKeys / 8 + i][e] - dd[r]) * sm_scale;
          }
        }
        uint32_t df[kKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wg::a_frag(df[kk], pa, kk);  // dS rounded to bf16
        const unsigned char* k_out = ks + pass * D::kK;  // the output slab
        wg::wgmma_fence();
        // dQ += dS K over the tile's keys (the output slab)
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wg::Mma<kSlab>::rs(dqa, df[kk],
                             wg::desc_mn<kSlab>(k_out, kKeys, kk, 0), 1);
        wg::commit();
        wg::wait<0>();
        wg::keep(dqa);
        wg::keep(df);
      }
    }
    __syncthreads();  // the stage is free for the next tiles
    if constexpr (D::kStages == 1)
      if (tid == 0 && it + 1 < n_tiles) issue(it + 1);
  }
  cluster.sync();  // no block leaves while a peer reads its partials
  if (ocol >= hd) return;  // the last block's missing slab
  store_rows<kSlab>(dq + o_base, pos_stride, rows, Tq, dqa, t);
}

// ---------------------------------------------------------------------------
// The SIMT forms (every kind above head dim 8192, and at any wide head
// dim behind the _simt entry points).

// shared memory of each kernel, in floats: the chunks share their space
// with the slab the product reads after them
constexpr int kFwdSmem =
    (2 * kChunkTile > kSlabTile ? 2 * kChunkTile : kSlabTile) + kPTile +
    kCols;
constexpr int kDkvSmem =
    (4 * kChunkTile > 2 * kSlabTile ? 4 * kChunkTile : 2 * kSlabTile) +
    2 * kPTile + 3 * kCols;
constexpr int kDqSmem =
    (4 * kChunkTile > kSlabTile ? 4 * kChunkTile : kSlabTile) + kPTile +
    kCols;

// grid (ceil(Tq / 64), nh * hd / 128, B); kThreads threads; kFwdSmem
// floats of dynamic shared memory
template <typename E>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v,
                      const float* __restrict__ key_mask, E* __restrict__ out,
                      float* __restrict__ lse, int Tq, int Tk, int nh, int hd,
                      int causal, float sm_scale) {
  constexpr bool kBf16 = sizeof(E) == 2;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // a chunk of q, then the slab of v
  float* k_s = smem + kChunkTile;  // a chunk of k
  float* v_s = smem;
  float* p_s = smem + (2 * kChunkTile > kSlabTile ? 2 * kChunkTile
                                                  : kSlabTile);
  float* flag_s = p_s + kPTile;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_slab = hd / kSlab;
  const int h = blockIdx.y / n_slab, b = blockIdx.z;
  const int col0 = (blockIdx.y % n_slab) * kSlab;
  const int row0 = blockIdx.x * kRows;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t base = (size_t)b * Tq * pos_stride + (size_t)h * hd;
  const size_t k_base = (size_t)b * Tk * pos_stride + (size_t)h * hd;

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }
  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, row0 + kRows) : Tk;
  for (int k0 = 0; k0 < t_end; k0 += kCols) {
    if (tid < kCols) flag_s[tid] = key_flag(key_mask, b, Tk, k0 + tid);
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();  // the previous chunk (or slab) is read
      stage<kChunk>(q_s, kCS, q + base, pos_stride, row0, Tq, c0, tid);
      stage<kChunk>(k_s, kCS, k + k_base, pos_stride, k0, Tk, c0, tid);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = q_s[(4 * ty + i) * kCS + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = k_s[(tx + 16 * j) * kCS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
      }
    }
    // mask, scale and the online softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * ty + i;
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool ok = flag_s[col] > 0.f && (!causal || k0 + col <= row);
        s[i][j] = ok ? s[i][j] * sm_scale : -INFINITY;
        cmax = fmaxf(cmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(cmax));
      const float alpha = expf(m[i] - m_new);  // 0 on the first real key
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);  // masked: exactly 0
        l[i] += p;
        p_s[(4 * ty + i) * kPS + tx + 16 * j] = kBf16 ? round_bf16(p) : p;
      }
    }
    __syncthreads();  // every warp is done with the chunks
    stage<kSlab>(v_s, kSlab, v + k_base, pos_stride, k0, Tk, col0, tid);
    __syncthreads();
    // O += P V over the slab
#pragma unroll 4
    for (int kk = 0; kk < kCols; ++kk) {
      float a[4], bb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = p_s[(4 * ty + i) * kPS + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = v_s[kk * kSlab + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) o[i][j] = fmaf(a[i], bb[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = row_sum(l[i]);
    const int row = row0 + 4 * ty + i;
    if (row >= Tq) continue;
    E* o_row = out + base + (size_t)row * pos_stride + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st(o_row + tx + 16 * j, li > 0.f ? o[i][j] / li : 0.f);
    if (lse != nullptr && tx == 0 && col0 == 0)  // one block of the slabs
      lse[((size_t)b * Tq + row) * nh + h] =
          li > 0.f ? m[i] + logf(li) : INFINITY;
  }
}

// grid (ceil(Tk / 64), nh * hd / 128, B): a block owns 64 keys; kThreads
// threads; kDkvSmem floats of dynamic shared memory.  lse and dsum are
// [B, Tq, nh] f32.
template <typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const E* __restrict__ q, const E* __restrict__ k,
                          const E* __restrict__ v, const E* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          const float* __restrict__ key_mask,
                          E* __restrict__ dk, E* __restrict__ dv, int Tq,
                          int Tk, int nh, int hd, int causal,
                          float sm_scale) {
  constexpr bool kBf16 = sizeof(E) == 2;
  constexpr int kUnion =
      4 * kChunkTile > 2 * kSlabTile ? 4 * kChunkTile : 2 * kSlabTile;
  extern __shared__ __align__(16) float smem[];
  // the head-dim loop's chunks of k, q, v and dO; then the slabs of dO
  // and q in the same space
  float* k_c = smem;
  float* q_c = k_c + kChunkTile;
  float* v_c = q_c + kChunkTile;
  float* do_c = v_c + kChunkTile;
  float* do_slab = smem;
  float* q_slab = smem + kSlabTile;
  float* pt_s = smem + kUnion;  // P^T: [key][query]
  float* dst_s = pt_s + kPTile;  // dS^T (times scale, rounded, in bf16)
  float* lse_s = dst_s + kPTile;
  float* d_s = lse_s + kCols;
  float* kflag_s = d_s + kCols;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_slab = hd / kSlab;
  const int h = blockIdx.y / n_slab, b = blockIdx.z;
  const int col0 = (blockIdx.y % n_slab) * kSlab;
  const int key0 = blockIdx.x * kRows;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t base = (size_t)b * Tk * pos_stride + (size_t)h * hd;
  const size_t q_base = (size_t)b * Tq * pos_stride + (size_t)h * hd;
  const size_t row_base = (size_t)b * Tq * nh + h;  // of lse and dsum

  if (tid < kRows) kflag_s[tid] = key_flag(key_mask, b, Tk, key0 + tid);
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal (Tq == Tk): query rows before the block's first key attend none
  const int q_begin = causal ? key0 : 0;  // a multiple of kCols
  for (int q0 = q_begin; q0 < Tq; q0 += kCols) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();  // the previous chunks (or slabs) are read
      if (c0 == 0 && tid < kCols) {
        const int row = q0 + tid;
        lse_s[tid] = row < Tq ? lse[row_base + (size_t)row * nh] : INFINITY;
        d_s[tid] = row < Tq ? dsum[row_base + (size_t)row * nh] : 0.f;
      }
      stage<kChunk>(k_c, kCS, k + base, pos_stride, key0, Tk, c0, tid);
      stage<kChunk>(q_c, kCS, q + q_base, pos_stride, q0, Tq, c0, tid);
      stage<kChunk>(v_c, kCS, v + base, pos_stride, key0, Tk, c0, tid);
      stage<kChunk>(do_c, kCS, dout + q_base, pos_stride, q0, Tq, c0, tid);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {
        float ka[4], va[4], qb[4], db[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = k_c[(4 * ty + i) * kCS + c];
          va[i] = v_c[(4 * ty + i) * kCS + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qb[j] = q_c[(tx + 16 * j) * kCS + c];
          db[j] = do_c[(tx + 16 * j) * kCS + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
            dp[i][j] = fmaf(va[i], db[j], dp[i][j]);
          }
      }
    }
    // P^T and dS^T for the tile: rows are keys, columns query rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = 4 * ty + i, key = key0 + kr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j, row = q0 + qc;
        const bool ok = kflag_s[kr] > 0.f && (!causal || key <= row);
        // a row past Tq or with no key to attend has lse +inf: p = 0
        const float p = ok ? expf(s[i][j] * sm_scale - lse_s[qc]) : 0.f;
        const float ds = p * (dp[i][j] - d_s[qc]);
        pt_s[kr * kPS + qc] = kBf16 ? round_bf16(p) : p;
        dst_s[kr * kPS + qc] = kBf16 ? round_bf16(ds * sm_scale) : ds;
      }
    }
    __syncthreads();  // every warp is done with the chunks
    stage<kSlab>(do_slab, kSlab, dout + q_base, pos_stride, q0, Tq, col0,
                 tid);
    stage<kSlab>(q_slab, kSlab, q + q_base, pos_stride, q0, Tq, col0, tid);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the slab
#pragma unroll 2
    for (int qq = 0; qq < kCols; ++qq) {
      float pa[4], sa[4], dob[8], qbv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = pt_s[(4 * ty + i) * kPS + qq];
        sa[i] = dst_s[(4 * ty + i) * kPS + qq];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dob[j] = do_slab[qq * kSlab + tx + 16 * j];
        qbv[j] = q_slab[qq * kSlab + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dv_acc[i][j] = fmaf(pa[i], dob[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sa[i], qbv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + 4 * ty + i;
    if (key >= Tk) continue;
    const size_t off = base + (size_t)key * pos_stride + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // f32: scale once after the sum, as the plain version; bf16: dS
      // already carries it
      st(dk + off + tx + 16 * j,
         kBf16 ? dk_acc[i][j] : dk_acc[i][j] * sm_scale);
      st(dv + off + tx + 16 * j, dv_acc[i][j]);
    }
  }
}

// grid (ceil(Tq / 64), nh * hd / 128, B): a block owns 64 query rows;
// kThreads threads; kDqSmem floats of dynamic shared memory
template <typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         const float* __restrict__ key_mask,
                         E* __restrict__ dq, int Tq, int Tk, int nh, int hd,
                         int causal, float sm_scale) {
  constexpr bool kBf16 = sizeof(E) == 2;
  constexpr int kUnion =
      4 * kChunkTile > kSlabTile ? 4 * kChunkTile : kSlabTile;
  extern __shared__ __align__(16) float smem[];
  // the head-dim loop's chunks of q, k, dO and v; then the slab of k
  float* q_c = smem;
  float* k_c = q_c + kChunkTile;
  float* do_c = k_c + kChunkTile;
  float* v_c = do_c + kChunkTile;
  float* k_slab = smem;
  float* ds_s = smem + kUnion;  // dS: [query][key]
  float* flag_s = ds_s + kPTile;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_slab = hd / kSlab;
  const int h = blockIdx.y / n_slab, b = blockIdx.z;
  const int col0 = (blockIdx.y % n_slab) * kSlab;
  const int row0 = blockIdx.x * kRows;
  const size_t pos_stride = (size_t)nh * hd;
  const size_t base = (size_t)b * Tq * pos_stride + (size_t)h * hd;
  const size_t k_base = (size_t)b * Tk * pos_stride + (size_t)h * hd;
  const size_t row_base = (size_t)b * Tq * nh + h;

  float lse_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    lse_r[i] = row < Tq ? lse[row_base + (size_t)row * nh] : INFINITY;
    d_r[i] = row < Tq ? dsum[row_base + (size_t)row * nh] : 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int t_end = causal ? min(Tk, row0 + kRows) : Tk;
  for (int k0 = 0; k0 < t_end; k0 += kCols) {
    if (tid < kCols) flag_s[tid] = key_flag(key_mask, b, Tk, k0 + tid);
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();  // the previous chunks (or slab) are read
      stage<kChunk>(q_c, kCS, q + base, pos_stride, row0, Tq, c0, tid);
      stage<kChunk>(k_c, kCS, k + k_base, pos_stride, k0, Tk, c0, tid);
      stage<kChunk>(do_c, kCS, dout + base, pos_stride, row0, Tq, c0, tid);
      stage<kChunk>(v_c, kCS, v + k_base, pos_stride, k0, Tk, c0, tid);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {
        float qa[4], da[4], kb[4], vb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = q_c[(4 * ty + i) * kCS + c];
          da[i] = do_c[(4 * ty + i) * kCS + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kb[j] = k_c[(tx + 16 * j) * kCS + c];
          vb[j] = v_c[(tx + 16 * j) * kCS + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
            dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool ok = flag_s[col] > 0.f && (!causal || k0 + col <= row);
        const float p = ok ? expf(s[i][j] * sm_scale - lse_r[i]) : 0.f;
        const float ds = p * (dp[i][j] - d_r[i]);
        ds_s[(4 * ty + i) * kPS + col] =
            kBf16 ? round_bf16(ds * sm_scale) : ds;
      }
    }
    __syncthreads();  // every warp is done with the chunks
    stage<kSlab>(k_slab, kSlab, k + k_base, pos_stride, k0, Tk, col0, tid);
    __syncthreads();
    // dQ += dS K over the slab
#pragma unroll 4
    for (int kk = 0; kk < kCols; ++kk) {
      float a[4], bb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ds_s[(4 * ty + i) * kPS + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = k_slab[kk * kSlab + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= Tq) continue;
    E* d_row = dq + base + (size_t)row * pos_stride + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st(d_row + tx + 16 * j, kBf16 ? acc[i][j] : acc[i][j] * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// Launches.

// the three kernels, as ts_flash_wide_form and
// ts_flash_wide_active_clusters name them
enum Kind { kFwd = 0, kDkv = 1, kDq = 2 };

// the most slabs a block of the multi-slab forms owns: hd 8192
constexpr int kMaxSlabs = 4;

// what every entry point checks: positive sizes within the grid's axes, a
// head dim that is a multiple of the slab, causal only on whole blocks
bool bad_shape(int B, int Tq, int Tk, int nh, int hd, int causal) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || nh <= 0 || hd <= 0 ||
         hd % kSlab != 0 || B > 65535 ||
         (long long)nh * (hd / kSlab) > 65535 || (causal && Tq != Tk);
}

// the slabs a block of the cluster forms owns at head dim hd (1 up to
// 2048), and the cluster's blocks C' = ceil(C / slabs)
int slabs_of(int hd) {
  return (hd / kSlab + kMaxClusterNP - 1) / kMaxClusterNP;
}
int blocks_of(int hd) {
  const int s = slabs_of(hd);
  return (hd / kSlab + s - 1) / s;
}

// does an entry point take its cluster form at this head dim: every kind
// up to 16 blocks of kMaxSlabs slabs (hd 8192); the SIMT form above
bool clustered(int hd) { return hd / kSlab <= kMaxClusterNP * kMaxSlabs; }

// the smallest cluster at which the f32 forward splits its exchange over
// the cluster (share_if); below it every block sums all C partials.  On
// an H100 at 16x400x1xhd the split was 7-14% slower at 9 and 12 blocks,
// within 1.2% either way at 13 and 14, and 5-9% faster at 15 and 16
// (PERF.md)
constexpr int kF32SplitFrom = 15;
// the same for the f32 dQ: at 16x400x1xhd the split was 0.6% slower at 9
// blocks (3.8% causal at 16x100), 3.7% faster at 10 and 6-19% faster at
// 11-16 (PERF.md)
constexpr int kF32DqSplitFrom = 10;

// the SIMT grid: a block per 64 rows of T and per (head, slab)
dim3 grid_of(int B, int T, int nh, int hd) {
  return dim3((T + kRows - 1) / kRows, nh * (hd / kSlab), B);
}

// What a cluster kernel has checked on each device (bit d: device d), at
// first use: its dynamic shared memory allowed, cluster sizes past the
// portable 8 allowed, and per cluster size that one cluster fits
struct ClusterCheck {
  unsigned smem_set = 0;
  unsigned non_portable_set = 0;
  unsigned fits[kMaxClusterNP + 1] = {};
};

unsigned device_bit(cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  return dev < 32 ? 1u << dev : 0u;
}

// *n = how many clusters of C blocks of `kernel` (`threads` threads and
// `smem` bytes of dynamic shared memory a block) can be resident at once
// on the current device (cudaOccupancyMaxActiveClusters), once the
// kernel's shared memory and, past 8 blocks, non-portable cluster sizes
// are allowed (on an H100, 0 from 20 blocks on)
template <typename Kernel>
cudaError_t active_clusters(Kernel kernel, ClusterCheck& chk, int threads,
                            size_t smem, int C, int* n) {
  *n = 0;
  if (C < 1) return cudaErrorInvalidClusterSize;
  cudaError_t err = tf32x3::allow_smem(kernel, smem, chk.smem_set);
  if (err != cudaSuccess) return err;
  const unsigned bit = device_bit(&err);
  if (err != cudaSuccess) return err;
  if (C > kMaxCluster && !(chk.non_portable_set & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    chk.non_portable_set |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// Launch `kernel` over (C * n_blocks, nh, B) blocks of `threads` threads
// in clusters of (C, 1, 1) (hd / 128 blocks, or blocks_of(hd) for the
// multi-slab forms), with `smem` bytes of dynamic shared memory.  At
// first use per device and C: active_clusters, and an error (no launch)
// where not one cluster fits
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), ClusterCheck& chk,
                           int threads, size_t smem, int n_blocks, int B,
                           int nh, int C, void* stream, Args... args) {
  cudaError_t err;
  const unsigned bit = device_bit(&err);
  if (err != cudaSuccess) return err;
  if (!(chk.fits[C] & bit)) {
    int n = 0;
    err = active_clusters(kernel, chk, threads, smem, C, &n);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorLaunchOutOfResources;
    chk.fits[C] |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * n_blocks, nh, B);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

// Each cluster form's kernel for a cluster of C blocks and the checks its
// launches keep: the one-sum instance up to 8 blocks, past them the split
// one (the f32 forward from kF32SplitFrom blocks, the f32 dQ from
// kF32DqSplitFrom; the f32 dK/dV never); the bf16 dQ, split at every
// size, its instance for up to 16 ranks past 8 blocks
auto fwd_f32_kernel(int C, ClusterCheck*& chk) {
  static ClusterCheck one, split;
  chk = C >= kF32SplitFrom ? &split : &one;
  return C >= kF32SplitFrom ? &flash_fwd_cluster_f32_kernel<true>
                            : &flash_fwd_cluster_f32_kernel<false>;
}
auto fwd_bf16_kernel(int C, ClusterCheck*& chk) {
  static ClusterCheck one, wide;
  chk = C > kMaxCluster ? &wide : &one;
  return C > kMaxCluster ? &flash_fwd_cluster_bf16_kernel<true>
                         : &flash_fwd_cluster_bf16_kernel<false>;
}
auto dkv_f32_kernel(int, ClusterCheck*& chk) {
  static ClusterCheck one;
  chk = &one;
  return &flash_bwd_dkv_cluster_f32_kernel;
}
auto dkv_bf16_kernel(int C, ClusterCheck*& chk) {
  static ClusterCheck one, wide;
  chk = C > kMaxCluster ? &wide : &one;
  return C > kMaxCluster ? &flash_bwd_dkv_cluster_bf16_kernel<true>
                         : &flash_bwd_dkv_cluster_bf16_kernel<false>;
}
auto dq_f32_kernel(int C, ClusterCheck*& chk) {
  static ClusterCheck one, split;
  chk = C >= kF32DqSplitFrom ? &split : &one;
  return C >= kF32DqSplitFrom ? &flash_bwd_dq_cluster_f32_kernel<true>
                              : &flash_bwd_dq_cluster_f32_kernel<false>;
}
auto dq_bf16_kernel(int C, ClusterCheck*& chk) {
  static ClusterCheck one, wide;
  chk = C > kMaxCluster ? &wide : &one;
  return C > kMaxCluster
             ? &flash_bwd_dq_cluster_bf16_kernel<kMaxClusterNP>
             : &flash_bwd_dq_cluster_bf16_kernel<kMaxCluster>;
}

// the tensor maps of a bf16 cluster launch: [B, T, nh, hd] tensors for
// tiles of `rows` rows and 128 columns (boxes of 64)
cudaError_t make_maps(CUtensorMap* maps, const void* const* ptrs,
                      const int* lens, const int* rows, int n, int B, int nh,
                      int hd) {
  for (int i = 0; i < n; ++i) {
    const cudaError_t err =
        wg::make_map(&maps[i], ptrs[i], B, lens[i], nh, hd, rows[i]);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int launch_fwd_f32(const void* q, const void* k, const void* v,
                   const float* key_mask, void* out, float* lse, int B,
                   int Tq, int Tk, int nh, int hd, int causal, float sm_scale,
                   void* stream) {
  using S = ClusterFwdF32;
  ClusterCheck* chk;
  const auto kernel = fwd_f32_kernel(hd / kSlab, chk);
  return (int)launch_cluster(
      kernel, *chk, S::kThreads, S::kSmem, (Tq + S::kRows - 1) / S::kRows, B,
      nh, hd / kSlab, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), key_mask,
      static_cast<float*>(out), lse, Tq, Tk, nh, hd, causal, sm_scale);
}

int launch_fwd_bf16(const void* q, const void* k, const void* v,
                    const float* key_mask, void* out, float* lse, int B,
                    int Tq, int Tk, int nh, int hd, int causal,
                    float sm_scale, void* stream) {
  using S = ClusterFwdBf16;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int lens[3] = {Tq, Tk, Tk};
  const int rows[3] = {kBf16Rows, S::kKeys, S::kKeys};
  cudaError_t err = make_maps(maps, ptrs, lens, rows, 3, B, nh, hd);
  if (err != cudaSuccess) return (int)err;
  ClusterCheck* chk;
  const auto kernel = fwd_bf16_kernel(hd / kSlab, chk);
  return (int)launch_cluster(
      kernel, *chk, kBf16Threads, S::kSmem, (Tq + kBf16Rows - 1) / kBf16Rows,
      B, nh, hd / kSlab, stream, maps[0], maps[1], maps[2], key_mask,
      static_cast<bf16*>(out), lse, Tq, Tk, nh, hd, causal, sm_scale);
}

int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dsum,
                   const float* key_mask, void* dk, void* dv, int B, int Tq,
                   int Tk, int nh, int hd, int causal, float sm_scale,
                   void* stream) {
  using D = ClusterDkvF32;
  ClusterCheck* chk;
  const auto kernel = dkv_f32_kernel(hd / kSlab, chk);
  return (int)launch_cluster(
      kernel, *chk, D::kThreads, D::kSmem, (Tk + D::kKeys - 1) / D::kKeys, B,
      nh, hd / kSlab, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dsum, key_mask,
      static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, nh, hd,
      causal, sm_scale);
}

int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* dsum,
                    const float* key_mask, void* dk, void* dv, int B, int Tq,
                    int Tk, int nh, int hd, int causal, float sm_scale,
                    void* stream) {
  using D = ClusterDkvBf16;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  const int lens[4] = {Tq, Tk, Tk, Tq};
  const int rows[4] = {D::kQ, kBf16Rows, kBf16Rows, D::kQ};
  cudaError_t err = make_maps(maps, ptrs, lens, rows, 4, B, nh, hd);
  if (err != cudaSuccess) return (int)err;
  ClusterCheck* chk;
  const auto kernel = dkv_bf16_kernel(hd / kSlab, chk);
  return (int)launch_cluster(
      kernel, *chk, kBf16Threads, D::kSmem, (Tk + kBf16Rows - 1) / kBf16Rows,
      B, nh, hd / kSlab, stream, maps[0], maps[1], maps[2], maps[3], lse, dsum,
      key_mask, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, nh,
      hd, causal, sm_scale);
}

int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* dsum,
                  const float* key_mask, void* dq, int B, int Tq, int Tk,
                  int nh, int hd, int causal, float sm_scale, void* stream) {
  using D = ClusterDqF32;
  ClusterCheck* chk;
  const auto kernel = dq_f32_kernel(hd / kSlab, chk);
  return (int)launch_cluster(
      kernel, *chk, D::kThreads, D::kSmem, (Tq + D::kRows - 1) / D::kRows, B,
      nh, hd / kSlab, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dsum, key_mask,
      static_cast<float*>(dq), Tq, Tk, nh, hd, causal, sm_scale);
}

int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dsum,
                   const float* key_mask, void* dq, int B, int Tq, int Tk,
                   int nh, int hd, int causal, float sm_scale, void* stream) {
  using D = ClusterDqBf16;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  const int lens[4] = {Tq, Tk, Tk, Tq};
  const int rows[4] = {kBf16Rows, D::kKeys, D::kKeys, kBf16Rows};
  cudaError_t err = make_maps(maps, ptrs, lens, rows, 4, B, nh, hd);
  if (err != cudaSuccess) return (int)err;
  ClusterCheck* chk;
  const auto kernel = dq_bf16_kernel(hd / kSlab, chk);
  return (int)launch_cluster(
      kernel, *chk, kBf16Threads, D::kSmem, (Tq + kBf16Rows - 1) / kBf16Rows,
      B, nh, hd / kSlab, stream, maps[0], maps[1], maps[2], maps[3], lse, dsum,
      key_mask, static_cast<bf16*>(dq), Tq, Tk, nh, hd, causal, sm_scale);
}

// The multi-slab forms' kernels for kS slabs a block and a cluster of C
// blocks (9 to 16), and the checks their launches keep: the f32 forward's
// split exchange from kF32SplitFrom blocks and the f32 dQ's from
// kF32DqSplitFrom as their one-slab forms'; the bf16 forms split at every
// such size; the f32 dK/dV never
template <int kS>
auto fwd_f32_slabs_kernel(int C, ClusterCheck*& chk) {
  static ClusterCheck one, split;
  chk = C >= kF32SplitFrom ? &split : &one;
  return C >= kF32SplitFrom ? &flash_fwd_slabs_f32_kernel<kS, true>
                            : &flash_fwd_slabs_f32_kernel<kS, false>;
}
template <int kS>
auto fwd_bf16_slabs_kernel(int, ClusterCheck*& chk) {
  static ClusterCheck one;
  chk = &one;
  return &flash_fwd_slabs_bf16_kernel<kS>;
}
template <int kS>
auto dkv_f32_slabs_kernel(int, ClusterCheck*& chk) {
  static ClusterCheck one;
  chk = &one;
  return &flash_bwd_dkv_slabs_f32_kernel<kS>;
}
template <int kS>
auto dkv_bf16_slabs_kernel(int, ClusterCheck*& chk) {
  static ClusterCheck one;
  chk = &one;
  return &flash_bwd_dkv_slabs_bf16_kernel<kS>;
}
// from 3 slabs a block every cluster has 11 blocks or more: the one-sum
// instance is built at 2 slabs only (at 9 blocks it beat the split one
// by 4-5%, PERF.md)
template <int kS>
auto dq_f32_slabs_kernel(int C, ClusterCheck*& chk) {
  static ClusterCheck one, split;
  if constexpr (kS == 2) {
    if (C < kF32DqSplitFrom) {
      chk = &one;
      return &flash_bwd_dq_slabs_f32_kernel<kS, false>;
    }
  }
  chk = &split;
  return &flash_bwd_dq_slabs_f32_kernel<kS, true>;
}
template <int kS>
auto dq_bf16_slabs_kernel(int, ClusterCheck*& chk) {
  static ClusterCheck one;
  chk = &one;
  return &flash_bwd_dq_slabs_bf16_kernel<kS>;
}

// A multi-slab launch: one per pass (the block's output slab), all with
// the same cluster of blocks_of(hd) blocks
template <int kS, typename Kernel, typename... Args>
int launch_passes(Kernel kernel, ClusterCheck& chk, int threads,
                  size_t smem, int n_blocks, int B, int nh, int hd,
                  void* stream, Args... args) {
  for (int pass = 0; pass < kS; ++pass) {
    const cudaError_t err =
        launch_cluster(kernel, chk, threads, smem, n_blocks, B, nh,
                       blocks_of(hd), stream, args..., pass);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <int kS>
int launch_fwd_f32_slabs(const void* q, const void* k, const void* v,
                         const float* key_mask, void* out, float* lse, int B,
                         int Tq, int Tk, int nh, int hd, int causal,
                         float sm_scale, void* stream) {
  using S = SlabsFwdF32<kS>;
  ClusterCheck* chk;
  const auto kernel = fwd_f32_slabs_kernel<kS>(blocks_of(hd), chk);
  return launch_passes<kS>(
      kernel, *chk, S::kThreads, S::kSmem, (Tq + S::kRows - 1) / S::kRows, B,
      nh, hd, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), key_mask,
      static_cast<float*>(out), lse, Tq, Tk, nh, hd, causal, sm_scale);
}

template <int kS>
int launch_fwd_bf16_slabs(const void* q, const void* k, const void* v,
                          const float* key_mask, void* out, float* lse,
                          int B, int Tq, int Tk, int nh, int hd, int causal,
                          float sm_scale, void* stream) {
  using S = SlabsFwdBf16<kS>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int lens[3] = {Tq, Tk, Tk};
  const int rows[3] = {S::kRows, S::kKeys, S::kKeys};
  cudaError_t err = make_maps(maps, ptrs, lens, rows, 3, B, nh, hd);
  if (err != cudaSuccess) return (int)err;
  ClusterCheck* chk;
  const auto kernel = fwd_bf16_slabs_kernel<kS>(blocks_of(hd), chk);
  return launch_passes<kS>(
      kernel, *chk, S::kThreads, S::kSmem, (Tq + S::kRows - 1) / S::kRows, B,
      nh, hd, stream, maps[0], maps[1], maps[2], key_mask,
      static_cast<bf16*>(out), lse, Tq, Tk, nh, hd, causal, sm_scale);
}

template <int kS>
int launch_dkv_f32_slabs(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* dsum, const float* key_mask, void* dk,
                         void* dv, int B, int Tq, int Tk, int nh, int hd,
                         int causal, float sm_scale, void* stream) {
  using D = SlabsDkvF32<kS>;
  ClusterCheck* chk;
  const auto kernel = dkv_f32_slabs_kernel<kS>(blocks_of(hd), chk);
  return launch_passes<kS>(
      kernel, *chk, D::kThreads, D::kSmem, (Tk + D::kKeys - 1) / D::kKeys, B,
      nh, hd, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dsum, key_mask,
      static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, nh, hd,
      causal, sm_scale);
}

template <int kS>
int launch_dkv_bf16_slabs(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* dsum, const float* key_mask, void* dk,
                          void* dv, int B, int Tq, int Tk, int nh, int hd,
                          int causal, float sm_scale, void* stream) {
  using D = SlabsDkvBf16<kS>;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  const int lens[4] = {Tq, Tk, Tk, Tq};
  const int rows[4] = {D::kQ, D::kKeys, D::kKeys, D::kQ};
  cudaError_t err = make_maps(maps, ptrs, lens, rows, 4, B, nh, hd);
  if (err != cudaSuccess) return (int)err;
  ClusterCheck* chk;
  const auto kernel = dkv_bf16_slabs_kernel<kS>(blocks_of(hd), chk);
  return launch_passes<kS>(
      kernel, *chk, D::kThreads, D::kSmem, (Tk + D::kKeys - 1) / D::kKeys, B,
      nh, hd, stream, maps[0], maps[1], maps[2], maps[3], lse, dsum,
      key_mask, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, nh,
      hd, causal, sm_scale);
}

template <int kS>
int launch_dq_f32_slabs(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* dsum,
                        const float* key_mask, void* dq, int B, int Tq,
                        int Tk, int nh, int hd, int causal, float sm_scale,
                        void* stream) {
  using D = SlabsDqF32<kS>;
  ClusterCheck* chk;
  const auto kernel = dq_f32_slabs_kernel<kS>(blocks_of(hd), chk);
  return launch_passes<kS>(
      kernel, *chk, D::kThreads, D::kSmem, (Tq + D::kRows - 1) / D::kRows, B,
      nh, hd, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dsum, key_mask,
      static_cast<float*>(dq), Tq, Tk, nh, hd, causal, sm_scale);
}

template <int kS>
int launch_dq_bf16_slabs(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* dsum, const float* key_mask, void* dq,
                         int B, int Tq, int Tk, int nh, int hd, int causal,
                         float sm_scale, void* stream) {
  using D = SlabsDqBf16<kS>;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  const int lens[4] = {Tq, Tk, Tk, Tq};
  const int rows[4] = {D::kRows, D::kKeys, D::kKeys, D::kRows};
  cudaError_t err = make_maps(maps, ptrs, lens, rows, 4, B, nh, hd);
  if (err != cudaSuccess) return (int)err;
  ClusterCheck* chk;
  const auto kernel = dq_bf16_slabs_kernel<kS>(blocks_of(hd), chk);
  return launch_passes<kS>(
      kernel, *chk, D::kThreads, D::kSmem, (Tq + D::kRows - 1) / D::kRows, B,
      nh, hd, stream, maps[0], maps[1], maps[2], maps[3], lse, dsum,
      key_mask, static_cast<bf16*>(dq), Tq, Tk, nh, hd, causal, sm_scale);
}

// The cluster form of the forward (dK/dV, dQ) at head dim hd: the
// one-slab form up to 2048, else the instance of slabs_of(hd) slabs a
// block
int launch_fwd_cluster(bool bf16, const void* q, const void* k,
                       const void* v, const float* key_mask, void* out,
                       float* lse, int B, int Tq, int Tk, int nh, int hd,
                       int causal, float sm_scale, void* stream) {
  decltype(&launch_fwd_f32) fn;
  switch (slabs_of(hd)) {
    case 1:
      fn = bf16 ? launch_fwd_bf16 : launch_fwd_f32;
      break;
    case 2:
      fn = bf16 ? &launch_fwd_bf16_slabs<2> : &launch_fwd_f32_slabs<2>;
      break;
    case 3:
      fn = bf16 ? &launch_fwd_bf16_slabs<3> : &launch_fwd_f32_slabs<3>;
      break;
    default:
      fn = bf16 ? &launch_fwd_bf16_slabs<4> : &launch_fwd_f32_slabs<4>;
  }
  return fn(q, k, v, key_mask, out, lse, B, Tq, Tk, nh, hd, causal, sm_scale,
            stream);
}

int launch_dkv_cluster(bool bf16, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* dsum, const float* key_mask, void* dk,
                       void* dv, int B, int Tq, int Tk, int nh, int hd,
                       int causal, float sm_scale, void* stream) {
  decltype(&launch_dkv_f32) fn;
  switch (slabs_of(hd)) {
    case 1:
      fn = bf16 ? launch_dkv_bf16 : launch_dkv_f32;
      break;
    case 2:
      fn = bf16 ? &launch_dkv_bf16_slabs<2> : &launch_dkv_f32_slabs<2>;
      break;
    case 3:
      fn = bf16 ? &launch_dkv_bf16_slabs<3> : &launch_dkv_f32_slabs<3>;
      break;
    default:
      fn = bf16 ? &launch_dkv_bf16_slabs<4> : &launch_dkv_f32_slabs<4>;
  }
  return fn(q, k, v, dout, lse, dsum, key_mask, dk, dv, B, Tq, Tk, nh, hd,
            causal, sm_scale, stream);
}

int launch_dq_cluster(bool bf16, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse,
                      const float* dsum, const float* key_mask, void* dq,
                      int B, int Tq, int Tk, int nh, int hd, int causal,
                      float sm_scale, void* stream) {
  decltype(&launch_dq_f32) fn;
  switch (slabs_of(hd)) {
    case 1:
      fn = bf16 ? launch_dq_bf16 : launch_dq_f32;
      break;
    case 2:
      fn = bf16 ? &launch_dq_bf16_slabs<2> : &launch_dq_f32_slabs<2>;
      break;
    case 3:
      fn = bf16 ? &launch_dq_bf16_slabs<3> : &launch_dq_f32_slabs<3>;
      break;
    default:
      fn = bf16 ? &launch_dq_bf16_slabs<4> : &launch_dq_f32_slabs<4>;
  }
  return fn(q, k, v, dout, lse, dsum, key_mask, dq, B, Tq, Tk, nh, hd, causal,
            sm_scale, stream);
}

// the clusters of C blocks of `pick`'s kernel resident at once, or a
// negative cudaError_t
template <typename Pick>
int active_of(Pick pick, int threads, size_t smem, int C) {
  ClusterCheck* chk;
  const auto kernel = pick(C, chk);
  int n = 0;
  const cudaError_t err = active_clusters(kernel, *chk, threads, smem, C, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// `simt`: the SIMT form at any head dim (the parent design, for timing
// the cluster form against it)
template <typename E>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* key_mask, void* out, float* lse, int B, int Tq,
               int Tk, int nh, int hd, int causal, float sm_scale,
               void* stream, bool simt = false) {
  if (bad_shape(B, Tq, Tk, nh, hd, causal)) return (int)cudaErrorInvalidValue;
  if (clustered(hd) && !simt)
    return launch_fwd_cluster(sizeof(E) == 2, q, k, v, key_mask, out, lse, B,
                              Tq, Tk, nh, hd, causal, sm_scale, stream);
  static unsigned smem_set = 0;  // per instantiation and device
  cudaError_t err = tf32x3::allow_smem(flash_fwd_wide_kernel<E>,
                                       kFwdSmem * sizeof(float), smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wide_kernel<E><<<grid_of(B, Tq, nh, hd), kThreads,
                             kFwdSmem * sizeof(float),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), key_mask, static_cast<E*>(out), lse, Tq, Tk,
      nh, hd, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, const float* key_mask,
               void* dk, void* dv, int B, int Tq, int Tk, int nh, int hd,
               int causal, float sm_scale, void* stream, bool simt = false) {
  if (bad_shape(B, Tq, Tk, nh, hd, causal)) return (int)cudaErrorInvalidValue;
  if (clustered(hd) && !simt)
    return launch_dkv_cluster(sizeof(E) == 2, q, k, v, dout, lse, dsum,
                              key_mask, dk, dv, B, Tq, Tk, nh, hd, causal,
                              sm_scale, stream);
  static unsigned smem_set = 0;
  cudaError_t err = tf32x3::allow_smem(flash_bwd_dkv_wide_kernel<E>,
                                       kDkvSmem * sizeof(float), smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_wide_kernel<E><<<grid_of(B, Tk, nh, hd), kThreads,
                                 kDkvSmem * sizeof(float),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout), lse, dsum,
      key_mask, static_cast<E*>(dk), static_cast<E*>(dv), Tq, Tk, nh, hd,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, const float* key_mask,
              void* dq, int B, int Tq, int Tk, int nh, int hd, int causal,
              float sm_scale, void* stream, bool simt = false) {
  if (bad_shape(B, Tq, Tk, nh, hd, causal)) return (int)cudaErrorInvalidValue;
  if (clustered(hd) && !simt)
    return launch_dq_cluster(sizeof(E) == 2, q, k, v, dout, lse, dsum,
                             key_mask, dq, B, Tq, Tk, nh, hd, causal,
                             sm_scale, stream);
  static unsigned smem_set = 0;
  cudaError_t err = tf32x3::allow_smem(flash_bwd_dq_wide_kernel<E>,
                                       kDqSmem * sizeof(float), smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_wide_kernel<E><<<grid_of(B, Tq, nh, hd), kThreads,
                                kDqSmem * sizeof(float),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout), lse, dsum,
      key_mask, static_cast<E*>(dq), Tq, Tk, nh, hd, causal, sm_scale);
  return (int)cudaGetLastError();
}
}  // namespace

// q, out [B, Tq, nh, hd] and k, v [B, Tk, nh, hd] float32 (bfloat16 for
// the _bf16 forms), contiguous, on one device, hd a multiple of 128;
// key_mask [B, Tk] float32 (1 = real token) or null (every key real); lse
// [B, Tq, nh] float32 or null (not written); causal needs Tq == Tk.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int ts_flash_wide(const void* q, const void* k, const void* v,
                             const float* key_mask, void* out, float* lse,
                             int B, int Tq, int Tk, int nh, int hd,
                             int causal, float sm_scale, void* stream) {
  return launch_fwd<float>(q, k, v, key_mask, out, lse, B, Tq, Tk, nh, hd,
                           causal, sm_scale, stream);
}

extern "C" int ts_flash_wide_bf16(const void* q, const void* k,
                                  const void* v, const float* key_mask,
                                  void* out, float* lse, int B, int Tq,
                                  int Tk, int nh, int hd, int causal,
                                  float sm_scale, void* stream) {
  return launch_fwd<bf16>(q, k, v, key_mask, out, lse, B, Tq, Tk, nh, hd,
                          causal, sm_scale, stream);
}

// q, dout [B, Tq, nh, hd], k, v, dk, dv [B, Tk, nh, hd] as above; lse (the
// forward's) and dsum (rowsum(dO * O)) [B, Tq, nh] float32
extern "C" int ts_flash_wide_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* dsum,
                                     const float* key_mask, void* dk,
                                     void* dv, int B, int Tq, int Tk, int nh,
                                     int hd, int causal, float sm_scale,
                                     void* stream) {
  return launch_dkv<float>(q, k, v, dout, lse, dsum, key_mask, dk, dv, B, Tq,
                           Tk, nh, hd, causal, sm_scale, stream);
}

extern "C" int ts_flash_wide_bwd_dkv_bf16(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const float* lse, const float* dsum,
                                          const float* key_mask, void* dk,
                                          void* dv, int B, int Tq, int Tk,
                                          int nh, int hd, int causal,
                                          float sm_scale, void* stream) {
  return launch_dkv<bf16>(q, k, v, dout, lse, dsum, key_mask, dk, dv, B, Tq,
                          Tk, nh, hd, causal, sm_scale, stream);
}

// as ts_flash_wide_bwd_dkv; writes dq [B, Tq, nh, hd]
extern "C" int ts_flash_wide_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* dsum,
                                    const float* key_mask, void* dq, int B,
                                    int Tq, int Tk, int nh, int hd,
                                    int causal, float sm_scale,
                                    void* stream) {
  return launch_dq<float>(q, k, v, dout, lse, dsum, key_mask, dq, B, Tq, Tk,
                          nh, hd, causal, sm_scale, stream);
}

extern "C" int ts_flash_wide_bwd_dq_bf16(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const float* lse, const float* dsum,
                                         const float* key_mask, void* dq,
                                         int B, int Tq, int Tk, int nh,
                                         int hd, int causal, float sm_scale,
                                         void* stream) {
  return launch_dq<bf16>(q, k, v, dout, lse, dsum, key_mask, dq, B, Tq, Tk,
                         nh, hd, causal, sm_scale, stream);
}

// The SIMT forward, dK/dV and dQ at every wide head dim, with the
// signatures of ts_flash_wide(_bf16), ts_flash_wide_bwd_dkv(_bf16) and
// ts_flash_wide_bwd_dq(_bf16): the design the cluster forms replaced up
// to head dim 8192, timed beside them (chip_smoke.py phase_flash_wide);
// no path of the port calls them
extern "C" int ts_flash_wide_simt(const void* q, const void* k,
                                  const void* v, const float* key_mask,
                                  void* out, float* lse, int B, int Tq,
                                  int Tk, int nh, int hd, int causal,
                                  float sm_scale, void* stream) {
  return launch_fwd<float>(q, k, v, key_mask, out, lse, B, Tq, Tk, nh, hd,
                           causal, sm_scale, stream, true);
}

extern "C" int ts_flash_wide_simt_bf16(const void* q, const void* k,
                                       const void* v, const float* key_mask,
                                       void* out, float* lse, int B, int Tq,
                                       int Tk, int nh, int hd, int causal,
                                       float sm_scale, void* stream) {
  return launch_fwd<bf16>(q, k, v, key_mask, out, lse, B, Tq, Tk, nh, hd,
                          causal, sm_scale, stream, true);
}

extern "C" int ts_flash_wide_bwd_dkv_simt(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, const float* key_mask, void* dk,
    void* dv, int B, int Tq, int Tk, int nh, int hd, int causal,
    float sm_scale, void* stream) {
  return launch_dkv<float>(q, k, v, dout, lse, dsum, key_mask, dk, dv, B, Tq,
                           Tk, nh, hd, causal, sm_scale, stream, true);
}

extern "C" int ts_flash_wide_bwd_dkv_simt_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, const float* key_mask, void* dk,
    void* dv, int B, int Tq, int Tk, int nh, int hd, int causal,
    float sm_scale, void* stream) {
  return launch_dkv<bf16>(q, k, v, dout, lse, dsum, key_mask, dk, dv, B, Tq,
                          Tk, nh, hd, causal, sm_scale, stream, true);
}

extern "C" int ts_flash_wide_bwd_dq_simt(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, const float* key_mask, void* dq,
    int B, int Tq, int Tk, int nh, int hd, int causal, float sm_scale,
    void* stream) {
  return launch_dq<float>(q, k, v, dout, lse, dsum, key_mask, dq, B, Tq, Tk,
                          nh, hd, causal, sm_scale, stream, true);
}

extern "C" int ts_flash_wide_bwd_dq_simt_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, const float* key_mask, void* dq,
    int B, int Tq, int Tk, int nh, int hd, int causal, float sm_scale,
    void* stream) {
  return launch_dq<bf16>(q, k, v, dout, lse, dsum, key_mask, dq, B, Tq, Tk,
                         nh, hd, causal, sm_scale, stream, true);
}

// The form the entry point of `kind` (0 the forward, 1 dK/dV, 2 dQ) takes
// at head dim hd without simt: 1 a cluster form (one slab a block or
// several), 0 the SIMT form; -1 where no wide kernel takes hd.  Where
// `slabs` and `blocks` are not null, the form's geometry: the slabs a
// block owns (the kernel launches a call makes, one per slab: 1 up to
// 2048) and the blocks of its cluster; 0 and 0 for the SIMT form (one
// launch) and where no wide kernel takes hd
extern "C" int ts_flash_wide_form(int kind, int hd, int* slabs,
                                  int* blocks) {
  const int form = kind < kFwd || kind > kDq || hd <= 0 || hd % kSlab != 0
                       ? -1
                       : clustered(hd) ? 1 : 0;
  if (slabs) *slabs = form == 1 ? slabs_of(hd) : 0;
  if (blocks) *blocks = form == 1 ? blocks_of(hd) : 0;
  return form;
}

// How many clusters of C blocks of the cluster form of `kind` (as
// ts_flash_wide_form; its _bf16 entry where bf16 is nonzero) can be
// resident at once on the current device: cudaOccupancyMaxActiveClusters
// at the form's threads and shared memory, the check its launches make at
// first use (a launch where this is below 1 returns an error); a negative
// cudaError_t where the query fails.  C need not be one a launch takes
extern "C" int ts_flash_wide_active_clusters(int kind, int bf16, int C) {
  if (kind < kFwd || kind > kDq) return -(int)cudaErrorInvalidValue;
  switch (kind * 2 + (bf16 != 0)) {
    case 0:
      return active_of(fwd_f32_kernel, ClusterFwdF32::kThreads,
                       ClusterFwdF32::kSmem, C);
    case 1:
      return active_of(fwd_bf16_kernel, kBf16Threads, ClusterFwdBf16::kSmem,
                       C);
    case 2:
      return active_of(dkv_f32_kernel, ClusterDkvF32::kThreads,
                       ClusterDkvF32::kSmem, C);
    case 3:
      return active_of(dkv_bf16_kernel, kBf16Threads, ClusterDkvBf16::kSmem,
                       C);
    case 4:
      return active_of(dq_f32_kernel, ClusterDqF32::kThreads,
                       ClusterDqF32::kSmem, C);
    default:
      return active_of(dq_bf16_kernel, kBf16Threads, ClusterDqBf16::kSmem, C);
  }
}

// The clusters of C blocks of the multi-slab form of `kind` with kS
// slabs a block resident at once, as active_of
template <int kS>
int active_slabs(int kind, bool bf16, int C) {
  if (kind == kFwd)
    return bf16 ? active_of(fwd_bf16_slabs_kernel<kS>,
                            SlabsFwdBf16<kS>::kThreads,
                            SlabsFwdBf16<kS>::kSmem, C)
                : active_of(fwd_f32_slabs_kernel<kS>,
                            SlabsFwdF32<kS>::kThreads,
                            SlabsFwdF32<kS>::kSmem, C);
  if (kind == kDkv)
    return bf16 ? active_of(dkv_bf16_slabs_kernel<kS>,
                            SlabsDkvBf16<kS>::kThreads,
                            SlabsDkvBf16<kS>::kSmem, C)
                : active_of(dkv_f32_slabs_kernel<kS>,
                            SlabsDkvF32<kS>::kThreads,
                            SlabsDkvF32<kS>::kSmem, C);
  return bf16 ? active_of(dq_bf16_slabs_kernel<kS>,
                          SlabsDqBf16<kS>::kThreads,
                          SlabsDqBf16<kS>::kSmem, C)
              : active_of(dq_f32_slabs_kernel<kS>, SlabsDqF32<kS>::kThreads,
                          SlabsDqF32<kS>::kSmem, C);
}

// As ts_flash_wide_active_clusters for the cluster form a launch of
// `kind` takes at head dim hd: its instance (one slab a block, or
// slabs_of(hd)) at its cluster size (hd / 128, or blocks_of(hd)); a
// negative cudaError_t where hd has no cluster form
extern "C" int ts_flash_wide_active_clusters_at(int kind, int bf16, int hd) {
  if (ts_flash_wide_form(kind, hd, nullptr, nullptr) != 1)
    return -(int)cudaErrorInvalidValue;
  const int C = blocks_of(hd);
  switch (slabs_of(hd)) {
    case 1:
      return ts_flash_wide_active_clusters(kind, bf16, C);
    case 2:
      return active_slabs<2>(kind, bf16 != 0, C);
    case 3:
      return active_slabs<3>(kind, bf16 != 0, C);
    default:
      return active_slabs<4>(kind, bf16 != 0, C);
  }
}

extern "C" const char* ts_flash_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
