// Flash self-attention backward for Hopper: the dK/dV kernel and the dQ
// kernel, each in an f32 form (3xTF32) and a bf16 form (bf16 mma.sync with
// f32 sums, after the f32 forms below) for the transformer under
// compute_dtype=bfloat16.
//
// Replaces the two backward Pallas kernels of the library flash attention
// the JAX package's transformer differentiates through in training
// (`flash_attention` of jax.experimental.pallas.ops.tpu, called at
// textsummarization_on_flink_tpu/models/transformer.py:285; its
// custom_vjp is flash_attention.py:254-318 of the installed jax):
// `_flash_attention_bwd_dkv` (:941, `pl.pallas_call` :1121) and
// `_flash_attention_bwd_dq` (:1287, `pl.pallas_call` :1456).  Per article
// b and head h (q, k, v, dout, dq, dk, dv are [B, T, nh, hd], contiguous;
// lse and dsum are [B, T, nh]), with
//
//   P_ij  = exp(s_ij - lse_i),  s_ij = (q_i . k_j) * sm_scale,
//           on the keys j row i may attend (key_mask[b, j] > 0, or every
//           key when key_mask is null, and j <= i when causal), else 0;
//           0 on a whole row with no key to attend (lse_i = +inf)
//   D_i   = dout_i . out_i   (dsum, computed by the caller, as the
//           library computes it outside its kernels)
//
//   dv_j = sum_i P_ij dout_i
//   dS_ij = P_ij (dout_i . v_j - D_i)
//   dk_j = sm_scale * sum_i dS_ij q_i
//   dq_i = sm_scale * sum_j dS_ij k_j
//
// The split follows the library: the dK/dV kernel takes one block per
// (key tile, head, article) and loops over query tiles; the dQ kernel
// takes one block per (query tile, head, article) and loops over key
// tiles.  Each block owns its outputs, so there are no atomics and a
// run's gradients are the same every time.  The scores are recomputed
// from q, k and the saved lse: the [T, T] matrices never reach device
// memory.
//
// What bounds it on an H100: operations.  Per (row, head, attended key)
// the function needs 10 * hd operations (the products s and dout . v and
// the dv, dk and dq updates; the two kernels do 14 * hd, since both
// recompute s and dout . v), 6.6 GFLOP at the encoder's shape
// (16 x 400 x 8 x hd 32, all keys): 40 us at 165 TFLOP/s (the TF32
// tensor-core rate over the three products of 3xTF32), against 52 MB of
// q, k, v, out, dout and the three gradients (16 us at 3.35 TB/s).
//
// Both kernels run their products on the tensor cores, f32-accurate in
// 3xTF32 (mma_tf32x3.cuh), as m16n8k8 products on tiles staged by
// cp.async, double-buffered, rows padded by 4 floats so the fragment
// loads are free of bank conflicts.  P and dS feed the next product from
// their accumulator registers in a permuted order (a_from_acc /
// load_b_perm), with no shuffle.
//
// The dK/dV kernel:
//
//   * a block owns 64 keys, 16 per warp; their K and V rows are staged in
//     shared memory once (hi/lo split at use: at hd 128 K, V and the two
//     accumulators would not fit in registers together), and the block
//     loops over tiles of queries (32 rows at hd 32, 16 at hd 128) whose
//     q, dout, lse and D are staged and split once per block;
//   * per tile a warp forms S^T = K Q^T, P^T = exp(S^T * scale - lse),
//     dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D) and dK += dS^T Q;
//     dK is scaled by sm_scale at the end;
//   * causal: a warp skips a tile all of whose rows precede its first key.
//
// The dQ kernel, the forward (flash_attention.cu) with one more product:
//
//   * a block owns 64 query rows, 16 per warp, and loops over tiles of
//     keys (64 at hd 32, 32 at hd 128) whose K, V and key flags are staged
//     and split once per block; q and dO stay in registers, split once, at
//     hd 32, and are staged in shared memory and split at use at hd 128;
//   * per chunk of 16 keys a warp forms S = Q K^T,
//     P = exp(S * scale - lse), dP = dO V^T, dS = P (dP - D) and
//     dQ += dS K, K taking V's place in the forward's P V; dQ is scaled
//     by sm_scale at the end;
//   * causal: tiles past the block's last row are not loaded, a warp
//     stops at the chunk past its last row, the diagonal test runs only
//     on chunks that cross it, and the blocks with the most tiles start
//     first; a tile none of whose keys is real and unmasked is skipped.
//
// Head dim 256: each kernel splits its output's columns over two blocks
// (the grid's y axis holds head x half).  A block forms S and dP over the
// full head dim, from q, K, V and dO tiles staged at the full 256, and
// keeps and writes only its 128 columns of dK and dV, or of dQ: its
// registers are hd 128's, at the cost of forming S and dP twice.  Its
// tiles are narrower to fit one block's shared memory (8 query rows per
// dK/dV tile, 183,296 bytes; 8 keys per dQ tile and warp pass, 183,104
// bytes).
//
// Both kernels:
//
//   * a pair the row may not attend gets p = 0 explicitly, never
//     exp(s - lse) with a sentinel, so a row with no key to attend (an
//     empty article) gives exact zeros in dq and nothing to dk or dv; a
//     block none of whose rows (dQ) or keys (dK/dV) may attend anything
//     writes zeros and stops;
//   * every chain of tensor-core sums is short (a 16-wide slice of the
//     head dim, or at most 32 keys or queries) in a fresh accumulator,
//     added to the long-lived sum by round-to-nearest f32 adds (mma3);
//   * causal: the dK/dV kernel starts at its first key's row (earlier
//     query rows attend none of its keys); the dQ kernel stops at the key
//     tile past its last query row, as the forward does.
//
// Softmax terms use expf (no fast math), so the result differs from the
// plain version by the order of sums and about one f32 rounding per
// product.  wgmma and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry points (two per
// dtype) bound with
// ctypes from ops/flash_attention.py.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using tf32x3::FragA;

constexpr int kThreads = 128;

// The head dims the kernels are built for; above 128 a block keeps half
// of its output's columns (kSplit blocks per tile and head)
template <int HD>
struct Split {
  static_assert(HD == 32 || HD == 128 || HD == 256, "built head dims");
  static constexpr int kSplit = HD > 128 ? 2 : 1;
  static constexpr int kOD = HD / kSplit;  // output columns a block keeps
};

// The dK/dV kernel's tiling: a block owns 64 keys, 16 per warp, and loops
// over tiles of kQ query rows staged in shared memory.
template <int HD>
struct Dkv : Split<HD> {
  static constexpr int kKeys = 64;  // keys per block
  // query rows per tile: 32 at hd 32, 16 at 128, 8 at 256 (16 would need
  // 233,472 bytes of shared memory, past one block's 232,448)
  static constexpr int kQ = HD <= 64 ? 32 : HD <= 128 ? 16 : 8;
  static constexpr int kStride = HD + 4;  // floats per shared row
  static constexpr int kKS = HD / 8;      // k-steps over the head dim
  static constexpr int kNT = kQ / 8;      // 8-query column tiles of S^T
  static constexpr int kDT = Split<HD>::kOD / 8;  // 8-wide tiles of dK, dV
  static constexpr int kKV = 2 * kKeys * kStride;  // the block's K and V
  static constexpr int kTile = kQ * kStride;       // floats of a q/dO tile
  // q, dO (hi after the split), then lse, D and a row flag (+ kQ floats
  // of padding)
  static constexpr int kStage = 2 * kTile + 4 * kQ;
  // K, V, two stages, then the lo parts of the current q and dO tiles
  static constexpr size_t kSmem =
      (kKV + 2 * kStage + 2 * kTile) * sizeof(float);
  static_assert(kKV % 4 == 0 && kStage % 4 == 0, "16-byte aligned tiles");
};

// grid (ceil(T / 64), nh * kSplit, B): one block per (64 keys, head and
// column half, article); Dkv<HD>::kSmem bytes of dynamic shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     const float* __restrict__ key_mask,
                     float* __restrict__ dk, float* __restrict__ dv, int T,
                     int nh, int causal, float sm_scale) {
  using D = Dkv<HD>;
  constexpr int kQ = D::kQ, kStride = D::kStride;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [64][kStride]
  float* vs = smem + D::kKeys * kStride;     // [64][kStride]
  float* stages = smem + D::kKV;             // two query-tile buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x, h = blockIdx.y / D::kSplit, b = blockIdx.z;
  // the first column of dK and dV this block keeps
  const int col0 = (blockIdx.y % D::kSplit) * D::kOD;
  const size_t pos_stride = (size_t)nh * HD;  // floats between positions
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * HD;
  const size_t row_base = (size_t)b * T * nh + h;  // lse/dsum of (b, 0, h)
  const int key0 = kb * D::kKeys + warp * 16;      // the warp's first key
  const int keys[2] = {key0 + g, key0 + g + 8};   // this lane's two keys
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kok[r] = keys[r] < T && (key_mask == nullptr ||
                             key_mask[(size_t)b * T + keys[r]] > 0.f);

  float dka[D::kDT][4], dva[D::kDT][4];
#pragma unroll
  for (int n = 0; n < D::kDT; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  // no key of the block is attended: zeros, without reading anything
  const bool any = __syncthreads_or(kok[0] || kok[1]);
  // causal: a row before the block's first key attends none of its keys
  const int q_begin = causal ? kb * D::kKeys : 0;  // block-uniform
  const int n_tiles = any ? (T - q_begin + kQ - 1) / kQ : 0;

  auto stage = [&](int tile, int buf) {
    float* qs = stages + buf * D::kStage;
    float* dos = qs + D::kTile;
    float* lse_s = dos + D::kTile;
    float* d_s = lse_s + kQ;
    float* rok_s = d_s + kQ;
    const int q0 = q_begin + tile * kQ;
    tf32x3::stage_rows<HD, kThreads>(qs, kStride, q + base, pos_stride, q0,
                                     kQ, T, tid);
    tf32x3::stage_rows<HD, kThreads>(dos, kStride, dout + base, pos_stride,
                                     q0, kQ, T, tid);
    for (int i = tid; i < kQ; i += kThreads) {
      const int row = q0 + i;
      float l = 0.f, d = 0.f;
      bool ok = false;
      if (row < T) {
        l = lse[row_base + (size_t)row * nh];
        d = dsum[row_base + (size_t)row * nh];
        ok = isfinite(l);
      }
      lse_s[i] = ok ? l : 0.f;
      d_s[i] = d;
      rok_s[i] = ok ? 1.f : 0.f;  // a real row with a key to attend
    }
    tf32x3::cp_async_commit();
  };

  if (n_tiles > 0) {
    tf32x3::stage_rows<HD, kThreads>(ks, kStride, k + base, pos_stride,
                                     kb * D::kKeys, D::kKeys, T, tid);
    tf32x3::stage_rows<HD, kThreads>(vs, kStride, v + base, pos_stride,
                                     kb * D::kKeys, D::kKeys, T, tid);
    stage(0, 0);  // one group: K, V and the first query tile
  }
  // the warp's 16 keys of K and V as A fragments, split at use
  const float* kw = ks + warp * 16 * kStride;
  const float* vw = vs + warp * 16 * kStride;
  auto k_frag = [&](int kk) {
    return tf32x3::load_a(kw + 8 * kk, kStride, g, t);
  };
  auto v_frag = [&](int kk) {
    return tf32x3::load_a(vw + 8 * kk, kStride, g, t);
  };
  float* q_lo = stages + 2 * D::kStage;  // lo parts of the current tile
  float* do_lo = q_lo + D::kTile;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1, (it + 1) & 1);  // its buffer was freed at it - 1's end
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    float* qs = stages + (it & 1) * D::kStage;
    float* dos = qs + D::kTile;
    // each thread splits the chunks it copied; then the whole tile is
    // split and has landed for every warp (K and V with the first tile)
    tf32x3::split_tile<HD, kThreads>(qs, q_lo, kStride, kQ, tid);
    tf32x3::split_tile<HD, kThreads>(dos, do_lo, kStride, kQ, tid);
    __syncthreads();

    const int q0 = q_begin + it * kQ;
    // causal: every row of the tile precedes the warp's first key
    if (!causal || q0 + kQ - 1 >= key0) {
      const tf32x3::SplitTile qt{qs, q_lo}, dot{dos, do_lo};
      // their columns of this block's part of dK and dV
      const tf32x3::SplitTile qt_out{qs + col0, q_lo + col0},
          dot_out{dos + col0, do_lo + col0};
      const float* lse_s = dos + D::kTile;
      const float* d_s = lse_s + kQ;
      const float* rok_s = d_s + kQ;

      // S^T = K Q^T: this warp's 16 keys x the tile's kQ queries, one
      // 16-wide slice of the head dim at a time (mma3)
      float p[D::kNT][4];
      tf32x3::head_dim_product<D::kNT, D::kKS>(p, k_frag, qt, kStride, g,
                                               t);
      // P^T = exp(S^T * scale - lse); exactly 0 where the pair is masked
      // or the row has no key to attend
#pragma unroll
      for (int j = 0; j < D::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int r = e >> 1;
          const bool ok = kok[r] && rok_s[col] > 0.f &&
                          (!causal || keys[r] <= q0 + col);
          p[j][e] = ok ? expf(p[j][e] * sm_scale - lse_s[col]) : 0.f;
        }
      }
      // dV += P^T dO (the tile's queries in a_from_acc's order)
      tf32x3::tile_product<D::kNT, D::kDT, D::kNT>(dva, p, dot_out, kStride,
                                                   g, t);
      // dP^T = V dO^T
      float ds[D::kNT][4];
      tf32x3::head_dim_product<D::kNT, D::kKS>(ds, v_frag, dot, kStride, g,
                                               t);
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < D::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - d_s[8 * j + 2 * t + (e & 1)]);
      }
      // dK += dS^T Q
      tf32x3::tile_product<D::kNT, D::kDT, D::kNT>(dka, ds, qt_out, kStride,
                                                   g, t);
    }
    __syncthreads();  // every warp is done with buffer it & 1 and the lo
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= T) continue;
    float* dk_row = dk + base + (size_t)keys[r] * pos_stride + col0;
    float* dv_row = dv + base + (size_t)keys[r] * pos_stride + col0;
#pragma unroll
    for (int n = 0; n < D::kDT; ++n) {
      *reinterpret_cast<float2*>(dk_row + 8 * n + 2 * t) = make_float2(
          dka[n][2 * r] * sm_scale, dka[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv_row + 8 * n + 2 * t) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int HD>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* dsum, const float* key_mask, float* dk,
                       float* dv, int B, int T, int nh, int causal,
                       float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Dkv<HD>::kSmem;
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_bwd_dkv_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + Dkv<HD>::kKeys - 1) / Dkv<HD>::kKeys,
                  nh * Dkv<HD>::kSplit, B);
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, key_mask, dk, dv, T, nh, causal, sm_scale);
  return cudaGetLastError();
}

// The dQ kernel's tiling: a block owns 64 query rows, 16 per warp, and
// loops over tiles of kKeys keys staged in shared memory; a warp works
// through a tile in chunks of kChunk keys (S and dP of one chunk are its
// live registers).  At hd 32 the warp's q and dO rows stay in registers,
// split to hi/lo once; at hd 128 and 256 (where dQ alone takes 64
// registers) they are staged in shared memory with the first tile and
// split at use.
template <int HD>
struct Dq : Split<HD> {
  static constexpr bool kQInRegs = HD <= 64;
  static constexpr int kRows = 64;  // query rows per block
  // keys per tile and per warp pass: 64 and 16 at hd 32, 32 and 16 at
  // 128, 8 and 8 at 256 (16 keys a tile would need 233,088 bytes of
  // shared memory beside the staged q and dO, past one block's 232,448)
  static constexpr int kKeys = HD <= 64 ? 64 : HD <= 128 ? 32 : 8;
  static constexpr int kChunk = HD <= 128 ? 16 : 8;
  static constexpr int kStride = HD + 4;  // floats per shared row
  static constexpr int kKS = HD / 8;      // k-steps over the head dim
  static constexpr int kNT = kChunk / 8;  // 8-key column tiles of a chunk
  static constexpr int kDT = Split<HD>::kOD / 8;  // 8-wide tiles of dQ
  // 8-key chunks of dS per accumulator of dQ += dS K: at most 32 keys
  static constexpr int kGroup = kNT < 4 ? kNT : 4;
  static constexpr int kTile = kKeys * kStride;     // floats of a K or V tile
  static constexpr int kStage = 2 * kTile + kKeys;  // K, V, key flags
  static constexpr int kQ = kQInRegs ? 0 : 2 * kRows * kStride;  // q, dO
  // blocks per SM asked of ptxas: shared memory allows 4 at hd 32 and 1
  // at hd 128 and 256
  static constexpr int kMinBlocks = kQInRegs ? 3 : 1;
  // two stages, the lo parts of the current K and V tiles, q and dO at
  // hd 128
  static constexpr size_t kSmem =
      (2 * kStage + 2 * kTile + kQ) * sizeof(float);
  static_assert(kKeys % kChunk == 0 && kKeys <= kThreads, "whole chunks");
  static_assert(kTile % 4 == 0 && kStage % 4 == 0, "16-byte aligned tiles");
};

// grid (ceil(T / 64), nh * kSplit, B): one block per (64 query rows, head
// and column half, article); Dq<HD>::kSmem bytes of dynamic shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads, Dq<HD>::kMinBlocks)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    const float* __restrict__ key_mask,
                    float* __restrict__ dq, int T, int nh, int causal,
                    float sm_scale) {
  using S = Dq<HD>;
  constexpr int kKeys = S::kKeys, kStride = S::kStride, kChunk = S::kChunk;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // causal: the last query blocks have the most key tiles; start them first
  const int qb = causal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int h = blockIdx.y / S::kSplit, b = blockIdx.z;
  const int col0 = (blockIdx.y % S::kSplit) * S::kOD;  // dQ's first column
  const size_t pos_stride = (size_t)nh * HD;  // floats between positions
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * HD;
  const size_t row_base = (size_t)b * T * nh + h;  // lse/dsum of (b, 0, h)
  const int row0 = qb * S::kRows + warp * 16;      // the warp's first row
  const int rows[2] = {row0 + g, row0 + g + 8};    // this lane's two rows

  float l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  bool rok[2] = {false, false};  // a real row with a key to attend
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < T) {
      l[r] = lse[row_base + (size_t)rows[r] * nh];
      dd[r] = dsum[row_base + (size_t)rows[r] * nh];
      rok[r] = isfinite(l[r]);
      if (!rok[r]) l[r] = 0.f;
    }
  }
  // no row of the block attends a key: zeros, without reading anything
  if (!__syncthreads_or(rok[0] || rok[1])) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= T) continue;
      float* dq_row = dq + base + (size_t)rows[r] * pos_stride + col0;
#pragma unroll
      for (int n = 0; n < S::kDT; ++n)
        *reinterpret_cast<float2*>(dq_row + 8 * n + 2 * t) =
            make_float2(0.f, 0.f);
    }
    return;
  }

  // the warp's q and dO rows as A fragments: split once into registers,
  // or (hd 128) read from the shared tiles and split at use
  float* q_s = smem + 2 * S::kStage + 2 * S::kTile;
  float* do_s = q_s + S::kRows * kStride;
  FragA q_reg[S::kQInRegs ? S::kKS : 1], do_reg[S::kQInRegs ? S::kKS : 1];
  if constexpr (S::kQInRegs) {
    const bool in0 = rows[0] < T, in1 = rows[1] < T;
    const size_t o0 = base + (size_t)(in0 ? rows[0] : 0) * pos_stride;
    const size_t o1 = base + (size_t)(in1 ? rows[1] : 0) * pos_stride;
#pragma unroll
    for (int ks = 0; ks < S::kKS; ++ks) {
      const int c = 8 * ks + t;
      q_reg[ks] = tf32x3::split_a(in0 ? q[o0 + c] : 0.f, in1 ? q[o1 + c] : 0.f,
                                  in0 ? q[o0 + c + 4] : 0.f,
                                  in1 ? q[o1 + c + 4] : 0.f);
      do_reg[ks] = tf32x3::split_a(
          in0 ? dout[o0 + c] : 0.f, in1 ? dout[o1 + c] : 0.f,
          in0 ? dout[o0 + c + 4] : 0.f, in1 ? dout[o1 + c + 4] : 0.f);
    }
  }
  auto q_frag = [&](int kk) -> FragA {
    if constexpr (S::kQInRegs)
      return q_reg[kk];
    else
      return tf32x3::load_a(q_s + warp * 16 * kStride + 8 * kk, kStride, g,
                            t);
  };
  auto do_frag = [&](int kk) -> FragA {
    if constexpr (S::kQInRegs)
      return do_reg[kk];
    else
      return tf32x3::load_a(do_s + warp * 16 * kStride + 8 * kk, kStride, g,
                            t);
  };
  float dqa[S::kDT][4];
#pragma unroll
  for (int n = 0; n < S::kDT; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  // causal: keys past the block's last row are never attended
  const int t_end = causal ? min(T, (qb + 1) * S::kRows) : T;  // block-uniform
  const int n_tiles = (t_end + kKeys - 1) / kKeys;

  auto stage = [&](int tile, int buf) {
    float* ks = smem + buf * S::kStage;
    float* vs = ks + S::kTile;
    float* oks = vs + S::kTile;
    const int k0 = tile * kKeys;
    tf32x3::stage_rows<HD, kThreads>(ks, kStride, k + base, pos_stride, k0,
                                     kKeys, T, tid);
    tf32x3::stage_rows<HD, kThreads>(vs, kStride, v + base, pos_stride, k0,
                                     kKeys, T, tid);
    for (int j = tid; j < kKeys; j += kThreads) {
      const int key = k0 + j;
      oks[j] = (key < T && (key_mask == nullptr ||
                            key_mask[(size_t)b * T + key] > 0.f))
                   ? 1.f
                   : 0.f;
    }
    tf32x3::cp_async_commit();
  };

  float* k_lo = smem + 2 * S::kStage;  // lo parts of the current tile
  float* v_lo = k_lo + S::kTile;
  if constexpr (!S::kQInRegs) {  // in the first group, with the first tile
    tf32x3::stage_rows<HD, kThreads>(q_s, kStride, q + base, pos_stride,
                                     qb * S::kRows, S::kRows, T, tid);
    tf32x3::stage_rows<HD, kThreads>(do_s, kStride, dout + base, pos_stride,
                                     qb * S::kRows, S::kRows, T, tid);
  }
  stage(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1, (it + 1) & 1);  // its buffer was freed at it - 1's end
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    float* ks = smem + (it & 1) * S::kStage;
    float* vs = ks + S::kTile;
    const float* oks = vs + S::kTile;
    // each thread splits the chunks it copied; after the barrier the tile
    // is split and has landed for every warp, and the block knows whether
    // any key of the tile is real and unmasked (thread j wrote flag j)
    tf32x3::split_tile<HD, kThreads>(ks, k_lo, kStride, kKeys, tid);
    tf32x3::split_tile<HD, kThreads>(vs, v_lo, kStride, kKeys, tid);
    const bool any_key = __syncthreads_or(tid < kKeys && oks[tid] > 0.f);

    if (any_key) {
      for (int c = 0; c < kKeys / kChunk; ++c) {
        const int c0 = it * kKeys + c * kChunk;  // the chunk's first key
        // causal: this chunk and the later ones lie past the warp's rows
        if (causal && c0 > row0 + 15) break;
        const int off = c * kChunk * kStride;
        const tf32x3::SplitTile kt{ks + off, k_lo + off},
            vt{vs + off, v_lo + off};
        const float* okc = oks + c * kChunk;
        // S = Q K^T
        float p[S::kNT][4];
        tf32x3::head_dim_product<S::kNT, S::kKS>(p, q_frag, kt, kStride, g,
                                                 t);
        // P = exp(S * scale - lse); exactly 0 where the pair is masked or
        // the row has no key to attend
        const bool diag = causal && c0 + kChunk - 1 > row0;
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const int r = e >> 1;
            const bool ok = rok[r] && okc[col] > 0.f &&
                            (!diag || c0 + col <= rows[r]);
            p[j][e] = ok ? expf(p[j][e] * sm_scale - l[r]) : 0.f;
          }
        }
        // dP = dO V^T, then dS = P (dP - D) in its registers
        float ds[S::kNT][4];
        tf32x3::head_dim_product<S::kNT, S::kKS>(ds, do_frag, vt, kStride,
                                                 g, t);
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[j][e] = p[j][e] * (ds[j][e] - dd[e >> 1]);
        }
        // dQ += dS K (the chunk's keys in a_from_acc's order; K's columns
        // of this block's part of dQ)
        const tf32x3::SplitTile kt_out{kt.hi + col0, kt.lo + col0};
        tf32x3::tile_product<S::kNT, S::kDT, S::kGroup>(dqa, ds, kt_out,
                                                        kStride, g, t);
      }
    }
    __syncthreads();  // every warp is done with buffer it & 1 and the lo
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T) continue;
    float* dq_row = dq + base + (size_t)rows[r] * pos_stride + col0;
#pragma unroll
    for (int n = 0; n < S::kDT; ++n)
      *reinterpret_cast<float2*>(dq_row + 8 * n + 2 * t) = make_float2(
          dqa[n][2 * r] * sm_scale, dqa[n][2 * r + 1] * sm_scale);
  }
}

template <int HD>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* dsum,
                      const float* key_mask, float* dq, int B, int T, int nh,
                      int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Dq<HD>::kSmem;
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_bwd_dq_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + Dq<HD>::kRows - 1) / Dq<HD>::kRows,
                  nh * Dq<HD>::kSplit, B);
  flash_bwd_dq_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, key_mask, dq, T, nh, causal, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 forms: q, k, v, dout and the three gradients in bf16, lse and
// dsum in f32.
//
// The library's backward arithmetic for bf16 operands
// (_flash_attention_bwd_dkv and _bwd_dq, flash_attention.py:900, :918,
// :1258): S and dP = dO V^T from bf16 values with f32 sums, P = exp(S *
// scale - lse) and dS = P (dP - D) * scale in f32, P rounded to bf16
// before dV += P^T dO, dS rounded to bf16 before dK += dS^T Q and dQ +=
// dS K, the sums in f32 registers across the whole loop and each gradient
// rounded once to bf16 at the end (sm_scale is in dS, as the library
// applies it before the rounding).  The products are m16n8k16 bf16
// mma.sync (mma_bf16.cuh), fragments from ldmatrix (ldmatrix.trans for
// the B operand taken down the rows: dO in P^T dO, Q in dS^T Q, K in
// dS K), P and dS from their accumulator registers to the next A operand
// (a_from_acc).  The tilings are the f32 forms' with bf16 tiles (rows
// padded by 8 bf16): the dK/dV kernel owns 64 keys (16 per warp), their
// K and V staged once, and loops over query tiles (32 rows at hd 32, 16
// at 128 and 256); the dQ kernel owns 64 query rows, its q and dO staged
// once, and loops over key tiles (64 keys at hd 32, 32 at 128 and 256) in
// passes of 16 keys per warp.  At hd 256 each splits its output's
// columns over two blocks.  Masks, empty rows and blocks, and the causal
// skips are the f32 forms'.
//
// What bounds them on an H100: at the dense bf16 rate (989 TFLOP/s) the
// encoder's 6.6 GFLOP take 6.7 us, against 26 MB of bf16 tensors and f32
// rows (7.9 us at 3.35 TB/s): the bytes, narrowly.

template <int HD>
struct DkvBf16 : Split<HD> {
  static constexpr int kKeys = 64;  // keys per block
  static constexpr int kQ = HD <= 64 ? 32 : 16;  // query rows per tile
  static constexpr int kStride = HD + 8;  // bf16 per shared row
  static constexpr int kNT = kQ / 8;      // 8-query column tiles of S^T
  static constexpr int kDT = Split<HD>::kOD / 8;  // 8-wide tiles of dK, dV
  static constexpr int kKV = 2 * kKeys * kStride;  // bf16 of K and V
  static constexpr int kTile = kQ * kStride;       // bf16 of a q/dO tile
  // per stage: q, dO, then lse, D and a row flag (f32)
  static constexpr size_t kStageBytes = 2 * kTile * 2 + 3 * kQ * 4;
  static constexpr size_t kSmem = kKV * 2 + 2 * kStageBytes;
  static_assert(kStageBytes % 16 == 0, "16-byte aligned stages");
};

// grid (ceil(T / 64), nh * kSplit, B); DkvBf16<HD>::kSmem bytes of dynamic
// shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const bf16mma::bf16* __restrict__ q,
                          const bf16mma::bf16* __restrict__ k,
                          const bf16mma::bf16* __restrict__ v,
                          const bf16mma::bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          const float* __restrict__ key_mask,
                          bf16mma::bf16* __restrict__ dk,
                          bf16mma::bf16* __restrict__ dv, int T, int nh,
                          int causal, float sm_scale) {
  using D = DkvBf16<HD>;
  using bf16mma::bf16;
  constexpr int kQ = D::kQ, kStride = D::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][kStride]
  bf16* vs = ks + D::kKeys * kStride;              // [64][kStride]
  unsigned char* stages = smem_raw + D::kKV * 2;   // two query tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x, h = blockIdx.y / D::kSplit, b = blockIdx.z;
  const int col0 = (blockIdx.y % D::kSplit) * D::kOD;
  const size_t pos_stride = (size_t)nh * HD;
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * HD;
  const size_t row_base = (size_t)b * T * nh + h;
  const int key0 = kb * D::kKeys + warp * 16;     // the warp's first key
  const int keys[2] = {key0 + g, key0 + g + 8};  // this lane's two keys
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kok[r] = keys[r] < T && (key_mask == nullptr ||
                             key_mask[(size_t)b * T + keys[r]] > 0.f);

  float dka[D::kDT][4], dva[D::kDT][4];
#pragma unroll
  for (int n = 0; n < D::kDT; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const bool any = __syncthreads_or(kok[0] || kok[1]);
  const int q_begin = causal ? kb * D::kKeys : 0;  // block-uniform
  const int n_tiles = any ? (T - q_begin + kQ - 1) / kQ : 0;

  auto stage = [&](int tile, int buf) {
    bf16* qs = reinterpret_cast<bf16*>(stages + buf * D::kStageBytes);
    bf16* dos = qs + D::kTile;
    float* lse_s = reinterpret_cast<float*>(dos + D::kTile);
    float* d_s = lse_s + kQ;
    float* rok_s = d_s + kQ;
    const int q0 = q_begin + tile * kQ;
    bf16mma::stage_rows<HD, kThreads>(qs, kStride, q + base, pos_stride, q0,
                                      kQ, T, tid);
    bf16mma::stage_rows<HD, kThreads>(dos, kStride, dout + base, pos_stride,
                                      q0, kQ, T, tid);
    for (int i = tid; i < kQ; i += kThreads) {
      const int row = q0 + i;
      float l = 0.f, d = 0.f;
      bool ok = false;
      if (row < T) {
        l = lse[row_base + (size_t)row * nh];
        d = dsum[row_base + (size_t)row * nh];
        ok = isfinite(l);
      }
      lse_s[i] = ok ? l : 0.f;
      d_s[i] = d;
      rok_s[i] = ok ? 1.f : 0.f;
    }
    tf32x3::cp_async_commit();
  };

  if (n_tiles > 0) {
    bf16mma::stage_rows<HD, kThreads>(ks, kStride, k + base, pos_stride,
                                      kb * D::kKeys, D::kKeys, T, tid);
    bf16mma::stage_rows<HD, kThreads>(vs, kStride, v + base, pos_stride,
                                      kb * D::kKeys, D::kKeys, T, tid);
    stage(0, 0);  // one group: K, V and the first query tile
  }
  const bf16* kw = ks + warp * 16 * kStride;
  const bf16* vw = vs + warp * 16 * kStride;
  auto k_frag = [&](int kk, uint32_t (&a)[4]) {
    bf16mma::load_a(a, kw + 16 * kk, kStride, lane);
  };
  auto v_frag = [&](int kk, uint32_t (&a)[4]) {
    bf16mma::load_a(a, vw + 16 * kk, kStride, lane);
  };
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1, (it + 1) & 1);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    const bf16* qs =
        reinterpret_cast<const bf16*>(stages + (it & 1) * D::kStageBytes);
    const bf16* dos = qs + D::kTile;
    __syncthreads();  // the tile (K and V with the first) has landed

    const int q0 = q_begin + it * kQ;
    if (!causal || q0 + kQ - 1 >= key0) {
      const float* lse_s = reinterpret_cast<const float*>(dos + D::kTile);
      const float* d_s = lse_s + kQ;
      const float* rok_s = d_s + kQ;
      // S^T = K Q^T: this warp's 16 keys x the tile's kQ queries
      float p[D::kNT][4];
      bf16mma::head_dim_product<D::kNT, HD>(p, k_frag, qs, kStride, lane);
      // P^T = exp(S^T * scale - lse); exactly 0 where the pair is masked
      // or the row has no key to attend
#pragma unroll
      for (int j = 0; j < D::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int r = e >> 1;
          const bool ok = kok[r] && rok_s[col] > 0.f &&
                          (!causal || keys[r] <= q0 + col);
          p[j][e] = ok ? expf(p[j][e] * sm_scale - lse_s[col]) : 0.f;
        }
      }
      // dV += P^T dO (P^T rounded to bf16; dO's columns of this block)
      bf16mma::tile_product<D::kNT, D::kDT>(dva, p, dos + col0, kStride,
                                            lane);
      // dP^T = V dO^T
      float ds[D::kNT][4];
      bf16mma::head_dim_product<D::kNT, HD>(ds, v_frag, dos, kStride, lane);
      // dS^T = P^T (dP^T - D) * scale
#pragma unroll
      for (int j = 0; j < D::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - d_s[8 * j + 2 * t + (e & 1)]) *
                     sm_scale;
      }
      // dK += dS^T Q (dS^T rounded to bf16)
      bf16mma::tile_product<D::kNT, D::kDT>(dka, ds, qs + col0, kStride,
                                            lane);
    }
    __syncthreads();  // every warp is done with buffer it & 1
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= T) continue;
    bf16* dk_row = dk + base + (size_t)keys[r] * pos_stride + col0;
    bf16* dv_row = dv + base + (size_t)keys[r] * pos_stride + col0;
#pragma unroll
    for (int n = 0; n < D::kDT; ++n) {
      *reinterpret_cast<uint32_t*>(dk_row + 8 * n + 2 * t) =
          bf16mma::pack(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv_row + 8 * n + 2 * t) =
          bf16mma::pack(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int HD>
cudaError_t launch_dkv_bf16(const bf16mma::bf16* q, const bf16mma::bf16* k,
                            const bf16mma::bf16* v, const bf16mma::bf16* dout,
                            const float* lse, const float* dsum,
                            const float* key_mask, bf16mma::bf16* dk,
                            bf16mma::bf16* dv, int B, int T, int nh,
                            int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = DkvBf16<HD>::kSmem;
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_bwd_dkv_bf16_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + DkvBf16<HD>::kKeys - 1) / DkvBf16<HD>::kKeys,
                  nh * DkvBf16<HD>::kSplit, B);
  flash_bwd_dkv_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, key_mask, dk, dv, T, nh, causal, sm_scale);
  return cudaGetLastError();
}

template <int HD>
struct DqBf16 : Split<HD> {
  static constexpr int kRows = 64;  // query rows per block
  static constexpr int kKeys = HD <= 64 ? 64 : 32;  // keys per tile
  static constexpr int kChunk = 16;  // keys per warp pass
  static constexpr int kStride = HD + 8;  // bf16 per shared row
  static constexpr int kNT = kChunk / 8;  // 8-key column tiles of a chunk
  static constexpr int kDT = Split<HD>::kOD / 8;  // 8-wide tiles of dQ
  static constexpr int kTile = kKeys * kStride;   // bf16 of a K or V tile
  static constexpr int kQD = 2 * kRows * kStride;  // bf16 of q and dO
  // per stage: K, V, then kKeys f32 key flags
  static constexpr size_t kStageBytes = 2 * kTile * 2 + kKeys * 4;
  static constexpr size_t kSmem = kQD * 2 + 2 * kStageBytes;
  static_assert(kKeys % kChunk == 0 && kKeys <= kThreads, "whole chunks");
  static_assert(kStageBytes % 16 == 0, "16-byte aligned stages");
};

// grid (ceil(T / 64), nh * kSplit, B); DqBf16<HD>::kSmem bytes of dynamic
// shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16mma::bf16* __restrict__ q,
                         const bf16mma::bf16* __restrict__ k,
                         const bf16mma::bf16* __restrict__ v,
                         const bf16mma::bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         const float* __restrict__ key_mask,
                         bf16mma::bf16* __restrict__ dq, int T, int nh,
                         int causal, float sm_scale) {
  using S = DqBf16<HD>;
  using bf16mma::bf16;
  constexpr int kKeys = S::kKeys, kStride = S::kStride, kChunk = S::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + S::kRows * kStride;
  unsigned char* stages = smem_raw + S::kQD * 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qb = causal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int h = blockIdx.y / S::kSplit, b = blockIdx.z;
  const int col0 = (blockIdx.y % S::kSplit) * S::kOD;  // dQ's first column
  const size_t pos_stride = (size_t)nh * HD;
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * HD;
  const size_t row_base = (size_t)b * T * nh + h;
  const int row0 = qb * S::kRows + warp * 16;    // the warp's first row
  const int rows[2] = {row0 + g, row0 + g + 8};  // this lane's two rows

  float l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  bool rok[2] = {false, false};  // a real row with a key to attend
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < T) {
      l[r] = lse[row_base + (size_t)rows[r] * nh];
      dd[r] = dsum[row_base + (size_t)rows[r] * nh];
      rok[r] = isfinite(l[r]);
      if (!rok[r]) l[r] = 0.f;
    }
  }
  // no row of the block attends a key: zeros, without reading anything
  if (!__syncthreads_or(rok[0] || rok[1])) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= T) continue;
      bf16* dq_row = dq + base + (size_t)rows[r] * pos_stride + col0;
#pragma unroll
      for (int n = 0; n < S::kDT; ++n)
        *reinterpret_cast<uint32_t*>(dq_row + 8 * n + 2 * t) = 0u;
    }
    return;
  }

  const bf16* q_warp = q_s + warp * 16 * kStride;
  const bf16* do_warp = do_s + warp * 16 * kStride;
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    bf16mma::load_a(a, q_warp + 16 * kk, kStride, lane);
  };
  auto do_frag = [&](int kk, uint32_t (&a)[4]) {
    bf16mma::load_a(a, do_warp + 16 * kk, kStride, lane);
  };
  float dqa[S::kDT][4];
#pragma unroll
  for (int n = 0; n < S::kDT; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  const int t_end = causal ? min(T, (qb + 1) * S::kRows) : T;  // block-uniform
  const int n_tiles = (t_end + kKeys - 1) / kKeys;

  auto stage = [&](int tile, int buf) {
    bf16* ks = reinterpret_cast<bf16*>(stages + buf * S::kStageBytes);
    bf16* vs = ks + S::kTile;
    float* oks = reinterpret_cast<float*>(vs + S::kTile);
    const int k0 = tile * kKeys;
    bf16mma::stage_rows<HD, kThreads>(ks, kStride, k + base, pos_stride, k0,
                                      kKeys, T, tid);
    bf16mma::stage_rows<HD, kThreads>(vs, kStride, v + base, pos_stride, k0,
                                      kKeys, T, tid);
    for (int j = tid; j < kKeys; j += kThreads) {
      const int key = k0 + j;
      oks[j] = (key < T && (key_mask == nullptr ||
                            key_mask[(size_t)b * T + key] > 0.f))
                   ? 1.f
                   : 0.f;
    }
    tf32x3::cp_async_commit();
  };

  // q and dO in the first group, with the first tile
  bf16mma::stage_rows<HD, kThreads>(q_s, kStride, q + base, pos_stride,
                                    qb * S::kRows, S::kRows, T, tid);
  bf16mma::stage_rows<HD, kThreads>(do_s, kStride, dout + base, pos_stride,
                                    qb * S::kRows, S::kRows, T, tid);
  stage(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1, (it + 1) & 1);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    const bf16* ks =
        reinterpret_cast<const bf16*>(stages + (it & 1) * S::kStageBytes);
    const bf16* vs = ks + S::kTile;
    const float* oks = reinterpret_cast<const float*>(vs + S::kTile);
    const bool any_key = __syncthreads_or(tid < kKeys && oks[tid] > 0.f);

    if (any_key) {
      for (int c = 0; c < kKeys / kChunk; ++c) {
        const int c0 = it * kKeys + c * kChunk;  // the chunk's first key
        if (causal && c0 > row0 + 15) break;
        const bf16* kc = ks + c * kChunk * kStride;
        const bf16* vc = vs + c * kChunk * kStride;
        const float* okc = oks + c * kChunk;
        // S = Q K^T
        float p[S::kNT][4];
        bf16mma::head_dim_product<S::kNT, HD>(p, q_frag, kc, kStride, lane);
        const bool diag = causal && c0 + kChunk - 1 > row0;
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const int r = e >> 1;
            const bool ok = rok[r] && okc[col] > 0.f &&
                            (!diag || c0 + col <= rows[r]);
            p[j][e] = ok ? expf(p[j][e] * sm_scale - l[r]) : 0.f;
          }
        }
        // dP = dO V^T, then dS = P (dP - D) * scale in its registers
        float ds[S::kNT][4];
        bf16mma::head_dim_product<S::kNT, HD>(ds, do_frag, vc, kStride,
                                              lane);
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[j][e] = p[j][e] * (ds[j][e] - dd[e >> 1]) * sm_scale;
        }
        // dQ += dS K (dS rounded to bf16; K's columns of this block)
        bf16mma::tile_product<S::kNT, S::kDT>(dqa, ds, kc + col0, kStride,
                                              lane);
      }
    }
    __syncthreads();  // every warp is done with buffer it & 1
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T) continue;
    bf16* dq_row = dq + base + (size_t)rows[r] * pos_stride + col0;
#pragma unroll
    for (int n = 0; n < S::kDT; ++n)
      *reinterpret_cast<uint32_t*>(dq_row + 8 * n + 2 * t) =
          bf16mma::pack(dqa[n][2 * r], dqa[n][2 * r + 1]);
  }
}

template <int HD>
cudaError_t launch_dq_bf16(const bf16mma::bf16* q, const bf16mma::bf16* k,
                           const bf16mma::bf16* v, const bf16mma::bf16* dout,
                           const float* lse, const float* dsum,
                           const float* key_mask, bf16mma::bf16* dq, int B,
                           int T, int nh, int causal, float sm_scale,
                           cudaStream_t stream) {
  constexpr size_t smem = DqBf16<HD>::kSmem;
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_bwd_dq_bf16_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + DqBf16<HD>::kRows - 1) / DqBf16<HD>::kRows,
                  nh * DqBf16<HD>::kSplit, B);
  flash_bwd_dq_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, key_mask, dq, T, nh, causal, sm_scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int nh) {
  return B <= 0 || T <= 0 || nh <= 0 || B > 65535 || nh > 32767;
}

}  // namespace

// q, k, v, dout [B, T, nh, hd], lse and dsum [B, T, nh], dk and dv
// [B, T, nh, hd]: float32, contiguous, on one device; key_mask [B, T]
// float32 (1 = real token) or null (every key real).  hd is 32, 128 or
// 256.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int ts_flash_bwd_dkv(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* lse, const float* dsum,
                                const float* key_mask, float* dk, float* dv,
                                int B, int T, int nh, int hd, int causal,
                                float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, T, nh)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch_dkv<32>(q, k, v, dout, lse, dsum, key_mask, dk, dv,
                                 B, T, nh, causal, sm_scale, st);
    case 128:
      return (int)launch_dkv<128>(q, k, v, dout, lse, dsum, key_mask, dk,
                                  dv, B, T, nh, causal, sm_scale, st);
    case 256:
      return (int)launch_dkv<256>(q, k, v, dout, lse, dsum, key_mask, dk,
                                  dv, B, T, nh, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As ts_flash_bwd_dkv; writes dq [B, T, nh, hd].
extern "C" int ts_flash_bwd_dq(const float* q, const float* k,
                               const float* v, const float* dout,
                               const float* lse, const float* dsum,
                               const float* key_mask, float* dq, int B, int T,
                               int nh, int hd, int causal, float sm_scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, T, nh)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch_dq<32>(q, k, v, dout, lse, dsum, key_mask, dq, B, T,
                                nh, causal, sm_scale, st);
    case 128:
      return (int)launch_dq<128>(q, k, v, dout, lse, dsum, key_mask, dq, B,
                                 T, nh, causal, sm_scale, st);
    case 256:
      return (int)launch_dq<256>(q, k, v, dout, lse, dsum, key_mask, dq, B,
                                 T, nh, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 forms: q, k, v, dout and dk, dv (or dq) [B, T, nh, hd]
// bfloat16, contiguous, 16-byte aligned; lse, dsum and key_mask as the
// f32 forms'.
extern "C" int ts_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* dsum,
                                     const float* key_mask, void* dk,
                                     void* dv, int B, int T, int nh, int hd,
                                     int causal, float sm_scale,
                                     void* stream) {
  using bf16mma::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, T, nh)) return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q),
             *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v),
             *db = static_cast<const bf16*>(dout);
  bf16 *dkb = static_cast<bf16*>(dk), *dvb = static_cast<bf16*>(dv);
  switch (hd) {
    case 32:
      return (int)launch_dkv_bf16<32>(qb, kb, vb, db, lse, dsum, key_mask,
                                      dkb, dvb, B, T, nh, causal, sm_scale,
                                      st);
    case 128:
      return (int)launch_dkv_bf16<128>(qb, kb, vb, db, lse, dsum, key_mask,
                                       dkb, dvb, B, T, nh, causal, sm_scale,
                                       st);
    case 256:
      return (int)launch_dkv_bf16<256>(qb, kb, vb, db, lse, dsum, key_mask,
                                       dkb, dvb, B, T, nh, causal, sm_scale,
                                       st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ts_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* dsum,
                                    const float* key_mask, void* dq, int B,
                                    int T, int nh, int hd, int causal,
                                    float sm_scale, void* stream) {
  using bf16mma::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, T, nh)) return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q),
             *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v),
             *db = static_cast<const bf16*>(dout);
  bf16* dqb = static_cast<bf16*>(dq);
  switch (hd) {
    case 32:
      return (int)launch_dq_bf16<32>(qb, kb, vb, db, lse, dsum, key_mask,
                                     dqb, B, T, nh, causal, sm_scale, st);
    case 128:
      return (int)launch_dq_bf16<128>(qb, kb, vb, db, lse, dsum, key_mask,
                                      dqb, B, T, nh, causal, sm_scale, st);
    case 256:
      return (int)launch_dq_bf16<256>(qb, kb, vb, db, lse, dsum, key_mask,
                                      dqb, B, T, nh, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ts_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
