// Flash self-attention backward for Hopper: the dK/dV kernel and the dQ
// kernel, each in an f32 form (3xTF32) and a bf16 form (wgmma with f32
// sums on tiles copied by TMA, after the f32 forms below) for the
// transformer under compute_dtype=bfloat16.
//
// Replaces the two backward Pallas kernels of the library flash attention
// the JAX package's transformer differentiates through in training
// (`flash_attention` of jax.experimental.pallas.ops.tpu, called at
// textsummarization_on_flink_tpu/models/transformer.py:285; its
// custom_vjp is flash_attention.py:254-318 of the installed jax):
// `_flash_attention_bwd_dkv` (:941, `pl.pallas_call` :1121) and
// `_flash_attention_bwd_dq` (:1287, `pl.pallas_call` :1456).  Per article
// b and head h (q, dout, dq are [B, Tq, nh, hd], k, v, dk, dv [B, Tk, nh,
// hd], contiguous; lse and dsum are [B, Tq, nh]; Tq < Tk is one sp rank's
// block of query rows against every key, and needs causal off), with
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
// The f32 forms' softmax terms use expf (no fast math), so the result
// differs from the plain version by the order of sums and about one f32
// rounding per product.  wgmma and TMA for them are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry points (two per
// dtype, and the bf16 forms' product check) bound with
// ctypes from ops/flash_attention.py.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using namespace flash_bf16;

using tf32x3::FragA;

constexpr int kThreads = 128;

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

// grid (ceil(Tk / 64), nh * kSplit, B): one block per (64 keys, head and
// column half, article); Dkv<HD>::kSmem bytes of dynamic shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     const float* __restrict__ key_mask,
                     float* __restrict__ dk, float* __restrict__ dv, int Tq,
                     int Tk, int nh, int causal, float sm_scale) {
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
  // q and dout hold Tq positions an article, k, v, dk and dv Tk
  const size_t base = (size_t)b * Tk * pos_stride + (size_t)h * HD;
  const size_t q_base = (size_t)b * Tq * pos_stride + (size_t)h * HD;
  const size_t row_base = (size_t)b * Tq * nh + h;  // lse/dsum of (b, 0, h)
  const int key0 = kb * D::kKeys + warp * 16;       // the warp's first key
  const int keys[2] = {key0 + g, key0 + g + 8};    // this lane's two keys
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kok[r] = keys[r] < Tk && (key_mask == nullptr ||
                              key_mask[(size_t)b * Tk + keys[r]] > 0.f);

  float dka[D::kDT][4], dva[D::kDT][4];
#pragma unroll
  for (int n = 0; n < D::kDT; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  // no key of the block is attended: zeros, without reading anything
  const bool any = __syncthreads_or(kok[0] || kok[1]);
  // causal (Tq == Tk): a row before the block's first key attends none of
  // its keys
  const int q_begin = causal ? kb * D::kKeys : 0;  // block-uniform
  const int n_tiles = any ? (Tq - q_begin + kQ - 1) / kQ : 0;

  auto stage = [&](int tile, int buf) {
    float* qs = stages + buf * D::kStage;
    float* dos = qs + D::kTile;
    float* lse_s = dos + D::kTile;
    float* d_s = lse_s + kQ;
    float* rok_s = d_s + kQ;
    const int q0 = q_begin + tile * kQ;
    tf32x3::stage_rows<HD, kThreads>(qs, kStride, q + q_base, pos_stride,
                                     q0, kQ, Tq, tid);
    tf32x3::stage_rows<HD, kThreads>(dos, kStride, dout + q_base, pos_stride,
                                     q0, kQ, Tq, tid);
    for (int i = tid; i < kQ; i += kThreads) {
      const int row = q0 + i;
      float l = 0.f, d = 0.f;
      bool ok = false;
      if (row < Tq) {
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
                                     kb * D::kKeys, D::kKeys, Tk, tid);
    tf32x3::stage_rows<HD, kThreads>(vs, kStride, v + base, pos_stride,
                                     kb * D::kKeys, D::kKeys, Tk, tid);
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
    if (keys[r] >= Tk) continue;
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
                       float* dv, int B, int Tq, int Tk, int nh, int causal,
                       float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Dkv<HD>::kSmem;
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_bwd_dkv_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + Dkv<HD>::kKeys - 1) / Dkv<HD>::kKeys,
                  nh * Dkv<HD>::kSplit, B);
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, key_mask, dk, dv, Tq, Tk, nh, causal,
      sm_scale);
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

// grid (ceil(Tq / 64), nh * kSplit, B): one block per (64 query rows, head
// and column half, article); Dq<HD>::kSmem bytes of dynamic shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads, Dq<HD>::kMinBlocks)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    const float* __restrict__ key_mask,
                    float* __restrict__ dq, int Tq, int Tk, int nh,
                    int causal, float sm_scale) {
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
  // q, dout and dq hold Tq positions an article, k and v Tk
  const size_t base = (size_t)b * Tq * pos_stride + (size_t)h * HD;
  const size_t k_base = (size_t)b * Tk * pos_stride + (size_t)h * HD;
  const size_t row_base = (size_t)b * Tq * nh + h;  // lse/dsum of (b, 0, h)
  const int row0 = qb * S::kRows + warp * 16;       // the warp's first row
  const int rows[2] = {row0 + g, row0 + g + 8};    // this lane's two rows

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
  // no row of the block attends a key: zeros, without reading anything
  if (!__syncthreads_or(rok[0] || rok[1])) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= Tq) continue;
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
    const bool in0 = rows[0] < Tq, in1 = rows[1] < Tq;
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

  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end =
      causal ? min(Tk, (qb + 1) * S::kRows) : Tk;  // block-uniform
  const int n_tiles = (t_end + kKeys - 1) / kKeys;

  auto stage = [&](int tile, int buf) {
    float* ks = smem + buf * S::kStage;
    float* vs = ks + S::kTile;
    float* oks = vs + S::kTile;
    const int k0 = tile * kKeys;
    tf32x3::stage_rows<HD, kThreads>(ks, kStride, k + k_base, pos_stride, k0,
                                     kKeys, Tk, tid);
    tf32x3::stage_rows<HD, kThreads>(vs, kStride, v + k_base, pos_stride, k0,
                                     kKeys, Tk, tid);
    for (int j = tid; j < kKeys; j += kThreads) {
      const int key = k0 + j;
      oks[j] = (key < Tk && (key_mask == nullptr ||
                             key_mask[(size_t)b * Tk + key] > 0.f))
                   ? 1.f
                   : 0.f;
    }
    tf32x3::cp_async_commit();
  };

  float* k_lo = smem + 2 * S::kStage;  // lo parts of the current tile
  float* v_lo = k_lo + S::kTile;
  if constexpr (!S::kQInRegs) {  // in the first group, with the first tile
    tf32x3::stage_rows<HD, kThreads>(q_s, kStride, q + base, pos_stride,
                                     qb * S::kRows, S::kRows, Tq, tid);
    tf32x3::stage_rows<HD, kThreads>(do_s, kStride, dout + base, pos_stride,
                                     qb * S::kRows, S::kRows, Tq, tid);
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
    if (rows[r] >= Tq) continue;
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
                      const float* key_mask, float* dq, int B, int Tq,
                      int Tk, int nh, int causal, float sm_scale,
                      cudaStream_t stream) {
  constexpr size_t smem = Dq<HD>::kSmem;
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_bwd_dq_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + Dq<HD>::kRows - 1) / Dq<HD>::kRows,
                  nh * Dq<HD>::kSplit, B);
  flash_bwd_dq_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, key_mask, dq, Tq, Tk, nh, causal, sm_scale);
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
// applies it before the rounding).
//
// What bounds them on an H100: operations at the dense bf16 rate (989
// TFLOP/s): 8 * hd per attended pair for dK/dV and 6 * hd for dQ (14 *
// hd together, since both form S and dP), 0.136 ms at 4 x 2048 x 8 x 128
// with a key mask; at the encoder's 16 x 400 x 8 x 32 the 26 MB of bf16
// tensors and f32 rows (7.9 us at 3.35 TB/s) bound them, narrowly.
//
// The design (Hopper's; wgmma_bf16.cuh, and the block geometry the
// forward's bf16 form shares, flash_bf16.cuh): a block is kWGs = 2 consumer
// warpgroups and a producer warpgroup whose first warp works (setmaxnreg
// moves the others' registers to the consumers).  Its lane 0 copies the
// block's fixed tiles once and keeps the loop's tiles in flight through a
// ring of kStages = 2 stages in shared memory (a third and a fourth gained
// nothing on the card), each behind a "full" mbarrier
// (the copy's bytes and the 32 lanes' arrivals) and an "empty" one (every
// consumer thread's arrival once its products have read the stage).  Each
// warpgroup owns 64 rows of the block's output and runs its products as
// wgmma on the ring's tiles, accumulating its gradients in registers over
// the whole loop (at hd 128, dK and dV alone are 128 registers a thread).
// Within a warpgroup the steps run in order (products, wait, elementwise
// terms, products, wait); the two warpgroups of a block overlap one's
// elementwise terms with the other's products.  Keeping a tile's dK and dV
// products in flight across the next tile's S^T was slower on the card.
//
//   * dK/dV: a block owns 128 keys (K and V copied once); the ring brings
//     tiles of kQ query rows of q and dO (64, or 32 at hd 256, where K and
//     V take 128 KB of shared memory) and their lse and D, which the
//     producer's lanes load (lse and D are [B, T, nh]: a head's rows are
//     nh * 4 bytes apart, below the copy engine's 16-byte box; lse is
//     stored times log2 e, +inf for a row with no key to attend or past
//     T).  Per tile: S^T = K Q^T and dP^T = V dO^T (A
//     and B from shared memory, both K-major), P^T and dS^T in their
//     accumulator registers, then dV += P^T dO and dK += dS^T Q with A
//     from registers (a_frag) and B = dO or Q M|N-major;
//   * dQ: a block owns 128 query rows (q and dO copied once, lse and D in
//     registers); the ring brings tiles of kKeys keys of K and V (64, or
//     32 at hd 256) and a 64-bit word of their flags (real and unmasked),
//     which the producer's lanes form with a ballot.  Per tile: S = Q K^T,
//     dP = dO V^T, dS in registers, dQ += dS K (B = K M|N-major);
//   * head dim 256: each kernel keeps its output's columns split over two
//     blocks (the grid's y axis holds head x half), forming S and dP over
//     the full 256 and keeping 128 columns of dK and dV, or of dQ.
//
// Masks: a pair the row may not attend gets p = 0 explicitly (key flag,
// lse of +inf, causal), never exp(s - lse) with a sentinel; so an empty
// article gives exact zeros, and a block none of whose keys (dK/dV) or
// rows (dQ) attends anything writes zeros and stops before the ring
// starts.  Causal: the dK/dV kernel starts at its first key's row and a
// warpgroup skips a tile all of whose rows precede its first key; the dQ
// kernel stops at the key tile past its last row, a warpgroup skips a
// tile all of whose keys follow its last row, and the blocks with the
// most tiles start first.  Only a tile that crosses the diagonal tests
// it.  No atomics: each block owns its outputs, so two runs give the same
// bits.  exp is ex2 (one MUFU instruction) of a fused multiply-add on
// log2 e-scaled terms.

template <int HD>
struct DkvBf16 : Split<HD> {
  using L = wg::Tile<HD>;
  static constexpr int kQ = HD <= 128 ? 64 : 32;  // query rows per tile
  static constexpr int kKV = L::bytes(kBlockRows);  // K or V
  static constexpr int kTile = L::bytes(kQ);        // a q or dO tile
  // K, V, the stages' q and dO tiles, their lse and D rows, the barriers
  static constexpr int kRowsOff = 2 * kKV + 2 * kStages * kTile;
  static constexpr int kBarOff = kRowsOff + 2 * kStages * kQ * 4;
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
};

// grid (ceil(Tk / 128), nh * kSplit, B), kBf16Threads threads,
// DkvBf16<HD>::kSmem bytes of dynamic shared memory; the maps' boxes are
// kQ rows (q, dO) and kBlockRows rows (k, v)
template <int HD>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          const float* __restrict__ key_mask,
                          wg::bf16* __restrict__ dk, wg::bf16* __restrict__ dv,
                          int Tq, int Tk, int nh, int causal,
                          float sm_scale) {
  using D = DkvBf16<HD>;
  constexpr int kQ = D::kQ, kOD = D::kOD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = smem + D::kKV;
  unsigned char* tiles = smem + 2 * D::kKV;  // stage s: q, then dO
  float* rows_s = reinterpret_cast<float*>(smem + D::kRowsOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + D::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool producer = warp >= 4 * kWGs;
  const int kb = blockIdx.x, h = blockIdx.y / D::kSplit, b = blockIdx.z;
  const int col0 = (blockIdx.y % D::kSplit) * kOD;
  const size_t pos_stride = (size_t)nh * HD;
  // of dk and dv, Tk positions an article; lse and dsum hold Tq
  const size_t base = (size_t)b * Tk * pos_stride + (size_t)h * HD + col0;
  const size_t row_base = (size_t)b * Tq * nh + h;
  const int k_blk = kb * kBlockRows;     // the block's first key
  const int kw = k_blk + 64 * (warp >> 2);  // the warpgroup's first key
  const int key0 = kw + 16 * (warp & 3) + g;
  const int keys[2] = {key0, key0 + 8};  // this thread's rows of dK, dV
  bool kok[2] = {false, false};
  if (!producer) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      kok[r] = keys[r] < Tk && (key_mask == nullptr ||
                                key_mask[(size_t)b * Tk + keys[r]] > 0.f);
  }
  float dka[kOD / 2], dva[kOD / 2];
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) dka[i] = dva[i] = 0.f;
  // no key of the block is attended: zeros, without reading anything
  if (!__syncthreads_or(kok[0] || kok[1])) {
    if (!producer) {
      store_rows<kOD>(dk + base, pos_stride, keys, Tk, dka, t);
      store_rows<kOD>(dv + base, pos_stride, keys, Tk, dva, t);
    }
    return;
  }
  // causal (Tq == Tk): a row before the block's first key attends none of
  // its keys
  const int q_begin = causal ? k_blk : 0;
  const int n_tiles = (Tq - q_begin + kQ - 1) / kQ;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::mbar_init(&full[s], 32);
      tma::mbar_init(&empty[s], kWgThreads);
    }
    tma::mbar_init(kv_bar, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();

  set_regs(producer);
  if (producer) {
    if (warp != 4 * kWGs) return;
    if (lane == 0) {
      tma::mbar_arrive_tx(kv_bar, 2 * D::kKV);
      wg::load_tile<HD>(ks, &k_map, kBlockRows, k_blk, h, b, kv_bar);
      wg::load_tile<HD>(vs, &v_map, kBlockRows, k_blk, h, b, kv_bar);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      tma::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      const int q0 = q_begin + it * kQ;
      float* lse_s = rows_s + s * 2 * kQ;  // then D
      for (int i = lane; i < kQ; i += 32) {
        const int row = q0 + i;
        float l = INFINITY, d = 0.f;
        if (row < Tq) {
          const float x = lse[row_base + (size_t)row * nh];
          if (isfinite(x)) l = x * kLog2e;
          d = dsum[row_base + (size_t)row * nh];
        }
        lse_s[i] = l;
        lse_s[kQ + i] = d;
      }
      unsigned char* qs = tiles + s * 2 * D::kTile;
      if (lane == 0) {
        tma::mbar_arrive_tx(&full[s], 2 * D::kTile);
        wg::load_tile<HD>(qs, &q_map, kQ, q0, h, b, &full[s]);
        wg::load_tile<HD>(qs + D::kTile, &do_map, kQ, q0, h, b, &full[s]);
      } else {
        tma::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int row0 = 64 * (warp >> 2);  // the warpgroup's rows of K and V
  const float scale_l2 = sm_scale * kLog2e;
  tma::mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    tma::mbar_wait(&full[s], (it / kStages) & 1);
    const int q0 = q_begin + it * kQ;
    // causal: every row of the tile precedes the warpgroup's first key
    if (kw < Tk && !(causal && q0 + kQ - 1 < kw)) {
      const unsigned char* qs = tiles + s * 2 * D::kTile;
      const unsigned char* dos = qs + D::kTile;
      const float* lse_s = rows_s + s * 2 * kQ;
      float sa[kQ / 2], pa[kQ / 2];  // S^T then P^T; dP^T then dS^T
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wg::Mma<kQ>::ss(sa, wg::desc_k<HD>(ks, kBlockRows, row0, kk),
                        wg::desc_k<HD>(qs, kQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wg::Mma<kQ>::ss(pa, wg::desc_k<HD>(vs, kBlockRows, row0, kk),
                        wg::desc_k<HD>(dos, kQ, 0, kk), kk > 0);
      wg::commit();
      wg::wait<0>();
      wg::keep(sa);
      wg::keep(pa);
      // P^T = exp(S^T * scale - lse), dS^T = P^T (dP^T - D) * scale
      const bool diag = causal && q0 < kw + 63;
#pragma unroll
      for (int i = 0; i < kQ / 8; ++i) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_s + 8 * i + 2 * t);
        const float2 d2 =
            *reinterpret_cast<const float2*>(lse_s + kQ + 8 * i + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * i + 2 * t + (e & 1);
          const float l = (e & 1) ? l2.y : l2.x;
          const float d = (e & 1) ? d2.y : d2.x;
          const bool ok = kok[r] && l != INFINITY &&
                          (!diag || keys[r] <= q0 + c);
          const float p = ok ? ex2(fmaf(sa[4 * i + e], scale_l2, -l)) : 0.f;
          sa[4 * i + e] = p;
          pa[4 * i + e] = p * (pa[4 * i + e] - d) * sm_scale;
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
        wg::Mma<kOD>::rs(dva, pf[kk], wg::desc_mn<HD>(dos, kQ, kk, col0), 1);
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wg::Mma<kOD>::rs(dka, df[kk], wg::desc_mn<HD>(qs, kQ, kk, col0), 1);
      wg::commit();
      wg::wait<0>();
      wg::keep(dva);
      wg::keep(dka);
      wg::keep(pf);
      wg::keep(df);
    }
    tma::mbar_arrive(&empty[s]);
  }
  store_rows<kOD>(dk + base, pos_stride, keys, Tk, dka, t);
  store_rows<kOD>(dv + base, pos_stride, keys, Tk, dva, t);
}

template <int HD>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* dsum, const float* key_mask,
                            void* dk, void* dv, int B, int Tq, int Tk, int nh,
                            int causal, float sm_scale, cudaStream_t stream) {
  using D = DkvBf16<HD>;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  const int rows[4] = {D::kQ, kBlockRows, kBlockRows, D::kQ};
  const int lens[4] = {Tq, Tk, Tk, Tq};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err =
        wg::make_map(&maps[i], ptrs[i], B, lens[i], nh, HD, rows[i]);
    if (err != cudaSuccess) return err;
  }
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_bwd_dkv_bf16_kernel<HD>, D::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + kBlockRows - 1) / kBlockRows, nh * D::kSplit, B);
  flash_bwd_dkv_bf16_kernel<HD><<<grid, kBf16Threads, D::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dsum, key_mask,
      static_cast<wg::bf16*>(dk), static_cast<wg::bf16*>(dv), Tq, Tk, nh,
      causal, sm_scale);
  return cudaGetLastError();
}

template <int HD>
struct DqBf16 : Split<HD> {
  using L = wg::Tile<HD>;
  static constexpr int kKeys = HD <= 128 ? 64 : 32;  // keys per tile
  static constexpr int kQD = L::bytes(kBlockRows);  // q or dO
  static constexpr int kTile = L::bytes(kKeys);     // a K or V tile
  // q, dO, the stages' K and V tiles, their key-flag words, the barriers
  static constexpr int kMaskOff = 2 * kQD + 2 * kStages * kTile;
  static constexpr int kBarOff = kMaskOff + kStages * 8;
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
  static_assert(kKeys <= 64, "one 64-bit word of key flags per tile");
};

// grid (ceil(Tq / 128), nh * kSplit, B), kBf16Threads threads,
// DqBf16<HD>::kSmem bytes of dynamic shared memory; the maps' boxes are
// kBlockRows rows (q, dO) and kKeys rows (k, v)
template <int HD>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         const float* __restrict__ key_mask,
                         wg::bf16* __restrict__ dq, int Tq, int Tk, int nh,
                         int causal, float sm_scale) {
  using S = DqBf16<HD>;
  constexpr int kKeys = S::kKeys, kOD = S::kOD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = smem + S::kQD;
  unsigned char* tiles = smem + 2 * S::kQD;  // stage s: K, then V
  uint64_t* flags = reinterpret_cast<uint64_t*>(smem + S::kMaskOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* qd_bar = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool producer = warp >= 4 * kWGs;
  // causal: the last query blocks have the most key tiles; start them first
  const int qb = causal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int h = blockIdx.y / S::kSplit, b = blockIdx.z;
  const int col0 = (blockIdx.y % S::kSplit) * kOD;
  const size_t pos_stride = (size_t)nh * HD;
  // of dq, lse and dsum: Tq positions an article
  const size_t base = (size_t)b * Tq * pos_stride + (size_t)h * HD + col0;
  const size_t row_base = (size_t)b * Tq * nh + h;
  const int r_blk = qb * kBlockRows;        // the block's first row
  const int rw = r_blk + 64 * (warp >> 2);  // the warpgroup's first row
  const int q_row = rw + 16 * (warp & 3) + g;
  const int rows[2] = {q_row, q_row + 8};  // this thread's rows of dQ
  float l[2] = {INFINITY, INFINITY}, dd[2] = {0.f, 0.f};  // lse * log2 e, D
  bool rok[2] = {false, false};  // a real row with a key to attend
  if (!producer) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= Tq) continue;
      const float x = lse[row_base + (size_t)rows[r] * nh];
      rok[r] = isfinite(x);
      if (rok[r]) l[r] = x * kLog2e;
      dd[r] = dsum[row_base + (size_t)rows[r] * nh];
    }
  }
  float dqa[kOD / 2];
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) dqa[i] = 0.f;
  // no row of the block attends a key: zeros, without reading anything
  if (!__syncthreads_or(rok[0] || rok[1])) {
    if (!producer) store_rows<kOD>(dq + base, pos_stride, rows, Tq, dqa, t);
    return;
  }
  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, r_blk + kBlockRows) : Tk;
  const int n_tiles = (t_end + kKeys - 1) / kKeys;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::mbar_init(&full[s], 32);
      tma::mbar_init(&empty[s], kWgThreads);
    }
    tma::mbar_init(qd_bar, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();

  set_regs(producer);
  if (producer) {
    if (warp != 4 * kWGs) return;
    if (lane == 0) {
      tma::mbar_arrive_tx(qd_bar, 2 * S::kQD);
      wg::load_tile<HD>(qs, &q_map, kBlockRows, r_blk, h, b, qd_bar);
      wg::load_tile<HD>(dos, &do_map, kBlockRows, r_blk, h, b, qd_bar);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      tma::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      const int k0 = it * kKeys;
      // bit j: key k0 + j is real and unmasked
      uint64_t bits = 0;
#pragma unroll
      for (int j = 0; j < kKeys; j += 32) {
        const int key = k0 + j + lane;
        const bool ok = key < Tk && (key_mask == nullptr ||
                                     key_mask[(size_t)b * Tk + key] > 0.f);
        bits |= (uint64_t)__ballot_sync(0xffffffffu, ok) << j;
      }
      unsigned char* ks = tiles + s * 2 * S::kTile;
      if (lane == 0) {
        flags[s] = bits;
        tma::mbar_arrive_tx(&full[s], 2 * S::kTile);
        wg::load_tile<HD>(ks, &k_map, kKeys, k0, h, b, &full[s]);
        wg::load_tile<HD>(ks + S::kTile, &v_map, kKeys, k0, h, b, &full[s]);
      } else {
        tma::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int row0 = 64 * (warp >> 2);  // the warpgroup's rows of q and dO
  const float scale_l2 = sm_scale * kLog2e;
  tma::mbar_wait(qd_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    tma::mbar_wait(&full[s], (it / kStages) & 1);
    const int k0 = it * kKeys;
    const uint64_t bits = flags[s];
    // causal: every key of the tile follows the warpgroup's last row
    if (bits != 0 && rw < Tq && !(causal && k0 > rw + 63)) {
      const unsigned char* ks = tiles + s * 2 * S::kTile;
      const unsigned char* vs = ks + S::kTile;
      float sa[kKeys / 2], pa[kKeys / 2];  // S then P; dP then dS
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wg::Mma<kKeys>::ss(sa, wg::desc_k<HD>(qs, kBlockRows, row0, kk),
                           wg::desc_k<HD>(ks, kKeys, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wg::Mma<kKeys>::ss(pa, wg::desc_k<HD>(dos, kBlockRows, row0, kk),
                           wg::desc_k<HD>(vs, kKeys, 0, kk), kk > 0);
      wg::commit();
      wg::wait<0>();
      wg::keep(sa);
      wg::keep(pa);
      // P = exp(S * scale - lse), dS = P (dP - D) * scale
      const bool diag = causal && k0 + kKeys - 1 > rw;
      const uint64_t bits_t = bits >> (2 * t);  // bit 8 i + e: key c below
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * i + 2 * t + (e & 1);
          const bool ok = rok[r] && ((bits_t >> (8 * i + (e & 1))) & 1) &&
                          (!diag || k0 + c <= rows[r]);
          const float p =
              ok ? ex2(fmaf(sa[4 * i + e], scale_l2, -l[r])) : 0.f;
          pa[4 * i + e] = p * (pa[4 * i + e] - dd[r]) * sm_scale;
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
        wg::Mma<kOD>::rs(dqa, df[kk], wg::desc_mn<HD>(ks, kKeys, kk, col0),
                         1);
      wg::commit();
      wg::wait<0>();
      wg::keep(dqa);
      wg::keep(df);
    }
    tma::mbar_arrive(&empty[s]);
  }
  store_rows<kOD>(dq + base, pos_stride, rows, Tq, dqa, t);
}

template <int HD>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* dsum, const float* key_mask, void* dq,
                           int B, int Tq, int Tk, int nh, int causal,
                           float sm_scale, cudaStream_t stream) {
  using S = DqBf16<HD>;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  const int rows[4] = {kBlockRows, S::kKeys, S::kKeys, kBlockRows};
  const int lens[4] = {Tq, Tk, Tk, Tq};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err =
        wg::make_map(&maps[i], ptrs[i], B, lens[i], nh, HD, rows[i]);
    if (err != cudaSuccess) return err;
  }
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_bwd_dq_bf16_kernel<HD>, S::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBlockRows - 1) / kBlockRows, nh * S::kSplit, B);
  flash_bwd_dq_bf16_kernel<HD><<<grid, kBf16Threads, S::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dsum, key_mask,
      static_cast<wg::bf16*>(dq), Tq, Tk, nh, causal, sm_scale);
  return cudaGetLastError();
}

// One warpgroup's products from copied tiles, the two kernels' building
// blocks on small integers for the card tests: d1 = X[x0 .. x0 + 63] Y^T
// (ss, both K-major: S^T = K Q^T, S = Q K^T) and d2 = bf16(d1) Z[:, col0
// .. col0 + kOD) (rs from a_frag, Z M|N-major: dV += P^T dO, dQ += dS K).
// x is [128, HD], y and z [NY, HD], all bf16; d1 [64, NY], d2 [64, kOD]
// f32.
template <int HD, int NY>
__global__ void __launch_bounds__(128)
wgmma_check_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap y_map,
                   const __grid_constant__ CUtensorMap z_map, int x0,
                   int col0, float* d1, float* d2) {
  using L = wg::Tile<HD>;
  constexpr int kOD = Split<HD>::kOD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = align1024(smem_raw);
  unsigned char* ys = xs + L::bytes(128);
  unsigned char* zs = ys + L::bytes(NY);
  uint64_t* bar = reinterpret_cast<uint64_t*>(zs + L::bytes(NY));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    tma::mbar_init(bar, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma::mbar_arrive_tx(bar, L::bytes(128) + 2 * L::bytes(NY));
    wg::load_tile<HD>(xs, &x_map, 128, 0, 0, 0, bar);
    wg::load_tile<HD>(ys, &y_map, NY, 0, 0, 0, bar);
    wg::load_tile<HD>(zs, &z_map, NY, 0, 0, 0, bar);
  }
  tma::mbar_wait(bar, 0);
  float s[NY / 2], o[kOD / 2];
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) o[i] = 0.f;
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wg::Mma<NY>::ss(s, wg::desc_k<HD>(xs, 128, x0, kk),
                    wg::desc_k<HD>(ys, NY, 0, kk), kk > 0);
  wg::commit();
  wg::wait<0>();
  wg::keep(s);
  uint32_t a[NY / 16][4];
#pragma unroll
  for (int kk = 0; kk < NY / 16; ++kk) wg::a_frag(a[kk], s, kk);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NY / 16; ++kk)
    wg::Mma<kOD>::rs(o, a[kk], wg::desc_mn<HD>(zs, NY, kk, col0), 1);
  wg::commit();
  wg::wait<0>();
  wg::keep(o);
  wg::keep(a);
  const int row = 16 * warp + g;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = row + 8 * (e >> 1);
#pragma unroll
    for (int i = 0; i < NY / 8; ++i)
      d1[r * NY + 8 * i + 2 * t + (e & 1)] = s[4 * i + e];
#pragma unroll
    for (int i = 0; i < kOD / 8; ++i)
      d2[r * kOD + 8 * i + 2 * t + (e & 1)] = o[4 * i + e];
  }
}

template <int HD, int NY>
cudaError_t launch_wgmma_check(const void* x, const void* y, const void* z,
                               int x0, int col0, float* d1, float* d2,
                               cudaStream_t stream) {
  using L = wg::Tile<HD>;
  CUtensorMap maps[3];
  cudaError_t err = wg::make_map(&maps[0], x, 1, 128, 1, HD, 128);
  if (err == cudaSuccess) err = wg::make_map(&maps[1], y, 1, NY, 1, HD, NY);
  if (err == cudaSuccess) err = wg::make_map(&maps[2], z, 1, NY, 1, HD, NY);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = L::bytes(128) + 2 * L::bytes(NY) + 8 + 1024;
  static unsigned smem_set = 0;
  err = tf32x3::allow_smem(wgmma_check_kernel<HD, NY>, smem, smem_set);
  if (err != cudaSuccess) return err;
  wgmma_check_kernel<HD, NY><<<1, 128, smem, stream>>>(
      maps[0], maps[1], maps[2], x0, col0, d1, d2);
  return cudaGetLastError();
}

bool bad_shape(int B, int Tq, int Tk, int nh, int causal) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || nh <= 0 || B > 65535 ||
         nh > 32767 || (causal && Tq != Tk);
}

}  // namespace

// q, dout [B, Tq, nh, hd], k, v [B, Tk, nh, hd], lse and dsum [B, Tq, nh],
// dk and dv [B, Tk, nh, hd]: float32, contiguous, on one device; key_mask
// [B, Tk] float32 (1 = real token) or null (every key real).  hd is 32,
// 128 or 256; causal needs Tq == Tk.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int ts_flash_bwd_dkv(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* lse, const float* dsum,
                                const float* key_mask, float* dk, float* dv,
                                int B, int Tq, int Tk, int nh, int hd,
                                int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, Tq, Tk, nh, causal)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch_dkv<32>(q, k, v, dout, lse, dsum, key_mask, dk, dv,
                                 B, Tq, Tk, nh, causal, sm_scale, st);
    case 128:
      return (int)launch_dkv<128>(q, k, v, dout, lse, dsum, key_mask, dk,
                                  dv, B, Tq, Tk, nh, causal, sm_scale, st);
    case 256:
      return (int)launch_dkv<256>(q, k, v, dout, lse, dsum, key_mask, dk,
                                  dv, B, Tq, Tk, nh, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As ts_flash_bwd_dkv; writes dq [B, Tq, nh, hd].
extern "C" int ts_flash_bwd_dq(const float* q, const float* k,
                               const float* v, const float* dout,
                               const float* lse, const float* dsum,
                               const float* key_mask, float* dq, int B,
                               int Tq, int Tk, int nh, int hd, int causal,
                               float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, Tq, Tk, nh, causal)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch_dq<32>(q, k, v, dout, lse, dsum, key_mask, dq, B,
                                Tq, Tk, nh, causal, sm_scale, st);
    case 128:
      return (int)launch_dq<128>(q, k, v, dout, lse, dsum, key_mask, dq, B,
                                 Tq, Tk, nh, causal, sm_scale, st);
    case 256:
      return (int)launch_dq<256>(q, k, v, dout, lse, dsum, key_mask, dq, B,
                                 Tq, Tk, nh, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 forms: q, k, v, dout and dk, dv (or dq) as above in bfloat16,
// contiguous, 16-byte aligned; lse, dsum and key_mask as the f32 forms'.
extern "C" int ts_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* dsum,
                                     const float* key_mask, void* dk,
                                     void* dv, int B, int Tq, int Tk, int nh,
                                     int hd, int causal, float sm_scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, Tq, Tk, nh, causal)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch_dkv_bf16<32>(q, k, v, dout, lse, dsum, key_mask, dk,
                                      dv, B, Tq, Tk, nh, causal, sm_scale,
                                      st);
    case 128:
      return (int)launch_dkv_bf16<128>(q, k, v, dout, lse, dsum, key_mask,
                                       dk, dv, B, Tq, Tk, nh, causal,
                                       sm_scale, st);
    case 256:
      return (int)launch_dkv_bf16<256>(q, k, v, dout, lse, dsum, key_mask,
                                       dk, dv, B, Tq, Tk, nh, causal,
                                       sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ts_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* dsum,
                                    const float* key_mask, void* dq, int B,
                                    int Tq, int Tk, int nh, int hd,
                                    int causal, float sm_scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, Tq, Tk, nh, causal)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch_dq_bf16<32>(q, k, v, dout, lse, dsum, key_mask, dq,
                                     B, Tq, Tk, nh, causal, sm_scale, st);
    case 128:
      return (int)launch_dq_bf16<128>(q, k, v, dout, lse, dsum, key_mask, dq,
                                      B, Tq, Tk, nh, causal, sm_scale, st);
    case 256:
      return (int)launch_dq_bf16<256>(q, k, v, dout, lse, dsum, key_mask, dq,
                                      B, Tq, Tk, nh, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x [128, hd], y and z [ny, hd] bfloat16, d1 [64, ny] and d2 [64, min(hd,
// 128)] float32 on the device: one warpgroup's product check
// (wgmma_check_kernel) at the kernels' (hd, ny): the backward's (32, 64),
// (128, 32), (128, 64), (256, 32) and the forward's (32, 128), (128,
// 128), (256, 64); x0 is 0 or 64, col0 0 (or 128 at hd 256)
extern "C" int ts_flash_wgmma_check(const void* x, const void* y,
                                    const void* z, float* d1, float* d2,
                                    int hd, int ny, int x0, int col0,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((x0 != 0 && x0 != 64) || col0 < 0 || col0 + (hd < 128 ? hd : 128) > hd ||
      col0 % 128 != 0)
    return (int)cudaErrorInvalidValue;
  if (hd == 32 && ny == 64)
    return (int)launch_wgmma_check<32, 64>(x, y, z, x0, col0, d1, d2, st);
  if (hd == 128 && ny == 32)
    return (int)launch_wgmma_check<128, 32>(x, y, z, x0, col0, d1, d2, st);
  if (hd == 128 && ny == 64)
    return (int)launch_wgmma_check<128, 64>(x, y, z, x0, col0, d1, d2, st);
  if (hd == 256 && ny == 32)
    return (int)launch_wgmma_check<256, 32>(x, y, z, x0, col0, d1, d2, st);
  if (hd == 32 && ny == 128)
    return (int)launch_wgmma_check<32, 128>(x, y, z, x0, col0, d1, d2, st);
  if (hd == 128 && ny == 128)
    return (int)launch_wgmma_check<128, 128>(x, y, z, x0, col0, d1, d2, st);
  if (hd == 256 && ny == 64)
    return (int)launch_wgmma_check<256, 64>(x, y, z, x0, col0, d1, d2, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ts_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
