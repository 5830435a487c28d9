// Flash self-attention forward for Hopper: an f32 form, f32-accurate on
// the tensor cores (3xTF32 mma.sync), and a bf16 form (bf16 mma.sync with
// f32 sums, below flash_fwd_bf16_kernel) for the transformer under
// compute_dtype=bfloat16, whose JAX package hands the library kernel bf16
// q, k and v.
//
// Replaces the library Pallas kernel the JAX package's transformer calls
// for self-attention: `flash_attention` of jax.experimental.pallas.ops.tpu
// (called at textsummarization_on_flink_tpu/models/transformer.py:285),
// whose forward is `_flash_attention_kernel` (flash_attention.py:331 of
// the installed jax) through `pl.pallas_call` (:758).  Per article b,
// head h and query row i (q, k, v, out are [B, T, nh, hd], contiguous):
//
//   s_j   = (q_i . k_j) * sm_scale   for every key j the row may attend:
//           key_mask[b, j] > 0 (all keys when key_mask is null) and, when
//           causal, j <= i
//   out_i = sum_j softmax(s)_j v_j   (zeros when the row may attend none)
//
// That is the einsum path of transformer.py `_mha` (:149-180) on every
// row; padding query rows attend the real keys, as there.
//
// Training also asks for each row's log-sum-exp of its attended scores,
// lse_i = m_i + log(l_i) ([B, T, nh]; +inf for a row with no key to
// attend), which the backward kernels (flash_attention_bwd.cu) recompute
// the probabilities from.  With a null `lse` the kernel is the serving
// kernel and writes nothing else.
//
// What bounds it on an H100: operations.  The two products are
// 4 * hd operations per (row, head, attended key): 2.6 GFLOP at the
// encoder's shape (16 articles x 400 positions x 8 heads x hd 32), 16 us
// at 165 TFLOP/s (the TF32 tensor-core rate, 495 TFLOP/s, over the three
// products of 3xTF32), against 26 MB of q, k, v and out (7.8 us at
// 3.35 TB/s).  The design, FlashAttention-2 style:
//
//   * one block per (64 query rows, head, article): 4 warps of 16 rows.
//     At hd 32 a warp's q rows stay in registers for the whole loop,
//     split to hi/lo once; at hd 128 and 256 (where O alone takes 64
//     registers) q is staged in shared memory and split at use;
//   * at hd 256 the output's columns are split over two blocks (the
//     grid's y axis holds head x half): each block forms S over the full
//     head dim, and keeps and writes only its 128 columns of O, so its
//     registers are hd 128's, at the cost of forming S twice;
//   * key/value tiles (64 keys at hd 32, 16 at hd 128 and 256) are staged in
//     shared memory by cp.async, double-buffered, rows padded by 4
//     floats so the fragment loads are free of bank conflicts, and split
//     to hi/lo once by the block (mma_tf32x3.cuh, split_tile);
//   * S = Q K^T and O += P V are m16n8k8 tensor-core products in 3xTF32
//     (mma_tf32x3.cuh).  The mask and the online softmax run on S's
//     accumulator fragment: each lane holds two rows, the row max and sum
//     are reduced over the 4 lanes of a quad with shuffles, and P feeds
//     P V from the same registers in a permuted key order (a_from_acc /
//     load_b_perm), with no shuffle;
//   * a key the row may not attend gets s = -inf, so p = exp(-inf - m) is
//     exactly 0 (m never drops below -1e30): a ragged tail or an empty
//     article adds nothing, and a row whose sum stays 0 writes zeros; a
//     tile none of whose keys is real and unmasked is skipped whole;
//   * causal: tiles of keys past the block's last row are not loaded, the
//     diagonal test runs only on tiles that cross the diagonal, a warp
//     skips a tile that lies wholly past its last row, and the blocks
//     with the most tiles are started first.
//
// The products are f32-accurate (mma_tf32x3.cuh); softmax, rescaling and
// the final division are f32 with expf and logf (no fast math).  The
// result differs from the plain version by the order of sums and about
// one f32 rounding per product.  wgmma (its tf32 B operand must be
// K-major, which V is not) and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry points (one per
// dtype, and the bf16 fragment check of the card tests) bound with ctypes
// from ops/flash_attention.py.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using tf32x3::FragA;

constexpr float kNeg = -1e30f;  // running-max floor, never -inf
constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 64;       // query rows per block, 16 per warp

// At hd 32 a warp's q rows live in registers, split to hi/lo once (32
// registers).  At hd 128 they would take 64 registers as f32 beside O's
// 64, and the kernel spilled; there q is staged in shared memory with the
// first tile and split at use, and tiles hold 16 keys so that two blocks
// still fit on an SM.  At hd 256 a block keeps half of O's columns (kOD),
// 64 registers as at hd 128; its shared memory (q, K and V tiles at the
// full 256) is 166,528 bytes, one block per SM.
template <int HD>
struct Fwd {
  static_assert(HD == 32 || HD == 128 || HD == 256, "built head dims");
  static constexpr bool kQInRegs = HD <= 64;
  static constexpr int kKeys = kQInRegs ? 64 : 16;  // keys per tile
  static constexpr int kStride = HD + 4;  // floats per shared row
  static constexpr int kKS = HD / 8;      // k-steps of Q K^T
  static constexpr int kNT = kKeys / 8;   // 8-key column tiles of S
  static constexpr int kSplit = HD > 128 ? 2 : 1;  // blocks per (rows, head)
  static constexpr int kOD = HD / kSplit;  // O's columns a block keeps
  static constexpr int kOT = kOD / 8;      // 8-wide column tiles of them
  // 8-key chunks of P per accumulator of O += P V: 32 keys (12 mma)
  static constexpr int kGroup = kNT < 4 ? kNT : 4;
  static constexpr int kTile = kKeys * kStride;  // floats of a K or V tile
  static constexpr int kStage = 2 * kTile + kKeys;  // K, V (hi after the
                                                    // split), key flags
  static constexpr int kQ = kQInRegs ? 0 : kRows * kStride;  // shared q
  // blocks per SM asked of ptxas.  At hd 128 shared memory allows only 2
  // anyway; an explicit 1 lets ptxas spend more registers than its own
  // choice (217 against 128, no spills), which ran faster on the card.
  static constexpr int kMinBlocks = kQInRegs ? 3 : 1;
  // two stages, the lo parts of the current K and V tiles, q at hd 128
  static constexpr size_t kSmem =
      (2 * kStage + 2 * kTile + kQ) * sizeof(float);
  static_assert(kTile % 4 == 0 && kStage % 4 == 0, "16-byte aligned tiles");
};

// grid (ceil(T / kRows), nh * kSplit, B); kThreads threads; Fwd<HD>::kSmem
// bytes of dynamic shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads, Fwd<HD>::kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ key_mask, float* __restrict__ out,
                 float* __restrict__ lse, int T, int nh, int causal,
                 float sm_scale) {
  using S = Fwd<HD>;
  constexpr int kKeys = S::kKeys, kStride = S::kStride;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // causal: the last query blocks have the most key tiles; start them first
  const int qb = causal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int h = blockIdx.y / S::kSplit, b = blockIdx.z;
  const int col0 = (blockIdx.y % S::kSplit) * S::kOD;  // O's first column
  const size_t pos_stride = (size_t)nh * HD;  // floats between positions
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * HD;
  const float* kb = k + base;
  const float* vb = v + base;
  const int row0 = qb * kRows + warp * 16;  // the warp's first row
  const int rows[2] = {row0 + g, row0 + g + 8};  // this lane's two rows

  // the warp's q rows as A fragments: split once into registers, or (hd
  // 128) read from the shared q tile and split at use
  float* q_s = smem + 2 * S::kStage + 2 * S::kTile;
  const float* q_warp = q_s + warp * 16 * kStride;
  FragA q_reg[S::kQInRegs ? S::kKS : 1];
  if constexpr (S::kQInRegs) {
    const bool in0 = rows[0] < T, in1 = rows[1] < T;
    const float* q0 = q + base + (size_t)rows[0] * pos_stride;
    const float* q1 = q + base + (size_t)rows[1] * pos_stride;
#pragma unroll
    for (int ks = 0; ks < S::kKS; ++ks) {
      const int c = 8 * ks + t;
      q_reg[ks] = tf32x3::split_a(in0 ? q0[c] : 0.f, in1 ? q1[c] : 0.f,
                                  in0 ? q0[c + 4] : 0.f,
                                  in1 ? q1[c + 4] : 0.f);
    }
  }
  auto q_frag = [&](int kk) -> FragA {
    if constexpr (S::kQInRegs)
      return q_reg[kk];
    else
      return tf32x3::load_a(q_warp + 8 * kk, kStride, g, t);
  };
  float o[S::kOT][4];
#pragma unroll
  for (int n = 0; n < S::kOT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this lane's columns

  // causal: keys past the block's last row are never attended
  const int t_end = causal ? min(T, (qb + 1) * kRows) : T;  // block-uniform
  const int n_tiles = (t_end + kKeys - 1) / kKeys;

  auto stage = [&](int tile, int buf) {
    float* ks = smem + buf * S::kStage;
    float* vs = ks + S::kTile;
    float* oks = vs + S::kTile;
    const int k0 = tile * kKeys;
    tf32x3::stage_rows<HD, kThreads>(ks, kStride, kb, pos_stride, k0, kKeys,
                                     T, tid);
    tf32x3::stage_rows<HD, kThreads>(vs, kStride, vb, pos_stride, k0, kKeys,
                                     T, tid);
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
  if (!S::kQInRegs)  // in the first group, with the first tile
    tf32x3::stage_rows<HD, kThreads>(q_s, kStride, q + base, pos_stride,
                                     qb * kRows, kRows, T, tid);
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
    // each thread splits the chunks it copied; then the whole tile is
    // split and has landed for every warp.  The barrier also tells the
    // block whether any key of the tile is real and unmasked (thread j
    // wrote flag j): a wholly masked tile adds nothing and is skipped.
    tf32x3::split_tile<HD, kThreads>(ks, k_lo, kStride, kKeys, tid);
    tf32x3::split_tile<HD, kThreads>(vs, v_lo, kStride, kKeys, tid);
    const bool any_key = __syncthreads_or(tid < kKeys && oks[tid] > 0.f);

    const int k0 = it * kKeys;
    // causal: a warp whose last row precedes the tile attends none of it
    if (any_key && (!causal || k0 <= row0 + 15)) {
      // V's columns of this block's part of O
      const tf32x3::SplitTile kt{ks, k_lo}, vt{vs + col0, v_lo + col0};
      // S = Q K^T
      float s[S::kNT][4];
      tf32x3::head_dim_product<S::kNT, S::kKS>(s, q_frag, kt, kStride, g, t);

      // mask, scale and the tile's row max over this lane's columns
      const bool diag = causal && k0 + kKeys - 1 > qb * kRows;
      float cmax[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < S::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int r = e >> 1;
          const bool ok = oks[col] > 0.f && (!diag || k0 + col <= rows[r]);
          s[j][e] = ok ? s[j][e] * sm_scale : -INFINITY;
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
      for (int j = 0; j < S::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m[e >> 1]);  // masked: exactly 0
          s[j][e] = p;
          l[e >> 1] += p;
        }
      }

      // O += P V
      tf32x3::tile_product<S::kNT, S::kOT, S::kGroup>(o, s, vt, kStride, g,
                                                      t);
    }
    __syncthreads();  // every warp is done with buffer it & 1 and the lo
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T) continue;
    float* o_row = out + base + (size_t)rows[r] * pos_stride;
#pragma unroll
    for (int n = 0; n < S::kOT; ++n) {
      float2 val = make_float2(0.f, 0.f);
      if (l[r] > 0.f)
        val = make_float2(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
      *reinterpret_cast<float2*>(o_row + col0 + 8 * n + 2 * t) = val;
    }
    if (lse != nullptr && t == 0 && col0 == 0)  // one block of a split
      lse[((size_t)b * T + rows[r]) * nh + h] =
          l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* key_mask, float* out, float* lse, int B,
                   int T, int nh, int causal, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Fwd<HD>::kSmem;
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_fwd_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kRows - 1) / kRows, nh * Fwd<HD>::kSplit, B);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, key_mask, out, lse, T, nh, causal, sm_scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The bf16 form: q, k, v and out in bf16, lse in f32.
//
// The library kernel's arithmetic for bf16 operands
// (_flash_attention_kernel, flash_attention.py:396 and :471): S from bf16
// q and k with f32 sums, the online softmax in f32, P = exp(S - m) rounded
// to bf16 before P V, whose sums are f32, l summed from the unrounded P,
// the output divided by l and rounded once to bf16.  The products are
// m16n8k16 bf16 mma.sync (mma_bf16.cuh): a product of bf16 values is
// exact and the tensor core sums in f32, so no f32 accuracy trick is
// needed.  The design is the f32 form's with bf16 tiles:
//
//   * one block per (64 query rows, head, article), 4 warps of 16 rows;
//     the block's q rows are staged in shared memory with the first tile
//     and each warp loads its A fragments with ldmatrix at use;
//   * K and V tiles of 64 keys (32 at hd 256) are staged by cp.async at
//     16 bytes, double-buffered, rows padded by 8 bf16 so that ldmatrix
//     is free of bank conflicts; K's B fragments come from ldmatrix, V's
//     from ldmatrix.trans (V row-major is P V's B operand transposed);
//   * P goes from S's accumulator registers to P V's A fragment, rounded
//     to bf16, without a shuffle (a_from_acc);
//   * the mask, the -1e30 running-max floor, +inf lse for a row with no
//     key, zeros out for such a row, the skipped empty tiles and the
//     causal skips are the f32 form's;
//   * at hd 256 the output's columns are split over two blocks, as in
//     the f32 form: a block keeps 128 columns of O (64 registers).
//
// What bounds it on an H100: operations, as the f32 form, but at the
// dense bf16 rate (989 TFLOP/s): 2.6 GFLOP at the encoder's shape is
// 2.7 us, against 13 MB of bf16 q, k, v and out (3.9 us at 3.35 TB/s), so
// at that shape the bytes bound it.  wgmma and TMA are later work.

template <int HD>
struct FwdBf16 {
  static_assert(HD == 32 || HD == 128 || HD == 256, "built head dims");
  static constexpr int kKeys = HD > 128 ? 32 : 64;  // keys per tile
  static constexpr int kStride = HD + 8;  // bf16 per shared row
  static constexpr int kNT = kKeys / 8;   // 8-key column tiles of S
  static constexpr int kSplit = HD > 128 ? 2 : 1;  // blocks per (rows, head)
  static constexpr int kOD = HD / kSplit;  // O's columns a block keeps
  static constexpr int kOT = kOD / 8;      // 8-wide column tiles of them
  static constexpr int kTile = kKeys * kStride;  // bf16 of a K or V tile
  static constexpr int kQ = kRows * kStride;     // bf16 of the q tile
  // per stage: K, V, then kKeys f32 key flags
  static constexpr size_t kStageBytes = 2 * kTile * 2 + kKeys * 4;
  static constexpr size_t kSmem = kQ * 2 + 2 * kStageBytes;
  static_assert(kTile % 8 == 0 && kQ % 8 == 0, "16-byte aligned tiles");
};

// grid (ceil(T / kRows), nh * kSplit, B); kThreads threads;
// FwdBf16<HD>::kSmem bytes of dynamic shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16mma::bf16* __restrict__ q,
                      const bf16mma::bf16* __restrict__ k,
                      const bf16mma::bf16* __restrict__ v,
                      const float* __restrict__ key_mask,
                      bf16mma::bf16* __restrict__ out,
                      float* __restrict__ lse, int T, int nh, int causal,
                      float sm_scale) {
  using S = FwdBf16<HD>;
  using bf16mma::bf16;
  constexpr int kKeys = S::kKeys, kStride = S::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* stages = smem_raw + S::kQ * 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // causal: the last query blocks have the most key tiles; start them first
  const int qb = causal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int h = blockIdx.y / S::kSplit, b = blockIdx.z;
  const int col0 = (blockIdx.y % S::kSplit) * S::kOD;  // O's first column
  const size_t pos_stride = (size_t)nh * HD;  // elements between positions
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * HD;
  const int row0 = qb * kRows + warp * 16;  // the warp's first row
  const int rows[2] = {row0 + g, row0 + g + 8};  // this lane's two rows
  const bf16* q_warp = q_s + warp * 16 * kStride;
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    bf16mma::load_a(a, q_warp + 16 * kk, kStride, lane);
  };

  float o[S::kOT][4];
#pragma unroll
  for (int n = 0; n < S::kOT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this lane's columns

  // causal: keys past the block's last row are never attended
  const int t_end = causal ? min(T, (qb + 1) * kRows) : T;  // block-uniform
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

  // q in the first group, with the first tile
  bf16mma::stage_rows<HD, kThreads>(q_s, kStride, q + base, pos_stride,
                                    qb * kRows, kRows, T, tid);
  stage(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1, (it + 1) & 1);  // its buffer was freed at it - 1's end
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    const bf16* ks =
        reinterpret_cast<const bf16*>(stages + (it & 1) * S::kStageBytes);
    const bf16* vs = ks + S::kTile;
    const float* oks = reinterpret_cast<const float*>(vs + S::kTile);
    // the tile (and q) has landed for every warp; the barrier also tells
    // the block whether any key of the tile is real and unmasked
    const bool any_key = __syncthreads_or(tid < kKeys && oks[tid] > 0.f);

    const int k0 = it * kKeys;
    // causal: a warp whose last row precedes the tile attends none of it
    if (any_key && (!causal || k0 <= row0 + 15)) {
      // S = Q K^T
      float s[S::kNT][4];
      bf16mma::head_dim_product<S::kNT, HD>(s, q_frag, ks, kStride, lane);

      // mask, scale and the tile's row max over this lane's columns
      const bool diag = causal && k0 + kKeys - 1 > qb * kRows;
      float cmax[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < S::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int r = e >> 1;
          const bool ok = oks[col] > 0.f && (!diag || k0 + col <= rows[r]);
          s[j][e] = ok ? s[j][e] * sm_scale : -INFINITY;
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
      for (int j = 0; j < S::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m[e >> 1]);  // masked: exactly 0
          s[j][e] = p;
          l[e >> 1] += p;  // the unrounded P, as the library sums it
        }
      }

      // O += P V, P rounded to bf16 on its way to the A operand; V's
      // columns of this block's part of O
      bf16mma::tile_product<S::kNT, S::kOT>(o, s, vs + col0, kStride, lane);
    }
    __syncthreads();  // every warp is done with buffer it & 1
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T) continue;
    bf16* o_row = out + base + (size_t)rows[r] * pos_stride + col0;
#pragma unroll
    for (int n = 0; n < S::kOT; ++n) {
      const uint32_t val = l[r] > 0.f
          ? bf16mma::pack(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r])
          : 0u;
      *reinterpret_cast<uint32_t*>(o_row + 8 * n + 2 * t) = val;
    }
    if (lse != nullptr && t == 0 && col0 == 0)  // one block of a split
      lse[((size_t)b * T + rows[r]) * nh + h] =
          l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
  }
}

template <int HD>
cudaError_t launch_bf16(const bf16mma::bf16* q, const bf16mma::bf16* k,
                        const bf16mma::bf16* v, const float* key_mask,
                        bf16mma::bf16* out, float* lse, int B, int T, int nh,
                        int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = FwdBf16<HD>::kSmem;
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_fwd_bf16_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kRows - 1) / kRows, nh * FwdBf16<HD>::kSplit, B);
  flash_fwd_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, key_mask, out, lse, T, nh, causal, sm_scale);
  return cudaGetLastError();
}

// One warp: C1 = A B from B stored row-major [k][n] (ldmatrix.trans) and
// C2 = A B from B^T stored row-major [n][k] (ldmatrix), A [16][16], B
// [16][16] bf16, C [16][16] f32 row-major: the m16n8k16 fragment layouts
// of mma_bf16.cuh held against a plain product by a card test.
__global__ void mma_bf16_check_kernel(const bf16mma::bf16* __restrict__ a,
                                      const bf16mma::bf16* __restrict__ b,
                                      float* __restrict__ c1,
                                      float* __restrict__ c2) {
  using bf16mma::bf16;
  constexpr int kStride = 16 + 8;
  __shared__ __align__(16) unsigned short raw[3][16 * kStride];
  const unsigned short* a16 = reinterpret_cast<const unsigned short*>(a);
  const unsigned short* b16 = reinterpret_cast<const unsigned short*>(b);
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  for (int i = lane; i < 256; i += 32) {
    const int r = i / 16, c = i % 16;
    raw[0][r * kStride + c] = a16[i];
    raw[1][r * kStride + c] = b16[i];
    raw[2][c * kStride + r] = b16[i];  // B^T
  }
  __syncwarp();
  const bf16* as = reinterpret_cast<const bf16*>(raw[0]);
  const bf16* bs = reinterpret_cast<const bf16*>(raw[1]);
  const bf16* bts = reinterpret_cast<const bf16*>(raw[2]);
  uint32_t af[4], bt[2][2], bn[2][2];
  bf16mma::load_a(af, as, kStride, lane);
  bf16mma::load_b_trans(bt, bs, kStride, lane);
  bf16mma::load_b_t(bn, bts, kStride, lane);
  float d1[2][4] = {}, d2[2][4] = {};
  for (int j = 0; j < 2; ++j) {
    bf16mma::mma(d1[j], af, bt[j][0], bt[j][1]);
    bf16mma::mma(d2[j], af, bn[j][0], bn[j][1]);
  }
  for (int j = 0; j < 2; ++j)
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      c1[r * 16 + c] = d1[j][e];
      c2[r * 16 + c] = d2[j][e];
    }
}
}  // namespace

// q, k, v, out [B, T, nh, hd] float32, contiguous, 16-byte aligned, on one
// device; key_mask [B, T] float32 (1 = real token) or null (every key
// real); lse [B, T, nh] float32 or null (not written).  hd is 32, 128 or
// 256.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int ts_flash_attention(const float* q, const float* k,
                                  const float* v, const float* key_mask,
                                  float* out, float* lse, int B, int T,
                                  int nh, int hd, int causal, float sm_scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || nh <= 0 || B > 65535 || nh > 32767)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch<32>(q, k, v, key_mask, out, lse, B, T, nh, causal,
                             sm_scale, st);
    case 128:
      return (int)launch<128>(q, k, v, key_mask, out, lse, B, T, nh,
                              causal, sm_scale, st);
    case 256:
      return (int)launch<256>(q, k, v, key_mask, out, lse, B, T, nh,
                              causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 form: q, k, v, out [B, T, nh, hd] bfloat16, contiguous,
// 16-byte aligned; key_mask and lse as ts_flash_attention's.
extern "C" int ts_flash_attention_bf16(const void* q, const void* k,
                                       const void* v, const float* key_mask,
                                       void* out, float* lse, int B, int T,
                                       int nh, int hd, int causal,
                                       float sm_scale, void* stream) {
  using bf16mma::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || nh <= 0 || B > 65535 || nh > 32767)
    return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  switch (hd) {
    case 32:
      return (int)launch_bf16<32>(qb, kb, vb, key_mask, ob, lse, B, T, nh,
                                  causal, sm_scale, st);
    case 128:
      return (int)launch_bf16<128>(qb, kb, vb, key_mask, ob, lse, B, T, nh,
                                   causal, sm_scale, st);
    case 256:
      return (int)launch_bf16<256>(qb, kb, vb, key_mask, ob, lse, B, T, nh,
                                   causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// a, b [16][16] bfloat16 and c1, c2 [16][16] float32 on the device: one
// warp's fragment check (mma_bf16_check_kernel)
extern "C" int ts_flash_mma_bf16_check(const void* a, const void* b,
                                       float* c1, float* c2, void* stream) {
  mma_bf16_check_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16mma::bf16*>(a),
      static_cast<const bf16mma::bf16*>(b), c1, c2);
  return (int)cudaGetLastError();
}

extern "C" const char* ts_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
