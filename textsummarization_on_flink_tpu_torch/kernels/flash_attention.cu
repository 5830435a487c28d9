// Flash self-attention forward for Hopper: an f32 form, f32-accurate on
// the tensor cores (3xTF32 mma.sync), and a bf16 form (wgmma on tiles the
// TMA unit copies, with f32 sums; below flash_fwd_bf16_kernel) for the
// transformer under compute_dtype=bfloat16, whose JAX package hands the
// library kernel bf16 q, k and v.
//
// Replaces the library Pallas kernel the JAX package's transformer calls
// for self-attention: `flash_attention` of jax.experimental.pallas.ops.tpu
// (called at textsummarization_on_flink_tpu/models/transformer.py:285),
// whose forward is `_flash_attention_kernel` (flash_attention.py:331 of
// the installed jax) through `pl.pallas_call` (:758).  Per article b,
// head h and query row i (q and out are [B, Tq, nh, hd], k and v [B, Tk,
// nh, hd], contiguous; Tq < Tk is one sp rank's block of query rows
// against every key, and needs causal off):
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
// lse_i = m_i + log(l_i) ([B, Tq, nh]; +inf for a row with no key to
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
// dtype) bound with ctypes from ops/flash_attention.py.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using namespace flash_bf16;

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

// grid (ceil(Tq / kRows), nh * kSplit, B); kThreads threads; Fwd<HD>::kSmem
// bytes of dynamic shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads, Fwd<HD>::kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ key_mask, float* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Tk, int nh,
                 int causal, float sm_scale) {
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
  // q and out hold Tq positions an article, k and v Tk
  const size_t base = (size_t)b * Tq * pos_stride + (size_t)h * HD;
  const float* kb = k + (size_t)b * Tk * pos_stride + (size_t)h * HD;
  const float* vb = v + (size_t)b * Tk * pos_stride + (size_t)h * HD;
  const int row0 = qb * kRows + warp * 16;  // the warp's first row
  const int rows[2] = {row0 + g, row0 + g + 8};  // this lane's two rows

  // the warp's q rows as A fragments: split once into registers, or (hd
  // 128) read from the shared q tile and split at use
  float* q_s = smem + 2 * S::kStage + 2 * S::kTile;
  const float* q_warp = q_s + warp * 16 * kStride;
  FragA q_reg[S::kQInRegs ? S::kKS : 1];
  if constexpr (S::kQInRegs) {
    const bool in0 = rows[0] < Tq, in1 = rows[1] < Tq;
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

  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, (qb + 1) * kRows) : Tk;  // block-uniform
  const int n_tiles = (t_end + kKeys - 1) / kKeys;

  auto stage = [&](int tile, int buf) {
    float* ks = smem + buf * S::kStage;
    float* vs = ks + S::kTile;
    float* oks = vs + S::kTile;
    const int k0 = tile * kKeys;
    tf32x3::stage_rows<HD, kThreads>(ks, kStride, kb, pos_stride, k0, kKeys,
                                     Tk, tid);
    tf32x3::stage_rows<HD, kThreads>(vs, kStride, vb, pos_stride, k0, kKeys,
                                     Tk, tid);
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
  if (!S::kQInRegs)  // in the first group, with the first tile
    tf32x3::stage_rows<HD, kThreads>(q_s, kStride, q + base, pos_stride,
                                     qb * kRows, kRows, Tq, tid);
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
    if (rows[r] >= Tq) continue;
    float* o_row = out + base + (size_t)rows[r] * pos_stride;
#pragma unroll
    for (int n = 0; n < S::kOT; ++n) {
      float2 val = make_float2(0.f, 0.f);
      if (l[r] > 0.f)
        val = make_float2(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
      *reinterpret_cast<float2*>(o_row + col0 + 8 * n + 2 * t) = val;
    }
    if (lse != nullptr && t == 0 && col0 == 0)  // one block of a split
      lse[((size_t)b * Tq + rows[r]) * nh + h] =
          l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* key_mask, float* out, float* lse, int B,
                   int Tq, int Tk, int nh, int causal, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Fwd<HD>::kSmem;
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_fwd_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kRows - 1) / kRows, nh * Fwd<HD>::kSplit, B);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, key_mask, out, lse, Tq, Tk, nh, causal, sm_scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The bf16 form: q, k, v and out in bf16, lse in f32.
//
// The library kernel's arithmetic for bf16 operands
// (_flash_attention_kernel, flash_attention.py:396 and :471): S from bf16
// q and k with f32 sums, the mask, scale and online softmax in f32, P =
// exp(S - m) rounded to bf16 only on its way into P V, whose sums are f32,
// l summed from the unrounded P, the output divided by l and rounded once
// to bf16.  A product of bf16 values is exact and the tensor core sums in
// f32, so no accuracy trick is needed.
//
// What bounds it on an H100: operations at the dense bf16 rate (989
// TFLOP/s), 4 * hd per attended pair: 0.0348 ms at 4 x 2048 x 8 x 128
// causal, 0.0398 ms with a key mask.  At the encoder's 16 x 400 x 8 x 32
// the 13 MB of bf16 q, k, v and out (3.9 us at 3.35 TB/s) bound it.
//
// The design (Hopper's, the bf16 dQ kernel's geometry; flash_bf16.cuh,
// wgmma_bf16.cuh): a block is two consumer warpgroups and a producer
// warpgroup (setmaxnreg 24/240, one block per SM) and owns 128 query rows,
// 64 per consumer warpgroup:
//
//   * the block's q tile is copied once by TMA into the 64- or 128-byte
//     swizzle of wg::Tile<HD>; the producer's lane 0 keeps K and V tiles
//     of kKeys keys in flight through a 2-stage ring behind full/empty
//     mbarriers, and its 32 lanes form each tile's words of key flags
//     (real and unmasked) with ballots, their key-mask loads issued before
//     the wait for the stage; a tile with no key to attend is not copied;
//   * S = Q K^T is wgmma from shared memory, both operands K-major; the
//     mask, the scale (times log2 e) and the online softmax run on S's
//     accumulator registers, where a thread holds rows g and g + 8 of its
//     warp's 16, as in mma.sync, so the row max and sum reduce over a
//     quad with two shuffles; O is rescaled by alpha in registers between
//     products; P goes to the A fragments in registers, rounded to bf16
//     (wg::a_frag), and O += P V is wgmma with V the M|N-major B operand;
//     exp is ex2 (one MUFU instruction) of log2 e-scaled scores against
//     the running max, which never drops below -1e30; lse goes back to
//     natural units with an accurate logf;
//   * a tile is 128 keys at hd 32 and 128 (64 at hd 256, whose q tile and
//     ring take 192 KB): at the tensor cores' peak an S product over 64
//     keys needs its A and B operands from shared memory at 128 bytes a
//     clock, the SM's whole rate, one over 128 keys at three quarters of
//     it, and a wider tile halves the ring's round trips;
//   * within a warpgroup the steps run in order (S, wait, softmax, P V,
//     wait); the two warpgroups take turns to issue S (named barriers 1
//     and 2), so one's softmax overlaps the other's products.  Each
//     product group (fence, products, commit, wait) lies inside one
//     branch: a group split over branches makes ptxas serialize every
//     wgmma (C7520);
//   * a key the row may not attend (a key flag, or past the diagonal) gets
//     p = exactly 0, so a ragged tail or an empty article adds nothing and
//     a row whose sum stays 0 writes zeros and lse +inf; padding query
//     rows attend the real keys; rows at or past Tq are zero-filled by the
//     copy and never stored.  At hd 128 and 256 a tile whose keys are all
//     real and that does not cross the diagonal skips the per-key test (at
//     hd 32 that second path made the decoder's shape slower);
//   * causal: tiles of keys past the block's last row are never loaded, a
//     warpgroup skips a tile all of whose keys follow its last row, only a
//     tile that crosses the diagonal tests it, and the query blocks are
//     the grid's slowest axis, last first, so that every head's blocks
//     with the most tiles start before any lighter one.  Without causal
//     they are its fastest, so that the blocks of one head run together
//     and read its K and V tiles from the L2 cache;
//   * head dim 256: the output's columns are split over two blocks (the
//     grid's head axis holds head x half), each forming S over the full 256
//     and keeping 128 columns of O, so the O accumulator is 64 registers
//     a thread at hd 128 and at hd 256; lse is written by the block of
//     the first half.  No atomics: two runs give the same bits.

template <int HD>
struct FwdBf16 : Split<HD> {
  using L = wg::Tile<HD>;
  static constexpr int kKeys = HD <= 128 ? 128 : 64;  // keys per tile
  static constexpr int kWords = kKeys / 64;  // key-flag words per tile
  static constexpr bool kWholeTiles = HD >= 128;  // the untested path
  static constexpr int kQ = L::bytes(kBlockRows);    // the q tile
  static constexpr int kTile = L::bytes(kKeys);      // a K or V tile
  // q, the stages' K and V tiles, their key-flag words, the barriers
  static constexpr int kMaskOff = kQ + 2 * kStages * kTile;
  static constexpr int kBarOff = kMaskOff + kStages * kWords * 8;
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

// named barriers 1 and 2 between the two consumer warpgroups: warpgroup
// w waits on 1 + w for its turn to issue S, then hands the turn over
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kWgThreads) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kWgThreads) : "memory");
}

// grid (nh * kSplit, B, ceil(Tq / 128)) when causal, else (ceil(Tq / 128),
// nh * kSplit, B); kBf16Threads threads, FwdBf16<HD>::kSmem bytes of
// dynamic shared memory; the maps' boxes are kBlockRows rows (q) and
// kKeys rows (k, v)
template <int HD>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const float* __restrict__ key_mask,
                      wg::bf16* __restrict__ out, float* __restrict__ lse,
                      int Tq, int Tk, int nh, int causal, float sm_scale) {
  using S = FwdBf16<HD>;
  constexpr int kKeys = S::kKeys, kOD = S::kOD, kWords = S::kWords;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* tiles = smem + S::kQ;  // stage s: K, then V
  uint64_t* flags = reinterpret_cast<uint64_t*>(smem + S::kMaskOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool producer = warp >= 4 * kWGs;
  // causal: the last query blocks have the most key tiles; start them first
  const int qb = causal ? (int)(gridDim.z - 1 - blockIdx.z) : (int)blockIdx.x;
  const int hx = causal ? blockIdx.x : blockIdx.y;  // head x half
  const int h = hx / S::kSplit, b = causal ? blockIdx.y : blockIdx.z;
  const int col0 = (hx % S::kSplit) * kOD;
  const int r_blk = qb * kBlockRows;        // the block's first row
  const int rw = r_blk + 64 * (warp >> 2);  // the warpgroup's first row
  // causal (Tq == Tk): keys past the block's last row are never attended
  const int t_end = causal ? min(Tk, r_blk + kBlockRows) : Tk;
  const int n_tiles = (t_end + kKeys - 1) / kKeys;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::mbar_init(&full[s], 32);
      tma::mbar_init(&empty[s], kWgThreads);
    }
    tma::mbar_init(q_bar, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();

  set_regs(producer);
  if (producer) {
    if (warp != 4 * kWGs) return;
    if (lane == 0) {
      tma::mbar_arrive_tx(q_bar, S::kQ);
      wg::load_tile<HD>(qs, &q_map, kBlockRows, r_blk, h, b, q_bar);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = it * kKeys;
      // key k0 + 32 j + lane is real and unmasked; loaded before the wait
      bool ok[kKeys / 32];
#pragma unroll
      for (int j = 0; j < kKeys / 32; ++j) {
        const int key = k0 + 32 * j + lane;
        ok[j] = key < Tk && (key_mask == nullptr ||
                             key_mask[(size_t)b * Tk + key] > 0.f);
      }
      tma::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      uint64_t bits[kWords] = {};  // bit j of word w: key k0 + 64 w + j
#pragma unroll
      for (int j = 0; j < kKeys / 32; ++j)
        bits[j / 2] |= (uint64_t)__ballot_sync(0xffffffffu, ok[j])
                       << (32 * (j % 2));
      uint64_t any = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) any |= bits[w];
      unsigned char* ks = tiles + s * 2 * S::kTile;
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) flags[s * kWords + w] = bits[w];
        if (any != 0) {  // a tile with no key to attend is not copied
          tma::mbar_arrive_tx(&full[s], 2 * S::kTile);
          wg::load_tile<HD>(ks, &k_map, kKeys, k0, h, b, &full[s]);
          wg::load_tile<HD>(ks + S::kTile, &v_map, kKeys, k0, h, b,
                            &full[s]);
        } else {
          tma::mbar_arrive(&full[s]);
        }
      } else {
        tma::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int wgi = warp >> 2;  // the consumer warpgroup
  const int row0 = 64 * wgi;  // its rows of the q tile
  const int q_row = rw + 16 * (warp & 3) + g;
  const int rows[2] = {q_row, q_row + 8};  // this thread's rows of O
  const float scale_l2 = sm_scale * kLog2e;
  float oa[kOD / 2];
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) oa[i] = 0.f;
  // running max (log2 units) and this thread's columns' sum, per row
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  if (wgi == 1) turn_arrive(1);  // warpgroup 0 issues first
  tma::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    tma::mbar_wait(&full[s], (it / kStages) & 1);
    const int k0 = it * kKeys;
    uint64_t bits_t[kWords];  // bit 8 i + e of word i / 8: key c below
    uint64_t any = 0, all = ~0ull;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint64_t word = flags[s * kWords + w];
      any |= word;
      all &= word;
      bits_t[w] = word >> (2 * t);
    }
    turn_sync(1 + wgi);
    // causal: every key of the tile follows the warpgroup's last row
    if (any != 0 && rw < Tq && !(causal && k0 > rw + 63)) {
      const unsigned char* ks = tiles + s * 2 * S::kTile;
      const unsigned char* vs = ks + S::kTile;
      float sa[kKeys / 2];  // S, then P
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wg::Mma<kKeys>::ss(sa, wg::desc_k<HD>(qs, kBlockRows, row0, kk),
                           wg::desc_k<HD>(ks, kKeys, 0, kk), kk > 0);
      wg::commit();
      turn_arrive(2 - wgi);
      wg::wait<0>();
      wg::keep(sa);
      // mask and scale (log2 units), the tile's max over this thread's
      // columns
      const bool diag = causal && k0 + kKeys - 1 > rw;
      float cmax[2] = {kNeg, kNeg};
      if (S::kWholeTiles && !diag && all == ~0ull) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          sa[i] *= scale_l2;
          cmax[(i >> 1) & 1] = fmaxf(cmax[(i >> 1) & 1], sa[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = 8 * i + 2 * t + (e & 1);
            const bool ok =
                ((bits_t[i / 8] >> (8 * (i % 8) + (e & 1))) & 1) &&
                (!diag || k0 + c <= rows[r]);
            const float x = ok ? sa[4 * i + e] * scale_l2 : -INFINITY;
            sa[4 * i + e] = x;
            cmax[r] = fmaxf(cmax[r], x);
          }
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
      for (int i = 0; i < kOD / 2; ++i) oa[i] *= alpha[(i >> 1) & 1];
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
        wg::Mma<kOD>::rs(oa, pf[kk], wg::desc_mn<HD>(vs, kKeys, kk, col0),
                         1);
      wg::commit();
      wg::wait<0>();
      wg::keep(oa);
      wg::keep(pf);
    } else {
      turn_arrive(2 - wgi);
    }
    tma::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) {
    const float li = l[(i >> 1) & 1];
    oa[i] = li > 0.f ? oa[i] / li : 0.f;  // no key to attend: zeros
  }
  const size_t pos_stride = (size_t)nh * HD;
  store_rows<kOD>(out + (size_t)b * Tq * pos_stride + (size_t)h * HD + col0,
                  pos_stride, rows, Tq, oa, t);
  if (lse != nullptr && t == 0 && col0 == 0) {  // one block of a split
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < Tq)
        lse[((size_t)b * Tq + rows[r]) * nh + h] =
            l[r] > 0.f ? m[r] / kLog2e + logf(l[r]) : INFINITY;
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const float* key_mask, void* out, float* lse, int B,
                        int Tq, int Tk, int nh, int causal, float sm_scale,
                        cudaStream_t stream) {
  using S = FwdBf16<HD>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {kBlockRows, S::kKeys, S::kKeys};
  const int lens[3] = {Tq, Tk, Tk};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err =
        wg::make_map(&maps[i], ptrs[i], B, lens[i], nh, HD, rows[i]);
    if (err != cudaSuccess) return err;
  }
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_fwd_bf16_kernel<HD>, S::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const int n_qb = (Tq + kBlockRows - 1) / kBlockRows;
  const dim3 grid = causal ? dim3(nh * S::kSplit, B, n_qb)
                           : dim3(n_qb, nh * S::kSplit, B);
  flash_fwd_bf16_kernel<HD><<<grid, kBf16Threads, S::kSmem, stream>>>(
      maps[0], maps[1], maps[2], key_mask, static_cast<wg::bf16*>(out), lse,
      Tq, Tk, nh, causal, sm_scale);
  return cudaGetLastError();
}
}  // namespace

// q and out [B, Tq, nh, hd], k and v [B, Tk, nh, hd] float32, contiguous,
// 16-byte aligned, on one device; key_mask [B, Tk] float32 (1 = real
// token) or null (every key real); lse [B, Tq, nh] float32 or null (not
// written).  hd is 32, 128 or 256; causal needs Tq == Tk.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int ts_flash_attention(const float* q, const float* k,
                                  const float* v, const float* key_mask,
                                  float* out, float* lse, int B, int Tq,
                                  int Tk, int nh, int hd, int causal,
                                  float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Tq <= 0 || Tk <= 0 || nh <= 0 || B > 65535 || nh > 32767 ||
      (causal && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch<32>(q, k, v, key_mask, out, lse, B, Tq, Tk, nh,
                             causal, sm_scale, st);
    case 128:
      return (int)launch<128>(q, k, v, key_mask, out, lse, B, Tq, Tk, nh,
                              causal, sm_scale, st);
    case 256:
      return (int)launch<256>(q, k, v, key_mask, out, lse, B, Tq, Tk, nh,
                              causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 form: q, out [B, Tq, nh, hd] and k, v [B, Tk, nh, hd]
// bfloat16, contiguous, 16-byte aligned; key_mask and lse as
// ts_flash_attention's.
extern "C" int ts_flash_attention_bf16(const void* q, const void* k,
                                       const void* v, const float* key_mask,
                                       void* out, float* lse, int B, int Tq,
                                       int Tk, int nh, int hd, int causal,
                                       float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Tq <= 0 || Tk <= 0 || nh <= 0 || B > 65535 || nh > 32767 ||
      (causal && Tq != Tk) ||
      (Tq - 1) / kBlockRows >= 65535)  // the grid's z axis: query blocks
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch_bf16<32>(q, k, v, key_mask, out, lse, B, Tq, Tk, nh,
                                  causal, sm_scale, st);
    case 128:
      return (int)launch_bf16<128>(q, k, v, key_mask, out, lse, B, Tq, Tk,
                                   nh, causal, sm_scale, st);
    case 256:
      return (int)launch_bf16<256>(q, k, v, key_mask, out, lse, B, Tq, Tk,
                                   nh, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ts_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
