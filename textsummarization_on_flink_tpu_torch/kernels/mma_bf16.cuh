// bf16 tensor-core products for the flash forward's bf16 form (the
// backward's run on wgmma_bf16.cuh):
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` with f32
// accumulators, fragments loaded with `ldmatrix`, tiles staged with
// cp.async.
//
// A product of two bf16 values is exact in f32 and the tensor core sums
// in f32, so this is the JAX package's arithmetic for bf16 operands
// (jnp.einsum of bf16 arrays with preferred_element_type=f32): no operand
// is rounded beyond what the caller handed in.  The f32 forms keep 3xTF32
// (mma_tf32x3.cuh).
//
// Fragment layouts of m16n8k16 (bf16 A and B, f32 C), for lane = 4*g + t
// (g = lane / 4 in 0..7, t = lane % 4); each A and B register holds two
// bf16, the lower column (A) or row (B) in its low half:
//
//   A (16 x 16, row): a0 = A[g][2t, 2t+1]     a1 = A[g+8][2t, 2t+1]
//                     a2 = A[g][2t+8, 2t+9]   a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, col):  b0 = B[2t, 2t+1][g]     b1 = B[2t+8, 2t+9][g]
//   C (16 x 8, f32):  c0 = C[g][2t]   c1 = C[g][2t+1]
//                     c2 = C[g+8][2t] c3 = C[g+8][2t+1]
//
// Two C fragments side by side (columns 0-7 and 8-15) are, rounded to
// bf16 and packed in pairs, exactly the A fragment of a 16 x 16 block
// (`a_from_acc`): P goes from its accumulators to the next product in
// registers, with no shuffle and no shared-memory trip.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices from shared memory, lane l
// giving the address of one 16-byte row (lanes 8m .. 8m+7: the rows of
// matrix m); lane 4g + t receives row g, columns 2t and 2t+1 of each, or
// with .trans the transpose: rows 2t and 2t+1 of column g.  So, for a
// row-major tile M in shared memory:
//
//   * load_a: the A fragment of the 16 x 16 block of M (Q rows as the
//     left operand);
//   * load_b_t: the B fragments of M^T for two 8-column tiles, M's rows
//     being B's columns (K in Q K^T);
//   * load_b_trans: the B fragments of M itself for two 8-column tiles
//     (V in P V): .trans gives the pairs down a column from M's
//     row-major rows.
//
// Shared rows are HD + 8 bf16 long (a 16-byte pad): at HD 32 a row is 80
// bytes, at 128 and 256 it is 4 words past a multiple of 32 words, so
// the 8 rows of each 8 x 8 matrix fall in 8 distinct groups of 4 banks
// and ldmatrix is free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

using bf16 = __nv_bfloat16;

// d += a * b: bf16 operands, f32 accumulate (one tensor-core instruction)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t b0, const uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// two f32 rounded to nearest bf16, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of the 16 x 16 block at s (row-major, `stride` bf16
// between rows).  Lanes 0-7 give rows 0-7 at column 0 (a0), 8-15 rows
// 8-15 (a1), 16-23 rows 0-7 at column 8 (a2), 24-31 rows 8-15 (a3).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int stride, int lane) {
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(a, s + r * stride + (lane >> 4) * 8);
}

// B = M^T for the 16 x 16 block at s (rows of M = B's columns): b[j] are
// (b0, b1) of the 8-column tile of M's rows 8j .. 8j+7.  Lanes 0-7 give
// rows 0-7 at column 0, 8-15 the same rows at column 8, 16-31 rows 8-15.
__device__ __forceinline__ void load_b_t(uint32_t (&b)[2][2], const bf16* s,
                                         int stride, int lane) {
  const int r = (lane & 7) + (lane >> 4) * 8;
  uint32_t x[4];
  ldsm_x4(x, s + r * stride + ((lane >> 3) & 1) * 8);
  b[0][0] = x[0];
  b[0][1] = x[1];
  b[1][0] = x[2];
  b[1][1] = x[3];
}

// B = M for the 16 x 16 block at s (M's rows are the k index): b[j] are
// (b0, b1) of the 8-column tile of columns 8j .. 8j+7; the addresses are
// load_a's, each 8 x 8 matrix transposed on the way in.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[2][2],
                                             const bf16* s, int stride,
                                             int lane) {
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t x[4];
  ldsm_x4_trans(x, s + r * stride + (lane >> 4) * 8);
  b[0][0] = x[0];
  b[0][1] = x[1];
  b[1][0] = x[2];
  b[1][1] = x[3];
}

// The A fragment of 16 rows x 16 columns of an accumulator held as two
// C fragments (columns 0-7 in c0, 8-15 in c1), rounded to bf16
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4],
                                           const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// out[j] = A . M_j^T for 16 rows of A and the 8 rows 8j .. 8j+7 of the
// tile `m` (kNT even), over the head dim (HD / 16 k-steps); a(kk, frag)
// writes A's fragment of k-step kk.  Fresh accumulators.
template <int kNT, int HD, class AFrag>
__device__ __forceinline__ void head_dim_product(float (&out)[kNT][4],
                                                 AFrag a, const bf16* m,
                                                 int stride, int lane) {
  static_assert(kNT % 2 == 0 && HD % 16 == 0, "whole 16 x 16 blocks");
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    out[j][0] = out[j][1] = out[j][2] = out[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    a(kk, af);
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      uint32_t b[2][2];
      load_b_t(b, m + 8 * j * stride + 16 * kk, stride, lane);
      mma(out[j], af, b[0][0], b[0][1]);
      mma(out[j + 1], af, b[1][0], b[1][1]);
    }
  }
}

// acc[n] += X . M over the 8 kNT rows of the tile `m` (n < kDT, 8 columns
// each, kDT even), X an accumulator (16 rows x 8 kNT columns: P, in
// f32) rounded to bf16 on its way to the A operand
template <int kNT, int kDT>
__device__ __forceinline__ void tile_product(float (&acc)[kDT][4],
                                             const float (&x)[kNT][4],
                                             const bf16* m, int stride,
                                             int lane) {
  static_assert(kNT % 2 == 0 && kDT % 2 == 0, "whole 16 x 16 blocks");
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    uint32_t af[4];
    a_from_acc(af, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < kDT; n += 2) {
      uint32_t b[2][2];
      load_b_trans(b, m + 16 * kk * stride + 8 * n, stride, lane);
      mma(acc[n], af, b[0][0], b[0][1]);
      mma(acc[n + 1], af, b[1][0], b[1][1]);
    }
  }
}

// 16 bytes global -> shared without registers; src_bytes 0 zero-fills
// (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// rows [r0, r0 + n_rows) of a [T, nh, HD] bf16 head view (row r at
// src + r * row_stride) into a shared tile of `stride` bf16 per row;
// rows at or past T are zero-filled.  Every thread of the block calls it;
// thread tid copies the 16-byte chunks tid, tid + kThreads, ...
template <int HD, int kThreads>
__device__ __forceinline__ void stage_rows(bf16* dst, int stride,
                                           const bf16* src,
                                           size_t row_stride, int r0,
                                           int n_rows, int T, int tid) {
  constexpr int kC8 = HD / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < n_rows * kC8; idx += kThreads) {
    const int r = idx / kC8, c = idx % kC8;
    const bool in = r0 + r < T;
    cp_async16(dst + r * stride + 8 * c,
               src + (size_t)(in ? r0 + r : 0) * row_stride + 8 * c,
               in ? 16 : 0);
  }
}

}  // namespace bf16mma
