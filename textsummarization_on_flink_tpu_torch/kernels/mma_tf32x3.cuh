// f32-accurate tensor-core products on Hopper: 3xTF32 with mma.sync, and
// the cp.async staging the flash kernels share.
//
// Each f32 operand x is split into two TF32 values,
//
//   hi = cvt.rna.tf32.f32(x),   lo = cvt.rna.tf32.f32(x - hi),
//
// and a product a*b is formed as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b by
// three `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`, summed in
// f32 (the small terms first; mma3 says where the sums are rounded).  hi
// holds the top 11 significant bits of x and lo the next 11, so x = hi +
// lo to 2^-22 relative; the dropped lo_a*lo_b term is below 2^-22 of the
// product.
// The result is f32-accurate: it differs from an f32 FMA product by about
// one f32 rounding, not by TF32's 2^-11.  This is CUTLASS's
// OpMultiplyAddFastF32; the port's rule "f32 throughout, TF32 off"
// (device.py) holds in substance, since no operand is rounded to TF32.
//
// Fragment layouts of m16n8k8 (tf32 A and B, f32 C), for lane = 4*g + t
// (g = lane / 4 in 0..7, t = lane % 4):
//
//   A (16 x 8, row):  a0 = A[g][t]    a1 = A[g+8][t]
//                     a2 = A[g][t+4]  a3 = A[g+8][t+4]
//   B (8 x 8, col):   b0 = B[t][g]    b1 = B[t+4][g]
//   C (16 x 8, f32):  c0 = C[g][2t]   c1 = C[g][2t+1]
//                     c2 = C[g+8][2t] c3 = C[g+8][2t+1]
//
// The f32 C layout is not the tf32 A layout, so a product of an
// accumulator (P, dS) with a second matrix cannot take the accumulator as
// its A operand directly.  It can in a permuted k order: let k = t stand
// for column 2t and k = t+4 for column 2t+1 of the accumulator.  Then A's
// a0..a3 are exactly c0, c2, c1, c3 of the same lane (`a_from_acc`), and
// the B operand takes its rows in the same order, b0 from row 2t and b1
// from row 2t+1 (`load_b_perm`).  No shuffle and no shared-memory round
// trip.
//
// Shared tiles are row-major with a row stride of (width + 4) floats, so
// stride = 4 (mod 32): every fragment load below then touches 32 distinct
// banks.  A tile that every warp of a block reads as a B operand is split
// once by the block (split_tile) and read as hi/lo pairs (SplitTile).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// hi = cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x - hi).  The cvt
// leaves the 13 low bits of its result unspecified; they are cleared
// before hi is read back as an f32 (the mma ignores them).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(x - __uint_as_float(h)));
  hi = h;
  lo = l;
}

__device__ __forceinline__ FragA split_a(float x0, float x1, float x2,
                                         float x3) {
  FragA f;
  split(x0, f.hi[0], f.lo[0]);
  split(x1, f.hi[1], f.lo[1]);
  split(x2, f.hi[2], f.lo[2]);
  split(x3, f.hi[3], f.lo[3]);
  return f;
}

// d += a * b on TF32 inputs, f32 accumulate (one tensor-core instruction)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b to f32 accuracy: lo*hi + hi*lo + hi*hi.
//
// The tensor core does not round its f32 sums to nearest (it truncates),
// so a long chain of mma into one accumulator drifts by up to an ulp of
// the running sum per instruction, all one way: at hd 128 and |s| ~ 20 a
// chain over the whole head dim tripled the lse error of plain f32.  So
// the kernels keep every chain short: `c` is a fresh accumulator that
// sums one 16-wide slice of the head dim (two k-steps), or at most 32
// keys or queries, and is then added to the long-lived sum by `add4`,
// whose f32 adds round to nearest.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

__device__ __forceinline__ void add4(float (&d)[4], const float (&c)[4]) {
  d[0] += c[0];
  d[1] += c[1];
  d[2] += c[2];
  d[3] += c[3];
}

// A = the 16 x 8 block at s (row-major, `stride` floats between rows)
__device__ __forceinline__ FragA load_a(const float* s, int stride, int g,
                                        int t) {
  return split_a(s[g * stride + t], s[(g + 8) * stride + t],
                 s[g * stride + t + 4], s[(g + 8) * stride + t + 4]);
}

// A shared tile that split_tile has split: the TF32 hi parts in place of
// the f32 values and the lo parts at the same offsets of a second array.
// Fragment loads from it are plain shared loads, with no arithmetic: a
// tile every warp of the block reads is split once, not once per warp.
struct SplitTile {
  const float* hi;
  const float* lo;
};

// B = M^T for the 8 x 8 block M at offset `off` of a split tile
// (row-major): B's column n is M's row n, as K's rows are the columns of
// K^T in Q K^T
__device__ __forceinline__ FragB load_b_t(SplitTile s, int off, int stride,
                                          int g, int t) {
  const int i0 = off + g * stride + t, i1 = i0 + 4;
  FragB f;
  f.hi[0] = __float_as_uint(s.hi[i0]);
  f.hi[1] = __float_as_uint(s.hi[i1]);
  f.lo[0] = __float_as_uint(s.lo[i0]);
  f.lo[1] = __float_as_uint(s.lo[i1]);
  return f;
}

// B = the 8 x 8 block at offset `off` of a split tile (row-major) in the
// permuted k order of a_from_acc: b0 from row 2t, b1 from row 2t+1
__device__ __forceinline__ FragB load_b_perm(SplitTile s, int off,
                                             int stride, int g, int t) {
  const int i0 = off + 2 * t * stride + g, i1 = i0 + stride;
  FragB f;
  f.hi[0] = __float_as_uint(s.hi[i0]);
  f.hi[1] = __float_as_uint(s.hi[i1]);
  f.lo[0] = __float_as_uint(s.lo[i0]);
  f.lo[1] = __float_as_uint(s.lo[i1]);
  return f;
}

// A from an f32 accumulator fragment, in the permuted k order
__device__ __forceinline__ FragA a_from_acc(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// out[j] = A . M_j^T over the head dim for 16 rows of A and the 8 rows
// 8j..8j+7 of the split tile `bt` (j < kNT; kKS k-steps of 8): one fresh
// accumulator per 16-wide slice of the head dim (see mma3).  a(kk) gives
// A's fragment of k-step kk.
template <int kNT, int kKS, class AFrag>
__device__ __forceinline__ void head_dim_product(float (&out)[kNT][4],
                                                 AFrag a, SplitTile bt,
                                                 int stride, int g, int t) {
  static_assert(kKS % 2 == 0, "slices of two k-steps");
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    out[j][0] = out[j][1] = out[j][2] = out[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKS; kk += 2) {
    const FragA a0 = a(kk), a1 = a(kk + 1);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int off = 8 * j * stride + 8 * kk;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(c, a0, load_b_t(bt, off, stride, g, t));
      mma3(c, a1, load_b_t(bt, off + 8, stride, g, t));
      add4(out[j], c);
    }
  }
}

// acc[n] += X . M over the 8 kNT rows of the split tile `b` (n < kDT, 8
// columns each), X an accumulator fragment (16 rows x 8 kNT columns: P or
// dS) taken in a_from_acc's order: one fresh accumulator per kGroup
// chunks of 8 rows (see mma3)
template <int kNT, int kDT, int kGroup>
__device__ __forceinline__ void tile_product(float (&acc)[kDT][4],
                                             const float (&x)[kNT][4],
                                             SplitTile b, int stride, int g,
                                             int t) {
  static_assert(kNT % kGroup == 0, "whole groups");
#pragma unroll
  for (int j0 = 0; j0 < kNT; j0 += kGroup) {
    FragA xa[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) xa[j] = a_from_acc(x[j0 + j]);
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        mma3(c, xa[j],
             load_b_perm(b, 8 * (j0 + j) * stride + 8 * n, stride, g, t));
      add4(acc[n], c);
    }
  }
}

// 16 bytes global -> shared without registers; src_bytes 0 zero-fills
// (src must still be a valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (cp.async through L1; committed with the
// 16-byte ones)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [r0, r0 + n_rows) of a [T, nh, HD] head view (row r at
// src + r * row_stride) into a shared tile of `stride` floats per row;
// rows at or past T are zero-filled.  Every thread of the block calls it;
// thread tid copies the 16-byte chunks tid, tid + kThreads, ...
template <int HD, int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, int stride,
                                           const float* src,
                                           size_t row_stride, int r0,
                                           int n_rows, int T, int tid) {
  constexpr int kC4 = HD / 4;  // 16-byte chunks per row
  for (int idx = tid; idx < n_rows * kC4; idx += kThreads) {
    const int r = idx / kC4, c = idx % kC4;
    const bool in = r0 + r < T;
    cp_async16(dst + r * stride + 4 * c,
               src + (size_t)(in ? r0 + r : 0) * row_stride + 4 * c,
               in ? 16 : 0);
  }
}

// Split a tile staged by stage_rows (same n_rows, stride and chunks per
// thread) in place: hi replaces the f32 values, lo goes to the same
// offsets of `lo`.  A thread splits exactly the chunks it copied, so after
// its own cp_async_wait it needs no barrier before; the block
// synchronises after, before any warp reads the tile.
template <int HD, int kThreads>
__device__ __forceinline__ void split_tile(float* hi, float* lo, int stride,
                                           int n_rows, int tid) {
  constexpr int kC4 = HD / 4;
  for (int idx = tid; idx < n_rows * kC4; idx += kThreads) {
    const int off = (idx / kC4) * stride + 4 * (idx % kC4);
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Let `kernel` use `bytes` of dynamic shared memory (needed above 48 KB),
// once per device: the attribute is a host call, which would otherwise
// add its latency to every launch.  `done` (bit d: set on device d) is a
// static of the caller's, one per kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, unsigned& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev) & 1u)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

}  // namespace tf32x3
