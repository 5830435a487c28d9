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
// query row i (q, k, v, out [B, T, nh, hd], contiguous):
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
// f32 accuracy: every product is an f32 FMA.
//
// What bounds it on an H100: operations.  At 16 x 400 x 1 x 512 with a
// key mask the forward does 4 * hd per attended pair, 5.24 GFLOP: 0.032
// ms at the 3xTF32 rate of the f32 kernels (165 TFLOP/s), 0.0053 ms at
// the bf16 tensor-core rate, where the 26.2 MB of bf16 q, k, v and out
// (0.0078 ms at 3.35 TB/s) bound it instead.  These kernels are the
// simple form, far from that: SIMT FMA at the 67 TFLOP/s f32 rate, and
// each block forms S (and dP) over the whole head dim for one 128-wide
// slab of its output.  The design:
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
//     columns of O, dK and dV, or dQ, the hd-256 kernels' two-block split
//     generalised to hd / 128 blocks;
//   * the forward's online softmax runs on S's registers, the row max and
//     sum reduced over the 16 threads of a half-warp with shuffles; P
//     (and in the backward P and dS) goes through shared memory to the
//     slab product, whose other operand (v, dO and q, or k) is staged 64
//     x 128 in the space the chunks used;
//   * a key the row may not attend gets s = -inf, so p is exactly 0 (the
//     running max never drops below -1e30); causal tiles past the block's
//     last row (forward, dQ) or before its first key (dK/dV) are never
//     visited.  No atomics: two runs give the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry points (one per
// kernel and dtype) bound with ctypes from ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"  // allow_smem

namespace {

using bf16 = __nv_bfloat16;

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

// may key `key` be attended at all (real and unmasked)
__device__ __forceinline__ float key_flag(const float* key_mask, int b,
                                          int T, int key) {
  return (key < T && (key_mask == nullptr ||
                      key_mask[(size_t)b * T + key] > 0.f))
             ? 1.f
             : 0.f;
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

// grid (ceil(T / 64), nh * hd / 128, B); kThreads threads; kFwdSmem floats
// of dynamic shared memory
template <typename E>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v,
                      const float* __restrict__ key_mask, E* __restrict__ out,
                      float* __restrict__ lse, int T, int nh, int hd,
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
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * hd;

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }
  // causal: keys past the block's last row are never attended
  const int t_end = causal ? min(T, row0 + kRows) : T;
  for (int k0 = 0; k0 < t_end; k0 += kCols) {
    if (tid < kCols) flag_s[tid] = key_flag(key_mask, b, T, k0 + tid);
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();  // the previous chunk (or slab) is read
      stage<kChunk>(q_s, kCS, q + base, pos_stride, row0, T, c0, tid);
      stage<kChunk>(k_s, kCS, k + base, pos_stride, k0, T, c0, tid);
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
    stage<kSlab>(v_s, kSlab, v + base, pos_stride, k0, T, col0, tid);
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
    if (row >= T) continue;
    E* o_row = out + base + (size_t)row * pos_stride + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st(o_row + tx + 16 * j, li > 0.f ? o[i][j] / li : 0.f);
    if (lse != nullptr && tx == 0 && col0 == 0)  // one block of the slabs
      lse[((size_t)b * T + row) * nh + h] =
          li > 0.f ? m[i] + logf(li) : INFINITY;
  }
}

// grid (ceil(T / 64), nh * hd / 128, B): a block owns 64 keys; kThreads
// threads; kDkvSmem floats of dynamic shared memory.  lse and dsum are
// [B, T, nh] f32.
template <typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const E* __restrict__ q, const E* __restrict__ k,
                          const E* __restrict__ v, const E* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          const float* __restrict__ key_mask,
                          E* __restrict__ dk, E* __restrict__ dv, int T,
                          int nh, int hd, int causal, float sm_scale) {
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
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * hd;
  const size_t row_base = (size_t)b * T * nh + h;  // of lse and dsum

  if (tid < kRows) kflag_s[tid] = key_flag(key_mask, b, T, key0 + tid);
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: query rows before the block's first key attend none of it
  const int q_begin = causal ? key0 : 0;  // a multiple of kCols
  for (int q0 = q_begin; q0 < T; q0 += kCols) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();  // the previous chunks (or slabs) are read
      if (c0 == 0 && tid < kCols) {
        const int row = q0 + tid;
        lse_s[tid] = row < T ? lse[row_base + (size_t)row * nh] : INFINITY;
        d_s[tid] = row < T ? dsum[row_base + (size_t)row * nh] : 0.f;
      }
      stage<kChunk>(k_c, kCS, k + base, pos_stride, key0, T, c0, tid);
      stage<kChunk>(q_c, kCS, q + base, pos_stride, q0, T, c0, tid);
      stage<kChunk>(v_c, kCS, v + base, pos_stride, key0, T, c0, tid);
      stage<kChunk>(do_c, kCS, dout + base, pos_stride, q0, T, c0, tid);
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
        // a row past T or with no key to attend has lse +inf: p = 0
        const float p = ok ? expf(s[i][j] * sm_scale - lse_s[qc]) : 0.f;
        const float ds = p * (dp[i][j] - d_s[qc]);
        pt_s[kr * kPS + qc] = kBf16 ? round_bf16(p) : p;
        dst_s[kr * kPS + qc] = kBf16 ? round_bf16(ds * sm_scale) : ds;
      }
    }
    __syncthreads();  // every warp is done with the chunks
    stage<kSlab>(do_slab, kSlab, dout + base, pos_stride, q0, T, col0, tid);
    stage<kSlab>(q_slab, kSlab, q + base, pos_stride, q0, T, col0, tid);
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
    if (key >= T) continue;
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

// grid (ceil(T / 64), nh * hd / 128, B): a block owns 64 query rows;
// kThreads threads; kDqSmem floats of dynamic shared memory
template <typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         const float* __restrict__ key_mask,
                         E* __restrict__ dq, int T, int nh, int hd,
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
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * hd;
  const size_t row_base = (size_t)b * T * nh + h;

  float lse_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    lse_r[i] = row < T ? lse[row_base + (size_t)row * nh] : INFINITY;
    d_r[i] = row < T ? dsum[row_base + (size_t)row * nh] : 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int t_end = causal ? min(T, row0 + kRows) : T;
  for (int k0 = 0; k0 < t_end; k0 += kCols) {
    if (tid < kCols) flag_s[tid] = key_flag(key_mask, b, T, k0 + tid);
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();  // the previous chunks (or slab) are read
      stage<kChunk>(q_c, kCS, q + base, pos_stride, row0, T, c0, tid);
      stage<kChunk>(k_c, kCS, k + base, pos_stride, k0, T, c0, tid);
      stage<kChunk>(do_c, kCS, dout + base, pos_stride, row0, T, c0, tid);
      stage<kChunk>(v_c, kCS, v + base, pos_stride, k0, T, c0, tid);
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
    stage<kSlab>(k_slab, kSlab, k + base, pos_stride, k0, T, col0, tid);
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
    if (row >= T) continue;
    E* d_row = dq + base + (size_t)row * pos_stride + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st(d_row + tx + 16 * j, kBf16 ? acc[i][j] : acc[i][j] * sm_scale);
  }
}

// what every entry point checks: positive sizes within the grid's axes, a
// head dim that is a multiple of the slab
bool bad_shape(int B, int T, int nh, int hd) {
  return B <= 0 || T <= 0 || nh <= 0 || hd <= 0 || hd % kSlab != 0 ||
         B > 65535 || (long long)nh * (hd / kSlab) > 65535;
}

dim3 grid_of(int B, int T, int nh, int hd) {
  return dim3((T + kRows - 1) / kRows, nh * (hd / kSlab), B);
}

template <typename E>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* key_mask, void* out, float* lse, int B, int T,
               int nh, int hd, int causal, float sm_scale, void* stream) {
  if (bad_shape(B, T, nh, hd)) return (int)cudaErrorInvalidValue;
  static unsigned smem_set = 0;  // per instantiation and device
  cudaError_t err = tf32x3::allow_smem(flash_fwd_wide_kernel<E>,
                                       kFwdSmem * sizeof(float), smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wide_kernel<E><<<grid_of(B, T, nh, hd), kThreads,
                             kFwdSmem * sizeof(float),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), key_mask, static_cast<E*>(out), lse, T, nh,
      hd, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, const float* key_mask,
               void* dk, void* dv, int B, int T, int nh, int hd, int causal,
               float sm_scale, void* stream) {
  if (bad_shape(B, T, nh, hd)) return (int)cudaErrorInvalidValue;
  static unsigned smem_set = 0;
  cudaError_t err = tf32x3::allow_smem(flash_bwd_dkv_wide_kernel<E>,
                                       kDkvSmem * sizeof(float), smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_wide_kernel<E><<<grid_of(B, T, nh, hd), kThreads,
                                 kDkvSmem * sizeof(float),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout), lse, dsum,
      key_mask, static_cast<E*>(dk), static_cast<E*>(dv), T, nh, hd, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, const float* key_mask,
              void* dq, int B, int T, int nh, int hd, int causal,
              float sm_scale, void* stream) {
  if (bad_shape(B, T, nh, hd)) return (int)cudaErrorInvalidValue;
  static unsigned smem_set = 0;
  cudaError_t err = tf32x3::allow_smem(flash_bwd_dq_wide_kernel<E>,
                                       kDqSmem * sizeof(float), smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_wide_kernel<E><<<grid_of(B, T, nh, hd), kThreads,
                                kDqSmem * sizeof(float),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout), lse, dsum,
      key_mask, static_cast<E*>(dq), T, nh, hd, causal, sm_scale);
  return (int)cudaGetLastError();
}
}  // namespace

// q, k, v, out [B, T, nh, hd] float32 (bfloat16 for the _bf16 forms),
// contiguous, on one device, hd a multiple of 128; key_mask [B, T] float32
// (1 = real token) or null (every key real); lse [B, T, nh] float32 or
// null (not written).  Launches on `stream`; returns the cudaError_t of
// the launch.
extern "C" int ts_flash_wide(const void* q, const void* k, const void* v,
                             const float* key_mask, void* out, float* lse,
                             int B, int T, int nh, int hd, int causal,
                             float sm_scale, void* stream) {
  return launch_fwd<float>(q, k, v, key_mask, out, lse, B, T, nh, hd, causal,
                           sm_scale, stream);
}

extern "C" int ts_flash_wide_bf16(const void* q, const void* k,
                                  const void* v, const float* key_mask,
                                  void* out, float* lse, int B, int T, int nh,
                                  int hd, int causal, float sm_scale,
                                  void* stream) {
  return launch_fwd<bf16>(q, k, v, key_mask, out, lse, B, T, nh, hd, causal,
                          sm_scale, stream);
}

// q, k, v, dout, dk, dv [B, T, nh, hd] as above; lse (the forward's) and
// dsum (rowsum(dO * O)) [B, T, nh] float32
extern "C" int ts_flash_wide_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* dsum,
                                     const float* key_mask, void* dk,
                                     void* dv, int B, int T, int nh, int hd,
                                     int causal, float sm_scale,
                                     void* stream) {
  return launch_dkv<float>(q, k, v, dout, lse, dsum, key_mask, dk, dv, B, T,
                           nh, hd, causal, sm_scale, stream);
}

extern "C" int ts_flash_wide_bwd_dkv_bf16(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const float* lse, const float* dsum,
                                          const float* key_mask, void* dk,
                                          void* dv, int B, int T, int nh,
                                          int hd, int causal, float sm_scale,
                                          void* stream) {
  return launch_dkv<bf16>(q, k, v, dout, lse, dsum, key_mask, dk, dv, B, T,
                          nh, hd, causal, sm_scale, stream);
}

extern "C" int ts_flash_wide_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* dsum,
                                    const float* key_mask, void* dq, int B,
                                    int T, int nh, int hd, int causal,
                                    float sm_scale, void* stream) {
  return launch_dq<float>(q, k, v, dout, lse, dsum, key_mask, dq, B, T, nh,
                          hd, causal, sm_scale, stream);
}

extern "C" int ts_flash_wide_bwd_dq_bf16(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const float* lse, const float* dsum,
                                         const float* key_mask, void* dq,
                                         int B, int T, int nh, int hd,
                                         int causal, float sm_scale,
                                         void* stream) {
  return launch_dq<bf16>(q, k, v, dout, lse, dsum, key_mask, dq, B, T, nh,
                         hd, causal, sm_scale, stream);
}

extern "C" const char* ts_flash_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
