// Hopper's warpgroup products and tensor copies for the flash kernels'
// bf16 forms (flash_attention.cu, flash_attention_bwd.cu):
// `wgmma.mma_async` on bf16 operands with f32 accumulators, tiles copied
// by the TMA unit (`cp.async.bulk.tensor`) into shared memory under
// mbarriers.
//
// Tiles.  q, k, v and dO are [B, T, nh, hd] bf16; each is described to
// the TMA unit as a 4D tensor (hd, nh, T, B) and a tile of R rows of one
// head is copied as hd / C boxes of (C, 1, R, 1), C = min(hd, 64) columns:
// box j holds the columns [C j, C j + C) of the R rows, rows C * 2 bytes
// long (64 at hd 32, 128 above), in the swizzle of that width (64 or 128
// bytes: the 16-byte chunk c of row r lands at chunk c ^ (r % 8), or
// c ^ ((r / 2) % 4) for 64-byte rows).  Rows at or past T are zero-filled
// by the copy.  Boxes sit R * 2C bytes apart, each at a multiple of 1024
// bytes.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"; the canonical
// layouts of CUTLASS's make_gmma_desc): bits 0-13 the start address >> 4,
// 16-29 the leading byte offset (LBO) >> 4, 32-45 the stride byte offset
// (SBO) >> 4, 62-63 the swizzle (1 = 128 bytes, 2 = 64).  A swizzle atom
// is 8 rows of one box (1024 or 512 bytes).
//
//   * K-major (desc_k): the tile's rows are M (or N), the head dim is K.
//     SBO = 8 rows (the next atom down the rows); LBO unused.  k-step kk
//     (columns 16 kk .. 16 kk + 15) starts in box 16 kk / C at byte
//     (16 kk % C) * 2 of row 0: the swizzle is applied by the hardware to
//     the address bits, so a start 32 bytes into an atom's row reads what
//     the copy wrote there.
//   * M|N-major (desc_mn, B only, with wgmma's transpose flag): the tile's
//     rows are K, the head dim is N.  SBO = 8 rows (the next 8 values of
//     K), LBO = one box (the next C values of N); k-step kk starts 16 kk
//     rows down.
//
// Fragments of m64nNk16 (one warpgroup, warp w of it holding rows 16 w ..
// 16 w + 15; lane = 4 g + t): accumulator register 4 i + e of a thread
// is D[16 w + g + 8 (e >> 1)][8 i + 2 t + (e & 1)], i < N / 8.  A from
// registers (rs) takes, per k-step, mma.sync's m16n8k16 A fragment:
// a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9],
// a3 = A[g+8][2t+8, 2t+9].  So columns 16 kk .. 16 kk + 15 of an
// accumulator, rounded to bf16 in pairs, are the A fragment of k-step kk
// of the next product (a_frag): P and dS pass from one product to the
// next in registers.
//
// Order.  wgmma_fence() before a product that reads registers other
// instructions wrote (A fragments, or accumulators read or zeroed in
// between); commit() closes a group, wait<n>() waits until n groups are
// in flight; keep() after the wait tells the compiler that the
// registers (accumulators, and the A fragments a product read) were in
// use until then, so it neither reads an accumulator early nor reuses an
// A register while the product still reads it.
//
// Tensor maps are encoded on the host (cuTensorMapEncodeTiled, looked up
// through the CUDA runtime's entry-point query, so nothing links against
// libcuda) and passed by value as __grid_constant__ kernel parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace wg {

using bf16 = __nv_bfloat16;

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a [B, T, nh, hd] bf16 tensor for tiles of `rows` rows of one
// head (boxes of min(hd, 64) columns, swizzled to their width)
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int T,
                            int nh, int hd, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t cols = hd < 64 ? hd : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)nh, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)nh * hd * 2,
                                 (cuuint64_t)T * nh * hd * 2};
  const cuuint32_t box[4] = {cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- device: tiles and copies --------------------------------------

// A tile of head dim HD in shared memory (see the top of this file)
template <int HD>
struct Tile {
  static_assert(HD == 32 || HD % 64 == 0, "64-byte or 128-byte rows");
  static constexpr int kCols = HD < 64 ? HD : 64;  // columns per box
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kBoxes = HD / kCols;
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr int kAtom = 8 * kRowBytes;  // SBO: 8 rows
  // bytes of a tile of `rows` rows
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * HD * 2;
  }
};

// rows [r0, r0 + rows) of head h of article b, columns [c0, c0 + HD) (c0
// a multiple of the box; 0 and HD the whole head for the flash kernels,
// one 128-column slab of a wider head for flash_attention_wide.cu), into
// the tile at dst (Tile<HD>'s layout), completing on bar; one thread
// issues it
template <int HD>
__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map,
                                          int rows, int r0, int h, int b,
                                          uint64_t* bar, int c0 = 0) {
  using L = Tile<HD>;
  const unsigned d = tma::smem_addr(dst), m = tma::smem_addr(bar);
#pragma unroll
  for (int j = 0; j < L::kBoxes; ++j)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_"
        "tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(
            d + j * rows * L::kRowBytes),
        "l"(map), "r"(c0 + j * L::kCols), "r"(h), "r"(r0), "r"(b), "r"(m)
        : "memory");
}

// ---- device: descriptors and products -------------------------------------

__device__ __forceinline__ uint64_t desc(const void* p, unsigned lbo,
                                         unsigned sbo, uint64_t swizzle) {
  const uint64_t a = tma::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

// K-major operand: 64 (A) or N (B) rows of a tile of `rows` rows from
// row0 (a multiple of 8), k-step kk of the head dim
template <int HD>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile,
                                           int rows, int row0, int kk) {
  using L = Tile<HD>;
  const int c = 16 * kk;
  return desc(tile + (c / L::kCols) * rows * L::kRowBytes +
                  row0 * L::kRowBytes + (c % L::kCols) * 2,
              16, L::kAtom, L::kSwizzle);
}

// M|N-major B operand: rows 16 kk .. 16 kk + 15 of a tile of `rows` rows
// as K, the head dim's columns from col0 (a multiple of the box) as N
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile,
                                            int rows, int kk, int col0) {
  using L = Tile<HD>;
  return desc(tile + (col0 / L::kCols) * rows * L::kRowBytes +
                  16 * kk * L::kRowBytes,
              rows * L::kRowBytes, L::kAtom, L::kSwizzle);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void keep(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// two f32 rounded to nearest bf16, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// columns 16 kk .. 16 kk + 15 of an m64nN accumulator, rounded to bf16,
// as the A fragment of k-step kk of the next product
template <int R>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[R],
                                       int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// m64nNk16 bf16 products with f32 accumulators (accumulate = 0 overwrites)
template <int N>
struct Mma;

template <>
struct Mma<32> {
  static constexpr int kRegs = 16;
  // d (+)= A B: A and B in shared memory (descriptors a, b), both K-major
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d (+)= A B: A in registers (a_frag's layout), B in shared memory
  // M|N-major (descriptor b; the transpose flag set)
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Mma<64> {
  static constexpr int kRegs = 32;
  // d (+)= A B: A and B in shared memory (descriptors a, b), both K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Mma<128> {
  static constexpr int kRegs = 64;
  // d (+)= A B: A and B in shared memory (descriptors a, b), both K-major
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d (+)= A B: A in registers (a_frag's layout), B in shared memory
  // M|N-major (descriptor b; the transpose flag set)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

}  // namespace wg
