// What the flash kernels' bf16 forms share (the forward in
// flash_attention.cu, dK/dV and dQ in flash_attention_bwd.cu): the
// block's geometry, the register split between its producer and its
// consumers, the column split at head dim 256, exp as one MUFU
// instruction, and the rounded store of an accumulator's rows.
//
// A block is kWGs = 2 consumer warpgroups and a producer warpgroup whose
// first warp works (it issues the TMA copies and forms the rows' or keys'
// side data with its lanes; the other three exit).  Each consumer
// warpgroup owns 64 of the block's kBlockRows rows (query rows, or keys
// for dK/dV) and runs its products as wgmma (wgmma_bf16.cuh) on tiles
// that a ring of kStages stages in shared memory brings, behind "full"
// and "empty" mbarriers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace flash_bf16 {

constexpr int kWGs = 2;                  // consumer warpgroups per block
constexpr int kStages = 2;               // tiles in the ring
constexpr int kBlockRows = 64 * kWGs;    // keys (dK/dV) or rows (dQ, fwd)
constexpr int kWgThreads = 128 * kWGs;   // consumer threads
// and the producer warpgroup: its first warp copies, the others exit.  A
// block's warps are spread over the SM's four register files (16,384
// registers each), so a ninth warp would cap every thread at 168; with a
// third warpgroup (one block per SM, 168 registers a thread at launch)
// the producer gives back all but kProducerRegs and the consumers take
// kConsumerRegs (setmaxnreg): 128 * (168 - 24) = 256 * (240 - 168), so
// the consumers take exactly what the producer gave back (setmaxnreg.inc
// waits for registers its own block released)
constexpr int kBf16Threads = kWgThreads + 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// The head dims the kernels are built for; above 128 a block keeps half
// of its output's columns (kSplit blocks per tile and head)
template <int HD>
struct Split {
  static_assert(HD == 32 || HD == 128 || HD == 256, "built head dims");
  static constexpr int kSplit = HD > 128 ? 2 : 1;
  static constexpr int kOD = HD / kSplit;  // output columns a block keeps
};

// 2^x in one MUFU instruction (relative error below 2^-22, far under
// the bf16 rounding of P and dS; subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the dynamic shared memory, aligned for the 128-byte swizzle
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// rows[r] < T of an m64nN accumulator (N = kOD) rounded to bf16 at dst
// (this block's first column of row 0)
template <int kOD>
__device__ __forceinline__ void store_rows(wg::bf16* dst, size_t pos_stride,
                                           const int (&rows)[2], int T,
                                           const float (&acc)[kOD / 2],
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T) continue;
    wg::bf16* row = dst + (size_t)rows[r] * pos_stride;
#pragma unroll
    for (int i = 0; i < kOD / 8; ++i)
      *reinterpret_cast<uint32_t*>(row + 8 * i + 2 * t) =
          wg::pack(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// the producer warpgroup gives back its registers (its other three warps
// then exit), the consumers take theirs
__device__ __forceinline__ void set_regs(bool producer) {
  if (producer)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
}

}  // namespace flash_bf16
