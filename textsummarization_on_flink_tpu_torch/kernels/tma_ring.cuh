// A ring of row chunks in shared memory filled by the TMA unit: the
// mbarrier and bulk-copy helpers the fused attention's forward and
// backward share (the flash kernels' bf16 forms use its mbarriers too,
// through wgmma_bf16.cuh).
//
// One thread arms a stage's mbarrier with the chunk's byte count and
// issues one bulk copy (cp.async.bulk) of the chunk's contiguous rows
// (or, for a slab of columns, one copy per row: bulk_copy);
// the copy completes the barrier's phase, and every thread waits on that
// phase's parity before it reads the stage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// an mbarrier that `count` arrivals (and the transaction bytes armed by
// them) complete
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make the initialised mbarriers visible to the copy engine
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// arrive, arming the phase with `bytes` to come from the copy engine
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// bytes global -> shared by the TMA unit (cp.async.bulk), completing on
// `bar`: one thread arrives on it with the byte count, then issues the
// copy (16-byte aligned ends, a multiple of 16 bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  mbar_arrive_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bytes global -> shared by the TMA unit, completing on `bar`, whose
// phase the caller has armed (mbar_arrive_tx) with the bytes of every
// copy it issues: several copies of one phase, e.g. the rows of a chunk
// that are not contiguous in memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wait for the phase of `bar` with this parity to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

}  // namespace tma
