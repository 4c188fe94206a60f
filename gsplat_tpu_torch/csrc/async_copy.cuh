// Hopper's asynchronous copies into shared memory, as PTX: the mbarrier a
// bulk or TMA copy completes on. Used by the probe kernels
// (probe_transpose.cu, probe_lane_dma.cu). A barrier made with one arrival
// and an expected transaction count of the copy's bytes completes its
// phase 0 when the issuing thread has arrived and every byte has landed;
// waiting on parity 0 then returns.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gsplat {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Initialise a barrier for `arrivals` arrivals and make the initialisation
// visible to the async proxy (the copy engines) before any use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(arrivals) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of asynchronous transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Block until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace gsplat
