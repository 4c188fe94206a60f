// Lane-slice DMA probe for Hopper (sm_90a), bound to Python through a plain
// C entry point (ctypes; see gsplat_tpu_torch/kernels/build.py and the
// wrapper in gsplat_tpu_torch/kernels/probes.py).
//
// Replaces the TPU kernel scripts/probe_lane_dma.py::kernel: grid nblk, and
// with the starts scalar-prefetched, block b copies the [16, 128] lane
// slice at the dynamic offset starts[b] of a [16, M] f32 array in HBM into
// VMEM, doubles it and copies it back to the same slice of the output.
//
// What bounds it on this card: bytes, 8 KB read and 8 KB written a block
// (64 KB at the probe's four blocks): nanoseconds at 3.35 TB/s, so the
// launch sets the time.
//
// What the design does: the copies are the Tensor Memory Accelerator's.
// The entry point encodes, on the host, a 2-D tensor map over each of the
// input and the output ([16, M] f32, rows M * 4 bytes apart, a box of 128
// columns by 16 rows, no swizzle) and passes both by value as
// __grid_constant__ parameters. Block b reads starts[b] from device memory
// (the counterpart of scalar prefetch); one thread issues
// cp.async.bulk.tensor.2d into a 128-byte aligned shared buffer, which
// completes on an mbarrier that expects the box's 8,192 bytes; the block
// doubles the slice in shared memory, fences it to the async proxy
// (fence.proxy.async.shared::cta), and one thread stores it back with the
// TMA store and waits for its bulk group.
//
// The tensor map is encoded through cuTensorMapEncodeTiled, a driver API
// function, reached through the runtime's cudaGetDriverEntryPoint so that
// the library needs no link against the driver (-lcuda); <cuda.h> and
// <cudaTypedefs.h> give only its types.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int kRows = 16;
constexpr int kBox = 128;  // columns a block copies
constexpr int kThreads = 256;
constexpr uint32_t kBoxBytes = kRows * kBox * sizeof(float);  // 8,192

__global__ void __launch_bounds__(kThreads) lane_dma_kernel(
    const __grid_constant__ CUtensorMap in_map, const __grid_constant__ CUtensorMap out_map,
    const int* __restrict__ starts) {
  __shared__ __align__(128) float slab[kRows * kBox];
  __shared__ __align__(8) uint64_t bar;
  const int off = starts[blockIdx.x];
  if (threadIdx.x == 0) gsplat::mbar_init(&bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    gsplat::mbar_arrive_expect_tx(&bar, kBoxBytes);
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::
            "r"(gsplat::smem_u32(slab)),
        "l"(reinterpret_cast<uint64_t>(&in_map)), "r"(off), "r"(0), "r"(gsplat::smem_u32(&bar))
        : "memory");
  }
  gsplat::mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < kRows * kBox; i += kThreads) slab[i] = __fmul_rn(slab[i], 2.0f);
  // Make this thread's shared-memory writes visible to the TMA store.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
                     reinterpret_cast<uint64_t>(&out_map)),
                 "r"(off), "r"(0), "r"(gsplat::smem_u32(slab))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// cuTensorMapEncodeTiled from the driver, looked up once.
cudaError_t encode_function(PFN_cuTensorMapEncodeTiled_v12000* fn) {
  static PFN_cuTensorMapEncodeTiled_v12000 cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// The [16, m] f32 array at `base` as TMA boxes of 128 columns x 16 rows.
bool encode_lane_map(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map, const float* base, int m) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m), kRows};  // innermost first
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m) * sizeof(float)};  // bytes between rows
  const cuuint32_t box[2] = {kBox, kRows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// out[:, s:s+128] = 2 * x[:, s:s+128] for each s of starts [nblk] (int32 on
// the device); x and out [16, m] f32, 16-byte aligned, m a multiple of 128,
// every start a multiple of 128 below m (the wrapper checks them).
cudaError_t gsplat_probe_lane_dma(const float* x, float* out, const int* starts, int m, int nblk, void* stream) {
  if (nblk <= 0 || m <= 0 || m % kBox || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = encode_function(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap in_map, out_map;
  if (!encode_lane_map(encode, &in_map, x, m) || !encode_lane_map(encode, &out_map, out, m)) {
    return cudaErrorInvalidValue;
  }
  lane_dma_kernel<<<nblk, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in_map, out_map, starts);
  return cudaGetLastError();
}

}  // extern "C"
