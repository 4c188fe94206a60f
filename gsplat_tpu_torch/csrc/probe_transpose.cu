// Transpose probes for Hopper (sm_90a), bound to Python through plain C
// entry points (ctypes; see gsplat_tpu_torch/kernels/build.py and the
// wrappers in gsplat_tpu_torch/kernels/probes.py).
//
// Replaces the TPU kernels of scripts/probe_transpose.py, which asked
// whether Mosaic lowers the in-kernel transposes a column-major pair slab
// needs:
//   - t1_kernel / t2_kernel: [16, 128] -> [128, 16] and back in fast memory
//     (transpose_smem);
//   - dma_kernel: grid nblk, an async copy of block b of a [nblk, 16, 128]
//     slab in HBM into VMEM, wait, write its transpose to out[b]
//     (transpose_block_async);
//   - mxu_t_kernel: the exact transpose as eye(128) . x^T on the MXU at
//     Precision.HIGHEST (transpose_mma).
//
// What bounds them on this card: bytes, each input read once and each
// output written once: 16 KB a slab, a few nanoseconds at 3.35 TB/s. At
// these sizes every kernel is one launch (or a few blocks), so the launch
// and its round trip through the host set the time, not the card.
//
// What the designs do:
//   - transpose_smem stages the block in shared memory with a padded row
//     stride, so that both the row-order load and the column-order store
//     hit distinct banks, then writes the transpose with consecutive
//     threads on consecutive output addresses.
//   - transpose_block_async is the Hopper form of
//     pltpu.make_async_copy(x_hbm.at[b], slab, sem).start()/.wait(): one
//     thread issues one cp.async.bulk of the slab's 8,192 contiguous bytes
//     that completes on an mbarrier (the semaphore), and every thread waits
//     on the barrier's phase before reading the slab.
//   - transpose_mma runs the same product eye(128) . x^T on the tensor
//     cores: mma.sync m16n8k8 with TF32 operands and an f32 accumulator,
//     eight warps, warp w computing output rows [16w, 16w + 16). The
//     identity is made in registers. TF32 keeps 10 of f32's 23 mantissa
//     bits, so in one mode x is rounded once to TF32 with
//     cvt.rna.tf32.f32 (round to nearest, ties away from zero), which makes
//     the rounding the kernel's and not the hardware's truncation; the
//     result is that rounding of x, transposed. In the other ("3xTF32") x
//     is split into hi + mid + lo, each exact in TF32, three products
//     accumulate in three f32 accumulators, and (hi + mid) + lo is summed
//     with round-to-nearest adds: every product has one nonzero term, so
//     each accumulator is exact and the sum gives x back bitwise.

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlabRows = 16;
constexpr int kSlabCols = 128;
constexpr int kSlabFloats = kSlabRows * kSlabCols;
constexpr uint32_t kSlabBytes = kSlabFloats * sizeof(float);  // 8,192

// ---------------------------------------------------------------------
// transpose_smem: [R, C] -> [C, R] through a padded shared tile.

// Row stride of the staged tile: C + 1 where a warp's column-order reads
// walk 32 or more rows (an odd stride puts them on distinct banks), C + 2
// for 16 rows (two columns of 16 rows a warp: even banks, then odd).
template <int R, int C>
__host__ __device__ constexpr int padded_stride() { return C + (R >= 32 ? 1 : 32 / R); }

template <int R, int C>
__global__ void __launch_bounds__(kThreads) transpose_smem_kernel(
    const float* __restrict__ x, float* __restrict__ out) {
  constexpr int S = padded_stride<R, C>();
  __shared__ float tile[R * S];
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    tile[(i / C) * S + i % C] = x[i];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < R * C; o += kThreads) {
    out[o] = tile[(o % R) * S + o / R];  // out[c][r] = x[r][c]
  }
}

// ---------------------------------------------------------------------
// transpose_block_async: block b copies slab b of [nblk, 16, 128] into
// shared memory with one bulk copy and writes its [128, 16] transpose.

__global__ void __launch_bounds__(kThreads) transpose_block_async_kernel(
    const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(128) float slab[kSlabFloats];
  __shared__ __align__(8) uint64_t bar;
  const size_t base = static_cast<size_t>(blockIdx.x) * kSlabFloats;
  if (threadIdx.x == 0) gsplat::mbar_init(&bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    gsplat::mbar_arrive_expect_tx(&bar, kSlabBytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            gsplat::smem_u32(slab)),
        "l"(x + base), "r"(kSlabBytes), "r"(gsplat::smem_u32(&bar))
        : "memory");
  }
  gsplat::mbar_wait(&bar, 0);
  // Consecutive threads read consecutive columns of a slab row (distinct
  // banks) and write a column of the transpose.
  for (int i = threadIdx.x; i < kSlabFloats; i += kThreads) {
    const int r = i / kSlabCols, c = i % kSlabCols;
    out[base + c * kSlabRows + r] = slab[i];
  }
}

// ---------------------------------------------------------------------
// transpose_mma: out [128, 16] = eye(128) . x^T, x [16, 128], on the
// tensor cores.

// x rounded to TF32 (10 mantissa bits), nearest with ties away from zero,
// as an f32 bit pattern whose low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// d += a . b for one m16n8k8 tile (row-major A, column-major B).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kMmaWarps = kSlabCols / 16;  // 8: one 16-row strip of the output each
constexpr uint32_t kOne = 0x3f800000u;     // 1.0f, exact in TF32

template <bool kSplit3>
__global__ void __launch_bounds__(kMmaWarps * 32) transpose_mma_kernel(
    const float* __restrict__ x, float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // groupID, threadID_in_group (PTX fragment layouts)
  const int row0 = warp * 16 + g;        // output rows row0 and row0 + 8
  constexpr int kParts = kSplit3 ? 3 : 1;
#pragma unroll
  for (int nt = 0; nt < kSlabRows / 8; ++nt) {
    float acc[kParts][4] = {};
    const float* xr = x + (nt * 8 + g) * kSlabCols;  // B's column g: x's row nt*8 + g
#pragma unroll 4
    for (int ks = 0; ks < kSlabCols / 8; ++ks) {
      const int k0 = ks * 8 + t;  // A's columns k0, k0 + 4; B's rows k0, k0 + 4
      const uint32_t a[4] = {row0 == k0 ? kOne : 0u, row0 + 8 == k0 ? kOne : 0u, row0 == k0 + 4 ? kOne : 0u,
                             row0 + 8 == k0 + 4 ? kOne : 0u};
      const float v[2] = {xr[k0], xr[k0 + 4]};
      uint32_t parts[2][3];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        parts[i][0] = tf32_rna(v[i]);
        if (kSplit3) {
          const float r1 = __fsub_rn(v[i], __uint_as_float(parts[i][0]));
          parts[i][1] = tf32_rna(r1);
          parts[i][2] = tf32_rna(__fsub_rn(r1, __uint_as_float(parts[i][1])));
        }
      }
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const uint32_t b[2] = {parts[0][p], parts[1][p]};
        mma_tf32(acc[p], a, b);
      }
    }
    // D fragment: rows row0 (d0, d1) and row0 + 8 (d2, d3), columns
    // nt*8 + 2t and + 1.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = acc[0][i];
      if (kSplit3) v = __fadd_rn(__fadd_rn(v, acc[1][i]), acc[2][i]);
      const int row = row0 + (i / 2) * 8, col = nt * 8 + 2 * t + (i % 2);
      out[row * kSlabRows + col] = v;
    }
  }
}

}  // namespace

extern "C" {

// x [rows, cols] -> out [cols, rows]; (16, 128) and (128, 16) only.
cudaError_t gsplat_probe_transpose_smem(const float* x, float* out, int rows, int cols, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == kSlabRows && cols == kSlabCols) {
    transpose_smem_kernel<kSlabRows, kSlabCols><<<1, kThreads, 0, s>>>(x, out);
  } else if (rows == kSlabCols && cols == kSlabRows) {
    transpose_smem_kernel<kSlabCols, kSlabRows><<<1, kThreads, 0, s>>>(x, out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x [nblk, 16, 128] -> out [nblk, 128, 16]; x 16-byte aligned.
cudaError_t gsplat_probe_transpose_block_async(const float* x, float* out, int nblk, void* stream) {
  if (nblk <= 0 || reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorInvalidValue;
  transpose_block_async_kernel<<<nblk, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
  return cudaGetLastError();
}

// x [16, 128] -> out [128, 16] = eye(128) . x^T in TF32 (split3 0) or
// 3xTF32 (split3 1).
cudaError_t gsplat_probe_transpose_mma(const float* x, float* out, int split3, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split3) {
    transpose_mma_kernel<true><<<1, kMmaWarps * 32, 0, s>>>(x, out);
  } else {
    transpose_mma_kernel<false><<<1, kMmaWarps * 32, 0, s>>>(x, out);
  }
  return cudaGetLastError();
}

}  // extern "C"
