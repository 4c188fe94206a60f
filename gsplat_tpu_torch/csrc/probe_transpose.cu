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
//   - transpose_smem issues each thread's two float4 loads before any
//     shared store, stages the block in a padded tile, and writes one
//     float4 of the output a thread (four staged rows at one column),
//     consecutive threads on consecutive float4s. The padding is picked
//     per shape so that those column reads meet 32 distinct banks: C + 2
//     at [16, 128] (a warp reads 4 row groups x 8 columns), C + 1 at
//     [128, 16] with each quarter-warp reading its four rows in a rotated
//     order, rotated back with selects (a warp reads 32 row groups of one
//     column). Every 32-bit pattern passes through unchanged.
//   - transpose_block_async is the Hopper form of
//     pltpu.make_async_copy(x_hbm.at[b], slab, sem).start()/.wait(): one
//     thread issues one cp.async.bulk of the slab's 8,192 contiguous bytes
//     that completes on an mbarrier (the semaphore), and every thread waits
//     on the barrier's phase before reading the slab.
//   - transpose_mma runs the same product eye(128) . x^T on the tensor
//     cores: mma.sync m16n8k8 with TF32 operands and f32 accumulators over
//     all 16 k-steps of the product (the identity's zero blocks too:
//     0 * inf and 0 * NaN are what spread NaN down a column, as in the
//     MXU's product). 768 mma in 3xTF32 on one SM took longer than the
//     whole copy, so the product is spread: a block a 16 x 8 output tile
//     (or two), which stages only the 8 rows of x the tile reads (their
//     float4 loads all in flight, each element flushed and split once,
//     without branches), and each warp takes a quarter of the k-steps,
//     reading its B fragments as float4s of the staged parts; the warps'
//     sums meet in shared memory. The layout (blocks, warps, k-steps a
//     warp; the template arguments of launch_transpose_mma) was picked on
//     the card among five: 16 blocks x 4 warps for 3xTF32, 8 x 8 for TF32.
//     The rules of the staging, which the plain version (kernels/probes.py)
//     follows:
//       * zero and subnormal elements become +0 (the product then gives +0
//         for -0.0, and a subnormal reads as zero, as XLA's f32 dot does);
//       * a non-finite element passes whole into the first part (NaN as a
//         quiet NaN whose TF32 bits are NaN), its other parts 0;
//       * TF32 mode rounds each element to TF32 (10 mantissa bits) to
//         nearest with ties away from zero, cvt.rna's rounding, on the bit
//         pattern (a finite value past TF32's largest rounds to inf); the
//         result is that rounding of x, transposed;
//       * 3xTF32 splits each element by truncation into hi + mid + lo,
//         each exact in TF32 (hi the top 11 significant bits, mid the next
//         11, lo the last 2), so that (hi + mid) + lo gives x back without
//         overflow. An element below 2^-63 is split after scaling by 2^64
//         and its output multiplied by 2^-64: TF32 holds no bit below
//         2^-136, and no part that reaches the tensor cores is subnormal.
//     Every output element has one nonzero product, so each accumulator
//     is exact and 3xTF32 gives x back bitwise for every finite normal x.

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlabRows = 16;
constexpr int kSlabCols = 128;
constexpr int kSlabFloats = kSlabRows * kSlabCols;
constexpr int kSlabVecs = kSlabFloats / 4;  // 512 float4s
constexpr uint32_t kSlabBytes = kSlabFloats * sizeof(float);  // 8,192

// ---------------------------------------------------------------------
// transpose_smem: [R, C] -> [C, R] through a padded shared tile.

// Row stride of the staged tile. Output float4 q holds rows 4a .. 4a + 3
// at column c (c = q / (R/4), a = q % (R/4)), read one row a load. At
// [16, 128] a warp reads 4 row groups x 8 columns: stride C + 2 puts the
// groups 8 banks apart. At [128, 16] a warp reads 32 row groups of one
// column: an odd stride (C + 1) and each quarter-warp starting at another
// of its four rows (kRotate) put the 32 reads on 32 banks.
template <int R, int C>
__host__ __device__ constexpr int padded_stride() { return C + (R >= 32 ? 1 : 32 / R); }

template <int R, int C>
__global__ void __launch_bounds__(kThreads) transpose_smem_kernel(const float* __restrict__ x,
                                                                  float* __restrict__ out) {
  constexpr int S = padded_stride<R, C>();
  constexpr int kPer = kSlabVecs / kThreads;  // float4s a thread, in and out
  constexpr bool kRotate = R >= 32;
  __shared__ float tile[R * S];
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = x4[threadIdx.x + i * kThreads];  // every load in flight
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int f = threadIdx.x + i * kThreads;
    float* row = tile + (f / (C / 4)) * S + (f % (C / 4)) * 4;
    row[0] = v[i].x;
    row[1] = v[i].y;
    row[2] = v[i].z;
    row[3] = v[i].w;
  }
  __syncthreads();
  const int rot = kRotate ? (threadIdx.x / 8) % 4 : 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int c = q / (R / 4), r0 = (q % (R / 4)) * 4;
    float w[4];  // w[j]: staged row r0 + (j + rot) % 4
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = tile[(r0 + (j + rot) % 4) * S + c];
    // out[c][r0 + m] = x[r0 + m][c] = w[(m - rot) % 4]: rotate back by
    // rot's two bits, with selects (no branch diverges the warp).
    float u[4], o[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) u[m] = rot & 1 ? w[(m + 3) % 4] : w[m];
#pragma unroll
    for (int m = 0; m < 4; ++m) o[m] = rot & 2 ? u[(m + 2) % 4] : u[m];
    reinterpret_cast<float4*>(out)[q] = make_float4(o[0], o[1], o[2], o[3]);
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

constexpr uint32_t kExpMask = 0x7f800000u;
constexpr uint32_t kTf32Mask = 0xffffe000u;  // TF32 keeps the top 19 bits
constexpr uint32_t kSignBit = 0x80000000u;
constexpr uint32_t kQuietNan = 0x7fc00000u;
constexpr uint32_t kOne = 0x3f800000u;      // 1.0f, exact in TF32
constexpr uint32_t kTinyExp = 64u << 23;    // below 2^-63 an element is split scaled
constexpr float kTinyScale = 0x1p64f, kTinyUnscale = 0x1p-64f;

// A finite f32 bit pattern rounded to TF32, to nearest with ties away from
// zero (add half of the 13 dropped bits' unit to the magnitude, clear
// them); past TF32's largest value the carry gives inf.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t b) { return (b + 0x1000u) & kTf32Mask; }

// How one element is staged (the rules at the top of this file), without
// branches: its TF32 parts and, for 3xTF32, the factor its output is
// multiplied by.
template <bool kSplit3>
__device__ __forceinline__ void stage_element(float v, float (&part)[kSplit3 ? 3 : 1], float& unscale) {
  const uint32_t b = __float_as_uint(v);
  const uint32_t e = b & kExpMask;
  const bool zero = e == 0, special = e == kExpMask;  // +-0 and subnormals; inf and NaN
  const float whole = (b & ~(kExpMask | kSignBit)) ? __uint_as_float(kQuietNan) : v;
  if constexpr (!kSplit3) {
    part[0] = zero ? 0.0f : special ? whole : __uint_as_float(tf32_rna(b));
    unscale = 1.0f;
  } else {
    const bool tiny = e < kTinyExp;
    const float s = __fmul_rn(v, tiny ? kTinyScale : 1.0f);  // exact
    const float hi = __uint_as_float(__float_as_uint(s) & kTf32Mask);
    const float r1 = __fsub_rn(s, hi);  // exact: the low 13 bits
    const float mid = __uint_as_float(__float_as_uint(r1) & kTf32Mask);
    const float lo = __fsub_rn(r1, mid);  // exact, at most 2 bits
    part[0] = zero ? 0.0f : special ? whole : hi;
    part[1] = zero || special ? 0.0f : mid;
    part[2] = zero || special ? 0.0f : lo;
    unscale = tiny && !zero ? kTinyUnscale : 1.0f;
  }
}

// d += a . b for one m16n8k8 tile (row-major A, column-major B).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kTileVecs = 8 * kSlabCols / 4;  // float4s of x's 8 rows that one 8-column tile of the output reads
constexpr int kMmaStride = 144;      // staged part rows: a B-fragment float4 read meets 32 banks a quarter-warp
constexpr int kUnscaleStride = 132;  // the final unscale reads meet 32 banks

// Block b computes the output tile of columns [8 nt, 8 nt + 8) (nt = b % 2)
// and rows [16 s0, 16 (s0 + kStrips)) (s0 = b / 2 * kStrips): it stages the
// 8 rows of x that tile reads, and each warp takes one 16-row strip (m) and
// 1 / kKWarps of the product's 16 k-steps, walked in two independent
// accumulator chains. The chains are added in registers, the warps of a
// strip through shared memory, in a fixed order; every output element has
// one nonzero term, so each partial sum is exact and keeps the product's
// NaN and inf. The k index is walked in an order that makes each thread's
// B fragments of two k-steps one float4: in k-steps 2j and 2j + 1,
// fragment slot t (thread t of each group) takes x's column 16j + 4t + 2h
// and slot t + 4 column 16j + 4t + 2h + 1 (h = 0, 1), and the identity's A
// fragment is built for the same columns.
template <bool kSplit3, int kStrips, int kKWarps>
__global__ void __launch_bounds__(kStrips * kKWarps * 32) transpose_mma_kernel(const float* __restrict__ x,
                                                                              float* __restrict__ out) {
  constexpr int kParts = kSplit3 ? 3 : 1;
  constexpr int kBlockThreads = kStrips * kKWarps * 32;
  constexpr int kPer = kTileVecs / kBlockThreads;  // staged float4s a thread
  constexpr int kGroups = kSlabCols / 16 / kKWarps;  // 16-column groups (two k-steps) a warp walks
  static_assert(kPer >= 1 && kGroups >= 1, "layout");
  __shared__ __align__(16) float parts[kParts][8 * kMmaStride];
  __shared__ __align__(16) float unscales[kSplit3 ? 8 * kUnscaleStride : 4];
  __shared__ float partials[kStrips * kKWarps * kParts * 4 * 32];
  const int nt = blockIdx.x % 2, s0 = blockIdx.x / 2 * kStrips;

  // Stage the tile's rows of x: their float4s all in flight, then each
  // element split once.
  const float4* x4 = reinterpret_cast<const float4*>(x) + nt * kTileVecs;
  float4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = x4[threadIdx.x + i * kBlockThreads];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int f = threadIdx.x + i * kBlockThreads;
    const int r = f / (kSlabCols / 4), c = (f % (kSlabCols / 4)) * 4;
    const float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    float p[4][kParts], s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) stage_element<kSplit3>(e[k], p[k], s[k]);
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      *reinterpret_cast<float4*>(&parts[q][r * kMmaStride + c]) = make_float4(p[0][q], p[1][q], p[2][q], p[3][q]);
    }
    if constexpr (kSplit3) {
      *reinterpret_cast<float4*>(&unscales[r * kUnscaleStride + c]) = make_float4(s[0], s[1], s[2], s[3]);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // groupID, threadID_in_group (PTX fragment layouts)
  const int kw = warp % kKWarps, strip = warp / kKWarps;
  {
    const int row0 = (s0 + strip) * 16 + g;  // output rows row0 and row0 + 8
    float acc[2][kParts][4] = {};
#pragma unroll
    for (int jj = 0; jj < kGroups; ++jj) {
      const int j = kw * kGroups + jj;
      float4 b[kParts];
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        b[q] = *reinterpret_cast<const float4*>(&parts[q][g * kMmaStride + 16 * j + 4 * t]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k0 = 16 * j + 4 * t + 2 * h;  // the columns of slots t and t + 4: k0 and k0 + 1
        const uint32_t a[4] = {row0 == k0 ? kOne : 0u, row0 + 8 == k0 ? kOne : 0u, row0 == k0 + 1 ? kOne : 0u,
                               row0 + 8 == k0 + 1 ? kOne : 0u};
#pragma unroll
        for (int q = 0; q < kParts; ++q) {
          const uint32_t bf[2] = {__float_as_uint(h ? b[q].z : b[q].x), __float_as_uint(h ? b[q].w : b[q].y)};
          mma_tf32(acc[h][q], a, bf);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        partials[((warp * kParts + q) * 4 + i) * 32 + lane] = __fadd_rn(acc[0][q][i], acc[1][q][i]);
      }
    }
  }
  __syncthreads();

  // Two threads a lane of each strip add its warps' sums in order, then
  // the parts as (hi + mid) + lo, and store the D fragment's column pairs:
  // rows 16 s + g (ih 0: d0, d1) and + 8 (ih 1: d2, d3), columns 8 nt + 2t
  // and + 1.
#pragma unroll
  for (int f = threadIdx.x; f < kStrips * 64; f += kBlockThreads) {
    const int so = f / 64, ih = f / 32 % 2, fl = f % 32;
    const int row = (s0 + so) * 16 + fl / 4 + 8 * ih, col = nt * 8 + 2 * (fl % 4);
    float o[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = 2 * ih + k;
      float sum[kParts];
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        sum[q] = partials[((so * kKWarps * kParts + q) * 4 + i) * 32 + fl];
#pragma unroll
        for (int w = 1; w < kKWarps; ++w) {
          sum[q] = __fadd_rn(sum[q], partials[(((so * kKWarps + w) * kParts + q) * 4 + i) * 32 + fl]);
        }
      }
      o[k] = sum[0];
      if constexpr (kSplit3) {
        o[k] = __fadd_rn(__fadd_rn(o[k], sum[1]), sum[2]);
        // x[col + k][row]'s factor (exact)
        o[k] = __fmul_rn(o[k], unscales[(col % 8 + k) * kUnscaleStride + row]);
      }
    }
    *reinterpret_cast<float2*>(&out[row * kSlabRows + col]) = make_float2(o[0], o[1]);
  }
}

template <bool kSplit3, int kStrips, int kKWarps>
void launch_transpose_mma(const float* x, float* out, cudaStream_t s) {
  constexpr int kBlocks = 2 * (kSlabCols / 16 / kStrips);
  transpose_mma_kernel<kSplit3, kStrips, kKWarps><<<kBlocks, kStrips * kKWarps * 32, 0, s>>>(x, out);
}

}  // namespace

extern "C" {

// x [rows, cols] -> out [cols, rows]; (16, 128) and (128, 16) only; x and
// out 16-byte aligned.
cudaError_t gsplat_probe_transpose_smem(const float* x, float* out, int rows, int cols, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) return cudaErrorInvalidValue;
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
// 3xTF32 (split3 1); x and out 16-byte aligned.
cudaError_t gsplat_probe_transpose_mma(const float* x, float* out, int split3, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) return cudaErrorInvalidValue;
  if (split3) {
    launch_transpose_mma<true, 1, 4>(x, out, s);  // 16 blocks x 4 warps
  } else {
    launch_transpose_mma<false, 2, 4>(x, out, s);  // 8 blocks x 8 warps
  }
  return cudaGetLastError();
}

}  // extern "C"
