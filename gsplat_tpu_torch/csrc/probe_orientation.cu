// The compositor's inner loop in two orientations, for Hopper (sm_90a),
// bound to Python through plain C entry points (ctypes; see
// gsplat_tpu_torch/kernels/build.py and the wrappers in
// gsplat_tpu_torch/kernels/probes.py).
//
// Replaces the TPU kernels of scripts/orientation_test.py, which time the
// forward compositor's chunk math on one 32x32 tile (1024 pixels) in both
// vector-register orientations: kernel_a (pairs on sublanes, 8192 chunks
// of 32 pairs) and kernel_b (pixels on sublanes, 2048 chunks of 128
// pairs). Both walk 268,435,456 pair-pixels. Chunk c's features are the
// input block scaled by 1 + 1e-6 * c in f32, so no chunk repeats another.
// The outputs are [8, 1024] (A) and [1024, 8] (B): colour, then T, then
// zeros. As in the TPU kernels the walk starts from colour 0 and a
// transmittance t0 (the TPU kernels' accumulator starts at zero, so t0 = 0
// is their function, and its output is zero; t0 = 1 is a real composite).
// Like the TPU probe, each is one thread block of 1024 threads on one SM.
//
// What bounds them on this card: operations on one SM. Every pair-pixel
// needs the gate (19 FP32 operations and an expf, raster_common.cuh
// eval_pair) and a pair-pixel that passes 9 more to composite: 268M
// pair-pixels x 19 at the SM's 128 FMA lanes (two operations each) at
// 1.98 GHz is 10.05 ms, the expf at 16 a clock 8.47 ms. eval_pair rounds
// each product and sum on its own (__fmul_rn / __fadd_rn: no FMA, for the
// compositors' bitwise parity with their plain versions), one instruction
// an operation, which halves that rate: 20.1 ms.
//
// What the designs do:
//   - orientation_a (pairs in sequence, one thread a pixel: the port's
//     compositors' orientation). For each chunk the block writes the 32
//     scaled feature rows into shared memory (double-buffered, one barrier
//     a chunk), and each thread walks them front to back through
//     gsplat::eval_pair, the compositors' own gate, compositing
//     C += rgb * (alpha * T), T *= 1 - alpha where the gate passes. The
//     running product in registers takes the place of the TPU's
//     Hillis-Steele scan down the pairs.
//   - orientation_b (pairs across lanes; the TPU's "pixels on sublanes,
//     scan along lanes"). Warp w owns pixels [32w, 32w + 32), lane i pixel
//     32w + i's colour and T. A chunk's 128 pairs are four sub-chunks of
//     32, lane k holding pair k in registers (read from the feature-major
//     block in shared memory and scaled), evaluated by eval_pair's
//     register form. For each of its 32 pixels the
//     warp evaluates the 32 pairs (one a lane), takes the exclusive
//     product of 1 - a by a 5-step __shfl_up_sync doubling (the TPU's
//     Hillis-Steele), weighs w = (a * t_excl) * T, and sums w * rgb over
//     the lanes by __shfl_xor_sync butterflies; the pixel's owner lane
//     takes the sums and T times the sub-chunk's product. The TPU kernel's
//     colour product ran on the MXU against a zero matrix; here each pair's
//     own rgb (features 6-8) is used (both give zero at t0 = 0), and the
//     sums stay in f32.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

constexpr int kEdge = 32;
constexpr int kNpix = kEdge * kEdge;  // 1024: one thread a pixel
constexpr int kPairsA = 32;           // pairs a chunk in A ([32, 128] block, a pair a row)
constexpr int kColsA = 128;           // A's row width (features 0-12 are read)
constexpr int kPairsB = 128;          // pairs a chunk in B ([16, 128] block, a pair a column)
constexpr int kFeatB = 16;
constexpr int kLanes = 32;
constexpr int kOut = 8;               // colour, T, zeros
using gsplat::kRowFloats;

// The chunk's feature scale, 1 + 1e-6 * c in f32 (JAX's weak typing of
// 1.0 + 1e-6 * c with an int32 c).
__device__ __forceinline__ float chunk_scale(int c) {
  return __fadd_rn(1.0f, __fmul_rn(1e-6f, static_cast<float>(c)));
}

__global__ void __launch_bounds__(kNpix) orientation_a_kernel(
    const float* __restrict__ feat, int reps, float t0, float min_alpha, float max_alpha,
    float* __restrict__ out) {
  __shared__ __align__(16) float raw[kPairsA * kRowFloats];
  __shared__ __align__(16) float rows[2][kPairsA * kRowFloats];
  const int tid = threadIdx.x;
  if (tid < kPairsA * kRowFloats) raw[tid] = feat[(tid / kRowFloats) * kColsA + tid % kRowFloats];
  const float px = static_cast<float>(tid % kEdge), py = static_cast<float>(tid / kEdge);
  float T = t0, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  __syncthreads();
  for (int c = 0; c < reps; ++c) {
    // Buffer c & 1 was last read in chunk c - 2; every thread has passed
    // chunk c - 1's barrier, so it is free.
    float* s = rows[c & 1];
    if (tid < kPairsA * kRowFloats) s[tid] = __fmul_rn(raw[tid], chunk_scale(c));
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kPairsA; ++j) {
      const float* row = s + j * kRowFloats;
      const gsplat::PairEval e = gsplat::eval_pair(row, px, py, min_alpha, max_alpha);
      if (e.valid) {
        const float w = __fmul_rn(e.alpha, T);
        cr = __fadd_rn(cr, __fmul_rn(row[gsplat::R], w));
        cg = __fadd_rn(cg, __fmul_rn(row[gsplat::G], w));
        cb = __fadd_rn(cb, __fmul_rn(row[gsplat::B], w));
        T = __fmul_rn(T, __fsub_rn(1.0f, e.alpha));
      }
    }
  }
  out[0 * kNpix + tid] = cr;
  out[1 * kNpix + tid] = cg;
  out[2 * kNpix + tid] = cb;
  out[3 * kNpix + tid] = T;
#pragma unroll
  for (int k = 4; k < kOut; ++k) out[k * kNpix + tid] = 0.0f;
}

// The sum over the warp's lanes, left in every lane (xor butterfly).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(gsplat::kFull, v, m));
  return v;
}

__global__ void __launch_bounds__(kNpix) orientation_b_kernel(
    const float* __restrict__ feat, int reps, float t0, float min_alpha, float max_alpha,
    float* __restrict__ out) {
  __shared__ float raw[kFeatB * kPairsB];  // feature-major: raw[f * 128 + k] is pair k's feature f
  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  for (int i = tid; i < kFeatB * kPairsB; i += kNpix) raw[i] = feat[i];
  const float py = static_cast<float>(warp);  // the warp's pixels are row `warp` of the tile
  float T = t0, cr = 0.0f, cg = 0.0f, cb = 0.0f;  // pixel 32 * warp + lane's
  __syncthreads();
  for (int c = 0; c < reps; ++c) {
    const float scale = chunk_scale(c);
    for (int q = 0; q < kPairsB / kLanes; ++q) {
      // This lane's pair, scaled, in registers in the compositors' row layout.
      const float* p = raw + q * kLanes + lane;
      auto at = [&](int f) { return __fmul_rn(p[f * kPairsB], scale); };
      const float4 fa = make_float4(at(gsplat::MX), at(gsplat::MY), at(gsplat::CX), at(gsplat::CY));
      const float4 fb = make_float4(at(gsplat::CXY), at(gsplat::OP), at(gsplat::R), at(gsplat::G));
      const float4 fc = make_float4(at(gsplat::B), at(gsplat::X0), at(gsplat::Y0), at(gsplat::X1));
      const float y1 = at(gsplat::Y1);
      for (int i = 0; i < kLanes; ++i) {
        const gsplat::PairEval e =
            gsplat::eval_pair(fa, fb, fc, y1, static_cast<float>(i), py, min_alpha, max_alpha);
        const float a = e.valid ? e.alpha : 0.0f;
        float y = __fsub_rn(1.0f, a);  // inclusive product of 1 - a over lanes 0..lane, after the scan
#pragma unroll
        for (int s = 1; s < kLanes; s <<= 1) {
          const float v = __shfl_up_sync(gsplat::kFull, y, s);
          if (lane >= s) y = __fmul_rn(y, v);
        }
        float t_excl = __shfl_up_sync(gsplat::kFull, y, 1);
        if (lane == 0) t_excl = 1.0f;
        const float t_pix = __shfl_sync(gsplat::kFull, T, i);
        const float w = __fmul_rn(__fmul_rn(a, t_excl), t_pix);
        const float sr = warp_sum(__fmul_rn(w, fb.z));
        const float sg = warp_sum(__fmul_rn(w, fb.w));
        const float sb = warp_sum(__fmul_rn(w, fc.x));
        const float total = __shfl_sync(gsplat::kFull, y, kLanes - 1);
        if (lane == i) {
          cr = __fadd_rn(cr, sr);
          cg = __fadd_rn(cg, sg);
          cb = __fadd_rn(cb, sb);
          T = __fmul_rn(t_pix, total);
        }
      }
    }
  }
  float* o = out + static_cast<size_t>(tid) * kOut;
  o[0] = cr;
  o[1] = cg;
  o[2] = cb;
  o[3] = T;
#pragma unroll
  for (int k = 4; k < kOut; ++k) o[k] = 0.0f;
}

}  // namespace

extern "C" {

// feat [32, 128] f32 -> out [8, 1024]: `reps` chunks of its 32 pair rows.
cudaError_t gsplat_probe_orientation_a(const float* feat, int reps, float t0, float min_alpha, float max_alpha,
                                       float* out, void* stream) {
  if (reps < 0) return cudaErrorInvalidValue;
  orientation_a_kernel<<<1, kNpix, 0, static_cast<cudaStream_t>(stream)>>>(feat, reps, t0, min_alpha, max_alpha,
                                                                            out);
  return cudaGetLastError();
}

// feat [16, 128] f32 (a pair a column) -> out [1024, 8]: `reps` chunks of
// its 128 pairs.
cudaError_t gsplat_probe_orientation_b(const float* feat, int reps, float t0, float min_alpha, float max_alpha,
                                       float* out, void* stream) {
  if (reps < 0) return cudaErrorInvalidValue;
  orientation_b_kernel<<<1, kNpix, 0, static_cast<cudaStream_t>(stream)>>>(feat, reps, t0, min_alpha, max_alpha,
                                                                            out);
  return cudaGetLastError();
}

}  // extern "C"
