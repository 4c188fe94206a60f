// Forward tile compositor for Hopper (sm_90a), bound to Python through a
// plain C entry point (ctypes; see gsplat_tpu_torch/kernels/build.py).
//
// Replaces the TPU kernel gsplat_tpu/kernels/raster_fwd.py::_fwd_kernel as
// entered through forward_tiles_pallas: per tile, front-to-back alpha
// compositing of the tile's depth-ordered (tile, gaussian) pairs, producing
// colour, final transmittance and the number of pair blocks composited.
//
// What bounds it on this card: operations. Every pair slot of a tile is
// evaluated at all tile_size^2 pixels, about 20 FP32 operations and one
// expf each, against about 56 bytes per pair slot (its id and 13 gathered
// floats) and 16 bytes per pixel of output. At the 1080p headline (about
// 1.5M pair slots x 1024 pixels) that is some 3e10 FP32 operations and
// 1.5e9 exps for about 0.1 GB moved, so FP32 issue and the SFU exp rate,
// not memory, set the bound.
//
// What the design does about it: one thread block per tile and one thread
// per pixel, so the per-pixel recurrence C += rgb*alpha*T, T *= 1-alpha is a
// plain sequential loop in registers (the TPU kernel needed Hillis-Steele
// cumprod scans, an MXU colour matmul and a column-major feature slab with
// an in-VMEM transpose; none of that is needed here). The block gathers
// each batch of pair_block pairs' features once into shared memory, where
// every thread reads them as broadcasts, so global traffic stays per pair,
// not per pixel. The batch is also the early-stop granularity, as in the
// TPU kernel: after a batch, __syncthreads_or over "this pixel is
// coverable and T >= threshold" ends the tile.
//
// The density and compositing arithmetic uses round-to-nearest intrinsics
// (no FMA contraction) so that every product and sum is rounded as in the
// plain PyTorch version, whose operations are separate kernels: the alpha
// gates are hard thresholds, and a contracted FMA could flip one.

#include <cuda_runtime.h>

namespace {

constexpr int kRowFloats = 16;  // floats per packed feature row
constexpr int kLive = 13;       // live feature columns per row
// Column layout of a packed feature row (ops/binning.py FEAT_*).
enum Col { MX = 0, MY, CX, CY, CXY, OP, R, G, B, X0, Y0, X1, Y1 };

__global__ void raster_fwd_kernel(
    const float* __restrict__ feat,          // [N+1, 16]; row N is zero
    const int* __restrict__ pair_gaussian,   // [P]
    const int* __restrict__ tile_start,      // [T]
    const int* __restrict__ tile_count,      // [T]
    const int* __restrict__ tile_ids,        // [T] global tile index
    int n_tiles_x, int tile_size, int pair_block, float early_stop,
    int width, int height, float min_alpha, float max_alpha,
    float* __restrict__ color,               // [T, npix, 3]
    float* __restrict__ trans,               // [T, npix]
    int* __restrict__ blocks_done)           // [T]
{
  extern __shared__ float sfeat[];  // [kLive][pair_block]
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int npix = tile_size * tile_size;
  const int tid = tile_ids[t];
  const int start = tile_start[t];
  const int count = tile_count[t];
  const float px = (float)((tid % n_tiles_x) * tile_size + lin % tile_size);
  const float py = (float)((tid / n_tiles_x) * tile_size + lin / tile_size);
  // The reference's bbox clamp means the last pixel row and column (and
  // pixels outside the frame) never receive a contribution; they are left
  // out of the early-stop test (gsplat_tpu/kernels/raster_fwd.py:154-179).
  const bool coverable = (width > 0 && height > 0)
      ? (px < (float)(width - 1) && py < (float)(height - 1)) : true;

  const int nblocks = (count + pair_block - 1) / pair_block;
  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int done = 0;
  for (int b = 0; b < nblocks; ++b) {
    const int base = b * pair_block;
    const int n = min(pair_block, count - base);
    __syncthreads();  // the previous batch is consumed before it is overwritten
    for (int j = lin; j < n; j += blockDim.x) {
      const float4* row = reinterpret_cast<const float4*>(
          feat + (size_t)pair_gaussian[start + base + j] * kRowFloats);
      const float4 a = row[0], bq = row[1], c = row[2], d = row[3];
      const float v[kLive] = {a.x, a.y, a.z, a.w, bq.x, bq.y, bq.z, bq.w,
                              c.x, c.y, c.z, c.w, d.x};
#pragma unroll
      for (int f = 0; f < kLive; ++f) sfeat[f * pair_block + j] = v[f];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* s = sfeat + j;
      const float dx = __fsub_rn(s[MX * pair_block], px);
      const float dy = __fsub_rn(s[MY * pair_block], py);
      // density = -0.5 * (cx*dx*dx + cy*dy*dy) - cxy*dx*dy
      const float quad = __fadd_rn(
          __fmul_rn(__fmul_rn(s[CX * pair_block], dx), dx),
          __fmul_rn(__fmul_rn(s[CY * pair_block], dy), dy));
      const float density = __fsub_rn(
          __fmul_rn(-0.5f, quad),
          __fmul_rn(__fmul_rn(s[CXY * pair_block], dx), dy));
      const float alpha = fminf(__fmul_rn(s[OP * pair_block], expf(density)), max_alpha);
      const bool inside = px >= s[X0 * pair_block] && px < s[X1 * pair_block] &&
                          py >= s[Y0 * pair_block] && py < s[Y1 * pair_block];
      if (!(alpha > min_alpha && density <= 0.0f && inside)) continue;
      const float w = __fmul_rn(alpha, T);
      c0 = __fadd_rn(c0, __fmul_rn(s[R * pair_block], w));
      c1 = __fadd_rn(c1, __fmul_rn(s[G * pair_block], w));
      c2 = __fadd_rn(c2, __fmul_rn(s[B * pair_block], w));
      T = __fmul_rn(T, __fsub_rn(1.0f, alpha));
    }
    done = b + 1;
    if (early_stop > 0.0f && !__syncthreads_or(coverable && T >= early_stop)) break;
  }

  const size_t p = (size_t)t * npix + lin;
  color[p * 3 + 0] = c0;
  color[p * 3 + 1] = c1;
  color[p * 3 + 2] = c2;
  trans[p] = T;
  if (lin == 0) blocks_done[t] = done;
}

}  // namespace

// Launches one block of tile_size^2 threads per tile on `stream`; allocates
// nothing and does not synchronise. Returns cudaGetLastError() after the
// launch (a refused launch never runs, and a later synchronise would not
// report it).
extern "C" int gsplat_raster_fwd(
    const void* feat, const void* pair_gaussian, const void* tile_start,
    const void* tile_count, const void* tile_ids, int num_tiles, int n_tiles_x,
    int tile_size, int pair_block, float early_stop, int width, int height,
    float min_alpha, float max_alpha, void* color, void* trans,
    void* blocks_done, void* stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = (size_t)kLive * pair_block * sizeof(float);
  raster_fwd_kernel<<<num_tiles, tile_size * tile_size, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(feat), static_cast<const int*>(pair_gaussian),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(tile_ids), n_tiles_x, tile_size, pair_block,
      early_stop, width, height, min_alpha, max_alpha,
      static_cast<float*>(color), static_cast<float*>(trans),
      static_cast<int*>(blocks_done));
  return (int)cudaGetLastError();
}
