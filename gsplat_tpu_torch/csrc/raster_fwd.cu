// Forward tile compositor for Hopper (sm_90a), bound to Python through a
// plain C entry point (ctypes; see gsplat_tpu_torch/kernels/build.py).
//
// Replaces the TPU kernel gsplat_tpu/kernels/raster_fwd.py::_fwd_kernel,
// both as entered through forward_tiles_pallas and in its carry form
// (forward_tiles_carry): per tile, front-to-back alpha compositing of the
// tile's depth-ordered (tile, gaussian) pairs, producing colour, final
// transmittance and the number of pair blocks composited. The carry form is
// the same body with a non-null carry-in: colour and T start from a previous
// depth slice's (render/sliced.py) instead of (0, 1), and blocks_done counts
// this call's blocks only. A tile with no pairs writes its carry back
// unchanged. Resuming from the stored f32 state is exact, so a frame
// composited slice by slice equals the single call bitwise.
//
// What bounds it on this card: operations. A pair's gate costs about 19
// FP32 operations and one expf per pixel, and only where it passes are there
// 9 more to composite, against about 56 bytes per pair slot (its id and 13
// gathered floats) and 16 bytes per pixel of output. At the 1080p headline
// (about 1M pairs over 1024-pixel tiles) the gate at every pair-pixel is
// some 2e10 FP32 operations and 1e9 exps for about 0.1 GB moved, so FP32
// issue and the SFU exp rate, not memory, set the bound; and only 8.6% of
// those pair-pixels pass the gate.
//
// What the design does about it: one thread block per tile and one thread
// per pixel, so the per-pixel recurrence C += rgb*alpha*T, T *= 1-alpha is a
// plain sequential loop in registers (the TPU kernel needed Hillis-Steele
// cumprod scans, an MXU colour matmul and a column-major feature slab with
// an in-VMEM transpose; none of that is needed here). Each warp owns a
// compact 8x4 pixel rect and evaluates only the pairs whose alpha-bound rect
// meets it (raster_common.cuh): per 32 staged pairs, lane k tests pair k's
// warp span, a ballot gives the mask, and the warp walks its set bits in
// increasing order, which is front-to-back order. At the headline that cuts
// the evaluated pair-pixels about 4.5x. Batches of pair_block rows are
// gathered with cp.async two batches ahead of the one composited, so the
// gather overlaps the compute, and one block barrier per batch both hands
// the next batch over and takes the early-stop vote: after a batch,
// __syncthreads_or over "this pixel is coverable and T >= threshold" ends
// the tile, as in the TPU kernel.
//
// The density, alpha and gate arithmetic lives in raster_common.cuh, shared
// with the backward kernel so that it recomputes bitwise the same alphas.
// It and the compositing use round-to-nearest intrinsics (no FMA
// contraction) so that every product and sum is rounded as in the plain
// PyTorch version, whose operations are separate kernels: the alpha gates
// are hard thresholds, and a contracted FMA could flip one.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using namespace gsplat;

__global__ void __launch_bounds__(1024) raster_fwd_kernel(
    const float* __restrict__ feat,          // [N+1, 16]; row N is zero
    const int* __restrict__ pair_gaussian,   // [P]
    const int* __restrict__ tile_start,      // [T]
    const int* __restrict__ tile_count,      // [T]
    const int* __restrict__ tile_ids,        // [T] global tile index
    const float* __restrict__ carry_color,   // [T, npix, 3], or null: 0
    const float* __restrict__ carry_trans,   // [T, npix], or null: 1
    int n_tiles_x, int tile_size, int pair_block, float early_stop,
    int width, int height, float min_alpha, float max_alpha,
    float* __restrict__ color,               // [T, npix, 3]
    float* __restrict__ trans,               // [T, npix]
    int* __restrict__ blocks_done)           // [T]
{
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int npix = tile_size * tile_size;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const TilePixel me = tile_pixel(tile_ids[t], n_tiles_x, tile_size);
  const float px = me.px, py = me.py;
  // The reference's bbox clamp means the last pixel row and column (and
  // pixels outside the frame) never receive a contribution; they are left
  // out of the early-stop test (gsplat_tpu/kernels/raster_fwd.py:154-179).
  const bool coverable = (width > 0 && height > 0)
      ? (px < (float)(width - 1) && py < (float)(height - 1)) : true;

  const int nblocks = (count + pair_block - 1) / pair_block;
  const size_t p = (size_t)t * npix + me.pix;
  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (carry_color) {
    c0 = carry_color[p * 3 + 0];
    c1 = carry_color[p * 3 + 1];
    c2 = carry_color[p * 3 + 2];
    T = carry_trans[p];
  }
  Staging st(smem, feat, pair_gaussian + start, count, nblocks, pair_block, min_alpha);
  st.begin(me);
  __syncthreads();
  int done = 0;
  for (int b = 0; b < nblocks; ++b) {
    st.issue(b + 2);
    const int n = st.size(b);
    for (int g = 0; g < n; g += 32) {
      const int k = g + lane;
      unsigned mask = __ballot_sync(kFull, k < n && span_holds(st.span(b, k), me.wx, me.wy));
      while (mask) {
        const int j = g + __ffs(mask) - 1;
        mask &= mask - 1;
        const float* s = st.row(b, j);
        const PairEval e = eval_pair(s, px, py, min_alpha, max_alpha);
        if (!e.valid) continue;
        const float w = __fmul_rn(e.alpha, T);
        c0 = __fadd_rn(c0, __fmul_rn(s[R], w));
        c1 = __fadd_rn(c1, __fmul_rn(s[G], w));
        c2 = __fadd_rn(c2, __fmul_rn(s[B], w));
        T = __fmul_rn(T, __fsub_rn(1.0f, e.alpha));
      }
    }
    st.prepare(b + 1, me);
    done = b + 1;
    // The barrier hands batch b + 1 over and frees batch b's buffers.
    if (early_stop > 0.0f) {
      if (!__syncthreads_or(coverable && T >= early_stop)) break;
    } else {
      __syncthreads();
    }
  }
  st.finish();

  color[p * 3 + 0] = c0;
  color[p * 3 + 1] = c1;
  color[p * 3 + 2] = c2;
  trans[p] = T;
  if (threadIdx.x == 0) blocks_done[t] = done;
}

}  // namespace

// Launches one block of tile_size^2 threads per tile on `stream` (the tile
// must be a multiple of the warp rect: cudaErrorInvalidValue otherwise);
// allocates nothing and does not synchronise. carry_color and carry_trans are both
// null (start from colour 0 and T 1) or both set. Returns cudaGetLastError()
// after the launch (a refused launch never runs, and a later synchronise
// would not report it).
extern "C" int gsplat_raster_fwd(
    const void* feat, const void* pair_gaussian, const void* tile_start,
    const void* tile_count, const void* tile_ids, const void* carry_color,
    const void* carry_trans, int num_tiles, int n_tiles_x,
    int tile_size, int pair_block, float early_stop, int width, int height,
    float min_alpha, float max_alpha, void* color, void* trans,
    void* blocks_done, void* stream) {
  if (num_tiles == 0) return 0;
  if (!gsplat::tile_supported(tile_size) || pair_block < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = gsplat::staging_bytes(pair_block);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  raster_fwd_kernel<<<num_tiles, tile_size * tile_size, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(feat), static_cast<const int*>(pair_gaussian),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(tile_ids), static_cast<const float*>(carry_color),
      static_cast<const float*>(carry_trans), n_tiles_x, tile_size, pair_block,
      early_stop, width, height, min_alpha, max_alpha,
      static_cast<float*>(color), static_cast<float*>(trans),
      static_cast<int*>(blocks_done));
  return (int)cudaGetLastError();
}
