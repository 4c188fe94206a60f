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
// What the design does about it: one thread block per tile, and each
// thread owns one pixel of it (two or four in tiles of more than 1024
// pixels, with their state side by side in registers), so the per-pixel
// recurrence C += rgb*alpha*T, T *= 1-alpha is a plain sequential loop in
// registers (the TPU kernel needed Hillis-Steele cumprod scans, an MXU
// colour matmul and a column-major feature slab with an in-VMEM transpose;
// none of that is needed here). Each warp walks compact 8x4 pixel rects and
// evaluates in each only the pairs whose alpha-bound rect meets it
// (raster_common.cuh): per 32 staged pairs, lane k tests pair k's span
// against each of the warp's rects, a ballot per rect gives its mask, and
// the warp walks the set bits of their union in increasing order, which is
// front-to-back order, evaluating the pair in the rects whose mask holds
// it. At the headline that cuts the evaluated pair-pixels about 4.5x.
// Sub-batches of pair rows are gathered with cp.async two ahead of the one
// composited, so the gather overlaps the compute, and one block barrier per
// sub-batch hands the next one over; where a sub-batch ends a pair block,
// that barrier also takes the early-stop vote: __syncthreads_or over "one
// of this thread's pixels is coverable and its T >= threshold" ends the
// tile, as in the TPU kernel, whatever the tile's size.
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

// FX x FY: the rects of a warp (warp_layout in raster_common.cuh); kSplit:
// pair blocks staged in several sub-batches (Staging).
template <int FX, int FY, bool kSplit>
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
  constexpr int kSubs = FX * FY;
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int npix = tile_size * tile_size;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const TileGrid grid = tile_grid(tile_ids[t], n_tiles_x, tile_size);
  const TilePixels<FX, FY> me = tile_pixels<FX, FY>(grid);
  const int nblocks = (count + pair_block - 1) / pair_block;
  const size_t base = (size_t)t * npix;

  float T[kSubs], c0[kSubs], c1[kSubs], c2[kSubs];
  bool votes[kSubs];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    const bool owns = me.owns(i, grid, tile_size);
    const float px = me.px(i), py = me.py(i);
    // The reference's bbox clamp means the last pixel row and column (and
    // pixels outside the frame) never receive a contribution; they are left
    // out of the early-stop test (gsplat_tpu/kernels/raster_fwd.py:154-179),
    // and so are lanes past the tile's edge, which own no pixel.
    votes[i] = owns && ((width > 0 && height > 0) ? (px < (float)(width - 1) && py < (float)(height - 1)) : true);
    T[i] = 1.0f;
    c0[i] = c1[i] = c2[i] = 0.0f;
    if (carry_color && owns) {
      const size_t p = base + me.pix(i, grid, tile_size);
      c0[i] = carry_color[p * 3 + 0];
      c1[i] = carry_color[p * 3 + 1];
      c2[i] = carry_color[p * 3 + 2];
      T[i] = carry_trans[p];
    }
  }
  Staging<kSplit> st(smem, feat, pair_gaussian + start, count, nblocks, pair_block, min_alpha);
  st.begin(grid);
  __syncthreads();
  int done = 0;
  for (int s = 0; s < st.batches; ++s) {
    st.issue(s + 2);
    const int n = st.size(s);
    for (int g = 0; g < n; g += 32) {
      const int k = g + lane;
      const unsigned span = k < n ? st.span(s, k) : kNoWarps;
      unsigned mask[kSubs], walk = 0u;
#pragma unroll
      for (int i = 0; i < kSubs; ++i) {
        mask[i] = __ballot_sync(kFull, span_holds(span, me.rect_x(i), me.rect_y(i)));
        walk |= mask[i];
      }
      while (walk) {
        const int bit = __ffs(walk) - 1;
        walk &= walk - 1;
        const float* row = st.row(s, g + bit);
#pragma unroll
        for (int i = 0; i < kSubs; ++i) {
          if (kSubs > 1 && !((mask[i] >> bit) & 1u)) continue;
          const PairEval e = eval_pair(row, me.px(i), me.py(i), min_alpha, max_alpha);
          if (!e.valid) continue;
          const float w = __fmul_rn(e.alpha, T[i]);
          c0[i] = __fadd_rn(c0[i], __fmul_rn(row[R], w));
          c1[i] = __fadd_rn(c1[i], __fmul_rn(row[G], w));
          c2[i] = __fadd_rn(c2[i], __fmul_rn(row[B], w));
          T[i] = __fmul_rn(T[i], __fsub_rn(1.0f, e.alpha));
        }
      }
    }
    st.prepare(s + 1, grid);
    // The barrier hands sub-batch s + 1 over and frees sub-batch s's
    // buffers; after a pair block's last sub-batch it also takes the vote.
    if (!st.ends_block(s)) {
      __syncthreads();
      continue;
    }
    done = st.block(s) + 1;
    if (early_stop > 0.0f) {
      bool live = false;
#pragma unroll
      for (int i = 0; i < kSubs; ++i) live = live || (votes[i] && T[i] >= early_stop);
      if (!__syncthreads_or(live)) break;
    } else {
      __syncthreads();
    }
  }
  st.finish();

#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    if (!me.owns(i, grid, tile_size)) continue;
    const size_t p = base + me.pix(i, grid, tile_size);
    color[p * 3 + 0] = c0[i];
    color[p * 3 + 1] = c1[i];
    color[p * 3 + 2] = c2[i];
    trans[p] = T[i];
  }
  if (threadIdx.x == 0) blocks_done[t] = done;
}

using FwdKernel = decltype(&raster_fwd_kernel<1, 1, false>);

// The instantiation for a warp layout and pair block.
FwdKernel pick(const WarpLayout& l, int pair_block) {
  if (pair_block > kSubRows) {
    return l.fx == 1 ? (l.fy == 1 ? &raster_fwd_kernel<1, 1, true> : &raster_fwd_kernel<1, 2, true>) : &raster_fwd_kernel<2, 2, true>;
  }
  return l.fx == 1 ? (l.fy == 1 ? &raster_fwd_kernel<1, 1, false> : &raster_fwd_kernel<1, 2, false>) : &raster_fwd_kernel<2, 2, false>;
}

}  // namespace

// Launches one block per tile, of warp_layout(tile_size).warps warps, on
// `stream` (a tile edge outside 1..kMaxTile or a pair block below 1:
// cudaErrorInvalidValue); allocates nothing and does not synchronise.
// carry_color and carry_trans are both null (start from colour 0 and T 1)
// or both set. Returns cudaGetLastError() after the launch (a refused
// launch never runs, and a later synchronise would not report it).
extern "C" int gsplat_raster_fwd(
    const void* feat, const void* pair_gaussian, const void* tile_start,
    const void* tile_count, const void* tile_ids, const void* carry_color,
    const void* carry_trans, int num_tiles, int n_tiles_x,
    int tile_size, int pair_block, float early_stop, int width, int height,
    float min_alpha, float max_alpha, void* color, void* trans,
    void* blocks_done, void* stream) {
  if (num_tiles == 0) return 0;
  const gsplat::WarpLayout layout = gsplat::warp_layout(tile_size);
  if (layout.fx == 0 || pair_block < 1) return (int)cudaErrorInvalidValue;
  const FwdKernel kernel = pick(layout, pair_block);
  const size_t smem = gsplat::staging_bytes(pair_block);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<num_tiles, layout.warps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(feat), static_cast<const int*>(pair_gaussian),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(tile_ids), static_cast<const float*>(carry_color),
      static_cast<const float*>(carry_trans), n_tiles_x, tile_size, pair_block,
      early_stop, width, height, min_alpha, max_alpha,
      static_cast<float*>(color), static_cast<float*>(trans),
      static_cast<int*>(blocks_done));
  return (int)cudaGetLastError();
}
