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
// Tiles of edge above 64 (kGroups): each pixel group is one block (tiles x
// groups blocks; raster_common.cuh BlockPixels). The tile's early stop in
// the TPU kernel comes after the first pair block at which no coverable
// pixel of the tile has T >= threshold; T never grows, so that block is the
// last of the blocks at which each group's own pixels pass that test. So
// with early stop on, each group block votes on its own pixels and records
// its blocks in group_done; a second launch, the resume, then starts from
// every group's colour and T and walks blocks [done_g, done_tile) of the
// tile's pairs with the vote off (done_tile the most over the tile's
// groups; a group with none left has a count of 0 and passes its state
// through) and writes done_tile as the tile's blocks_done. Every pixel then
// takes the plain version's steps in its order: the frame stays bitwise.
// With early stop off each group walks every block and no resume is run.
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
// pair blocks staged in several sub-batches (Staging); kGroups: a block is
// a pixel group of a larger tile (BlockPixels).
template <int FX, int FY, bool kSplit, bool kGroups>
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
    int* __restrict__ blocks_done,           // [T]
    GroupLayout gl,                          // kGroups: the tile's groups
    int* __restrict__ group_done,            // kGroups: [T, G] each group's blocks, or null (early stop off)
    int resume)                              // kGroups: the resume launch (group_done read)
{
  constexpr int kSubs = FX * FY;
  extern __shared__ __align__(16) float smem[];
  const BlockPixels<kGroups> blk(tile_ids, n_tiles_x, tile_size, gl);
  const int t = blk.t;
  const int lane = threadIdx.x & 31;
  int start = tile_start[t];
  int count = tile_count[t];
  int tile_done = 0;
  if constexpr (kGroups) {
    if (resume) {
      // Blocks [own, tile_done) of the tile's pairs, up to its count.
      const int groups = gl.n * gl.n;
      const int own = group_done[(size_t)t * groups + blk.g];
      for (int k = 0; k < groups; ++k) tile_done = max(tile_done, group_done[(size_t)t * groups + k]);
      count = max(min(count, tile_done * pair_block) - own * pair_block, 0);
      start += own * pair_block;
    }
  }
  const TileGrid& grid = blk.grid;
  const TilePixels<FX, FY> me = tile_pixels<FX, FY>(grid);
  const int nblocks = (count + pair_block - 1) / pair_block;
  const PixIndex<kGroups> npix = (PixIndex<kGroups>)tile_size * tile_size;
  const size_t base = (size_t)t * npix;

  float T[kSubs], c0[kSubs], c1[kSubs], c2[kSubs];
  bool votes[kSubs];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    const bool owns = blk.owns(me, i, tile_size);
    const float px = me.px(i), py = me.py(i);
    // The reference's bbox clamp means the last pixel row and column (and
    // pixels outside the frame) never receive a contribution; they are left
    // out of the early-stop test (gsplat_tpu/kernels/raster_fwd.py:154-179),
    // and so are lanes past the tile's edge, which own no pixel.
    votes[i] = owns && ((width > 0 && height > 0) ? (px < (float)(width - 1) && py < (float)(height - 1)) : true);
    T[i] = 1.0f;
    c0[i] = c1[i] = c2[i] = 0.0f;
    if (carry_color && owns) {
      const size_t p = base + blk.pix(me, i, tile_size);
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
    if (!blk.owns(me, i, tile_size)) continue;
    const size_t p = base + blk.pix(me, i, tile_size);
    color[p * 3 + 0] = c0[i];
    color[p * 3 + 1] = c1[i];
    color[p * 3 + 2] = c2[i];
    trans[p] = T[i];
  }
  if (threadIdx.x == 0) {
    if constexpr (kGroups) {
      if (resume) {
        if (blk.g == 0) blocks_done[t] = tile_done;
      } else if (group_done) {
        group_done[(size_t)t * gl.n * gl.n + blk.g] = done;
      } else if (blk.g == 0) {
        blocks_done[t] = done;  // early stop off: every group walked every block
      }
    } else {
      blocks_done[t] = done;
    }
  }
}

using FwdKernel = decltype(&raster_fwd_kernel<1, 1, false, false>);

// The instantiation for a warp layout and pair block. Groups have edges in
// (32, 64], whose layouts are 1x2 or 2x2 rects a warp: only those are
// instantiated with kGroups (null for 1x1).
FwdKernel pick(const WarpLayout& l, int pair_block, bool groups) {
  if (groups) {
    if (pair_block > kSubRows)
      return l.fx == 1 ? (l.fy == 1 ? nullptr : &raster_fwd_kernel<1, 2, true, true>) : &raster_fwd_kernel<2, 2, true, true>;
    return l.fx == 1 ? (l.fy == 1 ? nullptr : &raster_fwd_kernel<1, 2, false, true>) : &raster_fwd_kernel<2, 2, false, true>;
  }
  if (pair_block > kSubRows) {
    return l.fx == 1 ? (l.fy == 1 ? &raster_fwd_kernel<1, 1, true, false> : &raster_fwd_kernel<1, 2, true, false>) : &raster_fwd_kernel<2, 2, true, false>;
  }
  return l.fx == 1 ? (l.fy == 1 ? &raster_fwd_kernel<1, 1, false, false> : &raster_fwd_kernel<1, 2, false, false>) : &raster_fwd_kernel<2, 2, false, false>;
}

// Launches num_tiles * G blocks of the tile's group layout (G = 1 without
// groups); see the entry points below.
int launch(const void* feat, const void* pair_gaussian, const void* tile_start, const void* tile_count,
           const void* tile_ids, const void* carry_color, const void* carry_trans, int num_tiles, int n_tiles_x,
           int tile_size, int pair_block, float early_stop, int width, int height, float min_alpha,
           float max_alpha, void* color, void* trans, void* blocks_done, void* stream, bool groups,
           void* group_done, int resume) {
  if (num_tiles == 0) return 0;
  if (tile_size < 1 || pair_block < 1) return (int)cudaErrorInvalidValue;
  const GroupLayout gl = group_layout(tile_size);
  if ((gl.n > 1) != groups) return (int)cudaErrorInvalidValue;
  const WarpLayout layout = warp_layout(gl.edge);
  if (layout.fx == 0) return (int)cudaErrorInvalidValue;
  const FwdKernel kernel = pick(layout, pair_block, groups);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = staging_bytes(pair_block);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)num_tiles * gl.n * gl.n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, layout.warps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(feat), static_cast<const int*>(pair_gaussian),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(tile_ids), static_cast<const float*>(carry_color),
      static_cast<const float*>(carry_trans), n_tiles_x, tile_size, pair_block,
      early_stop, width, height, min_alpha, max_alpha,
      static_cast<float*>(color), static_cast<float*>(trans),
      static_cast<int*>(blocks_done), gl, static_cast<int*>(group_done), resume);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one block per tile, of warp_layout(tile_size).warps warps, on
// `stream` (a tile edge outside 1..kMaxGroup or a pair block below 1:
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
  return launch(feat, pair_gaussian, tile_start, tile_count, tile_ids, carry_color, carry_trans, num_tiles,
                n_tiles_x, tile_size, pair_block, early_stop, width, height, min_alpha, max_alpha, color, trans,
                blocks_done, stream, false, nullptr, 0);
}

// The same for a tile edge above kMaxGroup: one block per pixel group of
// each tile (num_tiles * G blocks). With group_done null (early stop off)
// one launch writes everything. With early stop on, launch it twice on one
// stream: first with resume 0 (each group votes on its own pixels, writes
// its pixels and group_done [T * G], not blocks_done), then with resume 1,
// early_stop 0 and the first launch's colour and T as the carry (into
// other outputs), which finishes every group and writes blocks_done.
extern "C" int gsplat_raster_fwd_groups(
    const void* feat, const void* pair_gaussian, const void* tile_start,
    const void* tile_count, const void* tile_ids, const void* carry_color,
    const void* carry_trans, int num_tiles, int n_tiles_x,
    int tile_size, int pair_block, float early_stop, int width, int height,
    float min_alpha, float max_alpha, void* color, void* trans,
    void* blocks_done, void* stream, void* group_done, int resume) {
  return launch(feat, pair_gaussian, tile_start, tile_count, tile_ids, carry_color, carry_trans, num_tiles,
                n_tiles_x, tile_size, pair_block, early_stop, width, height, min_alpha, max_alpha, color, trans,
                blocks_done, stream, true, group_done, resume);
}
