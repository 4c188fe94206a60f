// Backward tile compositor for Hopper (sm_90a), bound to Python through a
// plain C entry point (ctypes; see gsplat_tpu_torch/kernels/build.py).
//
// Replaces the TPU kernel gsplat_tpu/kernels/raster_bwd.py::_bwd_kernel,
// both as entered through backward_tiles_pallas and in its carry form
// (backward_tiles_carry): per tile, a recompute-based walk
// over the tile's depth-ordered pairs, front to back as in the forward,
// that turns the cotangents of colour and final transmittance into nine
// per-pair gradients (d mean x/y, d conic x/y/xy, d opacity, d rgb) in the
// FEAT_* column order. It computes what the TPU kernel computes, with the
// per-pair pixel sums taken directly (as the jnp twin backward_tiles_jnp
// does), not through the TPU kernel's MXU moment re-expansion, which
// exists only to use the matrix unit and costs accuracy.
//
// Per pixel, in registers: S = sum_ch g_ch*C_ch + g_T*T_final, T = 1 (the
// walk state; in the carry form it is read from carry_in, the state after
// the previous depth slice of render/sliced.py, and written to carry_out
// after this slice's walk, so the slices walked in order take every step
// of one walk over the whole frame); for
// each pair, with a = valid ? alpha : 0, T_k = T, w = a*T_k,
// u = sum_ch rgb_ch*g_ch:
//   S -= w*u;  d_a = valid ? u*T_k - S/(1-a) : 0  (1-a >= 0.01);
//   d_raw = raw < 0.99 ? d_a : 0 (raw = opacity*exp(density));
//   d_density = d_raw*raw;  T *= 1-a.
// The only division is by 1-a, which the 0.99 alpha clamp keeps >= 0.01.
// Per pair, summed over the tile's pixels:
//   d_mean_x = sum d_density * -(cx*dx + cxy*dy), d_mean_y likewise,
//   d_cx = sum d_density * (-0.5*dx*dx), d_cy likewise, d_cxy = sum
//   d_density * (-dx*dy), d_opacity = sum d_raw*exp(density),
//   d_rgb_ch = sum g_ch*w.
//
// What bounds it on this card: operations. Each walked pair-pixel needs its
// gate: about 19 FP32 operations for the recomputed density, alpha and
// gates (raster_common.cuh) and one expf. Only where the gate passes is
// there more: about 14 operations and a division for the walk, 20 for the
// nine per-pixel terms and 9 additions for their pixel sums. Elsewhere alpha
// is 0 and nothing changes. Against that, about 56 bytes are gathered per
// pair, 36 written per pair and 32 read per pixel. At the 1080p headline
// (about 1M pairs over 1024-pixel tiles, 8.6% of the pair-pixels past the
// gate) that is some 2.3e10 FP32 operations and 1.1e9 SFU operations for
// about 0.2 GB moved, if every pair is evaluated at every pixel.
//
// What the design does about it: one thread block per tile, and each
// thread owns one pixel of it (two or four in tiles of more than 1024
// pixels), as in the forward, so the walk is a sequential loop in registers
// (the TPU kernel needed cumprod/cumsum doubling scans). As in the forward,
// each warp walks its 8x4 pixel rects, in each only the pairs whose
// alpha-bound rect meets it, and sub-batches of pair rows are gathered with
// cp.async two ahead (raster_common.cuh). The per-pair sums over the tile's
// pixels are deterministic and use no atomics: a thread first adds its own
// pixels' nine terms in a fixed order (the rects in order; one pixel needs
// no addition), a warp that walks a pair then sums its 32 lanes with a
// transposing shuffle reduction (each step halves the values a lane
// carries: 14 shuffles where nine xor trees take 45) and writes them to its
// slot of red[warp][pair][9], or zeros when none of its pixels passes the
// pair's gate; after each round of pairs one thread per (pair, column) adds
// the slots of exactly the warps that walked the pair, in warp order, and
// writes the pair's row. So the shared memory of the sums is that of at
// most 32 warps whatever the tile. Lanes past the tile's edge own no pixel:
// their cotangents and S are 0, so every term they add is an exact zero.
// Two block barriers per round. A round is the whole sub-batch (measured
// faster than rounds of 32 pairs) unless its warp slots would not fit in
// shared memory, as at tile 32 from pair_block 171 on; then it is 32 pairs.
// Rows past a tile's blocks_done, and rows of alignment pads, are never
// written: the caller zero-fills the output.
//
// Tiles of edge above 64 (kGroups): each pixel group is one block (tiles x
// groups blocks; raster_common.cuh BlockPixels), and every group walks to
// its tile's blocks_done. A block's per-pair sums are over its group's
// pixels, in the order above: group 0 writes them to pair_grads, group g >
// 0 to its partial rows partials[g - 1] ([G - 1, P, 9], zero-filled), and
// the caller adds the partials to pair_grads in group order, so the rows
// are bitwise repeatable. The carry state is per pixel: each group reads
// and writes its own pixels.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using namespace gsplat;

constexpr int kGrad = 9;  // gradient columns per pair row (FEAT_* 0-8)

// Pairs per round of the block sums: the whole sub-batch where its warp
// slots [warps][sub][9] fit in shared memory beside the staging, else 32
// (kernels/raster_bwd.py _sum_round mirrors it).
int sum_round(int warps, int pair_block) {
  const int sub = sub_rows(pair_block);
  const size_t whole = staging_bytes(pair_block) + (size_t)warps * sub * kGrad * sizeof(float);
  return whole <= kMaxSmem ? sub : 32;
}

// Sums v[0..8] over the warp's 32 lanes. Values 0-7 by a transposing
// reduction: at offsets 16, 8 and 4 each lane keeps half of the values it
// carries and adds its partner's copy of that half, so lane l ends with
// value 4*b4 + 2*b3 + b2 (bits of l) summed over the 8 lanes that differ in
// bits 4-2; offsets 2 and 1 finish the sum. Value 8 by a plain xor tree.
// Lanes with l % 4 == 0 write value (l >> 2) to out, lane 0 also out[8].
// The order of additions is fixed, so two runs give the same bits.
__device__ __forceinline__ void warp_sum9(float v[kGrad], int lane, float* out) {
  {
    const bool up = lane & 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = up ? v[i] : v[i + 4];
      const float keep = up ? v[i + 4] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, 16);
    }
  }
  {
    const bool up = lane & 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = up ? v[i] : v[i + 2];
      const float keep = up ? v[i + 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, 8);
    }
  }
  {
    const bool up = lane & 4;
    const float send = up ? v[0] : v[1];
    const float keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  v[0] += __shfl_xor_sync(kFull, v[0], 2);
  v[0] += __shfl_xor_sync(kFull, v[0], 1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v[8] += __shfl_xor_sync(kFull, v[8], off);
  if ((lane & 3) == 0) out[lane >> 2] = v[0];
  if (lane == 0) out[8] = v[8];
}

// One step of a pixel's walk over a pair (the recurrence at the top of this
// file): updates S and T and returns what the pixel's terms need.
struct PixelStep {
  PairEval e;
  float w, d_raw, dd;
};

__device__ __forceinline__ PixelStep walk_pixel(const float* row, float px, float py, float g0, float g1, float g2,
                                                float& S, float& T, float min_alpha, float max_alpha) {
  PixelStep p;
  p.e = eval_pair(row, px, py, min_alpha, max_alpha);
  const float a = p.e.valid ? p.e.alpha : 0.0f;
  const float tk = T;
  p.w = __fmul_rn(a, tk);
  const float u = __fadd_rn(__fadd_rn(__fmul_rn(row[R], g0), __fmul_rn(row[G], g1)), __fmul_rn(row[B], g2));
  S = __fsub_rn(S, __fmul_rn(p.w, u));
  const float om = __fsub_rn(1.0f, a);
  const float d_a = p.e.valid ? __fsub_rn(__fmul_rn(u, tk), __fdiv_rn(S, om)) : 0.0f;
  p.d_raw = p.e.raw < max_alpha ? d_a : 0.0f;
  p.dd = __fmul_rn(p.d_raw, p.e.raw);
  T = __fmul_rn(tk, om);
  return p;
}

// The pixel's nine gradient terms (FEAT_* 0-8) of the pair, into v.
__device__ __forceinline__ void pixel_terms(const PixelStep& p, const float* row, float g0, float g1, float g2,
                                            float v[kGrad]) {
  const float cx = row[CX], cy = row[CY], cxy = row[CXY];
  const float dx = p.e.dx, dy = p.e.dy, dd = p.dd;
  v[0] = __fmul_rn(dd, -__fadd_rn(__fmul_rn(cx, dx), __fmul_rn(cxy, dy)));
  v[1] = __fmul_rn(dd, -__fadd_rn(__fmul_rn(cy, dy), __fmul_rn(cxy, dx)));
  v[2] = __fmul_rn(dd, __fmul_rn(__fmul_rn(-0.5f, dx), dx));
  v[3] = __fmul_rn(dd, __fmul_rn(__fmul_rn(-0.5f, dy), dy));
  v[4] = __fmul_rn(dd, __fmul_rn(-dx, dy));
  v[5] = __fmul_rn(p.d_raw, p.e.expd);
  v[6] = __fmul_rn(p.w, g0);
  v[7] = __fmul_rn(p.w, g1);
  v[8] = __fmul_rn(p.w, g2);
}

// FX x FY: the rects of a warp (warp_layout in raster_common.cuh); kSplit:
// pair blocks staged in several sub-batches (Staging); kGroups: a block is
// a pixel group of a larger tile (BlockPixels).
template <int FX, int FY, bool kSplit, bool kGroups>
__global__ void __launch_bounds__(1024) raster_bwd_kernel(
    const float* __restrict__ feat,          // [N+1, 16]; row N is zero
    const int* __restrict__ pair_gaussian,   // [P]
    const int* __restrict__ tile_start,      // [T]
    const int* __restrict__ tile_count,      // [T]
    const int* __restrict__ tile_ids,        // [T] global tile index
    const int* __restrict__ blocks_done,     // [T], or null: every block
    const float* __restrict__ color,         // [T, npix, 3] forward colour
    const float* __restrict__ trans,         // [T, npix] forward final T
    const float* __restrict__ g_color,       // [T, npix, 3] cotangent
    const float* __restrict__ g_trans,       // [T, npix] cotangent
    const float* __restrict__ carry_in,      // [T, 2, npix] (S, T), or null
    int n_tiles_x, int tile_size, int pair_block, int round_pairs,
    float min_alpha, float max_alpha,
    float* __restrict__ pair_grads,          // [P, 9], zero-filled
    float* __restrict__ carry_out,           // [T, 2, npix], or null
    GroupLayout gl,                          // kGroups: the tile's groups
    float* __restrict__ partials,            // kGroups: [G - 1, P, 9], zero-filled
    int num_pairs)                           // kGroups: P
{
  constexpr int kSubs = FX * FY;
  extern __shared__ __align__(16) float smem[];
  float* red = smem + staging_bytes(pair_block) / sizeof(float);  // [warps][round_pairs][kGrad]
  const BlockPixels<kGroups> blk(tile_ids, n_tiles_x, tile_size, gl);
  const int t = blk.t;
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const PixIndex<kGroups> npix = (PixIndex<kGroups>)tile_size * tile_size;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const TileGrid& grid = blk.grid;
  const TilePixels<FX, FY> me = tile_pixels<FX, FY>(grid);
  const int nblocks = (count + pair_block - 1) / pair_block;
  const int walk = blocks_done ? min(blocks_done[t], nblocks) : nblocks;
  float* const grads = kGroups && blk.g > 0 ? partials + (size_t)(blk.g - 1) * num_pairs * kGrad : pair_grads;

  const size_t base = (size_t)t * npix, cbase = (size_t)t * 2 * npix;
  float g0[kSubs], g1[kSubs], g2[kSubs], S[kSubs], T[kSubs];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) {
    g0[i] = g1[i] = g2[i] = S[i] = 0.0f;
    T[i] = 1.0f;
    if (!blk.owns(me, i, tile_size)) continue;
    const size_t p = base + blk.pix(me, i, tile_size);
    const size_t q = cbase + blk.pix(me, i, tile_size);
    g0[i] = g_color[p * 3 + 0];
    g1[i] = g_color[p * 3 + 1];
    g2[i] = g_color[p * 3 + 2];
    if (carry_in) {
      S[i] = carry_in[q];
      T[i] = carry_in[q + npix];
    } else {
      S[i] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(g0[i], color[p * 3 + 0]), __fmul_rn(g1[i], color[p * 3 + 1])),
                    __fmul_rn(g2[i], color[p * 3 + 2])),
          __fmul_rn(g_trans[p], trans[p]));
    }
  }

  Staging<kSplit> st(smem, feat, pair_gaussian + start, count, walk, pair_block, min_alpha);
  st.begin(grid);
  __syncthreads();
  for (int s = 0; s < st.batches; ++s) {
    st.issue(s + 2);
    const int n = st.size(s);
    for (int r0 = 0; r0 < n; r0 += round_pairs) {
      const int m = min(round_pairs, n - r0);
      for (int g = r0; g < r0 + m; g += 32) {
        const int k = g + lane;
        const unsigned span = k < r0 + m ? st.span(s, k) : kNoWarps;
        unsigned mask[kSubs], walked = 0u;
#pragma unroll
        for (int i = 0; i < kSubs; ++i) {
          mask[i] = __ballot_sync(kFull, span_holds(span, me.rect_x(i), me.rect_y(i)));
          walked |= mask[i];
        }
        while (walked) {
          const int bit = __ffs(walked) - 1;
          walked &= walked - 1;
          const int j = g + bit;
          const float* row = st.row(s, j);
          float* out = red + ((size_t)warp * round_pairs + (j - r0)) * kGrad;
          float v[kGrad];
          if constexpr (kSubs == 1) {
            const PixelStep p = walk_pixel(row, me.px0, me.py0, g0[0], g1[0], g2[0], S[0], T[0], min_alpha, max_alpha);
            if (!__any_sync(kFull, p.e.valid)) {
              if (lane < kGrad) out[lane] = 0.0f;
              continue;
            }
            pixel_terms(p, row, g0[0], g1[0], g2[0], v);
          } else {
            // This thread's pixels in rect order: their terms summed in a fixed order.
            bool any = false;  // some lane's pixel passed the gate: the warp sums
#pragma unroll
            for (int c = 0; c < kGrad; ++c) v[c] = 0.0f;
#pragma unroll
            for (int i = 0; i < kSubs; ++i) {
              if (!((mask[i] >> bit) & 1u)) continue;
              const PixelStep p = walk_pixel(row, me.px(i), me.py(i), g0[i], g1[i], g2[i], S[i], T[i], min_alpha,
                                             max_alpha);
              if (!__any_sync(kFull, p.e.valid)) continue;
              any = true;
              float terms[kGrad];
              pixel_terms(p, row, g0[i], g1[i], g2[i], terms);
#pragma unroll
              for (int c = 0; c < kGrad; ++c) v[c] = __fadd_rn(v[c], terms[c]);
            }
            if (!any) {
              if (lane < kGrad) out[lane] = 0.0f;
              continue;
            }
          }
          warp_sum9(v, lane, out);
        }
      }
      if (r0 + m >= n) st.prepare(s + 1, grid);
      __syncthreads();  // every walking warp's slots of this round are written
      // Row r0 + i, column c: the slots of the warps that own a rect in the
      // pair's span, in warp order (the other warps did not walk the pair:
      // exact zeros).
      float* rows = grads + (size_t)(start + st.first(s) + r0) * kGrad;
      for (int k = lin; k < m * kGrad; k += blockDim.x) {
        const int i = k / kGrad, c = k - i * kGrad;
        const unsigned span = st.span(s, r0 + i);
        float sum = 0.0f;
        if (FX == 1 || span != kNoWarps) {  // with FX 1, kNoWarps's x range is empty
          for (int by = ((span >> 16) & 255u) / FY; by <= (int)(span >> 24) / FY; ++by)
            for (int bx = (span & 255u) / FX; bx <= (int)((span >> 8) & 255u) / FX; ++bx)
              sum += red[((size_t)(by * blocks_x<FX>(grid) + bx) * round_pairs + i) * kGrad + c];
        }
        rows[k] = sum;
      }
      __syncthreads();  // red is free for the next round, sub-batch s's buffers for reuse
    }
  }
  st.finish();
  if (carry_out) {
#pragma unroll
    for (int i = 0; i < kSubs; ++i) {
      if (!blk.owns(me, i, tile_size)) continue;
      const size_t q = cbase + blk.pix(me, i, tile_size);
      carry_out[q] = S[i];
      carry_out[q + npix] = T[i];
    }
  }
}

using BwdKernel = decltype(&raster_bwd_kernel<1, 1, false, false>);

// The instantiation for a warp layout and pair block. Groups have edges in
// (32, 64], whose layouts are 1x2 or 2x2 rects a warp: only those are
// instantiated with kGroups (null for 1x1).
BwdKernel pick(const WarpLayout& l, int pair_block, bool groups) {
  if (groups) {
    if (pair_block > kSubRows)
      return l.fx == 1 ? (l.fy == 1 ? nullptr : &raster_bwd_kernel<1, 2, true, true>) : &raster_bwd_kernel<2, 2, true, true>;
    return l.fx == 1 ? (l.fy == 1 ? nullptr : &raster_bwd_kernel<1, 2, false, true>) : &raster_bwd_kernel<2, 2, false, true>;
  }
  if (pair_block > kSubRows) {
    return l.fx == 1 ? (l.fy == 1 ? &raster_bwd_kernel<1, 1, true, false> : &raster_bwd_kernel<1, 2, true, false>) : &raster_bwd_kernel<2, 2, true, false>;
  }
  return l.fx == 1 ? (l.fy == 1 ? &raster_bwd_kernel<1, 1, false, false> : &raster_bwd_kernel<1, 2, false, false>) : &raster_bwd_kernel<2, 2, false, false>;
}

// Launches num_tiles * G blocks of the tile's group layout (G = 1 without
// groups); see the entry points below.
int launch(const void* feat, const void* pair_gaussian, const void* tile_start, const void* tile_count,
           const void* tile_ids, const void* blocks_done, const void* color, const void* trans,
           const void* g_color, const void* g_trans, const void* carry_in, int num_tiles, int n_tiles_x,
           int tile_size, int pair_block, float min_alpha, float max_alpha, void* pair_grads, void* carry_out,
           void* stream, bool groups, void* partials, int num_pairs) {
  if (num_tiles == 0) return 0;
  if (tile_size < 1 || pair_block < 1) return (int)cudaErrorInvalidValue;
  const GroupLayout gl = group_layout(tile_size);
  if ((gl.n > 1) != groups) return (int)cudaErrorInvalidValue;
  const WarpLayout layout = warp_layout(gl.edge);
  if (layout.fx == 0) return (int)cudaErrorInvalidValue;
  const BwdKernel kernel = pick(layout, pair_block, groups);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int round_pairs = sum_round(layout.warps, pair_block);
  const size_t smem = staging_bytes(pair_block) + (size_t)layout.warps * round_pairs * kGrad * sizeof(float);
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
      static_cast<const int*>(tile_ids), static_cast<const int*>(blocks_done),
      static_cast<const float*>(color), static_cast<const float*>(trans),
      static_cast<const float*>(g_color), static_cast<const float*>(g_trans),
      static_cast<const float*>(carry_in), n_tiles_x, tile_size, pair_block,
      round_pairs, min_alpha, max_alpha, static_cast<float*>(pair_grads),
      static_cast<float*>(carry_out), gl, static_cast<float*>(partials), num_pairs);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one block per tile, of warp_layout(tile_size).warps warps, on
// `stream` (a tile edge outside 1..kMaxGroup or a pair block below 1:
// cudaErrorInvalidValue); allocates nothing and does not synchronise.
// `pair_grads` must be zero-filled. With carry_in set, color and trans are
// not read (they may be null); carry_out may be null. Returns
// cudaGetLastError() after the launch (a refused launch never runs, and a
// later synchronise would not report it).
extern "C" int gsplat_raster_bwd(
    const void* feat, const void* pair_gaussian, const void* tile_start,
    const void* tile_count, const void* tile_ids, const void* blocks_done,
    const void* color, const void* trans, const void* g_color,
    const void* g_trans, const void* carry_in, int num_tiles, int n_tiles_x,
    int tile_size, int pair_block, float min_alpha, float max_alpha,
    void* pair_grads, void* carry_out, void* stream) {
  return launch(feat, pair_gaussian, tile_start, tile_count, tile_ids, blocks_done, color, trans, g_color,
                g_trans, carry_in, num_tiles, n_tiles_x, tile_size, pair_block, min_alpha, max_alpha, pair_grads,
                carry_out, stream, false, nullptr, 0);
}

// The same for a tile edge above kMaxGroup: one block per pixel group of
// each tile (num_tiles * G blocks). Group 0's sums go to pair_grads, group
// g's to partials[g - 1] ([G - 1, num_pairs, 9], zero-filled); the caller
// adds the partials to pair_grads in group order.
extern "C" int gsplat_raster_bwd_groups(
    const void* feat, const void* pair_gaussian, const void* tile_start,
    const void* tile_count, const void* tile_ids, const void* blocks_done,
    const void* color, const void* trans, const void* g_color,
    const void* g_trans, const void* carry_in, int num_tiles, int n_tiles_x,
    int tile_size, int pair_block, float min_alpha, float max_alpha,
    void* pair_grads, void* carry_out, void* stream, void* partials, int num_pairs) {
  return launch(feat, pair_gaussian, tile_start, tile_count, tile_ids, blocks_done, color, trans, g_color,
                g_trans, carry_in, num_tiles, n_tiles_x, tile_size, pair_block, min_alpha, max_alpha, pair_grads,
                carry_out, stream, true, partials, num_pairs);
}
