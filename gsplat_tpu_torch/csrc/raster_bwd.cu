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
// What the design does about it: one thread block per tile and one thread
// per pixel, as in the forward, so the walk is a sequential loop in
// registers (the TPU kernel needed cumprod/cumsum doubling scans). As in the
// forward, each warp owns an 8x4 pixel rect and walks only the pairs whose
// alpha-bound rect meets it, and batches of pair rows are gathered with
// cp.async two batches ahead (raster_common.cuh). The per-pair sums over the
// tile's pixels are deterministic and use no atomics: a warp that walks a
// pair sums its 32 pixels' nine terms with a transposing shuffle reduction
// (each step halves the values a lane carries: 14 shuffles where nine xor
// trees take 45) and writes them to its slot of red[warp][pair][9], or
// zeros when none of its pixels passes the pair's gate; after each round of
// pairs one thread per (pair, column) adds the slots of exactly the warps
// that walked the pair, in warp order, and writes the pair's row. Two block
// barriers per round. A round is the whole batch (measured faster than
// rounds of 32 pairs) unless the batch's slots would not fit in shared
// memory, as at tile 32 from pair_block 171 on; then it is 32 pairs. Rows
// past a tile's blocks_done, and rows of alignment pads, are never written:
// the caller zero-fills the output.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using namespace gsplat;

constexpr int kGrad = 9;  // gradient columns per pair row (FEAT_* 0-8)

// Pairs per round of the block sums: the whole batch where its warp slots
// [warps][pair_block][9] fit in shared memory beside the staging, else 32
// (kernels/raster_bwd.py _sum_round mirrors it).
int sum_round(int warps, int pair_block) {
  const size_t whole = staging_bytes(pair_block) + (size_t)warps * pair_block * kGrad * sizeof(float);
  return whole <= kMaxSmem ? pair_block : 32;
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
    float* __restrict__ carry_out)           // [T, 2, npix], or null
{
  extern __shared__ __align__(16) float smem[];
  float* red = smem + staging_bytes(pair_block) / sizeof(float);  // [warps][round_pairs][kGrad]
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const int npix = tile_size * tile_size;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const TilePixel me = tile_pixel(tile_ids[t], n_tiles_x, tile_size);
  const float px = me.px, py = me.py;
  const int nblocks = (count + pair_block - 1) / pair_block;
  const int walk = blocks_done ? min(blocks_done[t], nblocks) : nblocks;

  const size_t p = (size_t)t * npix + me.pix;
  const size_t q = (size_t)t * 2 * npix + me.pix;
  const float g0 = g_color[p * 3 + 0], g1 = g_color[p * 3 + 1], g2 = g_color[p * 3 + 2];
  float S, T;
  if (carry_in) {
    S = carry_in[q];
    T = carry_in[q + npix];
  } else {
    S = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(g0, color[p * 3 + 0]), __fmul_rn(g1, color[p * 3 + 1])),
                  __fmul_rn(g2, color[p * 3 + 2])),
        __fmul_rn(g_trans[p], trans[p]));
    T = 1.0f;
  }

  Staging st(smem, feat, pair_gaussian + start, count, walk, pair_block, min_alpha);
  st.begin(me);
  __syncthreads();
  for (int b = 0; b < walk; ++b) {
    st.issue(b + 2);
    const int n = st.size(b);
    for (int r0 = 0; r0 < n; r0 += round_pairs) {
      const int m = min(round_pairs, n - r0);
      for (int g = r0; g < r0 + m; g += 32) {
        const int k = g + lane;
        unsigned mask = __ballot_sync(kFull, k < r0 + m && span_holds(st.span(b, k), me.wx, me.wy));
        while (mask) {
          const int j = g + __ffs(mask) - 1;
          mask &= mask - 1;
          const float* s = st.row(b, j);
          const PairEval e = eval_pair(s, px, py, min_alpha, max_alpha);
          const float a = e.valid ? e.alpha : 0.0f;
          const float tk = T;
          const float w = __fmul_rn(a, tk);
          const float u = __fadd_rn(
              __fadd_rn(__fmul_rn(s[R], g0), __fmul_rn(s[G], g1)), __fmul_rn(s[B], g2));
          S = __fsub_rn(S, __fmul_rn(w, u));
          const float om = __fsub_rn(1.0f, a);
          const float d_a = e.valid ? __fsub_rn(__fmul_rn(u, tk), __fdiv_rn(S, om)) : 0.0f;
          const float d_raw = e.raw < max_alpha ? d_a : 0.0f;
          const float dd = __fmul_rn(d_raw, e.raw);
          T = __fmul_rn(tk, om);

          float* out = red + ((size_t)warp * round_pairs + (j - r0)) * kGrad;
          if (!__any_sync(kFull, e.valid)) {
            if (lane < kGrad) out[lane] = 0.0f;
            continue;
          }
          const float cx = s[CX], cy = s[CY], cxy = s[CXY];
          float v[kGrad];
          v[0] = __fmul_rn(dd, -__fadd_rn(__fmul_rn(cx, e.dx), __fmul_rn(cxy, e.dy)));
          v[1] = __fmul_rn(dd, -__fadd_rn(__fmul_rn(cy, e.dy), __fmul_rn(cxy, e.dx)));
          v[2] = __fmul_rn(dd, __fmul_rn(__fmul_rn(-0.5f, e.dx), e.dx));
          v[3] = __fmul_rn(dd, __fmul_rn(__fmul_rn(-0.5f, e.dy), e.dy));
          v[4] = __fmul_rn(dd, __fmul_rn(-e.dx, e.dy));
          v[5] = __fmul_rn(d_raw, e.expd);
          v[6] = __fmul_rn(w, g0);
          v[7] = __fmul_rn(w, g1);
          v[8] = __fmul_rn(w, g2);
          warp_sum9(v, lane, out);
        }
      }
      if (r0 + m >= n) st.prepare(b + 1, me);
      __syncthreads();  // every walking warp's slots of this round are written
      // Row r0 + i, column c: the slots of the warps in the pair's span, in
      // warp order (the other warps did not walk the pair: exact zeros).
      float* rows = pair_grads + (size_t)(start + b * pair_block + r0) * kGrad;
      for (int k = lin; k < m * kGrad; k += blockDim.x) {
        const int i = k / kGrad, c = k - i * kGrad;
        const unsigned span = st.span(b, r0 + i);
        float sum = 0.0f;
        for (int wy = (span >> 16) & 255u; wy <= (int)(span >> 24); ++wy)
          for (int wx = span & 255u; wx <= (int)((span >> 8) & 255u); ++wx)
            sum += red[((size_t)(wy * me.warps_x + wx) * round_pairs + i) * kGrad + c];
        rows[k] = sum;
      }
      __syncthreads();  // red is free for the next round, batch b's buffers for reuse
    }
  }
  st.finish();
  if (carry_out) {
    carry_out[q] = S;
    carry_out[q + npix] = T;
  }
}

}  // namespace

// Launches one block of tile_size^2 threads per tile on `stream` (the tile
// must be a multiple of the warp rect: cudaErrorInvalidValue otherwise);
// allocates nothing and does not synchronise. `pair_grads` must be
// zero-filled. With carry_in set, color and trans are not read (they may be
// null); carry_out may be null. Returns cudaGetLastError() after the launch
// (a refused launch never runs, and a later synchronise would not report
// it).
extern "C" int gsplat_raster_bwd(
    const void* feat, const void* pair_gaussian, const void* tile_start,
    const void* tile_count, const void* tile_ids, const void* blocks_done,
    const void* color, const void* trans, const void* g_color,
    const void* g_trans, const void* carry_in, int num_tiles, int n_tiles_x,
    int tile_size, int pair_block, float min_alpha, float max_alpha,
    void* pair_grads, void* carry_out, void* stream) {
  if (num_tiles == 0) return 0;
  if (!gsplat::tile_supported(tile_size) || pair_block < 1) return (int)cudaErrorInvalidValue;
  const int threads = tile_size * tile_size;
  const int round_pairs = sum_round(threads / 32, pair_block);
  const size_t smem = gsplat::staging_bytes(pair_block) +
                      (size_t)(threads / 32) * round_pairs * kGrad * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  raster_bwd_kernel<<<num_tiles, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(feat), static_cast<const int*>(pair_gaussian),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(tile_ids), static_cast<const int*>(blocks_done),
      static_cast<const float*>(color), static_cast<const float*>(trans),
      static_cast<const float*>(g_color), static_cast<const float*>(g_trans),
      static_cast<const float*>(carry_in), n_tiles_x, tile_size, pair_block,
      round_pairs, min_alpha, max_alpha, static_cast<float*>(pair_grads),
      static_cast<float*>(carry_out));
  return (int)cudaGetLastError();
}
