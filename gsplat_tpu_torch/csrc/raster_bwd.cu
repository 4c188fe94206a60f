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
// What bounds it on this card: operations. Every walked pair is evaluated
// at all tile_size^2 pixels, and each such pair-pixel needs its gate: about
// 19 FP32 operations for the recomputed density, alpha and gates
// (raster_common.cuh) and one expf. Only where the gate passes is there
// more: about 14 operations and a division for the walk, 20 for the nine
// per-pixel terms and 9 additions for their pixel sums. Elsewhere alpha is
// 0 and nothing changes. Against that, about 56 bytes are gathered per
// pair, 36 written per pair and 32 read per pixel. At the 1080p headline
// (about 1M pairs x 1024 pixels, under a tenth of them past the gate) that
// is some 2.3e10 FP32 operations and 1.1e9 SFU operations for about 0.2 GB
// moved.
//
// What the design does about it: one thread block per tile and one thread
// per pixel, as in the forward, so the walk is a sequential loop in
// registers (the TPU kernel needed cumprod/cumsum doubling scans). Each
// batch of pair_block pairs' 13 live features is staged once in shared
// memory and read as broadcasts. The per-pair sums over the tile's pixels
// are deterministic and use no atomics: each warp sums its 32 pixels with
// xor shuffles, lane 0 writes the nine sums of each of up to 32 pairs to
// shared memory, and after every 32 pairs one thread per (pair, column)
// adds the warps' sums in warp order and writes the pair's row. A warp in
// which no pixel passes a pair's gates contributes exact zeros without
// shuffling, which is most warps for most pairs at the headline's small
// splats. Rows past a tile's blocks_done, and rows of alignment pads, are
// never written: the caller zero-fills the output.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using namespace gsplat;

constexpr int kGrad = 9;    // gradient columns per pair row (FEAT_* 0-8)
constexpr int kChunk = 32;  // pairs per round of the block-wide pixel sums
constexpr unsigned kFull = 0xffffffffu;

__global__ void raster_bwd_kernel(
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
    int n_tiles_x, int tile_size, int pair_block, float min_alpha,
    float max_alpha,
    float* __restrict__ pair_grads,          // [P, 9], zero-filled
    float* __restrict__ carry_out)           // [T, 2, npix], or null
{
  extern __shared__ float smem[];
  float* sfeat = smem;                     // [kLive][pair_block]
  float* red = smem + kLive * pair_block;  // [warps][kChunk][kGrad]
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const int warps = blockDim.x >> 5;
  const int npix = tile_size * tile_size;
  const int tid = tile_ids[t];
  const int start = tile_start[t];
  const int count = tile_count[t];
  const float px = (float)((tid % n_tiles_x) * tile_size + lin % tile_size);
  const float py = (float)((tid / n_tiles_x) * tile_size + lin / tile_size);
  const int nblocks = (count + pair_block - 1) / pair_block;
  const int walk = blocks_done ? min(blocks_done[t], nblocks) : nblocks;

  const size_t p = (size_t)t * npix + lin;
  const float g0 = g_color[p * 3 + 0], g1 = g_color[p * 3 + 1], g2 = g_color[p * 3 + 2];
  float S, T;
  if (carry_in) {
    S = carry_in[(size_t)t * 2 * npix + lin];
    T = carry_in[(size_t)t * 2 * npix + npix + lin];
  } else {
    S = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(g0, color[p * 3 + 0]), __fmul_rn(g1, color[p * 3 + 1])),
                  __fmul_rn(g2, color[p * 3 + 2])),
        __fmul_rn(g_trans[p], trans[p]));
    T = 1.0f;
  }

  for (int b = 0; b < walk; ++b) {
    const int base = b * pair_block;
    const int n = min(pair_block, count - base);
    __syncthreads();  // the previous batch is consumed before it is overwritten
    stage_features(feat, pair_gaussian + start + base, n, sfeat, pair_block);
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int m = min(kChunk, n - c0);
      for (int jj = 0; jj < m; ++jj) {
        const float* s = sfeat + c0 + jj;
        const PairEval e = eval_pair(s, pair_block, px, py, min_alpha, max_alpha);
        const float a = e.valid ? e.alpha : 0.0f;
        const float tk = T;
        const float w = __fmul_rn(a, tk);
        const float u = __fadd_rn(
            __fadd_rn(__fmul_rn(s[R * pair_block], g0), __fmul_rn(s[G * pair_block], g1)),
            __fmul_rn(s[B * pair_block], g2));
        S = __fsub_rn(S, __fmul_rn(w, u));
        const float om = __fsub_rn(1.0f, a);
        const float d_a = e.valid ? __fsub_rn(__fmul_rn(u, tk), __fdiv_rn(S, om)) : 0.0f;
        const float d_raw = e.raw < max_alpha ? d_a : 0.0f;
        const float dd = __fmul_rn(d_raw, e.raw);
        T = __fmul_rn(tk, om);

        float* out = red + (warp * kChunk + jj) * kGrad;
        if (!__any_sync(kFull, e.valid)) {
          if (lane == 0) {
#pragma unroll
            for (int i = 0; i < kGrad; ++i) out[i] = 0.0f;
          }
          continue;
        }
        const float cx = s[CX * pair_block], cy = s[CY * pair_block], cxy = s[CXY * pair_block];
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
#pragma unroll
        for (int i = 0; i < kGrad; ++i) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(kFull, v[i], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < kGrad; ++i) out[i] = v[i];
        }
      }
      __syncthreads();
      // Warp sums of this round, added in warp order: row c0+k/9, column k%9.
      float* rows = pair_grads + (size_t)(start + base + c0) * kGrad;
      for (int k = lin; k < m * kGrad; k += blockDim.x) {
        float sum = 0.0f;
        for (int wi = 0; wi < warps; ++wi) sum += red[wi * kChunk * kGrad + k];
        rows[k] = sum;
      }
      __syncthreads();  // red is free for the next round
    }
  }
  if (carry_out) {
    carry_out[(size_t)t * 2 * npix + lin] = S;
    carry_out[(size_t)t * 2 * npix + npix + lin] = T;
  }
}

}  // namespace

// Launches one block of tile_size^2 threads (a multiple of 32) per tile on
// `stream`; allocates nothing and does not synchronise. `pair_grads` must
// be zero-filled. With carry_in set, color and trans are not read (they may
// be null); carry_out may be null. Returns cudaGetLastError() after the
// launch (a refused launch never runs, and a later synchronise would not
// report it).
extern "C" int gsplat_raster_bwd(
    const void* feat, const void* pair_gaussian, const void* tile_start,
    const void* tile_count, const void* tile_ids, const void* blocks_done,
    const void* color, const void* trans, const void* g_color,
    const void* g_trans, const void* carry_in, int num_tiles, int n_tiles_x,
    int tile_size, int pair_block, float min_alpha, float max_alpha,
    void* pair_grads, void* carry_out, void* stream) {
  if (num_tiles == 0) return 0;
  const int threads = tile_size * tile_size;
  const size_t smem = ((size_t)gsplat::kLive * pair_block +
                       (size_t)(threads / 32) * kChunk * kGrad) * sizeof(float);
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
      min_alpha, max_alpha, static_cast<float*>(pair_grads),
      static_cast<float*>(carry_out));
  return (int)cudaGetLastError();
}
