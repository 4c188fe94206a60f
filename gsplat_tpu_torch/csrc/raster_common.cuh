// Shared by the forward and backward tile compositors (raster_fwd.cu,
// raster_bwd.cu): the packed feature row layout, the staging of a batch of
// pair features into shared memory, and the per (pair, pixel) density,
// alpha and validity gate.
//
// The backward recomputes every alpha of the forward, and the gates
// (alpha > 1/255, density <= 0, the half-open bbox) are hard thresholds: a
// gate that flipped between the two passes would give a gradient to a pair
// the forward skipped, or take one from a pair it used. So both kernels
// evaluate a pair through eval_pair, with round-to-nearest intrinsics (no
// FMA contraction) and expf, which also round every product and sum as the
// plain PyTorch versions do, whose operations are separate kernels.

#pragma once

#include <cuda_runtime.h>

namespace gsplat {

constexpr int kRowFloats = 16;  // floats per packed feature row
constexpr int kLive = 13;       // live feature columns per row
// Column layout of a packed feature row (ops/binning.py FEAT_*).
enum Col { MX = 0, MY, CX, CY, CXY, OP, R, G, B, X0, Y0, X1, Y1 };

// Gather the 13 live features of pairs [0, n) of one batch (pair slots
// `pairs[0..n)`) into sfeat[f * stride + j], column f of pair j. Every
// thread of the block takes part; the caller synchronises around it.
__device__ __forceinline__ void stage_features(
    const float* __restrict__ feat, const int* __restrict__ pairs, int n,
    float* sfeat, int stride) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float4* row = reinterpret_cast<const float4*>(
        feat + (size_t)pairs[j] * kRowFloats);
    const float4 a = row[0], b = row[1], c = row[2], d = row[3];
    const float v[kLive] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                            c.x, c.y, c.z, c.w, d.x};
#pragma unroll
    for (int f = 0; f < kLive; ++f) sfeat[f * stride + j] = v[f];
  }
}

struct PairEval {
  float dx, dy;     // mean - pixel
  float density;    // -0.5 * (cx*dx*dx + cy*dy*dy) - cxy*dx*dy
  float expd;       // expf(density)
  float raw;        // opacity * expd
  float alpha;      // min(raw, max_alpha)
  bool valid;       // alpha > min_alpha && density <= 0 && pixel in bbox
};

// One pair at one pixel; s points at the pair's column 0 in a staged batch
// of the given stride.
__device__ __forceinline__ PairEval eval_pair(
    const float* s, int stride, float px, float py, float min_alpha,
    float max_alpha) {
  PairEval e;
  e.dx = __fsub_rn(s[MX * stride], px);
  e.dy = __fsub_rn(s[MY * stride], py);
  const float quad = __fadd_rn(
      __fmul_rn(__fmul_rn(s[CX * stride], e.dx), e.dx),
      __fmul_rn(__fmul_rn(s[CY * stride], e.dy), e.dy));
  e.density = __fsub_rn(
      __fmul_rn(-0.5f, quad),
      __fmul_rn(__fmul_rn(s[CXY * stride], e.dx), e.dy));
  e.expd = expf(e.density);
  e.raw = __fmul_rn(s[OP * stride], e.expd);
  e.alpha = fminf(e.raw, max_alpha);
  const bool inside = px >= s[X0 * stride] && px < s[X1 * stride] &&
                      py >= s[Y0 * stride] && py < s[Y1 * stride];
  e.valid = e.alpha > min_alpha && e.density <= 0.0f && inside;
  return e;
}

}  // namespace gsplat
