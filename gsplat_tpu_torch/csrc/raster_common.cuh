// Shared by the forward and backward tile compositors (raster_fwd.cu,
// raster_bwd.cu): the packed feature row layout, the per (pair, pixel)
// density, alpha and validity gate, the warp-to-pixel mapping, each pair's
// alpha-bound rect, and the pipeline that stages batches of pair rows into
// shared memory.
//
// The backward recomputes every alpha of the forward, and the gates
// (alpha > 1/255, density <= 0, the half-open bbox) are hard thresholds: a
// gate that flipped between the two passes would give a gradient to a pair
// the forward skipped, or take one from a pair it used. So both kernels
// evaluate a pair through eval_pair, with round-to-nearest intrinsics (no
// FMA contraction) and expf, which also round every product and sum as the
// plain PyTorch versions do, whose operations are separate kernels.
//
// Culling. Each warp owns a compact kWarpW x kWarpH rect of the tile's
// pixels. While a batch is staged, the thread that staged pair j bounds the
// pixels where the pair's gate can pass (alpha_rect) and stores which of the
// tile's warps that rect meets (warp_span). A warp walks only the pairs
// whose span holds it; for every other pair its pixels fail the gate, so
// skipping the pair changes nothing: the forward composites nothing there,
// and in the backward alpha = 0 leaves the walk state and every per-pixel
// term as they were. The gate itself is unchanged, so results stay bitwise
// those of a walk over every pair.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace gsplat {

constexpr int kRowFloats = 16;  // floats per packed feature row
// Column layout of a packed feature row (ops/binning.py FEAT_*).
enum Col { MX = 0, MY, CX, CY, CXY, OP, R, G, B, X0, Y0, X1, Y1 };

// The pixel rect a warp owns (kernels/cull.py WARP_RECT mirrors it). 8x4
// was measured against 16x2 and 32x1 and is the fastest: compact rects cull
// most where splats are small.
constexpr int kWarpW = 8;
constexpr int kWarpH = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoWarps = 1u;  // a span with lo_x 1 > hi_x 0: no warp
constexpr int kStages = 3;  // row buffers: composited, rect being taken, in flight
constexpr size_t kMaxSmem = 232448;  // shared memory a block may opt in to on Hopper (kernels/cull.py MAX_SMEM)

// Shared memory the staging pipeline takes for batches of pair_block pairs:
// kStages row buffers [pair_block][16] and two span buffers [pair_block].
__host__ __device__ inline size_t staging_bytes(int pair_block) {
  return (size_t)pair_block * (kStages * kRowFloats + 2) * sizeof(float);
}

// Whether the warp mapping covers a tile of this size.
inline bool tile_supported(int tile_size) {
  return tile_size > 0 && tile_size % kWarpW == 0 && tile_size % kWarpH == 0 &&
         tile_size * tile_size <= 1024;
}

// The pixel of this thread: warp w owns the rect at (w % warps_x, w /
// warps_x) in units of kWarpW x kWarpH, lane l its pixel (l % kWarpW,
// l / kWarpW). `pix` is the pixel's row-major index in the tile, which
// indexes every per-pixel input and output as before.
struct TilePixel {
  int pix;        // row-major index within the tile
  float px, py;   // frame pixel coordinates
  int wx, wy;     // the warp's rect, in warp units within the tile
  int warps_x, warps_y;
  float ox, oy;   // the tile's first pixel
};

__device__ __forceinline__ TilePixel tile_pixel(int tile, int n_tiles_x, int tile_size) {
  TilePixel p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  p.warps_x = tile_size / kWarpW;
  p.warps_y = tile_size / kWarpH;
  p.wx = warp % p.warps_x;
  p.wy = warp / p.warps_x;
  const int lx = p.wx * kWarpW + lane % kWarpW, ly = p.wy * kWarpH + lane / kWarpW;
  p.pix = ly * tile_size + lx;
  p.ox = (float)((tile % n_tiles_x) * tile_size);
  p.oy = (float)((tile / n_tiles_x) * tile_size);
  p.px = p.ox + (float)lx;
  p.py = p.oy + (float)ly;
  return p;
}

__device__ __forceinline__ bool span_holds(unsigned span, int wx, int wy) {
  return wx >= (int)(span & 255u) && wx <= (int)((span >> 8) & 255u) &&
         wy >= (int)((span >> 16) & 255u) && wy <= (int)(span >> 24);
}

// The half-open pixel rect outside which a pair's gate cannot pass, from its
// row (kernels/cull.py pair_alpha_rect is its twin). Where opacity * exp(
// density) > 1/255 the quadratic form q = -2 * density stays below
// 2 * ln(opacity / min_alpha), and over that ellipse |dx| <= sqrt(q * Sxx),
// Sxx = cy / (cx * cy - cxy^2), and likewise for y. The f32 gate rounds the
// density's terms, whose magnitudes are at most q / (1 - rho) (rho the
// conic's correlation), and the expf and product; q is widened to cover
// that, a pixel of guard is added on each side, and the rect is cut to the
// reference bbox. In double, once per staged pair. Opacity <= min_alpha
// gives an empty rect (alpha <= opacity * expf(density) <= opacity where
// density <= 0); a conic that is not clearly positive definite, or a term
// that is not finite, gives the whole bbox.
__device__ __forceinline__ float4 alpha_rect(const float* row, float min_alpha) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(row + 4);
  const float4 c = *reinterpret_cast<const float4*>(row + 8);
  const float y1 = row[Y1];
  const float4 bbox = make_float4(c.y, c.z, c.w, y1);
  const float mx = a.x, my = a.y, cx = a.z, cy = a.w, cxy = b.x, op = b.y;
  if (!(isfinite(mx) && isfinite(my) && isfinite(cx) && isfinite(cy) && isfinite(cxy) && isfinite(op)))
    return bbox;
  if (!(op > min_alpha)) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const double dcx = cx, dcy = cy, dcxy = cxy;
  const double det = dcx * dcy - dcxy * dcxy;  // the products are exact in double
  if (!(dcx > 0.0 && dcy > 0.0 && det > 1e-4 * dcx * dcy)) return bbox;
  const double s = det / (dcx * dcy);  // 1 - rho^2, in (1e-4, 1]
  const double q = (2.0 * log((double)op / (double)min_alpha) + 1e-5) * (1.0 + 1e-4 / s);
  const double rx = sqrt(q * dcy / det) + 1.0, ry = sqrt(q * dcx / det) + 1.0;
  const double x0 = fmax((double)bbox.x, ceil(mx - rx)), y0 = fmax((double)bbox.y, ceil(my - ry));
  const double x1 = fmin((double)bbox.z, floor(mx + rx) + 1.0);
  const double y1r = fmin((double)bbox.w, floor(my + ry) + 1.0);
  if (!(x1 > x0 && y1r > y0)) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return make_float4((float)x0, (float)y0, (float)x1, (float)y1r);
}

// The warps of the tile whose rect meets pixel rect r, packed as lo_x |
// hi_x << 8 | lo_y << 16 | hi_y << 24 (inclusive, in warp units), or
// kNoWarps. Warp wx covers [ox + wx*kWarpW, ox + (wx+1)*kWarpW); rect
// coordinates are whole pixels, so the divisions are exact.
__device__ __forceinline__ unsigned warp_span(float4 r, const TilePixel& t) {
  if (!(r.z > r.x && r.w > r.y)) return kNoWarps;
  const float lx = fmaxf(floorf((r.x - t.ox) / kWarpW), 0.0f);
  const float hx = fminf(floorf((r.z - 1.0f - t.ox) / kWarpW), (float)(t.warps_x - 1));
  const float ly = fmaxf(floorf((r.y - t.oy) / kWarpH), 0.0f);
  const float hy = fminf(floorf((r.w - 1.0f - t.oy) / kWarpH), (float)(t.warps_y - 1));
  if (!(lx <= hx && ly <= hy)) return kNoWarps;
  return (unsigned)lx | (unsigned)hx << 8 | (unsigned)ly << 16 | (unsigned)hy << 24;
}

// Stages the rows of a tile's pair batches into shared memory, two batches
// ahead of the one being composited. Thread i owns rows i, i + blockDim.x,
// ... of every batch (one row each unless pair_block exceeds the tile's
// pixels): it copies them with cp.async (four 16-byte copies a row; Hopper's
// TMA does not gather rows by index), and once its own copies have landed it
// takes each pair's rect and span from the staged row. Each batch is one
// cp.async group of every thread (empty past the last batch), so
// __pipeline_wait_prior(1) always means "all but the newest batch have
// landed". The pair id of a thread's first row of the next batch to issue is
// loaded a batch early, so issuing never waits on it.
//
// Use: begin(); __syncthreads(); then for every batch b: issue(b + 2),
// composite batch b (row(b, j), span(b, j)), prepare(b + 1), and a block
// barrier before batch b + 1; finish() before the block exits.
struct Staging {
  float* rows;    // [kStages][pair_block][16]
  unsigned* spans;  // [2][pair_block]
  const float* feat;
  const int* pairs;  // the tile's pair slots
  int count, batches, pair_block;
  float min_alpha;
  int next_gid;  // pair id of this thread's first row in the next batch to issue

  __device__ Staging(float* smem, const float* feat_, const int* pairs_, int count_, int batches_,
                     int pair_block_, float min_alpha_)
      : rows(smem), spans(reinterpret_cast<unsigned*>(smem + (size_t)kStages * pair_block_ * kRowFloats)),
        feat(feat_), pairs(pairs_), count(count_), batches(batches_), pair_block(pair_block_),
        min_alpha(min_alpha_), next_gid(0) {}

  __device__ __forceinline__ int size(int b) const { return min(pair_block, count - b * pair_block); }
  __device__ __forceinline__ bool mine(int b) const { return b < batches && (int)threadIdx.x < size(b); }
  __device__ __forceinline__ float* row(int b, int j) const {
    return rows + ((size_t)(b % kStages) * pair_block + j) * kRowFloats;
  }
  __device__ __forceinline__ unsigned span(int b, int j) const { return spans[(b & 1) * pair_block + j]; }

  __device__ __forceinline__ void load_gid(int b) {
    if (mine(b)) next_gid = pairs[b * pair_block + threadIdx.x];
  }

  __device__ __forceinline__ void issue(int b) {
    if (b < batches) {
      const int n = size(b);
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int gid = j == (int)threadIdx.x ? next_gid : pairs[b * pair_block + j];
        const float* src = feat + (size_t)gid * kRowFloats;
        float* dst = row(b, j);
#pragma unroll
        for (int q = 0; q < 4; ++q) __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);
      }
    }
    __pipeline_commit();
    load_gid(b + 1);
  }

  __device__ __forceinline__ void prepare(int b, const TilePixel& t) {
    __pipeline_wait_prior(1);
    if (b < batches) {
      const int n = size(b);
      for (int j = threadIdx.x; j < n; j += blockDim.x)
        spans[(b & 1) * pair_block + j] = warp_span(alpha_rect(row(b, j), min_alpha), t);
    }
  }

  __device__ __forceinline__ void begin(const TilePixel& t) {
    load_gid(0);
    issue(0);
    issue(1);
    prepare(0, t);
  }

  __device__ __forceinline__ void finish() { __pipeline_wait_prior(0); }
};

struct PairEval {
  float dx, dy;     // mean - pixel
  float density;    // -0.5 * (cx*dx*dx + cy*dy*dy) - cxy*dx*dy
  float expd;       // expf(density)
  float raw;        // opacity * expd
  float alpha;      // min(raw, max_alpha)
  bool valid;       // alpha > min_alpha && density <= 0 && pixel in bbox
};

// One pair at one pixel; s points at the pair's staged row.
__device__ __forceinline__ PairEval eval_pair(
    const float* s, float px, float py, float min_alpha, float max_alpha) {
  const float4 a = *reinterpret_cast<const float4*>(s);       // mx, my, cx, cy
  const float4 b = *reinterpret_cast<const float4*>(s + 4);   // cxy, op, r, g
  const float4 c = *reinterpret_cast<const float4*>(s + 8);   // b, x0, y0, x1
  const float y1 = s[Y1];
  PairEval e;
  e.dx = __fsub_rn(a.x, px);
  e.dy = __fsub_rn(a.y, py);
  const float quad = __fadd_rn(
      __fmul_rn(__fmul_rn(a.z, e.dx), e.dx),
      __fmul_rn(__fmul_rn(a.w, e.dy), e.dy));
  e.density = __fsub_rn(
      __fmul_rn(-0.5f, quad),
      __fmul_rn(__fmul_rn(b.x, e.dx), e.dy));
  e.expd = expf(e.density);
  e.raw = __fmul_rn(b.y, e.expd);
  e.alpha = fminf(e.raw, max_alpha);
  const bool inside = px >= c.y && px < c.w && py >= c.z && py < y1;
  e.valid = e.alpha > min_alpha && e.density <= 0.0f && inside;
  return e;
}

}  // namespace gsplat
