// Shared by the forward and backward tile compositors (raster_fwd.cu,
// raster_bwd.cu): the packed feature row layout, the per (pair, pixel)
// density, alpha and validity gate, the map from threads to pixels, each
// pair's alpha-bound rect, and the pipeline that stages sub-batches of pair
// rows into shared memory.
//
// The backward recomputes every alpha of the forward, and the gates
// (alpha > 1/255, density <= 0, the half-open bbox) are hard thresholds: a
// gate that flipped between the two passes would give a gradient to a pair
// the forward skipped, or take one from a pair it used. So both kernels
// evaluate a pair through eval_pair, with round-to-nearest intrinsics (no
// FMA contraction) and expf, which also round every product and sum as the
// plain PyTorch versions do, whose operations are separate kernels.
//
// Culling. A tile's pixels are cut into compact kWarpW x kWarpH rects, each
// walked by the 32 lanes of one warp. While a sub-batch is staged, the
// thread that staged pair j bounds the pixels where the pair's gate can
// pass (alpha_rect) and stores which of the tile's rects that bound meets
// (warp_span). A warp walks a pair in a rect only if the span holds the
// rect; at every other pixel the gate fails, so skipping the pair changes
// nothing: the forward composites nothing there, and in the backward
// alpha = 0 leaves the walk state and every per-pixel term as they were.
// The gate itself is unchanged, so results stay bitwise those of a walk
// over every pair.
//
// Tilings. Any tile edge from 1 to kMaxGroup is one thread block
// (warp_layout): the rect grid is rounded up past the tile's edge, and a
// thread owns one, two or four pixels, so that a tile of up to 4096 pixels
// is one block of at most 1024 threads. A larger tile is cut into pixel
// groups of edge at most kMaxGroup (group_layout), each one block of the
// group edge's layout with its rect grid from the group's first pixel
// (BlockPixels); the kernels combine the groups' votes and sums. The pair
// block sets only where the early-stop vote is taken; staging goes by
// sub-batches of at most kSubRows rows.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace gsplat {

constexpr int kRowFloats = 16;  // floats per packed feature row
// Column layout of a packed feature row (ops/binning.py FEAT_*).
enum Col { MX = 0, MY, CX, CY, CXY, OP, R, G, B, X0, Y0, X1, Y1 };

// The pixel rect a warp walks as one (kernels/cull.py WARP_RECT mirrors
// it). 8x4 was measured against 16x2 and 32x1 and is the fastest: compact
// rects cull most where splats are small.
constexpr int kWarpW = 8;
constexpr int kWarpH = 4;
constexpr int kMaxGroup = 64;  // the largest edge of one block's pixels (kernels/cull.py MAX_GROUP)
constexpr int kMaxWarps = 32;  // warps of a block: 1024 threads
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoWarps = 1u;  // a span with lo_x 1 > hi_x 0: no rect
constexpr int kStages = 3;  // row buffers: composited, rect being taken, in flight
constexpr int kSubRows = 256;  // rows a staged sub-batch holds at most (kernels/cull.py SUB_ROWS)
constexpr size_t kMaxSmem = 232448;  // shared memory a block may opt in to on Hopper (kernels/cull.py MAX_SMEM)

// Rows of one staged sub-batch: the whole pair block up to kSubRows.
__host__ __device__ inline int sub_rows(int pair_block) {
  return pair_block < kSubRows ? pair_block : kSubRows;
}

// Shared memory the staging pipeline takes: kStages row buffers [sub][16]
// and two span buffers [sub], whatever the pair block.
__host__ __device__ inline size_t staging_bytes(int pair_block) {
  return (size_t)sub_rows(pair_block) * (kStages * kRowFloats + 2) * sizeof(float);
}

// How a tile's warp rects map onto the block's warps (kernels/cull.py
// warp_layout mirrors it). The tile is covered by a grid of
// ceil(ts / kWarpW) x ceil(ts / kWarpH) rects, rounded up past its edge
// where the edge is not a multiple of the rect. Each warp owns a block of
// fx x fy rects, the first of 1x1, 1x2 and 2x2 that keeps the block within
// kMaxWarps warps, and each thread one pixel in each of its warp's rects:
// one pixel up to 32 rects (1024 pixels), two up to 2048, four up to 4096.
// So a tile up to kMaxGroup is one thread block, with one early-stop
// decision per pair block as in the TPU kernel. Takes the edge of a block's
// pixels, 1 to kMaxGroup (fx = 0 otherwise).
struct WarpLayout {
  int fx, fy, warps;
};

inline WarpLayout warp_layout(int tile_size) {
  if (tile_size < 1 || tile_size > kMaxGroup) return WarpLayout{0, 0, 0};
  const int rx = (tile_size + kWarpW - 1) / kWarpW, ry = (tile_size + kWarpH - 1) / kWarpH;
  const int blocks[3][2] = {{1, 1}, {1, 2}, {2, 2}};
  for (const auto& f : blocks) {
    const int warps = ((rx + f[0] - 1) / f[0]) * ((ry + f[1] - 1) / f[1]);
    if (warps <= kMaxWarps) return WarpLayout{f[0], f[1], warps};
  }
  return WarpLayout{0, 0, 0};
}

// The tile's first pixel and its grid of rects.
struct TileGrid {
  float ox, oy;
  int rects_x, rects_y;
};

__device__ __forceinline__ TileGrid tile_grid(int tile, int n_tiles_x, int tile_size) {
  TileGrid g;
  g.ox = (float)((tile % n_tiles_x) * tile_size);
  g.oy = (float)((tile / n_tiles_x) * tile_size);
  g.rects_x = (tile_size + kWarpW - 1) / kWarpW;
  g.rects_y = (tile_size + kWarpH - 1) / kWarpH;
  return g;
}

// The pixels of this thread. Warp w owns the FX x FY block of rects at
// (w % blocks_x, w / blocks_x) in block units; its rect i is the block's
// (i % FX, i / FX); lane l owns pixel (l % kWarpW, l / kWarpW) of each rect.
// A pixel past the tile's edge is owned by no one: its lane still takes
// part in every warp vote and shuffle, and writes nothing. pix(i) is the
// pixel's row-major index in the tile, which indexes every per-pixel input
// and output. Only the first pixel's frame coordinates are kept, as floats
// for the gate (whole numbers, so every offset and difference is exact);
// the rest derives from them.
template <int FX, int FY>
struct TilePixels {
  static constexpr int kSubs = FX * FY;  // pixels of a thread
  int rx, ry;        // the warp's first rect, in rect units
  float px0, py0;    // this lane's pixel in that rect, frame coordinates
  __device__ __forceinline__ int rect_x(int i) const { return rx + i % FX; }
  __device__ __forceinline__ int rect_y(int i) const { return ry + i / FX; }
  __device__ __forceinline__ float px(int i) const { return i % FX == 0 ? px0 : px0 + (float)((i % FX) * kWarpW); }
  __device__ __forceinline__ float py(int i) const { return i / FX == 0 ? py0 : py0 + (float)((i / FX) * kWarpH); }
  __device__ __forceinline__ bool owns(int i, const TileGrid& g, int ts) const {
    return px(i) < g.ox + (float)ts && py(i) < g.oy + (float)ts;
  }
  __device__ __forceinline__ int pix(int i, const TileGrid& g, int ts) const {
    return (int)(py(i) - g.oy) * ts + (int)(px(i) - g.ox);
  }
};

// A tile of edge above kMaxGroup is cut into n x n pixel groups of edge
// ceil(tile_size / n), n = ceil(tile_size / kMaxGroup), the last row and
// column cut by the tile's edge (kernels/cull.py group_layout mirrors it);
// a tile up to kMaxGroup is one group. Each group is one thread block of
// warp_layout(edge), edge in (32, 64] for n > 1.
struct GroupLayout {
  int n, edge;
};

inline GroupLayout group_layout(int tile_size) {
  const int n = (tile_size + kMaxGroup - 1) / kMaxGroup;
  return GroupLayout{n, (tile_size + n - 1) / n};
}

// The pixels one thread block composites. Without groups (kGroups false:
// a tile up to kMaxGroup) block b is tile slot b, and grid and ownership
// are the tile's (TileGrid, TilePixels). With groups, block b is group b %
// G of tile slot b / G (G = n * n, row-major), grid is the group's rect
// grid from the group's first pixel, and a pixel is the block's if it lies
// before (ex, ey), where the group or the tile ends, whichever is first;
// pix() counts a pixel's row-major index in the tile from the tile's first
// pixel (tx, ty). So spans stay within 8 bits whatever the tile, and
// pixels past the group's edge are owned by no lane of the block, as those
// past a tile's edge.
template <bool kGroups>
struct BlockPixels {
  int t, g;  // tile slot, group
  TileGrid grid;
  float ex, ey, tx, ty;

  __device__ __forceinline__ BlockPixels(const int* tile_ids, int n_tiles_x, int tile_size, GroupLayout gl) {
    if constexpr (kGroups) {
      const int groups = gl.n * gl.n;
      t = blockIdx.x / groups;
      g = blockIdx.x - t * groups;
      const int tile = tile_ids[t];
      tx = (float)((tile % n_tiles_x) * tile_size);
      ty = (float)((tile / n_tiles_x) * tile_size);
      grid.ox = tx + (float)((g % gl.n) * gl.edge);
      grid.oy = ty + (float)((g / gl.n) * gl.edge);
      grid.rects_x = (gl.edge + kWarpW - 1) / kWarpW;
      grid.rects_y = (gl.edge + kWarpH - 1) / kWarpH;
      ex = fminf(grid.ox + (float)gl.edge, tx + (float)tile_size);
      ey = fminf(grid.oy + (float)gl.edge, ty + (float)tile_size);
    } else {
      t = blockIdx.x;
      g = 0;
      grid = tile_grid(tile_ids[t], n_tiles_x, tile_size);
    }
  }

  template <class P>
  __device__ __forceinline__ bool owns(const P& me, int i, int tile_size) const {
    if constexpr (kGroups) {
      return me.px(i) < ex && me.py(i) < ey;
    } else {
      return me.owns(i, grid, tile_size);
    }
  }

  template <class P>
  __device__ __forceinline__ size_t pix(const P& me, int i, int tile_size) const {
    if constexpr (kGroups) {
      return (size_t)(me.py(i) - ty) * tile_size + (size_t)(me.px(i) - tx);
    } else {
      return me.pix(i, grid, tile_size);
    }
  }
};

// The type of a pixel count of one tile: int up to kMaxGroup (as before
// groups existed), size_t for a tile cut into groups, whose pixels may
// exceed int.
template <bool kGroups>
using PixIndex = typename std::conditional<kGroups, size_t, int>::type;

// Warp blocks per row of the grid.
template <int FX>
__device__ __forceinline__ int blocks_x(const TileGrid& g) { return (g.rects_x + FX - 1) / FX; }

template <int FX, int FY>
__device__ __forceinline__ TilePixels<FX, FY> tile_pixels(const TileGrid& g) {
  TilePixels<FX, FY> p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  p.rx = (warp % blocks_x<FX>(g)) * FX;
  p.ry = (warp / blocks_x<FX>(g)) * FY;
  p.px0 = g.ox + (float)(p.rx * kWarpW + lane % kWarpW);
  p.py0 = g.oy + (float)(p.ry * kWarpH + lane / kWarpW);
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

// The rects of the tile's grid that meet pixel rect r, packed as lo_x |
// hi_x << 8 | lo_y << 16 | hi_y << 24 (inclusive, in rect units), or
// kNoWarps. Rect rx covers [ox + rx*kWarpW, ox + (rx+1)*kWarpW); rect
// coordinates are whole pixels, so the divisions are exact.
__device__ __forceinline__ unsigned warp_span(float4 r, const TileGrid& t) {
  if (!(r.z > r.x && r.w > r.y)) return kNoWarps;
  const float lx = fmaxf(floorf((r.x - t.ox) / kWarpW), 0.0f);
  const float hx = fminf(floorf((r.z - 1.0f - t.ox) / kWarpW), (float)(t.rects_x - 1));
  const float ly = fmaxf(floorf((r.y - t.oy) / kWarpH), 0.0f);
  const float hy = fminf(floorf((r.w - 1.0f - t.oy) / kWarpH), (float)(t.rects_y - 1));
  if (!(lx <= hx && ly <= hy)) return kNoWarps;
  return (unsigned)lx | (unsigned)hx << 8 | (unsigned)ly << 16 | (unsigned)hy << 24;
}

// Stages the rows of a tile's pairs into shared memory, two sub-batches
// ahead of the one being composited. A pair block of up to kSubRows rows is
// one sub-batch; a larger one is cut into sub-batches of kSubRows rows (the
// last of a block may be shorter), so shared memory does not grow with the
// pair block, and no sub-batch straddles two blocks: the caller takes the
// early-stop vote where a sub-batch ends a block (ends_block). Thread i owns
// rows i, i + blockDim.x, ... of every sub-batch: it copies them with
// cp.async (four 16-byte copies a row; Hopper's TMA does not gather rows by
// index), and once its own copies have landed it takes each pair's rect and
// span from the staged row. Each sub-batch is one cp.async group of every
// thread (empty past the last), so __pipeline_wait_prior(1) always means
// "all but the newest sub-batch have landed". The pair id of a thread's
// first row of the next sub-batch to issue is loaded a sub-batch early, so
// issuing never waits on it.
//
// Use: begin(); __syncthreads(); then for every sub-batch s < batches:
// issue(s + 2), composite sub-batch s (row(s, j), span(s, j)), prepare(s +
// 1), and a block barrier before sub-batch s + 1; finish() before the block
// exits. kSplit: whether a pair block is cut into several sub-batches
// (pair_block > kSubRows); without it a sub-batch is a pair block, and the
// sub-batch arithmetic folds away at compile time.
template <bool kSplit>
struct Staging {
  float* rows;      // [kStages][sub][16]
  unsigned* spans;  // [2][sub]
  const float* feat;
  const int* pairs;  // the tile's pair slots
  int count, pair_block, sub, parts;
  int batches;  // sub-batches of the walked blocks
  float min_alpha;
  int next_gid;  // pair id of this thread's first row in the next sub-batch to issue

  // Walks the first `blocks` pair blocks of the tile's `count` pairs.
  __device__ Staging(float* smem, const float* feat_, const int* pairs_, int count_, int blocks,
                     int pair_block_, float min_alpha_) {
    feat = feat_;
    pairs = pairs_;
    count = count_;
    pair_block = pair_block_;
    sub = kSplit ? kSubRows : pair_block_;
    parts = kSplit ? (pair_block + kSubRows - 1) / kSubRows : 1;
    rows = smem;
    spans = reinterpret_cast<unsigned*>(smem + (size_t)kStages * sub * kRowFloats);
    if (kSplit) {
      batches = blocks > 0
          ? (blocks - 1) * parts + (min(pair_block, count - (blocks - 1) * pair_block) + sub - 1) / sub
          : 0;
    } else {
      batches = blocks;
    }
    min_alpha = min_alpha_;
    next_gid = 0;
  }

  __device__ __forceinline__ int block(int s) const { return kSplit ? s / parts : s; }
  __device__ __forceinline__ int first(int s) const {
    return kSplit ? block(s) * pair_block + (s % parts) * sub : s * pair_block;
  }
  __device__ __forceinline__ int size(int s) const {
    return kSplit ? min(min(sub, pair_block - (s % parts) * sub), count - first(s))
                  : min(pair_block, count - s * pair_block);
  }
  __device__ __forceinline__ bool ends_block(int s) const {
    return !kSplit || s % parts == parts - 1 || s == batches - 1;
  }
  __device__ __forceinline__ bool mine(int s) const { return s < batches && (int)threadIdx.x < size(s); }
  __device__ __forceinline__ float* row(int s, int j) const {
    return rows + ((size_t)(s % kStages) * sub + j) * kRowFloats;
  }
  __device__ __forceinline__ unsigned span(int s, int j) const { return spans[(s & 1) * sub + j]; }

  __device__ __forceinline__ void load_gid(int s) {
    if (mine(s)) next_gid = pairs[first(s) + threadIdx.x];
  }

  __device__ __forceinline__ void issue(int s) {
    if (s < batches) {
      const int n = size(s), f = first(s);
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int gid = j == (int)threadIdx.x ? next_gid : pairs[f + j];
        const float* src = feat + (size_t)gid * kRowFloats;
        float* dst = row(s, j);
#pragma unroll
        for (int q = 0; q < 4; ++q) __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);
      }
    }
    __pipeline_commit();
    load_gid(s + 1);
  }

  __device__ __forceinline__ void prepare(int s, const TileGrid& t) {
    __pipeline_wait_prior(1);
    if (s < batches) {
      const int n = size(s);
      for (int j = threadIdx.x; j < n; j += blockDim.x)
        spans[(s & 1) * sub + j] = warp_span(alpha_rect(row(s, j), min_alpha), t);
    }
  }

  __device__ __forceinline__ void begin(const TileGrid& t) {
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

// One pair at one pixel, from the first 13 floats of its row: a = (mx, my,
// cx, cy), b = (cxy, op, r, g), c = (b, x0, y0, x1) and y1.
__device__ __forceinline__ PairEval eval_pair(
    const float4 a, const float4 b, const float4 c, const float y1, float px, float py, float min_alpha,
    float max_alpha) {
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

// One pair at one pixel; s points at the pair's staged row.
__device__ __forceinline__ PairEval eval_pair(
    const float* s, float px, float py, float min_alpha, float max_alpha) {
  return eval_pair(*reinterpret_cast<const float4*>(s), *reinterpret_cast<const float4*>(s + 4),
                   *reinterpret_cast<const float4*>(s + 8), s[Y1], px, py, min_alpha, max_alpha);
}

}  // namespace gsplat
