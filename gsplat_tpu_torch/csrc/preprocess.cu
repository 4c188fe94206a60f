// Per-gaussian preprocess, forward and backward, for Hopper (sm_90a), bound
// to Python through plain C entry points (ctypes; see
// gsplat_tpu_torch/kernels/build.py).
//
// Replaces no TPU kernel: the JAX package leaves this elementwise work to
// XLA, which fuses it, and its gradient to jax.grad. The port's eager
// version (ops/sh.py sh_to_rgb, then ops/projection.py
// preprocess_gaussians_from_params) is some 480 PyTorch launches over [N]
// columns forward and some 750 in autograd's backward, each of which writes
// its result to device memory, and stacks of columns into [N, k] rows.
// These two kernels do the same work in one launch each
// (kernels/preprocess.py wraps them in one autograd Function). One thread a
// gaussian.
//
// The forward computes:
//   * the SH colour (degree 0-3), +0.5 and the clamp to [0, 1];
//   * the normalised quaternion's rotation and the 3D covariance;
//   * camera space and depth, the clip/NDC/pixel projection, the near cull,
//     and the viewspace probe's screen offset where one is given;
//   * the EWA 2D covariance with the tan clamp and the low-pass, the conic;
//   * the two-step block/pixel bbox, the alpha-bound cull rect, `active`.
// The backward takes the cotangents of the pixel means, the conic and the
// colour, recomputes the forward's intermediates in registers (nothing of
// the forward is saved but its inputs) and writes the gradients of the
// means, the activated scales, the raw quaternion and the SH coefficients,
// each parameter's terms summed in the thread (no atomics: a gaussian owns
// its rows). It gives what autograd gives through the eager path: half the
// gradient at a colour of exactly 0 or 1 (torch.minimum / maximum), all of
// it inside a clamp's ends included (the tan clamp, the quaternion norm's
// 1e-12 floor), and nothing through a torch.where's discarded branch: a
// culled gaussian's geometry takes no gradient, a gaussian at the camera
// centre no term of the view direction's norm. The screen offset's
// gradient is the pixel means' cotangent itself, which no kernel writes.
//
// What bounds both: bytes. The forward reads means 12 B, activated scales
// 12 B, quats 16 B, activated opacity 4 B and, at SH degree 3, 192 B of
// coefficients (236 B), and writes screen means 8 B, conic 12 B, rgb 12 B,
// depth 4 B, bbox 16 B, cull bbox 16 B and active 1 B (69 B): 305 B, so
// 1.525 GB at 5M gaussians and 0.455 ms at 3.35 TB/s. The backward reads
// the same but opacity (232 B) and three cotangents (32 B), and writes
// four gradients (232 B): 496 B, 2.48 GB and 0.740 ms at 5M. The arithmetic
// (some 300 FP32 operations a gaussian forward, some 700 backward, a few
// IEEE divisions and square roots) needs far less than that time.
//
// What the design does about it: each byte is read once and written once,
// and no intermediate leaves the registers. SH is 63% of what is read and,
// in the backward, 39% of what is written; a thread reading or writing its
// own 192 B row at a 192 B stride would not coalesce. So each block copies
// its contiguous slab of rows (kThreads rows, only the coefficients its
// degree reads) into shared memory with float4 loads, neighbouring threads
// on neighbouring addresses, all of a thread's loads in flight at once; the
// backward writes each thread's gradient row over its coefficients there
// and stores the slab back with float4 stores, as it was read. Rows are
// stored at an odd stride of words, so that the 32 threads of a warp, each
// reading its own row, meet 32 banks (at the row's 48 words they would meet
// 2, a 16-way conflict). The camera is read from device memory once a
// block: no host sync reads it. The backward reads each cotangent where
// autograd hands it over, at its row stride (column slices of the packed
// features' [N+1, 16] cotangent), rather than a copy.
//
// Bitwise parity with the eager path. The integer bboxes come from floor,
// ceil and clamps of floats, so one ulp can flip one, and the set-up's pair
// capacity probe runs without a gradient where training takes one. So
// every float step of the forward (and so of the backward's recomputation,
// which shares its code) keeps the eager code's order and rounding:
// round-to-nearest intrinsics (never an FMA contraction, which nvcc's
// default -fmad=true would make), IEEE division, reciprocal and square
// root, logf, NaN passed through as torch.clamp and torch.maximum pass it,
// and each Python constant rounded from double to float as PyTorch rounds a
// scalar. A division by a power-of-two Python number is a multiplication by
// its reciprocal, as PyTorch computes it; both are exact. `1.0 / x` is
// PyTorch's reciprocal, correctly rounded. Only the colour differs from the
// eager path, by the order of its sums: the eager path takes the view
// direction's norm and the dot product with the coefficients through
// library reductions. The backward's own products and sums are plain
// arithmetic: they differ from autograd's by their order alone.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // gaussians (and SH rows) of a block

// Constants of gsplat_tpu_torch/config.py, as Python floats;
// c() rounds one to float as PyTorch rounds a scalar operand.
constexpr double kNearZ = 0.2;        // FRUSTUM_NEAR_Z
constexpr double kPerspEps = 1e-7;    // PERSPECTIVE_EPS
constexpr double kTanClamp = 1.3;     // EWA_TAN_CLAMP
constexpr double kLowpass = 0.3;      // COV2D_LOWPASS
constexpr double kEigenFloor = 0.1;   // EIGENVALUE_FLOOR
constexpr double kSpread = 3.0;       // GAUSSIAN_SPREAD
constexpr double kQuatFloor = 1e-12;  // the quaternion norm's floor (ops/projection.py)
constexpr int kBlockSize = 16;        // BLOCK_SIZE

// ops/sh.py's SH_C0 ... SH_C3.
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
constexpr double kC20 = 1.0925484305920792, kC21 = -1.0925484305920792, kC22 = 0.31539156525252005,
                 kC23 = -1.0925484305920792, kC24 = 0.5462742152960396;
constexpr double kC30 = -0.5900435899266435, kC31 = 2.890611442640554, kC32 = -0.4570457994644658,
                 kC33 = 0.3731763325901154, kC34 = -0.4570457994644658, kC35 = 1.445305721320277,
                 kC36 = -0.5900435899266435;

__device__ __forceinline__ float c(double v) { return static_cast<float>(v); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }

// torch.clamp, clamp(min=), torch.maximum / minimum on float32: NaN passes.
__device__ __forceinline__ float clamp(float v, float lo, float hi) { return isnan(v) ? v : fminf(fmaxf(v, lo), hi); }
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float maximum(float a, float b) { return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b); }
__device__ __forceinline__ float minimum(float a, float b) { return isnan(a) ? a : isnan(b) ? b : fminf(a, b); }

// Float to int32 as PyTorch's .to(torch.int32) on the card (truncation;
// the callers have floored or ceiled and clamped the value).
__device__ __forceinline__ int to_int(float v) { return static_cast<int>(v); }

// ops/projection.py to_px: block units floored, clamped, back to pixels.
__device__ __forceinline__ int to_px(float v, int limit) {
  const int blocks = to_int(floorf(clamp(v, 0.0f, static_cast<float>(limit - 1))));
  return min(max(blocks * kBlockSize, 0), limit - 1);
}

// ops/projection.py _alpha_cull_bbox's lo: clamped to the screen before the
// int cast.
__device__ __forceinline__ int cull_lo(float v, int width, int height) {
  return to_int(clamp(v, -1.0f, static_cast<float>(width + height)));
}

// Coefficients (and float4s) of an SH row that degree kDegree reads; the
// odd shared-memory row stride in words.
template <int kDegree>
struct ShRow {
  static constexpr int kBasis = (kDegree + 1) * (kDegree + 1);
  static constexpr int kNeed4 = (kBasis * 3 + 3) / 4;
  static constexpr int kStride = kNeed4 * 4 + 1;  // odd: a warp's row reads meet 32 banks
};

// The block's camera (w2c_t 16, full_proj_t 16, cam_center 3, tan_fov 2,
// focal 2) into shared memory, by its first 39 threads.
__device__ __forceinline__ void load_camera(float* cam, int t, const float* w2c_t, const float* full_proj_t,
                                            const float* cam_center, const float* tan_fov, const float* focal) {
  if (t < 16) cam[t] = w2c_t[t];
  else if (t < 32) cam[t] = full_proj_t[t - 16];
  else if (t < 35) cam[t] = cam_center[t - 32];
  else if (t < 37) cam[t] = tan_fov[t - 35];
  else if (t < 39) cam[t] = focal[t - 37];
}

// The block's SH slab (`rows` rows from `slab`) into `stage`: every load
// issued before any store.
template <int kDegree>
__device__ __forceinline__ void load_slab(float* stage, const float4* __restrict__ slab, int sh_row4, int rows,
                                          int t) {
  using R = ShRow<kDegree>;
  float4 v[R::kNeed4];
#pragma unroll
  for (int k = 0; k < R::kNeed4; ++k) {
    const int i = t + k * kThreads, r = i / R::kNeed4;
    if (r < rows) v[k] = __ldcs(slab + (long long)r * sh_row4 + (i - r * R::kNeed4));
  }
#pragma unroll
  for (int k = 0; k < R::kNeed4; ++k) {
    const int i = t + k * kThreads, r = i / R::kNeed4;
    if (r < rows) {
      float* d = stage + r * R::kStride + 4 * (i - r * R::kNeed4);
      d[0] = v[k].x;
      d[1] = v[k].y;
      d[2] = v[k].z;
      d[3] = v[k].w;
    }
  }
}

// The view direction of ops/sh.py sh_to_rgb: mean - centre over its norm,
// or the zero direction for a gaussian at the camera centre (a pool's dead
// rows at the origin, seen from a camera there), whose norm is 0.
struct ViewDir {
  float dx, dy, dz, norm, den, x, y, z;
};

__device__ __forceinline__ ViewDir view_dir(float mx, float my, float mz, const float* center) {
  ViewDir v;
  v.dx = sub(mx, center[0]);
  v.dy = sub(my, center[1]);
  v.dz = sub(mz, center[2]);
  v.norm = root(add(add(mul(v.dx, v.dx), mul(v.dy, v.dy)), mul(v.dz, v.dz)));
  v.den = v.norm > 0.0f ? v.norm : 1.0f;
  v.x = div(v.dx, v.den);
  v.y = div(v.dy, v.den);
  v.z = div(v.dz, v.den);
  return v;
}

// The SH basis at a unit direction (ops/sh.py sh_basis), band-major.
template <int kDegree>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* basis) {
  basis[0] = c(kC0);
  if constexpr (kDegree > 0) {
    basis[1] = mul(c(-kC1), y);
    basis[2] = mul(c(kC1), z);
    basis[3] = mul(c(-kC1), x);
    if constexpr (kDegree > 1) {
      const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
      const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
      basis[4] = mul(c(kC20), xy);
      basis[5] = mul(c(kC21), yz);
      basis[6] = mul(c(kC22), sub(sub(mul(2.0f, zz), xx), yy));
      basis[7] = mul(c(kC23), xz);
      basis[8] = mul(c(kC24), sub(xx, yy));
      if constexpr (kDegree > 2) {
        basis[9] = mul(mul(c(kC30), y), sub(mul(3.0f, xx), yy));
        basis[10] = mul(mul(c(kC31), xy), z);
        basis[11] = mul(mul(c(kC32), y), sub(sub(mul(4.0f, zz), xx), yy));
        basis[12] = mul(mul(c(kC33), z), sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
        basis[13] = mul(mul(c(kC34), x), sub(sub(mul(4.0f, zz), xx), yy));
        basis[14] = mul(mul(c(kC35), z), sub(xx, yy));
        basis[15] = mul(mul(c(kC36), x), sub(xx, mul(3.0f, yy)));
      }
    }
  }
}

// The basis of one gaussian's view (the view direction where the degree
// reads one).
template <int kDegree>
__device__ __forceinline__ void view_basis(float mx, float my, float mz, const float* center, ViewDir& dir,
                                           float* basis) {
  if constexpr (kDegree > 0) {
    dir = view_dir(mx, my, mz, center);
    sh_basis<kDegree>(dir.x, dir.y, dir.z, basis);
  } else {
    sh_basis<0>(0.0f, 0.0f, 0.0f, basis);
  }
}

// Channel `ch` of the colour before its clamp: the basis's dot product
// with the staged row's coefficients, +0.5.
template <int kDegree>
__device__ __forceinline__ float sh_dot(const float* basis, const float* row, int ch) {
  float s = mul(basis[0], row[ch]);
#pragma unroll
  for (int b = 1; b < ShRow<kDegree>::kBasis; ++b) s = add(s, mul(basis[b], row[3 * b + ch]));
  return add(s, 0.5f);
}

// One gaussian's geometry for one camera (ops/projection.py
// preprocess_gaussians_from_params for one row, up to the conic): every
// intermediate the forward rounds and the backward differentiates. `cam`
// holds w2c_t [16], full_proj_t [16], cam_center [3], tan_fov [2] and focal
// [2], row-major. A culled gaussian's clip coordinates and 2D covariance
// are zero, as the eager path's torch.where makes them.
struct Geometry {
  float s, inv_n;                            // |q| and 1 / max(|q|, 1e-12)
  float qw, qx, qy, qz;                      // the normalised quaternion
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;
  float m00, m01, m02, m10, m11, m12, m20, m21, m22;  // m_aj = r_aj * s_j
  float c00, c01, c02, c11, c12, c22;        // the 3D covariance
  float cam_x, cam_y, depth;
  bool culled;
  float clip_x, clip_y, inv_w, mean_px, mean_py;
  float fx, fy, lim_x, lim_y, inv_z, ratio_x, ratio_y, tx_c, ty_c;
  float t00, t01, t02, t10, t11, t12;        // T = J W
  float u00, u01, u02, u10, u11, u12;        // T cov3d
  float cov_a, cov_b, cov_c, det, det_inv;   // the 2D covariance (a, b; b, c)
};

__device__ __forceinline__ Geometry geometry(float x, float y, float z, float sx, float sy, float sz, float4 q,
                                             const float* cam, int width, int height) {
  const float* W = cam;       // W[4 * i + j] = w2c_t[i, j]
  const float* P = cam + 16;  // P[4 * i + j] = full_proj_t[i, j]
  Geometry g;

  // -- rotation from the normalised quaternion (norm clamped at 1e-12) --
  g.s = root(add(add(add(mul(q.x, q.x), mul(q.y, q.y)), mul(q.z, q.z)), mul(q.w, q.w)));
  g.inv_n = rcp(clamp_min(g.s, c(kQuatFloor)));
  g.qw = mul(q.x, g.inv_n);
  g.qx = mul(q.y, g.inv_n);
  g.qy = mul(q.z, g.inv_n);
  g.qz = mul(q.w, g.inv_n);
  const float qw = g.qw, qx = g.qx, qy = g.qy, qz = g.qz;
  g.r00 = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  g.r01 = mul(2.0f, sub(mul(qx, qy), mul(qz, qw)));
  g.r02 = mul(2.0f, add(mul(qx, qz), mul(qy, qw)));
  g.r10 = mul(2.0f, add(mul(qx, qy), mul(qz, qw)));
  g.r11 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  g.r12 = mul(2.0f, sub(mul(qy, qz), mul(qx, qw)));
  g.r20 = mul(2.0f, sub(mul(qx, qz), mul(qy, qw)));
  g.r21 = mul(2.0f, add(mul(qy, qz), mul(qx, qw)));
  g.r22 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));

  // -- 3D covariance: m_aj = r_aj * s_j, c_ab = sum_j m_aj * m_bj --
  g.m00 = mul(g.r00, sx), g.m01 = mul(g.r01, sy), g.m02 = mul(g.r02, sz);
  g.m10 = mul(g.r10, sx), g.m11 = mul(g.r11, sy), g.m12 = mul(g.r12, sz);
  g.m20 = mul(g.r20, sx), g.m21 = mul(g.r21, sy), g.m22 = mul(g.r22, sz);
  g.c00 = add(add(mul(g.m00, g.m00), mul(g.m01, g.m01)), mul(g.m02, g.m02));
  g.c01 = add(add(mul(g.m00, g.m10), mul(g.m01, g.m11)), mul(g.m02, g.m12));
  g.c02 = add(add(mul(g.m00, g.m20), mul(g.m01, g.m21)), mul(g.m02, g.m22));
  g.c11 = add(add(mul(g.m10, g.m10), mul(g.m11, g.m11)), mul(g.m12, g.m12));
  g.c12 = add(add(mul(g.m10, g.m20), mul(g.m11, g.m21)), mul(g.m12, g.m22));
  g.c22 = add(add(mul(g.m20, g.m20), mul(g.m21, g.m21)), mul(g.m22, g.m22));

  // -- camera space and depth (row-vector convention) --
  auto row_vec = [&](const float* M, int j) {
    return add(add(add(mul(x, M[j]), mul(y, M[4 + j])), mul(z, M[8 + j])), M[12 + j]);
  };
  g.cam_x = row_vec(W, 0), g.cam_y = row_vec(W, 1), g.depth = row_vec(W, 2);
  g.culled = g.depth < c(kNearZ);

  // -- clip/NDC/pixel projection --
  g.clip_x = g.culled ? 0.0f : row_vec(P, 0);
  g.clip_y = g.culled ? 0.0f : row_vec(P, 1);
  const float clip_w = g.culled ? 0.0f : row_vec(P, 3);
  g.inv_w = rcp(add(clip_w, c(kPerspEps)));
  g.mean_px = mul(sub(mul(add(mul(g.clip_x, g.inv_w), 1.0f), (float)width), 1.0f), 0.5f);
  g.mean_py = mul(sub(mul(add(mul(g.clip_y, g.inv_w), 1.0f), (float)height), 1.0f), 0.5f);

  // -- EWA projection: T = J W with W[k, j] = w2c_t[j, k] --
  g.fx = mul(cam[37], 0.5f), g.fy = mul(cam[38], 0.5f);
  g.lim_x = mul(c(kTanClamp), cam[35]), g.lim_y = mul(c(kTanClamp), cam[36]);
  g.inv_z = rcp(g.depth);
  g.ratio_x = mul(g.cam_x, g.inv_z);
  g.ratio_y = mul(g.cam_y, g.inv_z);
  g.tx_c = mul(clamp(g.ratio_x, -g.lim_x, g.lim_x), g.depth);
  g.ty_c = mul(clamp(g.ratio_y, -g.lim_y, g.lim_y), g.depth);
  const float j00 = mul(g.fx, g.inv_z);
  const float j02 = mul(mul(mul(-g.fx, g.tx_c), g.inv_z), g.inv_z);
  const float j11 = mul(g.fy, g.inv_z);
  const float j12 = mul(mul(mul(-g.fy, g.ty_c), g.inv_z), g.inv_z);
  g.t00 = add(mul(j00, W[0]), mul(j02, W[2]));
  g.t01 = add(mul(j00, W[4]), mul(j02, W[6]));
  g.t02 = add(mul(j00, W[8]), mul(j02, W[10]));
  g.t10 = add(mul(j11, W[1]), mul(j12, W[2]));
  g.t11 = add(mul(j11, W[5]), mul(j12, W[6]));
  g.t12 = add(mul(j11, W[9]), mul(j12, W[10]));
  g.u00 = add(add(mul(g.t00, g.c00), mul(g.t01, g.c01)), mul(g.t02, g.c02));
  g.u01 = add(add(mul(g.t00, g.c01), mul(g.t01, g.c11)), mul(g.t02, g.c12));
  g.u02 = add(add(mul(g.t00, g.c02), mul(g.t01, g.c12)), mul(g.t02, g.c22));
  g.u10 = add(add(mul(g.t10, g.c00), mul(g.t11, g.c01)), mul(g.t12, g.c02));
  g.u11 = add(add(mul(g.t10, g.c01), mul(g.t11, g.c11)), mul(g.t12, g.c12));
  g.u12 = add(add(mul(g.t10, g.c02), mul(g.t11, g.c12)), mul(g.t12, g.c22));
  // Culled gaussians get a zero covariance -> det == 0 -> zero conic.
  g.cov_a = g.culled ? 0.0f : add(add(add(mul(g.u00, g.t00), mul(g.u01, g.t01)), mul(g.u02, g.t02)), c(kLowpass));
  g.cov_b = g.culled ? 0.0f : add(add(mul(g.u00, g.t10), mul(g.u01, g.t11)), mul(g.u02, g.t12));
  g.cov_c = g.culled ? 0.0f : add(add(add(mul(g.u10, g.t10), mul(g.u11, g.t11)), mul(g.u12, g.t12)), c(kLowpass));

  // -- conic's determinant --
  g.det = sub(mul(g.cov_a, g.cov_c), mul(g.cov_b, g.cov_b));
  g.det_inv = g.det == 0.0f ? 0.0f : rcp(g.det);
  return g;
}

// What the preprocess writes of one gaussian for one camera, but the colour.
struct Projected {
  float mean_px, mean_py, conic_x, conic_y, conic_xy;
  int4 bbox, cull_bbox;
  bool active;
};

// The conic, bboxes and active flag from a gaussian's geometry, its pixel
// means (with the screen offset where one is given) and its activated
// opacity.
template <bool kStrict>
__device__ __forceinline__ Projected project(const Geometry& g, float mean_px, float mean_py, float opacity,
                                             int width, int height) {
  const float cov_a = g.cov_a, cov_b = g.cov_b, cov_c = g.cov_c, det = g.det;
  const float conic_x = mul(cov_c, g.det_inv), conic_y = mul(cov_a, g.det_inv), conic_xy = mul(-cov_b, g.det_inv);

  // -- covering bbox: block-unit rounding, then pixels (two-step) --
  const float trace = add(cov_a, cov_c);
  const float half_trace = mul(trace, 0.5f);
  const float sq = root(clamp_min(sub(mul(mul(trace, trace), 0.25f), det), c(kEigenFloor)));
  const float spread = ceilf(mul(c(kSpread), root(maximum(add(half_trace, sq), sub(half_trace, sq)))));
  constexpr float kInvBlock = 1.0f / kBlockSize;
  const int x_min = to_px(mul(sub(mean_px, spread), kInvBlock), width);
  const int y_min = to_px(mul(sub(mean_py, spread), kInvBlock), height);
  const int x_max = to_px(mul(sub(add(add(mean_px, spread), (float)kBlockSize), 1.0f), kInvBlock), width);
  const int y_max = to_px(mul(sub(add(add(mean_py, spread), (float)kBlockSize), 1.0f), kInvBlock), height);
  const bool conic_ok = kStrict ? (conic_x != 0.0f && conic_y != 0.0f && conic_xy != 0.0f)
                                : (conic_x != 0.0f || conic_y != 0.0f || conic_xy != 0.0f);

  // -- alpha-bound cull rect (ops/projection.py _alpha_cull_bbox) --
  const float log_gate = logf(mul(clamp_min(opacity, c(1e-30)), 255.0f));
  const bool live = log_gate > 0.0f;
  const float gate = clamp_min(log_gate, 0.0f);
  const float rx = add(root(mul(mul(2.0f, clamp_min(cov_a, 0.0f)), gate)), 1.0f);
  const float ry = add(root(mul(mul(2.0f, clamp_min(cov_c, 0.0f)), gate)), 1.0f);
  const int cx_min = max(x_min, cull_lo(ceilf(sub(mean_px, rx)), width, height));
  const int cy_min = max(y_min, cull_lo(ceilf(sub(mean_py, ry)), width, height));
  const int cx_max = live ? min(x_max, cull_lo(floorf(add(mean_px, rx)), width, height) + 1) : cx_min;
  const int cy_max = live ? min(y_max, cull_lo(floorf(add(mean_py, ry)), width, height) + 1) : cy_min;

  return {mean_px, mean_py, conic_x, conic_y, conic_xy, make_int4(x_min, y_min, x_max, y_max),
          make_int4(cx_min, cy_min, cx_max, cy_max), (x_max - x_min) * (y_max - y_min) > 0 && conic_ok};
}

template <int kDegree, bool kStrict>
__global__ void __launch_bounds__(kThreads) preprocess_kernel(
    const float* __restrict__ means,        // [N, 3]
    const float* __restrict__ scales,       // [N, 3] activated
    const float4* __restrict__ quats,       // [N, 4] (w, x, y, z), raw
    const float* __restrict__ opacity,      // [N] activated
    const float4* __restrict__ sh,          // [N, K, 3] as rows of sh_row4 float4s
    int sh_row4,
    const float* __restrict__ w2c_t,        // [4, 4] row-vector world -> camera
    const float* __restrict__ full_proj_t,  // [4, 4] row-vector world -> clip
    const float* __restrict__ cam_center,   // [3]
    const float* __restrict__ tan_fov,      // [2]
    const float* __restrict__ focal,        // [2]
    const float* __restrict__ screen_offset,  // [N, 2], or null
    int n, int width, int height,
    float2* __restrict__ screen_means,      // [N, 2]
    float* __restrict__ conics,             // [N, 3]
    float* __restrict__ rgb,                // [N, 3]
    float* __restrict__ depth_out,          // [N]
    int4* __restrict__ bbox,                // [N, 4]
    int4* __restrict__ cull_bbox,           // [N, 4]
    bool* __restrict__ active) {            // [N]
  using R = ShRow<kDegree>;
  __shared__ float stage[kThreads * R::kStride];
  __shared__ float cam[39];

  const int t = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * kThreads;
  const long long left = (long long)n - g0;
  const int rows = left < kThreads ? (int)left : kThreads;
  load_camera(cam, t, w2c_t, full_proj_t, cam_center, tan_fov, focal);
  load_slab<kDegree>(stage, sh + g0 * sh_row4, sh_row4, rows, t);
  __syncthreads();
  if (t >= rows) return;
  const long long g = g0 + t;

  const float x = means[3 * g], y = means[3 * g + 1], z = means[3 * g + 2];
  const float* row = stage + t * R::kStride;
  ViewDir dir;
  float basis[R::kBasis];
  view_basis<kDegree>(x, y, z, cam + 32, dir, basis);

  const Geometry geo = geometry(x, y, z, scales[3 * g], scales[3 * g + 1], scales[3 * g + 2], quats[g], cam,
                                width, height);
  float mean_px = geo.mean_px, mean_py = geo.mean_py;
  if (screen_offset != nullptr) {
    mean_px = add(mean_px, screen_offset[2 * g]);
    mean_py = add(mean_py, screen_offset[2 * g + 1]);
  }
  const Projected p = project<kStrict>(geo, mean_px, mean_py, opacity[g], width, height);
  screen_means[g] = make_float2(p.mean_px, p.mean_py);
  conics[3 * g] = p.conic_x;
  conics[3 * g + 1] = p.conic_y;
  conics[3 * g + 2] = p.conic_xy;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) rgb[3 * g + ch] = minimum(maximum(sh_dot<kDegree>(basis, row, ch), 0.0f), 1.0f);
  depth_out[g] = geo.depth;
  bbox[g] = p.bbox;
  cull_bbox[g] = p.cull_bbox;
  active[g] = p.active;
}

// The gradient of one gaussian's colour (cotangent `v_rgb`) with respect to
// its SH coefficients, written over the staged row `row` (zeros past the
// degree's coefficients), and to its mean, added to `v_mean`.
template <int kDegree>
__device__ __forceinline__ void sh_backward(float* row, float mx, float my, float mz, const float* center,
                                            const float* v_rgb, float* v_mean) {
  using R = ShRow<kDegree>;
  ViewDir dir;
  float basis[R::kBasis];
  view_basis<kDegree>(mx, my, mz, center, dir, basis);

  // The colour's clamp, minimum(maximum(v, 0), 1): each passes half the
  // gradient where its operands are equal.
  float v_col[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float v = sh_dot<kDegree>(basis, row, ch), hi = maximum(v, 0.0f);
    float g = v_rgb[ch];
    g = hi > 1.0f ? 0.0f : hi == 1.0f ? 0.5f * g : g;
    g = v < 0.0f ? 0.0f : v == 0.0f ? 0.5f * g : g;
    v_col[ch] = g;
  }

  if constexpr (kDegree > 0) {
    float vb[R::kBasis];  // d colour . v_col / d basis_b
#pragma unroll
    for (int b = 1; b < R::kBasis; ++b) {
      vb[b] = row[3 * b] * v_col[0] + row[3 * b + 1] * v_col[1] + row[3 * b + 2] * v_col[2];
    }
    // d basis / d direction, band by band.
    const float x = dir.x, y = dir.y, z = dir.z;
    float gx = -c(kC1) * vb[3], gy = -c(kC1) * vb[1], gz = c(kC1) * vb[2];
    if constexpr (kDegree > 1) {
      gx += c(kC20) * y * vb[4] - 2.0f * c(kC22) * x * vb[6] + c(kC23) * z * vb[7] + 2.0f * c(kC24) * x * vb[8];
      gy += c(kC20) * x * vb[4] + c(kC21) * z * vb[5] - 2.0f * c(kC22) * y * vb[6] - 2.0f * c(kC24) * y * vb[8];
      gz += c(kC21) * y * vb[5] + 4.0f * c(kC22) * z * vb[6] + c(kC23) * x * vb[7];
      if constexpr (kDegree > 2) {
        const float xx = x * x, yy = y * y, zz = z * z;
        gx += c(kC30) * 6.0f * x * y * vb[9] + c(kC31) * y * z * vb[10] - c(kC32) * 2.0f * x * y * vb[11]
              - c(kC33) * 6.0f * x * z * vb[12] + c(kC34) * (4.0f * zz - 3.0f * xx - yy) * vb[13]
              + c(kC35) * 2.0f * x * z * vb[14] + c(kC36) * 3.0f * (xx - yy) * vb[15];
        gy += c(kC30) * 3.0f * (xx - yy) * vb[9] + c(kC31) * x * z * vb[10]
              + c(kC32) * (4.0f * zz - xx - 3.0f * yy) * vb[11] - c(kC33) * 6.0f * y * z * vb[12]
              - c(kC34) * 2.0f * x * y * vb[13] - c(kC35) * 2.0f * y * z * vb[14]
              - c(kC36) * 6.0f * x * y * vb[15];
        gz += c(kC31) * x * y * vb[10] + c(kC32) * 8.0f * y * z * vb[11]
              + c(kC33) * (6.0f * zz - 3.0f * xx - 3.0f * yy) * vb[12] + c(kC34) * 8.0f * x * z * vb[13]
              + c(kC35) * (xx - yy) * vb[14];
      }
    }
    // direction = d / den, den = norm where norm > 0, else 1 (a discarded
    // norm gets no gradient); d |d| / d d = d / |d|.
    float ux = gx / dir.den, uy = gy / dir.den, uz = gz / dir.den;
    if (dir.norm > 0.0f) {
      const float v_norm = -(gx * dir.dx + gy * dir.dy + gz * dir.dz) / (dir.den * dir.den) / dir.norm;
      ux += dir.dx * v_norm;
      uy += dir.dy * v_norm;
      uz += dir.dz * v_norm;
    }
    v_mean[0] += ux;
    v_mean[1] += uy;
    v_mean[2] += uz;
  }
#pragma unroll
  for (int b = 0; b < R::kBasis; ++b) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) row[3 * b + ch] = basis[b] * v_col[ch];
  }
#pragma unroll
  for (int i = 3 * R::kBasis; i < 4 * R::kNeed4; ++i) row[i] = 0.0f;
}

// The gradient of one gaussian's pixel means (v_px, v_py) and conic
// (v_cx, v_cy, v_cxy) with respect to its mean (added to v_mean), scales
// and raw quaternion (written), through its recomputed geometry. A culled
// gaussian's clip coordinates and covariance are torch.where's discarded
// branch: it takes none.
__device__ __forceinline__ void geometry_backward(const Geometry& g, float4 q, float sx, float sy, float sz,
                                                  const float* cam, int width, int height, float v_px, float v_py,
                                                  float v_cx, float v_cy, float v_cxy, float* v_mean,
                                                  float* v_scale, float4& v_quat) {
  v_scale[0] = v_scale[1] = v_scale[2] = 0.0f;
  v_quat = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (g.culled) return;
  const float* W = cam;
  const float* P = cam + 16;

  // -- pixel means: ((clip * inv_w + 1) * size - 1) / 2, inv_w = 1 / (clip_w + eps) --
  const float hw = 0.5f * (float)width, hh = 0.5f * (float)height;
  const float v_clip_x = v_px * hw * g.inv_w, v_clip_y = v_py * hh * g.inv_w;
  const float v_clip_w = -(v_px * hw * g.clip_x + v_py * hh * g.clip_y) * g.inv_w * g.inv_w;
  float vx = P[0] * v_clip_x + P[1] * v_clip_y + P[3] * v_clip_w;
  float vy = P[4] * v_clip_x + P[5] * v_clip_y + P[7] * v_clip_w;
  float vz = P[8] * v_clip_x + P[9] * v_clip_y + P[11] * v_clip_w;

  // -- conic: (c, a, -b) / det, det_inv = 0 where det == 0 --
  float v_a = v_cy * g.det_inv, v_b = -v_cxy * g.det_inv, v_c = v_cx * g.det_inv;
  if (g.det != 0.0f) {
    const float v_det = -(v_cx * g.cov_c + v_cy * g.cov_a - v_cxy * g.cov_b) * g.det_inv * g.det_inv;
    v_a += v_det * g.cov_c;
    v_c += v_det * g.cov_a;
    v_b -= 2.0f * v_det * g.cov_b;
  }

  // -- 2D covariance: a = u0 . t0, b = u0 . t1, c = u1 . t1, u = T cov3d --
  const float vu00 = v_a * g.t00 + v_b * g.t10, vu01 = v_a * g.t01 + v_b * g.t11, vu02 = v_a * g.t02 + v_b * g.t12;
  const float vu10 = v_c * g.t10, vu11 = v_c * g.t11, vu12 = v_c * g.t12;
  const float vt00 = v_a * g.u00 + vu00 * g.c00 + vu01 * g.c01 + vu02 * g.c02;
  const float vt01 = v_a * g.u01 + vu00 * g.c01 + vu01 * g.c11 + vu02 * g.c12;
  const float vt02 = v_a * g.u02 + vu00 * g.c02 + vu01 * g.c12 + vu02 * g.c22;
  const float vt10 = v_b * g.u00 + v_c * g.u10 + vu10 * g.c00 + vu11 * g.c01 + vu12 * g.c02;
  const float vt11 = v_b * g.u01 + v_c * g.u11 + vu10 * g.c01 + vu11 * g.c11 + vu12 * g.c12;
  const float vt12 = v_b * g.u02 + v_c * g.u12 + vu10 * g.c02 + vu11 * g.c12 + vu12 * g.c22;
  // d cov3d (each off-diagonal entry counted from both of its places)
  const float vc00 = g.t00 * vu00 + g.t10 * vu10;
  const float vc11 = g.t01 * vu01 + g.t11 * vu11;
  const float vc22 = g.t02 * vu02 + g.t12 * vu12;
  const float vc01 = g.t00 * vu01 + g.t01 * vu00 + g.t10 * vu11 + g.t11 * vu10;
  const float vc02 = g.t00 * vu02 + g.t02 * vu00 + g.t10 * vu12 + g.t12 * vu10;
  const float vc12 = g.t01 * vu02 + g.t02 * vu01 + g.t11 * vu12 + g.t12 * vu11;

  // -- T = J W: t0k = j00 W[k, 0] + j02 W[k, 2], t1k = j11 W[k, 1] + j12 W[k, 2] --
  const float vj00 = vt00 * W[0] + vt01 * W[4] + vt02 * W[8];
  const float vj02 = vt00 * W[2] + vt01 * W[6] + vt02 * W[10];
  const float vj11 = vt10 * W[1] + vt11 * W[5] + vt12 * W[9];
  const float vj12 = vt10 * W[2] + vt11 * W[6] + vt12 * W[10];
  // j00 = fx inv_z, j02 = -fx tx_c inv_z^2 (y likewise)
  const float inv_z2 = g.inv_z * g.inv_z;
  float v_inv_z = vj00 * g.fx + vj11 * g.fy - 2.0f * g.inv_z * (vj02 * g.fx * g.tx_c + vj12 * g.fy * g.ty_c);
  const float v_tx = -vj02 * g.fx * inv_z2, v_ty = -vj12 * g.fy * inv_z2;
  // tx_c = clamp(cam_x inv_z, +-lim_x) depth: the clamp passes all of it within its ends.
  const bool in_x = g.ratio_x >= -g.lim_x && g.ratio_x <= g.lim_x;
  const bool in_y = g.ratio_y >= -g.lim_y && g.ratio_y <= g.lim_y;
  const float v_rx = in_x ? v_tx * g.depth : 0.0f, v_ry = in_y ? v_ty * g.depth : 0.0f;
  float v_depth = v_tx * clamp(g.ratio_x, -g.lim_x, g.lim_x) + v_ty * clamp(g.ratio_y, -g.lim_y, g.lim_y);
  const float v_cam_x = v_rx * g.inv_z, v_cam_y = v_ry * g.inv_z;
  v_inv_z += v_rx * g.cam_x + v_ry * g.cam_y;
  v_depth -= v_inv_z * inv_z2;
  vx += W[0] * v_cam_x + W[1] * v_cam_y + W[2] * v_depth;
  vy += W[4] * v_cam_x + W[5] * v_cam_y + W[6] * v_depth;
  vz += W[8] * v_cam_x + W[9] * v_cam_y + W[10] * v_depth;
  v_mean[0] += vx;
  v_mean[1] += vy;
  v_mean[2] += vz;

  // -- cov3d = M M^T: d m_aj = sum_b G_ab m_bj, G_aa = 2 d c_aa, G_ab = d c_ab --
  const float G00 = 2.0f * vc00, G11 = 2.0f * vc11, G22 = 2.0f * vc22;
  const float vm00 = G00 * g.m00 + vc01 * g.m10 + vc02 * g.m20;
  const float vm01 = G00 * g.m01 + vc01 * g.m11 + vc02 * g.m21;
  const float vm02 = G00 * g.m02 + vc01 * g.m12 + vc02 * g.m22;
  const float vm10 = vc01 * g.m00 + G11 * g.m10 + vc12 * g.m20;
  const float vm11 = vc01 * g.m01 + G11 * g.m11 + vc12 * g.m21;
  const float vm12 = vc01 * g.m02 + G11 * g.m12 + vc12 * g.m22;
  const float vm20 = vc02 * g.m00 + vc12 * g.m10 + G22 * g.m20;
  const float vm21 = vc02 * g.m01 + vc12 * g.m11 + G22 * g.m21;
  const float vm22 = vc02 * g.m02 + vc12 * g.m12 + G22 * g.m22;
  // m_aj = r_aj s_j
  v_scale[0] = vm00 * g.r00 + vm10 * g.r10 + vm20 * g.r20;
  v_scale[1] = vm01 * g.r01 + vm11 * g.r11 + vm21 * g.r21;
  v_scale[2] = vm02 * g.r02 + vm12 * g.r12 + vm22 * g.r22;
  const float v00 = vm00 * sx, v01 = vm01 * sy, v02 = vm02 * sz;
  const float v10 = vm10 * sx, v11 = vm11 * sy, v12 = vm12 * sz;
  const float v20 = vm20 * sx, v21 = vm21 * sy, v22 = vm22 * sz;

  // -- rotation of the normalised quaternion (w, x, y, z) --
  const float qw = g.qw, qx = g.qx, qy = g.qy, qz = g.qz;
  const float vqw = 2.0f * (qx * (v21 - v12) + qy * (v02 - v20) + qz * (v10 - v01));
  const float vqx = 2.0f * (qy * (v01 + v10) + qz * (v02 + v20) + qw * (v21 - v12) - 2.0f * qx * (v11 + v22));
  const float vqy = 2.0f * (qx * (v01 + v10) + qz * (v12 + v21) + qw * (v02 - v20) - 2.0f * qy * (v00 + v22));
  const float vqz = 2.0f * (qx * (v02 + v20) + qy * (v12 + v21) + qw * (v10 - v01) - 2.0f * qz * (v00 + v11));
  // q_hat = q / max(|q|, 1e-12): the clamp passes all of it at |q| >= 1e-12,
  // and sqrt's backward divides by 2 |q| (0/0 at a zero quaternion, as autograd gives).
  const float v_inv_n = vqw * q.x + vqx * q.y + vqy * q.z + vqz * q.w;
  const float v_s = g.s >= c(kQuatFloor) ? -v_inv_n * g.inv_n * g.inv_n : 0.0f;
  const float v_sq = v_s / (2.0f * g.s) * 2.0f;  // d |q|^2 / d q_i = 2 q_i
  v_quat = make_float4(vqw * g.inv_n + v_sq * q.x, vqx * g.inv_n + v_sq * q.y, vqy * g.inv_n + v_sq * q.z,
                       vqz * g.inv_n + v_sq * q.w);
}

template <int kDegree>
__global__ void __launch_bounds__(kThreads) preprocess_bwd_kernel(
    const float* __restrict__ means,        // [N, 3]
    const float* __restrict__ scales,       // [N, 3] activated
    const float4* __restrict__ quats,       // [N, 4] (w, x, y, z), raw
    const float4* __restrict__ sh,          // [N, K, 3] as rows of sh_row4 float4s
    int sh_row4,
    const float* __restrict__ w2c_t, const float* __restrict__ full_proj_t, const float* __restrict__ cam_center,
    const float* __restrict__ tan_fov, const float* __restrict__ focal,
    int n, int width, int height,
    const float* __restrict__ v_means2d, long long v_means2d_row,  // [N, 2] at a row stride in floats
    const float* __restrict__ v_conics, long long v_conics_row,    // [N, 3]
    const float* __restrict__ v_rgb, long long v_rgb_row,          // [N, 3]
    float* __restrict__ g_means,            // [N, 3]
    float* __restrict__ g_scales,           // [N, 3]
    float4* __restrict__ g_quats,           // [N, 4]
    float4* __restrict__ g_sh) {            // [N, K, 3] as rows of sh_row4 float4s
  using R = ShRow<kDegree>;
  __shared__ float stage[kThreads * R::kStride];
  __shared__ float cam[39];

  const int t = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * kThreads;
  const long long left = (long long)n - g0;
  const int rows = left < kThreads ? (int)left : kThreads;
  load_camera(cam, t, w2c_t, full_proj_t, cam_center, tan_fov, focal);
  load_slab<kDegree>(stage, sh + g0 * sh_row4, sh_row4, rows, t);
  __syncthreads();

  if (t < rows) {
    const long long g = g0 + t;
    const float x = means[3 * g], y = means[3 * g + 1], z = means[3 * g + 2];
    const float sx = scales[3 * g], sy = scales[3 * g + 1], sz = scales[3 * g + 2];
    const float4 q = quats[g];
    const float* vm = v_means2d + g * v_means2d_row;
    const float* vc = v_conics + g * v_conics_row;
    const float* vr = v_rgb + g * v_rgb_row;
    const float v_col[3] = {vr[0], vr[1], vr[2]};
    float v_mean[3] = {0.0f, 0.0f, 0.0f}, v_scale[3];
    float4 v_quat;
    sh_backward<kDegree>(stage + t * R::kStride, x, y, z, cam + 32, v_col, v_mean);
    const Geometry geo = geometry(x, y, z, sx, sy, sz, q, cam, width, height);
    geometry_backward(geo, q, sx, sy, sz, cam, width, height, vm[0], vm[1], vc[0], vc[1], vc[2], v_mean, v_scale,
                      v_quat);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_means[3 * g + i] = v_mean[i];
      g_scales[3 * g + i] = v_scale[i];
    }
    g_quats[g] = v_quat;
  }
  __syncthreads();

  // The block's SH gradient rows, stored as the slab was loaded: float4s,
  // neighbouring threads on neighbouring addresses; zeros past the degree.
  float4* out = g_sh + g0 * sh_row4;
#pragma unroll
  for (int k = 0; k < R::kNeed4; ++k) {
    const int i = t + k * kThreads, r = i / R::kNeed4;
    if (r < rows) {
      const float* s = stage + r * R::kStride + 4 * (i - r * R::kNeed4);
      __stcs(out + (long long)r * sh_row4 + (i - r * R::kNeed4), make_float4(s[0], s[1], s[2], s[3]));
    }
  }
  const int tail = sh_row4 - R::kNeed4;
  for (int i = t; i < rows * tail; i += kThreads) {
    const int r = i / tail;
    __stcs(out + (long long)r * sh_row4 + R::kNeed4 + (i - r * tail), make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  }
}

using Kernel = decltype(&preprocess_kernel<3, true>);
using BwdKernel = decltype(&preprocess_bwd_kernel<3>);

template <int kDegree>
Kernel pick(bool strict) {
  return strict ? &preprocess_kernel<kDegree, true> : &preprocess_kernel<kDegree, false>;
}

// float4s of an SH row that degree `degree` reads.
int need4(int degree) { return ((degree + 1) * (degree + 1) * 3 + 3) / 4; }

unsigned blocks_for(int n) { return (unsigned)(((long long)n + kThreads - 1) / kThreads); }

}  // namespace

// Launches ceil(n / 128) blocks of 128 threads on `stream`; allocates
// nothing and does not synchronise. `sh` holds rows of sh_row4 float4s (the
// [N, K, 3] coefficients with 3K a multiple of 4, 16-byte aligned, as
// `quats`); `screen_offset` is [N, 2] or null; a degree outside 0..3 or
// rows too short for it: cudaErrorInvalidValue. Returns cudaGetLastError()
// after the launch.
extern "C" int gsplat_preprocess(
    const void* means, const void* scales, const void* quats, const void* opacity, const void* sh, int sh_row4,
    const void* w2c_t, const void* full_proj_t, const void* cam_center, const void* tan_fov, const void* focal,
    const void* screen_offset, int n, int width, int height, int degree, int strict_parity, void* screen_means,
    void* conics, void* rgb, void* depth, void* bbox, void* cull_bbox, void* active, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || degree < 0 || degree > 3 || sh_row4 < need4(degree) || width < 1 || height < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const bool strict = strict_parity != 0;
  const Kernel kernel = degree == 0 ? pick<0>(strict) : degree == 1 ? pick<1>(strict)
                        : degree == 2 ? pick<2>(strict) : pick<3>(strict);
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(scales), static_cast<const float4*>(quats),
      static_cast<const float*>(opacity), static_cast<const float4*>(sh), sh_row4,
      static_cast<const float*>(w2c_t), static_cast<const float*>(full_proj_t),
      static_cast<const float*>(cam_center), static_cast<const float*>(tan_fov), static_cast<const float*>(focal),
      static_cast<const float*>(screen_offset), n, width, height, static_cast<float2*>(screen_means),
      static_cast<float*>(conics), static_cast<float*>(rgb), static_cast<float*>(depth), static_cast<int4*>(bbox),
      static_cast<int4*>(cull_bbox), static_cast<bool*>(active));
  return (int)cudaGetLastError();
}

// The backward of gsplat_preprocess for the same inputs but opacity: the
// cotangents of the pixel means, conics and colours, each read at its row
// stride in floats (its columns contiguous), give the gradients of the
// means, activated scales, raw quaternions and SH coefficients (the whole
// [N, K, 3] rows, zeros past the degree; 16-byte aligned, as `sh`). The
// same launch and errors as gsplat_preprocess.
extern "C" int gsplat_preprocess_backward(
    const void* means, const void* scales, const void* quats, const void* sh, int sh_row4, const void* w2c_t,
    const void* full_proj_t, const void* cam_center, const void* tan_fov, const void* focal, int n, int width,
    int height, int degree, const void* v_means2d, long long v_means2d_row, const void* v_conics,
    long long v_conics_row, const void* v_rgb, long long v_rgb_row, void* g_means, void* g_scales, void* g_quats,
    void* g_sh, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || degree < 0 || degree > 3 || sh_row4 < need4(degree) || width < 1 || height < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdKernel kernel = degree == 0 ? &preprocess_bwd_kernel<0> : degree == 1 ? &preprocess_bwd_kernel<1>
                           : degree == 2 ? &preprocess_bwd_kernel<2> : &preprocess_bwd_kernel<3>;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(scales), static_cast<const float4*>(quats),
      static_cast<const float4*>(sh), sh_row4, static_cast<const float*>(w2c_t),
      static_cast<const float*>(full_proj_t), static_cast<const float*>(cam_center),
      static_cast<const float*>(tan_fov), static_cast<const float*>(focal), n, width, height,
      static_cast<const float*>(v_means2d), v_means2d_row, static_cast<const float*>(v_conics), v_conics_row,
      static_cast<const float*>(v_rgb), v_rgb_row, static_cast<float*>(g_means), static_cast<float*>(g_scales),
      static_cast<float4*>(g_quats), static_cast<float4*>(g_sh));
  return (int)cudaGetLastError();
}
