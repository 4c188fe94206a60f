// Per-gaussian preprocess forward for Hopper (sm_90a), bound to Python
// through a plain C entry point (ctypes; see gsplat_tpu_torch/kernels/build.py).
//
// Replaces no TPU kernel: the JAX package leaves this elementwise work to
// XLA, which fuses it. The port's eager version (ops/sh.py sh_to_rgb, then
// ops/projection.py preprocess_gaussians_from_params) is some 480 PyTorch
// launches over [N] columns, each of which writes its result to device
// memory, and stacks of columns into [N, k] rows. This kernel does the same
// work in one launch, for a preprocess that takes no gradient
// (kernels/preprocess.py). One thread a gaussian computes:
//   * the SH colour (degree 0-3), +0.5 and the clamp to [0, 1];
//   * the normalised quaternion's rotation and the 3D covariance;
//   * camera space and depth, the clip/NDC/pixel projection, the near cull;
//   * the EWA 2D covariance with the tan clamp and the low-pass, the conic;
//   * the two-step block/pixel bbox, the alpha-bound cull rect, `active`.
//
// What bounds it: bytes. A gaussian reads means 12 B, activated scales 12 B,
// quats 16 B, activated opacity 4 B and, at SH degree 3, 192 B of
// coefficients (236 B), and writes screen means 8 B, conic 12 B, rgb 12 B,
// depth 4 B, bbox 16 B, cull bbox 16 B and active 1 B (69 B). That is 305 B,
// so 1.525 GB at 5M gaussians and 0.455 ms at 3.35 TB/s. The arithmetic
// (about 300 FP32 operations, a few IEEE divisions and square roots and one
// logf a gaussian) needs far less than that time.
//
// What the design does about it: each byte is read once and written once,
// and no intermediate leaves the registers. SH is 63% of what is read, and
// a thread reading its own 192 B row at a 192 B stride would not coalesce.
// So each block first copies its contiguous slab of rows (kThreads rows,
// only the coefficients its degree reads) into shared memory with float4
// loads, neighbouring threads on neighbouring addresses, all of a thread's
// loads in flight at once. Rows are stored at an odd stride of words, so
// that the 32 threads of a warp, each reading its own row, meet 32 banks
// (at the row's 48 words they would meet 2, a 16-way conflict). The camera
// is read from device memory once a block: no host sync reads it.
//
// Bitwise parity with the eager path. The integer bboxes come from floor,
// ceil and clamps of floats, so one ulp can flip one; and the set-up's pair
// capacity probe takes this kernel while training takes the eager path.
// So every float step keeps the eager code's order and rounding: round-to-
// nearest intrinsics (never an FMA contraction, which nvcc's default
// -fmad=true would make), IEEE division, reciprocal and square root, logf,
// NaN passed through as torch.clamp and torch.maximum pass it, and each
// Python constant rounded from double to float as PyTorch rounds a scalar.
// A division by a power-of-two Python number is a multiplication by its
// reciprocal, as PyTorch computes it; both are exact. `1.0 / x` is
// PyTorch's reciprocal, correctly rounded. Only the colour differs from the
// eager path, by the order of its sums: the eager path takes the view
// direction's norm and the dot product with the coefficients through
// library reductions.

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
constexpr int kBlockSize = 16;        // BLOCK_SIZE

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

// The SH colour of one gaussian from its staged row (ops/sh.py sh_to_rgb):
// the basis at the unit view direction (ops/sh.py's SH_C0 ... SH_C3), its
// dot product with each channel's coefficients, +0.5 and the clamp to
// [0, 1].
template <int kDegree>
__device__ __forceinline__ float3 sh_colour(const float* row, float mx, float my, float mz, const float* center) {
  constexpr int kBasis = (kDegree + 1) * (kDegree + 1);
  float basis[kBasis];
  basis[0] = c(0.28209479177387814);
  if constexpr (kDegree > 0) {
    const float dx = sub(mx, center[0]), dy = sub(my, center[1]), dz = sub(mz, center[2]);
    const float norm = root(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)));
    const float x = div(dx, norm), y = div(dy, norm), z = div(dz, norm);
    basis[1] = mul(c(-0.4886025119029199), y);
    basis[2] = mul(c(0.4886025119029199), z);
    basis[3] = mul(c(-0.4886025119029199), x);
    if constexpr (kDegree > 1) {
      const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
      const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
      basis[4] = mul(c(1.0925484305920792), xy);
      basis[5] = mul(c(-1.0925484305920792), yz);
      basis[6] = mul(c(0.31539156525252005), sub(sub(mul(2.0f, zz), xx), yy));
      basis[7] = mul(c(-1.0925484305920792), xz);
      basis[8] = mul(c(0.5462742152960396), sub(xx, yy));
      if constexpr (kDegree > 2) {
        basis[9] = mul(mul(c(-0.5900435899266435), y), sub(mul(3.0f, xx), yy));
        basis[10] = mul(mul(c(2.890611442640554), xy), z);
        basis[11] = mul(mul(c(-0.4570457994644658), y), sub(sub(mul(4.0f, zz), xx), yy));
        basis[12] = mul(mul(c(0.3731763325901154), z), sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
        basis[13] = mul(mul(c(-0.4570457994644658), x), sub(sub(mul(4.0f, zz), xx), yy));
        basis[14] = mul(mul(c(1.445305721320277), z), sub(xx, yy));
        basis[15] = mul(mul(c(-0.5900435899266435), x), sub(xx, mul(3.0f, yy)));
      }
    }
  }
  float out[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float s = mul(basis[0], row[ch]);
#pragma unroll
    for (int b = 1; b < kBasis; ++b) s = add(s, mul(basis[b], row[3 * b + ch]));
    out[ch] = minimum(maximum(add(s, 0.5f), 0.0f), 1.0f);
  }
  return make_float3(out[0], out[1], out[2]);
}

// What the preprocess writes of one gaussian for one camera, but the colour.
struct Projected {
  float mean_px, mean_py, conic_x, conic_y, conic_xy, depth;
  int4 bbox, cull_bbox;
  bool active;
};

// One gaussian's projection (ops/projection.py
// preprocess_gaussians_from_params for one row) from its mean, activated
// scales (sx, sy, sz), raw quaternion q = (w, x, y, z) and activated
// opacity. `cam` holds w2c_t [16], full_proj_t [16], cam_center [3],
// tan_fov [2] and focal [2], row-major.
template <bool kStrict>
__device__ __forceinline__ Projected project(float x, float y, float z, float sx, float sy, float sz, float4 q,
                                             float opacity, const float* cam, int width, int height) {
  const float* W = cam;       // W[4 * i + j] = w2c_t[i, j]
  const float* P = cam + 16;  // P[4 * i + j] = full_proj_t[i, j]

  // -- rotation from the normalised quaternion (norm clamped at 1e-12) --
  const float inv_n = rcp(clamp_min(root(add(add(add(mul(q.x, q.x), mul(q.y, q.y)), mul(q.z, q.z)), mul(q.w, q.w))),
                                    c(1e-12)));
  const float qw = mul(q.x, inv_n), qx = mul(q.y, inv_n), qy = mul(q.z, inv_n), qz = mul(q.w, inv_n);
  const float r00 = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  const float r01 = mul(2.0f, sub(mul(qx, qy), mul(qz, qw)));
  const float r02 = mul(2.0f, add(mul(qx, qz), mul(qy, qw)));
  const float r10 = mul(2.0f, add(mul(qx, qy), mul(qz, qw)));
  const float r11 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  const float r12 = mul(2.0f, sub(mul(qy, qz), mul(qx, qw)));
  const float r20 = mul(2.0f, sub(mul(qx, qz), mul(qy, qw)));
  const float r21 = mul(2.0f, add(mul(qy, qz), mul(qx, qw)));
  const float r22 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));

  // -- 3D covariance: m_aj = r_aj * s_j, c_ab = sum_j m_aj * m_bj --
  const float m00 = mul(r00, sx), m01 = mul(r01, sy), m02 = mul(r02, sz);
  const float m10 = mul(r10, sx), m11 = mul(r11, sy), m12 = mul(r12, sz);
  const float m20 = mul(r20, sx), m21 = mul(r21, sy), m22 = mul(r22, sz);
  const float c00 = add(add(mul(m00, m00), mul(m01, m01)), mul(m02, m02));
  const float c01 = add(add(mul(m00, m10), mul(m01, m11)), mul(m02, m12));
  const float c02 = add(add(mul(m00, m20), mul(m01, m21)), mul(m02, m22));
  const float c11 = add(add(mul(m10, m10), mul(m11, m11)), mul(m12, m12));
  const float c12 = add(add(mul(m10, m20), mul(m11, m21)), mul(m12, m22));
  const float c22 = add(add(mul(m20, m20), mul(m21, m21)), mul(m22, m22));

  // -- camera space and depth (row-vector convention) --
  auto row_vec = [&](const float* M, int j) {
    return add(add(add(mul(x, M[j]), mul(y, M[4 + j])), mul(z, M[8 + j])), M[12 + j]);
  };
  const float cam_x = row_vec(W, 0), cam_y = row_vec(W, 1), depth = row_vec(W, 2);
  const bool culled = depth < c(kNearZ);

  // -- clip/NDC/pixel projection --
  const float clip_x = culled ? 0.0f : row_vec(P, 0);
  const float clip_y = culled ? 0.0f : row_vec(P, 1);
  const float clip_w = culled ? 0.0f : row_vec(P, 3);
  const float inv_w = rcp(add(clip_w, c(kPerspEps)));
  const float mean_px = mul(sub(mul(add(mul(clip_x, inv_w), 1.0f), (float)width), 1.0f), 0.5f);
  const float mean_py = mul(sub(mul(add(mul(clip_y, inv_w), 1.0f), (float)height), 1.0f), 0.5f);

  // -- EWA projection: T = J W with W[k, j] = w2c_t[j, k] --
  const float fx = mul(cam[37], 0.5f), fy = mul(cam[38], 0.5f);
  const float lim_x = mul(c(kTanClamp), cam[35]), lim_y = mul(c(kTanClamp), cam[36]);
  const float inv_z = rcp(depth);
  const float tx_c = mul(clamp(mul(cam_x, inv_z), -lim_x, lim_x), depth);
  const float ty_c = mul(clamp(mul(cam_y, inv_z), -lim_y, lim_y), depth);
  const float j00 = mul(fx, inv_z);
  const float j02 = mul(mul(mul(-fx, tx_c), inv_z), inv_z);
  const float j11 = mul(fy, inv_z);
  const float j12 = mul(mul(mul(-fy, ty_c), inv_z), inv_z);
  const float t00 = add(mul(j00, W[0]), mul(j02, W[2]));
  const float t01 = add(mul(j00, W[4]), mul(j02, W[6]));
  const float t02 = add(mul(j00, W[8]), mul(j02, W[10]));
  const float t10 = add(mul(j11, W[1]), mul(j12, W[2]));
  const float t11 = add(mul(j11, W[5]), mul(j12, W[6]));
  const float t12 = add(mul(j11, W[9]), mul(j12, W[10]));
  const float u00 = add(add(mul(t00, c00), mul(t01, c01)), mul(t02, c02));
  const float u01 = add(add(mul(t00, c01), mul(t01, c11)), mul(t02, c12));
  const float u02 = add(add(mul(t00, c02), mul(t01, c12)), mul(t02, c22));
  const float u10 = add(add(mul(t10, c00), mul(t11, c01)), mul(t12, c02));
  const float u11 = add(add(mul(t10, c01), mul(t11, c11)), mul(t12, c12));
  const float u12 = add(add(mul(t10, c02), mul(t11, c12)), mul(t12, c22));
  // Culled gaussians get a zero covariance -> det == 0 -> zero conic.
  const float cov_a = culled ? 0.0f : add(add(add(mul(u00, t00), mul(u01, t01)), mul(u02, t02)), c(kLowpass));
  const float cov_b = culled ? 0.0f : add(add(mul(u00, t10), mul(u01, t11)), mul(u02, t12));
  const float cov_c = culled ? 0.0f : add(add(add(mul(u10, t10), mul(u11, t11)), mul(u12, t12)), c(kLowpass));

  // -- conic --
  const float det = sub(mul(cov_a, cov_c), mul(cov_b, cov_b));
  const float det_inv = det == 0.0f ? 0.0f : rcp(det);
  const float conic_x = mul(cov_c, det_inv), conic_y = mul(cov_a, det_inv), conic_xy = mul(-cov_b, det_inv);

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

  return {mean_px, mean_py, conic_x, conic_y, conic_xy, depth, make_int4(x_min, y_min, x_max, y_max),
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
    int n, int width, int height,
    float2* __restrict__ screen_means,      // [N, 2]
    float* __restrict__ conics,             // [N, 3]
    float* __restrict__ rgb,                // [N, 3]
    float* __restrict__ depth_out,          // [N]
    int4* __restrict__ bbox,                // [N, 4]
    int4* __restrict__ cull_bbox,           // [N, 4]
    bool* __restrict__ active) {            // [N]
  constexpr int kBasis = (kDegree + 1) * (kDegree + 1);
  constexpr int kNeed4 = (kBasis * 3 + 3) / 4;  // float4s of a row this degree reads
  constexpr int kStride = kNeed4 * 4 + 1;       // odd: a warp's row reads meet 32 banks
  __shared__ float stage[kThreads * kStride];
  __shared__ float cam[39];  // w2c_t 16, full_proj_t 16, cam_center 3, tan_fov 2, focal 2

  const int t = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * kThreads;
  const long long left = (long long)n - g0;
  const int rows = left < kThreads ? (int)left : kThreads;
  if (t < 16) cam[t] = w2c_t[t];
  else if (t < 32) cam[t] = full_proj_t[t - 16];
  else if (t < 35) cam[t] = cam_center[t - 32];
  else if (t < 37) cam[t] = tan_fov[t - 35];
  else if (t < 39) cam[t] = focal[t - 37];

  // The block's SH slab: every load issued before any store.
  const float4* slab = sh + g0 * sh_row4;
  float4 v[kNeed4];
#pragma unroll
  for (int k = 0; k < kNeed4; ++k) {
    const int i = t + k * kThreads, r = i / kNeed4;
    if (r < rows) v[k] = __ldcs(slab + (long long)r * sh_row4 + (i - r * kNeed4));
  }
#pragma unroll
  for (int k = 0; k < kNeed4; ++k) {
    const int i = t + k * kThreads, r = i / kNeed4;
    if (r < rows) {
      float* d = stage + r * kStride + 4 * (i - r * kNeed4);
      d[0] = v[k].x;
      d[1] = v[k].y;
      d[2] = v[k].z;
      d[3] = v[k].w;
    }
  }
  __syncthreads();
  if (t >= rows) return;
  const long long g = g0 + t;

  const float x = means[3 * g], y = means[3 * g + 1], z = means[3 * g + 2];
  const float3 colour = sh_colour<kDegree>(stage + t * kStride, x, y, z, cam + 32);

  const Projected p = project<kStrict>(x, y, z, scales[3 * g], scales[3 * g + 1], scales[3 * g + 2], quats[g],
                                       opacity[g], cam, width, height);
  screen_means[g] = make_float2(p.mean_px, p.mean_py);
  conics[3 * g] = p.conic_x;
  conics[3 * g + 1] = p.conic_y;
  conics[3 * g + 2] = p.conic_xy;
  rgb[3 * g] = colour.x;
  rgb[3 * g + 1] = colour.y;
  rgb[3 * g + 2] = colour.z;
  depth_out[g] = p.depth;
  bbox[g] = p.bbox;
  cull_bbox[g] = p.cull_bbox;
  active[g] = p.active;
}

using Kernel = decltype(&preprocess_kernel<3, true>);

template <int kDegree>
Kernel pick(bool strict) {
  return strict ? &preprocess_kernel<kDegree, true> : &preprocess_kernel<kDegree, false>;
}

// float4s of an SH row that degree `degree` reads.
int need4(int degree) { return ((degree + 1) * (degree + 1) * 3 + 3) / 4; }

}  // namespace

// Launches ceil(n / 128) blocks of 128 threads on `stream`; allocates
// nothing and does not synchronise. `sh` holds rows of sh_row4 float4s (the
// [N, K, 3] coefficients with 3K a multiple of 4, 16-byte aligned, as
// `quats`); a degree outside 0..3 or rows too short for it:
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch.
extern "C" int gsplat_preprocess(
    const void* means, const void* scales, const void* quats, const void* opacity, const void* sh, int sh_row4,
    const void* w2c_t, const void* full_proj_t, const void* cam_center, const void* tan_fov, const void* focal,
    int n, int width, int height, int degree, int strict_parity, void* screen_means, void* conics, void* rgb,
    void* depth, void* bbox, void* cull_bbox, void* active, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || degree < 0 || degree > 3 || sh_row4 < need4(degree) || width < 1 || height < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const bool strict = strict_parity != 0;
  const Kernel kernel = degree == 0 ? pick<0>(strict) : degree == 1 ? pick<1>(strict)
                        : degree == 2 ? pick<2>(strict) : pick<3>(strict);
  const unsigned blocks = (unsigned)(((long long)n + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(scales), static_cast<const float4*>(quats),
      static_cast<const float*>(opacity), static_cast<const float4*>(sh), sh_row4,
      static_cast<const float*>(w2c_t), static_cast<const float*>(full_proj_t),
      static_cast<const float*>(cam_center), static_cast<const float*>(tan_fov), static_cast<const float*>(focal),
      n, width, height, static_cast<float2*>(screen_means), static_cast<float*>(conics), static_cast<float*>(rgb),
      static_cast<float*>(depth), static_cast<int4*>(bbox), static_cast<int4*>(cull_bbox),
      static_cast<bool*>(active));
  return (int)cudaGetLastError();
}
