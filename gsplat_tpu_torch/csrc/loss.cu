// The training loss, (1 - w) * mean|p - t| + w * (1 - mean SSIM), and its
// gradient with respect to p, for Hopper (sm_90a), bound to Python through
// plain C entry points (ctypes; see gsplat_tpu_torch/kernels/build.py).
//
// Replaces no TPU kernel: the JAX package leaves the SSIM blurs to XLA's
// convolution. The port's eager version (kernels/loss.py loss_plain) runs
// ten cuDNN f32 convolutions, each an implicit GEMM over a [3, 1, H, W]
// depthwise 11x1 filter, and about 130 elementwise launches forward and
// backward. These two kernels do the same work in one launch each
// (kernels/loss.py wraps them in one autograd Function).
//
// SSIM of a pixel and channel is s = A1 B1 / (A2 B2) with
//   A1 = 2 mu_p mu_t + C1,           B1 = 2 s_pt + C2,
//   A2 = mu_p^2 + mu_t^2 + C1,       B2 = s_pp + s_tt + C2,
// where mu_p = blur(p), s_pp = blur(p^2) - mu_p^2, s_pt = blur(p t) - mu_p mu_t
// and so on, blur the 11x11 gaussian window (sigma 1.5) applied as two
// 11-tap passes with zero "same" padding. The target takes no gradient, so
// s depends on p through mu_p, blur(p^2) and blur(p t) alone, and
//   d mean(s) / dp = (blur(A) + 2 p blur(B) + t blur(C)) / N
// with three per-pixel maps (the blur is its own adjoint: a zero-padded
// correlation with a symmetric window)
//   B = ds/ds_pp = -s / B2,   C = ds/ds_pt = 2 A1 / (A2 B2),
//   A = ds/dmu_p - 2 mu_p B - mu_t C
//     = (2 mu_t (B1 - A1) + 2 mu_p s (A2 - B2)) / (A2 B2).
// The forward writes A, B and C as a [3, H, W, C] buffer, which the
// backward blurs and combines:
//   g = c [ ((1 - w) / N) sign(p - t) - (w / N) (blur(A) + 2 p blur(B) + t blur(C)) ]
// with c the loss's cotangent, read on the card (no host sync), and
// sign(0) = 0, as autograd's abs gives it.
//
// Layout: one block an output tile of kTileX x kTileY pixels, all three
// channels, one thread a pixel. The block stages its inputs with a kHalo-
// pixel border into shared memory, read straight from the interleaved
// [H, W, C] rows (neighbouring threads on neighbouring words), zero outside
// the frame: the zero padding. The horizontal pass writes the tile's
// columns for every staged row back to shared memory; the vertical pass
// runs in registers, a thread its own pixel. The forward stages p and t
// and blurs five quantities (p, t, p^2, t^2, p t); the backward stages the
// three maps and blurs them. Taps are the f32 window that kernels/loss.py
// computes (gaussian_window), passed by value, so kernel and plain version
// blur with the same numbers. All arithmetic is f32 (FMAs, IEEE division),
// but the last sum of the block partials: no TF32, no half precision.
//
// The sums: each thread adds its three channels' s and |p - t| in order,
// a warp adds its threads by an xor butterfly, the block's first thread its
// warps in order into the block's partials. The last block to finish (a
// ticket taken with an atomic after a fence) adds the partials in a fixed
// order in double and writes the loss and mean s. So the forward is one
// launch and bitwise the same from run to run; the ticket counter is reset
// by that block for the next launch on the stream.
//
// What bounds both: bytes. At 1920x1080x3 in f32 (24.9 MB a frame) the
// forward reads p and t and writes the three maps (124.4 MB), the backward
// reads the maps, p and t and writes the gradient (149.3 MB): 273.7 MB,
// 0.082 ms at 3.35 TB/s. The arithmetic, some 5 x 2 x 11 x 2 FLOP forward
// and 3 x 2 x 11 x 2 backward a value (2.2 GFLOP), is 0.033 ms at
// 67 TFLOP/s. Staging with a border reads each input (26 x 26) / (16 x 16)
// = 2.6 times, mostly from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 11;                         // the SSIM window's taps
constexpr int kHalo = kTaps / 2;                  // its reach either side
constexpr int kC = 3;                             // channels
constexpr int kTileX = 16, kTileY = 16;           // output pixels of a block
constexpr int kThreads = kTileX * kTileY;         // one a pixel
constexpr int kWarps = kThreads / 32;
constexpr int kSpanY = kTileY + 2 * kHalo;        // staged rows
constexpr int kRowIn = (kTileX + 2 * kHalo) * kC; // floats of a staged row
constexpr int kRowOut = kTileX * kC;              // floats of a row after the horizontal pass
constexpr int kIn = kSpanY * kRowIn;              // floats of a staged plane
constexpr int kOut = kSpanY * kRowOut;            // floats of a horizontally blurred plane

struct Taps {
  float w[kTaps];
};

// The kSpanY x kRowIn window of plane `src` ([H, W, C], row stride W C)
// around the tile at (x0, y0) into `dst`, zero outside the frame.
__device__ __forceinline__ void stage(const float* __restrict__ src, float* __restrict__ dst, int x0, int y0,
                                      int height, int width) {
  const int row = width * kC;
  const int e0 = (x0 - kHalo) * kC;
  for (int i = threadIdx.x; i < kIn; i += kThreads) {
    const int r = i / kRowIn;
    const int y = y0 - kHalo + r;
    const int e = e0 + (i - r * kRowIn);
    dst[i] = (y >= 0 && y < height && e >= 0 && e < row) ? src[static_cast<size_t>(y) * row + e] : 0.0f;
  }
}

// The sign autograd's abs backward multiplies by: 0 at 0, NaN passed.
__device__ __forceinline__ float sign(float d) { return d > 0.0f ? 1.0f : d < 0.0f ? -1.0f : d; }

__global__ void __launch_bounds__(kThreads) loss_fwd_kernel(
    const float* __restrict__ pred, const float* __restrict__ target, int height, int width, Taps taps, float c1,
    float c2, double ssim_weight, float* __restrict__ maps, float2* __restrict__ partials,
    unsigned int* __restrict__ ticket, float* __restrict__ out_loss, float* __restrict__ out_ssim) {
  __shared__ float sp[kIn], st[kIn];
  __shared__ float sh[5][kOut];  // blur along x of p, t, p^2, t^2, p t
  __shared__ float warp_sums[kWarps][2];
  __shared__ double block_sums[kWarps][2];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  stage(pred, sp, x0, y0, height, width);
  stage(target, st, x0, y0, height, width);
  __syncthreads();

  for (int i = tid; i < kOut; i += kThreads) {
    const int r = i / kRowOut;
    const float* a = sp + r * kRowIn + (i - r * kRowOut);
    const float* b = st + r * kRowIn + (i - r * kRowOut);
    float m_p = 0.0f, m_t = 0.0f, m_pp = 0.0f, m_tt = 0.0f, m_pt = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float p = a[k * kC], t = b[k * kC], w = taps.w[k];
      m_p = fmaf(w, p, m_p);
      m_t = fmaf(w, t, m_t);
      m_pp = fmaf(w, p * p, m_pp);
      m_tt = fmaf(w, t * t, m_tt);
      m_pt = fmaf(w, p * t, m_pt);
    }
    sh[0][i] = m_p;
    sh[1][i] = m_t;
    sh[2][i] = m_pp;
    sh[3][i] = m_tt;
    sh[4][i] = m_pt;
  }
  __syncthreads();

  const int tx = tid % kTileX, ty = tid / kTileX;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < width && y < height;
  const size_t plane = static_cast<size_t>(height) * width * kC;
  const size_t at = (static_cast<size_t>(y) * width + x) * kC;
  float sum_s = 0.0f, sum_l1 = 0.0f;
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int j = (ty + k) * kRowOut + tx * kC + ch;
#pragma unroll
      for (int q = 0; q < 5; ++q) v[q] = fmaf(taps.w[k], sh[q][j], v[q]);
    }
    if (inside) {
      const float mu_p = v[0], mu_t = v[1];
      const float mu_pp = mu_p * mu_p, mu_tt = mu_t * mu_t, mu_pt = mu_p * mu_t;
      const float a1 = 2.0f * mu_pt + c1, b1 = 2.0f * (v[4] - mu_pt) + c2;
      const float a2 = mu_pp + mu_tt + c1, b2 = (v[2] - mu_pp) + (v[3] - mu_tt) + c2;
      const float den = a2 * b2;
      const float s = (a1 * b1) / den;
      const int c = (ty + kHalo) * kRowIn + (tx + kHalo) * kC + ch;
      maps[at + ch] = (2.0f * mu_t * (b1 - a1) + 2.0f * mu_p * s * (a2 - b2)) / den;
      maps[plane + at + ch] = -s / b2;
      maps[2 * plane + at + ch] = (2.0f * a1) / den;
      sum_s += s;
      sum_l1 += fabsf(sp[c] - st[c]);
    }
  }

  // The block's sums in a fixed order: an xor butterfly leaves every lane
  // of a warp the same bits; the first thread adds the warps in order.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum_s += __shfl_xor_sync(0xffffffffu, sum_s, o);
    sum_l1 += __shfl_xor_sync(0xffffffffu, sum_l1, o);
  }
  if (tid % 32 == 0) {
    warp_sums[tid / 32][0] = sum_s;
    warp_sums[tid / 32][1] = sum_l1;
  }
  __syncthreads();
  const unsigned int blocks = gridDim.x * gridDim.y;
  if (tid == 0) {
    float s = 0.0f, l1 = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      s += warp_sums[w][0];
      l1 += warp_sums[w][1];
    }
    partials[blockIdx.y * gridDim.x + blockIdx.x] = make_float2(s, l1);
    __threadfence();
    last = atomicAdd(ticket, 1u) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block: every partial is written and fenced. Each thread adds
  // a strided set in double, then the block as above.
  __threadfence();
  double s = 0.0, l1 = 0.0;
  for (unsigned int i = tid; i < blocks; i += kThreads) {
    const float2 part = __ldcg(partials + i);
    s += part.x;
    l1 += part.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  if (tid % 32 == 0) {
    block_sums[tid / 32][0] = s;
    block_sums[tid / 32][1] = l1;
  }
  __syncthreads();
  if (tid == 0) {
    double total_s = 0.0, total_l1 = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      total_s += block_sums[w][0];
      total_l1 += block_sums[w][1];
    }
    const double n = static_cast<double>(height) * width * kC;
    const double mean_s = total_s / n;
    *out_ssim = static_cast<float>(mean_s);
    *out_loss = static_cast<float>((1.0 - ssim_weight) * (total_l1 / n) + ssim_weight * (1.0 - mean_s));
    *ticket = 0u;
  }
}

__global__ void __launch_bounds__(kThreads) loss_bwd_kernel(
    const float* __restrict__ pred, const float* __restrict__ target, const float* __restrict__ maps, int height,
    int width, Taps taps, const float* __restrict__ grad_out, float l1_coef, float ssim_coef,
    float* __restrict__ grad) {
  __shared__ float sm[3][kIn];
  __shared__ float sh[3][kOut];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const size_t plane = static_cast<size_t>(height) * width * kC;
#pragma unroll
  for (int m = 0; m < 3; ++m) stage(maps + m * plane, sm[m], x0, y0, height, width);
  __syncthreads();

  for (int i = tid; i < kOut; i += kThreads) {
    const int r = i / kRowOut;
    const int base = r * kRowIn + (i - r * kRowOut);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc = fmaf(taps.w[k], sm[m][base + k * kC], acc);
      sh[m][i] = acc;
    }
  }
  __syncthreads();

  const int tx = tid % kTileX, ty = tid / kTileX;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= width || y >= height) return;
  const float c = *grad_out;
  const size_t at = (static_cast<size_t>(y) * width + x) * kC;
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    float v[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int j = (ty + k) * kRowOut + tx * kC + ch;
#pragma unroll
      for (int m = 0; m < 3; ++m) v[m] = fmaf(taps.w[k], sh[m][j], v[m]);
    }
    const float p = pred[at + ch], t = target[at + ch];
    const float d_ssim = v[0] + 2.0f * p * v[1] + t * v[2];
    grad[at + ch] = c * (l1_coef * sign(p - t) - ssim_coef * d_ssim);
  }
}

Taps taps_from(const float* host) {
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.w[k] = host[k];
  return t;
}

dim3 grid_for(int height, int width) {
  return dim3((width + kTileX - 1) / kTileX, (height + kTileY - 1) / kTileY);
}

}  // namespace

// The loss of pred and target (float32 [height, width, 3], contiguous, on
// one device) at SSIM weight ssim_weight, into *out_loss, and mean SSIM into
// *out_ssim; the three maps into maps ([3, height, width, 3]). taps: the 11
// window taps in host memory. partials: one float2 a block,
// ceil(width / 16) * ceil(height / 16) of them; ticket: one unsigned int,
// 0 before the launch (the launch leaves it 0). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an empty frame.
extern "C" int gsplat_loss_forward(const float* pred, const float* target, int height, int width,
                                   const float* taps, float c1, float c2, double ssim_weight, float* maps,
                                   void* partials, unsigned int* ticket, float* out_loss, float* out_ssim,
                                   void* stream) {
  if (height < 1 || width < 1) return (int)cudaErrorInvalidValue;
  loss_fwd_kernel<<<grid_for(height, width), kThreads, 0, (cudaStream_t)stream>>>(
      pred, target, height, width, taps_from(taps), c1, c2, ssim_weight, maps, static_cast<float2*>(partials),
      ticket, out_loss, out_ssim);
  return (int)cudaGetLastError();
}

// The loss's gradient with respect to pred into grad ([height, width, 3]),
// from pred, target and the forward's maps, the cotangent *grad_out (a
// float on the device) and the coefficients (1 - w) / N and w / N.
extern "C" int gsplat_loss_backward(const float* pred, const float* target, const float* maps, int height,
                                    int width, const float* taps, const float* grad_out, float l1_coef,
                                    float ssim_coef, float* grad, void* stream) {
  if (height < 1 || width < 1) return (int)cudaErrorInvalidValue;
  loss_bwd_kernel<<<grid_for(height, width), kThreads, 0, (cudaStream_t)stream>>>(
      pred, target, maps, height, width, taps_from(taps), grad_out, l1_coef, ssim_coef, grad);
  return (int)cudaGetLastError();
}
