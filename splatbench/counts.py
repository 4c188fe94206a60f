"""The frozen count arithmetic: the work a view or a training step needs,
in FP32 operations and bytes, and the published H100 peaks it is held to.

The counts are of the work itself, not of any implementation: per gaussian
for the preprocess, per pixel entry for the compositors (from the
benchmark's own projection, ``reference/render.py``: the entries inside
each gaussian's box up to each pixel's early stop, and those whose alpha
passes the gate), per pixel for the loss. A later change to how the
program bins, culls or fuses moves its time and leaves these counts as they
are. A transcendental or a division counts as one operation; a clamp,
floor or ceil as one.

Peaks: NVIDIA's H100 SXM data sheet (dense, at the full 700 W limit): FP32
outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s; the special-function
units give 16 results per clock per SM (CUDA programming guide, compute
capability 9.0) at the 1.98 GHz boost clock on 132 SMs. A card set below
700 W runs slower under load; the run prints its ``power.limit`` beside
these peaks.
"""

from __future__ import annotations

PEAK_FP32_OPS = 67e12  # operations/s
PEAK_SFU = 132 * 16 * 1.98e9  # results/s
PEAK_HBM_BYTES = 3.35e12  # bytes/s

# --- Compositors, per pixel entry (copied from chip_smoke.py's bound) ---
# Every entry inside a gaussian's box needs its gate: d = mean - pixel (2),
# the quadratic form and density (9), raw = opacity * exp and the 0.99
# clamp (2), the box test (4), the alpha and density tests (2): 19, and one
# exp on the special-function units. Only where the gate passes is there
# more: the forward's compositing (w = alpha * T, three colour multiply-adds,
# T *= 1 - alpha: 9); the backward's walk (w, the colour behind, 1 - alpha,
# d alpha, the clamp, d density, T: 14, and one division), its nine
# per-entry gradient terms (20) and their sums (9): 43.
GATE_OPS = 19
FWD_PASSED_OPS = 9
BWD_PASSED_OPS = 43

# --- Preprocess, per gaussian (reference/render.py ``project`` and
# ``sh_color``) ---
# quaternion normalised 13; rotation matrix 39; exp of 3 scales and R S 12;
# covariance M M^T (6 entries x 5) 30; camera space 18; perspective and
# pixel coordinates 13; EWA: 1/z and the clamped ray 10, J 8, J R 18,
# (J R) Cov 30, the 2x2 product 15, low-pass 2: 83; conic 8; box (extent,
# two roundings a side) 30; alpha-reach bound 24; sigmoid 3; SH degree 3:
# direction 12, basis 54, 48 multiply-adds 96, offset and clamp 9: 171.
PREPROCESS_OPS = 13 + 39 + 12 + 30 + 18 + 13 + 83 + 8 + 30 + 24 + 3 + 171
# Reverse mode: each forward multiply or add gives two in the backward.
PREPROCESS_BWD_OPS = 2 * PREPROCESS_OPS

# --- Loss, per pixel and channel ---
# SSIM: five blurs of an 11x11 separable window (2 x 11 multiply-adds =
# 44 each: 220), the three products it blurs (3), the means' products (3),
# the three variances (3), numerator and denominator (12), the division
# and the mean (2): 243. Its backward: the blurs of the three maps that
# depend on the frame (132), their elementwise derivatives (30): 162.
# L1: difference, absolute value, sum (3); backward: sign and scale (2).
SSIM_OPS = 243
SSIM_BWD_OPS = 162
L1_OPS = 3
L1_BWD_OPS = 2

# Bytes each compositor must move at least: every feature row it uses read
# once (16 floats), every pixel written once (colour and T: 4 floats); the
# backward also reads the frame's colour, T and gradient (7 floats a pixel)
# and writes nine gradients a gaussian.
FEATURE_BYTES = 64
FWD_PIXEL_BYTES = 16
BWD_PIXEL_BYTES = 28
BWD_GAUSSIAN_BYTES = FEATURE_BYTES + 36


def compositor_bound_s(in_box: int, passed: int, gaussians: int, pixels: int, backward: bool) -> float:
    """The least seconds a compositor needs for this work: the larger of its
    FP32 operations, its special-function results and its bytes, each over
    its peak."""
    fp32 = in_box * GATE_OPS + passed * (BWD_PASSED_OPS if backward else FWD_PASSED_OPS)
    sfu = in_box + (passed if backward else 0)
    nbytes = (gaussians * BWD_GAUSSIAN_BYTES + pixels * BWD_PIXEL_BYTES if backward
              else gaussians * FEATURE_BYTES + pixels * FWD_PIXEL_BYTES)
    return max(fp32 / PEAK_FP32_OPS, sfu / PEAK_SFU, nbytes / PEAK_HBM_BYTES)


def view_ops(n_gaussians: int, pixels: int, in_box: int, passed: int, train: bool) -> float:
    """FP32 operations of one request (``train`` False: preprocess and the
    forward compositor) or one training step (both ways, and the loss)."""
    ops = n_gaussians * PREPROCESS_OPS + in_box * GATE_OPS + passed * FWD_PASSED_OPS
    if train:
        ops += n_gaussians * PREPROCESS_BWD_OPS + in_box * GATE_OPS + passed * BWD_PASSED_OPS
        ops += 3 * pixels * (SSIM_OPS + SSIM_BWD_OPS + L1_OPS + L1_BWD_OPS)
    return float(ops)
