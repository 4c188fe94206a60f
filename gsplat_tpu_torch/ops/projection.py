"""Per-gaussian preprocessing: projection, EWA splatting, conics, bboxes.

The vectorized-over-N half of the renderer: plain elementwise PyTorch on
flat ``[N]`` columns (struct of arrays), no kernel needed.

Parity targets (reference file:line):
  * 3D covariance from scales/quats: rasterize.py:89-120.
  * camera-space projection:          rasterize.py:80-86.
  * clip/NDC/screen projection:       rasterize.py:374-391.
  * frustum culling at z < 0.2:       rasterize.py:377-378, 388.
  * EWA 2D covariance:                rasterize.py:201-252.
  * conic ("sigma"):                  rasterize.py:395-411.
  * covering bbox:                    rasterize.py:154-198, 413-420.

The integer bboxes come from float ``floor``/``ceil`` and clamps, so every
float step keeps the JAX package's operation order: one ulp of difference
can flip an integer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch.config import (
    BLOCK_SIZE,
    COV2D_LOWPASS,
    EIGENVALUE_FLOOR,
    EWA_TAN_CLAMP,
    FRUSTUM_NEAR_Z,
    GAUSSIAN_SPREAD,
    PERSPECTIVE_EPS,
)
from gsplat_tpu_torch.ops.quaternion import normalize_quaternion, quaternion_to_rotation_matrix


def covariance_from_scales_quats(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """3D covariance ``Cov = (R S)(R S)^T`` per gaussian, ``[N, 3, 3]``, from
    activated scales ``[N, 3]`` and raw quaternions ``[N, 4]``."""
    rot = quaternion_to_rotation_matrix(normalize_quaternion(quats))
    m = rot * scales[:, None, :]
    return m @ m.transpose(-1, -2)


class Preprocessed(NamedTuple):
    """Everything the binner + rasterizer need, all ``[N, ...]``."""

    screen_means: torch.Tensor  # [N, 2] pixel-space centers
    conics: torch.Tensor  # [N, 3] inverse 2D covariance (sx, sy, sxy)
    rgb: torch.Tensor  # [N, 3] view-dependent color
    opacity: torch.Tensor  # [N] activated opacity
    depth: torch.Tensor  # [N] camera-space z (sort key)
    bbox: torch.Tensor  # [N, 4] int32 pixel bbox, half-open (reference-exact;
    #   the rasterizer's containment test uses THIS rect)
    cull_bbox: torch.Tensor  # [N, 4] int32 rect for tile binning only: bbox
    #   intersected with the opacity-aware alpha-bound rect
    active: torch.Tensor  # [N] bool: participates in rasterization


def _alpha_cull_bbox(mean_px, mean_py, cov_a, cov_c, opacity, bbox, width: int, height: int):
    """Tile-cull rect. A pixel is composited only when
    ``opacity * exp(density) > 1/255`` (rasterize.py:291); minimizing the
    quadratic form over one axis bounds ``|dx| <= sqrt(2*Sigma_xx*ln(255*opac))``
    (same for y). Intersecting the reference bbox with that rect, plus a 1px
    guard for f32 rounding at the gate, only removes (gaussian, tile) pairs
    whose every pixel contributes exactly zero."""
    log_gate = torch.log(opacity.clamp(min=1e-30) * 255.0)
    live = log_gate > 0.0  # opac <= 1/255 never passes the gate at all
    gate = log_gate.clamp(min=0.0)
    rx = torch.sqrt(2.0 * cov_a.clamp(min=0.0) * gate) + 1.0
    ry = torch.sqrt(2.0 * cov_c.clamp(min=0.0) * gate) + 1.0

    # Clamp to the screen before the int cast: a huge/inf radius would
    # saturate the cast and the +1 would wrap negative.
    def lo(v):
        return v.clamp(-1.0, float(width + height)).to(torch.int32)

    cx_min = torch.maximum(bbox[:, 0], lo(torch.ceil(mean_px - rx)))
    cy_min = torch.maximum(bbox[:, 1], lo(torch.ceil(mean_py - ry)))
    cx_max = torch.minimum(bbox[:, 2], lo(torch.floor(mean_px + rx)) + 1)
    cy_max = torch.minimum(bbox[:, 3], lo(torch.floor(mean_py + ry)) + 1)
    cx_max = torch.where(live, cx_max, cx_min)  # empty rect => zero tiles
    cy_max = torch.where(live, cy_max, cy_min)
    return torch.stack([cx_min, cy_min, cx_max, cy_max], dim=-1)


def preprocess_gaussians_from_params(
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacity: torch.Tensor,
    rgb: torch.Tensor,
    w2c_t: torch.Tensor,
    full_proj_t: torch.Tensor,
    tan_fov_x,
    tan_fov_y,
    focal_x,
    focal_y,
    width: int,
    height: int,
    strict_parity: bool = True,
    screen_offset: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """Struct-of-arrays preprocess straight from activated parameters
    (reference rasterize.py:370-425). The 3x3 algebra is unrolled into
    ``[N]`` column arithmetic.

    ``screen_offset`` ([N, 2], normally absent) is added to the pixel-space
    means; the densifying trainer differentiates with respect to it.
    """
    x, y, z = means[:, 0], means[:, 1], means[:, 2]
    sx, sy, sz = scales[:, 0], scales[:, 1], scales[:, 2]

    # -- rotation from normalized quaternions (norm clamped at 1e-12) --
    qw, qx, qy, qz = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    inv_n = 1.0 / torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz).clamp(min=1e-12)
    qw, qx, qy, qz = qw * inv_n, qx * inv_n, qy * inv_n, qz * inv_n
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qz * qw)
    r02 = 2 * (qx * qz + qy * qw)
    r10 = 2 * (qx * qy + qz * qw)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qx * qw)
    r20 = 2 * (qx * qz - qy * qw)
    r21 = 2 * (qy * qz + qx * qw)
    r22 = 1 - 2 * (qx * qx + qy * qy)

    # -- 3D covariance: m_aj = r_aj * s_j, c_ab = sum_j m_aj * m_bj --
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22

    # -- camera space + depth (row-vector convention) --
    cam_x = x * w2c_t[0, 0] + y * w2c_t[1, 0] + z * w2c_t[2, 0] + w2c_t[3, 0]
    cam_y = x * w2c_t[0, 1] + y * w2c_t[1, 1] + z * w2c_t[2, 1] + w2c_t[3, 1]
    depth = x * w2c_t[0, 2] + y * w2c_t[1, 2] + z * w2c_t[2, 2] + w2c_t[3, 2]
    culled = depth < FRUSTUM_NEAR_Z

    # -- clip/NDC/pixel projection --
    def proj_col(j):
        return x * full_proj_t[0, j] + y * full_proj_t[1, j] + z * full_proj_t[2, j] + full_proj_t[3, j]

    zero = torch.zeros_like(x)
    clip_x = torch.where(culled, zero, proj_col(0))
    clip_y = torch.where(culled, zero, proj_col(1))
    clip_w = torch.where(culled, zero, proj_col(3))
    inv_w = 1.0 / (clip_w + PERSPECTIVE_EPS)
    mean_px = ((clip_x * inv_w + 1.0) * width - 1.0) / 2.0
    mean_py = ((clip_y * inv_w + 1.0) * height - 1.0) / 2.0
    if screen_offset is not None:
        mean_px = mean_px + screen_offset[:, 0]
        mean_py = mean_py + screen_offset[:, 1]

    # -- EWA projection: T = J W with W[k, j] = w2c_t[j, k] --
    fx = focal_x / 2.0
    fy = focal_y / 2.0
    lim_x = EWA_TAN_CLAMP * tan_fov_x
    lim_y = EWA_TAN_CLAMP * tan_fov_y
    inv_z = 1.0 / depth
    tx_c = torch.clamp(cam_x * inv_z, -lim_x, lim_x) * depth
    ty_c = torch.clamp(cam_y * inv_z, -lim_y, lim_y) * depth
    j00 = fx * inv_z
    j02 = -fx * tx_c * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty_c * inv_z * inv_z
    t00 = j00 * w2c_t[0, 0] + j02 * w2c_t[0, 2]
    t01 = j00 * w2c_t[1, 0] + j02 * w2c_t[1, 2]
    t02 = j00 * w2c_t[2, 0] + j02 * w2c_t[2, 2]
    t10 = j11 * w2c_t[0, 1] + j12 * w2c_t[0, 2]
    t11 = j11 * w2c_t[1, 1] + j12 * w2c_t[1, 2]
    t12 = j11 * w2c_t[2, 1] + j12 * w2c_t[2, 2]
    u00 = t00 * c00 + t01 * c01 + t02 * c02
    u01 = t00 * c01 + t01 * c11 + t02 * c12
    u02 = t00 * c02 + t01 * c12 + t02 * c22
    u10 = t10 * c00 + t11 * c01 + t12 * c02
    u11 = t10 * c01 + t11 * c11 + t12 * c12
    u12 = t10 * c02 + t11 * c12 + t12 * c22
    cov_a = u00 * t00 + u01 * t01 + u02 * t02 + COV2D_LOWPASS
    cov_b = u00 * t10 + u01 * t11 + u02 * t12
    cov_c = u10 * t10 + u11 * t11 + u12 * t12 + COV2D_LOWPASS
    # Culled gaussians get a zero covariance (rasterize.py:388) -> det == 0
    # -> zero conic -> skipped by the raster loop.
    cov_a = torch.where(culled, zero, cov_a)
    cov_b = torch.where(culled, zero, cov_b)
    cov_c = torch.where(culled, zero, cov_c)

    # -- conic --
    det = cov_a * cov_c - cov_b * cov_b
    det_inv = torch.where(det == 0.0, zero, 1.0 / det)
    conic_x = cov_c * det_inv
    conic_y = cov_a * det_inv
    conic_xy = -cov_b * det_inv

    # -- covering bbox: block-unit rounding, then pixels (two-step) --
    trace = cov_a + cov_c
    disc = (trace * trace / 4.0 - det).clamp(min=EIGENVALUE_FLOOR)
    sq = torch.sqrt(disc)
    max_spread = torch.ceil(
        GAUSSIAN_SPREAD * torch.sqrt(torch.maximum(trace / 2.0 + sq, trace / 2.0 - sq))
    )
    bs = float(BLOCK_SIZE)

    def to_px(v, limit):
        blocks = torch.floor(v.clamp(0, limit - 1)).to(torch.int32)
        return (blocks * BLOCK_SIZE).clamp(0, limit - 1)

    x_min = to_px((mean_px - max_spread) / bs, width)
    y_min = to_px((mean_py - max_spread) / bs, height)
    x_max = to_px((mean_px + max_spread + bs - 1) / bs, width)
    y_max = to_px((mean_py + max_spread + bs - 1) / bs, height)

    area = (x_max - x_min) * (y_max - y_min)
    if strict_parity:
        conic_ok = (conic_x != 0.0) & (conic_y != 0.0) & (conic_xy != 0.0)
    else:
        conic_ok = (conic_x != 0.0) | (conic_y != 0.0) | (conic_xy != 0.0)
    active = (area > 0) & conic_ok

    bbox = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    return Preprocessed(
        screen_means=torch.stack([mean_px, mean_py], dim=-1),
        conics=torch.stack([conic_x, conic_y, conic_xy], dim=-1),
        rgb=rgb,
        opacity=opacity,
        depth=depth,
        bbox=bbox,
        cull_bbox=_alpha_cull_bbox(mean_px, mean_py, cov_a, cov_c, opacity, bbox, width, height),
        active=active,
    )
