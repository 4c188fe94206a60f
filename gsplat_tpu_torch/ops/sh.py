"""Spherical-harmonics -> RGB evaluation (degrees 0-3).

Parity target: reference ``spherical_harmonics.py:27-73``: view direction is
``normalize(mean - cam_center)``, hardcoded real cartesian SH bases in the
band-major Inria layout, a +0.5 offset and a clamp to [0, 1]. Color is
evaluated once per gaussian per view (rasterize.py:368).
"""

from __future__ import annotations

import torch

# Real SH constants (spherical_harmonics.py:4-24).
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis at unit directions ``[N, 3]`` -> ``[N, (degree+1)**2]``
    (band-major: [dc, deg1 x3, deg2 x5, deg3 x7])."""
    cols = [torch.full_like(dirs[:, 0], SH_C0)]
    if degree > 0:
        x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            cols += [
                SH_C2[0] * xy,
                SH_C2[1] * yz,
                SH_C2[2] * (2.0 * zz - xx - yy),
                SH_C2[3] * xz,
                SH_C2[4] * (xx - yy),
            ]
            if degree > 2:
                cols += [
                    SH_C3[0] * y * (3.0 * xx - yy),
                    SH_C3[1] * xy * z,
                    SH_C3[2] * y * (4.0 * zz - xx - yy),
                    SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                    SH_C3[4] * x * (4.0 * zz - xx - yy),
                    SH_C3[5] * z * (xx - yy),
                    SH_C3[6] * x * (xx - 3.0 * yy),
                ]
    return torch.stack(cols, dim=-1)


def sh_to_rgb(
    means: torch.Tensor,
    sh_coeffs: torch.Tensor,
    cam_center: torch.Tensor,
    degree: int = 3,
    clamp: bool = True,
) -> torch.Tensor:
    """View-dependent color ``[N, 3]`` of each gaussian.

    Args:
      means: ``[N, 3]`` world-space centers.
      sh_coeffs: ``[N, 16, 3]`` SH coefficients (Inria layout).
      cam_center: ``[3]`` world-space camera position.
      degree: SH degree in [0, 3].
      clamp: clamp to [0, 1] after the +0.5 offset, as the reference does.
    """
    if not 0 <= degree <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got {degree}")
    dirs = means - cam_center[None, :]
    # A gaussian at the camera centre (a pool's dead rows at the origin, seen
    # from a camera there) keeps a zero direction rather than 0/0: it is
    # culled, and a NaN here would reach its gradient.
    norm = torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    dirs = dirs / torch.where(norm > 0, norm, torch.ones_like(norm))
    basis = sh_basis(dirs, degree)  # [N, B]
    nb = basis.shape[-1]
    colors = torch.einsum("nb,nbc->nc", basis, sh_coeffs[:, :nb, :]) + 0.5
    if clamp:
        # minimum/maximum rather than clamp: at a colour exactly 0 or 1 (a
        # point of SfM colour 0 or 255 in from_points3d) they pass half the
        # gradient, as jnp.clip does; torch.clamp passes all of it.
        colors = torch.minimum(torch.maximum(colors, colors.new_zeros(())), colors.new_ones(()))
    return colors
