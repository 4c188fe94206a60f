"""Camera math: world->camera and perspective projection matrices.

Parity targets in the reference:
  * world->camera matrix: ``rasterize.py:59-77`` — COLMAP convention where
    ``X_cam = R @ X_world + t`` (tvec is already the world->cam translation,
    stored positive at [:3, 3] despite the docstring's ``-T``).
  * OpenGL-style perspective matrix: ``rasterize.py:123-151`` with
    Z_NEAR=0.01, Z_FAR=100, z_sign=+1 and the w=z row at P[3, 2].
  * FoV from COLMAP intrinsics: ``rasterize.py:342-343``.

Matrices are kept in the row-vector convention the reference uses for its
combined transform (``clip = p @ full_proj_t``). They are built on the host
in the requested dtype (qvec, tvec and fov are cast before any arithmetic,
and ``tan`` is taken in that dtype, as the JAX package does) and then moved
to the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.config import Z_FAR, Z_NEAR
from gsplat_tpu_torch.ops.quaternion import quaternion_to_rotation_matrix
from gsplat_tpu_torch.utils.device import resolve_device


def world_to_camera_matrix(qvec: torch.Tensor, tvec: torch.Tensor) -> torch.Tensor:
    """4x4 world->camera matrix from a unit quaternion and COLMAP tvec
    (column-vector convention, reference rasterize.py:59-77)."""
    m = torch.zeros((4, 4), dtype=qvec.dtype, device=qvec.device)
    m[:3, :3] = quaternion_to_rotation_matrix(qvec)
    m[:3, 3] = tvec
    m[3, 3] = 1.0
    return m


def projection_matrix(fov_x: torch.Tensor, fov_y: torch.Tensor) -> torch.Tensor:
    """OpenGL-style perspective matrix (column-vector convention, reference
    rasterize.py:123-151). ``fov_x``/``fov_y`` are 0-d tensors whose dtype
    the matrix takes."""
    tan_half_x = torch.tan(fov_x / 2.0)
    tan_half_y = torch.tan(fov_y / 2.0)
    top = tan_half_y * Z_NEAR
    right = tan_half_x * Z_NEAR
    two_near = torch.tensor(2.0 * Z_NEAR, dtype=fov_x.dtype)
    p = torch.zeros((4, 4), dtype=fov_x.dtype)
    # A scalar divided by a tensor would go through reciprocal(); divide two
    # tensors so the quotient is rounded once, as in the JAX package.
    p[0, 0] = two_near / (2.0 * right)
    p[1, 1] = two_near / (2.0 * top)
    p[2, 2] = Z_FAR / (Z_FAR - Z_NEAR)
    p[2, 3] = -(Z_FAR * Z_NEAR) / (Z_FAR - Z_NEAR)
    p[3, 2] = 1.0
    return p


def fov_from_focal(width: float, height: float, fx: float, fy: float) -> Tuple[float, float]:
    """Full fields of view from pinhole intrinsics (rasterize.py:342-343)."""
    return 2.0 * math.atan(width / (2.0 * fx)), 2.0 * math.atan(height / (2.0 * fy))


def camera_center(world_to_camera_t: torch.Tensor) -> torch.Tensor:
    """World-space camera position ``-R^T t`` from the transposed
    world->camera matrix (spherical_harmonics.py:35)."""
    return -(world_to_camera_t[:3, :3] @ world_to_camera_t[3, :3])


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Everything the renderer needs about one camera/view, as plain Python
    data. ``width``/``height`` are the render resolution; the FoV comes from
    the full-resolution intrinsics (rasterize.py:333-343)."""

    width: int
    height: int
    fov_x: float
    fov_y: float
    focal_x: float
    focal_y: float
    qvec: Tuple[float, float, float, float]
    tvec: Tuple[float, float, float]

    @property
    def tan_fov_x(self) -> float:
        return math.tan(self.fov_x * 0.5)

    @property
    def tan_fov_y(self) -> float:
        return math.tan(self.fov_y * 0.5)

    def matrices(self, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """(world_to_camera^T, full_projection^T) on the host, as used by
        the row-vector pipeline: ``clip = p @ full_proj_t``."""
        w2c = world_to_camera_matrix(
            torch.tensor(self.qvec, dtype=dtype), torch.tensor(self.tvec, dtype=dtype)
        )
        proj = projection_matrix(
            torch.tensor(self.fov_x, dtype=dtype), torch.tensor(self.fov_y, dtype=dtype)
        )
        w2c_t = w2c.T.contiguous()
        return w2c_t, w2c_t @ proj.T

    @staticmethod
    def from_colmap(image, camera, render_width: int, render_height: int) -> "CameraParams":
        """Build from COLMAP ``BaseImage`` + ``Camera`` records.

        Single-focal models (SIMPLE_PINHOLE / SIMPLE_RADIAL / RADIAL /
        SIMPLE_RADIAL_FISHEYE / RADIAL_FISHEYE) store (f, cx, cy, ...), so
        fx = fy = params[0]; two-focal models store (fx, fy, cx, cy, ...).
        Distortion coefficients are ignored (undistorted pinhole projection,
        as in the reference).
        """
        single_focal = getattr(camera, "model", "PINHOLE") in {
            "SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
            "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE",
        }
        fx = float(camera.params[0])
        fy = fx if single_focal else float(camera.params[1])
        fov_x, fov_y = fov_from_focal(camera.width, camera.height, fx, fy)
        return CameraParams(
            width=int(render_width),
            height=int(render_height),
            fov_x=fov_x,
            fov_y=fov_y,
            focal_x=fx,
            focal_y=fy,
            qvec=tuple(np.asarray(image.qvec, dtype=np.float64).tolist()),
            tvec=tuple(np.asarray(image.tvec, dtype=np.float64).tolist()),
        )


class CameraArrays(NamedTuple):
    """Per-view camera quantities as tensors on the render device. Width and
    height stay Python ints beside them (they fix tensor shapes)."""

    w2c_t: torch.Tensor  # [4, 4]
    full_proj_t: torch.Tensor  # [4, 4]
    cam_center: torch.Tensor  # [3]
    tan_fov: torch.Tensor  # [2] (tan of half fov x, y)
    focal: torch.Tensor  # [2] (fx, fy)

    @staticmethod
    def from_params(
        camera: CameraParams, dtype=torch.float32, device="cuda"
    ) -> "CameraArrays":
        dev = resolve_device(device)
        w2c_t, full_proj_t = camera.matrices(dtype)
        host = CameraArrays(
            w2c_t=w2c_t,
            full_proj_t=full_proj_t,
            cam_center=camera_center(w2c_t),
            tan_fov=torch.tensor([camera.tan_fov_x, camera.tan_fov_y], dtype=dtype),
            focal=torch.tensor([camera.focal_x, camera.focal_y], dtype=dtype),
        )
        # Pageable host memory is staged at once, so a non-blocking copy is
        # safe and spares the render path a stream synchronisation per field.
        return CameraArrays(*(x.to(dev, non_blocking=True) for x in host))

    @staticmethod
    def stack(cameras: Sequence["CameraArrays"]) -> "CameraArrays":
        """Stack CameraArrays into batched leaves ``[B, ...]``."""
        return CameraArrays(*(torch.stack(xs) for xs in zip(*cameras)))
