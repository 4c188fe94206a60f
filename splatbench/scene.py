"""The benchmark's inputs: the scene drawn from ``--seed`` and the poses of a
traffic mix.

The scene is bench.py's distribution (``bench.py:172-200``; copied from the
program's ``chip_smoke.build_scene``, which fixes the seed at 0): camera at
the origin looking down +z, z in [2, 10], the view frustum filled, log
scales in [-5.2, -3.6] plus the configuration's shift, normal quaternions,
opacity logits in [-2, 2], SH coefficients 0.2 times a normal. It is drawn
on the device by one ``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

PARAM_NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")


def seed_value(seed: int) -> int:
    """A generator seed from any whole number (``manual_seed`` takes
    0 .. 2^64 - 1)."""
    return int(seed) % (1 << 63)


def build_scene(n: int, scale_shift: float, seed: int, device) -> List[torch.Tensor]:
    """The five raw parameters, in ``PARAM_NAMES`` order, float32."""
    g = torch.Generator(device=device).manual_seed(seed_value(seed))

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    z = uniform((n,), 2.0, 10.0)
    x = uniform((n,), -0.9, 0.9) * z
    y = uniform((n,), -0.55, 0.55) * z
    return [
        torch.stack([x, y, z], -1),
        uniform((n, 3), -5.2, -3.6) + scale_shift,
        torch.randn((n, 4), generator=g, device=device),
        uniform((n,), -2.0, 2.0),
        torch.randn((n, 48), generator=g, device=device).reshape(n, 16, 3) * 0.2,
    ]


def poses(traffic: dict) -> List[Tuple[float, float]]:
    """(yaw, shift) of each pose of the mix: ``count`` yaws evenly from
    ``yaw_min`` to ``yaw_max`` radians about +y, each moved
    ``shift_per_yaw * yaw`` along the camera's x axis."""
    p = traffic["poses"]
    k = p["count"]
    yaws = [p["yaw_min"] + (p["yaw_max"] - p["yaw_min"]) * i / max(k - 1, 1) for i in range(k)]
    return [(yaw, p["shift_per_yaw"] * yaw) for yaw in yaws]


def camera_params(width: int, height: int, yaw: float, shift: float):
    """The program's camera for a pose (``chip_smoke.bench_camera``: focal
    0.8 * width, turned by ``yaw`` about +y, ``tvec`` = (shift, 0, 0))."""
    from gsplat_tpu_torch import CameraParams

    fx = 0.8 * width
    return CameraParams(
        width=width, height=height,
        fov_x=2 * math.atan(width / (2 * fx)), fov_y=2 * math.atan(height / (2 * fx)),
        focal_x=fx, focal_y=fx,
        qvec=(math.cos(yaw / 2), 0.0, math.sin(yaw / 2), 0.0), tvec=(shift, 0.0, 0.0),
    )
