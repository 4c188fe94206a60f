"""The benchmark's inputs: the poses of a traffic mix and their cameras, and
the seed every draw starts from. The scene itself is a configuration's
scene file (``scenes/<scene>.py``, ``spec.scene_file``)."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from splatbench import spec

PARAM_NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")


def seed_value(seed: int) -> int:
    """A generator seed from any whole number (``manual_seed`` takes
    0 .. 2^64 - 1)."""
    return int(seed) % (1 << 63)


def build_scene(n: int, scale_shift: float, seed: int, device) -> List[torch.Tensor]:
    """The default scene (``scenes/synthetic.py``) of ``n`` gaussians at
    ``scale_shift``: the five raw parameters, in ``PARAM_NAMES`` order,
    float32."""
    config = {"n_gaussians": n, "scale_shift": scale_shift}
    return spec.scene_file(config).build(config, seed, device)


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
