"""Scene facade: join COLMAP extrinsics + intrinsics under ``sparse/0``.

Parity target: ``utils.py:34-58`` (read_scene). Adds optional text-format
fallback, which COLMAP reconstructions sometimes ship instead of binary.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

from gsplat_tpu_torch.io.colmap import (
    BaseImage,
    Camera,
    read_extrinsics_binary,
    read_extrinsics_text,
    read_intrinsics_binary,
    read_intrinsics_text,
)


def read_scene(path_to_scene: str) -> Tuple[Dict[int, BaseImage], Dict[int, Camera]]:
    """Load per-image extrinsics and camera intrinsics from
    ``<scene>/sparse/0/{images,cameras}.{bin,txt}``."""
    sparse = os.path.join(path_to_scene, "sparse/0")
    images_bin = os.path.join(sparse, "images.bin")
    cameras_bin = os.path.join(sparse, "cameras.bin")
    if os.path.exists(images_bin):
        extrinsics = read_extrinsics_binary(images_bin)
    else:
        extrinsics = read_extrinsics_text(os.path.join(sparse, "images.txt"))
    if os.path.exists(cameras_bin):
        intrinsics = read_intrinsics_binary(cameras_bin)
    else:
        intrinsics = read_intrinsics_text(os.path.join(sparse, "cameras.txt"))
    return extrinsics, intrinsics


def checkpoint_ply_path(trained_model_path: str, iteration: int = 30000) -> str:
    """The Inria checkpoint layout the reference hardcodes
    (rasterize.py:351-353)."""
    return os.path.join(
        trained_model_path, f"point_cloud/iteration_{iteration}/point_cloud.ply"
    )


def read_points3d(path_to_scene: str):
    """Load the SfM point cloud from ``<scene>/sparse/0/points3D.{bin,txt}``
    -> (xyzs [N,3], rgbs [N,3], errors [N,1]), the seed of training from
    scratch (``GaussianModel.from_points3d``). The reference parses the same files
    (data_reader.py:48-114) but never consumes them."""
    from gsplat_tpu_torch.io.colmap import read_points3D_binary, read_points3D_text

    sparse = os.path.join(path_to_scene, "sparse/0")
    bin_path = os.path.join(sparse, "points3D.bin")
    if os.path.exists(bin_path):
        return read_points3D_binary(bin_path)
    return read_points3D_text(os.path.join(sparse, "points3D.txt"))
