"""End-to-end render pipeline.

Mirrors the reference's compute sequence (rasterize.py:353-452):
activations -> SH color -> camera matrices -> projection/EWA preprocess ->
feature packing -> tile binning -> tile rasterization -> image assembly.
Everything runs on the device of the model's tensors. Two camera forms:

  * :func:`render` takes a :class:`CameraParams` (plain Python data);
  * :func:`render_traced` takes :class:`CameraArrays` already on the
    device; :func:`render_batch` renders a stacked batch of them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.kernels.raster import rasterize_tiles
from gsplat_tpu_torch.models.gaussians import GaussianModel
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.ops.camera import CameraArrays, CameraParams
from gsplat_tpu_torch.ops.compositing import render_oracle
from gsplat_tpu_torch.ops.projection import Preprocessed, preprocess_gaussians_from_params
from gsplat_tpu_torch.ops.sh import sh_to_rgb
from gsplat_tpu_torch.render.tile_torch import tiles_to_image


def preprocess_traced(
    model: GaussianModel,
    cam: CameraArrays,
    width: int,
    height: int,
    cfg: RasterConfig,
    screen_offset=None,
) -> Preprocessed:
    """Per-gaussian preprocess for one camera (rasterize.py:353-425)."""
    rgb = sh_to_rgb(model.means, model.sh, cam.cam_center, degree=cfg.sh_degree)
    return preprocess_gaussians_from_params(
        means=model.means,
        scales=model.scales(),
        quats=model.quats,
        opacity=model.opacity(),
        rgb=rgb,
        w2c_t=cam.w2c_t,
        full_proj_t=cam.full_proj_t,
        tan_fov_x=cam.tan_fov[0],
        tan_fov_y=cam.tan_fov[1],
        focal_x=cam.focal[0],
        focal_y=cam.focal[1],
        width=width,
        height=height,
        strict_parity=cfg.strict_parity,
        screen_offset=screen_offset,
    )


def _camera_arrays(model: GaussianModel, camera: CameraParams) -> CameraArrays:
    return CameraArrays.from_params(camera, dtype=model.means.dtype, device=model.means.device)


def preprocess(model: GaussianModel, camera: CameraParams, cfg: RasterConfig) -> Preprocessed:
    return preprocess_traced(model, _camera_arrays(model, camera), camera.width, camera.height, cfg)


def render_traced(
    model: GaussianModel,
    cam: CameraArrays,
    width: int,
    height: int,
    cfg: RasterConfig = RasterConfig(),
    screen_offset=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render one view. Returns (image ``[H, W, 3]``, transmittance
    ``[H, W]``). ``screen_offset`` ([N, 2], optional) shifts pixel-space
    means (the densifying trainer's viewspace-gradient probe)."""
    prep = preprocess_traced(model, cam, width, height, cfg, screen_offset)
    feat = binning.pack_features(prep)
    bins = binning.bin_gaussians(
        prep, width, height, cfg.tile_size, cfg.max_pairs, align=cfg.pair_block
    )
    n_tiles_x = -(-width // cfg.tile_size)
    n_tiles_y = -(-height // cfg.tile_size)
    tile_ids = torch.arange(n_tiles_x * n_tiles_y, dtype=torch.int32, device=feat.device)
    color, trans = rasterize_tiles(
        feat, bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids,
        bins.gaussian_counts, n_tiles_x, cfg, width=width, height=height,
    )
    return (
        tiles_to_image(color, width, height, cfg.tile_size),
        tiles_to_image(trans, width, height, cfg.tile_size),
    )


def render(
    model: GaussianModel, camera: CameraParams, cfg: RasterConfig = RasterConfig()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render one view. Returns (image ``[H, W, 3]``, transmittance ``[H, W]``)."""
    return render_traced(model, _camera_arrays(model, camera), camera.width, camera.height, cfg)


def render_batch(
    model: GaussianModel,
    cams: CameraArrays,
    width: int,
    height: int,
    cfg: RasterConfig = RasterConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a batch of views (stacked CameraArrays, ``[B, ...]`` leaves),
    one after another. Returns (``[B, H, W, 3]``, ``[B, H, W]``)."""
    frames = [
        render_traced(model, CameraArrays(*(x[i] for x in cams)), width, height, cfg)
        for i in range(cams.w2c_t.shape[0])
    ]
    return torch.stack([f[0] for f in frames]), torch.stack([f[1] for f in frames])


def binning_stats(
    model: GaussianModel,
    cam: CameraArrays,
    width: int,
    height: int,
    cfg: RasterConfig = RasterConfig(),
) -> dict:
    """Pair-budget diagnostics for one view, as 0-d tensors on the device.
    ``overflowed`` means the pair buffer could not hold the view's demand
    and the deepest splats were dropped; see :func:`suggest_max_pairs`."""
    prep = preprocess_traced(model, cam, width, height, cfg)
    bins = binning.bin_gaussians(
        prep, width, height, cfg.tile_size, cfg.max_pairs, align=cfg.pair_block
    )
    return {
        "num_pairs": bins.num_pairs,
        "pair_demand": bins.pair_demand,
        "capacity": torch.tensor(cfg.max_pairs, dtype=torch.int32, device=prep.depth.device),
        "overflowed": bins.pair_demand > cfg.max_pairs,
        "active_gaussians": prep.active.sum(dtype=torch.int32),
        "max_tile_count": bins.tile_count.max(),
    }


def required_max_pairs(demand: int, headroom: float = 1.5, floor: int = 32) -> int:
    """The pair capacity covering ``demand * headroom``, rounded up to a
    power of two."""
    target = int(max(demand, 1) * headroom)
    return 1 << max(target - 1, floor).bit_length()


def suggest_max_pairs(
    model: GaussianModel,
    camera: CameraParams,
    cfg: RasterConfig = RasterConfig(),
    headroom: float = 2.0,
) -> int:
    """Size ``max_pairs`` for a scene and view: measured pair demand times
    ``headroom``, power-of-two rounded (one host sync)."""
    stats = binning_stats(model, _camera_arrays(model, camera), camera.width, camera.height, cfg)
    return required_max_pairs(int(stats["pair_demand"]), headroom, floor=cfg.pair_block)


def render_reference_oracle(
    model: GaussianModel, camera: CameraParams, cfg: RasterConfig = RasterConfig()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slow exact-semantics sequential render (test oracle; O(N*H*W))."""
    return render_oracle(preprocess(model, camera, cfg), camera.width, camera.height)
