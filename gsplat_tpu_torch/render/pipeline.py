"""End-to-end render pipeline.

Mirrors the reference's compute sequence (rasterize.py:353-452):
activations -> SH color -> camera matrices -> projection/EWA preprocess ->
feature packing -> tile binning -> tile rasterization -> image assembly.
Everything runs on the device of the model's tensors. Two camera forms:

  * :func:`render` takes a :class:`CameraParams` (plain Python data);
  * :func:`render_traced` takes :class:`CameraArrays` already on the
    device; :func:`render_batch` renders a stacked batch of them.

With ``cfg.slice_pairs > 0`` binning and rasterization take the
depth-sliced path (``render/sliced.py``) instead, on any device.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Tuple

import torch

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.kernels.preprocess import (
    needs_grad, preprocess_autograd, preprocess_forward, preprocess_plain, takes_kernel,
)
from gsplat_tpu_torch.kernels.raster import rasterize_tiles
from gsplat_tpu_torch.models.gaussians import GaussianModel
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.ops.camera import CameraArrays, CameraParams
from gsplat_tpu_torch.ops.compositing import render_oracle
from gsplat_tpu_torch.ops.projection import Preprocessed
from gsplat_tpu_torch.ops.sh import SH_C0
from gsplat_tpu_torch.render.sliced import render_sliced_tiles
from gsplat_tpu_torch.render.tile_torch import tiles_to_image
from gsplat_tpu_torch.utils import stages
from gsplat_tpu_torch.utils.stages import stage


def preprocess_traced(
    model: GaussianModel,
    cam: CameraArrays,
    width: int,
    height: int,
    cfg: RasterConfig,
    screen_offset=None,
) -> Preprocessed:
    """Per-gaussian preprocess for one camera (rasterize.py:353-425): the
    kernels of ``kernels/preprocess.py`` where ``takes_kernel`` holds (CUDA
    float32), through their autograd Function where a gradient is taken;
    the eager autograd path otherwise. Counts ``preprocess_kernel`` 1 or 0
    for the tracer, and where the eager path takes a gradient
    ``preprocess_bwd_kernel`` 0 (the Function's backward counts 1)."""
    # While recording, the backward of what the preprocess reads from the
    # model closes the span ``preprocess_bwd``.
    inputs = stages.closes_backward(
        "preprocess_bwd", model.means, model.sh, model.quats, model.scales(), model.opacity()
    )
    args = (*inputs, cam, width, height, cfg.sh_degree, cfg.strict_parity, screen_offset)
    grad = needs_grad((*inputs, screen_offset))
    if takes_kernel(inputs, cam, screen_offset):
        stages.count("preprocess_kernel", 1)
        return preprocess_autograd(*args) if grad else preprocess_forward(*args)
    stages.count("preprocess_kernel", 0)
    if grad:
        stages.count("preprocess_bwd_kernel", 0)
    return preprocess_plain(*args)


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
    return render_with_preprocess(model, cam, width, height, cfg, screen_offset)[:2]


def render_with_preprocess(
    model: GaussianModel,
    cam: CameraArrays,
    width: int,
    height: int,
    cfg: RasterConfig,
    screen_offset=None,
) -> Tuple[torch.Tensor, torch.Tensor, Preprocessed]:
    """:func:`render_traced` that also returns the view's preprocess (the
    densifying trainer reads the projected radii from it instead of running
    a second preprocess)."""
    with stage("preprocess"):
        prep = preprocess_traced(model, cam, width, height, cfg, screen_offset)
    with stage("pack_features"):
        feat = stages.opens_backward("preprocess_bwd", binning.pack_features(prep))
    if cfg.slice_pairs > 0:
        color, trans = render_sliced_tiles(prep, feat, width, height, cfg)
    else:
        with stage("binning"):
            bins = binning.bin_gaussians(
                prep, width, height, cfg.tile_size, cfg.max_pairs, align=cfg.pair_block
            )
        stages.count("pairs", bins.num_pairs)
        stages.count("pair_demand", bins.pair_demand)
        stages.count("overflow", bins.pair_demand, above=cfg.max_pairs)
        n_tiles_x = -(-width // cfg.tile_size)
        n_tiles_y = -(-height // cfg.tile_size)
        tile_ids = torch.arange(n_tiles_x * n_tiles_y, dtype=torch.int32, device=feat.device)
        color, trans = rasterize_tiles(
            feat, bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids,
            bins.gaussian_counts, n_tiles_x, cfg, width=width, height=height,
        )
    with stage("tiles_to_image"):
        return (
            tiles_to_image(color, width, height, cfg.tile_size),
            tiles_to_image(trans, width, height, cfg.tile_size),
            prep,
        )


def render_depth(
    model: GaussianModel,
    cam: CameraArrays,
    width: int,
    height: int,
    cfg: RasterConfig = RasterConfig(),
    near: float = 0.2,
    far: float = 100.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expected-depth map: each gaussian's camera-space z, alpha-composited
    through the standard pipeline (depth rides the degree-0 SH channel, so
    the compositor is the colour one and the result is differentiable like
    :func:`render`).

    Returns (depth ``[H, W]``, transmittance ``[H, W]``): ``depth`` is the
    T-weighted expected camera depth in [near, far] units; pixels the
    splats never cover carry depth 0 and transmittance 1. Divide by
    ``(1 - trans)`` for an occupancy-normalised map."""
    means = model.means
    z = means[:, 0] * cam.w2c_t[0, 2] + means[:, 1] * cam.w2c_t[1, 2] + means[:, 2] * cam.w2c_t[2, 2] + cam.w2c_t[3, 2]
    depth_norm = torch.clamp((z - near) / (far - near), 0.0, 1.0)
    # sh_to_rgb computes C0*sh0 + 0.5 and clamps to [0, 1], so
    # sh0 = (d - 0.5)/C0 gives back d for d in [0, 1] (ops/sh.py).
    sh0 = ((depth_norm - 0.5) / SH_C0)[:, None, None].expand(-1, 1, 3)
    sh = torch.cat([sh0, sh0.new_zeros((sh0.shape[0], model.sh.shape[1] - 1, 3))], dim=1)
    # The model's geometry with the depth colour: what preprocess_traced reads.
    depth_model = SimpleNamespace(means=means, quats=model.quats, sh=sh, scales=model.scales, opacity=model.opacity)
    img, trans = render_traced(depth_model, cam, width, height, dataclasses.replace(cfg, sh_degree=0))
    return img[:, :, 0] * (far - near) + near * (1.0 - trans), trans


def render(
    model: GaussianModel, camera: CameraParams, cfg: RasterConfig = RasterConfig()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render one view. Returns (image ``[H, W, 3]``, transmittance ``[H, W]``)."""
    with stage("camera"):
        cam = _camera_arrays(model, camera)
    return render_traced(model, cam, camera.width, camera.height, cfg)


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
