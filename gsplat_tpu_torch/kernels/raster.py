"""Tile rasterization: the single entry point every renderer uses.

``rasterize_tiles`` works at tile level (explicit global ``tile_ids``,
per-tile output slabs); image assembly (``render.tile_torch.tiles_to_image``)
happens outside. It dispatches on the device of its tensors: a CUDA tensor
launches the hand-written forward kernel, a CPU tensor takes its plain
version (``kernels/raster_fwd.py``).

This slice is forward-only. The gradient (the JAX package's custom VJP,
``gsplat_tpu/kernels/raster.py``) arrives with the backward kernel in the
training slice; until then a call that would need it raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles


def rasterize_tiles(
    feat: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tile_ids: torch.Tensor,
    gaussian_counts: torch.Tensor,
    n_tiles_x: int,
    cfg: RasterConfig,
    width: int = 0,
    height: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite binned gaussians into per-tile pixel slabs.

    Args:
      feat: ``[N+1, 16]`` packed per-gaussian features (ops.binning).
      pair_gaussian / tile_start / tile_count: binning result, aligned to
        ``cfg.pair_block``.
      tile_ids: ``[T]`` global tile indices to rasterize.
      gaussian_counts: ``[N]`` kept pairs per gaussian (binning); the
        backward's pair->gaussian reduction will use it.
      n_tiles_x, cfg: tile grid width and settings.
      width, height: frame size; pixels of the last row/column and outside
        the frame are left out of the early-stop test (0 = test all).
    Returns:
      (color ``[T, npix, 3]``, transmittance ``[T, npix]``).
    """
    if torch.is_grad_enabled() and feat.requires_grad:
        raise NotImplementedError(
            "rasterize_tiles is forward-only until the training slice ports the "
            "backward kernel (_bwd_kernel); render under torch.no_grad() or "
            "torch.inference_mode()"
        )
    color, trans, _ = forward_tiles(
        feat, pair_gaussian, tile_start, tile_count, tile_ids, n_tiles_x, cfg, width, height
    )
    return color, trans
