"""Differentiable tile rasterization: a ``torch.autograd.Function`` over the
forward and backward compositors.

``rasterize_tiles`` is the single entry point every renderer uses. It works
at tile level (explicit global ``tile_ids``, per-tile output slabs); image
assembly (``render.tile_torch.tiles_to_image``) happens outside and is
differentiated by autograd. Both compositors dispatch on the device of
their tensors: a CUDA tensor launches the hand-written kernel
(``csrc/raster_fwd.cu``, ``csrc/raster_bwd.cu``), a CPU tensor takes its
plain version (``kernels/raster_fwd.py``, ``kernels/raster_bwd.py``).

The gradient, the counterpart of the JAX package's custom VJP
(``gsplat_tpu/kernels/raster.py``), goes to the packed per-gaussian
features ``feat`` (means, conics, opacity, rgb), from which autograd
continues through the preprocess to the raw parameters. Binning indices get
none, as in the original design: no gradient flows through tile
assignment.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles, reduce_compacted, reduce_exact, reduce_pair_grads
from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles
from gsplat_tpu_torch.utils import stages
from gsplat_tpu_torch.utils.stages import stage


class _RasterizeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, pair_gaussian, tile_start, tile_count, tile_ids, gaussian_counts,
                n_tiles_x, cfg, width, height):
        color, trans, blocks_done = forward_tiles(
            feat, pair_gaussian, tile_start, tile_count, tile_ids, n_tiles_x, cfg, width, height
        )
        ctx.save_for_backward(feat, pair_gaussian, tile_start, tile_count, tile_ids,
                              gaussian_counts, color, trans, blocks_done)
        ctx.n_tiles_x, ctx.cfg = n_tiles_x, cfg
        return color, trans

    @staticmethod
    @once_differentiable
    def backward(ctx, g_color, g_trans):
        # Unused outputs arrive as zeros (autograd materializes them).
        feat, pair_gaussian, tile_start, tile_count, tile_ids, gaussian_counts, color, trans, blocks_done = (
            ctx.saved_tensors
        )
        with stage("raster_bwd"):
            pair_grads = backward_tiles(
                feat, pair_gaussian, tile_start, tile_count, tile_ids, color, trans,
                g_color.contiguous(), g_trans.contiguous(), ctx.n_tiles_x, ctx.cfg, blocks_done,
            )
        with stage("reduction"):
            d_feat = _reduce(pair_grads, pair_gaussian, tile_start, gaussian_counts, blocks_done,
                             feat.shape[0], ctx.cfg)
        return (d_feat,) + (None,) * 9


def _reduce(pair_grads, pair_gaussian, tile_start, gaussian_counts, blocks_done, num_rows, cfg):
    """The pair-to-gaussian reduction, as ``backward_tiles_pallas`` chooses
    it: with ``cfg.exact_grad_reduction``, the exact sum over every row;
    else, with ``cfg.reduce_pairs`` smaller than the pair buffer, the walked
    blocks are gathered and reduced alone when they fit it (one host sync to
    count them), else the full reduction over every row."""
    if cfg.exact_grad_reduction:
        return reduce_exact(pair_grads, pair_gaussian, gaussian_counts, num_rows)
    blk = cfg.pair_block
    cap_blk = max(cfg.reduce_pairs // blk, 1)
    if gaussian_counts is not None and cfg.reduce_pairs > 0 and cap_blk < -(-pair_gaussian.shape[0] // blk):
        with stages.sync("reduction_sync"):
            total = int(blocks_done.sum())
        stages.count("reduction", int(total <= cap_blk))
        if total <= cap_blk:
            return reduce_compacted(pair_grads, pair_gaussian, tile_start, blocks_done, total, blk, num_rows)
    return reduce_pair_grads(pair_grads, pair_gaussian, gaussian_counts, num_rows)


def rasterize_tiles(
    feat: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tile_ids: torch.Tensor,
    gaussian_counts: Optional[torch.Tensor],
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
      gaussian_counts: ``[N]`` kept pairs per gaussian in id order
        (binning); drives the backward's sort-based gradient reduction.
        None reduces with an exact segment sum instead, as does
        ``cfg.exact_grad_reduction``. With ``cfg.reduce_pairs > 0`` the
        backward reduces only the blocks it walked when they fit that
        capacity.
      n_tiles_x, cfg: tile grid width and settings.
      width, height: frame size; pixels of the last row/column and outside
        the frame are left out of the early-stop test (0 = test all).
    Returns:
      (color ``[T, npix, 3]``, transmittance ``[T, npix]``).

    Under ``torch.no_grad()`` / ``torch.inference_mode()``, or when ``feat``
    needs no gradient, this is one forward launch and nothing is saved.
    """
    with stage("raster_fwd"):
        if torch.is_grad_enabled() and feat.requires_grad:
            # While recording, the tiles' backward closes the span ``loss_bwd``.
            return stages.closes_backward("loss_bwd", *_RasterizeTiles.apply(
                feat, pair_gaussian, tile_start, tile_count, tile_ids, gaussian_counts,
                n_tiles_x, cfg, width, height,
            ))
        color, trans, _ = forward_tiles(
            feat, pair_gaussian, tile_start, tile_count, tile_ids, n_tiles_x, cfg, width, height
        )
    return color, trans
