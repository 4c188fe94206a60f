"""Tile <-> image layout helpers.

Everything in the rasterizer works at tile level: per-tile pixel slabs
``[T, tile_size**2, ...]`` in row-major pixel order, addressed by global
tile ids. These convert to and from framebuffer layout.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def tiles_to_image(per_tile: torch.Tensor, width: int, height: int, tile_size: int) -> torch.Tensor:
    """``[T, tile_px, C...]`` -> ``[H, W, C...]`` (crops the tile padding)."""
    ts = tile_size
    n_tiles_x = -(-width // ts)
    n_tiles_y = -(-height // ts)
    trailing = per_tile.shape[2:]
    x = per_tile.reshape(n_tiles_y, n_tiles_x, ts, ts, *trailing)
    x = x.movedim(2, 1).reshape(n_tiles_y * ts, n_tiles_x * ts, *trailing)
    return x[:height, :width]


def image_to_tiles(image: torch.Tensor, tile_size: int) -> torch.Tensor:
    """``[H, W, C...]`` -> ``[T, tile_px, C...]`` (zero-pads to tile multiples)."""
    ts = tile_size
    h, w = image.shape[:2]
    n_tiles_x = -(-w // ts)
    n_tiles_y = -(-h // ts)
    trailing = image.shape[2:]
    # F.pad pads the last dims first: zeros for the trailing dims, then W, H.
    pad = [0, 0] * len(trailing) + [0, n_tiles_x * ts - w, 0, n_tiles_y * ts - h]
    x = F.pad(image, pad)
    x = x.reshape(n_tiles_y, ts, n_tiles_x, ts, *trailing).movedim(1, 2)
    return x.reshape(n_tiles_y * n_tiles_x, ts * ts, *trailing)


def tile_pixel_coords(tile_ids: torch.Tensor, n_tiles_x: int, tile_size: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-major pixel coordinates of the given tiles: ``([T, npix], [T, npix])``."""
    ts = tile_size
    tx = (tile_ids % n_tiles_x)[:, None]
    ty = (tile_ids // n_tiles_x)[:, None]
    lin = torch.arange(ts * ts, dtype=torch.int32, device=tile_ids.device)[None, :]
    return (tx * ts + lin % ts).to(dtype), (ty * ts + lin // ts).to(dtype)
