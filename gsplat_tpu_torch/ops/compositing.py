"""Alpha-compositing math and a slow, exact oracle renderer.

``gaussian_alpha`` is the blending rule every renderer of the port shares
(the kernel, its plain version, the oracle). ``render_oracle`` replays the
reference's per-gaussian sequential loop (rasterize.py:436-452, 255-305)
over depth-sorted gaussians against the whole framebuffer with a bbox
containment mask: O(N * H * W), for tests only.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.config import MAX_GAUSSIAN_DENSITY, MIN_ALPHA
from gsplat_tpu_torch.ops.projection import Preprocessed

# The gates compare f32 alphas against these f32 values, as the JAX package
# does (its Python constants are weakly typed to f32).
MIN_ALPHA_F32 = float(np.float32(MIN_ALPHA))
MAX_GAUSSIAN_DENSITY_F32 = float(np.float32(MAX_GAUSSIAN_DENSITY))


class AlphaTerms(NamedTuple):
    """What :func:`gaussian_alpha` returns: alpha, its gate, and the
    intermediates the backward needs."""

    dx: torch.Tensor  # mean_x - px
    dy: torch.Tensor  # mean_y - py
    density: torch.Tensor
    expd: torch.Tensor  # exp(density)
    raw: torch.Tensor  # opacity * expd, before the clamp
    alpha: torch.Tensor  # min(raw, 0.99)
    valid: torch.Tensor  # alpha > 1/255 and density <= 0


def gaussian_alpha(px, py, mean_x, mean_y, conic_x, conic_y, conic_xy, opacity) -> AlphaTerms:
    """Per-pixel alpha of a broadcastable batch of gaussians
    (rasterize.py:279-292) with its intermediates: ``d = mean - pixel``,
    quadratic-form density, ``alpha = min(opacity * exp(density), 0.99)``,
    valid when ``alpha > 1/255 and density <= 0``. The backward recomputes
    alphas through this same function (the CUDA kernels through
    ``csrc/raster_common.cuh``, which rounds alike)."""
    dx = mean_x - px
    dy = mean_y - py
    density = -0.5 * (conic_x * dx * dx + conic_y * dy * dy) - conic_xy * dx * dy
    expd = torch.exp(density)
    raw = opacity * expd
    alpha = torch.clamp(raw, max=MAX_GAUSSIAN_DENSITY_F32)
    valid = (alpha > MIN_ALPHA_F32) & (density <= 0.0)
    return AlphaTerms(dx, dy, density, expd, raw, alpha, valid)


def render_oracle(prep: Preprocessed, width: int, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-semantics sequential renderer (test oracle). Returns (image
    ``[H, W, 3]``, transmittance ``[H, W]``) in display orientation."""
    dtype = prep.screen_means.dtype
    dev = prep.screen_means.device
    order = torch.argsort(prep.depth, stable=True)
    px = torch.arange(width, dtype=dtype, device=dev)[None, :]
    py = torch.arange(height, dtype=dtype, device=dev)[:, None]
    image = torch.zeros((height, width, 3), dtype=dtype, device=dev)
    trans = torch.ones((height, width), dtype=dtype, device=dev)
    for g in order.tolist():
        mx, my = prep.screen_means[g]
        cx, cy, cxy = prep.conics[g]
        at = gaussian_alpha(px, py, mx, my, cx, cy, cxy, prep.opacity[g])
        x0, y0, x1, y1 = prep.bbox[g]
        inside = (px >= x0) & (px < x1) & (py >= y0) & (py < y1)
        a = torch.where(at.valid & inside & prep.active[g], at.alpha, 0.0)
        image = image + (a * trans)[..., None] * prep.rgb[g][None, None, :]
        trans = trans * (1.0 - a)
    return image, trans
