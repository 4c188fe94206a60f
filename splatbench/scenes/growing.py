"""A scene mid-densification: bench.py's synthetic distribution
(``scenes/synthetic.py``: camera at the origin looking down +z, z in
[2, 10], the view frustum filled, normal quaternions, opacity logits in
[-2, 2], SH coefficients 0.2 times a normal) with its log scales drawn by a
screen-size law instead of a fixed range, so that its gaussians sit under
the recipe's size prune and its pass clones and splits.

Each gaussian's largest axis is drawn so that ``sigma * f / z`` lies in
the configuration's band of pixels ``sigma_px`` (log-uniform; ``f`` the
cameras' focal, 0.8 times the width), its other two axes as a share of the
largest, uniform in ``axis_share``; every log scale then takes the
configuration's ``scale_shift``. The rasterizer's EWA Jacobian takes half
that focal (the published rasterizer's convention), so a splat's drawn
standard deviation is half its ``sigma * f / z``.

It is drawn on the device by one ``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

import math
from typing import List

import torch

from splatbench.scene import seed_value


def build(config: dict, seed: int, device) -> List[torch.Tensor]:
    """The five raw parameters, in ``scene.PARAM_NAMES`` order, float32:
    ``config["n_gaussians"]`` of them."""
    n, scale_shift = config["n_gaussians"], config["scale_shift"]
    (px_lo, px_hi), (share_lo, share_hi) = config["sigma_px"], config["axis_share"]
    focal = 0.8 * config["width"]
    g = torch.Generator(device=device).manual_seed(seed_value(seed))

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    z = uniform((n,), 2.0, 10.0)
    x = uniform((n,), -0.9, 0.9) * z
    y = uniform((n,), -0.55, 0.55) * z
    largest = uniform((n, 1), math.log(px_lo), math.log(px_hi)) + torch.log(z / focal)[:, None]
    others = largest + torch.log(uniform((n, 2), share_lo, share_hi))
    return [
        torch.stack([x, y, z], -1),
        torch.cat([largest, others], -1) + scale_shift,
        torch.randn((n, 4), generator=g, device=device),
        uniform((n,), -2.0, 2.0),
        torch.randn((n, 48), generator=g, device=device).reshape(n, 16, 3) * 0.2,
    ]
