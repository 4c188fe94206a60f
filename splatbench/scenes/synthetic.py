"""bench.py's synthetic scene (``bench.py:172-200``; copied from the
program's ``chip_smoke.build_scene``, which fixes the seed at 0): camera at
the origin looking down +z, z in [2, 10], the view frustum filled, log
scales in [-5.2, -3.6] plus the configuration's ``scale_shift``, normal
quaternions, opacity logits in [-2, 2], SH coefficients 0.2 times a normal.
It is drawn on the device by one ``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

from typing import List

import torch

from splatbench.scene import seed_value


def build(config: dict, seed: int, device) -> List[torch.Tensor]:
    """The five raw parameters, in ``scene.PARAM_NAMES`` order, float32:
    ``config["n_gaussians"]`` of them."""
    n, scale_shift = config["n_gaussians"], config["scale_shift"]
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
