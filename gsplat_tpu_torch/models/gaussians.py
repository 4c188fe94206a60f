"""The gaussian splat model: an ``nn.Module`` of raw (pre-activation)
parameters, in the Inria PLY checkpoint semantics the reference loads:

  * ``means``          [N, 3]  world-space centers (x, y, z).
  * ``log_scales``     [N, 3]  exp() -> per-axis std-devs (rasterize.py:97-99).
  * ``quats``          [N, 4]  unnormalized rotation quaternions, w-first;
                               normalized at use (rasterize.py:100-112).
  * ``opacity_logits`` [N]     sigmoid() -> opacity (rasterize.py:358).
  * ``sh``             [N, 16, 3] spherical-harmonics coefficients in the
                               Inria band-major layout (utils.py:21-31).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from gsplat_tpu_torch.ops.projection import covariance_from_scales_quats
from gsplat_tpu_torch.utils.device import resolve_device
from gsplat_tpu_torch.utils.stages import stage

PARAM_NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")


class GaussianModel(nn.Module):
    """Splat parameters as trainable ``nn.Parameter``s."""

    def __init__(self, means, log_scales, quats, opacity_logits, sh):
        super().__init__()
        self.means = nn.Parameter(means)
        self.log_scales = nn.Parameter(log_scales)
        self.quats = nn.Parameter(quats)
        self.opacity_logits = nn.Parameter(opacity_logits)
        self.sh = nn.Parameter(sh)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logits)

    def covariances(self) -> torch.Tensor:
        """[N, 3, 3] 3D covariances, Cov = (R S)(R S)^T (rasterize.py:89-120)."""
        return covariance_from_scales_quats(self.scales(), self.quats)

    @classmethod
    def from_arrays(
        cls, arrays: Dict[str, np.ndarray], dtype=torch.float32, device="cuda"
    ) -> "GaussianModel":
        """Model from the raw-parameter arrays of a PLY checkpoint or of the
        JAX package's ``GaussianModel.to_arrays()``."""
        dev = resolve_device(device)
        return cls(*(torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=dev) for k in PARAM_NAMES))

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k).detach().cpu().numpy() for k in PARAM_NAMES}

    def extra_repr(self) -> str:
        return f"num_gaussians={self.num_gaussians}"

    @classmethod
    def from_points3d(
        cls, xyzs, rgbs, initial_opacity: float = 0.1, dtype=torch.float32, device="cuda"
    ) -> "GaussianModel":
        """A trainable model from SfM points (``[N, 3]`` positions and
        ``[N, 3]`` 0-255 colours, as ``io.scene.read_points3d`` returns
        them), the 3DGS initialisation:

          * means = the point positions;
          * the degree-0 SH band reproduces the point's colour through
            ``sh_to_rgb`` (``(rgb/255 - 0.5) / C0``), higher bands zero;
          * isotropic scales, std-dev = sqrt of the mean squared distance to
            the 3 nearest neighbours (:func:`knn_mean_sq_dist`);
          * identity rotations; opacity ``initial_opacity``.
        """
        from gsplat_tpu_torch.ops.sh import SH_C0

        dev = resolve_device(device)
        xyz = torch.as_tensor(xyzs, dtype=dtype, device=dev)
        n = xyz.shape[0]
        rgb = torch.as_tensor(rgbs, dtype=dtype, device=dev) / 255.0
        sh = torch.zeros((n, 16, 3), dtype=dtype, device=dev)
        sh[:, 0, :] = (rgb - 0.5) / SH_C0
        with stage("knn_mean_sq_dist"):
            dist2 = knn_mean_sq_dist(xyz).clamp(min=1e-7)
        log_scales = (0.5 * torch.log(dist2))[:, None].repeat(1, 3)
        quats = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev).repeat(n, 1)
        logit = float(np.log(initial_opacity / (1.0 - initial_opacity)))
        return cls(xyz, log_scales, quats, torch.full((n,), logit, dtype=dtype, device=dev), sh)


def knn_mean_sq_dist(xyz: torch.Tensor, k: int = 3, chunk: Optional[int] = None) -> torch.Tensor:
    """Mean squared distance from each point to its ``k`` nearest neighbours
    (itself excluded), ``[N]``, on the device of ``xyz``. Brute force in
    blocks of ``chunk`` query points; the default keeps each block's
    ``[chunk, N]`` distance matrix at 2^26 elements (256 MB in f32).

    The distances are sums of squared coordinate differences, added x, y, z
    in that order and each square rounded before the sum, as the JAX package
    computes them (``torch.cdist``'s matmul expansion would round and cancel
    differently)."""
    n = xyz.shape[0]
    k_eff = min(k + 1, n)  # +1: each query point is its own 0-distance neighbour
    if k_eff <= 1:
        return torch.ones((n,), dtype=xyz.dtype, device=xyz.device)
    if chunk is None:
        chunk = max(1, (1 << 26) // n)
    cols = xyz.detach().T.contiguous()  # [3, N]
    out = []
    for start in range(0, n, chunk):
        q = cols[:, start:start + chunk, None]  # [3, c, 1]
        d2 = None
        for axis in range(3):
            d = q[axis] - cols[axis][None, :]  # [c, N]
            d.mul_(d)  # its own rounding: no fused multiply-add into the sum
            d2 = d if d2 is None else d2.add_(d)
        top = torch.topk(d2, k_eff, dim=1, largest=False).values  # ascending; top[:, 0] is the point itself
        out.append(top[:, 1:].mean(dim=1))
    return torch.cat(out)


DEAD_OPACITY_LOGIT = -30.0
# sigmoid(-30) ~ 9e-14: far below the 1/255 alpha gate, so a dead slot's
# alpha-cull rect is empty and it can never emit a (tile, gaussian) pair.


def pad_model(model: GaussianModel, total: int, dead_logit: float = DEAD_OPACITY_LOGIT) -> GaussianModel:
    """Pad the gaussian axis to ``total`` rows with inert splats (identity
    quats keep every preprocess intermediate finite)."""
    extra = total - model.num_gaussians
    if extra == 0:
        return model
    params = {k: getattr(model, k).detach() for k in PARAM_NAMES}

    def pad(x, fill=0.0):
        return torch.cat([x, x.new_full((extra,) + x.shape[1:], fill)])

    pad_quats = params["quats"].new_tensor([1.0, 0.0, 0.0, 0.0]).expand(extra, 4)
    return GaussianModel(
        means=pad(params["means"]),
        log_scales=pad(params["log_scales"]),
        quats=torch.cat([params["quats"], pad_quats]),
        opacity_logits=pad(params["opacity_logits"], dead_logit),
        sh=pad(params["sh"]),
    )


def random_model(
    generator: torch.Generator, n: int, extent: float = 1.0, device="cuda"
) -> GaussianModel:
    """Random splat model for tests and benchmarks, drawn from ``generator``
    on its own device and placed on ``device``. The draws follow the JAX
    package's distributions, not its numbers."""
    dev = resolve_device(device)
    gdev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=gdev) * (hi - lo) + lo

    return GaussianModel(
        means=uniform((n, 3), -extent, extent).to(dev),
        log_scales=uniform((n, 3), -5.0, -2.0).to(dev),
        quats=torch.randn((n, 4), generator=generator, device=gdev).to(dev),
        opacity_logits=uniform((n,), -2.0, 3.0).to(dev),
        sh=(torch.randn((n, 16, 3), generator=generator, device=gdev) * 0.3).to(dev),
    )
