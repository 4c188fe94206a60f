"""gsplat_tpu_torch: the PyTorch and CUDA port of gsplat_tpu.

The render path of ``gsplat_tpu`` (activations, SH color, camera matrices,
EWA preprocess, tile binning, tile compositing, image assembly) in PyTorch,
with the tile compositor as a hand-written CUDA kernel for Hopper. Entry
points run on the device of their tensors; the factories default to
``device="cuda"`` and raise when no card is present. This package imports
neither JAX nor ``gsplat_tpu``.
"""

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.models.gaussians import GaussianModel, random_model
from gsplat_tpu_torch.ops.camera import CameraArrays, CameraParams
from gsplat_tpu_torch.render.pipeline import (
    binning_stats,
    render,
    render_batch,
    render_reference_oracle,
    render_traced,
    required_max_pairs,
    suggest_max_pairs,
)

__version__ = "0.1.0"

__all__ = [
    "CameraArrays",
    "CameraParams",
    "GaussianModel",
    "RasterConfig",
    "binning_stats",
    "random_model",
    "render",
    "render_batch",
    "render_reference_oracle",
    "render_traced",
    "required_max_pairs",
    "suggest_max_pairs",
]
