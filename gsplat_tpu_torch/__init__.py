"""gsplat_tpu_torch: the PyTorch and CUDA port of gsplat_tpu.

The render path of ``gsplat_tpu`` (activations, SH color, camera matrices,
EWA preprocess, tile binning, tile compositing, image assembly, depth maps)
and its training (L1 + SSIM loss, gradients to every splat parameter, Adam,
densification, loop checkpoints, training from SfM points) in PyTorch, with
the forward and backward tile compositors as hand-written CUDA kernels for
Hopper. Entry points run on the device of their tensors; the factories
default to ``device="cuda"`` and raise when no card is present. The command
line is ``gsplat_tpu_torch.cli`` (not imported here, so that importing the
package loads neither ``click`` nor Pillow). This package imports neither
JAX nor ``gsplat_tpu``.
"""

from gsplat_tpu_torch.config import DensifyConfig, MeshConfig, RasterConfig, TrainConfig
from gsplat_tpu_torch.models.gaussians import GaussianModel, random_model
from gsplat_tpu_torch.ops.camera import CameraArrays, CameraParams
from gsplat_tpu_torch.render.pipeline import (
    binning_stats,
    render,
    render_batch,
    render_depth,
    render_reference_oracle,
    render_traced,
    required_max_pairs,
    suggest_max_pairs,
)
from gsplat_tpu_torch.train.loss import psnr, rgb_loss, ssim
from gsplat_tpu_torch.train.trainer import Trainer

__version__ = "0.1.0"

__all__ = [
    "CameraArrays",
    "CameraParams",
    "DensifyConfig",
    "GaussianModel",
    "MeshConfig",
    "RasterConfig",
    "TrainConfig",
    "Trainer",
    "binning_stats",
    "psnr",
    "random_model",
    "render",
    "render_batch",
    "render_depth",
    "render_reference_oracle",
    "render_traced",
    "required_max_pairs",
    "rgb_loss",
    "ssim",
    "suggest_max_pairs",
]
