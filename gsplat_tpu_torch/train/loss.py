"""Image losses and quality metrics for splat training.

L1 + D-SSIM (the 3DGS training loss) and PSNR, as in
``gsplat_tpu/train/loss.py``. SSIM uses the 11x11 gaussian window of the
original SSIM paper with zero padding. On the card the loss, SSIM and
their gradients are two hand-written kernels (``kernels/loss.py``,
``csrc/loss.cu``), f32 throughout; elsewhere the eager version
(``kernels/loss.py::loss_plain``: two separable depthwise convolutions a
blur, in full f32).
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.kernels import loss as kl
from gsplat_tpu_torch.utils import stages
from gsplat_tpu_torch.utils.stages import stage


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def ssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over an ``[H, W, C]`` image pair (values in [0, 1]), one
    minus the loss at SSIM weight 1: by the kernels where
    ``kernels/loss.py::takes_kernel`` holds, else eager."""
    if kl.takes_kernel(pred, target):
        return 1.0 - kl.loss_autograd(pred, target, 1.0)[0]
    return kl.ssim_plain(pred, target)


def rgb_loss(pred: torch.Tensor, target: torch.Tensor, ssim_weight: float) -> torch.Tensor:
    """(1-w) * L1 + w * (1 - SSIM): the 3DGS training loss, the stage
    ``loss``; by the kernels where ``kernels/loss.py::takes_kernel`` holds
    (counter ``loss_kernel`` 1; CUDA frames they cannot take raise), else
    eager (0). While recording, its backward opens the span ``loss_bwd``."""
    with stage("loss"):
        if kl.takes_kernel(pred, target):
            stages.count("loss_kernel", 1)
            loss = kl.loss_autograd(pred, target, ssim_weight)[0]
        else:
            stages.count("loss_kernel", 0)
            loss = kl.loss_plain(pred, target, ssim_weight)
    return stages.opens_backward("loss_bwd", loss)
