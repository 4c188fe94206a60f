"""Image losses and quality metrics for splat training.

L1 + D-SSIM (the 3DGS training loss) and PSNR, as in
``gsplat_tpu/train/loss.py``. SSIM uses the 11x11 gaussian window of the
original SSIM paper as two separable depthwise convolutions with zero
padding. The blur runs in full f32 whatever the caller's global flags:
cuDNN allows TF32 for f32 convolutions by default, which keeps about three
decimal digits, so the convolutions run with TF32 off, forward and backward.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from gsplat_tpu_torch.utils import stages
from gsplat_tpu_torch.utils.stages import stage

_SSIM_WINDOW = 11
_SSIM_SIGMA = 1.5
_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _gaussian_window(dtype, device) -> torch.Tensor:
    half = (_SSIM_WINDOW - 1) / 2.0
    x = torch.arange(_SSIM_WINDOW, dtype=dtype, device=device) - half
    w = torch.exp(-(x * x) / (2.0 * _SSIM_SIGMA * _SSIM_SIGMA))
    return w / torch.sum(w)


@contextlib.contextmanager
def _full_f32_convolutions():
    """cuDNN convolutions in full f32 (no TF32) and deterministic, restoring
    the caller's flags after."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic)
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved


def _separable_blur(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Zero-padded 'same' blur of ``x [C, 1, H, W]`` by the window ``w``
    along H, then along W."""
    pad = _SSIM_WINDOW // 2
    with _full_f32_convolutions():
        x = F.conv2d(x, w.reshape(1, 1, _SSIM_WINDOW, 1), padding=(pad, 0))
        return F.conv2d(x, w.reshape(1, 1, 1, _SSIM_WINDOW), padding=(0, pad))


class _Blur(torch.autograd.Function):
    """The blur with its backward also in full f32. A zero-padded 'same'
    correlation with a symmetric window is its own adjoint, so the backward
    is the same blur of the cotangent."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        return _separable_blur(x, w)

    @staticmethod
    def backward(ctx, grad):
        (w,) = ctx.saved_tensors
        return _Blur.apply(grad.contiguous(), w), None


def _blur(img: torch.Tensor) -> torch.Tensor:
    """Separable 11x11 gaussian blur of ``[H, W, C]`` (zero 'same' padding)."""
    w = _gaussian_window(img.dtype, img.device)
    x = img.permute(2, 0, 1)[:, None].contiguous()  # [C, 1, H, W]
    return _Blur.apply(x, w)[:, 0].permute(1, 2, 0)


def ssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over an ``[H, W, C]`` image pair (values in [0, 1])."""
    mu_p = _blur(pred)
    mu_t = _blur(target)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sigma_pp = _blur(pred * pred) - mu_pp
    sigma_tt = _blur(target * target) - mu_tt
    sigma_pt = _blur(pred * target) - mu_pt
    num = (2.0 * mu_pt + _C1) * (2.0 * sigma_pt + _C2)
    den = (mu_pp + mu_tt + _C1) * (sigma_pp + sigma_tt + _C2)
    return torch.mean(num / den)


def rgb_loss(pred: torch.Tensor, target: torch.Tensor, ssim_weight: float) -> torch.Tensor:
    """(1-w) * L1 + w * (1 - SSIM): the 3DGS training loss, the stage
    ``loss``. While recording, its backward opens the span ``loss_bwd``."""
    with stage("loss"):
        if ssim_weight == 0.0:
            loss = l1_loss(pred, target)
        else:
            loss = (1.0 - ssim_weight) * l1_loss(pred, target) + ssim_weight * (1.0 - ssim(pred, target))
    return stages.opens_backward("loss_bwd", loss)
