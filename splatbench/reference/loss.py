"""Plain-PyTorch reference of the training loss: ``(1 - w) * L1 + w * (1 -
SSIM)``, SSIM with the 11x11 gaussian window (sigma 1.5) of the SSIM paper,
zero padded, constants (0.01)^2 and (0.03)^2. The window is applied as one
2-D convolution (the program applies it as two 1-D ones)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

WINDOW = 11
SIGMA = 1.5
C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _window(dtype, device) -> torch.Tensor:
    x = torch.arange(WINDOW, dtype=torch.float64) - (WINDOW - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * SIGMA * SIGMA))
    g = g / g.sum()
    return (g[:, None] * g[None, :]).to(dtype=dtype, device=device)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """``[H, W, C]`` -> the same, each channel blurred by the window."""
    w = _window(x.dtype, x.device)[None, None]
    y = F.conv2d(x.permute(2, 0, 1)[:, None], w, padding=WINDOW // 2)
    return y[:, 0].permute(1, 2, 0)


def ssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mu_p, mu_t = _blur(pred), _blur(target)
    s_pp = _blur(pred * pred) - mu_p * mu_p
    s_tt = _blur(target * target) - mu_t * mu_t
    s_pt = _blur(pred * target) - mu_p * mu_t
    num = (2 * mu_p * mu_t + C1) * (2 * s_pt + C2)
    den = (mu_p * mu_p + mu_t * mu_t + C1) * (s_pp + s_tt + C2)
    return (num / den).mean()


def rgb_loss(pred: torch.Tensor, target: torch.Tensor, ssim_weight: float) -> torch.Tensor:
    l1 = (pred - target).abs().mean()
    if ssim_weight == 0.0:
        return l1
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim(pred, target))
