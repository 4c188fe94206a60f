"""The training loss, L1 + D-SSIM, forward and backward: the CUDA kernels'
wrappers, their autograd Function and their plain versions.

``loss_forward`` computes ``(1 - w) * mean|p - t| + w * (1 - mean SSIM)`` of
an ``[H, W, 3]`` float32 frame pair, its mean SSIM, and three per-pixel maps
that make the gradient a blur and a combine, by one launch of the
hand-written kernel ``csrc/loss.cu``; ``loss_backward`` takes the maps and
the loss's cotangent and gives the gradient with respect to the prediction
by one launch of that file's second kernel. :func:`loss_autograd` joins the
two in one autograd Function that saves the inputs and the maps.

:func:`loss_plain` is the eager loss, SSIM with the 11x11 gaussian window
of the SSIM paper as two separable depthwise convolutions with zero
padding, as ``gsplat_tpu/train/loss.py`` computes it: the CPU's path, held
to JAX by the CPU tests. The blur runs in full f32 whatever the caller's
global flags: cuDNN allows TF32 for f32 convolutions by default, which
keeps about three decimal digits, so the convolutions run with TF32 off,
forward and backward. :func:`loss_maps_plain` and
:func:`loss_backward_plain` are the kernels' algorithm in plain PyTorch (the
maps, then blur and combine), held to autograd through :func:`loss_plain`
on the CPU. There is no fallback from one path to the other: each wrapper
launches its kernel or raises.

The kernels replace no TPU kernel (the JAX package leaves the blurs to
XLA's convolution). ``train/loss.py`` takes them for every CUDA frame pair
(:func:`takes_kernel`, which raises for CUDA frames they cannot take) and
:func:`loss_plain` elsewhere (the CPU). This design moves 11 frames
(:func:`bytes_moved`): at 1920x1080 the forward reads the frame pair and
writes the maps, the backward reads the maps and the pair and writes the
gradient, 273.7 MB and 0.082 ms at 3.35 TB/s.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gsplat_tpu_torch.kernels import build
from gsplat_tpu_torch.kernels.preprocess import needs_grad

WINDOW = 11
SIGMA = 1.5
C1 = 0.01 ** 2
C2 = 0.03 ** 2
TILE = 16  # output pixels a block covers along each axis (csrc/loss.cu kTileX, kTileY)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_FWD_ARGTYPES = (
    _P, _P, _I, _I,  # pred, target, height, width
    _P, _F, _F, _D,  # taps (host), C1, C2, ssim_weight
    _P, _P, _P, _P, _P, _P,  # maps, partials, ticket, loss, ssim, stream
)
_BWD_ARGTYPES = (
    _P, _P, _P, _I, _I,  # pred, target, maps, height, width
    _P, _P, _F, _F, _P, _P,  # taps (host), grad_out, l1_coef, ssim_coef, grad, stream
)

_taps: Dict[torch.device, ctypes.Array] = {}
_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def gaussian_window(dtype, device) -> torch.Tensor:
    """The SSIM window's 11 taps, ``exp(-x^2 / (2 sigma^2))`` normalised."""
    half = (WINDOW - 1) / 2.0
    x = torch.arange(WINDOW, dtype=dtype, device=device) - half
    w = torch.exp(-(x * x) / (2.0 * SIGMA * SIGMA))
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
    pad = WINDOW // 2
    with _full_f32_convolutions():
        x = F.conv2d(x, w.reshape(1, 1, WINDOW, 1), padding=(pad, 0))
        return F.conv2d(x, w.reshape(1, 1, 1, WINDOW), padding=(0, pad))


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


def blur(img: torch.Tensor) -> torch.Tensor:
    """Separable 11x11 gaussian blur of ``[H, W, C]`` (zero 'same' padding)."""
    w = gaussian_window(img.dtype, img.device)
    x = img.permute(2, 0, 1)[:, None].contiguous()  # [C, 1, H, W]
    return _Blur.apply(x, w)[:, 0].permute(1, 2, 0)


def ssim_plain(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over an ``[H, W, C]`` image pair (values in [0, 1])."""
    mu_p = blur(pred)
    mu_t = blur(target)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sigma_pp = blur(pred * pred) - mu_pp
    sigma_tt = blur(target * target) - mu_tt
    sigma_pt = blur(pred * target) - mu_pt
    num = (2.0 * mu_pt + C1) * (2.0 * sigma_pt + C2)
    den = (mu_pp + mu_tt + C1) * (sigma_pp + sigma_tt + C2)
    return torch.mean(num / den)


def loss_plain(pred: torch.Tensor, target: torch.Tensor, ssim_weight: float) -> torch.Tensor:
    """``(1 - w) * mean|pred - target| + w * (1 - SSIM)``, eager and
    differentiable; the L1 term alone at weight 0."""
    l1 = torch.mean(torch.abs(pred - target))
    if ssim_weight == 0.0:
        return l1
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim_plain(pred, target))


def loss_maps_plain(pred: torch.Tensor, target: torch.Tensor,
                    ssim_weight: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: the loss, the mean
    SSIM and the maps ``[3, H, W, C]`` (A, B, C of ``csrc/loss.cu``: the
    derivative of a pixel's SSIM by its blurred mean with the variance
    terms' chain folded in, by its variance and by its covariance)."""
    mu_p, mu_t = blur(pred), blur(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    a1 = 2.0 * mu_pt + C1
    b1 = 2.0 * (blur(pred * target) - mu_pt) + C2
    a2 = mu_pp + mu_tt + C1
    b2 = (blur(pred * pred) - mu_pp) + (blur(target * target) - mu_tt) + C2
    den = a2 * b2
    s = a1 * b1 / den
    maps = torch.stack([(2.0 * mu_t * (b1 - a1) + 2.0 * mu_p * s * (a2 - b2)) / den, -s / b2, 2.0 * a1 / den])
    mean_s = torch.mean(s)
    loss = (1.0 - ssim_weight) * torch.mean(torch.abs(pred - target)) + ssim_weight * (1.0 - mean_s)
    return loss, mean_s, maps


def loss_backward_plain(pred: torch.Tensor, target: torch.Tensor, maps: torch.Tensor, ssim_weight: float,
                        grad_out: torch.Tensor) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: each map blurred,
    then ``c ((1 - w) / N sign(p - t) - (w / N) (blur(A) + 2 p blur(B) + t
    blur(C)))`` with ``c`` the loss's cotangent."""
    l1_coef, ssim_coef = _coefficients(pred, ssim_weight)
    d_ssim = blur(maps[0]) + 2.0 * pred * blur(maps[1]) + target * blur(maps[2])
    return grad_out * (l1_coef * torch.sign(pred - target) - ssim_coef * d_ssim)


def _coefficients(pred: torch.Tensor, ssim_weight: float) -> Tuple[float, float]:
    """``(1 - w) / N`` and ``w / N`` (each rounded to float32 where a float32
    tensor or the kernel takes it)."""
    n = pred.numel()
    return (1.0 - ssim_weight) / n, ssim_weight / n


def takes_kernel(pred: torch.Tensor, target: torch.Tensor) -> bool:
    """Whether the loss of this pair takes the kernels: True where either
    frame is on a CUDA device, False elsewhere (:func:`loss_plain`, the
    CPU's path). Raises ValueError for CUDA frames the kernels cannot take:
    anything but float32 ``[H, W, 3]`` frames of one shape on one device, or
    a target that takes a gradient. The card has no eager loss."""
    if pred.device.type != "cuda" and target.device.type != "cuda":
        return False
    if not (pred.dim() == 3 and pred.shape[-1] == 3 and target.shape == pred.shape
            and pred.dtype == target.dtype == torch.float32 and target.device == pred.device):
        raise ValueError(f"the loss kernels take float32 [H, W, 3] frames of one shape on one device, got "
                         f"{pred.dtype} {tuple(pred.shape)} on {pred.device} and {target.dtype} "
                         f"{tuple(target.shape)} on {target.device}")
    if needs_grad([target]):
        raise ValueError("the loss kernels take no gradient with respect to the target")
    return True


def _check(who: str, *named: Tuple[str, torch.Tensor]) -> None:
    """Raise unless the kernels take these tensors: contiguous float32 CUDA
    ``[H, W, 3]`` frames of one shape on one device, at most 2**31 values."""
    pred = named[0][1]
    for name, t in named:
        if t.dtype != torch.float32 or t.device != pred.device or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous float32 tensor on {pred.device}, "
                             f"got {t.dtype} on {t.device}")
        if t.shape != pred.shape:
            raise ValueError(f"{who}: {name} must have the shape {tuple(pred.shape)}, got {tuple(t.shape)}")
    if pred.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {pred.device}")
    if pred.dim() != 3 or pred.shape[2] != 3 or pred.shape[0] < 1 or pred.shape[1] < 1:
        raise ValueError(f"{who}: frames must be [H, W, 3] with H, W >= 1, got {tuple(pred.shape)}")
    if pred.numel() >= 2**31 or pred.shape[0] > TILE * 65535:
        raise ValueError(f"{who}: frame {tuple(pred.shape)} too large")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _window_taps(dev: torch.device) -> ctypes.Array:
    """The window's f32 taps as the eager path computes them on ``dev``,
    read to the host once a device."""
    taps = _taps.get(dev)
    if taps is None:
        taps = _taps[dev] = (ctypes.c_float * WINDOW)(*gaussian_window(torch.float32, dev).tolist())
    return taps


def _ticket(dev: torch.device) -> torch.Tensor:
    """The forward's ticket counter on ``dev``'s current stream: zero at
    first use, and each launch leaves it zero."""
    key = (dev, _stream(dev))
    ticket = _tickets.get(key)
    if ticket is None:
        ticket = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return ticket


def loss_forward(pred: torch.Tensor, target: torch.Tensor,
                 ssim_weight: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The loss (0-d), the mean SSIM (0-d) and the maps ``[3, H, W, 3]`` of
    contiguous float32 CUDA frames ``[H, W, 3]``, by the forward kernel on
    the current stream, recording no gradient. Raises on anything else, CPU
    tensors included."""
    _check("loss_forward", ("pred", pred), ("target", target))
    dev = pred.device
    height, width, _ = pred.shape
    maps = torch.empty((3, *pred.shape), dtype=torch.float32, device=dev)
    blocks = ((height + TILE - 1) // TILE) * ((width + TILE - 1) // TILE)
    partials = torch.empty(2 * blocks, dtype=torch.float32, device=dev)
    loss, mean_s = (torch.empty((), dtype=torch.float32, device=dev) for _ in range(2))
    err = build.load_function("loss", "gsplat_loss_forward", _FWD_ARGTYPES)(
        pred.data_ptr(), target.data_ptr(), height, width, ctypes.addressof(_window_taps(dev)), C1, C2,
        float(ssim_weight), maps.data_ptr(), partials.data_ptr(), _ticket(dev).data_ptr(), loss.data_ptr(),
        mean_s.data_ptr(), _stream(dev),
    )
    if err != 0:
        raise RuntimeError(f"loss forward kernel launch failed with cudaError_t {err}")
    return loss, mean_s, maps


def loss_backward(pred: torch.Tensor, target: torch.Tensor, maps: torch.Tensor, ssim_weight: float,
                  grad_out: torch.Tensor) -> torch.Tensor:
    """The gradient ``[H, W, 3]`` of the loss with respect to ``pred`` from
    :func:`loss_forward`'s maps and the loss's cotangent ``grad_out`` (0-d,
    read on the card), by the backward kernel on the current stream. The
    frames as :func:`loss_forward` takes them, ``maps`` contiguous float32
    ``[3, H, W, 3]`` on their device."""
    _check("loss_backward", ("pred", pred), ("target", target))
    dev = pred.device
    if maps.dtype != torch.float32 or maps.device != dev or not maps.is_contiguous() or \
            maps.shape != (3, *pred.shape):
        raise ValueError(f"loss_backward: maps must be a contiguous float32 [3, {', '.join(map(str, pred.shape))}] "
                         f"tensor on {dev}, got {maps.dtype} {tuple(maps.shape)} on {maps.device}")
    grad_out = grad_out.to(dtype=torch.float32, device=dev).reshape(()).contiguous()
    l1_coef, ssim_coef = _coefficients(pred, ssim_weight)
    grad = torch.empty_like(pred)
    height, width, _ = pred.shape
    err = build.load_function("loss", "gsplat_loss_backward", _BWD_ARGTYPES)(
        pred.data_ptr(), target.data_ptr(), maps.data_ptr(), height, width, ctypes.addressof(_window_taps(dev)),
        grad_out.data_ptr(), l1_coef, ssim_coef, grad.data_ptr(), _stream(dev),
    )
    if err != 0:
        raise RuntimeError(f"loss backward kernel launch failed with cudaError_t {err}")
    return grad


class _Loss(torch.autograd.Function):
    """The forward kernel, its backward the backward kernel; saves the
    frames and the maps. The mean SSIM takes no gradient."""

    @staticmethod
    def forward(ctx, pred, target, ssim_weight):
        loss, mean_s, maps = loss_forward(pred, target, ssim_weight)
        ctx.save_for_backward(pred, target, maps)
        ctx.ssim_weight = ssim_weight
        ctx.mark_non_differentiable(mean_s)
        ctx.set_materialize_grads(False)  # no zeros launched for the mean SSIM's cotangent
        return loss, mean_s

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_loss, _):
        if grad_loss is None:
            return None, None, None
        pred, target, maps = ctx.saved_tensors
        return loss_backward(pred, target, maps, ctx.ssim_weight, grad_loss), None, None


def loss_autograd(pred: torch.Tensor, target: torch.Tensor,
                  ssim_weight: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss and the mean SSIM by the forward kernel, the loss
    differentiable with respect to ``pred`` through the backward kernel (one
    launch each way). Frames that are not contiguous are copied first."""
    return _Loss.apply(pred.contiguous(), target.contiguous(), float(ssim_weight))


def bytes_moved(height: int, width: int, channels: int = 3) -> int:
    """Bytes this design of the two kernels moves for one ``[H, W, C]``
    float32 frame pair: the forward reads the pair and writes the three
    maps, the backward reads the maps and the pair and writes the gradient.
    The function itself needs 5 frames (the pair each way and the gradient)
    where the backward recomputes the blurs, 572 FLOP a value in all."""
    frame = height * width * channels * 4
    return (2 + 3) * frame + (3 + 2 + 1) * frame
