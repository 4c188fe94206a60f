"""Per-gaussian preprocess, forward and backward: the CUDA kernels' wrappers,
their autograd Function and their plain versions.

``preprocess_forward`` computes, for one camera, everything the binner and
the compositors read of each gaussian (``ops/projection.py``
:class:`Preprocessed`): the colour of ``ops/sh.py::sh_to_rgb`` and the
projection, conic, bboxes and active flag of
``ops/projection.py::preprocess_gaussians_from_params``, with the viewspace
probe's screen offset where one is given, by one launch of the hand-written
kernel ``csrc/preprocess.cu``. ``preprocess_backward`` takes the cotangents
of the pixel means, conics and colours and gives the gradients of the
means, activated scales, raw quaternions and SH coefficients by one launch
of that file's second kernel, which recomputes the forward in registers.
:func:`preprocess_autograd` joins the two in one autograd Function that
saves only its inputs. :func:`preprocess_plain` is their plain version,
those two eager functions as they are, and its autograd the backward's
(:func:`preprocess_backward_plain`). There is no fallback from one to the
other: each wrapper launches its kernel or raises.

The kernels replace no TPU kernel (the JAX package leaves this elementwise
work to XLA, and its gradient to ``jax.grad``). ``render/pipeline.py::
preprocess_traced`` takes them where :func:`takes_kernel` holds, with or
without a gradient and a screen offset, and runs :func:`preprocess_plain`,
the eager autograd path, otherwise (the CPU). On the card every forward
output but ``rgb`` is bitwise the eager path's (:func:`same_bits`); ``rgb``
differs by the order of its sums, within ``RGB_ATOL``, and the gradients by
the order of theirs. ``opacity`` is the tensor passed in, outside the
Function: its gradient is autograd's.

Their bound is bytes. The forward's: 305 a gaussian at SH degree 3 (236
read, 69 written), 1.525 GB and 0.455 ms at 3.35 TB/s for 5M gaussians
(``bytes_moved``). The backward's: 496 (264 read, 232 written), 2.48 GB
and 0.740 ms (``bytes_moved_backward``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from gsplat_tpu_torch.kernels import build
from gsplat_tpu_torch.ops.camera import CameraArrays
from gsplat_tpu_torch.ops.projection import Preprocessed, preprocess_gaussians_from_params
from gsplat_tpu_torch.ops.sh import sh_to_rgb
from gsplat_tpu_torch.utils import stages

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (
    _P, _P, _P, _P, _P, _I,  # means, scales, quats, opacity, sh, sh_row4
    _P, _P, _P, _P, _P, _P,  # w2c_t, full_proj_t, cam_center, tan_fov, focal, screen_offset
    _I, _I, _I, _I, _I,  # n, width, height, degree, strict_parity
    _P, _P, _P, _P, _P, _P, _P, _P,  # screen_means, conics, rgb, depth, bbox, cull_bbox, active, stream
)
_BWD_ARGTYPES = (
    _P, _P, _P, _P, _I,  # means, scales, quats, sh, sh_row4
    _P, _P, _P, _P, _P,  # w2c_t, full_proj_t, cam_center, tan_fov, focal
    _I, _I, _I, _I,  # n, width, height, degree
    _P, _L, _P, _L, _P, _L,  # the cotangents of screen_means, conics, rgb, each with its row stride
    _P, _P, _P, _P, _P,  # the gradients of means, scales, quats, sh; stream
)
_CAMERA_SHAPES = {"w2c_t": (4, 4), "full_proj_t": (4, 4), "cam_center": (3,), "tan_fov": (2,), "focal": (2,)}

# rgb sums its dot product of up to 16 products a channel in another order
# than the eager path, after a view direction normalised by another
# reduction: each of the 16 roundings is at most half an ulp of a partial
# sum below 8 (6e-8 * 8 * 16 = 7.7e-6).
RGB_ATOL = 1e-5


def needs_grad(tensors: Sequence[Optional[torch.Tensor]]) -> bool:
    """Whether autograd records a function of these tensors (None skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def takes_kernel(inputs: Sequence[torch.Tensor], cam: Sequence[torch.Tensor],
                 screen_offset: Optional[torch.Tensor] = None) -> bool:
    """Whether a preprocess of these inputs (the model's tensors), camera and
    screen offset takes the kernels: all CUDA float32, with or without a
    gradient and an offset, but no gradient to take with respect to the
    camera, which the backward kernel does not compute. Any other call takes
    the eager autograd path."""
    tensors = (*inputs, *cam, *(() if screen_offset is None else (screen_offset,)))
    return all(t.device.type == "cuda" and t.dtype == torch.float32 for t in tensors) and not needs_grad(cam)


def preprocess_plain(
    means: torch.Tensor,
    sh: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacity: torch.Tensor,
    cam: CameraArrays,
    width: int,
    height: int,
    sh_degree: int,
    strict_parity: bool,
    screen_offset: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """The kernel's function in plain PyTorch, differentiable: the SH colour
    (``sh_to_rgb``), then ``preprocess_gaussians_from_params``."""
    rgb = sh_to_rgb(means, sh, cam.cam_center, degree=sh_degree)
    return preprocess_gaussians_from_params(
        means=means,
        scales=scales,
        quats=quats,
        opacity=opacity,
        rgb=rgb,
        w2c_t=cam.w2c_t,
        full_proj_t=cam.full_proj_t,
        tan_fov_x=cam.tan_fov[0],
        tan_fov_y=cam.tan_fov[1],
        focal_x=cam.focal[0],
        focal_y=cam.focal[1],
        width=width,
        height=height,
        strict_parity=strict_parity,
        screen_offset=screen_offset,
    )


def _check(who: str, means, sh, quats, scales, cam, width: int, height: int, sh_degree: int,
           more: Sequence[Tuple[str, torch.Tensor, tuple]] = ()) -> None:
    """Raise unless the kernels take these tensors: contiguous float32 CUDA
    tensors on one device, of the shapes the wrappers' docstrings give, and
    ``more``'s (name, tensor, shape) likewise."""
    dev = means.device
    n = means.shape[0]
    named = [("means", means, (n, 3)), ("sh", sh, None), ("quats", quats, (n, 4)), ("scales", scales, (n, 3)),
             *((name, getattr(cam, name), shape) for name, shape in _CAMERA_SHAPES.items()), *more]
    for name, t, _ in named:
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous float32 tensor on {dev}, got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{who}: unsupported device {dev}")
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got {sh_degree}")
    for name, t, shape in named:
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{who}: {name} must be {shape}, got {tuple(t.shape)}")
    if (sh.dim() != 3 or sh.shape[0] != n or sh.shape[2] != 3 or sh.shape[1] < (sh_degree + 1) ** 2
            or sh.shape[1] % 4):
        raise ValueError(f"{who}: sh must be [{n}, K, 3] with K >= {(sh_degree + 1) ** 2} and a multiple of 4, "
                         f"got {tuple(sh.shape)}")
    if sh.data_ptr() % 16 or quats.data_ptr() % 16:
        raise ValueError(f"{who}: sh and quats must be 16-byte aligned")
    if n >= 2**31 or width < 1 or height < 1:
        raise ValueError(f"{who}: needs fewer than 2**31 gaussians and a positive frame, got {n}, {width}x{height}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def preprocess_forward(
    means: torch.Tensor,
    sh: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacity: torch.Tensor,
    cam: CameraArrays,
    width: int,
    height: int,
    sh_degree: int,
    strict_parity: bool,
    screen_offset: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """The preprocess of one camera by the CUDA kernel, on the current
    stream (no launch for no gaussians), recording no gradient; counts the
    launch on ``preprocess_forward``. Takes means ``[N, 3]``, SH ``[N, K,
    3]`` (K at least ``(sh_degree + 1)**2`` and ``3 K`` a multiple of 4),
    raw quaternions ``[N, 4]``, activated scales ``[N, 3]``, opacity ``[N]``
    and, where given, the screen offset ``[N, 2]``: contiguous float32 CUDA
    tensors on one device, ``sh`` and ``quats`` 16-byte aligned. Raises on
    anything else, CPU tensors included."""
    n = means.shape[0]
    more = [("opacity", opacity, (n,))]
    if screen_offset is not None:
        more.append(("screen_offset", screen_offset, (n, 2)))
    _check("preprocess_forward", means, sh, quats, scales, cam, width, height, sh_degree, more)
    dev = means.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    screen_means, conics, rgb, depth = empty(n, 2), empty(n, 3), empty(n, 3), empty(n)
    bbox, cull_bbox = empty(n, 4, dtype=torch.int32), empty(n, 4, dtype=torch.int32)
    active = empty(n, dtype=torch.bool)
    if n:
        err = build.load_function("preprocess", "gsplat_preprocess", _ARGTYPES)(
            means.data_ptr(), scales.data_ptr(), quats.data_ptr(), opacity.data_ptr(), sh.data_ptr(),
            sh.shape[1] * 3 // 4, *(getattr(cam, name).data_ptr() for name in _CAMERA_SHAPES),
            None if screen_offset is None else screen_offset.data_ptr(), n, width, height, sh_degree,
            int(strict_parity), screen_means.data_ptr(), conics.data_ptr(), rgb.data_ptr(), depth.data_ptr(),
            bbox.data_ptr(), cull_bbox.data_ptr(), active.data_ptr(), _stream(dev),
        )
        if err != 0:
            raise RuntimeError(f"preprocess kernel launch failed with cudaError_t {err}")
        preprocess_forward.launches += 1
    return Preprocessed(screen_means, conics, rgb, opacity, depth, bbox, cull_bbox, active)


def preprocess_backward(
    means: torch.Tensor,
    sh: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    cam: CameraArrays,
    width: int,
    height: int,
    sh_degree: int,
    v_screen_means: torch.Tensor,
    v_conics: torch.Tensor,
    v_rgb: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of means ``[N, 3]``, SH ``[N, K, 3]`` (zeros past the
    degree's coefficients), raw quaternions ``[N, 4]`` and activated scales
    ``[N, 3]`` from the cotangents of :func:`preprocess_forward`'s screen
    means ``[N, 2]``, conics ``[N, 3]`` and colours ``[N, 3]``, by the
    backward kernel on the current stream (no launch for no gaussians);
    counts the launch on ``preprocess_backward``. The inputs as
    :func:`preprocess_forward` takes them; each cotangent float32 on their
    device with contiguous columns (a column slice of a wider row, as
    autograd hands them over, is read in place; another is copied first)."""
    n = means.shape[0]
    cotangents = []
    for name, v, k in (("v_screen_means", v_screen_means, 2), ("v_conics", v_conics, 3), ("v_rgb", v_rgb, 3)):
        if v.dtype != torch.float32 or v.device != means.device or tuple(v.shape) != (n, k):
            raise ValueError(f"preprocess_backward: {name} must be a float32 [{n}, {k}] tensor on {means.device}, "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
        cotangents.append(v if v.stride(1) == 1 else v.contiguous())
    _check("preprocess_backward", means, sh, quats, scales, cam, width, height, sh_degree)
    g_means, g_sh, g_quats, g_scales = (torch.empty_like(t) for t in (means, sh, quats, scales))
    if n:
        err = build.load_function("preprocess", "gsplat_preprocess_backward", _BWD_ARGTYPES)(
            means.data_ptr(), scales.data_ptr(), quats.data_ptr(), sh.data_ptr(), sh.shape[1] * 3 // 4,
            *(getattr(cam, name).data_ptr() for name in _CAMERA_SHAPES), n, width, height, sh_degree,
            *(x for v in cotangents for x in (v.data_ptr(), v.stride(0))),
            g_means.data_ptr(), g_scales.data_ptr(), g_quats.data_ptr(), g_sh.data_ptr(), _stream(means.device),
        )
        if err != 0:
            raise RuntimeError(f"preprocess backward kernel launch failed with cudaError_t {err}")
        preprocess_backward.launches += 1
    return g_means, g_sh, g_quats, g_scales


def preprocess_backward_plain(
    means: torch.Tensor,
    sh: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    cam: CameraArrays,
    width: int,
    height: int,
    sh_degree: int,
    v_screen_means: torch.Tensor,
    v_conics: torch.Tensor,
    v_rgb: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch: autograd through
    :func:`preprocess_plain` (the opacity, which moves no float output, at
    1)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (means, sh, quats, scales)]
        prep = preprocess_plain(*leaves, means.new_ones(means.shape[0]), cam, width, height, sh_degree, True)
        grads = torch.autograd.grad((prep.screen_means, prep.conics, prep.rgb), leaves,
                                    (v_screen_means, v_conics, v_rgb))
    return grads[0], grads[1], grads[2], grads[3]


class _Preprocess(torch.autograd.Function):
    """The forward kernel, its backward the backward kernel; saves only the
    inputs. The screen offset's gradient is the screen means' cotangent; a
    depth cotangent reaches the means through ``w2c_t``'s depth column."""

    @staticmethod
    def forward(ctx, means, sh, quats, scales, opacity, screen_offset, w2c_t, full_proj_t, cam_center, tan_fov,
                focal, width, height, sh_degree, strict_parity):
        cam = CameraArrays(w2c_t, full_proj_t, cam_center, tan_fov, focal)
        prep = preprocess_forward(means, sh, quats, scales, opacity, cam, width, height, sh_degree, strict_parity,
                                  screen_offset)
        ctx.save_for_backward(means, sh, quats, scales, *cam)
        ctx.frame = (width, height, sh_degree)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(prep.bbox, prep.cull_bbox, prep.active)
        return prep.screen_means, prep.conics, prep.rgb, prep.depth, prep.bbox, prep.cull_bbox, prep.active

    @staticmethod
    @once_differentiable
    def backward(ctx, v_screen_means, v_conics, v_rgb, v_depth, *_):
        means, sh, quats, scales, *cam = ctx.saved_tensors
        cam = CameraArrays(*cam)
        n = means.shape[0]
        v = [x if x is not None else means.new_zeros((n, k))
             for x, k in ((v_screen_means, 2), (v_conics, 3), (v_rgb, 3))]
        g_means, g_sh, g_quats, g_scales = preprocess_backward(means, sh, quats, scales, cam, *ctx.frame, *v)
        stages.count("preprocess_bwd_kernel", 1)
        if v_depth is not None:  # depth = means @ w2c_t[:3, 2] + w2c_t[3, 2]
            g_means += v_depth[:, None] * cam.w2c_t[:3, 2]
        g_offset = v_screen_means if ctx.needs_input_grad[5] else None
        return (g_means, g_sh, g_quats, g_scales, None, g_offset) + (None,) * 9


def preprocess_autograd(
    means: torch.Tensor,
    sh: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacity: torch.Tensor,
    cam: CameraArrays,
    width: int,
    height: int,
    sh_degree: int,
    strict_parity: bool,
    screen_offset: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """:func:`preprocess_forward` differentiable with respect to the means,
    SH, quaternions, scales and screen offset through the backward kernel
    (one launch each way). ``opacity`` is the tensor passed in."""
    out = _Preprocess.apply(means, sh, quats, scales, opacity.detach(), screen_offset, *cam, width, height,
                            sh_degree, strict_parity)
    screen_means, conics, rgb, depth, bbox, cull_bbox, active = out
    return Preprocessed(screen_means, conics, rgb, opacity, depth, bbox, cull_bbox, active)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (floats by their bits, so -0.0 differs
    from 0.0), NaN where the other has NaN: what the kernel's outputs but
    ``rgb`` are held to against :func:`preprocess_plain`."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b) and torch.equal(a.view(torch.int32)[~nan_a], b.view(torch.int32)[~nan_b]))


def bytes_moved(n: int, sh_degree: int) -> int:
    """Bytes the forward kernel needs to move for ``n`` gaussians: means,
    scales, quats, opacity and the SH coefficients of ``sh_degree`` read;
    screen means, conic, rgb, depth, both bboxes and the active flag
    written."""
    read = (3 + 3 + 4 + 1 + (sh_degree + 1) ** 2 * 3) * 4
    written = (2 + 3 + 3 + 1 + 4 + 4) * 4 + 1
    return n * (read + written)


def bytes_moved_backward(n: int, sh_degree: int, sh_coeffs: int = 16) -> int:
    """Bytes the backward kernel needs to move for ``n`` gaussians: means,
    scales, quats and the SH coefficients of ``sh_degree`` read, with the
    cotangents of the screen means, conic and rgb; the gradients of means,
    scales, quats and all ``sh_coeffs`` SH coefficients (zeros past the
    degree) written."""
    read = (3 + 3 + 4 + (sh_degree + 1) ** 2 * 3 + 2 + 3 + 3) * 4
    written = (3 + 3 + 4 + sh_coeffs * 3) * 4
    return n * (read + written)


preprocess_forward.launches = 0  # kernel launches since the count was last reset
preprocess_backward.launches = 0
