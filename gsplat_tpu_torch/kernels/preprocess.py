"""Per-gaussian preprocess forward: the CUDA kernel's wrapper and its plain
version.

``preprocess_forward`` computes, for one camera, everything the binner and
the compositors read of each gaussian (``ops/projection.py``
:class:`Preprocessed`): the colour of ``ops/sh.py::sh_to_rgb`` and the
projection, conic, bboxes and active flag of
``ops/projection.py::preprocess_gaussians_from_params``, by one launch of
the hand-written kernel ``csrc/preprocess.cu``. :func:`preprocess_plain` is
its plain version, those two functions as they are. There is no fallback
from one to the other: ``preprocess_forward`` launches the kernel or raises.

The kernel replaces no TPU kernel (the JAX package leaves this elementwise
work to XLA) and takes no gradient, so ``render/pipeline.py::
preprocess_traced`` takes it only where :func:`takes_kernel` holds and runs
:func:`preprocess_plain`, the eager autograd path, otherwise. On the card
every output but ``rgb`` is bitwise the eager path's (:func:`same_bits`);
``rgb`` differs by the order of its sums, within ``RGB_ATOL``. ``opacity``
is the tensor passed in.

Its bound is bytes: 305 a gaussian at SH degree 3 (236 read, 69 written),
1.525 GB and 0.455 ms at 3.35 TB/s for 5M gaussians (``bytes_moved``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from gsplat_tpu_torch.kernels import build
from gsplat_tpu_torch.ops.camera import CameraArrays
from gsplat_tpu_torch.ops.projection import Preprocessed, preprocess_gaussians_from_params
from gsplat_tpu_torch.ops.sh import sh_to_rgb

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (
    _P, _P, _P, _P, _P, _I,  # means, scales, quats, opacity, sh, sh_row4
    _P, _P, _P, _P, _P,  # w2c_t, full_proj_t, cam_center, tan_fov, focal
    _I, _I, _I, _I, _I,  # n, width, height, degree, strict_parity
    _P, _P, _P, _P, _P, _P, _P, _P,  # screen_means, conics, rgb, depth, bbox, cull_bbox, active, stream
)
_CAMERA_SHAPES = {"w2c_t": (4, 4), "full_proj_t": (4, 4), "cam_center": (3,), "tan_fov": (2,), "focal": (2,)}

# rgb sums its dot product of up to 16 products a channel in another order
# than the eager path, after a view direction normalised by another
# reduction: each of the 16 roundings is at most half an ulp of a partial
# sum below 8 (6e-8 * 8 * 16 = 7.7e-6).
RGB_ATOL = 1e-5


def takes_kernel(tensors: Sequence[torch.Tensor], screen_offset: Optional[torch.Tensor] = None) -> bool:
    """Whether a preprocess of these inputs (the model's and the camera's
    tensors) takes the kernel: all CUDA float32, no ``screen_offset`` and no
    gradient to take. The kernel computes no gradient, so any other call
    takes the eager autograd path."""
    return (
        screen_offset is None
        and all(t.device.type == "cuda" and t.dtype == torch.float32 for t in tensors)
        and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))
    )


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
) -> Preprocessed:
    """The preprocess of one camera by the CUDA kernel, on the current
    stream (no launch for no gaussians); counts the launch on
    ``preprocess_forward``. Takes means ``[N, 3]``, SH ``[N, K, 3]`` (K at
    least ``(sh_degree + 1)**2`` and ``3 K`` a multiple of 4), raw
    quaternions ``[N, 4]``, activated scales ``[N, 3]`` and opacity ``[N]``:
    contiguous float32 CUDA tensors on one device, ``sh`` and ``quats``
    16-byte aligned. Raises on anything else, CPU tensors included."""
    who = "preprocess_forward"
    dev = means.device
    named = [("means", means), ("sh", sh), ("quats", quats), ("scales", scales), ("opacity", opacity),
             *((name, getattr(cam, name)) for name in _CAMERA_SHAPES)]
    for name, t in named:
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous float32 tensor on {dev}, got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{who}: unsupported device {dev}")
    n = means.shape[0]
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got {sh_degree}")
    shapes = {"means": (n, 3), "quats": (n, 4), "scales": (n, 3), "opacity": (n,), **_CAMERA_SHAPES}
    for name, t in named:
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{who}: {name} must be {shapes[name]}, got {tuple(t.shape)}")
    if (sh.dim() != 3 or sh.shape[0] != n or sh.shape[2] != 3 or sh.shape[1] < (sh_degree + 1) ** 2
            or sh.shape[1] % 4):
        raise ValueError(f"{who}: sh must be [{n}, K, 3] with K >= {(sh_degree + 1) ** 2} and a multiple of 4, "
                         f"got {tuple(sh.shape)}")
    if sh.data_ptr() % 16 or quats.data_ptr() % 16:
        raise ValueError(f"{who}: sh and quats must be 16-byte aligned")
    if n >= 2**31 or width < 1 or height < 1:
        raise ValueError(f"{who}: needs fewer than 2**31 gaussians and a positive frame, got {n}, {width}x{height}")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    screen_means, conics, rgb, depth = empty(n, 2), empty(n, 3), empty(n, 3), empty(n)
    bbox, cull_bbox = empty(n, 4, dtype=torch.int32), empty(n, 4, dtype=torch.int32)
    active = empty(n, dtype=torch.bool)
    if n:
        err = build.load_function("preprocess", "gsplat_preprocess", _ARGTYPES)(
            means.data_ptr(), scales.data_ptr(), quats.data_ptr(), opacity.data_ptr(), sh.data_ptr(),
            sh.shape[1] * 3 // 4, *(getattr(cam, name).data_ptr() for name in _CAMERA_SHAPES),
            n, width, height, sh_degree, int(strict_parity),
            screen_means.data_ptr(), conics.data_ptr(), rgb.data_ptr(), depth.data_ptr(), bbox.data_ptr(),
            cull_bbox.data_ptr(), active.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"preprocess kernel launch failed with cudaError_t {err}")
        preprocess_forward.launches += 1
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
    """Bytes the kernel needs to move for ``n`` gaussians: means, scales,
    quats, opacity and the SH coefficients of ``sh_degree`` read; screen
    means, conic, rgb, depth, both bboxes and the active flag written."""
    read = (3 + 3 + 4 + 1 + (sh_degree + 1) ** 2 * 3) * 4
    written = (2 + 3 + 3 + 1 + 4 + 4) * 4 + 1
    return n * (read + written)


preprocess_forward.launches = 0  # kernel launches since the count was last reset
