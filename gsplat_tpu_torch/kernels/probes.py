"""Probe kernels: the wrappers of the Hopper counterparts of the TPU probes'
kernels, and their plain versions.

The TPU probes (``scripts/probe_transpose.py``, ``scripts/probe_lane_dma.py``
and ``scripts/orientation_test.py``) each ask one question of the hardware:
whether a transpose lowers, whether a dynamic lane-offset DMA lowers, and
how fast the compositor's chunk math runs in either register orientation.
Their counterparts here ask the same of the H100 (``tools/probe_transpose.py``,
``tools/probe_lane_dma.py``, ``tools/orientation_test.py``):

* ``transpose_smem``: ``[16, 128]`` or ``[128, 16]`` f32, transposed
  through shared memory (``t1_kernel``, ``t2_kernel``);
* ``transpose_block_async``: ``[nblk, 16, 128]`` -> ``[nblk, 128, 16]``,
  each slab brought in by one bulk copy on an mbarrier (``dma_kernel``);
* ``transpose_mma``: ``eye(128) . x^T`` of ``[16, 128]`` on the tensor
  cores in TF32, one pass or three (``mxu_t_kernel``);
* ``lane_dma``: ``out[:, s:s+128] = 2 x[:, s:s+128]`` for each start
  ``s`` of a ``[16, M]`` array, through TMA tensor maps (``kernel``);
* ``orientation_a`` / ``orientation_b``: the compositor's chunk math on a
  32x32 tile in both orientations (``kernel_a``, ``kernel_b``).

Every wrapper checks its arguments alike on both devices. On a CUDA tensor
it launches its kernel (``csrc/probe_transpose.cu``,
``csrc/probe_lane_dma.cu``, ``csrc/probe_orientation.cu``) on the current
stream and counts the launch in ``launches``; on a CPU tensor it runs its
plain version, which counts nothing. There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from gsplat_tpu_torch.kernels import build
from gsplat_tpu_torch.ops import binning as B
from gsplat_tpu_torch.ops.compositing import MAX_GAUSSIAN_DENSITY_F32, MIN_ALPHA_F32, gaussian_alpha

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

SLAB = (16, 128)  # the TPU probes' block: 16 sublanes x 128 lanes
EDGE = 32  # the orientation probes' tile edge
NPIX = EDGE * EDGE
PAIRS_A = 32  # pairs a chunk of orientation A ([32, 128] block, a pair a row)
PAIRS_B = 128  # pairs a chunk of orientation B ([16, 128] block, a pair a column)
LANES = 32  # orientation B's sub-chunk: one pair a lane of a warp
OUT_ROWS = 8  # colour (3), T, zeros (4)
PLAIN_PAIRS = 1 << 13  # pairs the orientation plain versions take at once


def _require(who: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{who}: needs a contiguous float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {x.device}")


def _require_aligned(who: str, x: torch.Tensor) -> None:
    if x.data_ptr() % 16:
        raise ValueError(f"{who}: x must be 16-byte aligned")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, who: str) -> None:
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed with cudaError_t {err}")


# -- transposes (scripts/probe_transpose.py) --------------------------------


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """``x [R, C]`` transposed to ``[C, R]`` by a gather of its flat
    elements (``out[c, r] = x.flat[r * C + c]``)."""
    r, c = x.shape
    idx = torch.arange(r, device=x.device)[None, :] * c + torch.arange(c, device=x.device)[:, None]
    return x.reshape(-1)[idx]


def transpose_smem(x: torch.Tensor) -> torch.Tensor:
    """``x [16, 128]`` or ``[128, 16]`` f32 transposed (``t1_kernel`` /
    ``t2_kernel``), every 32-bit pattern unchanged: the shared-memory
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if tuple(x.shape) not in (SLAB, SLAB[::-1]):
        raise ValueError(f"transpose_smem: x must be {SLAB} or {SLAB[::-1]}, got {tuple(x.shape)}")
    _require("transpose_smem", x)
    if x.device.type == "cpu":
        return transpose_plain(x)
    _require_aligned("transpose_smem", x)
    out = torch.empty(x.shape[::-1], dtype=x.dtype, device=x.device)
    fn = build.load_function("probe_transpose", "gsplat_probe_transpose_smem", (_P, _P, _I, _I, _P))
    _raise_on(fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], _stream(x)), "transpose_smem")
    transpose_smem.launches += 1
    return out


def transpose_block_plain(x: torch.Tensor) -> torch.Tensor:
    """``x [nblk, 16, 128]`` -> ``[nblk, 128, 16]``, each slab by
    :func:`transpose_plain`'s gather."""
    return torch.stack([transpose_plain(slab) for slab in x])


def transpose_block_async(x: torch.Tensor) -> torch.Tensor:
    """Each ``[16, 128]`` slab of ``x [nblk, 16, 128]`` transposed
    (``dma_kernel``): on a CUDA tensor one block a slab, brought into shared
    memory by one bulk copy on an mbarrier; the plain version on a CPU
    tensor."""
    if x.dim() != 3 or tuple(x.shape[1:]) != SLAB or x.shape[0] < 1:
        raise ValueError(f"transpose_block_async: x must be [nblk >= 1, 16, 128], got {tuple(x.shape)}")
    _require("transpose_block_async", x)
    if x.device.type == "cpu":
        return transpose_block_plain(x)
    _require_aligned("transpose_block_async", x)
    out = torch.empty((x.shape[0], *SLAB[::-1]), dtype=x.dtype, device=x.device)
    fn = build.load_function("probe_transpose", "gsplat_probe_transpose_block_async", (_P, _P, _I, _P))
    _raise_on(fn(x.data_ptr(), out.data_ptr(), x.shape[0], _stream(x)), "transpose_block_async")
    transpose_block_async.launches += 1
    return out


_EXP_BITS = 0x7F800000
_TF32_MASK = -0x2000  # keeps the top 19 bits of an f32 pattern: sign, exponent, 10 mantissa bits
_TINY_EXP = 64 << 23  # 3xTF32 splits an element below 2^-63 scaled by 2^64


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Finite f32 rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``'s rounding), on the int32 view: add
    half of the 13 dropped bits' unit to the magnitude, then clear them.
    Past TF32's largest value the carry gives inf."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & _TF32_MASK).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    return (x.contiguous().view(torch.int32) & _TF32_MASK).view(torch.float32)


def _exponent(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) & _EXP_BITS


def tf32_stage(x: torch.Tensor) -> torch.Tensor:
    """How the tensor-core kernel stages ``x`` in one-pass TF32: zeros and
    subnormals as +0, inf and NaN whole, every other element
    :func:`tf32_round`."""
    e = _exponent(x)
    staged = torch.where(e == _EXP_BITS, x, tf32_round(x))
    return torch.where(e == 0, torch.zeros_like(x), staged)


def tf32_split(x: torch.Tensor):
    """How the tensor-core kernel stages ``x`` in 3xTF32: ``(hi, mid, lo,
    unscale)`` with ``((hi + mid) + lo) * unscale == x`` for every finite
    normal ``x``, each part exact in TF32 and none subnormal. The split is
    by truncation (``hi`` the top 11 significant bits, ``mid`` the next 11,
    ``lo`` the last 2: no part overflows); an element below 2^-63 is split
    scaled by 2^64 and its ``unscale`` is 2^-64, else 1. Zeros and
    subnormals give +0 parts; inf and NaN pass whole into ``hi``, their
    other parts +0."""
    e = _exponent(x)
    normal = (e != 0) & (e != _EXP_BITS)
    tiny = normal & (e < _TINY_EXP)
    v = torch.where(normal, x, 0.0) * torch.where(tiny, 2.0**64, 1.0)  # exact
    hi = _tf32_trunc(v)
    r1 = v - hi  # exact: the low 13 bits
    mid = _tf32_trunc(r1)
    return torch.where(e == _EXP_BITS, x, hi), mid, r1 - mid, torch.where(tiny, 2.0**-64, 1.0)


def _eye_product(part: torch.Tensor) -> torch.Tensor:
    """``eye(128) . part^T`` for ``part [16, 128]`` as the f32 product gives
    it from a +0 accumulator: ``out[i, n] = 0 + sum_k eye[i, k] part[n, k]``,
    every term formed (``0 * inf`` and ``0 * NaN`` are NaN). Each element
    has one nonzero term, so it is ``part[n, i]`` exactly (``+0`` for a
    zero) where no other element of ``part[n]`` is inf or NaN, else NaN."""
    eye = torch.eye(part.shape[1], dtype=part.dtype, device=part.device)
    return (eye[:, None, :] * part[None, :, :]).sum(-1) + 0.0


def transpose_mma_plain(x: torch.Tensor, split3: bool) -> torch.Tensor:
    """The tensor-core kernel's function, ``eye(128) . x^T`` as staged: in
    one pass the product of :func:`tf32_stage`'s ``x`` (``split3`` False);
    in 3xTF32 the f32 sum ``(hi + mid) + lo`` of the products of
    :func:`tf32_split`'s parts, times each element's ``unscale`` (True),
    which is the product of ``x`` that ``mxu_t_kernel`` computes: ``x.T``
    for finite ``x``, with subnormals and ``-0.0`` read as +0, and NaN down
    a column of ``x.T`` that holds inf or NaN (inf where the inf is)."""
    if not split3:
        return _eye_product(tf32_stage(x))
    hi, mid, lo, unscale = tf32_split(x)
    return ((_eye_product(hi) + _eye_product(mid)) + _eye_product(lo)) * unscale.t()


def transpose_mma(x: torch.Tensor, split3: bool) -> torch.Tensor:
    """``eye(128) . x^T`` of ``x [16, 128]`` f32 (``mxu_t_kernel``): on a CUDA
    tensor ``mma.sync`` m16n8k8 in TF32, one pass or 3xTF32, over every
    k-step of the product, a block an output tile of 16 rows by 8 columns
    (two in one pass) whose warps share its k-steps; the plain version on a
    CPU tensor."""
    if tuple(x.shape) != SLAB:
        raise ValueError(f"transpose_mma: x must be {SLAB}, got {tuple(x.shape)}")
    _require("transpose_mma", x)
    if x.device.type == "cpu":
        return transpose_mma_plain(x, split3)
    _require_aligned("transpose_mma", x)
    out = torch.empty(SLAB[::-1], dtype=x.dtype, device=x.device)
    fn = build.load_function("probe_transpose", "gsplat_probe_transpose_mma", (_P, _P, _I, _P))
    _raise_on(fn(x.data_ptr(), out.data_ptr(), int(bool(split3)), _stream(x)), "transpose_mma")
    transpose_mma.launches += 1
    return out


# -- lane-slice DMA (scripts/probe_lane_dma.py) -------------------------------


def _check_starts(x: torch.Tensor, starts: Sequence[int]) -> list:
    if x.dim() != 2 or x.shape[0] != SLAB[0] or x.shape[1] % SLAB[1] or x.shape[1] == 0:
        raise ValueError(f"lane_dma: x must be [16, M] with M a positive multiple of 128, got {tuple(x.shape)}")
    starts = [int(s) for s in starts]
    bad = [s for s in starts if s % SLAB[1] or not 0 <= s < x.shape[1]]
    if not starts or bad:
        raise ValueError(f"lane_dma: starts must be multiples of 128 in [0, {x.shape[1]}), got {starts}")
    return starts


def lane_dma_plain(x: torch.Tensor, starts: Sequence[int]) -> torch.Tensor:
    """``out[:, s:s+128] = 2 * x[:, s:s+128]`` for each start; columns no
    start covers are left as allocated (as the TPU probe's output in HBM)."""
    out = torch.empty_like(x)
    for s in starts:
        out[:, s : s + SLAB[1]] = x[:, s : s + SLAB[1]] * 2.0
    return out


@functools.lru_cache(maxsize=None)
def _device_starts(starts: tuple, device: torch.device) -> torch.Tensor:
    """The starts as int32 on ``device``, copied there once for each set of
    starts, so that later launches (and a CUDA graph's capture of them) make
    no copy."""
    return torch.tensor(starts, dtype=torch.int32, device=device)


def lane_dma(x: torch.Tensor, starts: Sequence[int]) -> torch.Tensor:
    """The lane slices of ``x [16, M]`` f32 at ``starts`` (multiples of 128
    below M, known to the host as the TPU probe's scalar prefetch is),
    doubled into a new array (``scripts/probe_lane_dma.py::kernel``): on a
    CUDA tensor a TMA load and store per block through tensor maps, each
    block reading its start from device memory; the plain version on a CPU
    tensor."""
    starts = _check_starts(x, starts)
    _require("lane_dma", x)
    if x.device.type == "cpu":
        return lane_dma_plain(x, starts)
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("lane_dma: x must be 16-byte aligned")
    dev_starts = _device_starts(tuple(starts), x.device)
    fn = build.load_function("probe_lane_dma", "gsplat_probe_lane_dma", (_P, _P, _P, _I, _I, _P))
    _raise_on(fn(x.data_ptr(), out.data_ptr(), dev_starts.data_ptr(), x.shape[1], len(starts), _stream(x)),
              "lane_dma")
    lane_dma.launches += 1
    return out


# -- compositor orientations (scripts/orientation_test.py) --------------------


def chunk_scales(first: int, count: int, device) -> torch.Tensor:
    """``1 + 1e-6 * c`` in f32 for chunks ``c`` in ``[first, first + count)``,
    rounded as JAX's weak typing of ``1.0 + 1e-6 * c`` rounds it."""
    c = torch.arange(first, first + count, dtype=torch.float32, device=device)
    return 1.0 + c * torch.tensor(1e-6, dtype=torch.float32, device=device)


def gated_alpha(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Alpha of each pair row (``rows [..., 16]`` in the packed feature
    layout of ``ops/binning.py``, broadcast against the pixels ``px, py``)
    where the compositors' gate passes (alpha > 1/255, density <= 0, the
    half-open bbox), else 0."""

    def col(i):
        return rows[..., i]

    at = gaussian_alpha(px, py, col(B.FEAT_MEAN_X), col(B.FEAT_MEAN_Y), col(B.FEAT_CONIC_X),
                        col(B.FEAT_CONIC_Y), col(B.FEAT_CONIC_XY), col(B.FEAT_OPACITY))
    inside = (px >= col(B.FEAT_X_MIN)) & (px < col(B.FEAT_X_MAX)) & (py >= col(B.FEAT_Y_MIN)) & (py < col(B.FEAT_Y_MAX))
    return torch.where(at.valid & inside, at.alpha, 0.0)


def _pixels(device):
    lin = torch.arange(NPIX, device=device)
    return (lin % EDGE).to(torch.float32), (lin // EDGE).to(torch.float32)


def _chunk_rows(feat: torch.Tensor, first: int, count: int, orientation: str) -> torch.Tensor:
    """Chunks ``[first, first + count)``'s scaled pair rows: ``[count, 32,
    16]`` (A: the block's rows' first 16 features) or ``[count, 128, 16]``
    (B: the block's columns)."""
    rows = feat[:, :16] if orientation == "a" else feat.t()
    return rows[None] * chunk_scales(first, count, feat.device)[:, None, None]


def orientation_passed(feat: torch.Tensor, reps: int, orientation: str) -> int:
    """The pair-pixels of an orientation probe's walk that pass the gate."""
    px, py = _pixels(feat.device)
    passed = 0
    for first, count in _batches(reps, orientation):
        rows = _chunk_rows(feat, first, count, orientation).reshape(-1, 1, 16)
        passed += int((gated_alpha(rows, px, py) > 0).sum())
    return passed


def _batches(reps: int, orientation: str):
    """(first chunk, chunks) of the plain versions' batches of about
    ``PLAIN_PAIRS`` pairs."""
    step = PLAIN_PAIRS // (PAIRS_A if orientation == "a" else PAIRS_B)
    return [(first, min(step, reps - first)) for first in range(0, reps, step)]


def _check_orientation(who: str, feat: torch.Tensor, shape, reps: int) -> None:
    if tuple(feat.shape) != shape:
        raise ValueError(f"{who}: feat must be {shape}, got {tuple(feat.shape)}")
    _require(who, feat)
    if reps < 0:
        raise ValueError(f"{who}: reps must be >= 0, got {reps}")


def orientation_a_plain(feat: torch.Tensor, reps: int, t0: float) -> torch.Tensor:
    """Orientation A's function: ``reps`` chunks of the 32 pair rows of
    ``feat [32, 128]`` (chunk c scaled by ``1 + 1e-6 c``), composited front to
    back at the 1024 pixels of a 32x32 tile from colour 0 and T ``t0``.
    Returns ``[8, 1024]``: colour, T, zeros. T before each pair is the
    running product of ``1 - a`` (a ``cumprod`` down the pairs, which on the
    card multiplies in order, as the kernel does), and the colour the
    running sum of ``rgb * (a * T)`` (``cumsum``, likewise), ``PLAIN_PAIRS``
    pairs at once."""
    px, py = _pixels(feat.device)
    trans = torch.full((NPIX,), float(t0), dtype=torch.float32, device=feat.device)
    color = torch.zeros((NPIX, 3), dtype=torch.float32, device=feat.device)
    for first, count in _batches(reps, "a"):
        rows = _chunk_rows(feat, first, count, "a").reshape(-1, 1, 16)  # [P, 1, 16]
        a = gated_alpha(rows, px, py)  # [P, 1024]
        t_run = torch.cat([trans[None], 1.0 - a]).cumprod(0)  # T before pair k, then after the last
        terms = rows[:, :, B.FEAT_R : B.FEAT_B + 1] * (a * t_run[:-1])[..., None]  # [P, 1024, 3]
        color = torch.cat([color[None], terms]).cumsum(0)[-1]
        trans = t_run[-1]
    zeros = torch.zeros((OUT_ROWS - 4, NPIX), dtype=torch.float32, device=feat.device)
    return torch.cat([color.t(), trans[None], zeros])


def orientation_a(feat: torch.Tensor, reps: int, t0: float) -> torch.Tensor:
    """Orientation A (``scripts/orientation_test.py::kernel_a``; pairs in
    sequence, one thread a pixel): on a CUDA tensor one block of 1024
    threads walking each chunk's staged rows through the compositors' gate;
    the plain version on a CPU tensor. ``feat [32, 128]`` f32; returns
    ``[8, 1024]``."""
    _check_orientation("orientation_a", feat, (PAIRS_A, 128), reps)
    if feat.device.type == "cpu":
        return orientation_a_plain(feat, reps, t0)
    return _launch_orientation(orientation_a, "gsplat_probe_orientation_a", feat, reps, t0, (OUT_ROWS, NPIX))


def orientation_b_plain(feat: torch.Tensor, reps: int, t0: float) -> torch.Tensor:
    """Orientation B's function: ``reps`` chunks of the 128 pairs of ``feat
    [16, 128]`` (a pair a column, chunk c scaled by ``1 + 1e-6 c``) as sub-chunks
    of 32, composited at the 1024 pixels from colour 0 and T ``t0`` as the
    kernel does: per sub-chunk the Hillis-Steele product of ``1 - a`` across
    the 32 pairs (exclusive: ``t_excl``), ``w = (a * t_excl) * T``, colour
    sums by xor butterflies over the 32, T times the sub-chunk's product.
    Returns ``[1024, 8]``: colour, T, zeros."""
    px, py = _pixels(feat.device)
    px, py = px[:, None], py[:, None]  # [1024, 1] against the lanes
    trans = torch.full((NPIX,), float(t0), dtype=torch.float32, device=feat.device)
    color = torch.zeros((NPIX, 3), dtype=torch.float32, device=feat.device)
    lane = torch.arange(LANES, device=feat.device)
    for first, count in _batches(reps, "b"):
        rows = _chunk_rows(feat, first, count, "b").reshape(-1, 1, LANES, 16)  # [S, 1, 32, 16]
        a = gated_alpha(rows, px, py)  # [S, 1024, 32]
        y = 1.0 - a
        s = 1
        while s < LANES:
            y = y * torch.cat([torch.ones_like(y[..., :s]), y[..., :-s]], dim=-1)
            s *= 2
        t_excl = torch.cat([torch.ones_like(y[..., :1]), y[..., :-1]], dim=-1)
        t_start = torch.cat([trans[None], y[..., -1]]).cumprod(0)  # T before each sub-chunk, then after the last
        w = (a * t_excl) * t_start[:-1, :, None]
        v = w[..., None] * rows[:, :, :, B.FEAT_R : B.FEAT_B + 1]  # [S, 1024, 32, 3]
        m = LANES // 2
        while m > 0:
            v = v + v[:, :, lane ^ m]
            m //= 2
        color = torch.cat([color[None], v[:, :, 0]]).cumsum(0)[-1]
        trans = t_start[-1]
    zeros = torch.zeros((NPIX, OUT_ROWS - 4), dtype=torch.float32, device=feat.device)
    return torch.cat([color, trans[:, None], zeros], dim=1)


def orientation_b(feat: torch.Tensor, reps: int, t0: float) -> torch.Tensor:
    """Orientation B (``scripts/orientation_test.py::kernel_b``; pairs
    across a warp's lanes, a shuffle scan): on a CUDA tensor one block of
    1024 threads, warp w owning pixels ``[32w, 32w + 32)``; the plain
    version on a CPU tensor. ``feat [16, 128]`` f32; returns ``[1024, 8]``."""
    _check_orientation("orientation_b", feat, (16, PAIRS_B), reps)
    if feat.device.type == "cpu":
        return orientation_b_plain(feat, reps, t0)
    return _launch_orientation(orientation_b, "gsplat_probe_orientation_b", feat, reps, t0, (NPIX, OUT_ROWS))


def _launch_orientation(wrapper, symbol: str, feat: torch.Tensor, reps: int, t0: float, out_shape) -> torch.Tensor:
    out = torch.empty(out_shape, dtype=torch.float32, device=feat.device)
    fn = build.load_function("probe_orientation", symbol, (_P, _I, _F, _F, _F, _P, _P))
    err = fn(feat.data_ptr(), int(reps), float(t0), MIN_ALPHA_F32, MAX_GAUSSIAN_DENSITY_F32, out.data_ptr(),
             _stream(feat))
    _raise_on(err, wrapper.__name__)
    wrapper.launches += 1
    return out


# Kernel launches since each count was last reset.
transpose_smem.launches = 0
transpose_block_async.launches = 0
transpose_mma.launches = 0
lane_dma.launches = 0
orientation_a.launches = 0
orientation_b.launches = 0
