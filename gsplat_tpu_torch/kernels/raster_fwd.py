"""Forward tile compositor: the CUDA kernel's wrapper and its plain version.

``forward_tiles`` composites binned gaussians into per-tile pixel slabs. On
a CUDA tensor it launches the hand-written kernel ``csrc/raster_fwd.cu``
(which replaces the TPU kernel ``gsplat_tpu/kernels/raster_fwd.py::
_fwd_kernel``); on a CPU tensor it runs ``forward_tiles_plain``, the same
function in plain PyTorch. There is no fallback from one to the other: a
CUDA tensor launches the kernel or raises.

Both produce per tile: color ``[T, npix, 3]``, final transmittance
``[T, npix]`` and ``blocks_done [T]`` int32 (pair blocks composited before
the early stop; ``ceil(count / pair_block)`` when early stop is off), with
the TPU kernel's block-granular early stop on coverable pixels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.kernels import build
from gsplat_tpu_torch.ops import binning as B
from gsplat_tpu_torch.ops.compositing import MAX_GAUSSIAN_DENSITY_F32, MIN_ALPHA_F32, gaussian_alpha
from gsplat_tpu_torch.render.tile_torch import tile_pixel_coords

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (
    _P, _P, _P, _P, _P,  # feat, pair_gaussian, tile_start, tile_count, tile_ids
    _I, _I, _I, _I,  # num_tiles, n_tiles_x, tile_size, pair_block
    _F, _I, _I, _F, _F,  # early_stop, width, height, min_alpha, max_alpha
    _P, _P, _P, _P,  # color, trans, blocks_done, stream
)
_MAX_THREADS = 1024
_MAX_SMEM = 48 * 1024  # dynamic shared memory a launch gets without opting in


def forward_tiles_plain(
    feat: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tile_ids: torch.Tensor,
    n_tiles_x: int,
    cfg: RasterConfig,
    width: int = 0,
    height: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, vectorized over tiles.

    Walks pair blocks up to the largest tile's count (one host sync for that
    count). Within a block, alphas are evaluated ``chunk_size`` pairs at a
    time and composited pair by pair in the kernel's order
    (``C += rgb * (alpha * T)``, then ``T *= 1 - alpha``). A tile that is
    done, or a pair slot past its tile's count, composites alpha 0, which
    leaves color and T bitwise unchanged.
    """
    dev, dtype = feat.device, feat.dtype
    ts, cs, blk = cfg.tile_size, cfg.chunk_size, cfg.pair_block
    num_t = tile_ids.shape[0]
    px, py = tile_pixel_coords(tile_ids, n_tiles_x, ts, dtype)  # [T, npix]
    color = torch.zeros((num_t, ts * ts, 3), dtype=dtype, device=dev)
    trans = torch.ones((num_t, ts * ts), dtype=dtype, device=dev)
    start = tile_start.long()
    count = tile_count.long()
    nblocks = -(-count // blk)
    blocks_done = torch.zeros(num_t, dtype=torch.int64, device=dev)
    running = torch.ones(num_t, dtype=torch.bool, device=dev)
    if width > 0 and height > 0:
        coverable = (px < width - 1) & (py < height - 1)
    else:
        coverable = torch.ones_like(px, dtype=torch.bool)
    pairs = pair_gaussian.long()
    sentinel = feat.shape[0] - 1
    lane = torch.arange(cs, device=dev)
    pxc, pyc = px[:, None, :], py[:, None, :]
    max_blocks = int(nblocks.max()) if num_t else 0
    for b in range(max_blocks):
        live = running & (b < nblocks)
        for c in range(0, blk, cs):
            k = b * blk + c + lane  # [cs] slot within the tile
            in_tile = live[:, None] & (k[None, :] < count[:, None])  # [T, cs]
            slot = torch.where(in_tile, start[:, None] + k[None, :], 0)
            f = feat[torch.where(in_tile, pairs[slot], sentinel)]  # [T, cs, 16]

            def col(i):
                return f[:, :, i, None]

            alpha, valid = gaussian_alpha(
                pxc, pyc, col(B.FEAT_MEAN_X), col(B.FEAT_MEAN_Y),
                col(B.FEAT_CONIC_X), col(B.FEAT_CONIC_Y), col(B.FEAT_CONIC_XY),
                col(B.FEAT_OPACITY),
            )
            inside = (
                (pxc >= col(B.FEAT_X_MIN)) & (pxc < col(B.FEAT_X_MAX))
                & (pyc >= col(B.FEAT_Y_MIN)) & (pyc < col(B.FEAT_Y_MAX))
            )
            a = torch.where(valid & inside, alpha, 0.0)  # [T, cs, npix]
            rgb = f[:, :, B.FEAT_R : B.FEAT_B + 1]  # [T, cs, 3]
            for j in range(cs):
                w = a[:, j] * trans
                color = color + rgb[:, j, None, :] * w[..., None]
                trans = trans * (1.0 - a[:, j])
        blocks_done += live
        if cfg.early_stop_transmittance > 0.0:
            still = ((trans >= cfg.early_stop_transmittance) & coverable).any(dim=1)
            running = running & (~live | still)
    return color, trans, blocks_done.to(torch.int32)


def forward_tiles(
    feat: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tile_ids: torch.Tensor,
    n_tiles_x: int,
    cfg: RasterConfig,
    width: int = 0,
    height: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rasterize the given tiles: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Needs block-aligned binning
    (``align=cfg.pair_block``) and ``feat`` ``[N+1, 16]`` f32 whose last row
    is zero. Returns (color, trans, blocks_done)."""
    args = (feat, pair_gaussian, tile_start, tile_count, tile_ids)
    if feat.device.type == "cpu":
        return forward_tiles_plain(*args, n_tiles_x, cfg, width, height)
    if feat.device.type != "cuda":
        raise ValueError(f"forward_tiles: unsupported device {feat.device}")
    num_t = tile_ids.shape[0]
    npix = cfg.tile_size * cfg.tile_size
    for name, t, dtype in (
        ("feat", feat, torch.float32), ("pair_gaussian", pair_gaussian, torch.int32),
        ("tile_start", tile_start, torch.int32), ("tile_count", tile_count, torch.int32),
        ("tile_ids", tile_ids, torch.int32),
    ):
        if t.device != feat.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"forward_tiles: {name} must be a contiguous {dtype} tensor on "
                f"{feat.device}, got {t.dtype} on {t.device}"
            )
    if feat.dim() != 2 or feat.shape[1] != B.NUM_FEATURES or feat.data_ptr() % 16:
        raise ValueError(f"forward_tiles: feat must be a 16-byte aligned [N+1, 16], got {tuple(feat.shape)}")
    if pair_gaussian.dim() != 1 or any(t.shape != (num_t,) for t in (tile_start, tile_count)):
        raise ValueError("forward_tiles: pair_gaussian must be 1-D and tile_start/tile_count [T]")
    if npix > _MAX_THREADS or B.NUM_LIVE_FEATURES * cfg.pair_block * 4 > _MAX_SMEM:
        raise ValueError(f"forward_tiles: tile_size {cfg.tile_size} / pair_block {cfg.pair_block} too large")
    fn = build.load_function("raster_fwd", "gsplat_raster_fwd", _ARGTYPES)
    color = torch.empty((num_t, npix, 3), dtype=torch.float32, device=feat.device)
    trans = torch.empty((num_t, npix), dtype=torch.float32, device=feat.device)
    blocks_done = torch.empty((num_t,), dtype=torch.int32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = fn(
        *(t.data_ptr() for t in args), num_t, n_tiles_x, cfg.tile_size, cfg.pair_block,
        cfg.early_stop_transmittance, width, height, MIN_ALPHA_F32, MAX_GAUSSIAN_DENSITY_F32,
        color.data_ptr(), trans.data_ptr(), blocks_done.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"raster_fwd kernel launch failed with cudaError_t {err}")
    forward_tiles.launches += 1
    return color, trans, blocks_done


forward_tiles.launches = 0  # kernel launches since the count was last reset
