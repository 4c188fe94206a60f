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

``forward_tiles_carry`` is the same kernel in its carry form (the TPU's
``forward_tiles_carry``), one depth slice of ``render/sliced.py``: each tile
resumes from a carried colour and T instead of (0, 1), ``blocks_done``
counts this call's blocks, and a tile with no pairs passes its carry
through. It keeps its own launch count.

A tile of edge above 64 is cut into pixel groups, one thread block each
(``kernels/cull.py`` ``group_layout``). With early stop on, each group
first votes on its own pixels; a second launch, the resume, then takes each
group that stopped before its tile's last group on to that block with the
vote off, so every pixel takes the steps of the unsplit tile and the frame
stays bitwise the plain version's. Each wrapper counts that launch apart
(``resume_launches``): ``launches`` keeps counting one per call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.kernels import build, cull
from gsplat_tpu_torch.ops import binning as B
from gsplat_tpu_torch.ops.compositing import MAX_GAUSSIAN_DENSITY_F32, MIN_ALPHA_F32, gaussian_alpha
from gsplat_tpu_torch.render.tile_torch import tile_pixel_coords

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (
    _P, _P, _P, _P, _P,  # feat, pair_gaussian, tile_start, tile_count, tile_ids
    _P, _P,  # carry_color, carry_trans (null: start from 0 and 1)
    _I, _I, _I, _I,  # num_tiles, n_tiles_x, tile_size, pair_block
    _F, _I, _I, _F, _F,  # early_stop, width, height, min_alpha, max_alpha
    _P, _P, _P, _P,  # color, trans, blocks_done, stream
)
_GROUP_ARGTYPES = _ARGTYPES + (_P, _I)  # group_done, resume


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
    carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, vectorized over tiles: the
    tile's pixels through :func:`composite_pixels`, pixels of the last row
    and column of the frame (and outside it) left out of the early-stop
    vote. ``carry`` (colour ``[T, npix, 3]``, T ``[T, npix]``) is the state
    to resume from, (0, 1) when None."""
    px, py = tile_pixel_coords(tile_ids, n_tiles_x, cfg.tile_size, feat.dtype)  # [T, npix]
    if width > 0 and height > 0:
        votes = (px < width - 1) & (py < height - 1)
    else:
        votes = torch.ones_like(px, dtype=torch.bool)
    return composite_pixels(feat, pair_gaussian, tile_start, tile_count, px, py, votes, cfg, carry)


def composite_pixels(
    feat: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    votes: torch.Tensor,
    cfg: RasterConfig,
    carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Front-to-back compositing of each row's pairs (``tile_start``,
    ``tile_count`` ``[T]``) at the pixels ``px, py [T, K]``: a tile's pixels,
    or a pixel group of them as the kernels take a large tile. After each
    pair block a row stops once none of its ``votes [T, K]`` pixels has
    ``T >= early_stop_transmittance`` (early stop on). Returns colour
    ``[T, K, 3]``, T ``[T, K]`` and the pair blocks composited ``[T]``.

    Walks pair blocks up to the largest count (one host sync for that
    count), and in the last of them stops at that count. Within a block,
    alphas are evaluated ``chunk_size`` pairs at a time and composited pair
    by pair in the kernel's order (``C += rgb * (alpha * T)``, then
    ``T *= 1 - alpha``). A row that is done, or a pair slot past its
    count, composites alpha 0, which leaves color and T bitwise
    unchanged.
    """
    dev, dtype = feat.device, feat.dtype
    cs, blk = cfg.chunk_size, cfg.pair_block
    num_t, num_px = px.shape
    if carry is None:
        color = torch.zeros((num_t, num_px, 3), dtype=dtype, device=dev)
        trans = torch.ones((num_t, num_px), dtype=dtype, device=dev)
    else:
        color, trans = carry
    start = tile_start.long()
    count = tile_count.long()
    nblocks = -(-count // blk)
    blocks_done = torch.zeros(num_t, dtype=torch.int64, device=dev)
    running = torch.ones(num_t, dtype=torch.bool, device=dev)
    pairs = pair_gaussian.long()
    sentinel = feat.shape[0] - 1
    lane = torch.arange(cs, device=dev)
    pxc, pyc = px[:, None, :], py[:, None, :]
    max_count = int(count.max()) if num_t else 0
    for b in range(-(-max_count // blk)):
        live = running & (b < nblocks)
        # Chunks past every tile's count would composite alpha 0 only.
        for c in range(0, min(blk, max_count - b * blk), cs):
            k = b * blk + c + lane  # [cs] slot within the tile
            in_tile = live[:, None] & (k[None, :] < count[:, None])  # [T, cs]
            slot = torch.where(in_tile, start[:, None] + k[None, :], 0)
            f = feat[torch.where(in_tile, pairs[slot], sentinel)]  # [T, cs, 16]

            def col(i):
                return f[:, :, i, None]

            at = gaussian_alpha(
                pxc, pyc, col(B.FEAT_MEAN_X), col(B.FEAT_MEAN_Y),
                col(B.FEAT_CONIC_X), col(B.FEAT_CONIC_Y), col(B.FEAT_CONIC_XY),
                col(B.FEAT_OPACITY),
            )
            inside = (
                (pxc >= col(B.FEAT_X_MIN)) & (pxc < col(B.FEAT_X_MAX))
                & (pyc >= col(B.FEAT_Y_MIN)) & (pyc < col(B.FEAT_Y_MAX))
            )
            a = torch.where(at.valid & inside, at.alpha, 0.0)  # [T, cs, npix]
            rgb = f[:, :, B.FEAT_R : B.FEAT_B + 1]  # [T, cs, 3]
            for j in range(cs):
                w = a[:, j] * trans
                color = color + rgb[:, j, None, :] * w[..., None]
                trans = trans * (1.0 - a[:, j])
        blocks_done += live
        if cfg.early_stop_transmittance > 0.0:
            still = ((trans >= cfg.early_stop_transmittance) & votes).any(dim=1)
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
    return _launch(forward_tiles, args, None, n_tiles_x, cfg, width, height)


def forward_tiles_carry(
    feat: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tile_ids: torch.Tensor,
    carry_color: torch.Tensor,
    carry_trans: torch.Tensor,
    n_tiles_x: int,
    cfg: RasterConfig,
    width: int = 0,
    height: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One depth slice: resume every tile from ``carry_color [T, npix, 3]``
    and ``carry_trans [T, npix]`` over this slice's binned pairs. The CUDA
    kernel's carry form for CUDA tensors, the plain version for CPU tensors.
    Returns the new (color, trans) and ``blocks_done [T]``, this call's
    blocks; a tile with ``tile_count == 0`` passes its carry through."""
    args = (feat, pair_gaussian, tile_start, tile_count, tile_ids)
    if feat.device.type == "cpu":
        return forward_tiles_plain(*args, n_tiles_x, cfg, width, height, carry=(carry_color, carry_trans))
    return _launch(forward_tiles_carry, args, (carry_color, carry_trans), n_tiles_x, cfg, width, height)


def _launch(wrapper, args, carry, n_tiles_x, cfg, width, height):
    """Check the inputs and launch the kernel on the current stream, with
    the resume launch where a tile is cut into pixel groups and early stop
    is on; count the launches on ``wrapper``."""
    who = wrapper.__name__
    feat, pair_gaussian, tile_start, tile_count, tile_ids = args
    if feat.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {feat.device}")
    num_t = tile_ids.shape[0]
    npix = cfg.tile_size * cfg.tile_size
    checked = [
        ("feat", feat, torch.float32), ("pair_gaussian", pair_gaussian, torch.int32),
        ("tile_start", tile_start, torch.int32), ("tile_count", tile_count, torch.int32),
        ("tile_ids", tile_ids, torch.int32),
    ]
    if carry is not None:
        checked += [("carry_color", carry[0], torch.float32), ("carry_trans", carry[1], torch.float32)]
    for name, t, dtype in checked:
        if t.device != feat.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{who}: {name} must be a contiguous {dtype} tensor on "
                f"{feat.device}, got {t.dtype} on {t.device}"
            )
    if feat.dim() != 2 or feat.shape[1] != B.NUM_FEATURES or feat.data_ptr() % 16:
        raise ValueError(f"{who}: feat must be a 16-byte aligned [N+1, 16], got {tuple(feat.shape)}")
    if pair_gaussian.dim() != 1 or any(t.shape != (num_t,) for t in (tile_start, tile_count)):
        raise ValueError(f"{who}: pair_gaussian must be 1-D and tile_start/tile_count [T]")
    if carry is not None and (tuple(carry[0].shape) != (num_t, npix, 3) or tuple(carry[1].shape) != (num_t, npix)):
        raise ValueError(
            f"{who}: carry_color must be {(num_t, npix, 3)} and carry_trans {(num_t, npix)}, "
            f"got {tuple(carry[0].shape)} and {tuple(carry[1].shape)}"
        )
    cull.check_tiling(who, cfg.tile_size, cfg.pair_block, cull.staging_bytes(cfg.pair_block))
    groups = cull.group_layout(cfg.tile_size)[0] ** 2
    stream = torch.cuda.current_stream(feat.device).cuda_stream

    def run(carry, early_stop, group_done=None, resume=0):
        color = torch.empty((num_t, npix, 3), dtype=torch.float32, device=feat.device)
        trans = torch.empty((num_t, npix), dtype=torch.float32, device=feat.device)
        carry_ptrs = (None, None) if carry is None else (carry[0].data_ptr(), carry[1].data_ptr())
        common = (*(t.data_ptr() for t in args), *carry_ptrs, num_t, n_tiles_x, cfg.tile_size, cfg.pair_block,
                  early_stop, width, height, MIN_ALPHA_F32, MAX_GAUSSIAN_DENSITY_F32,
                  color.data_ptr(), trans.data_ptr(), blocks_done.data_ptr(), stream)
        if groups == 1:
            err = build.load_function("raster_fwd", "gsplat_raster_fwd", _ARGTYPES)(*common)
        else:
            err = build.load_function("raster_fwd", "gsplat_raster_fwd_groups", _GROUP_ARGTYPES)(
                *common, None if group_done is None else group_done.data_ptr(), resume)
        if err != 0:
            raise RuntimeError(f"raster_fwd kernel launch failed with cudaError_t {err}")
        return color, trans

    blocks_done = torch.empty((num_t,), dtype=torch.int32, device=feat.device)
    stop = cfg.early_stop_transmittance
    if groups == 1 or stop <= 0.0:
        # One launch: without groups the block votes for the whole tile;
        # without early stop every group walks every block.
        color, trans = run(carry, stop)
        wrapper.launches += 1
        return color, trans, blocks_done
    # Each group votes on its own pixels and records its blocks; the resume
    # takes every group on to its tile's last group's block, the vote off.
    group_done = torch.empty((num_t * groups,), dtype=torch.int32, device=feat.device)
    first = run(carry, stop, group_done)
    wrapper.launches += 1
    color, trans = run(first, 0.0, group_done, resume=1)
    wrapper.resume_launches += 1
    return color, trans, blocks_done


forward_tiles.launches = 0  # kernel launches since the count was last reset
forward_tiles.resume_launches = 0  # resume launches of grouped tiles with early stop
forward_tiles_carry.launches = 0
forward_tiles_carry.resume_launches = 0
