"""Backward tile compositor: the CUDA kernel's wrapper, its plain version,
and the pair-to-gaussian gradient reduction.

``backward_tiles`` turns the cotangents of the forward's per-tile colour and
final transmittance into per-pair gradient rows ``[P, 9]`` (columns in
``FEAT_*`` order: d mean x/y, d conic x/y/xy, d opacity, d rgb). On a CUDA
tensor it launches the hand-written kernel ``csrc/raster_bwd.cu`` (which
replaces the TPU kernel ``gsplat_tpu/kernels/raster_bwd.py::_bwd_kernel``);
on a CPU tensor it runs ``backward_tiles_plain``, the same function in
plain PyTorch. There is no fallback from one to the other.

Both walk each tile's pairs front to back over the first
``min(blocks_done, ceil(count / pair_block))`` pair blocks only, recomputing
the forward's alphas, and leave every other row (an early-stopped tail, an
alignment pad, a slot past the last tile) exactly zero.
``reduce_pair_grads`` then sums the rows of each gaussian into the
``[N+1, 16]`` gradient of ``feat``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.kernels import build
from gsplat_tpu_torch.ops import binning as B
from gsplat_tpu_torch.ops.compositing import MAX_GAUSSIAN_DENSITY_F32, MIN_ALPHA_F32, gaussian_alpha
from gsplat_tpu_torch.render.tile_torch import tile_pixel_coords

NUM_GRAD = 9  # gradient columns per pair row: FEAT_MEAN_X .. FEAT_B

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (
    _P, _P, _P, _P, _P, _P,  # feat, pair_gaussian, tile_start, tile_count, tile_ids, blocks_done
    _P, _P, _P, _P,  # color, trans, g_color, g_trans
    _I, _I, _I, _I,  # num_tiles, n_tiles_x, tile_size, pair_block
    _F, _F,  # min_alpha, max_alpha
    _P, _P,  # pair_grads, stream
)
_MAX_THREADS = 1024
_MAX_SMEM = 232448  # shared memory a block may opt in to on Hopper
_CHUNK = 32  # pairs per round of the kernel's pixel sums (csrc/raster_bwd.cu kChunk)
_SCAN_BLOCK = 1024  # row length of the blocked cumsum


def _smem_bytes(npix: int, pair_block: int) -> int:
    return (B.NUM_LIVE_FEATURES * pair_block + (npix // 32) * _CHUNK * NUM_GRAD) * 4


def backward_tiles_plain(
    feat: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tile_ids: torch.Tensor,
    color: torch.Tensor,
    trans: torch.Tensor,
    g_color: torch.Tensor,
    g_trans: torch.Tensor,
    n_tiles_x: int,
    cfg: RasterConfig,
    blocks_done: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, vectorized over tiles.

    Walks pair blocks up to the longest tile's walk (one host sync for it).
    Within a block, alphas are recomputed ``chunk_size`` pairs at a time
    through ``gaussian_alpha`` and the walk runs pair by pair in the
    kernel's order and rounding; the per-pixel terms are then summed over
    each tile's pixels. Returns the per-pair rows ``[P, 9]``.
    """
    dev, dtype = feat.device, feat.dtype
    ts, cs, blk = cfg.tile_size, cfg.chunk_size, cfg.pair_block
    num_t = tile_ids.shape[0]
    num_p = pair_gaussian.shape[0]
    px, py = tile_pixel_coords(tile_ids, n_tiles_x, ts, dtype)  # [T, npix]
    pxc, pyc = px[:, None, :], py[:, None, :]
    start = tile_start.long()
    count = tile_count.long()
    walk = -(-count // blk)
    if blocks_done is not None:
        walk = torch.minimum(walk, blocks_done.long())
    g0, g1, g2 = (g_color[..., i] for i in range(3))  # [T, npix]
    s_sig = g0 * color[..., 0] + g1 * color[..., 1] + g2 * color[..., 2] + g_trans * trans
    t_run = torch.ones_like(trans)
    rows = torch.zeros((num_p + 1, NUM_GRAD), dtype=dtype, device=dev)  # row P: unwalked slots
    pairs = pair_gaussian.long()
    sentinel = feat.shape[0] - 1
    lane = torch.arange(cs, device=dev)
    max_walk = int(walk.max()) if num_t else 0
    for b in range(max_walk):
        live = b < walk
        for c in range(0, blk, cs):
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
            valid = at.valid & inside  # [T, cs, npix]
            a = torch.where(valid, at.alpha, 0.0)
            u = col(B.FEAT_R) * g0[:, None] + col(B.FEAT_G) * g1[:, None] + col(B.FEAT_B) * g2[:, None]
            w = torch.empty_like(a)
            d_raw = torch.empty_like(a)
            for j in range(cs):
                tk = t_run
                w[:, j] = a[:, j] * tk
                s_sig = s_sig - w[:, j] * u[:, j]
                om = 1.0 - a[:, j]
                d_a = torch.where(valid[:, j], u[:, j] * tk - s_sig / om, 0.0)
                d_raw[:, j] = torch.where(at.raw[:, j] < MAX_GAUSSIAN_DENSITY_F32, d_a, 0.0)
                t_run = tk * om
            dd = d_raw * at.raw
            cx, cy, cxy = col(B.FEAT_CONIC_X), col(B.FEAT_CONIC_Y), col(B.FEAT_CONIC_XY)
            dx, dy = at.dx, at.dy
            terms = (
                dd * -(cx * dx + cxy * dy),
                dd * -(cy * dy + cxy * dx),
                dd * (-0.5 * dx * dx),
                dd * (-0.5 * dy * dy),
                dd * (-dx * dy),
                d_raw * at.expd,
                w * g0[:, None],
                w * g1[:, None],
                w * g2[:, None],
            )
            rows[torch.where(in_tile, slot, num_p)] = torch.stack([x.sum(-1) for x in terms], -1)
    return rows[:num_p]


def backward_tiles(
    feat: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tile_ids: torch.Tensor,
    color: torch.Tensor,
    trans: torch.Tensor,
    g_color: torch.Tensor,
    g_trans: torch.Tensor,
    n_tiles_x: int,
    cfg: RasterConfig,
    blocks_done: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-pair gradient rows ``[P, 9]``: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Takes the forward's inputs, its
    ``color [T, npix, 3]`` / ``trans [T, npix]`` outputs and their
    cotangents (contiguous f32), and ``blocks_done [T]`` int32 from the
    forward (None walks every block)."""
    args = (feat, pair_gaussian, tile_start, tile_count, tile_ids, color, trans, g_color, g_trans)
    if feat.device.type == "cpu":
        return backward_tiles_plain(*args, n_tiles_x, cfg, blocks_done)
    if feat.device.type != "cuda":
        raise ValueError(f"backward_tiles: unsupported device {feat.device}")
    num_t = tile_ids.shape[0]
    npix = cfg.tile_size * cfg.tile_size
    if npix > _MAX_THREADS or npix % 32 or _smem_bytes(npix, cfg.pair_block) > _MAX_SMEM:
        raise ValueError(
            f"backward_tiles: tile_size {cfg.tile_size} / pair_block {cfg.pair_block} not supported "
            "(tile_size**2 must be a multiple of 32 and at most 1024)"
        )
    f32, i32 = torch.float32, torch.int32
    checked = [
        ("feat", feat, f32), ("pair_gaussian", pair_gaussian, i32), ("tile_start", tile_start, i32),
        ("tile_count", tile_count, i32), ("tile_ids", tile_ids, i32), ("color", color, f32),
        ("trans", trans, f32), ("g_color", g_color, f32), ("g_trans", g_trans, f32),
    ]
    if blocks_done is not None:
        checked.append(("blocks_done", blocks_done, i32))
    for name, t, dtype in checked:
        if t.device != feat.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"backward_tiles: {name} must be a contiguous {dtype} tensor on "
                f"{feat.device}, got {t.dtype} on {t.device}"
            )
    if feat.dim() != 2 or feat.shape[1] != B.NUM_FEATURES or feat.data_ptr() % 16:
        raise ValueError(f"backward_tiles: feat must be a 16-byte aligned [N+1, 16], got {tuple(feat.shape)}")
    if pair_gaussian.dim() != 1 or any(
        t.shape != (num_t,) for t in (tile_start, tile_count) + ((blocks_done,) if blocks_done is not None else ())
    ):
        raise ValueError("backward_tiles: pair_gaussian must be 1-D and tile_start/tile_count/blocks_done [T]")
    for name, t, shape in (("color", color, (num_t, npix, 3)), ("g_color", g_color, (num_t, npix, 3)),
                           ("trans", trans, (num_t, npix)), ("g_trans", g_trans, (num_t, npix))):
        if tuple(t.shape) != shape:
            raise ValueError(f"backward_tiles: {name} must be {shape}, got {tuple(t.shape)}")
    fn = build.load_function("raster_bwd", "gsplat_raster_bwd", _ARGTYPES)
    pair_grads = torch.zeros((pair_gaussian.shape[0], NUM_GRAD), dtype=f32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = fn(
        *(t.data_ptr() for t in args[:5]), blocks_done.data_ptr() if blocks_done is not None else None,
        *(t.data_ptr() for t in args[5:]), num_t, n_tiles_x, cfg.tile_size, cfg.pair_block,
        MIN_ALPHA_F32, MAX_GAUSSIAN_DENSITY_F32, pair_grads.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"raster_bwd kernel launch failed with cudaError_t {err}")
    backward_tiles.launches += 1
    return pair_grads


backward_tiles.launches = 0  # kernel launches since the count was last reset


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of ``x [C, P]`` along its last axis, in an order of
    additions that the shapes alone fix, so bitwise repeatable on the card:
    rows of ``_SCAN_BLOCK`` values are scanned independently, then their
    totals, and each block gets the totals before it. (PyTorch scans a
    single 1-D run with CUB, which promises no fixed order; many short rows
    also spread over more of the card than nine long ones.)"""
    c, p = x.shape
    k = max(-(-p // _SCAN_BLOCK), 1)
    within = torch.cumsum(F.pad(x, (0, k * _SCAN_BLOCK - p)).reshape(c, k, _SCAN_BLOCK), dim=2)
    before = F.pad(torch.cumsum(within[:, :, -1], dim=1)[:, :-1], (1, 0))  # [C, K] exclusive
    return (within + before[:, :, None]).reshape(c, k * _SCAN_BLOCK)[:, :p]


def reduce_pair_grads(
    pair_grads: torch.Tensor,
    pair_gaussian: torch.Tensor,
    gaussian_counts: Optional[torch.Tensor],
    num_rows: int,
) -> torch.Tensor:
    """Sum per-pair gradient rows ``[P, 9]`` into per-gaussian rows
    ``[num_rows, 16]`` (``num_rows = N + 1``; columns 9-15 and the sentinel
    row ``N`` are zero).

    Default (as the JAX package's): sort the rows by gaussian id (stable),
    take the inclusive cumsum of the nine columns in that order and
    difference it at the segment ends ``cumsum(gaussian_counts)``. It needs
    ``pair_gaussian`` to hold exactly ``gaussian_counts[i]`` pairs of each
    gaussian ``i`` (one binning of the whole frame), makes no host sync and
    is bitwise repeatable on the card; the cumsum reorders f32 additions
    (about 1e-5 of the gradient scale).

    ``gaussian_counts=None``: an exact segment sum (``index_add_``). Its
    atomic additions land in a varying order on the card, so it is not
    bitwise repeatable there.
    """
    n = num_rows - 1
    d_feat = pair_grads.new_zeros((num_rows, B.NUM_FEATURES))
    if gaussian_counts is None:
        sums = pair_grads.new_zeros((num_rows, NUM_GRAD))
        sums.index_add_(0, pair_gaussian.long(), pair_grads)
        d_feat[:n, :NUM_GRAD] = sums[:n]
        return d_feat
    if n == 0:
        return d_feat
    order = torch.sort(pair_gaussian, stable=True).indices
    cum = blocked_cumsum(pair_grads.t().index_select(1, order))  # [9, P] in id order
    ends = torch.cumsum(gaussian_counts.long(), 0)  # [N]
    at_end = torch.where(ends > 0, cum[:, (ends - 1).clamp(min=0)], 0.0)  # [9, N]
    d_feat[:n, :NUM_GRAD] = (at_end - F.pad(at_end[:, :-1], (1, 0))).t()
    return d_feat
