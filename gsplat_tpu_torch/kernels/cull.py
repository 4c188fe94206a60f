"""The compositors' culling and tiling, in plain PyTorch: each pair's
alpha-bound rect, the warp rect, the pixel groups of large tiles, the
tilings the kernels take, and the counts of the work the culled kernels do.

Both CUDA compositors (``csrc/raster_fwd.cu``, ``csrc/raster_bwd.cu``) cut a
tile's pixels into compact rects of ``WARP_RECT`` pixels, each walked by one
warp (a warp owns one, two or four of them: :func:`warp_layout`), and walk
in each rect only the pairs whose alpha-bound rect meets it (``csrc/raster_common.cuh``
``alpha_rect`` and ``warp_span``). :func:`pair_alpha_rect` is the plain twin
of ``alpha_rect``. A tile of edge above ``MAX_GROUP`` is cut into pixel
groups (:func:`group_layout`), each one thread block; the forward's
early-stop vote and the backward's pixel sums are then taken per group and
combined (:func:`resume_ranges`, the partial rows of ``kernels/raster_bwd.py``).
Nothing on the render or training path calls this module's culling
functions: the kernels take their rects themselves (the wrappers call only
:func:`check_tiling` and :func:`group_layout`). The CPU tests check with
them that the rect is conservative, the culling exact and the group walk
bitwise the tile's, and ``tools/card.py::pair_pixels`` counts with them
the pair-pixels and warp evaluations a culled walk makes
(:func:`cull_counts`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from gsplat_tpu_torch.ops import binning as B
from gsplat_tpu_torch.ops.compositing import MIN_ALPHA_F32

WARP_RECT = (8, 4)  # pixels a warp walks as one, x by y (csrc/raster_common.cuh kWarpW, kWarpH)
MAX_GROUP = 64  # the largest edge of the pixels one thread block composites (kMaxGroup)
MAX_WARPS = 32  # warps of a block: 1024 threads
WARP_BLOCKS = ((1, 1), (1, 2), (2, 2))  # rects a warp may own, x by y, in the order tried
SUB_ROWS = 256  # rows a staged sub-batch holds at most (kSubRows)
MAX_SMEM = 232448  # shared memory a block may opt in to on Hopper


def group_layout(tile_size: int) -> Tuple[int, int]:
    """How the kernels cut a tile into pixel groups (``group_layout`` in
    ``csrc/raster_common.cuh``): ``(n, edge)``, ``n x n`` groups of edge
    ``edge = ceil(tile_size / n)``, ``n = ceil(tile_size / MAX_GROUP)``; the
    last row and column of groups are cut by the tile's edge. A tile up to
    ``MAX_GROUP`` is one group, its own edge. Raises ValueError for a tile
    edge below 1."""
    if tile_size < 1:
        raise ValueError(f"tile_size {tile_size} not supported: a tile edge must be positive")
    n = -(-tile_size // MAX_GROUP)
    return n, -(-tile_size // n)


def group_rects(tile_size: int) -> List[Tuple[int, int, int, int]]:
    """Each pixel group's half-open pixel rect ``(x0, y0, x1, y1)`` in the
    tile (from the tile's first pixel), in group order (row-major), cut by
    the tile's edge."""
    n, e = group_layout(tile_size)
    return [(gx * e, gy * e, min((gx + 1) * e, tile_size), min((gy + 1) * e, tile_size))
            for gy in range(n) for gx in range(n)]


def group_pixels(tile_size: int) -> List[torch.Tensor]:
    """Each pixel group's pixels as indices into the tile's row-major
    ``tile_size**2`` pixels (int64), in group order."""
    out = []
    for x0, y0, x1, y1 in group_rects(tile_size):
        ys, xs = torch.meshgrid(torch.arange(y0, y1), torch.arange(x0, x1), indexing="ij")
        out.append((ys * tile_size + xs).reshape(-1))
    return out


def resume_ranges(group_done: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
                  pair_block: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward's resume after each group's own early-stop vote
    (``csrc/raster_fwd.cu``): from the pair blocks each group composited
    ``group_done [T, G]``, the tile's ``blocks_done [T]`` (the most over its
    groups: T never grows, so the tile's vote first passes after its last
    group's), and each group's pairs left to composite with the vote off,
    blocks ``[done_g, done_tile)``: ``start [T, G]`` (``tile_start +
    done_g * pair_block``) and ``count [T, G]`` (up to the tile's count; 0
    for a group with nothing left, which passes its state through)."""
    done = group_done.long()
    tile_done = done.amax(dim=1)
    first = done * pair_block
    end = torch.minimum(tile_count.long(), tile_done * pair_block)
    start = tile_start.long()[:, None] + first
    count = (end[:, None] - first).clamp(min=0)
    return tile_done.to(torch.int32), start.to(torch.int32), count.to(torch.int32)


def rect_grid(tile_size: int) -> Tuple[int, int]:
    """The kernels' grid of warp rects over a block's pixels of edge
    ``tile_size`` (a tile up to ``MAX_GROUP``, or a pixel group),
    ``(rects_x, rects_y)``: rounded up past the edge where it is not a
    multiple of ``WARP_RECT`` (lanes whose pixel lies past the edge own
    none)."""
    ww, wh = WARP_RECT
    return -(-tile_size // ww), -(-tile_size // wh)


def warp_layout(tile_size: int) -> Tuple[int, int, int]:
    """How the kernels map a block's rects onto warps (``warp_layout`` in
    ``csrc/raster_common.cuh``), for the block of a tile of this edge (of
    its pixel groups' edge above ``MAX_GROUP``): ``(fx, fy, warps)``, each
    warp owning a block of ``fx x fy`` rects (each thread a pixel in each),
    the first of ``WARP_BLOCKS`` that needs at most ``MAX_WARPS`` warps.
    Raises ValueError for a tile edge below 1."""
    edge = group_layout(tile_size)[1]
    rx, ry = rect_grid(edge)
    for fx, fy in WARP_BLOCKS:
        warps = -(-rx // fx) * -(-ry // fy)
        if warps <= MAX_WARPS:
            return fx, fy, warps
    raise AssertionError("unreachable: a 2x2 block covers every group up to MAX_GROUP")


def staging_bytes(pair_block: int) -> int:
    """Shared memory of the kernels' staging pipeline (``staging_bytes`` in
    ``csrc/raster_common.cuh``): three row buffers ``[sub, 16]`` and two
    warp-span buffers ``[sub]``, where a sub-batch holds the whole pair
    block up to ``SUB_ROWS`` rows."""
    return min(pair_block, SUB_ROWS) * (3 * B.NUM_FEATURES + 2) * 4


def check_tiling(who: str, tile_size: int, pair_block: int, smem_bytes: int) -> None:
    """Raise ValueError unless the kernels can take this tiling: a positive
    tile edge, a positive pair block, and the launch's shared memory at
    most ``MAX_SMEM``."""
    if pair_block <= 0:
        raise ValueError(f"{who}: pair_block {pair_block} not supported: it must be positive")
    try:
        warp_layout(tile_size)
    except ValueError as e:
        raise ValueError(f"{who}: {e}") from None
    if smem_bytes > MAX_SMEM:
        raise ValueError(
            f"{who}: tile_size {tile_size} / pair_block {pair_block} not supported: needs {smem_bytes} bytes of "
            f"shared memory, above the {MAX_SMEM} a block may take"
        )


def pair_alpha_rect(feat_rows: torch.Tensor) -> torch.Tensor:
    """The half-open pixel rect ``[P, 4]`` (x0, y0, x1, y1; f32 whole
    pixels) outside which each packed feature row's gate cannot pass: the
    twin of ``alpha_rect`` in ``csrc/raster_common.cuh``, in float64 as
    there.

    Where ``opacity * exp(density) > 1/255`` the quadratic form ``q = -2 *
    density`` stays below ``2 ln(opacity / MIN_ALPHA_F32)``, so ``|dx| <=
    sqrt(q * Sxx)`` with ``Sxx = cy / (cx*cy - cxy^2)`` (and likewise for
    y). ``q`` is widened for the f32 rounding of the gate (the density's
    terms, whose magnitudes are at most ``q / (1 - rho)``, and the expf and
    product), a pixel of guard is added on each side, and the rect is cut to
    the row's reference bbox. Opacity at or below ``MIN_ALPHA_F32`` gives
    the empty rect (0, 0, 0, 0), as does an empty cut; a conic that is not
    clearly positive definite (``det <= 1e-4 cx cy``), or a non-finite
    term, gives the whole bbox.
    """
    f = feat_rows.to(torch.float32)
    mx, my, cx, cy, cxy, op = (f[:, i] for i in (B.FEAT_MEAN_X, B.FEAT_MEAN_Y, B.FEAT_CONIC_X,
                                                 B.FEAT_CONIC_Y, B.FEAT_CONIC_XY, B.FEAT_OPACITY))
    bbox = f[:, B.FEAT_X_MIN:B.FEAT_Y_MAX + 1]
    finite = torch.isfinite(f[:, B.FEAT_MEAN_X:B.FEAT_OPACITY + 1]).all(dim=1)
    live = op > MIN_ALPHA_F32
    dcx, dcy, dcxy, dop = cx.double(), cy.double(), cxy.double(), op.double()
    det = dcx * dcy - dcxy * dcxy
    pd = (dcx > 0.0) & (dcy > 0.0) & (det > 1e-4 * dcx * dcy)
    s = det / (dcx * dcy)
    q = (2.0 * torch.log(dop / MIN_ALPHA_F32) + 1e-5) * (1.0 + 1e-4 / s)
    rx = torch.sqrt(q * dcy / det) + 1.0
    ry = torch.sqrt(q * dcx / det) + 1.0
    box = bbox.double()
    x0 = torch.maximum(box[:, 0], torch.ceil(mx.double() - rx))
    y0 = torch.maximum(box[:, 1], torch.ceil(my.double() - ry))
    x1 = torch.minimum(box[:, 2], torch.floor(mx.double() + rx) + 1.0)
    y1 = torch.minimum(box[:, 3], torch.floor(my.double() + ry) + 1.0)
    fits = (x1 > x0) & (y1 > y0)
    rect = torch.where(fits[:, None], torch.stack([x0, y0, x1, y1], dim=1), 0.0).to(torch.float32)
    rect = torch.where(pd[:, None], rect, bbox)
    rect = torch.where(live[:, None], rect, 0.0)
    return torch.where(finite[:, None], rect, bbox)


def cull_counts(rect: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                tile_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For pairs with rects ``rect [P, 4]`` walked in tiles whose first
    pixels are ``(ox, oy)`` (each ``[P]``): the tile pixels inside each rect,
    and the warp rects that each rect meets, which are the rects in which a
    warp walks the pair (``warp_span`` in ``csrc/raster_common.cuh``): over
    each pixel group of the tile (:func:`group_layout`; the tile itself up
    to ``MAX_GROUP``), the grid of rects from the group's first pixel,
    rounded up past the group's edge. Returns two int64 ``[P]``."""
    ww, wh = WARP_RECT
    rx, ry = rect_grid(group_layout(tile_size)[1])
    ox, oy = ox.to(rect.dtype), oy.to(rect.dtype)
    pixels = torch.zeros(rect.shape[0], dtype=torch.int64, device=rect.device)
    warps = torch.zeros_like(pixels)
    for gx0, gy0, gx1, gy1 in group_rects(tile_size):
        x0, x1 = torch.maximum(rect[:, 0], ox + gx0), torch.minimum(rect[:, 2], ox + gx1)
        y0, y1 = torch.maximum(rect[:, 1], oy + gy0), torch.minimum(rect[:, 3], oy + gy1)
        pixels += ((x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0)).long()
        lx, ly = ox + gx0, oy + gy0  # the group's grid of rects starts here
        x0, x1 = torch.maximum(rect[:, 0], lx), torch.minimum(rect[:, 2], lx + rx * ww)
        y0, y1 = torch.maximum(rect[:, 1], ly), torch.minimum(rect[:, 3], ly + ry * wh)
        nwx = torch.floor((x1 - 1 - lx) / ww) - torch.floor((x0 - lx) / ww) + 1
        nwy = torch.floor((y1 - 1 - ly) / wh) - torch.floor((y0 - ly) / wh) + 1
        warps += torch.where((x1 > x0) & (y1 > y0), nwx * nwy, 0.0).long()
    return pixels, warps
