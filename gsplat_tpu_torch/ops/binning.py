"""Tile binning: turn per-gaussian rects into per-tile, depth-ordered lists.

Produces the same fixed-capacity outputs as ``gsplat_tpu/ops/binning.py``
(integer-equal, including the buffer length and the sentinel id ``N``) with
PyTorch's own primitives instead of the TPU mechanisms:

  1. Each active gaussian covers ``ntx * nty`` tiles of the grid. Overflow
     of the pair capacity drops the deepest whole gaussians: a stable sort
     of the gaussians by their monotone depth key (ties stay in id order),
     an inclusive cumsum of their pair counts in that order, and every
     gaussian with ``cum <= capacity`` is kept. This is the set the JAX
     package's 63-step threshold search selects.
  2. Pair slots are laid out per gaussian in id order; ``repeat_interleave``
     (with a fixed ``output_size``, so no host sync) gives each slot its
     owning gaussian, and a trailing filler segment fills the unused slots
     with the sentinel ``N``.
  3. Per-tile counts are a bincount of the valid pairs' tile ids.
  4. Alignment pads (``align > 1``) are explicit sentinel pairs that sort to
     the tail of their tile's segment.
  5. ONE stable sort on an int64 key ``(tile << 32) | depth_key`` orders
     every tile's list front to back, with (depth, id) ties in id order
     like the reference's stable argsort (rasterize.py:424-425).

The depth key is the f32 depth's bit pattern mapped to a monotone unsigned
32-bit value, carried in int64 (PyTorch's uint32 support is thin). Binning
makes no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsplat_tpu_torch.ops.projection import Preprocessed

NUM_FEATURES = 16
NUM_LIVE_FEATURES = 13  # columns 0-12 carry data; 13-15 are padding
# Feature column layout for the packed raster-feature array.
FEAT_MEAN_X, FEAT_MEAN_Y = 0, 1
FEAT_CONIC_X, FEAT_CONIC_Y, FEAT_CONIC_XY = 2, 3, 4
FEAT_OPACITY = 5
FEAT_R, FEAT_G, FEAT_B = 6, 7, 8
FEAT_X_MIN, FEAT_Y_MIN, FEAT_X_MAX, FEAT_Y_MAX = 9, 10, 11, 12

_DKEY_MAX = 0xFFFFFFFF  # depth key of sentinel and pad pairs (sorts last)


class TileBinning(NamedTuple):
    """Fixed-capacity binning result for one view.

    Attributes:
      pair_gaussian: ``[max_pairs + num_tiles*(align-1)]`` int32 — global
        gaussian index of each pair slot; unused slots hold ``N`` (the zero
        feature row).
      tile_start: ``[num_tiles]`` int32 — first pair slot of each tile.
      tile_count: ``[num_tiles]`` int32 — number of pairs in each tile.
      num_pairs: 0-d int32 — pairs emitted (under overflow less than the
        demand, because whole gaussians are dropped).
      pair_demand: 0-d int32 — pairs the view wanted before clipping.
      gaussian_counts: ``[N]`` int32 — kept pairs per gaussian, id order.
    """

    pair_gaussian: torch.Tensor
    tile_start: torch.Tensor
    tile_count: torch.Tensor
    num_pairs: torch.Tensor
    pair_demand: torch.Tensor
    gaussian_counts: torch.Tensor


def tile_ranges(bbox: torch.Tensor, tile_size: int, n_tiles_x: int, n_tiles_y: int):
    """Tile ranges ``(tx0, ty0, ntx, nty)``, each ``[N]`` int32, covered by
    half-open pixel bboxes; empty bboxes give 0 counts."""
    x_min, y_min, x_max, y_max = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    tx0 = (x_min // tile_size).clamp(0, n_tiles_x - 1)
    ty0 = (y_min // tile_size).clamp(0, n_tiles_y - 1)
    tx1 = ((x_max - 1) // tile_size).clamp(0, n_tiles_x - 1)
    ty1 = ((y_max - 1) // tile_size).clamp(0, n_tiles_y - 1)
    empty = (x_max <= x_min) | (y_max <= y_min)
    ntx = torch.where(empty, 0, tx1 - tx0 + 1)
    nty = torch.where(empty, 0, ty1 - ty0 + 1)
    i32 = torch.int32
    return tx0.to(i32), ty0.to(i32), ntx.to(i32), nty.to(i32)


def depth_key(depth: torch.Tensor) -> torch.Tensor:
    """Monotone unsigned 32-bit key of f32 depths, as int64 in [0, 2^32)."""
    bits = depth.detach().to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _DKEY_MAX
    negative = bits >= 0x80000000
    return torch.where(negative, _DKEY_MAX - bits, bits | 0x80000000)


def bin_gaussians(
    prep: Preprocessed, width: int, height: int, tile_size: int, max_pairs: int, align: int = 1
) -> TileBinning:
    """Per-tile depth-ordered gaussian lists for the whole frame, binned
    against the alpha-cull rect (``prep.cull_bbox``)."""
    n_tiles_x = -(-width // tile_size)
    n_tiles_y = -(-height // tile_size)
    rects = tile_ranges(prep.cull_bbox, tile_size, n_tiles_x, n_tiles_y)
    return bin_rects(prep.depth, prep.active, rects, n_tiles_x, n_tiles_y, max_pairs, align)


def bin_rects(
    depth: torch.Tensor,
    active: torch.Tensor,
    rects,
    n_tiles_x: int,
    n_tiles_y: int,
    max_pairs: int,
    align: int = 1,
) -> TileBinning:
    """Bin gaussians with per-gaussian tile rects ``(tx0, ty0, ntx, nty)``
    onto an ``n_tiles_x x n_tiles_y`` grid. With ``align > 1`` every tile's
    segment starts at a multiple of ``align`` and is padded to one with
    sentinel pairs. ``pair_gaussian`` has length
    ``max_pairs + num_tiles*(align-1)``."""
    dev = depth.device
    n = depth.shape[0]
    num_tiles = n_tiles_x * n_tiles_y
    i64 = torch.int64
    tx0, ty0, ntx, nty = (r.to(i64) for r in rects)
    counts = torch.where(active, ntx * nty, 0)
    total = counts.sum()  # pair demand before any clipping

    # 1. Overflow policy: keep the (depth, id)-ordered prefix of whole
    #    gaussians whose cumulative pair count fits the capacity.
    dkey = depth_key(depth)
    order = torch.sort(dkey, stable=True).indices
    keep_sorted = torch.cumsum(counts[order], 0) <= max_pairs
    keep = torch.empty_like(keep_sorted)
    keep[order] = keep_sorted
    gaussian_counts = torch.where(keep, counts, 0)
    num_pairs = gaussian_counts.sum()

    # 2. Owning gaussian of every pair slot; the filler segment (id N)
    #    covers the slots past num_pairs, so the output size is exact.
    seg_counts = torch.cat([gaussian_counts, (max_pairs - num_pairs).reshape(1)])
    offsets = torch.cumsum(seg_counts, 0) - seg_counts
    pair_gid = torch.repeat_interleave(
        torch.arange(n + 1, device=dev), seg_counts, output_size=max_pairs
    )
    valid = pair_gid < n
    gid = pair_gid.clamp(max=max(n - 1, 0))
    local = torch.arange(max_pairs, device=dev) - offsets[pair_gid]
    w = ntx[gid].clamp(min=1)
    tile_x = tx0[gid] + local % w
    tile_y = ty0[gid] + local // w
    tile_id = torch.where(valid, tile_y * n_tiles_x + tile_x, num_tiles)
    pair_dkey = torch.where(valid, dkey[gid], _DKEY_MAX)

    # 3. Per-tile pair counts: bincount of the valid pairs' tile ids (the
    #    sentinel bin num_tiles collects the unused slots).
    tile_count = torch.zeros(num_tiles + 1, dtype=i64, device=dev)
    tile_count.index_add_(0, tile_id, torch.ones_like(tile_id))
    tile_count = tile_count[:num_tiles]

    # 4. Alignment pads: per tile, pad_t sentinel pairs with that tile's key
    #    and the largest depth key, so they sort to the segment's tail.
    keys, dkeys, vals = tile_id, pair_dkey, pair_gid
    aligned_count = tile_count
    if align > 1:
        aligned_count = -(-tile_count // align) * align
        pad_t = aligned_count - tile_count  # in [0, align)
        pj = torch.arange(align - 1, device=dev)[None, :]
        ptile = torch.arange(num_tiles, device=dev)[:, None]
        pad_keys = torch.where(pj < pad_t[:, None], ptile, num_tiles).reshape(-1)
        keys = torch.cat([keys, pad_keys])
        dkeys = torch.cat([dkeys, torch.full_like(pad_keys, _DKEY_MAX)])
        vals = torch.cat([vals, torch.full_like(pad_keys, n)])

    # 5. One stable sort on (tile, depth key); ties keep buffer order, which
    #    is gaussian id order.
    perm = torch.sort((keys << 32) | dkeys, stable=True).indices
    i32 = torch.int32
    return TileBinning(
        pair_gaussian=vals[perm].to(i32),
        tile_start=(torch.cumsum(aligned_count, 0) - aligned_count).to(i32),
        tile_count=tile_count.to(i32),
        num_pairs=num_pairs.to(i32),
        pair_demand=total.to(i32),
        gaussian_counts=gaussian_counts.to(i32),
    )


def pack_feature_rows(prep: Preprocessed) -> torch.Tensor:
    """Per-gaussian raster features ``[N, 16]``: (mean_x, mean_y,
    conic_x/y/xy, opacity, r, g, b, bbox x4, pad x3)."""
    dtype = prep.screen_means.dtype
    return torch.cat(
        [
            prep.screen_means,
            prep.conics,
            prep.opacity[:, None],
            prep.rgb,
            prep.bbox.to(dtype),
            prep.screen_means.new_zeros((prep.depth.shape[0], 3)),
        ],
        dim=-1,
    )


def pack_features(prep: Preprocessed) -> torch.Tensor:
    """:func:`pack_feature_rows` plus row ``N``, the zero row that sentinel
    pairs point at (empty bbox => contributes exactly nothing). The bbox
    rides along because the reference evaluates only pixels inside a
    gaussian's bbox (rasterize.py:271-275)."""
    feat = pack_feature_rows(prep)
    return torch.cat([feat, feat.new_zeros((1, feat.shape[-1]))])
