"""Depth-sliced binning and rasterization (the real-density path).

The counterpart of ``gsplat_tpu/render/sliced.py``. The single-sort
pipeline (``ops/binning.py``) sorts every (tile, gaussian) pair of the view
before the compositor runs, while at real MipNeRF-360 density early stop
composites only a few percent of the pair blocks. Here the pair-scale work
is done lazily, front to back, one depth slice of ``cfg.slice_pairs`` pairs
at a time:

  1. The gaussians are sorted once by depth (``_prepare_sliced``), ties in
     id order: (depth, id), the reference's stable argsort.
  2. A slice is the longest run of the remaining gaussians, in that order,
     whose pairs fit ``slice_pairs`` (``_bin_slice``). Its pairs are emitted
     in depth order, so ONE stable sort by tile orders each tile's pairs
     front to back; alignment pads follow each tile's pairs.
  3. The forward compositor's carry form (``kernels/raster_fwd.py``
     ``forward_tiles_carry``) resumes every tile from the colour and T the
     previous slices left. A tile whose coverable pixels all have T below
     ``cfg.early_stop_transmittance`` is done: later slices give it no pairs
     (``countc = where(done, 0, tile_count)``), and gaussians whose rect
     touches only done tiles are culled before the next slice is cut
     (``_alive_mask``). The loop ends when every tile is done, the
     gaussians run out, or ``ceil(max_pairs / slice_pairs)`` slices ran
     (the deepest whole gaussians are then dropped, as binning drops them).

The loop is a Python loop: deciding whether to cut another slice reads one
flag on the host, one synchronisation per slice after the first
(``SliceRecords.host_syncs``). The JAX package's window fast path
(``gsplat_tpu/render/sliced.py:334-399``) emits the same pairs as its exact
full-N branch and exists for the TPU's gather costs; only the full-N branch
is ported. Pair counts are summed in int64.

Pair slots hold ORIGINAL gaussian ids and the kernels gather rows of the
id-ordered ``feat`` themselves, so there is no per-pair feature slab to
build or keep, and the gradient reduction lands in id order directly.

With early stop off, a tile's pairs are composited in the same order as by
the single-sort path and the carry is the exact f32 state, so the image and
T equal the single-sort forward's bitwise (the TPU kernels re-chunk their
scans at slice boundaries and differ by 1-2 ulp, ``sliced.py:55-57``).

The backward (``_RasterizeSliced.backward``) walks the executed slices front
to back with the backward compositor's carry form, threading the walk state
(``kernels/raster_bwd.py`` ``backward_tiles_carry``). Each slice's rows
reduce by ``reduce_sorted``, each slice on its own (its sort, cumsum and
segments), all in one pass after the walk, straight into the backward's one
``d_feat``, zeroed once: the slices partition the gaussians, so each writes
only its own ids' rows, and the reduction costs the pairs, not the pool. With
``cfg.reduce_pairs > 0`` the walked blocks of all slices are gathered (in
one pass too) into one buffer and reduced once instead, when they fit it;
the forward's
``blocks_done`` already says whether they do (one host sync), so an
overflow takes the per-slice reduction without a second walk and gives its
result bitwise.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles_carry, reduce_sorted, walk_state, written_slots
from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles_carry
from gsplat_tpu_torch.ops import binning as B
from gsplat_tpu_torch.ops.projection import Preprocessed
from gsplat_tpu_torch.render.tile_torch import tile_pixel_coords
from gsplat_tpu_torch.utils import stages
from gsplat_tpu_torch.utils.stages import stage


def _grid(width: int, height: int, ts: int) -> Tuple[int, int, int]:
    ntxg = -(-width // ts)
    ntyg = -(-height // ts)
    return ntxg, ntyg, ntxg * ntyg


def _sizes(cfg: RasterConfig, num_tiles: int) -> Tuple[int, int, int]:
    """(k_max, padcap, s_store): the most slices that run, the alignment
    pads a slice can need, and the length of a slice's pair buffer.
    (``RasterConfig`` already holds ``slice_pairs`` to a ``pair_block``
    multiple; the tile count is known only here.)"""
    align, s_cap = cfg.pair_block, cfg.slice_pairs
    if s_cap < num_tiles:
        raise ValueError(
            f"slice_pairs ({s_cap}) must be at least the frame's tile count ({num_tiles}), "
            "the most pairs one gaussian can have, so that every slice makes progress"
        )
    k_max = max(-(-cfg.max_pairs // s_cap), 1)
    padcap = num_tiles * (align - 1)
    s_store = -(-(s_cap + padcap) // align) * align
    return k_max, padcap, s_store


class DepthOrder(NamedTuple):
    """The gaussians in (depth, id) order, each ``[N]`` int64: original id,
    tile rect ``(tx0, ty0, ntx, nty)`` and pair count (0 if inactive)."""

    order: torch.Tensor
    tx0: torch.Tensor
    ty0: torch.Tensor
    ntx: torch.Tensor
    nty: torch.Tensor
    count: torch.Tensor


class SliceRecords(NamedTuple):
    """What the forward loop keeps of each executed slice (the TPU loop's
    ``ids``/``starts``/``countc``/``bdone`` rows) for the backward, and
    ``gb``: the sorted-axis position each slice ended at, after a leading 0."""

    ids: List[torch.Tensor]  # [s_store] int32 original id per pair slot (N: none)
    starts: List[torch.Tensor]  # [T] int32
    countc: List[torch.Tensor]  # [T] int32 pairs composited (0 for done tiles)
    bdone: List[torch.Tensor]  # [T] int32 blocks composited by this slice
    gb: List[torch.Tensor]  # 0-d int64
    host_syncs: int


def _prepare_sliced(prep: Preprocessed, ts: int, ntxg: int, ntyg: int) -> DepthOrder:
    """One stable sort of the gaussians by depth key; the ids and tile
    rects follow it."""
    rects = torch.stack(B.tile_ranges(prep.cull_bbox, ts, ntxg, ntyg)).long()  # [4, N]
    order = torch.sort(B.depth_key(prep.depth), stable=True).indices
    tx0, ty0, ntx, nty = rects[:, order]
    count = torch.where(prep.active[order], ntx * nty, 0)
    return DepthOrder(order, tx0, ty0, ntx, nty, count)


def _alive_mask(done: torch.Tensor, g0: torch.Tensor, d: DepthOrder, ntxg: int, ntyg: int, es: float) -> torch.Tensor:
    """Gaussians not yet consumed (sorted position ``>= g0``) whose rect
    still touches a tile that is not done: the number of not-done tiles in
    each rect, from a summed-area table of the tile grid (exact integers)."""
    alive = torch.arange(d.order.shape[0], device=g0.device) >= g0
    if es <= 0.0:
        return alive
    table = F.pad((~done).reshape(ntyg, ntxg).long().cumsum(0).cumsum(1), (1, 0, 1, 0)).reshape(-1)
    w = ntxg + 1
    x1, y1 = d.tx0 + d.ntx, d.ty0 + d.nty
    hits = table[y1 * w + x1] - table[d.ty0 * w + x1] - table[y1 * w + d.tx0] + table[d.ty0 * w + d.tx0]
    return alive & (hits > 0)


def _bin_slice(d: DepthOrder, alive: torch.Tensor, n: int, ntxg: int, num_tiles: int, cfg: RasterConfig):
    """Cut and bin one slice. Returns (pair_ids [s_store] int32, tile_start
    [T] int32, tile_count [T] int64, g1 0-d int64: where the slice ends on
    the sorted axis)."""
    dev = alive.device
    align, s_cap = cfg.pair_block, cfg.slice_pairs
    _, padcap, s_store = _sizes(cfg, num_tiles)
    cum = torch.cumsum(torch.where(alive, d.count, 0), 0)  # int64
    # The longest prefix that fits: g1 is the first position with cum > s_cap.
    g1 = torch.searchsorted(cum, torch.full((1,), s_cap, dtype=cum.dtype, device=dev), right=True)
    pairs_k = torch.where(g1 > 0, cum.gather(0, (g1 - 1).clamp(min=0)), 0)  # [1]: no host sync
    stages.count("pairs", pairs_k)
    g1 = g1[0]
    cnt_k = torch.where(alive & (torch.arange(n, device=dev) < g1), d.count, 0)
    # Segment decode: each slot's owning gaussian (the first position whose
    # clamped inclusive count exceeds the slot) and its offset in it.
    slot = torch.arange(s_cap, device=dev)
    cum_slice = cum.clamp(max=pairs_k)
    owner = torch.searchsorted(cum_slice, slot, right=True).clamp(max=n - 1)
    local = slot - (cum_slice[owner] - cnt_k[owner])
    w = d.ntx[owner].clamp(min=1)
    valid = slot < pairs_k
    key = torch.where(valid, (d.ty0[owner] + local // w) * ntxg + d.tx0[owner] + local % w, num_tiles)
    vals = torch.where(valid, d.order[owner], n)
    tile_count = torch.zeros(num_tiles + 1, dtype=torch.int64, device=dev)
    tile_count.index_add_(0, key, torch.ones_like(key))
    tile_count = tile_count[:num_tiles]
    # Alignment pads, sorting after each tile's pairs; then ONE stable sort
    # by tile (emission order is depth order).
    aligned = -(-tile_count // align) * align
    pj = torch.arange(align - 1, device=dev)[None, :]
    ptile = torch.arange(num_tiles, device=dev)[:, None]
    pad_keys = torch.where(pj < (aligned - tile_count)[:, None], ptile, num_tiles).reshape(padcap)
    keys = torch.cat([key, pad_keys])
    vals = torch.cat([vals, torch.full_like(pad_keys, n)])
    perm = torch.sort(keys, stable=True).indices
    pair_ids = F.pad(vals[perm], (0, s_store - s_cap - padcap), value=n).to(torch.int32)
    tile_start = (torch.cumsum(aligned, 0) - aligned).to(torch.int32)
    return pair_ids, tile_start, tile_count, g1


def _forward_impl(feat: torch.Tensor, d: DepthOrder, width: int, height: int, cfg: RasterConfig):
    """Run the slice loop, the stage ``slice_loop``. Returns (color
    [T, npix, 3], trans [T, npix], SliceRecords)."""
    with stage("slice_loop"):
        return _slice_loop(feat, d, width, height, cfg)


def _slice_loop(feat: torch.Tensor, d: DepthOrder, width: int, height: int, cfg: RasterConfig):
    dev = feat.device
    ts, es = cfg.tile_size, cfg.early_stop_transmittance
    ntxg, ntyg, num_tiles = _grid(width, height, ts)
    k_max, _, _ = _sizes(cfg, num_tiles)
    n = d.order.shape[0]
    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    color = torch.zeros((num_tiles, ts * ts, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((num_tiles, ts * ts), dtype=torch.float32, device=dev)
    # Done is judged on coverable pixels only (the reference's bbox clamp
    # leaves the last pixel row and column, and pixels outside the frame,
    # at T = 1 forever), as the kernel's own early stop is.
    px, py = tile_pixel_coords(tile_ids, ntxg, ts, torch.float32)
    inframe = ((px < width - 1) & (py < height - 1)).to(torch.float32)
    done = torch.zeros(num_tiles, dtype=torch.bool, device=dev)
    g0 = torch.zeros((), dtype=torch.int64, device=dev)
    rec = SliceRecords([], [], [], [], [g0], 0)
    syncs = 0
    go = n > 0 and num_tiles > 0
    while go:
        with stage("sliced_binning"):
            alive = _alive_mask(done, g0, d, ntxg, ntyg, es)
            pair_ids, tile_start, tile_count, g1 = _bin_slice(d, alive, n, ntxg, num_tiles, cfg)
            countc = torch.where(done, 0, tile_count).to(torch.int32)
        with stage("raster_fwd"):
            color, trans, bdone = forward_tiles_carry(
                feat, pair_ids, tile_start, countc, tile_ids, color, trans, ntxg, cfg, width, height
            )
        rec.ids.append(pair_ids)
        rec.starts.append(tile_start)
        rec.countc.append(countc)
        rec.bdone.append(bdone)
        rec.gb.append(g1)
        g0 = g1
        if len(rec.ids) == k_max:
            stages.count("slice_budget_hit", 1)
            break
        more = g1 < n
        if es > 0.0:
            done = done | ((trans * inframe).amax(dim=1) < es)
            more = more & ~done.all()
        with stages.sync("slice_sync"):
            go = bool(more)  # the one host sync of a slice
        syncs += 1
    stages.count("slices", len(rec.ids))
    return color, trans, rec._replace(host_syncs=syncs)


class _RasterizeSliced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, d, width, height, cfg):
        color, trans, rec = _forward_impl(feat, d, width, height, cfg)
        ctx.save_for_backward(feat, color, trans)
        ctx.rec, ctx.width, ctx.height, ctx.cfg = rec, width, height, cfg
        return color, trans

    @staticmethod
    @once_differentiable
    def backward(ctx, g_color, g_trans):
        feat, color, trans = ctx.saved_tensors
        with stage("slice_loop_bwd"):
            d_feat = _backward_impl(feat, color, trans, g_color.contiguous(), g_trans.contiguous(), ctx.rec,
                                    ctx.width, ctx.height, ctx.cfg)
        return d_feat, None, None, None, None


def _backward_impl(feat, color, trans, g_color, g_trans, rec: SliceRecords, width, height, cfg: RasterConfig):
    """d feat ``[N+1, 16]``: the executed slices walked front to back from
    the forward's final outputs, threading the walk state; per-slice or
    compacted reduction (see the module docstring)."""
    ntxg, _, num_tiles = _grid(width, height, cfg.tile_size)
    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=feat.device)
    n_rows = feat.shape[0]
    r_blk = cfg.reduce_pairs // cfg.pair_block
    walked = None  # blocks the slices walk, where they fit the compact buffer
    if r_blk > 0 and rec.bdone:
        with stages.sync("slice_sync"):
            walked = int(torch.stack(rec.bdone).sum())
        stages.count("reduction", int(walked <= r_blk))
        if walked > r_blk:
            walked = None  # overflow: the per-slice reduction
    carry = walk_state(color, trans, g_color, g_trans)
    rows_k = []
    for k in range(len(rec.ids)):
        with stage("raster_bwd"):
            rows, carry = backward_tiles_carry(
                feat, rec.ids[k], rec.starts[k], rec.countc[k], tile_ids, carry, g_color, ntxg, cfg, rec.bdone[k]
            )
        rows_k.append(rows)
    d_feat = feat.new_zeros((n_rows, B.NUM_FEATURES))
    if not rec.ids:
        return d_feat
    with stage("reduction"):
        rows, ids = torch.stack(rows_k), torch.stack(rec.ids)  # [K, s_store, 9], [K, s_store]
        if walked is None:  # each slice's pairs reduced on their own, in one pass
            return reduce_sorted(rows, ids, n_rows, out=d_feat)
        # The walked blocks of every slice, slice after slice.
        k, s_store = ids.shape
        starts = torch.stack(rec.starts).long() + torch.arange(0, k * s_store, s_store, device=ids.device)[:, None]
        slots = written_slots(starts.view(-1), torch.cat(rec.bdone), walked, cfg.pair_block)
        return reduce_sorted(rows.view(-1, rows.shape[-1])[slots], ids.view(-1)[slots], n_rows, out=d_feat)


def render_sliced_tiles(
    prep: Preprocessed,
    feat: torch.Tensor,
    width: int,
    height: int,
    cfg: RasterConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-sliced render of one view at tile level.

    ``prep``: the per-gaussian preprocess; ``feat``: ``[N+1, 16]`` packed
    features in original id order (``ops/binning.pack_features``), the
    differentiable surface. Returns (color ``[T, npix, 3]``, trans
    ``[T, npix]``) for the full tile grid. Under grad the forward keeps each
    slice's binning for the backward; otherwise nothing is kept.
    """
    ntxg, ntyg, num_tiles = _grid(width, height, cfg.tile_size)
    _sizes(cfg, num_tiles)  # refuse a slice size this frame cannot use
    with stage("depth_sort"):
        d = _prepare_sliced(prep, cfg.tile_size, ntxg, ntyg)
    if torch.is_grad_enabled() and feat.requires_grad:
        # While recording, the tiles' backward closes the span ``loss_bwd``.
        return stages.closes_backward("loss_bwd", *_RasterizeSliced.apply(feat, d, width, height, cfg))
    color, trans, _ = _forward_impl(feat, d, width, height, cfg)
    return color, trans
