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

``backward_tiles_carry`` is the kernel's carry form (the TPU's
``backward_tiles_carry``), one depth slice of ``render/sliced.py``'s
backward: the walk starts from a per-pixel state ``[T, 2, npix]`` (row 0 the
cotangent-contracted suffix signal S, row 1 the running T) and returns the
state after the slice, so slices walked front to back take the steps of one
walk. :func:`walk_state` builds the first state exactly as the kernel
starts its walk. It keeps its own launch count.

A tile of edge above 64 is cut into pixel groups, one thread block each
(``kernels/cull.py`` ``group_layout``), all walking to the tile's
``blocks_done``. Group 0 writes its per-pair sums into the rows, every
other group into partial rows ``[G - 1, P, 9]``, which are then added to
them in group order, so the rows are bitwise repeatable.

Without ``gaussian_counts`` (a depth slice's pairs, or a compacted subset of
a frame's) the rows reduce by :func:`reduce_sorted`, which finds each
gaussian's segment in the id-sorted rows itself; :func:`reduce_compacted`
is the unsliced backward's compacted reduction (``RasterConfig.reduce_pairs``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.kernels import build, cull
from gsplat_tpu_torch.ops import binning as B
from gsplat_tpu_torch.ops.compositing import MAX_GAUSSIAN_DENSITY_F32, MIN_ALPHA_F32, gaussian_alpha
from gsplat_tpu_torch.render.tile_torch import tile_pixel_coords
from gsplat_tpu_torch.utils import stages

NUM_GRAD = 9  # gradient columns per pair row: FEAT_MEAN_X .. FEAT_B

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (
    _P, _P, _P, _P, _P, _P,  # feat, pair_gaussian, tile_start, tile_count, tile_ids, blocks_done
    _P, _P, _P, _P, _P,  # color, trans, g_color, g_trans, carry_in
    _I, _I, _I, _I,  # num_tiles, n_tiles_x, tile_size, pair_block
    _F, _F,  # min_alpha, max_alpha
    _P, _P, _P,  # pair_grads, carry_out, stream
)
_GROUP_ARGTYPES = _ARGTYPES + (_P, _I)  # partials, num_pairs
_SCAN_BLOCK = 1024  # row length of the blocked cumsum


def _sum_round(tile_size: int, pair_block: int) -> int:
    """Pairs per round of the kernel's pixel sums (csrc/raster_bwd.cu
    ``sum_round``): the whole staged sub-batch where its warp slots fit in
    shared memory beside the staging, else 32. The warps are a block's:
    those of a pixel group above 64."""
    sub = min(pair_block, cull.SUB_ROWS)
    whole = cull.staging_bytes(pair_block) + cull.warp_layout(tile_size)[2] * sub * NUM_GRAD * 4
    return sub if whole <= cull.MAX_SMEM else 32


def _smem_bytes(tile_size: int, pair_block: int) -> int:
    """The kernel's shared memory (csrc/raster_bwd.cu): the staging
    pipeline's, and the warps' pixel sums of one round, [warps, round,
    9]."""
    warps = cull.warp_layout(tile_size)[2]
    return cull.staging_bytes(pair_block) + warps * _sum_round(tile_size, pair_block) * NUM_GRAD * 4


def walk_state(color: torch.Tensor, trans: torch.Tensor, g_color: torch.Tensor, g_trans: torch.Tensor) -> torch.Tensor:
    """The backward walk's first state ``[T, 2, npix]`` from the forward's
    final ``color``/``trans`` and their cotangents: row 0
    ``S = ((g0*c0 + g1*c1) + g2*c2) + gT*T``, row 1 ``T = 1``, added in the
    order and rounding the kernel starts its walk with (csrc/raster_bwd.cu)."""
    g0, g1, g2 = (g_color[..., i] for i in range(3))
    s_sig = g0 * color[..., 0] + g1 * color[..., 1] + g2 * color[..., 2] + g_trans * trans
    return torch.stack([s_sig, torch.ones_like(s_sig)], dim=1)


def backward_tiles_plain(
    feat: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tile_ids: torch.Tensor,
    color: Optional[torch.Tensor],
    trans: Optional[torch.Tensor],
    g_color: torch.Tensor,
    g_trans: Optional[torch.Tensor],
    n_tiles_x: int,
    cfg: RasterConfig,
    blocks_done: Optional[torch.Tensor] = None,
    carry_in: Optional[torch.Tensor] = None,
):
    """The kernel's function in plain PyTorch, vectorized over tiles.

    Walks pair blocks up to the longest tile's walk (one host sync for it,
    one for the largest count, where the last block stops).
    Within a block, alphas are recomputed ``chunk_size`` pairs at a time
    through ``gaussian_alpha`` and the walk runs pair by pair in the
    kernel's order and rounding; the per-pixel terms are then summed over
    each tile's pixels. Returns the per-pair rows ``[P, 9]``.

    With ``carry_in`` (``[T, 2, npix]``, see :func:`walk_state`) the walk
    starts from that state, ``color``/``trans``/``g_trans`` are not read,
    and it returns ``(rows, carry_out)``, the state after the walk.
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
    state = walk_state(color, trans, g_color, g_trans) if carry_in is None else carry_in
    s_sig, t_run = state[:, 0], state[:, 1]
    rows = torch.zeros((num_p + 1, NUM_GRAD), dtype=dtype, device=dev)  # row P: unwalked slots
    pairs = pair_gaussian.long()
    sentinel = feat.shape[0] - 1
    lane = torch.arange(cs, device=dev)
    max_walk = int(walk.max()) if num_t else 0
    max_count = int(count.max()) if num_t else 0
    for b in range(max_walk):
        live = b < walk
        # Chunks past every tile's count would walk alpha 0 only.
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
    if carry_in is None:
        return rows[:num_p]
    return rows[:num_p], torch.stack([s_sig, t_run], dim=1)


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
    args = (feat, pair_gaussian, tile_start, tile_count, tile_ids)
    if feat.device.type == "cpu":
        return backward_tiles_plain(*args, color, trans, g_color, g_trans, n_tiles_x, cfg, blocks_done)
    rows, _ = _launch("backward_tiles", args, blocks_done, (color, trans, g_color, g_trans), None, n_tiles_x, cfg)
    backward_tiles.launches += 1
    return rows


def backward_tiles_carry(
    feat: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tile_ids: torch.Tensor,
    carry_in: torch.Tensor,
    g_color: torch.Tensor,
    n_tiles_x: int,
    cfg: RasterConfig,
    blocks_done: Optional[torch.Tensor] = None,
):
    """One depth slice of the backward walk: per-pair rows ``[P, 9]`` of
    this slice's binned pairs and the walk state after it, starting from
    ``carry_in [T, 2, npix]`` (:func:`walk_state` for the first slice).
    ``g_color`` is the colour cotangent ``[T, npix, 3]``; ``blocks_done`` the
    forward's count for this slice. The CUDA kernel's carry form for CUDA
    tensors, the plain version for CPU tensors. Returns (rows, carry_out)."""
    args = (feat, pair_gaussian, tile_start, tile_count, tile_ids)
    if feat.device.type == "cpu":
        return backward_tiles_plain(*args, None, None, g_color, None, n_tiles_x, cfg, blocks_done, carry_in)
    out = _launch("backward_tiles_carry", args, blocks_done, (None, None, g_color, None), carry_in, n_tiles_x, cfg)
    backward_tiles_carry.launches += 1
    return out


def _launch(who, args, blocks_done, outs, carry_in, n_tiles_x, cfg):
    """Check the inputs and launch the kernel on the current stream.
    ``outs`` is (color, trans, g_color, g_trans); with ``carry_in`` only
    ``g_color`` is read. Returns (rows, carry_out or None)."""
    feat, pair_gaussian, tile_start, tile_count, tile_ids = args
    if feat.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {feat.device}")
    num_t = tile_ids.shape[0]
    npix = cfg.tile_size * cfg.tile_size
    # The tiling first: the shared memory of the sums is counted for a tiling the kernel takes.
    cull.check_tiling(who, cfg.tile_size, cfg.pair_block, cull.staging_bytes(cfg.pair_block))
    cull.check_tiling(who, cfg.tile_size, cfg.pair_block, _smem_bytes(cfg.tile_size, cfg.pair_block))
    f32, i32 = torch.float32, torch.int32
    shapes = {"color": (num_t, npix, 3), "trans": (num_t, npix), "g_color": (num_t, npix, 3),
              "g_trans": (num_t, npix), "carry_in": (num_t, 2, npix)}
    checked = [
        ("feat", feat, f32), ("pair_gaussian", pair_gaussian, i32), ("tile_start", tile_start, i32),
        ("tile_count", tile_count, i32), ("tile_ids", tile_ids, i32), ("blocks_done", blocks_done, i32),
        *zip(("color", "trans", "g_color", "g_trans"), outs, (f32,) * 4), ("carry_in", carry_in, f32),
    ]
    checked = [c for c in checked if c[1] is not None]
    for name, t, dtype in checked:
        if t.device != feat.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{who}: {name} must be a contiguous {dtype} tensor on "
                f"{feat.device}, got {t.dtype} on {t.device}"
            )
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{who}: {name} must be {shapes[name]}, got {tuple(t.shape)}")
    if feat.dim() != 2 or feat.shape[1] != B.NUM_FEATURES or feat.data_ptr() % 16:
        raise ValueError(f"{who}: feat must be a 16-byte aligned [N+1, 16], got {tuple(feat.shape)}")
    if pair_gaussian.dim() != 1 or any(
        t.shape != (num_t,) for t in (tile_start, tile_count) + ((blocks_done,) if blocks_done is not None else ())
    ):
        raise ValueError(f"{who}: pair_gaussian must be 1-D and tile_start/tile_count/blocks_done [T]")
    num_p = pair_gaussian.shape[0]
    groups = cull.group_layout(cfg.tile_size)[0] ** 2
    pair_grads = torch.zeros((num_p, NUM_GRAD), dtype=f32, device=feat.device)
    carry_out = None if carry_in is None else torch.empty_like(carry_in)
    stream = torch.cuda.current_stream(feat.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    common = (
        *(t.data_ptr() for t in args), ptr(blocks_done), *(ptr(t) for t in outs), ptr(carry_in),
        num_t, n_tiles_x, cfg.tile_size, cfg.pair_block, MIN_ALPHA_F32, MAX_GAUSSIAN_DENSITY_F32,
        pair_grads.data_ptr(), ptr(carry_out), stream,
    )
    if groups == 1:
        err = build.load_function("raster_bwd", "gsplat_raster_bwd", _ARGTYPES)(*common)
    else:
        partials = torch.zeros((groups - 1, num_p, NUM_GRAD), dtype=f32, device=feat.device)
        err = build.load_function("raster_bwd", "gsplat_raster_bwd_groups", _GROUP_ARGTYPES)(
            *common, partials.data_ptr(), num_p)
    if err != 0:
        raise RuntimeError(f"raster_bwd kernel launch failed with cudaError_t {err}")
    if groups > 1:
        for part in partials:  # group order: ((group 0 + group 1) + group 2) + ...
            pair_grads += part
    return pair_grads, carry_out


backward_tiles.launches = 0  # kernel launches since the count was last reset
backward_tiles_carry.launches = 0


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
    bitwise repeatable there. Counts ``P`` into the tracer's
    ``reduced_pairs``.
    """
    n = num_rows - 1
    stages.count("reduced_pairs", pair_gaussian.shape[0])
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


def reduce_exact(
    pair_grads: torch.Tensor,
    pair_gaussian: torch.Tensor,
    gaussian_counts: Optional[torch.Tensor],
    num_rows: int,
) -> torch.Tensor:
    """The exact reduction (``RasterConfig.exact_grad_reduction``; the JAX
    package's exact segment sum, ``gsplat_tpu/kernels/raster_bwd.py:531``):
    :func:`reduce_pair_grads` taken in float64 and rounded to float32 once,
    so each gaussian's row is its pairs' sum whatever pairs lie around it in
    the cumsum. No atomics (each gaussian's pair count, where
    ``gaussian_counts`` is None, is an integer ``index_add_``): bitwise
    repeatable on the card."""
    if gaussian_counts is None:
        gaussian_counts = pair_counts(pair_gaussian, num_rows)
    return reduce_pair_grads(pair_grads.double(), pair_gaussian, gaussian_counts, num_rows).float()


def pair_counts(pair_gaussian: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Pairs of each gaussian ``[num_rows - 1]`` int64, in id order, by an
    integer ``index_add_`` over the ids (sentinel pairs, id ``N``, are not
    counted)."""
    counts = torch.zeros(num_rows, dtype=torch.int64, device=pair_gaussian.device)
    counts.index_add_(0, pair_gaussian.long(), torch.ones_like(pair_gaussian, dtype=torch.int64))
    return counts[:-1]


def reduce_sorted(
    pair_grads: torch.Tensor,
    pair_gaussian: torch.Tensor,
    num_rows: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum per-pair rows ``[P, 9]`` into per-gaussian rows ``[num_rows, 16]``
    where no ``gaussian_counts`` describes the pairs (one depth slice's
    pairs, or a compacted subset of a frame's), as the JAX package's sliced
    backward does (``gsplat_tpu/render/sliced.py`` ``reduce_sorted``).

    The rows are sorted by id (stable) and scanned by :func:`blocked_cumsum`
    as in :func:`reduce_pair_grads`; each id's segment ends where the sorted
    ids change, and its sum is the cumsum there less the cumsum at the
    segment end before it (0 before the first): the same values at the same
    positions as :func:`reduce_pair_grads` with each id's pair count, so
    bitwise its result. No float atomics and no host sync: bitwise
    repeatable on the card.

    ``[K, P, 9]`` rows and ``[K, P]`` ids are K sets of pairs, each reduced
    on its own as above (its own sort, cumsum and segments), in one pass:
    the depth slices of one backward, whose ids are disjoint but for the
    sentinel.

    Each segment's sum is written into the first 9 columns of its id's row
    of ``out`` (a new zeroed ``[num_rows, 16]`` if None), which is
    returned; the rest of ``out`` is left as it is. Its sentinel row ``N``
    (the sentinel pairs' id) must be zero and stays so. So the cost is the
    pairs', ``O(K P)``, beside ``out`` itself. Counts ``K P`` into the
    tracer's ``reduced_pairs``.
    """
    n, p = num_rows - 1, pair_gaussian.shape[-1]
    if out is None:
        out = pair_grads.new_zeros((num_rows, B.NUM_FEATURES))
    stages.count("reduced_pairs", pair_gaussian.numel())
    if n == 0 or pair_gaussian.numel() == 0:
        return out
    ids, order = torch.sort(pair_gaussian.reshape(-1, p), dim=1, stable=True)  # [K, P]
    grads = pair_grads.reshape(-1, p, NUM_GRAD).transpose(1, 2)
    by_id = grads.gather(2, order[:, None].expand_as(grads))  # [K, 9, P]
    # Each set's cumsum on its own [9, P], as a call for that set alone
    # takes it: how the card's scan associates its additions follows the shape.
    cum = torch.cat([blocked_cumsum(x) for x in by_id], 1)  # [9, K P]
    # Segments end where the sorted ids change and at each set's last
    # position; the j-th end's position goes to ends[j].
    is_end = F.pad(ids[:, 1:] != ids[:, :-1], (0, 1), value=True).view(-1)
    nth = is_end.cumsum(0)
    pos = torch.arange(nth.shape[0], device=nth.device)
    ends = nth.new_zeros(nth.shape[0] + 1).index_copy_(0, nth * is_end, pos)[1:]
    at_end = cum.index_select(1, ends)
    # Less the cumsum at the segment end before, 0 before a set's first.
    before = F.pad(at_end[:, :-1], (1, 0))
    if ids.shape[0] > 1:
        before = torch.where(F.pad(ends[:-1] % p == p - 1, (1, 0)), 0.0, before)
    sums = at_end - before
    # The slots past the last segment repeat the segments (slot j writes
    # segment j mod count), so every write lands on a segment's own row
    # with its own sum and none is masked; the sentinel's segments write
    # row N, zeroed after.
    seg = pos % nth[-1]
    out[:, :NUM_GRAD].index_copy_(0, ids.view(-1)[ends[seg]].long(), sums.t()[seg])
    out[n].zero_()
    return out


def written_slots(tile_start: torch.Tensor, blocks_done: torch.Tensor, total_blocks: int, pair_block: int) -> torch.Tensor:
    """Pair slots of the blocks a backward walk wrote: each tile's first
    ``blocks_done`` blocks from ``tile_start``, tile after tile;
    ``total_blocks`` is ``blocks_done.sum()`` (a host int: it sizes the
    result without a sync). Returns ``[total_blocks * pair_block]`` int64."""
    dev = tile_start.device
    done = blocks_done.long()
    first = torch.cumsum(done, 0) - done  # each tile's first compact block
    tile = torch.repeat_interleave(torch.arange(done.shape[0], device=dev), done, output_size=total_blocks)
    blk = tile_start.long()[tile] // pair_block + torch.arange(total_blocks, device=dev) - first[tile]
    return (blk[:, None] * pair_block + torch.arange(pair_block, device=dev)).reshape(-1)


def reduce_compacted(
    pair_grads: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    blocks_done: torch.Tensor,
    total_blocks: int,
    pair_block: int,
    num_rows: int,
) -> torch.Tensor:
    """The compacted reduction (``gsplat_tpu/kernels/raster_bwd.py:576-620``):
    gather only the blocks the walk wrote (``written_slots``) and reduce
    those with :func:`reduce_sorted`. Every other row is zero, so the sum is
    the full reduction's, over far fewer rows when early stop ended most
    tiles early."""
    slots = written_slots(tile_start, blocks_done, total_blocks, pair_block)
    return reduce_sorted(pair_grads[slots], pair_gaussian[slots], num_rows)
