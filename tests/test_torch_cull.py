"""The compositors' culling (``gsplat_tpu_torch/kernels/cull.py``) on the CPU.

Both CUDA compositors walk, in each warp, only the pairs whose alpha-bound
rect (``csrc/raster_common.cuh`` ``alpha_rect``; plain twin
``pair_alpha_rect``) meets the warp's pixel rect. That is exact only if the
rect is conservative: every pixel where a pair's gate and bbox pass lies
inside it. These tests check that on the fixture scenes, grown and shrunk,
and on hand-built rows at the rect's edges, and hold the rect to the JAX
package's binning cull rect (``gsplat_tpu/ops/projection.py``
``_alpha_cull_bbox``), which bounds the same gate from the covariance.

They also run a culled walk: the plain compositors with every pair's alpha
forced to 0 at the pixels of the 8x4 warp rects its rect misses (the grid of
rects from each tile's first pixel, rounded up past the tile's edge), which
must leave colour, T, ``blocks_done``, the backward rows and the carried
walk state bitwise unchanged, and check the tilings the kernels take (every
positive tile edge and pair block), how a tile's rects map onto warps, the
backward's shared memory, and the pixel groups of tiles above 64: the plain
forward run group by group, each group with its own early-stop vote and
then the resume to its tile's last group's block (``cull.resume_ranges``),
is bitwise the unsplit walk. The kernels themselves are held to the plain
versions on the card (``tests/test_torch_gpu.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsplat_tpu import RasterConfig as JRasterConfig
from gsplat_tpu.models.gaussians import GaussianModel as JModel
from gsplat_tpu.render.pipeline import preprocess as j_preprocess

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.kernels import cull
from gsplat_tpu_torch.kernels import raster_bwd, raster_fwd
from gsplat_tpu_torch.ops import binning as B
from gsplat_tpu_torch.ops.camera import CameraParams
from gsplat_tpu_torch.ops.compositing import MIN_ALPHA_F32, gaussian_alpha
from gsplat_tpu_torch.render.pipeline import preprocess
from gsplat_tpu_torch.render.tile_torch import tile_pixel_coords

from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

WIDTH, HEIGHT = 64, 48


def _scene(seed, n, grow):
    arrays = random_splat_arrays(np.random.default_rng(seed), n)
    arrays["log_scales"] += grow
    arrays["opacity_logits"] += grow
    return arrays


def _rows(arrays, cfg):
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    camera = CameraParams(**dataclasses.asdict(orbit_camera(0.15, width=WIDTH, height=HEIGHT)))
    with torch.no_grad():
        return B.pack_feature_rows(preprocess(model, camera, cfg))


def _passing(rows, width=WIDTH, height=HEIGHT):
    """[P, H, W] bool: where each row's gate and bbox pass on the pixel grid."""
    py, px = torch.meshgrid(torch.arange(height, dtype=torch.float32), torch.arange(width, dtype=torch.float32),
                            indexing="ij")

    def col(i):
        return rows[:, i, None, None]

    at = gaussian_alpha(px, py, *(col(i) for i in (B.FEAT_MEAN_X, B.FEAT_MEAN_Y, B.FEAT_CONIC_X, B.FEAT_CONIC_Y,
                                                  B.FEAT_CONIC_XY, B.FEAT_OPACITY)))
    inside = (px >= col(B.FEAT_X_MIN)) & (px < col(B.FEAT_X_MAX)) & (py >= col(B.FEAT_Y_MIN)) & (py < col(B.FEAT_Y_MAX))
    return at.valid & inside, px, py


def _assert_conservative(rows, width=WIDTH, height=HEIGHT):
    rect = cull.pair_alpha_rect(rows)
    ok, px, py = _passing(rows, width, height)
    r = rect[:, :, None, None]
    in_rect = (px >= r[:, 0]) & (px < r[:, 2]) & (py >= r[:, 1]) & (py < r[:, 3])
    escaped = ok & ~in_rect
    assert not escaped.any(), f"{int(escaped.sum())} passing pixels outside the rect of rows {escaped.flatten(1).any(1).nonzero().flatten().tolist()}"
    return rect, ok


@pytest.mark.parametrize("grow", [-1.5, 0.0, 1.0, 2.5])
def test_rect_is_conservative_on_scenes(grow):
    rows = _rows(_scene(11, 300, grow), tgs.RasterConfig(tile_size=16))
    rect, ok = _assert_conservative(rows)
    area = lambda r: ((r[:, 2] - r[:, 0]).clamp(min=0) * (r[:, 3] - r[:, 1]).clamp(min=0)).sum()
    bbox = rows[:, B.FEAT_X_MIN:B.FEAT_Y_MAX + 1]
    assert ok.any() and area(rect) < area(bbox), "the rect culls something"


def _row(mx=20.3, my=15.7, cx=0.5, cy=0.4, cxy=0.1, op=0.8, bbox=(0.0, 0.0, 64.0, 48.0)):
    r = torch.zeros(B.NUM_FEATURES)
    r[B.FEAT_MEAN_X], r[B.FEAT_MEAN_Y] = mx, my
    r[B.FEAT_CONIC_X], r[B.FEAT_CONIC_Y], r[B.FEAT_CONIC_XY], r[B.FEAT_OPACITY] = cx, cy, cxy, op
    r[B.FEAT_X_MIN:B.FEAT_Y_MAX + 1] = torch.tensor(bbox)
    return r


_ABOVE_MIN = float(np.nextafter(np.float32(MIN_ALPHA_F32), np.float32(1.0)))
BBOX = (0.0, 0.0, 64.0, 48.0)
HAND_ROWS = {
    # name: (row, expected rect or None to only check conservativeness)
    "sentinel": (torch.zeros(B.NUM_FEATURES), (0.0, 0.0, 0.0, 0.0)),
    "opacity_at_min": (_row(op=MIN_ALPHA_F32), (0.0, 0.0, 0.0, 0.0)),
    "opacity_below_min": (_row(op=0.5 * MIN_ALPHA_F32), (0.0, 0.0, 0.0, 0.0)),
    "opacity_just_above_min": (_row(mx=20.0, my=15.0, op=_ABOVE_MIN), None),
    "round": (_row(cxy=0.0), None),
    "thin": (_row(cx=2.0, cy=0.02, cxy=0.19), None),
    "near_singular_kept": (_row(cx=1.0, cy=1.0, cxy=0.99), None),
    "near_singular_falls_back": (_row(cx=1.0, cy=1.0, cxy=1.0 - 1e-6, bbox=(3.0, 4.0, 50.0, 40.0)), (3.0, 4.0, 50.0, 40.0)),
    "det_zero": (_row(cx=1.0, cy=1.0, cxy=1.0, bbox=(3.0, 4.0, 50.0, 40.0)), (3.0, 4.0, 50.0, 40.0)),
    "det_negative": (_row(cx=1.0, cy=1.0, cxy=2.0, bbox=(3.0, 4.0, 50.0, 40.0)), (3.0, 4.0, 50.0, 40.0)),
    "negative_conic": (_row(cx=-1.0, cy=-1.0, cxy=0.0, bbox=(3.0, 4.0, 50.0, 40.0)), (3.0, 4.0, 50.0, 40.0)),
    "huge_radius": (_row(cx=1e-9, cy=1e-9, cxy=0.0), BBOX),
    "nan_mean": (_row(mx=float("nan"), bbox=(3.0, 4.0, 50.0, 40.0)), (3.0, 4.0, 50.0, 40.0)),
    "inf_opacity": (_row(op=float("inf"), bbox=(3.0, 4.0, 50.0, 40.0)), (3.0, 4.0, 50.0, 40.0)),
    "outside_bbox": (_row(mx=60.0, my=45.0, cx=4.0, cy=4.0, cxy=0.0, bbox=(0.0, 0.0, 10.0, 10.0)), (0.0, 0.0, 0.0, 0.0)),
}


@pytest.mark.parametrize("name", sorted(HAND_ROWS))
def test_rect_edges(name):
    row, want = HAND_ROWS[name]
    rect, ok = _assert_conservative(row[None])
    if want is not None:
        assert rect[0].tolist() == list(want)
    if name == "opacity_just_above_min":  # passes at the mean's own pixel only
        assert ok[0, 15, 20] and int(ok.sum()) == 1 and rect[0, 2] > rect[0, 0]


def test_rect_holds_jax_cull_rect():
    """The JAX binning's alpha-bound rect (from the covariance) lies inside
    the kernel's (from the conic), which adds at most a pixel or two."""
    arrays = _scene(12, 400, 0.5)
    jcfg = JRasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=4096)
    jprep = j_preprocess(JModel.from_arrays(arrays), orbit_camera(0.15, width=WIDTH, height=HEIGHT), jcfg)
    rows = _rows(arrays, tgs.RasterConfig(tile_size=16))
    rect = cull.pair_alpha_rect(rows).numpy()
    jrect = np.asarray(jprep.cull_bbox).astype(np.float32)
    live = np.asarray(jprep.active) & (np.asarray(jprep.opacity) > MIN_ALPHA_F32) & (jrect[:, 2] > jrect[:, 0]) & (
        jrect[:, 3] > jrect[:, 1])
    assert live.sum() > 100
    r, j = rect[live], jrect[live]
    assert (r[:, :2] <= j[:, :2]).all() and (r[:, 2:] >= j[:, 2:]).all()
    assert (j[:, :2] - r[:, :2]).max() <= 2 and (r[:, 2:] - j[:, 2:]).max() <= 2


def _culled_alpha(px, py, mean_x, mean_y, conic_x, conic_y, conic_xy, opacity):
    """``gaussian_alpha`` of a walk culled by the kernels' warp rects: a
    pair's alpha is invalid at every pixel of a warp rect (the grid of
    ``cull.WARP_RECT`` rects from each tile's first pixel, rounded up past
    the tile's edge) that its alpha-bound rect misses. The plain versions
    call it with pixel coordinates ``[T, 1, npix]``, pixel 0 each tile's
    first."""
    ww, wh = cull.WARP_RECT
    at = gaussian_alpha(px, py, mean_x, mean_y, conic_x, conic_y, conic_xy, opacity)
    lead = torch.broadcast_tensors(mean_x, mean_y, conic_x, conic_y, conic_xy, opacity)
    rows = torch.zeros(lead[0].numel(), B.NUM_FEATURES)
    for i, v in zip((B.FEAT_MEAN_X, B.FEAT_MEAN_Y, B.FEAT_CONIC_X, B.FEAT_CONIC_Y, B.FEAT_CONIC_XY,
                     B.FEAT_OPACITY), lead):
        rows[:, i] = v.reshape(-1)
    rows[:, B.FEAT_X_MIN:B.FEAT_Y_MAX + 1] = torch.tensor([-1e6, -1e6, 1e6, 1e6])
    rect = cull.pair_alpha_rect(rows).reshape(*lead[0].shape, 4)
    ox, oy = px[..., :1], py[..., :1]  # each tile's first pixel
    # The grid of rects starts at the first pixel of each pixel's group (the tile's up to 64).
    edge = cull.group_layout(int(round(px.shape[-1] ** 0.5)))[1]
    ox, oy = ox + torch.floor((px - ox) / edge) * edge, oy + torch.floor((py - oy) / edge) * edge
    wx0, wy0 = ox + torch.floor((px - ox) / ww) * ww, oy + torch.floor((py - oy) / wh) * wh
    meets = ((torch.maximum(rect[..., 0], wx0) < torch.minimum(rect[..., 2], wx0 + ww))
             & (torch.maximum(rect[..., 1], wy0) < torch.minimum(rect[..., 3], wy0 + wh)))
    return at._replace(valid=at.valid & meets)


WALK_W, WALK_H = 48, 32
WALK_CFG = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 14)


@pytest.fixture(scope="module")
def binned_dense():
    """Splats grown until tiles saturate, so early stop ends some tiles."""
    model = tgs.GaussianModel.from_arrays(_scene(6, 300, 2.5), device="cpu")
    camera = CameraParams(**dataclasses.asdict(orbit_camera(0.15, width=WALK_W, height=WALK_H)))
    with torch.no_grad():
        prep = preprocess(model, camera, WALK_CFG)
        bins = B.bin_gaussians(prep, WALK_W, WALK_H, 16, WALK_CFG.max_pairs, align=WALK_CFG.pair_block)
    ntx = -(-WALK_W // 16)
    tile_ids = torch.arange(ntx * -(-WALK_H // 16), dtype=torch.int32)
    return (B.pack_features(prep), bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids), ntx, {}


def _walks(args, ntx, cfg):
    """Forward, backward and the carried backward of the plain versions."""
    color, trans, done = raster_fwd.forward_tiles_plain(*args, ntx, cfg, WALK_W, WALK_H)
    gen = torch.Generator().manual_seed(3)
    g_color, g_trans = torch.randn(color.shape, generator=gen), torch.randn(trans.shape, generator=gen)
    rows = raster_bwd.backward_tiles_plain(*args, color, trans, g_color, g_trans, ntx, cfg, done)
    state = raster_bwd.walk_state(color, trans, g_color, g_trans)
    c_rows, c_out = raster_bwd.backward_tiles_plain(*args, None, None, g_color, None, ntx, cfg, done, state)
    return color, trans, done, rows, c_rows, c_out


@pytest.mark.parametrize("stop", [0.0, 1e-4])
def test_culled_walk_is_exact(binned_dense, monkeypatch, stop):
    """Tile 16 with pair_block 8, so a batch is smaller than a ballot
    group."""
    args, ntx, plain = binned_dense
    cfg = dataclasses.replace(WALK_CFG, early_stop_transmittance=stop)
    if stop not in plain:
        plain[stop] = _walks(args, ntx, cfg)
    want = plain[stop]
    monkeypatch.setattr(raster_fwd, "gaussian_alpha", _culled_alpha)
    monkeypatch.setattr(raster_bwd, "gaussian_alpha", _culled_alpha)
    got = _walks(args, ntx, cfg)
    for name, g, w in zip(("color", "trans", "blocks_done", "rows", "carry rows", "carry out"), got, want):
        assert torch.equal(g, w), name
    if stop > 0:
        assert (want[2] < -(-args[3] // cfg.pair_block)).any(), "some tile stops early"


@pytest.mark.parametrize("tile,pair_block", [(12, 8), (20, 16), (4, 8), (40, 32), (65, 8), (100, 16)])
def test_culled_walk_is_exact_on_padded_grid(monkeypatch, tile, pair_block):
    """Tiles that are not a multiple of the 8x4 rect: the kernels round the
    grid of rects up past the tile's edge, and a pair whose alpha-bound
    rect meets only the part of a rect past the edge is still walked there
    (at pixels no lane owns). Tiles 65 and 100 are cut into pixel groups of
    edge 33 and 50, each with its own grid from its first pixel, rounded up
    past the group's edge into the next group. The culled walk stays
    bitwise the plain walk, early stop on and off."""
    model = tgs.GaussianModel.from_arrays(_scene(6, 300, 2.5), device="cpu")
    camera = CameraParams(**dataclasses.asdict(orbit_camera(0.15, width=WALK_W, height=WALK_H)))
    base = tgs.RasterConfig(tile_size=tile, chunk_size=8, pair_block=pair_block, max_pairs=1 << 15)
    with torch.no_grad():
        prep = preprocess(model, camera, base)
        bins = B.bin_gaussians(prep, WALK_W, WALK_H, tile, base.max_pairs, align=pair_block)
    ntx = -(-WALK_W // tile)
    tile_ids = torch.arange(ntx * -(-WALK_H // tile), dtype=torch.int32)
    args = (B.pack_features(prep), bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids)
    for stop in (0.0, 1e-4):
        cfg = dataclasses.replace(base, early_stop_transmittance=stop)
        want = _walks(args, ntx, cfg)
        with monkeypatch.context() as m:
            m.setattr(raster_fwd, "gaussian_alpha", _culled_alpha)
            m.setattr(raster_bwd, "gaussian_alpha", _culled_alpha)
            got = _walks(args, ntx, cfg)
        for name, g, w in zip(("color", "trans", "blocks_done", "rows", "carry rows", "carry out"), got, want):
            assert torch.equal(g, w), (stop, name)


def test_culling_removes_work(binned_dense):
    """On the dense scene the 8x4 warp rects skip a good share of the walked
    (warp, pair) evaluations."""
    (feat, pairs, start, count, tile_ids), ntx, _ = binned_dense
    slots = torch.cat([torch.arange(int(s), int(s) + int(c)) for s, c in zip(start, count)])
    tiles = torch.repeat_interleave(torch.arange(len(tile_ids)), count.long())
    rect = cull.pair_alpha_rect(feat[pairs[slots].long()])
    _, warps = cull.cull_counts(rect, (tiles % ntx) * 16, (tiles // ntx) * 16, 16)
    assert 0 < int(warps.sum()) < 0.9 * len(slots) * 8


def test_cull_counts_match_brute_force():
    rng = np.random.default_rng(4)
    lo = rng.integers(-20, 60, (200, 2))
    rect = torch.tensor(np.concatenate([lo, lo + rng.integers(-3, 40, (200, 2))], 1), dtype=torch.float32)
    ox = torch.tensor(rng.integers(0, 3, 200) * 16)
    oy = torch.tensor(rng.integers(0, 2, 200) * 16)
    pixels, warps = cull.cull_counts(rect, ox, oy, 16)
    for i in range(200):
        x0, y0, x1, y1 = rect[i].tolist()
        inside = [(x, y) for y in range(int(oy[i]), int(oy[i]) + 16) for x in range(int(ox[i]), int(ox[i]) + 16)
                  if x0 <= x < x1 and y0 <= y < y1]
        assert int(pixels[i]) == len(inside)
        assert int(warps[i]) == len({((x - int(ox[i])) // 8, (y - int(oy[i])) // 4) for x, y in inside})


@pytest.mark.parametrize("tile,pair_block,ok", [(16, 8, True), (32, 128, True), (8, 128, True), (16, 512, True),
                                                (16, 0, False), (12, 8, True), (4, 8, True), (64, 8, True),
                                                (16, 4096, True), (1, 8, True), (0, 8, False), (65, 8, True),
                                                (-3, 8, False), (128, 128, True), (256, 2048, True)])
def test_check_tiling(tile, pair_block, ok):
    """The kernels take every positive tile edge (above 64 as pixel groups)
    and every positive pair block; shared memory over ``MAX_SMEM`` is
    refused."""
    if ok:
        cull.check_tiling("k", tile, pair_block, 1024)
    else:
        with pytest.raises(ValueError, match="not supported"):
            cull.check_tiling("k", tile, pair_block, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        cull.check_tiling("k", 16, 8, cull.MAX_SMEM + 1)


@pytest.mark.parametrize("tile,pair_block,round_pairs", [(8, 128, 128), (16, 8, 8), (16, 512, 256), (24, 128, 128),
                                                          (32, 128, 128), (32, 256, 32), (32, 945, 32), (4, 8, 8),
                                                          (12, 2048, 256), (40, 2048, 32), (64, 128, 128),
                                                          (64, 4096, 32), (65, 128, 128), (100, 2048, 32),
                                                          (128, 128, 128), (256, 8, 8)])
def test_tilings_fit_shared_memory(tile, pair_block, round_pairs):
    """Every tiling fits both kernels' shared memory: the staging holds
    sub-batches of at most ``SUB_ROWS`` rows whatever the pair block, and
    the backward sums a whole sub-batch per round where the slots of its
    warps (at most 32, however many pixels the tile has) fit, else rounds
    of 32 pairs (``sum_round`` in ``csrc/raster_bwd.cu``). A tile above 64
    takes the shared memory of its pixel group's block."""
    warps = cull.warp_layout(tile)[2]
    assert raster_bwd._sum_round(tile, pair_block) == round_pairs
    bwd = raster_bwd._smem_bytes(tile, pair_block)
    assert bwd == cull.staging_bytes(pair_block) + warps * round_pairs * 9 * 4
    for smem in (cull.staging_bytes(pair_block), bwd):
        cull.check_tiling("k", tile, pair_block, smem)
    assert raster_bwd._smem_bytes(32, 128) == 173056  # 25,600 B of staging, 147,456 of warp slots


@pytest.mark.parametrize("tile,layout", [(1, (1, 1, 1)), (4, (1, 1, 1)), (12, (1, 1, 6)), (32, (1, 1, 32)),
                                         (33, (1, 2, 25)), (40, (1, 2, 25)), (44, (2, 2, 18)), (64, (2, 2, 32)),
                                         (65, (1, 2, 25)), (100, (2, 2, 28)), (128, (2, 2, 32)),
                                         (256, (2, 2, 32))])
def test_warp_layout(tile, layout):
    """One pixel a thread up to 32 rects, then 1x2 and 2x2 rects a warp;
    the rect grid covers the block's pixels: the tile up to 64, above it
    each of its n x n pixel groups (65: 2x2 groups of edge 33, 100: of 50,
    128: of 64, 256: 4x4 of 64), which tile the tile."""
    n, edge = cull.group_layout(tile)
    assert (n, edge) == ((1, tile) if tile <= 64 else {65: (2, 33), 100: (2, 50), 128: (2, 64), 256: (4, 64)}[tile])
    assert edge <= 64 and n * edge >= tile > (n - 1) * edge
    fx, fy, warps = cull.warp_layout(tile)
    assert (fx, fy, warps) == layout == cull.warp_layout(edge)
    rx, ry = cull.rect_grid(edge)
    assert rx * 8 >= edge > (rx - 1) * 8 and ry * 4 >= edge > (ry - 1) * 4
    assert -(-rx // fx) * -(-ry // fy) == warps <= 32
    pixels = cull.group_pixels(tile)
    assert len(pixels) == n * n
    assert torch.equal(torch.sort(torch.cat(pixels)).values, torch.arange(tile * tile))


@pytest.mark.parametrize("tile", [12, 20, 4, 65, 100])
def test_cull_counts_follow_the_padded_grid(tile):
    """``cull_counts`` on a tile that is not a multiple of the rect: the
    pixels are the tile's, the warp rects those of the grid rounded up past
    its edge that the rect meets (where a warp walks the pair); above 64,
    those of each pixel group's grid, rounded up past the group's edge."""
    rng = np.random.default_rng(tile)
    lo = rng.integers(-10, 3 * tile, (200, 2))
    rect = torch.tensor(np.concatenate([lo, lo + rng.integers(-2, 2 * tile, (200, 2))], 1), dtype=torch.float32)
    ox = torch.tensor(rng.integers(0, 3, 200) * tile)
    oy = torch.tensor(rng.integers(0, 2, 200) * tile)
    pixels, warps = cull.cull_counts(rect, ox, oy, tile)
    rx, ry = cull.rect_grid(cull.group_layout(tile)[1])
    for i in range(200):
        x0, y0, x1, y1 = rect[i].tolist()
        want_pixels = want_warps = 0
        for gx0, gy0, gx1, gy1 in cull.group_rects(tile):
            ox_i, oy_i = int(ox[i]) + gx0, int(oy[i]) + gy0
            grid = [(x, y) for y in range(oy_i, oy_i + 4 * ry) for x in range(ox_i, ox_i + 8 * rx)
                    if x0 <= x < x1 and y0 <= y < y1]
            want_pixels += sum(x < int(ox[i]) + gx1 and y < int(oy[i]) + gy1 for x, y in grid)
            want_warps += len({((x - ox_i) // 8, (y - oy_i) // 4) for x, y in grid})
        assert int(pixels[i]) == want_pixels
        assert int(warps[i]) == want_warps


def test_compositor_counts_match_brute_force(binned_dense):
    """``tools/card.py``'s ``pair_pixels`` (the counts behind the kernels'
    bounds) against a walk over every slot and pixel, and the bounds it
    feeds, with ``splatbench/counts.py``'s peaks and operations."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    import card
    from splatbench import counts as C

    args, ntx, _ = binned_dense
    feat, pairs, start, count, tile_ids = args
    cfg = WALK_CFG
    done = torch.tensor([1, 3, 2, 40, 0, 5], dtype=torch.int32)
    counts = card.pair_pixels(args, ntx, cfg, done, chunk=97)
    walked = rect_pixels = passed = warps = 0
    for t in range(len(tile_ids)):
        ox, oy = (t % ntx) * 16, (t // ntx) * 16
        n = min(int(count[t]), int(done[t]) * cfg.pair_block)
        rows = feat[pairs[int(start[t]):int(start[t]) + n].long()]
        ok, px, py = _passing(rows, WALK_W, WALK_H)
        in_tile = (px >= ox) & (px < ox + 16) & (py >= oy) & (py < oy + 16)
        rect = cull.pair_alpha_rect(rows)[:, :, None, None]
        in_rect = (px >= rect[:, 0]) & (px < rect[:, 2]) & (py >= rect[:, 1]) & (py < rect[:, 3]) & in_tile
        walked += n * 256
        passed += int((ok & in_tile).sum())
        rect_pixels += int(in_rect.sum())
        warp_of = ((px - ox) // 8 + 2 * ((py - oy) // 4)).long()
        warps += sum(len(set(warp_of[m].tolist())) for m in in_rect)
    assert counts == {"walked": walked, "rect": rect_pixels, "passed": passed, "warp_pairs": warps}
    assert passed <= rect_pixels < walked and warps * 32 >= rect_pixels
    bound = card.compositor_bound(counts, 10 ** 6, backward=True)
    assert bound["bound_ms"] <= bound["bound_unculled_ms"]
    assert bound["fp32_ms"] == (rect_pixels * C.GATE_OPS + passed * C.BWD_PASSED_OPS) / C.PEAK_FP32_OPS * 1e3
    fields = card.bound_fields(bound, 2.0)
    assert fields["share_of_bound"] == bound["bound_ms"] / 2.0 and fields["warp_pairs"] == warps
    assert fields["share_of_bound_unculled"] == bound["bound_unculled_ms"] / 2.0
    report = ["ptxas info    : Used 62 registers, used 1 barriers, 400 bytes cmem[0]",
              "ptxas info    : 8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads"]
    assert card.ptxas_resources(report) == {"registers": 62, "spill_stores": 4, "spill_loads": 12}


GROUP_W, GROUP_H = 160, 120


@pytest.fixture(scope="module")
def group_prep():
    """600 splats grown until tiles of 65 to 256 pixels stop early on a
    160x120 frame."""
    model = tgs.GaussianModel.from_arrays(_scene(6, 600, 3.0), device="cpu")
    camera = CameraParams(**dataclasses.asdict(orbit_camera(0.15, width=GROUP_W, height=GROUP_H)))
    with torch.no_grad():
        return preprocess(model, camera, WALK_CFG)


@pytest.mark.parametrize("stop", [0.0, 1e-4])
@pytest.mark.parametrize("tile", [65, 100, 128, 256])
def test_group_walk_is_the_tile_walk(group_prep, tile, stop):
    """The kernels' walk of a tile above 64 (``csrc/raster_fwd.cu``), in
    the plain version: each pixel group composited on its own
    (``raster_fwd.composite_pixels`` at the group's pixels), voting on its
    own coverable pixels, then, with early stop on, resumed from its colour
    and T over the blocks ``cull.resume_ranges`` gives it, the vote off.
    The frame is bitwise the unsplit plain walk's and the tile's
    ``blocks_done`` the most over its groups. On the 160x120 frame some
    groups lie wholly outside it (at tile 256, 10 of 16) and vote to stop
    after one block, as JAX's ``inframe`` mask has them."""
    cfg = tgs.RasterConfig(tile_size=tile, chunk_size=8, pair_block=8, max_pairs=1 << 15,
                           early_stop_transmittance=stop)
    bins = B.bin_gaussians(group_prep, GROUP_W, GROUP_H, tile, cfg.max_pairs, align=cfg.pair_block)
    ntx = -(-GROUP_W // tile)
    tile_ids = torch.arange(ntx * -(-GROUP_H // tile), dtype=torch.int32)
    feat = B.pack_features(group_prep)
    args = (feat, bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids)
    want = raster_fwd.forward_tiles_plain(*args, ntx, cfg, GROUP_W, GROUP_H)

    px, py = tile_pixel_coords(tile_ids, ntx, tile, torch.float32)
    votes = (px < GROUP_W - 1) & (py < GROUP_H - 1)
    groups = cull.group_pixels(tile)
    firsts = [raster_fwd.composite_pixels(*args[:4], px[:, idx], py[:, idx], votes[:, idx], cfg) for idx in groups]
    group_done = torch.stack([f[2] for f in firsts], dim=1)
    tile_done, start, count = cull.resume_ranges(group_done, bins.tile_start, bins.tile_count, cfg.pair_block)
    resume_cfg = dataclasses.replace(cfg, early_stop_transmittance=0.0)
    color, trans = torch.empty_like(want[0]), torch.empty_like(want[1])
    for g, (idx, (c, tr, _)) in enumerate(zip(groups, firsts)):
        if stop > 0:
            c, tr, done = raster_fwd.composite_pixels(feat, bins.pair_gaussian, start[:, g], count[:, g], px[:, idx],
                                                      py[:, idx], votes[:, idx], resume_cfg, carry=(c, tr))
            assert torch.equal(done, tile_done - group_done[:, g]), "the resume walks the blocks left"
        color[:, idx], trans[:, idx] = c, tr
    assert torch.equal(color, want[0]) and torch.equal(trans, want[1])
    assert torch.equal(tile_done, want[2])
    assert torch.equal(count.sum(1) == 0, (group_done == tile_done[:, None]).all(1))
    if stop > 0:
        assert (group_done < tile_done[:, None]).any(), "some group stops before its tile's last"
        assert (want[2] < -(-bins.tile_count // cfg.pair_block)).any(), "some tile stops early"
    else:
        assert torch.equal(group_done, tile_done[:, None].expand_as(group_done))
    if tile == 256:
        outside = [(x0 >= GROUP_W - 1) or (y0 >= GROUP_H - 1) for x0, y0, _, _ in cull.group_rects(tile)]
        assert sum(outside) == 10
