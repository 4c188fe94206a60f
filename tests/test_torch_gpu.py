"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package (nor ``fixtures.py``), so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

The forward kernel and its plain version round every product and sum
alike, so they are compared at rtol=1e-5 / atol=1e-6 and ``blocks_done``
must be equal. The backward kernel's per-pixel terms are rounded as in its
plain version too, but it sums them over a tile's pixels in another order
(warp shuffles, then warps in order). A sum of n f32 terms in another order
differs by up to about log2(n) * 6e-8 of the sum of the terms' magnitudes,
which exceeds the result where terms cancel (d conic at a pixel grows with
dx^2), so per-pair rows and reduced gradients are compared at rtol=1e-4 /
atol=1e-5 of the gradient's largest magnitude, and two runs of the kernel
must be bitwise equal.

The carry forms (``forward_tiles_carry``, ``backward_tiles_carry``) are held
to the same tolerances, on a frame split in two slices: the first two pair
blocks of every tile, then the rest, resumed from the carried state.

Both kernels walk, in each warp, only the pairs whose alpha-bound rect meets
the warp's pixel rect, and stage pair rows two batches ahead; hand-built
inputs (``_synthetic``) probe the edges of both, with the forward held
bitwise to its plain version.

The preprocess kernel (``kernels/preprocess.py``) is held to the eager
path it replaces: every output but rgb bitwise, rgb within
``kernels/preprocess.py``'s ``RGB_ATOL`` (the order of its sums), under a
gradient and with a screen offset too. Its backward kernel recomputes the
forward's intermediates bitwise and sums each gradient's terms in another
order than autograd through the eager path (FMA-contracted, chain-rule
products in registers): each gradient differs by a few roundings of its
largest terms, which exceeds the result where terms cancel, so the
gradients are held to the eager path's autograd at the backward
compositor's tolerance, rtol 1e-4 + atol 1e-5 of each column's largest
finite magnitude, and the screen offset's bitwise (it is the screen means'
cotangent). The colour's clamp has kinks at 0 and 1 (half the gradient
there, none beyond), and the two paths' colours differ by up to
``RGB_ATOL``: where either colour lies within it of a kink, the random
cotangent's rgb entry is zero, and the kinks are held on their own, at
colours both paths place exactly.

The loss kernels (``kernels/loss.py``, ``csrc/loss.cu``) are held to the
eager loss through autograd: the loss and mean SSIM within 1e-6 relative
(sums in another order), the gradient at the backward compositor's
tolerance (the blurs sum in another order and the combine's terms cancel),
two calls bitwise equal; on small and odd frames, a strided frame and the
headline's 1920x1080 frames at the eight ``orbit8`` poses.

Tiles above 64 run as pixel groups of one thread block each: the forward
with early stop on takes a second launch, the resume, counted apart
(``resume_launches``), and the backward adds the groups' partial rows in
group order. ``test_large_tiles_match_plain`` holds all four kernels to
their plain versions there, on a frame smaller than the largest tiles, so
that whole groups lie outside it.

Some tests also take full-size cases (``full_size``): the benchmark's
synthetic scenes (``tools/card.py``) at 1920x1080, the headline's 1M
gaussians in exact mode at tiles 16 to 128, and the dense scene's 5M at
the real-density settings, where tiles hold thousands of pairs. They run
with the rest under ``-m gpu``.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import sys
from typing import NamedTuple
from unittest import mock

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.kernels import loss as kl
from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles, backward_tiles_carry, backward_tiles_plain, reduce_pair_grads
from gsplat_tpu_torch.kernels.raster_bwd import walk_state
from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_carry, forward_tiles_plain
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.render.pipeline import preprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import card  # noqa: E402

pytestmark = pytest.mark.gpu
RTOL, ATOL = 1e-5, 1e-6
WIDTH, HEIGHT = 48, 32
CFG = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=8192)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene(device, n=800, grow=2.0, seed=6, width=WIDTH, height=HEIGHT):
    """Random splats in front of a camera at +z (the ``fixtures.py``
    distribution, grown so that tiles saturate and early stop triggers)."""
    rng = np.random.default_rng(seed)
    arrays = {
        "means": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "log_scales": (rng.uniform(-4.0, -1.5, (n, 3)) + grow).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity_logits": (rng.uniform(-1.0, 4.0, n) + grow).astype(np.float32),
        "sh": (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32),
    }
    fx = 0.8 * width
    camera = tgs.CameraParams(
        width, height, 2 * math.atan(width / (2 * fx)), 2 * math.atan(height / (2 * fx)), fx, fx,
        (math.cos(0.075), 0.0, math.sin(0.075), 0.0), (0.0, 0.0, 4.0),
    )
    return tgs.GaussianModel.from_arrays(arrays, device=device), camera


@pytest.fixture(scope="module")
def full_size(device):
    """The full-size cases at 1920x1080, drawn once each:
    ``full_size(kind, tile_size=32, sliced=False)`` gives (model, camera,
    config). ``"headline"``: 1M gaussians of the benchmark's synthetic scene
    at the bench pose, tile ``tile_size``, chunk 32, pair block 128, SH
    degree 3, exact mode and strict parity, pair capacity 1.5x the view's
    demand at that tile (``tools/bench_torch.py::sized_capacity``); sliced,
    2^17 pairs a depth slice. ``"dense"``: 5M gaussians at scale shift 1.9
    with the real-density settings, early stop 1e-4 and capacity 1.1x the
    demand; sliced, 2^19 pairs a slice with a 2^20-pair reduction, else the
    single sort with a reduction of a quarter of the capacity."""
    import bench_torch

    models = {}
    camera = card.camera_params(card.WIDTH, card.HEIGHT, 0.0, 0.0)
    cam = tgs.CameraArrays.from_params(camera, device=device)

    def make(kind, tile_size=32, sliced=False):
        dense = kind == "dense"
        if kind not in models:
            models[kind] = card.build_scene(*((card.REAL_N, card.REAL_SHIFT) if dense else (card.NUM_GAUSSIANS, 0.0)),
                                            device)
        model = models[kind]
        capacity, _ = bench_torch.sized_capacity(model, cam, 1.1 if dense else 1.5, camera.width, camera.height,
                                                 tile_size)
        cfg = tgs.RasterConfig(tile_size=tile_size, chunk_size=32, pair_block=128, max_pairs=capacity, sh_degree=3,
                               early_stop_transmittance=1e-4 if dense else 0.0, strict_parity=True)
        if dense:
            cfg = dataclasses.replace(cfg, slice_pairs=card.REAL_SLICE if sliced else 0,
                                      reduce_pairs=card.REAL_REDUCE if sliced else capacity // 4)
        elif sliced:
            cfg = dataclasses.replace(cfg, slice_pairs=1 << 17)
        return model, camera, cfg

    return make


class Binned(NamedTuple):
    args: tuple  # feat, pair_gaussian, tile_start, tile_count, tile_ids
    ntx: int
    counts: torch.Tensor  # gaussian_counts
    cfg: tgs.RasterConfig
    width: int
    height: int


@pytest.fixture(scope="module")
def binned(request, device, full_size):
    """The compositors' inputs for one view, binned by the port: the small
    48x32 frame at ``CFG``, or the full-size case an indirect parameter
    names (``"headline"``, or ``"dense"`` single-sort)."""
    kind = getattr(request, "param", "small")
    model, camera, cfg = (*scene(device), CFG) if kind == "small" else full_size(kind)
    with torch.no_grad():
        args, bins, ntx = card.binned_inputs(model, camera, cfg)
    return Binned(args, ntx, bins.gaussian_counts, cfg, camera.width, camera.height)


@pytest.mark.parametrize("binned,threshold", [
    *(("small", t) for t in (0.0, 1e-4, 0.3)),
    ("headline", 0.0), ("headline", 0.3),  # at 1e-4 no headline tile stops: a pair a gaussian leaves T above it
    ("dense", 1e-4),  # the real-density setting
], indirect=["binned"])
def test_kernel_matches_plain(binned, threshold):
    args, ntx, _, base, w, h = binned
    cfg = dataclasses.replace(base, early_stop_transmittance=threshold)
    before = forward_tiles.launches
    got = forward_tiles(*args, ntx, cfg, w, h)
    torch.cuda.synchronize()
    assert forward_tiles.launches == before + 1
    want = forward_tiles_plain(*args, ntx, cfg, w, h)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    if threshold > 0:
        assert (got[2] < -(-args[3] // cfg.pair_block)).any(), "some tile should stop early"


def test_render_on_card_matches_oracle(device):
    model, camera = scene(device, n=300, grow=0.0, seed=7)
    with torch.inference_mode():
        before = forward_tiles.launches
        img, trans = tgs.render(model, camera, CFG)
        assert forward_tiles.launches == before + 1
        o_img, o_trans = tgs.render_reference_oracle(model, camera, CFG)
    assert img.device.type == "cuda"
    torch.testing.assert_close(img, o_img, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(trans, o_trans, rtol=RTOL, atol=ATOL)


def test_kernel_rejects_bad_inputs(binned):
    (feat, *rest), ntx = binned[:2]
    with pytest.raises(ValueError, match="pair_gaussian"):
        forward_tiles(feat, rest[0].long(), *rest[1:], ntx, CFG)
    with pytest.raises(ValueError, match="feat"):
        forward_tiles(feat[:, :8].contiguous(), *rest, ntx, CFG)


# The preprocess kernel (csrc/preprocess.cu) rounds every step of the
# geometry as the eager path does, so every output but rgb must be bitwise
# the eager path's on the card (floats compared by their bits,
# ``kernels/preprocess.py::same_bits``); rgb within ``RGB_ATOL`` there, the
# bound of its sums in another order.


def _edge_scene(device, n, seed=0):
    """``n`` random splats before two 96x64 cameras (one axis-aligned, one
    turned), the first 64 rows where ``n`` allows probing the kernel's
    edges: behind the near plane (one at depth exactly 0), zero scales,
    axis-aligned quaternions on the camera's x = 0 plane (a zero conic
    term), opacity at and below 1/255, huge scales (a radius past the
    int32 range), and bboxes across every screen edge."""
    rng = np.random.default_rng(seed)
    w, h = 96, 64
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(-1, 4, n)], 1)
    log_scales = rng.uniform(-4.0, -1.0, (n, 3))
    quats = rng.normal(size=(n, 4))
    logits = rng.uniform(-1.0, 4.0, n)
    if n >= 64:
        means[0:8, 2] = [-4.5, -4.2, -4.0, -3.9, -3.85, -3.81, -3.8, -3.79]  # camera depth -0.5 ... 0.21
        log_scales[8:16] = -200.0  # exp underflows to 0
        quats[16:24] = [1.0, 0.0, 0.0, 0.0]
        means[16:24, 0] = 0.0
        logits[24:28] = -10.0
        logits[28:32] = math.log(1.0 / 254.0)  # opacity 1/255
        log_scales[32:36] = 14.0
        log_scales[36:40] = 20.0  # radius and spread far past the screen and the int32 range
        # Screen edges at depth 4: x = +-0.625 * 4, y = +-0.4167 * 4, a little inside, on and outside.
        s = np.repeat([0.97, 1.0, 1.03], 8)
        sign = np.tile([1.0, -1.0], 12)
        axis = np.tile([0, 0, 1, 1], 6)
        means[40:64] = 0.0
        means[40:64, 0] = np.where(axis == 0, sign * 2.5 * s, 0.3)
        means[40:64, 1] = np.where(axis == 1, sign * 1.6667 * s, -0.2)
        log_scales[40:64] = -3.0
    arrays = {"means": means, "log_scales": log_scales, "quats": quats, "opacity_logits": logits,
              "sh": rng.normal(size=(n, 16, 3)) * 0.3}
    model = tgs.GaussianModel.from_arrays({k: v.astype(np.float32) for k, v in arrays.items()}, device=device)
    fx = 0.8 * w
    fov = (2 * math.atan(w / (2 * fx)), 2 * math.atan(h / (2 * fx)))
    q = np.array([math.cos(0.1), 0.05, math.sin(0.1), 0.0])
    cameras = [tgs.CameraParams(w, h, *fov, fx, fx, (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 4.0)),
               tgs.CameraParams(w, h, *fov, fx, fx, tuple(q / np.linalg.norm(q)), (0.2, -0.1, 4.0))]
    return model, cameras


def _check_preprocess(device, n, degree, strict):
    from gsplat_tpu_torch.kernels import preprocess as kp

    model, cameras = _edge_scene(device, n)
    w, h = cameras[0].width, cameras[0].height
    with torch.no_grad():
        inputs = (model.means, model.sh, model.quats, model.scales(), model.opacity())
        for i, camera in enumerate(cameras):
            cam = tgs.CameraArrays.from_params(camera, device=device)
            before = kp.preprocess_forward.launches
            got = kp.preprocess_forward(*inputs, cam, w, h, degree, strict)
            torch.cuda.synchronize()
            assert kp.preprocess_forward.launches == before + 1
            want = kp.preprocess_plain(*inputs, cam, w, h, degree, strict)
            for name in want._fields:
                if name != "rgb":
                    assert kp.same_bits(getattr(got, name), getattr(want, name)), (name, i)
            assert got.opacity is inputs[4]
            torch.testing.assert_close(got.rgb, want.rgb, rtol=0, atol=kp.RGB_ATOL)
            if n >= 64 and i == 0:
                conic, bbox, cull = want.conics, want.bbox, want.cull_bbox
                assert bool((want.depth < 0.2).any() and (want.depth == 0).any())
                assert bool(((conic[:, 2] == 0) & (conic[:, 0] != 0)).any())
                assert bool(((cull[:, 2] == cull[:, 0]) & (bbox[:, 2] > bbox[:, 0])).any())  # dead, in view
                assert bool((bbox[:, 0] == 0).any() and (bbox[:, 1] == 0).any())
                assert bool((bbox[:, 2] == w - 1).any() and (bbox[:, 3] == h - 1).any())
                assert bool(((bbox == torch.tensor([0, 0, w - 1, h - 1], device=device)).all(1)).any())
                assert bool(want.active.any() and not want.active.all())


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_preprocess_kernel_matches_eager(device, degree, strict):
    """The kernel against the eager path at every SH degree, strict parity
    on and off, at 4133 gaussians (not a multiple of the block's 128) with
    the edge rows of ``_edge_scene``."""
    _check_preprocess(device, 4133, degree, strict)


@pytest.mark.parametrize("n", [1, 127, 129])
def test_preprocess_kernel_ragged_counts(device, n):
    """One gaussian, one short of a block, one past it."""
    _check_preprocess(device, n, 3, True)


@pytest.mark.parametrize("case", [
    pytest.param(None, id="small"),
    pytest.param(("headline", 32, False), id="headline"),
    *(pytest.param(("headline", ts, sliced), id=f"headline-tile{ts}{'-sliced' if sliced else ''}")
      for ts in (16, 64, 128) for sliced in (False, True)),
    pytest.param(("dense", 32, True), id="dense-sliced"),
])
def test_render_takes_the_preprocess_kernel_without_grad(device, full_size, case):
    """A request under ``no_grad`` launches the preprocess kernel once and
    counts ``preprocess_kernel`` 1; under grad too, and its backward then
    launches the backward kernel once and counts ``preprocess_bwd_kernel``
    1. The frames are bitwise the same: one kernel renders both. The
    compositors launch as the path plans: single-sort, one forward a
    request and one backward a step; depth-sliced, one carry forward a
    slice (the ``slices`` counter) and as many carry backwards a step, and
    nothing else; no pair past the capacity. At the full-size cases
    (``full_size``) too; there the headline's frame at every tiling,
    single-sort and sliced, is bitwise its single-sort frame at tile 32
    (exact mode: every pixel composites the same gaussians in the same
    order)."""
    from gsplat_tpu_torch.kernels.preprocess import preprocess_backward, preprocess_forward
    from gsplat_tpu_torch.utils import stages

    model, camera, cfg = (*scene(device), CFG) if case is None else full_size(*case)
    compositors = (forward_tiles, backward_tiles, forward_tiles_carry, backward_tiles_carry)
    seen, frames = [], []
    for grad in (False, True):
        before = preprocess_forward.launches, preprocess_backward.launches
        k_before = [k.launches for k in compositors]
        with torch.set_grad_enabled(grad), stages.record_stages() as rec:
            img, trans = tgs.render(model, camera, cfg)
            if grad:
                torch.autograd.grad((img * img).sum() + trans.sum(), list(model.parameters()))
        torch.cuda.synchronize()
        counts = rec.counter_values()
        seen.append(([v for name, _, v in counts if name == "preprocess_kernel"],
                     [v for name, _, v in counts if name == "preprocess_bwd_kernel"],
                     preprocess_forward.launches - before[0], preprocess_backward.launches - before[1]))
        slices = sum(v for name, _, v in counts if name == "slices")
        launched = tuple(k.launches - b for k, b in zip(compositors, k_before))
        assert launched == ((0, 0, slices, slices * grad) if cfg.slice_pairs else (1, int(grad), 0, 0)), launched
        assert (slices > 0) == (cfg.slice_pairs > 0), slices
        assert sum(v for name, _, v in counts if name == "overflow") == 0  # no pair beyond the capacity
        frames.append((img.detach(), trans.detach()))
    assert seen == [([1], [], 1, 0), ([1], [1], 1, 1)]
    assert torch.equal(frames[0][0], frames[1][0]) and torch.equal(frames[0][1], frames[1][1])
    img, trans = frames[0]
    assert bool(torch.isfinite(img).all()) and 0.0 <= float(trans.min()) <= float(trans.max()) <= 1.0
    if case is not None and case[0] == "headline":
        with torch.no_grad():
            want = tgs.render(*full_size("headline"))
        assert torch.equal(img, want[0]) and torch.equal(trans, want[1])


def _close_by_column(got, want, name):
    """``got`` within rtol 1e-4 + atol 1e-5 of each column's largest finite
    magnitude of ``want`` (columns: every entry past the row index), with
    the same entries not finite."""
    g, w = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    finite = torch.isfinite(w)
    assert torch.equal(torch.isfinite(g), finite), name
    scale = torch.where(finite, w.abs(), torch.zeros_like(w)).amax(0, keepdim=True)
    err = (g - w).abs()
    bad = finite & ~(err <= 1e-4 * w.abs() + 1e-5 * scale)
    assert not bool(bad.any()), (name, int(bad.sum()), float(err[bad].max()) if bad.any() else 0.0)


def _bench_scene(device, n, seed=0):
    """``n`` splats of the benchmark's scene distribution
    (``card.build_scene`` at the dense scale shift 1.9, drawn with numpy):
    the camera at the origin looking down +z, z in [2, 10]."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 10.0, n)
    arrays = {
        "means": np.stack([rng.uniform(-0.9, 0.9, n) * z, rng.uniform(-0.55, 0.55, n) * z, z], 1),
        "log_scales": rng.uniform(-5.2, -3.6, (n, 3)) + 1.9,
        "quats": rng.normal(size=(n, 4)),
        "opacity_logits": rng.uniform(-2.0, 2.0, n),
        "sh": rng.normal(size=(n, 16, 3)) * 0.2,
    }
    return tgs.GaussianModel.from_arrays({k: v.astype(np.float32) for k, v in arrays.items()}, device=device)


def _orbit8_cameras(width, height):
    """The cameras of the benchmark's ``orbit8`` poses (``splatbench/scene.py``)."""
    from splatbench.scene import camera_params, poses

    with open(os.path.join(ROOT, "splatbench", "traffic", "render.json")) as f:
        return [camera_params(width, height, yaw, shift) for yaw, shift in poses(json.load(f))]


def _check_preprocess_grads(device, model, cameras, degree, offsets=(False, True), seed=0):
    """The kernel pair's gradients of means, SH, quats, log-scales and the
    screen offset against the eager path's autograd, at each camera, for a
    random cotangent of the packed features (so the backward reads column
    slices of its ``[N+1, 16]`` cotangent) and of the depth, with and
    without a screen offset; one backward launch each. At each camera the
    grad-free kernel's outputs too: all but rgb bitwise the eager path's,
    rgb within ``RGB_ATOL``. Returns the last pair of gradient lists."""
    from gsplat_tpu_torch.kernels import preprocess as kp

    g = torch.Generator(device=device).manual_seed(seed)
    n = model.num_gaussians
    leaves = [model.means, model.sh, model.quats, model.log_scales]
    for i, camera in enumerate(cameras):
        w, h = camera.width, camera.height
        cam = tgs.CameraArrays.from_params(camera, device=device)
        with torch.no_grad():
            ins = (model.means, model.sh, model.quats, model.scales(), model.opacity())
            fwd = kp.preprocess_forward(*ins, cam, w, h, degree, True)
            eager = kp.preprocess_plain(*ins, cam, w, h, degree, True)
        for name in eager._fields:
            if name != "rgb":
                assert kp.same_bits(getattr(fwd, name), getattr(eager, name)), (name, i)
        torch.testing.assert_close(fwd.rgb, eager.rgb, rtol=0, atol=kp.RGB_ATOL)
        kink = torch.zeros((n, 3), dtype=torch.bool, device=device)
        for c in (fwd.rgb, eager.rgb):
            kink |= (c <= kp.RGB_ATOL) | (c >= 1.0 - kp.RGB_ATOL)
        del fwd, eager
        v_feat = torch.randn((n + 1, 16), generator=g, device=device)
        v_feat[:n, 6:9][kink] = 0.0
        v_depth = torch.randn(n, generator=g, device=device)
        for with_offset in offsets:
            offset = torch.randn((n, 2), generator=g, device=device).requires_grad_() if with_offset else None
            grads = []
            for fn in (kp.preprocess_autograd, kp.preprocess_plain):
                before = kp.preprocess_backward.launches
                prep = fn(model.means, model.sh, model.quats, model.scales(), model.opacity(), cam, w, h, degree,
                          True, offset)
                loss = (binning.pack_features(prep) * v_feat).sum() + (prep.depth * v_depth).sum()
                grads.append(torch.autograd.grad(loss, leaves + ([offset] if with_offset else [])))
                torch.cuda.synchronize()
                assert kp.preprocess_backward.launches - before == (fn is kp.preprocess_autograd)
            got, want = grads
            for name, a, b in zip(("means", "sh", "quats", "log_scales"), got, want):
                _close_by_column(a, b, f"{name}, degree {degree}, camera {i}, offset {with_offset}")
            if with_offset:
                assert torch.equal(got[-1], want[-1])
    return got, want


@pytest.mark.parametrize("size,degree", [*((None, d) for d in range(4)), ("headline", 3), ("dense", 3)],
                         ids=["0", "1", "2", "3", "headline-3", "dense-3"])
def test_preprocess_grads_match_eager_at_orbit8(device, full_size, size, degree):
    """The kernel pair's gradients at the benchmark's eight ``orbit8`` poses
    (1920x1080) over 20,000 splats of its scene distribution, with and
    without a screen offset, at every SH degree; and at SH degree 3 over
    the headline's 1M and the dense scene's 5M gaussians (``full_size``)."""
    model = _bench_scene(device, 20_000) if size is None else full_size(size)[0]
    _check_preprocess_grads(device, model, _orbit8_cameras(1920, 1080), degree, seed=degree)


@pytest.mark.parametrize("degree", [0, 3])
@pytest.mark.parametrize("n", [4133, 1, 127, 129])
def test_preprocess_grads_on_edge_rows(device, n, degree):
    """The kernel pair's gradients on ``_edge_scene``'s rows (behind the near
    plane and at depth 0, zero and huge scales, axis-aligned quaternions,
    opacity at and below 1/255, bboxes across the screen's edges) before
    both of its cameras, at a count that is not a multiple of the block's
    128, one gaussian, and one short of and one past a block."""
    model, cameras = _edge_scene(device, n, seed=n)
    _check_preprocess_grads(device, model, cameras, degree, seed=n)


@pytest.mark.parametrize("pool", ["small", "recipe_5m"])
def test_preprocess_grads_for_dead_pool_rows(device, full_size, pool):
    """A pool's dead rows (``models/gaussians.py::pad_model``: at the origin,
    identity quaternion, log-scale 0, the dead opacity logit), seen from a
    camera at the origin: depth 0, so culled, and a zero view direction.
    Their gradients are finite and the eager path's, the geometry's (quats,
    log-scales) exactly zero. Also at ``recipe_5m``'s pool: the dense
    scene's 5M gaussians padded to 10,000,128 rows
    (``train/densify.py::init_pool``), seen at 1920x1080 from the bench
    camera, which sits at the origin."""
    from gsplat_tpu_torch.models.gaussians import pad_model
    from gsplat_tpu_torch.train.densify import init_pool

    if pool == "small":
        live, cameras = _edge_scene(device, 900, seed=3)
        model = pad_model(live, 1024)
        fov = (cameras[0].fov_x, cameras[0].fov_y)
        origin = tgs.CameraParams(96, 64, *fov, cameras[0].focal_x, cameras[0].focal_y, (1.0, 0.0, 0.0, 0.0),
                                  (0.0, 0.0, 0.0))
    else:
        live, origin, _ = full_size("dense")
        model = init_pool(live, tgs.DensifyConfig())
        assert model.num_gaussians == 10_000_128
    n_live = live.num_gaussians
    for degree in (0, 3):
        got, want = _check_preprocess_grads(device, model, [origin], degree, seed=degree)
        for a, b in zip(got, want):
            assert bool(torch.isfinite(a[n_live:]).all() and torch.isfinite(b[n_live:]).all())
        for a, b in zip(got[2:4], want[2:4]):  # quats, log-scales
            assert not bool(a[n_live:].any()) and not bool(b[n_live:].any())


def test_preprocess_grads_at_clamped_colours(device):
    """Colours both paths place exactly (the DC coefficient alone, C0 * sh0
    + 0.5) at 0 and 1 take half the rgb cotangent (torch.minimum / maximum),
    past them none, inside all of it: the DC coefficient's gradient C0 / 2,
    0 and C0 on both paths, and the rows' SH and means gradients as the
    eager path's (none at all past the clamp)."""
    from gsplat_tpu_torch.kernels import preprocess as kp

    model, cameras = _edge_scene(device, 256, seed=5)
    arrays = model.to_arrays()
    c0 = np.float32(0.28209479177387814)
    targets = [-0.5, 0.5, -0.75, 0.75, 0.0, -0.5, 0.5]  # C0 * sh0: colours 0, 1, past 0, past 1, 0.5, 0, 1
    for row, target in enumerate(targets, start=64):
        v = np.float32(target / float(c0))
        while np.float32(c0 * v) != np.float32(target):  # the float32 sh0 whose product is the target
            v = np.nextafter(v, np.float32(np.inf) if np.float32(c0 * v) < target else np.float32(-np.inf))
        arrays["sh"][row] = 0.0
        arrays["sh"][row, 0, :] = v
    model = tgs.GaussianModel.from_arrays(arrays, device=device)
    rows = slice(64, 64 + len(targets))
    cam = tgs.CameraArrays.from_params(cameras[0], device=device)
    grads, colours = [], []
    for fn in (kp.preprocess_autograd, kp.preprocess_plain):
        prep = fn(model.means, model.sh, model.quats, model.scales(), model.opacity(), cam, 96, 64, 3, True)
        colours.append(prep.rgb[rows].detach())
        grads.append(torch.autograd.grad(prep.rgb[rows].sum(), [model.sh, model.means]))
    expected = torch.tensor([0.0, 1.0, 0.0, 1.0, 0.5, 0.0, 1.0], device=device)[:, None].expand(-1, 3)
    assert torch.equal(colours[0], expected) and torch.equal(colours[1], expected)
    half = float(c0) * 0.5
    want_dc = torch.tensor([half, half, 0.0, 0.0, float(c0), half, half], device=device)[:, None].expand(-1, 3)
    for (g_sh, g_means), name in zip(grads, ("kernel", "eager")):
        torch.testing.assert_close(g_sh[rows, 0, :], want_dc, rtol=1e-6, atol=0, msg=name)
        assert not bool(g_sh[64 + 2 : 64 + 4].any()) and not bool(g_means[64 + 2 : 64 + 4].any()), name
    _close_by_column(grads[0][0][rows], grads[1][0][rows], "sh")
    _close_by_column(grads[0][1][rows], grads[1][1][rows], "means")


def test_preprocess_forward_under_grad_is_the_grad_free_kernel(device):
    """Under a gradient the Function's forward is the grad-free kernel: every
    output bitwise, rgb too; with a screen offset, every output but rgb
    bitwise the eager path's, the means shifted by it."""
    from gsplat_tpu_torch.kernels import preprocess as kp

    model, cameras = _edge_scene(device, 4133, seed=2)
    inputs = (model.means, model.sh, model.quats, model.scales(), model.opacity())
    offset = torch.randn((4133, 2), device=device) * 4.0
    for camera in cameras:
        cam = tgs.CameraArrays.from_params(camera, device=device)
        for off in (None, offset):
            got = kp.preprocess_autograd(*inputs, cam, 96, 64, 3, True, off)
            with torch.no_grad():
                free = kp.preprocess_forward(*inputs, cam, 96, 64, 3, True, off)
                want = kp.preprocess_plain(*inputs, cam, 96, 64, 3, True, off)
            assert got.screen_means.requires_grad and got.opacity is inputs[4]
            for name in want._fields:
                assert kp.same_bits(getattr(got, name).detach(), getattr(free, name)), name
                if name != "rgb":
                    assert kp.same_bits(getattr(got, name).detach(), getattr(want, name)), name
            torch.testing.assert_close(got.rgb.detach(), want.rgb, rtol=0, atol=kp.RGB_ATOL)


def test_preprocess_backward_reads_any_cotangent_layout(device):
    """Cotangents that are not column slices (autograd's expanded ones of a
    sum, a channel of rgb alone, none for the conic) give the eager path's
    gradients; the backward wrapper refuses a cotangent of another shape."""
    from gsplat_tpu_torch.kernels import preprocess as kp

    model, cameras = _edge_scene(device, 700, seed=4)
    cam = tgs.CameraArrays.from_params(cameras[1], device=device)
    leaves = [model.means, model.sh, model.quats, model.log_scales]
    grads = []
    for fn in (kp.preprocess_autograd, kp.preprocess_plain):
        prep = fn(model.means, model.sh, model.quats, model.scales(), model.opacity(), cam, 96, 64, 3, True)
        loss = prep.screen_means.sum() + (prep.rgb[:, 1] * prep.depth.detach()).sum()
        grads.append([g if g is not None else torch.zeros_like(x)  # what reads quats is not in this loss
                      for g, x in zip(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)])
    for name, a, b in zip(("means", "sh", "quats", "log_scales"), *grads):
        _close_by_column(a, b, name)
    inputs = (model.means, model.sh, model.quats, model.scales())
    v = [torch.zeros((700, k), device=device) for k in (2, 3, 3)]
    v[1] = torch.zeros((700, 4), device=device)
    with pytest.raises(ValueError, match="v_conics"):
        kp.preprocess_backward(*inputs, cam, 96, 64, 3, *v)


def test_preprocess_kernel_rejects_bad_inputs(device):
    from gsplat_tpu_torch.kernels.preprocess import preprocess_forward

    model, cameras = _edge_scene(device, 64)
    cam = tgs.CameraArrays.from_params(cameras[0], device=device)
    inputs = [model.means, model.sh, model.quats, model.scales(), model.opacity()]
    for i, bad, match in ((0, model.means.double(), "float32"), (1, model.sh[:, :15].contiguous(), "sh"),
                          (2, model.quats[:, :3].contiguous(), "quats"), (3, model.scales()[::2], "float32")):
        args = list(inputs)
        args[i] = bad
        with pytest.raises(ValueError, match=match):
            preprocess_forward(*args, cam, 96, 64, 3, True)
    with pytest.raises(ValueError, match="SH degree"):
        preprocess_forward(*inputs, cam, 96, 64, 4, True)


def _close_to_max(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))


def _grad_error(got, want):
    """The largest error of ``got`` over the largest magnitude of ``want``,
    and the count of entries outside rtol 1e-4 + atol 1e-5 of it."""
    scale = float(want.abs().max())
    err = (got.double() - want.double()).abs()
    return float(err.max()) / scale, int((err > 1e-4 * want.double().abs() + 1e-5 * scale).sum())


@contextlib.contextmanager
def _loss_launches():
    """Counts the loss kernels' launches inside the block, by the calls of
    their C entry points (``launched["forward"]``, ``["backward"]``), and
    asserts that no library convolution or GEMM ran among the device
    operations torch.profiler records (it can miss one, so it counts none)."""
    from torch.profiler import ProfilerActivity, profile

    from gsplat_tpu_torch.kernels import build

    launched = {"forward": 0, "backward": 0}
    sides = {"gsplat_loss_forward": "forward", "gsplat_loss_backward": "backward"}
    real = build.load_function

    def load(name, symbol, argtypes):
        fn = real(name, symbol, argtypes)
        if symbol not in sides:
            return fn

        def counted(*args):
            launched[sides[symbol]] += 1
            return fn(*args)

        return counted

    torch.cuda.synchronize()
    with mock.patch.object(build, "load_function", load), profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield launched
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert not [n for n in names if re.search("conv|gemm|cudnn|xmma", n, re.IGNORECASE)], names


def _check_loss(base, target, weight=0.2, view=lambda x: x, flat=False):
    """The loss kernels (``kernels/loss.py``) on ``view`` of the frames,
    differentiated with respect to ``base``, against the eager path: the loss
    and the mean SSIM within 1e-6 relative (the order of their sums), the
    gradient within rtol 1e-4 + atol 1e-5 of its largest magnitude (the
    backward compositor's tolerance: the blurs sum in another order, and the
    combine's terms cancel); one launch each way and no library kernel, two
    calls bitwise equal, and ``ssim`` the forward kernel's mean SSIM.

    ``flat``: a constant target against a frame with flat regions. There
    ``s_pp = blur(p^2) - mu_p^2`` cancels to a few roundings of ``mu_p^2``
    against ``C2`` (9e-4), so each f32 path's gradient is a few 1e-5 of the
    scale off the float64 eager path at some hundred entries a frame, and
    the two paths are as far apart. There both are held to the eager path in
    float64, the kernels' largest error and count outside the tolerance at
    most 1.5 times the eager f32 path's (at the headline's ``orbit8`` frames
    the ratios read 0.86-1.21 and 0.79-1.06)."""
    def run():
        leaf = base.detach().clone().requires_grad_()
        loss, mean_s = kl.loss_autograd(view(leaf), view(target), weight)
        (grad,) = torch.autograd.grad(loss, leaf)
        return loss.detach(), mean_s, grad

    with _loss_launches() as launched:
        first = run()
    assert launched == {"forward": 1, "backward": 1}
    assert all(torch.equal(a, b) for a, b in zip(first, run()))
    loss, mean_s, grad = first
    leaf = base.detach().clone().requires_grad_()
    want = kl.loss_plain(view(leaf), view(target), weight)
    (want_grad,) = torch.autograd.grad(want, leaf)
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-6)
    with torch.no_grad():
        assert float(mean_s) == pytest.approx(float(kl.ssim_plain(view(base), view(target))), rel=1e-6, abs=1e-7)
        assert float(tgs.ssim(view(base), view(target))) == pytest.approx(float(mean_s), rel=1e-6, abs=1e-7)
    if not flat:
        _close_to_max(grad, want_grad)
        return
    leaf = base.detach().double().requires_grad_()
    (grad64,) = torch.autograd.grad(kl.loss_plain(view(leaf), view(target).double(), weight), leaf)
    (k_max, k_bad), (e_max, e_bad) = _grad_error(grad, grad64), _grad_error(want_grad, grad64)
    assert k_max <= 1.5 * e_max and k_bad <= 1.5 * e_bad, (k_max, k_bad, e_max, e_bad)


@pytest.mark.parametrize("height,width", [(3, 5), (7, 11), (17, 33), (32, 48)], ids=["5x3", "11x7", "33x17", "48x32"])
def test_loss_kernels_match_eager_on_small_frames(device, height, width):
    """Frames smaller than a block (16x16) and than the window (11), and
    ragged edges; with ties of prediction and target (``sign(0)``) in every
    other column; at SSIM weights 0.2, 1.0 and 0 (L1 alone)."""
    g = torch.Generator(device=device).manual_seed(height * width)
    pred = torch.rand((height, width, 3), generator=g, device=device)
    target = torch.rand((height, width, 3), generator=g, device=device)
    target[:, ::2] = pred[:, ::2]
    for weight in (0.2, 1.0, 0.0):
        _check_loss(pred, target, weight)


def test_loss_kernels_take_a_strided_frame(device):
    """A frame's every other row (the benchmark's ``half`` fault,
    ``image[::2]``): copied, then the kernels; no gradient reaches the rows
    left out."""
    g = torch.Generator(device=device).manual_seed(1)
    pred = torch.rand((70, 90, 3), generator=g, device=device)
    target = torch.rand((70, 90, 3), generator=g, device=device)
    _check_loss(pred, target, view=lambda x: x[::2])


@pytest.mark.parametrize("target", ["constant", "random"])
def test_loss_kernels_match_eager_at_orbit8(device, full_size, target):
    """The loss of the headline's 1920x1080 frames at the eight ``orbit8``
    poses against the benchmark's constant 0.25 target (``flat``: its
    gradient against the float64 eager path) and a random one."""
    model, _, cfg = full_size("headline")
    g = torch.Generator(device=device).manual_seed(8)
    for camera in _orbit8_cameras(card.WIDTH, card.HEIGHT):
        with torch.no_grad():
            image, _ = tgs.render(model, camera, cfg)
        want = torch.full_like(image, 0.25) if target == "constant" else torch.rand(image.shape, generator=g,
                                                                                      device=device)
        _check_loss(image, want, flat=target == "constant")


def test_ssim_and_rgb_loss_on_card_take_the_kernels(device):
    """``ssim`` on the card is differentiable through the kernels: the eager
    SSIM's value and gradient, one launch each way and no library kernel;
    so is ``rgb_loss`` at SSIM weight 0, the eager L1. CUDA frames the
    kernels cannot take raise, for both."""
    from gsplat_tpu_torch.train.loss import l1_loss

    g = torch.Generator(device=device).manual_seed(3)
    pred = torch.rand((17, 33, 3), generator=g, device=device)
    target = torch.rand((17, 33, 3), generator=g, device=device)
    for fn, plain in ((tgs.ssim, kl.ssim_plain), (lambda p, t: tgs.rgb_loss(p, t, 0.0), l1_loss)):
        leaf = pred.clone().requires_grad_()

        def run():
            value = fn(leaf, target)
            return value.detach(), torch.autograd.grad(value, leaf)[0]

        with _loss_launches() as launched:
            got, grad = run()
        assert launched == {"forward": 1, "backward": 1}
        eager_leaf = pred.clone().requires_grad_()
        want = plain(eager_leaf, target)
        (want_grad,) = torch.autograd.grad(want, eager_leaf)
        assert float(got) == pytest.approx(float(want.detach()), rel=1e-6)
        _close_to_max(grad, want_grad)
    for p, t in ((pred.double(), target.double()), (pred[..., :2], target[..., :2]), (pred, target.cpu()),
                 (pred, target.clone().requires_grad_())):
        for fn in (tgs.ssim, lambda a, b: tgs.rgb_loss(a, b, 0.2)):
            with pytest.raises(ValueError, match="the loss kernels take"):
                fn(p, t)


def test_loss_kernels_reject_bad_inputs(device):
    good = torch.rand((8, 12, 3), device=device)
    for pred, target, match in ((good.double(), good, "float32"), (good, good[:, ::2], "contiguous"),
                                (good[..., :2].contiguous(), good[..., :2].contiguous(), r"\[H, W, 3\]"),
                                (good, good[1:], "shape"), (good.cpu(), good.cpu(), "unsupported device")):
        with pytest.raises(ValueError, match=match):
            kl.loss_forward(pred, target, 0.2)
    with pytest.raises(ValueError, match="maps"):
        kl.loss_backward(good, good, torch.zeros((3, 8, 12, 2), device=device), 0.2, torch.ones((), device=device))


@pytest.mark.parametrize("binned", ["small", "headline"], indirect=True)
@pytest.mark.parametrize("threshold", [0.0, 1e-4])
def test_backward_kernel_matches_plain(binned, threshold):
    args, ntx, counts, base, w, h = binned
    cfg = dataclasses.replace(base, early_stop_transmittance=threshold)
    color, trans, done = forward_tiles(*args, ntx, cfg, w, h)
    gen = torch.Generator(device=args[0].device).manual_seed(0)
    g_color = torch.randn(color.shape, generator=gen, device=color.device)
    g_trans = torch.randn(trans.shape, generator=gen, device=color.device)
    outs = (color, trans, g_color, g_trans)
    before = backward_tiles.launches
    rows = backward_tiles(*args, *outs, ntx, cfg, done)
    again = backward_tiles(*args, *outs, ntx, cfg, done)
    torch.cuda.synchronize()
    assert backward_tiles.launches == before + 2
    want = backward_tiles_plain(*args, *outs, ntx, cfg, done)
    _close_to_max(rows, want)
    assert torch.equal(rows, again)
    n_rows = args[0].shape[0]
    for gaussian_counts in (counts, None):
        got = reduce_pair_grads(rows, args[1], gaussian_counts, n_rows)
        _close_to_max(got, reduce_pair_grads(want, args[1], gaussian_counts, n_rows))
    assert torch.equal(reduce_pair_grads(rows, args[1], counts, n_rows), reduce_pair_grads(again, args[1], counts, n_rows))


def test_render_grads_on_card_match_cpu(device):
    """Autograd through ``render`` on the card (both kernels) against the
    same model on the CPU (both plain versions)."""
    model, camera = scene(device, n=300, grow=0.0, seed=7)
    cpu_model = tgs.GaussianModel.from_arrays(model.to_arrays(), device="cpu")
    grads = []
    for m in (model, cpu_model):
        img, trans = tgs.render(m, camera, CFG)
        grads.append(torch.autograd.grad((img * img).sum() + trans.sum(), list(m.parameters())))
    for got, want in zip(*grads):
        torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=5e-5 * float(want.abs().max()))


def test_exact_grad_reduction_on_card(device):
    """``exact_grad_reduction``: autograd through ``render`` on the card
    twice, bitwise equal (the f64 reduction uses no atomics), and against
    the CPU's with the same flag at the tolerance above."""
    model, camera = scene(device, n=300, grow=0.0, seed=7)
    cpu_model = tgs.GaussianModel.from_arrays(model.to_arrays(), device="cpu")
    cfg = dataclasses.replace(CFG, exact_grad_reduction=True)
    grads = []
    for m in (model, model, cpu_model):
        img, trans = tgs.render(m, camera, cfg)
        grads.append(torch.autograd.grad((img * img).sum() + trans.sum(), list(m.parameters())))
    assert all(torch.equal(a, b) for a, b in zip(grads[0], grads[1]))
    for got, want in zip(grads[0], grads[2]):
        torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=5e-5 * float(want.abs().max()))


def test_backward_kernel_rejects_bad_inputs(binned):
    args, ntx = binned[:2]
    color, trans, done = forward_tiles(*args, ntx, CFG)
    with pytest.raises(ValueError, match="g_color"):
        backward_tiles(*args, color, trans, color[:, :, :2].contiguous(), trans, ntx, CFG, done)
    with pytest.raises(ValueError, match="blocks_done"):
        backward_tiles(*args, color, trans, color, trans, ntx, CFG, done.long())
    with pytest.raises(ValueError, match="not supported"):
        backward_tiles(*args, color, trans, color, trans, ntx, dataclasses.replace(CFG, tile_size=0), done)


def _two_slices(args, pair_block=CFG.pair_block):
    """The binned frame as two slices of every tile's pairs: the first two
    pair blocks, then the rest (start and count of each)."""
    _, _, tile_start, tile_count, _ = args
    first = torch.minimum(tile_count, torch.full_like(tile_count, 2 * pair_block))
    return ((tile_start, first), (tile_start + first, tile_count - first))


@pytest.mark.parametrize("binned", ["small", "dense"], indirect=True)
@pytest.mark.parametrize("threshold", [0.0, 1e-4])
def test_carry_kernels_match_plain(binned, threshold):
    """Both carry kernels, slice after slice, against their plain versions
    on the same inputs; the slices chained give the single pass's frame."""
    args, ntx, _, base, w, h = binned
    feat, pair_gaussian, _, _, tile_ids = args
    cfg = dataclasses.replace(base, early_stop_transmittance=threshold)
    num_t, npix = tile_ids.shape[0], cfg.tile_size ** 2
    carry = (torch.zeros(num_t, npix, 3, device=feat.device), torch.ones(num_t, npix, device=feat.device))
    before = forward_tiles_carry.launches, backward_tiles_carry.launches
    slices = []
    for start, count in _two_slices(args, cfg.pair_block):
        got = forward_tiles_carry(feat, pair_gaussian, start, count, tile_ids, *carry, ntx, cfg, w, h)
        torch.cuda.synchronize()
        want = forward_tiles_plain(feat, pair_gaussian, start, count, tile_ids, ntx, cfg, w, h, carry=carry)
        torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
        slices.append((start, count, got[2]))
        carry = got[:2]
    if threshold == 0.0:
        single = forward_tiles(*args, ntx, cfg, w, h)
        assert torch.equal(carry[0], single[0]) and torch.equal(carry[1], single[1])
    gen = torch.Generator(device=feat.device).manual_seed(1)
    g_color = torch.randn(carry[0].shape, generator=gen, device=feat.device)
    g_trans = torch.randn(carry[1].shape, generator=gen, device=feat.device)
    state = walk_state(*carry, g_color, g_trans)
    for start, count, done in slices:
        rows, out = backward_tiles_carry(feat, pair_gaussian, start, count, tile_ids, state, g_color, ntx, cfg, done)
        again, _ = backward_tiles_carry(feat, pair_gaussian, start, count, tile_ids, state, g_color, ntx, cfg, done)
        torch.cuda.synchronize()
        p_rows, p_out = backward_tiles_plain(feat, pair_gaussian, start, count, tile_ids, None, None, g_color, None,
                                             ntx, cfg, done, state)
        _close_to_max(rows, p_rows)
        torch.testing.assert_close(out[:, 1], p_out[:, 1], rtol=RTOL, atol=ATOL)
        _close_to_max(out[:, 0], p_out[:, 0])
        assert torch.equal(rows, again)
        state = out
    assert (forward_tiles_carry.launches, backward_tiles_carry.launches) == (before[0] + 2, before[1] + 4)


def test_carry_kernels_reject_bad_inputs(binned):
    args, ntx = binned[:2]
    num_t, npix = args[4].shape[0], CFG.tile_size ** 2
    color = torch.zeros(num_t, npix, 3, device=args[0].device)
    trans = torch.ones(num_t, npix, device=args[0].device)
    with pytest.raises(ValueError, match="carry_trans"):
        forward_tiles_carry(*args, color, trans.double(), ntx, CFG)
    with pytest.raises(ValueError, match="carry_color"):
        forward_tiles_carry(*args, color[:, :, :2].contiguous(), trans, ntx, CFG)
    state = torch.zeros(num_t, 2, npix, device=args[0].device)
    with pytest.raises(ValueError, match="carry_in"):
        backward_tiles_carry(*args, state[:, :1].contiguous(), color, ntx, CFG)
    with pytest.raises(ValueError, match="carry_in"):
        backward_tiles_carry(*args, state.transpose(1, 2), color, ntx, CFG)
    with pytest.raises(ValueError, match="g_color"):
        backward_tiles_carry(*args, state, trans, ntx, CFG)


def test_sliced_render_on_card_matches_cpu(device):
    """The depth-sliced path on the card (both carry kernels) against the
    same model on the CPU (both plain versions): image, T and gradients;
    two runs on the card bitwise equal; with early stop off the image
    equals the single-sort render bitwise."""
    model, camera = scene(device, n=300, grow=0.0, seed=7)
    cpu_model = tgs.GaussianModel.from_arrays(model.to_arrays(), device="cpu")
    cfg = dataclasses.replace(CFG, slice_pairs=64, reduce_pairs=1024)
    before = forward_tiles.launches, forward_tiles_carry.launches
    outs = []
    for m in (model, model, cpu_model):
        img, trans = tgs.render(m, camera, cfg)
        grads = torch.autograd.grad((img * img).sum() + trans.sum(), list(m.parameters()))
        outs.append((img, trans, grads))
    assert forward_tiles.launches == before[0] and forward_tiles_carry.launches > before[1] + 1
    (img, trans, grads), again, (c_img, c_trans, c_grads) = outs
    assert torch.equal(img, again[0]) and torch.equal(trans, again[1])
    assert all(torch.equal(a, b) for a, b in zip(grads, again[2]))
    torch.testing.assert_close(img.cpu(), c_img, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(trans.cpu(), c_trans, rtol=RTOL, atol=ATOL)
    for got, want in zip(grads, c_grads):
        torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=5e-5 * float(want.abs().max()))
    single = tgs.render(model, camera, CFG)  # under grad too: the same preprocess (the kernel pair)
    assert torch.equal(img.detach(), single[0].detach()) and torch.equal(trans.detach(), single[1].detach())


def _synthetic(kind, tile_size, pair_block, seed=0):
    """Hand-built compositor inputs on a 2x2-tile frame that probe the
    kernels' culling (each warp walks only the pairs whose alpha-bound rect
    meets its pixel rect) and their staging (batches of pair_block rows,
    copied two batches ahead): rects ending on warp-rect edges, tiles whose
    every pair misses some warps, ragged pair counts, tiles of many batches,
    and splats that cover the whole tile."""
    rng = np.random.default_rng(seed)
    counts = {"warp_edges": [150, 40, 97, 5], "corner": [130, 33, 64, 1],
              "ragged": [1, 31, 33, 129] if pair_block > 8 else [1, 7, 9, 33],
              "many_batches": [5 * pair_block + 3, 3 * pair_block, 2 * pair_block + 1, pair_block - 1],
              "whole_tile": [60, 17, 3 * pair_block + 5, 2]}[kind]
    rows, ids, starts = [], [], []
    for tile, count in enumerate(counts):
        ox, oy = (tile % 2) * tile_size, (tile // 2) * tile_size
        starts.append(len(ids))
        sigma = rng.uniform(0.6, 5.0, (count, 2))
        centre = rng.uniform(0, tile_size, (count, 2))
        opacity = rng.uniform(0.05, 0.9, count)
        if kind == "corner":  # small splats in the tile's first quarter only
            sigma, centre = sigma * 0.4, centre * 0.3
        if kind == "whole_tile":  # every pair covers every pixel
            sigma, opacity = rng.uniform(4 * tile_size, 8 * tile_size, (count, 2)), rng.uniform(0.004, 0.02, count)
        theta = rng.uniform(0, np.pi, count)
        c, s = np.cos(theta), np.sin(theta)
        a, b = sigma[:, 0] ** 2, sigma[:, 1] ** 2
        cov = np.stack([a * c * c + b * s * s, (a - b) * c * s, a * s * s + b * c * c], 1)
        det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
        mx, my = ox + centre[:, 0], oy + centre[:, 1]
        lo = np.floor(np.stack([mx, my], 1) - 3 * sigma.max(1, keepdims=True))
        hi = np.ceil(np.stack([mx, my], 1) + 3 * sigma.max(1, keepdims=True)) + 1
        if kind == "warp_edges":  # the bbox, not the alpha extent, bounds the rect: snap it to warp edges
            cov = np.stack([np.full(count, 2500.0), np.zeros(count), np.full(count, 2500.0)], 1)
            det = cov[:, 0] * cov[:, 2]
            snap = np.array([8, 4])
            lo = np.stack([ox + rng.integers(0, -(-tile_size // 8), count) * 8,
                           oy + rng.integers(0, -(-tile_size // 4), count) * 4], 1) + rng.integers(-1, 2, (count, 2))
            hi = lo + rng.integers(1, 3, (count, 2)) * snap + rng.integers(-1, 2, (count, 2))
        lo = np.clip(lo, 0, 2 * tile_size)
        hi = np.clip(hi, 0, 2 * tile_size)
        row = np.zeros((count, 16), np.float32)
        row[:, 0], row[:, 1] = mx, my
        row[:, 2], row[:, 3], row[:, 4] = cov[:, 2] / det, cov[:, 0] / det, -cov[:, 1] / det
        row[:, 5] = opacity
        row[:, 6:9] = rng.uniform(0, 1, (count, 3))
        row[:, 9:11], row[:, 11:13] = lo, hi
        first = sum(len(r) for r in rows)
        ids.extend(range(first, first + count))
        rows.append(row)
    feat = np.concatenate(rows + [np.zeros((1, 16), np.float32)])
    ids = np.array(ids, np.int32)
    pad = -len(ids) % pair_block
    return (torch.from_numpy(feat), torch.from_numpy(np.concatenate([ids, np.full(pad, len(feat) - 1, np.int32)])),
            torch.tensor(starts, dtype=torch.int32), torch.tensor(counts, dtype=torch.int32),
            torch.arange(4, dtype=torch.int32))


@pytest.mark.parametrize("tiling", [(16, 8), (32, 128), (8, 128), (32, 256), (1, 8), (4, 8), (12, 8), (20, 128),
                                    (33, 296), (48, 600), (64, 128), (64, 2048), (65, 8), (100, 128), (128, 296),
                                    (256, 2048)])
@pytest.mark.parametrize("kind", ["warp_edges", "corner", "ragged", "many_batches", "whole_tile"])
def test_culled_kernels_match_plain(device, kind, tiling):
    """Both kernels and their carry forms on the culling and staging edge
    cases of ``_synthetic``: the forward bitwise equal to its plain version
    (colour, T and blocks_done), the backward within its tolerance, two
    runs of each bitwise equal. Tile 8 with pair_block 128 has each thread
    stage two rows of a batch; at tile 32 with pair_block 256 the
    backward's warp slots of a whole batch exceed shared memory, so it sums
    in rounds of 32 pairs. Tiles 1, 4, 12, 20 and 33 round the warp-rect
    grid up past the tile's edge; 33 and 48 give each thread two and four
    pixels, 64 four; pair blocks 296, 600 and 2048 are staged in sub-batches
    of at most 256 rows, the early-stop vote still per pair block. Tiles
    65, 100, 128 and 256 are cut into 2x2 or 4x4 pixel groups."""
    tile_size, pair_block = tiling
    args = tuple(t.to(device) for t in _synthetic(kind, tile_size, pair_block))
    width = height = 2 * tile_size
    for stop in (0.0, 1e-4):
        cfg = tgs.RasterConfig(tile_size=tile_size, chunk_size=8, pair_block=pair_block, early_stop_transmittance=stop)
        got = forward_tiles(*args, 2, cfg, width, height)
        again = forward_tiles(*args, 2, cfg, width, height)
        torch.cuda.synchronize()
        want = forward_tiles_plain(*args, 2, cfg, width, height)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(g, a)
        gen = torch.Generator(device=device).manual_seed(2)
        g_color = torch.randn(got[0].shape, generator=gen, device=device)
        g_trans = torch.randn(got[1].shape, generator=gen, device=device)
        outs = (*got[:2], g_color, g_trans)
        rows = backward_tiles(*args, *outs, 2, cfg, got[2])
        rows2 = backward_tiles(*args, *outs, 2, cfg, got[2])
        state = walk_state(*got[:2], g_color, g_trans)
        c_rows, c_out = backward_tiles_carry(*args, state, g_color, 2, cfg, got[2])
        torch.cuda.synchronize()
        p_rows = backward_tiles_plain(*args, *outs, 2, cfg, got[2])
        pc_rows, pc_out = backward_tiles_plain(*args, None, None, g_color, None, 2, cfg, got[2], state)
        _close_to_max(rows, p_rows)
        _close_to_max(c_rows, pc_rows)
        torch.testing.assert_close(c_out[:, 1], pc_out[:, 1], rtol=RTOL, atol=ATOL)
        _close_to_max(c_out[:, 0], pc_out[:, 0])
        assert torch.equal(rows, rows2) and torch.equal(rows, c_rows)


LARGE_W, LARGE_H = 160, 120


@pytest.mark.parametrize("pair_block", [8, 128])
@pytest.mark.parametrize("tile_size", [65, 100, 128, 256])
def test_large_tiles_match_plain(device, tile_size, pair_block):
    """All four kernels at tiles above 64, on a 160x120 frame (at 128 and
    256 some pixel groups lie wholly outside it), early stop off and 1e-4:
    the forward and its carry form bitwise their plain versions with
    ``blocks_done`` equal (one launch each, and one resume launch each with
    early stop on), the backward and its carry form within the tolerance,
    every kernel twice bitwise; the carry forms on two slices of every
    tile's pairs."""
    model, camera = scene(device, n=1500, grow=1.5, seed=9, width=LARGE_W, height=LARGE_H)
    base = tgs.RasterConfig(tile_size=tile_size, chunk_size=8, pair_block=pair_block, max_pairs=1 << 18)
    with torch.no_grad():
        prep = preprocess(model, camera, base)
        bins = binning.bin_gaussians(prep, LARGE_W, LARGE_H, tile_size, base.max_pairs, align=pair_block)
        ntx = -(-LARGE_W // tile_size)
        tile_ids = torch.arange(ntx * -(-LARGE_H // tile_size), dtype=torch.int32, device=device)
        args = (binning.pack_features(prep), bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids)
    feat, pair_gaussian, _, _, _ = args
    num_t, npix = tile_ids.shape[0], tile_size ** 2
    for stop in (0.0, 1e-4):
        cfg = dataclasses.replace(base, early_stop_transmittance=stop)
        resumes = int(stop > 0)
        before = forward_tiles.launches, forward_tiles.resume_launches
        got = forward_tiles(*args, ntx, cfg, LARGE_W, LARGE_H)
        again = forward_tiles(*args, ntx, cfg, LARGE_W, LARGE_H)
        torch.cuda.synchronize()
        assert (forward_tiles.launches, forward_tiles.resume_launches) == (before[0] + 2, before[1] + 2 * resumes)
        want = forward_tiles_plain(*args, ntx, cfg, LARGE_W, LARGE_H)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(g, a)
        gen = torch.Generator(device=device).manual_seed(4)
        g_color = torch.randn(got[0].shape, generator=gen, device=device)
        g_trans = torch.randn(got[1].shape, generator=gen, device=device)
        outs = (*got[:2], g_color, g_trans)
        rows = backward_tiles(*args, *outs, ntx, cfg, got[2])
        rows2 = backward_tiles(*args, *outs, ntx, cfg, got[2])
        torch.cuda.synchronize()
        _close_to_max(rows, backward_tiles_plain(*args, *outs, ntx, cfg, got[2]))
        assert torch.equal(rows, rows2)

        carry = (torch.zeros(num_t, npix, 3, device=device), torch.ones(num_t, npix, device=device))
        before = forward_tiles_carry.launches, forward_tiles_carry.resume_launches
        slices = []
        for start, count in _two_slices(args):
            s_args = (feat, pair_gaussian, start, count, tile_ids)
            c_got = forward_tiles_carry(*s_args, *carry, ntx, cfg, LARGE_W, LARGE_H)
            c_again = forward_tiles_carry(*s_args, *carry, ntx, cfg, LARGE_W, LARGE_H)
            torch.cuda.synchronize()
            c_want = forward_tiles_plain(*s_args, ntx, cfg, LARGE_W, LARGE_H, carry=carry)
            for g, a, w in zip(c_got, c_again, c_want):
                assert torch.equal(g, w) and torch.equal(g, a)
            slices.append((s_args, c_got[2]))
            carry = c_got[:2]
        assert (forward_tiles_carry.launches, forward_tiles_carry.resume_launches) == (
            before[0] + 4, before[1] + 4 * resumes)
        if stop == 0.0:
            assert torch.equal(carry[0], got[0]) and torch.equal(carry[1], got[1])
        state = walk_state(*carry, g_color, g_trans)
        for s_args, done in slices:
            c_rows, c_out = backward_tiles_carry(*s_args, state, g_color, ntx, cfg, done)
            c_rows2, c_out2 = backward_tiles_carry(*s_args, state, g_color, ntx, cfg, done)
            torch.cuda.synchronize()
            p_rows, p_out = backward_tiles_plain(*s_args, None, None, g_color, None, ntx, cfg, done, state)
            _close_to_max(c_rows, p_rows)
            torch.testing.assert_close(c_out[:, 1], p_out[:, 1], rtol=RTOL, atol=ATOL)
            _close_to_max(c_out[:, 0], p_out[:, 0])
            assert torch.equal(c_rows, c_rows2) and torch.equal(c_out, c_out2)
            state = c_out


def _pool_arrays(c, seed):
    """A random densify pool: dead slots, low-opacity slots, a spread of
    scales, and an accumulated viewspace state (sum, count, max radius)."""
    rng = np.random.default_rng(seed)
    arrays = {
        "means": rng.uniform(-1, 1, (c, 3)).astype(np.float32),
        "log_scales": rng.uniform(-5.0, -0.5, (c, 3)).astype(np.float32),
        "quats": rng.normal(size=(c, 4)).astype(np.float32),
        "opacity_logits": rng.uniform(-7.0, 4.0, c).astype(np.float32),
        "sh": (rng.normal(size=(c, 16, 3)) * 0.3).astype(np.float32),
    }
    arrays["opacity_logits"][rng.uniform(size=c) > 0.6] = -30.0
    count = rng.integers(0, 4, c).astype(np.int32)
    state = ((rng.uniform(0, 4, c) * 1e-4 * count).astype(np.float32), count,
             np.ceil(rng.uniform(0, 60, c)).astype(np.float32))
    return arrays, state


def test_densify_pass_on_card_matches_cpu(device):
    """One clone/split/prune pass with the same pool, state and split
    samples on the card and on the CPU: the same touched rows and stats,
    and bitwise the same pool except the means of new split halves, whose
    offsets ``R @ (exp(log_scale) * eps)`` take ``exp`` from the card's and
    the CPU's own libraries, which may round one ulp apart: those within
    1e-6 of each row's largest component."""
    from gsplat_tpu_torch.train import densify as D

    arrays, state = _pool_arrays(4096, 3)
    eps = torch.randn((4096, 3), generator=torch.Generator().manual_seed(0))
    cfg = tgs.DensifyConfig(grad_threshold=1e-4, percent_dense=0.05, size_prune_start=0, max_screen_size=40.0)
    outs = []
    for dev in (device, torch.device("cpu")):
        model = tgs.GaussianModel.from_arrays(arrays, device=dev)
        st = D.DensifyState(*(torch.from_numpy(x).to(dev) for x in state))
        _, touched, stats = D._densify_prune_step(model, st, eps.to(dev), 2.0, cfg, 10)
        outs.append((model, touched.cpu(), stats))
    (card, c_touched, c_stats), (cpu, touched, stats) = outs
    assert c_stats == stats and stats["cloned"] > 0 and stats["split"] > 0 and stats["pruned"] > 0, stats
    assert torch.equal(c_touched, touched)
    for name in ("log_scales", "quats", "opacity_logits", "sh"):
        assert torch.equal(getattr(card, name).detach().cpu(), getattr(cpu, name).detach()), name
    got, want = card.means.detach().cpu(), cpu.means.detach()
    new_rows = touched & D.alive_mask(cpu)
    assert torch.equal(got[~new_rows], want[~new_rows])
    scale = want[new_rows].abs().amax(dim=1, keepdim=True)
    assert bool(((got[new_rows] - want[new_rows]).abs() <= 1e-6 * scale).all())


def test_densifying_fit_resumes_bitwise_on_card(device, tmp_path):
    """A densifying fit at 256x192 (passes at steps 3 and 6), interrupted
    after step 4 and resumed by a fresh trainer from its loop checkpoint,
    reaches the uninterrupted run's parameters and losses bitwise."""
    rng = np.random.default_rng(9)
    n, w, h = 3000, 256, 192
    arrays = {
        "means": np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n), rng.uniform(-1, 1, n)], 1).astype(np.float32),
        "log_scales": rng.uniform(-4.0, -2.0, (n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity_logits": rng.uniform(-1.0, 3.0, n).astype(np.float32),
        "sh": (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32),
    }
    fx = 0.8 * w
    cams = [tgs.CameraParams(w, h, 2 * math.atan(w / (2 * fx)), 2 * math.atan(h / (2 * fx)), fx, fx,
                             (math.cos(a / 2), 0.0, math.sin(a / 2), 0.0), (shift, 0.0, 4.0))
            for a, shift in ((0.0, 0.0), (0.1, 0.3), (-0.1, -0.3))]
    cfg = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 19)
    with torch.no_grad():
        target_model = tgs.GaussianModel.from_arrays(arrays, device=device)
        views = [(cam, tgs.render(target_model, cam, cfg)[0]) for cam in cams]
    arrays["means"] += rng.normal(0, 0.02, arrays["means"].shape).astype(np.float32)
    tc = tgs.TrainConfig(steps=8, log_every=1, ssim_weight=0.2, checkpoint_every=2, background="random",
                         densify=tgs.DensifyConfig(every=3, start=1, grad_threshold=5e-4, size_prune_start=0,
                                                   prune_scale_extent=1.0, max_screen_size=10.0, percent_dense=0.5,
                                                   opacity_reset_every=5, pool_factor=1.5))
    ref, ref_hist = tgs.Trainer(raster=cfg, train=tc, show_progress=False).fit(
        tgs.GaussianModel.from_arrays(arrays, device=device), views)
    ckpt = str(tmp_path / "run")
    tgs.Trainer(raster=cfg, train=tc, show_progress=False).fit(
        tgs.GaussianModel.from_arrays(arrays, device=device), views, steps=5, checkpoint_dir=ckpt)
    res, res_hist = tgs.Trainer(raster=cfg, train=tc, show_progress=False).fit(
        tgs.GaussianModel.from_arrays(arrays, device=device), views, checkpoint_dir=ckpt, resume=True)
    assert [r["step"] for r in res_hist] == [5, 6, 7]
    assert res_hist == ref_hist[5:]
    assert ref.num_gaussians != n and ref.means.device.type == "cuda"
    for name in ("means", "log_scales", "quats", "opacity_logits", "sh"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name


def _write_cli_scene(root, width=256, height=192, n=2000, seed=11):
    """A scene on disk for the command line, written with the port's own
    writers: one PINHOLE camera, two views, a random model as the trained
    checkpoint and random ground-truth PNGs."""
    from PIL import Image

    from gsplat_tpu_torch.io import colmap
    from gsplat_tpu_torch.io.ply import save_splat_arrays
    from gsplat_tpu_torch.io.scene import checkpoint_ply_path

    rng = np.random.default_rng(seed)
    save_splat_arrays(checkpoint_ply_path(os.path.join(root, "model")), {
        "means": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "log_scales": rng.uniform(-4.0, -1.5, (n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity_logits": rng.uniform(-1.0, 4.0, n).astype(np.float32),
        "sh": (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32),
    })
    fx = 0.8 * width
    colmap.write_intrinsics_binary(os.path.join(root, "sparse/0/cameras.bin"), {1: colmap.Camera(
        id=1, model="PINHOLE", width=width, height=height, params=np.array([fx, fx, width / 2, height / 2]))})
    images = {i: colmap.BaseImage(id=i, qvec=np.array([math.cos(a / 2), 0.0, math.sin(a / 2), 0.0]),
                                  tvec=np.array([0.0, 0.0, 4.0]), camera_id=1, name=f"view_{i}.png",
                                  xys=np.zeros((0, 2)), point3D_ids=np.zeros((0,), np.int64))
              for i, a in enumerate((0.15, -0.1))}
    colmap.write_extrinsics_binary(os.path.join(root, "sparse/0/images.bin"), images)
    os.makedirs(os.path.join(root, "images_1"))
    for image in images.values():
        Image.fromarray(rng.integers(0, 256, (height, width, 3), dtype=np.uint8)).save(
            os.path.join(root, "images_1", image.name))


def test_cli_on_card_matches_cpu(device, tmp_path):
    """``evaluate`` through the command line with ``--device cuda`` (one
    forward launch per view) and ``--device cpu``: the same views, PSNR
    within 1e-3 dB, SSIM within 1e-5. ``render``'s view and its
    ``render.png`` through the command's own helpers (the command draws a
    matplotlib figure, and the card's machine has no matplotlib): the card's
    PNG within 1 LSB of the CPU's."""
    from click.testing import CliRunner
    from PIL import Image

    from gsplat_tpu_torch import cli as C
    from gsplat_tpu_torch.utils.video import save_frame

    root = str(tmp_path / "scene")
    _write_cli_scene(root)
    common = ["--input_dir", root, "--trained_model_path", os.path.join(root, "model"), "--scale-factor", "1",
              "--scene-index", "0", "--tile-size", "16", "--chunk-size", "8", "--max-pairs", str(1 << 16)]
    metrics, pngs = {}, {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / dev)
        before = forward_tiles.launches
        result = CliRunner().invoke(C.cli, ["evaluate", *common, "--device", dev, "--output_path", out])
        assert result.exit_code == 0, result.output + repr(result.exception)
        assert forward_tiles.launches == before + (2 if dev == "cuda" else 0)
        with open(os.path.join(out, "metrics.json")) as f:
            metrics[dev] = json.load(f)
        cfg = C._raster_config(16, 8, 1 << 16, 0.0, dev)
        model, camera, _, _ = C._load_scene(root, os.path.join(root, "model"), 0, 1, dev)
        with torch.inference_mode():
            save_frame(os.path.join(out, "render.png"), tgs.render(model, camera, cfg)[0].cpu().numpy())
        pngs[dev] = np.asarray(Image.open(os.path.join(out, "render.png")).convert("RGB"), dtype=np.int16)
    assert np.abs(pngs["cuda"] - pngs["cpu"]).max() <= 1
    card, cpu = metrics["cuda"]["views"], metrics["cpu"]["views"]
    assert [v["view"] for v in card] == [v["view"] for v in cpu] == ["view_0.png", "view_1.png"]
    for a, b in zip(card, cpu):
        assert abs(a["psnr"] - b["psnr"]) < 1e-3 and abs(a["ssim"] - b["ssim"]) < 1e-5, (a, b)


def _mesh_arrays(n, seed):
    """Random splat parameters in front of :func:`_pinhole`'s camera."""
    rng = np.random.default_rng(seed)
    return {
        "means": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "log_scales": rng.uniform(-4.0, -1.5, (n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity_logits": rng.uniform(-1.0, 4.0, n).astype(np.float32),
        "sh": (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32),
    }


def _pinhole(width, height):
    """``scene``'s camera at another frame size, as ``CameraParams`` fields."""
    fx = 0.8 * width
    return dict(width=width, height=height, fov_x=2 * math.atan(width / (2 * fx)),
                fov_y=2 * math.atan(height / (2 * fx)), focal_x=fx, focal_y=fx,
                qvec=(math.cos(0.075), 0.0, math.sin(0.075), 0.0), tvec=(0.0, 0.0, 4.0))


def test_mesh_render_on_padded_frame_is_bitwise(device, tmp_path):
    """A 1x4 mesh of gloo ranks sharing the card renders a 200x150 frame at
    tile 16 (a 13x10 grid, stride 2x2, local 7x5): the padding column's
    tile ids alias the next row's first tile and the last row's run past
    the grid, with zero pairs. The frame is bitwise the single-device one,
    through the forward kernel on every rank."""
    import torch_mesh_worker as worker

    ranks = worker.spawn_world(worker.padded_frame_world, 4, tmp_path, _mesh_arrays(3000, 12), _pinhole(200, 150),
                               dict(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 16), device="cuda")
    for rank in ranks:
        assert rank["bitwise"], rank
        assert rank["launches"] == 2  # the single-device render and this rank's tiles


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_mesh_step_on_card_matches_one_device(device, tmp_path, backend):
    """One 2x2 train step of gloo ranks sharing the card, with one camera
    repeated over the batch, against the 1x1 step of a world of one over
    ``backend`` (nccl: the backend a card a rank takes): loss at rtol 1e-5,
    means at rtol 1e-4 / atol 1e-7 (as ``tests/test_parallel.py`` holds
    JAX's mesh shapes), the replicas bitwise equal."""
    import torch_mesh_worker as worker

    arrays, cam = _mesh_arrays(300, 13), _pinhole(worker.W, worker.H)
    target = np.random.default_rng(3).uniform(0, 1, (worker.H, worker.W, 3)).astype(np.float32)
    one = worker.spawn_world(worker.repeated_step_world, 1, tmp_path / "one", arrays, cam, target, 1, 1,
                             device="cuda", backend=backend)[0]
    four = worker.spawn_world(worker.repeated_step_world, 4, tmp_path / "four", arrays, cam, target, 2, 2,
                              device="cuda")
    assert len({r["digest"] for r in four}) == 1
    got = four[0]
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-5)
    np.testing.assert_allclose(got["params"]["means"], one["params"]["means"], rtol=1e-4, atol=1e-7)


def test_coverage_histogram_on_card_matches_cpu(device):
    """``coverage_histogram`` adds integers (``index_add_`` of +-1 at rect
    corners, then prefix sums), so the card's counts equal the CPU's, here
    at the headline's 60x34 grid with counts in the thousands."""
    gen = torch.Generator().manual_seed(3)
    n, nx, ny = 20000, 60, 34
    tx0, ty0 = torch.randint(0, nx, (n,), generator=gen), torch.randint(0, ny, (n,), generator=gen)
    rects = (tx0, ty0, torch.randint(0, 40, (n,), generator=gen).clamp(max=nx - tx0),
             torch.randint(0, 30, (n,), generator=gen).clamp(max=ny - ty0))
    keep = torch.rand(n, generator=gen) < 0.8
    want = binning.coverage_histogram(rects, keep, nx, ny)
    got = binning.coverage_histogram(tuple(r.to(device) for r in rects), keep.to(device), nx, ny)
    assert got.device.type == "cuda" and want.max() > 1000
    assert torch.equal(got.cpu(), want)


def test_bench_step_on_card_matches_cpu(device):
    """``tools/bench_torch.py``'s timed step (render, ``rgb_loss`` with SSIM
    weight 0.2, gradients to the five parameters; a warm-up and one timed
    step) on 20,000 gaussians of the benchmark's synthetic scene at scale
    shift 2.5 and 256x192, drawn on the CPU: the card's final loss within
    rel 1e-5 of the CPU's, in exact mode and with early stop 1e-4, one
    forward launch a step on the card."""
    import bench_torch

    arrays = card.build_scene(20_000, 2.5, "cpu").to_arrays()
    camera = card.camera_params(256, 192, 0.0, 0.0)
    losses = {}
    for dev in ("cpu", "cuda"):
        model = tgs.GaussianModel.from_arrays(arrays, device=dev)
        cam = tgs.CameraArrays.from_params(camera, device=dev)
        target = torch.zeros((192, 256, 3), device=dev) + 0.25
        cap, _ = bench_torch.sized_capacity(model, cam, width=256, height=192)
        for stop in (0.0, 1e-4):
            before = forward_tiles.launches
            cfg = bench_torch.make_cfg(cap, stop)
            losses[dev, stop] = bench_torch.time_fwd_bwd(model, cam, target, cfg, iters=1)[1]
            assert forward_tiles.launches - before == (2 if dev == "cuda" else 0)
    for stop in (0.0, 1e-4):
        assert losses["cuda", stop] == pytest.approx(losses["cpu", stop], rel=1e-5), (stop, losses)


def test_probe_transpose_kernels_on_card(device):
    """``tools/probe_transpose.py``'s kernels (``kernels/probes.py``) bitwise
    their plain versions on the card: both shared-memory transposes, seven
    slabs through the bulk copy, and the tensor-core transpose in both
    modes, on normal draws, draws over 2^-30-2^30 and exact TF32 ties (where
    one-pass rounding goes away from zero); 3xTF32 is bitwise ``x.T``. At
    the tool's special blocks (inf, NaN, signed zeros, subnormals, the
    smallest and largest normals) the tensor-core transpose in both modes
    has NaN where its plain version has and every other element's bits;
    3xTF32 is bitwise ``x.T`` at the finite normal blocks; both
    shared-memory transposes move those blocks and random 32-bit patterns
    bit for bit."""
    from gsplat_tpu_torch.kernels import probes as P
    import probe_transpose as PT

    rng = np.random.default_rng(15)
    wide = rng.normal(size=(16, 128)) * 2.0 ** rng.uniform(-30, 30, (16, 128))
    for block in (rng.normal(size=(16, 128)), wide, PT.tf32_ties(rng, (16, 128))):
        x = torch.from_numpy(block.astype(np.float32)).to(device)
        before = P.transpose_mma.launches
        for split3 in (False, True):
            assert torch.equal(P.transpose_mma(x, split3), P.transpose_mma_plain(x, split3)), split3
        assert torch.equal(P.transpose_mma(x, True), x.t())
        assert P.transpose_mma.launches - before == 3
        for t in (x, x.t().contiguous()):
            assert torch.equal(P.transpose_smem(t), t.t())
    special = PT.special_blocks()
    for name, block in special.items():
        x = torch.from_numpy(block).to(device)
        for split3 in (False, True):
            got = P.transpose_mma(x, split3)
            assert PT.same_values(got, P.transpose_mma_plain(x, split3)), (name, split3)
            if split3 and name in PT.FINITE_NORMAL:
                assert torch.equal(got, x.t()), name
    for block in (*special.values(), PT.random_bits()):
        x = torch.from_numpy(block).to(device)
        for t in (x, x.t().contiguous()):
            assert torch.equal(P.transpose_smem(t).view(torch.int32), t.t().contiguous().view(torch.int32))
    assert PT.special_checks(device)["mma"] == {"tf32": True, "3xtf32": True, "x_t": True}
    xb = torch.from_numpy(rng.normal(size=(7, 16, 128)).astype(np.float32)).to(device)
    assert torch.equal(P.transpose_block_async(xb), P.transpose_block_plain(xb))
    with pytest.raises(ValueError):
        P.transpose_smem(torch.zeros((16, 64), device=device))
    with pytest.raises(ValueError):  # the float4 loads need 16-byte alignment
        P.transpose_mma(torch.zeros(16 * 128 + 1, device=device)[1:].view(16, 128), True)


def test_probe_lane_dma_on_card(device):
    """``tools/probe_lane_dma.py``'s TMA lane copy bitwise its plain version
    on a ``[16, 1024]`` array, every slice once in shuffled order, and
    refused for a start off the 128 grid or past the array."""
    from gsplat_tpu_torch.kernels import probes as P

    x = torch.from_numpy(np.random.default_rng(16).normal(size=(16, 1024)).astype(np.float32)).to(device)
    starts = [768, 0, 512, 256, 128, 896, 640, 384]
    before = P.lane_dma.launches
    got = P.lane_dma(x, starts)
    assert P.lane_dma.launches - before == 1
    assert torch.equal(got, P.lane_dma_plain(x, starts)) and torch.equal(got, x * 2)
    for bad in ([64], [1024], [-128], []):
        with pytest.raises(ValueError):
            P.lane_dma(x, bad)


@pytest.mark.parametrize("orientation", ["a", "b"])
def test_orientation_kernels_on_card(device, orientation):
    """``tools/orientation_test.py``'s kernels against their plain versions
    on the card at 3 chunks: zero at ``t0 = 0``, within rtol 1e-5 / atol
    1e-6 at ``t0`` 0.5 and 1 (the card's ``expf`` against PyTorch's), at the
    TPU probe's inputs, the passing set and the sparse set, where T is
    bitwise the plain version's."""
    from gsplat_tpu_torch.kernels import probes as P
    import orientation_test

    wrapper, plain = ((P.orientation_a, P.orientation_a_plain) if orientation == "a"
                      else (P.orientation_b, P.orientation_b_plain))
    blocks = {"jax": orientation_test.jax_features(orientation),
              "passing": orientation_test.passing_features(orientation, seed=3),
              "sparse": orientation_test.sparse_features(orientation, seed=3)}
    for features, block in blocks.items():
        feat = torch.from_numpy(block).to(device)
        assert bool((wrapper(feat, 3, 0.0) == 0).all())
        for t0 in (0.5, 1.0):
            got, want = wrapper(feat, 3, t0), plain(feat, 3, t0)
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            if features == "sparse":
                trans = orientation_test.transmittance
                assert torch.equal(trans(got, orientation), trans(want, orientation))


@pytest.mark.parametrize("sliced", [False, True])
def test_tracer_on_card(device, sliced):
    """The tracer on the card: every span has its CUDA events; the
    backward's spans run on autograd's thread, the first of them with the
    caller's span as parent, all with the step id; counters read after the
    fence (``loss_kernel`` 1: the step's loss took the kernels); the same
    gradients as with the tracer off."""
    import threading

    from gsplat_tpu_torch.utils import stages

    model, camera = scene(device)
    cfg = dataclasses.replace(CFG, slice_pairs=64 if sliced else 0, reduce_pairs=1024,
                              early_stop_transmittance=1e-4)

    def step():
        image, _ = tgs.render(model, camera, cfg)
        loss = tgs.rgb_loss(image, torch.full_like(image, 0.25), 0.2)
        with stages.stage("backward"):
            return torch.autograd.grad(loss, list(model.parameters()))

    want = step()
    with stages.record_stages() as rec:
        with stages.step(5):
            got = step()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
        assert s.step == 5 and s.start.elapsed_time(s.end) >= 0.0
    (back,) = by["backward"]
    main = threading.get_native_id()
    assert back.thread == main
    for name in ("loss_bwd", "raster_bwd", "reduction", "preprocess_bwd"):
        assert by[name][0].thread != main, name
    assert by["loss_bwd"][0].parent == back.id
    assert by["loss_bwd"][0].host_end_ns <= by["raster_bwd"][0].host_start_ns
    counts = {}
    for name, step_id, value in rec.counter_values():
        counts[name] = counts.get(name, 0) + value
    assert counts["host_syncs"] == len([s for s in rec.spans if s.sync]) >= 1
    assert counts["pairs"] > 0 and ("slices" in counts) == sliced
    assert counts["loss_kernel"] == 1


def test_recipe_steps_on_card_match_reference(device):
    """The benchmark's ``recipe_5m.fit`` step (``splatbench/steps/fit.py``:
    the loop state restored to iteration 7,550, then ``Trainer.fit_step``
    on the densify pool) on a 20,000-gaussian draw of its scene at
    384x256 on the card: a step and a pass step (step 50, iteration 7,600)
    held to the plain float64 reference ``splatbench/reference/fit.py``
    within the cell's own limits, which its full-size runs are held to."""
    from splatbench import compare, run, spec
    from splatbench.reference import reference_answer

    bench = json.loads((run.REPO / "BENCHMARK.json").read_text())
    cell = spec.load_cell(bench, "recipe_5m.fit", run.REPO)
    config = dict(cell.config, n_gaussians=20_000, width=384, height=256, slice_pairs=1 << 14,
                  reduce_pairs=1 << 15)
    cell = cell._replace(config=config, traffic=dict(cell.traffic, warmup_seconds=0.0))
    params, prog, _ = run.set_up(cell, 2147483659, device)
    answers = {i: prog.step(i) for i in (1, 50)}
    limits = compare.load_limits(run.HERE, "recipe_5m.fit")
    assert answers[50].passed and not answers[1].passed
    for i, got in answers.items():
        want, _ = reference_answer(params, prog.poses[prog.pose_of(i)], config, cell.traffic)
        correct, checks = compare.judge(compare.numbers("fit", got, want, config["early_stop"]), limits)
        assert correct, (i, checks)
