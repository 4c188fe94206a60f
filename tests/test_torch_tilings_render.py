"""The port's render and its gradients at every tiling the JAX package
takes, and ``RasterConfig.exact_grad_reduction``, held against JAX.

With early stop off every pixel composites the same depth-ordered gaussians
whatever the tiling, so the port's frame at tiles 4, 12, 20, 64 and 100
(on the card, pixel groups of edge 50) and at pair block 2048 is bitwise
its tile-16 frame, and its render and parameter
gradients are held to one JAX ``render`` + ``jax.grad`` on the jnp path at
rtol 1e-5 / atol 1e-6 and rtol 2e-3 / atol 5e-5 of each gradient's scale
(``tests/test_torch_grad.py``). ``tests/test_torch_tilings.py`` holds the
compositors themselves to JAX's jnp and Pallas paths at each tiling.

``exact_grad_reduction`` sums each gaussian's per-pair rows in float64 and
rounds once, ahead of the compacted reduction: the reduction of the port's
rows is held to JAX's exact segment sum of the same rows (what the flag
selects in ``gsplat_tpu/kernels/raster_bwd.py:531``) at rtol 1e-6 / atol
1e-6 of the gradient scale, and the feature gradient of ``rasterize_tiles``
to ``backward_tiles_jnp`` at the exact reduction's tolerance of
``tests/test_torch_grad.py`` (rtol 1e-4 / atol 1e-6 of the scale: the
per-pair pixel sums run in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as jgs
from gsplat_tpu.models.gaussians import GaussianModel as JModel
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.render.pipeline import preprocess as j_preprocess
from gsplat_tpu.render.tile_jnp import backward_tiles_jnp, forward_tiles_jnp

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.kernels import raster as traster
from gsplat_tpu_torch.kernels.raster import rasterize_tiles
from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles_plain

from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

WIDTH, HEIGHT = 70, 50
NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")
# (tile_size, chunk_size, pair_block)
TILINGS = [(4, 8, 8), (12, 8, 8), (20, 8, 16), (64, 8, 32), (16, 32, 2048), (100, 8, 32)]


def t(x):
    return torch.from_numpy(np.array(x))


def close_to_scale(got, want, rtol, atol_of_scale):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_of_scale * scale)


def _render(arrays, jcam, cfg, w_img, w_trans):
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    img, trans = tgs.render(model, tgs.CameraParams(**dataclasses.asdict(jcam)), cfg)
    loss = torch.sum(img * t(w_img)) + torch.sum(trans * t(w_trans))
    return img.detach(), trans.detach(), torch.autograd.grad(loss, [getattr(model, k) for k in NAMES])


@pytest.fixture(scope="module")
def scene():
    """The scene, seeded cotangents, JAX's render and gradients (jnp path,
    tile 16) and the port's tile-16 frame."""
    arrays = random_splat_arrays(np.random.default_rng(17), 120)
    arrays["log_scales"] += 0.7  # splats that span several small tiles
    jcam = orbit_camera(0.2, width=WIDTH, height=HEIGHT)
    rng = np.random.default_rng(23)
    w_img = rng.normal(size=(HEIGHT, WIDTH, 3)).astype(np.float32) * 0.1
    w_trans = rng.normal(size=(HEIGHT, WIDTH)).astype(np.float32) * 0.1
    size = dict(tile_size=16, chunk_size=8, pair_block=8, max_pairs=2048)

    def j_loss(m):
        img, trans = jgs.render(m, jcam, jgs.RasterConfig(**size, use_pallas=False))
        return jnp.sum(img * w_img) + jnp.sum(trans * w_trans), (img, trans)

    (_, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(JModel.from_arrays(arrays))
    with torch.no_grad():
        ref = tgs.render(tgs.GaussianModel.from_arrays(arrays, device="cpu"),
                         tgs.CameraParams(**dataclasses.asdict(jcam)), tgs.RasterConfig(**size))
    return arrays, jcam, w_img, w_trans, j_out, j_grads, ref


@pytest.mark.parametrize("tiling", TILINGS, ids=lambda x: f"tile{x[0]}_block{x[2]}")
def test_render_and_grads_match_jax(scene, tiling):
    arrays, jcam, w_img, w_trans, (j_img, j_trans), j_grads, ref = scene
    ts, cs, blk = tiling
    cfg = tgs.RasterConfig(tile_size=ts, chunk_size=cs, pair_block=blk, max_pairs=2048)
    img, trans, grads = _render(arrays, jcam, cfg, w_img, w_trans)
    assert torch.equal(img, ref[0]) and torch.equal(trans, ref[1])
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(trans.numpy(), np.asarray(j_trans), rtol=1e-5, atol=1e-6)
    for name, got in zip(NAMES, grads):
        close_to_scale(got.numpy(), np.asarray(getattr(j_grads, name)), 2e-3, 5e-5)


def test_exact_grad_reduction_matches_jax(monkeypatch):
    """``rasterize_tiles`` with ``exact_grad_reduction`` (and
    ``reduce_pairs`` set, which it goes ahead of): no f32 reduction runs,
    two runs are bitwise equal, the reduction of the port's rows is JAX's
    exact segment sum of them, and the feature gradient is JAX's."""
    ts, cs, blk = 12, 8, 16
    arrays = random_splat_arrays(np.random.default_rng(5), 200)
    jcfg = jgs.RasterConfig(tile_size=ts, chunk_size=cs, pair_block=blk, max_pairs=4096, use_pallas=False,
                            exact_grad_reduction=True)
    prep = j_preprocess(JModel.from_arrays(arrays), orbit_camera(0.15, width=48, height=32), jcfg)
    bins = jbin.bin_gaussians(prep, 48, 32, ts, jcfg.max_pairs, align=blk)
    ntx = -(-48 // ts)
    tile_ids = jnp.arange(ntx * -(-32 // ts), dtype=jnp.int32)
    jargs = (jbin.pack_features(prep), bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids)
    color, trans = forward_tiles_jnp(*jargs, ntx, jcfg)
    rng = np.random.default_rng(8)
    g_color = rng.normal(size=color.shape).astype(np.float32)
    g_trans = rng.normal(size=trans.shape).astype(np.float32)
    want = np.asarray(backward_tiles_jnp(*jargs, color, trans, jnp.asarray(g_color), jnp.asarray(g_trans), ntx,
                                         jcfg))
    args = tuple(t(a) for a in jargs)
    cfg = tgs.RasterConfig(tile_size=ts, chunk_size=cs, pair_block=blk, max_pairs=4096,
                           exact_grad_reduction=True, reduce_pairs=blk)
    reductions = []
    monkeypatch.setattr(traster, "reduce_pair_grads", lambda *a: reductions.append("f32"))
    monkeypatch.setattr(traster, "reduce_compacted", lambda *a: reductions.append("compacted"))
    runs = []
    for _ in range(2):
        feat = args[0].clone().requires_grad_(True)
        c, tr = rasterize_tiles(feat, *args[1:], t(bins.gaussian_counts), ntx, cfg, 48, 32)
        (d_feat,) = torch.autograd.grad((c * t(g_color)).sum() + (tr * t(g_trans)).sum(), [feat])
        runs.append(d_feat)
    assert reductions == [] and torch.equal(runs[0], runs[1])
    got = runs[0]
    assert not got[-1].any() and not got[:, 9:].any()
    # The reduction alone: JAX's exact segment sum of the port's own rows.
    rows = backward_tiles_plain(*args, t(color), t(trans), t(g_color), t(g_trans), ntx, cfg)
    n = args[0].shape[0]
    segment = jax.ops.segment_sum(jnp.asarray(rows.numpy()), jargs[1], num_segments=n)
    close_to_scale(traster._reduce(rows, args[1], None, t(bins.gaussian_counts), None, n, cfg)[:-1, :9].numpy(),
                   np.asarray(segment)[:-1], 1e-6, 1e-6)
    close_to_scale(got[:-1].numpy(), want[:-1], 1e-4, 1e-6)
