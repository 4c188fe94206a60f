"""The port's forward compositor held against the JAX package's.

``forward_tiles_plain`` (the CUDA kernel's plain PyTorch version) is held
against the Pallas kernel in interpret mode and against the jnp tile
renderer on the ``tests/test_pallas_kernels.py`` setup, at rtol=1e-5 /
atol=1e-6 (the tolerance those tests hold Pallas to jnp at): the plain
version composites pair by pair where the JAX code uses a chunked cumprod,
so products are ordered differently. ``blocks_done`` must equal the Pallas
kernel's. The CUDA kernel itself is held against the plain version on the
card by ``tests/test_torch_gpu.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import RasterConfig as JRasterConfig
from gsplat_tpu.kernels.raster_fwd import forward_tiles_pallas
from gsplat_tpu.models.gaussians import GaussianModel as JModel
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.render.pipeline import preprocess as j_preprocess
from gsplat_tpu.render.tile_jnp import _tile_pixel_coords, forward_tiles_jnp, image_to_tiles as j_image_to_tiles
from gsplat_tpu.render.tile_jnp import tiles_to_image as j_tiles_to_image

from gsplat_tpu_torch import RasterConfig
from gsplat_tpu_torch.kernels.raster import rasterize_tiles
from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles_plain, reduce_pair_grads
from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_plain
from gsplat_tpu_torch.render.tile_torch import image_to_tiles, tile_pixel_coords, tiles_to_image

from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

JCFG = JRasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=4096, use_pallas=True)
CFG = RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=4096)
WIDTH, HEIGHT = 48, 32
NTX = -(-WIDTH // CFG.tile_size)
NTY = -(-HEIGHT // CFG.tile_size)
RTOL, ATOL = 1e-5, 1e-6


def _binned(seed, n, grow=0.0):
    arrays = random_splat_arrays(np.random.default_rng(seed), n)
    arrays["log_scales"] += grow
    arrays["opacity_logits"] += grow
    prep = j_preprocess(JModel.from_arrays(arrays), orbit_camera(0.15, width=WIDTH, height=HEIGHT), JCFG)
    bins = jbin.bin_gaussians(prep, WIDTH, HEIGHT, JCFG.tile_size, JCFG.max_pairs, align=JCFG.pair_block)
    feat = jbin.pack_features(prep)
    tile_ids = jnp.arange(NTX * NTY, dtype=jnp.int32)
    jax_args = (feat, bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids)
    return jax_args, tuple(torch.from_numpy(np.array(a)) for a in jax_args)


@pytest.fixture(scope="module")
def binned():
    return _binned(5, 150)


@pytest.fixture(scope="module")
def binned_dense():
    """Enough overlapping splats that early stop ends some tiles early."""
    return _binned(6, 800, grow=2.0)


def test_plain_matches_pallas_and_jnp(binned):
    jax_args, args = binned
    col_p, trans_p, done_p = forward_tiles_pallas(*jax_args, NTX, JCFG, interpret=True)
    col_j, trans_j = forward_tiles_jnp(*jax_args, NTX, JCFG)
    color, trans, done = forward_tiles_plain(*args, NTX, CFG)
    for want_c, want_t in ((col_p, trans_p), (col_j, trans_j)):
        np.testing.assert_allclose(color.numpy(), np.asarray(want_c), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(trans.numpy(), np.asarray(want_t), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(done.numpy(), np.asarray(done_p))


@pytest.mark.parametrize("threshold", [1e-4, 0.3])
def test_plain_early_stop_matches_pallas(binned_dense, threshold):
    """Block-granular early stop on coverable pixels, as the Pallas kernel
    does it: same blocks_done, same colors and T for what was composited."""
    jax_args, args = binned_dense
    jcfg = dataclasses.replace(JCFG, early_stop_transmittance=threshold)
    cfg = dataclasses.replace(CFG, early_stop_transmittance=threshold)
    col_p, trans_p, done_p = forward_tiles_pallas(
        *jax_args, NTX, jcfg, interpret=True, width=WIDTH, height=HEIGHT
    )
    color, trans, done = forward_tiles_plain(*args, NTX, cfg, WIDTH, HEIGHT)
    np.testing.assert_array_equal(done.numpy(), np.asarray(done_p))
    np.testing.assert_allclose(color.numpy(), np.asarray(col_p), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(trans.numpy(), np.asarray(trans_p), rtol=RTOL, atol=ATOL)
    all_blocks = -(-args[3] // CFG.pair_block)
    assert (done < all_blocks).any(), "the scene should stop some tile early"


def test_dispatch_on_cpu_is_the_plain_version(binned):
    _, args = binned
    before = forward_tiles.launches
    want = forward_tiles_plain(*args, NTX, CFG)
    got = forward_tiles(*args, NTX, CFG)
    color, trans = rasterize_tiles(*args, torch.zeros(0, dtype=torch.int32), NTX, CFG)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(color, want[0], rtol=0, atol=0)
    torch.testing.assert_close(trans, want[1], rtol=0, atol=0)
    assert forward_tiles.launches == before  # the CPU path launches no kernel


def test_rasterize_tiles_grad_and_no_grad(binned):
    """Under grad, ``rasterize_tiles``' gradient to ``feat`` is the plain
    backward + the sort-based reduction (the backward kernel's plain path on
    the CPU); without grad it is the forward alone, with nothing saved."""
    _, (feat, pair_gaussian, tile_start, tile_count, tile_ids) = binned
    counts = torch.bincount(pair_gaussian.long(), minlength=feat.shape[0])[:-1].to(torch.int32)
    rng = np.random.default_rng(0)
    feat = feat.clone().requires_grad_(True)
    args = (feat, pair_gaussian, tile_start, tile_count, tile_ids)
    color, trans = rasterize_tiles(*args, counts, NTX, CFG)
    g_color = torch.from_numpy(rng.normal(size=color.shape).astype(np.float32))
    g_trans = torch.from_numpy(rng.normal(size=trans.shape).astype(np.float32))
    (d_feat,) = torch.autograd.grad((color, trans), feat, (g_color, g_trans))
    with torch.no_grad():
        rows = backward_tiles_plain(*args, color, trans, g_color, g_trans, NTX, CFG)
        want = reduce_pair_grads(rows, pair_gaussian, counts, feat.shape[0])
    torch.testing.assert_close(d_feat, want, rtol=0, atol=0)
    assert d_feat.abs().max() > 0
    with torch.no_grad():
        color, trans = rasterize_tiles(*args, counts, NTX, CFG)
    assert color.grad_fn is None and trans.grad_fn is None


@pytest.mark.parametrize("width,height,channels", [(48, 32, (3,)), (50, 35, ()), (17, 40, (2, 2))])
def test_tile_layout_matches_jax(width, height, channels):
    image = np.random.default_rng(0).normal(size=(height, width) + channels).astype(np.float32)
    tiles = image_to_tiles(torch.from_numpy(image), 16)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(j_image_to_tiles(jnp.asarray(image), 16)))
    np.testing.assert_array_equal(tiles_to_image(tiles, width, height, 16).numpy(), image)
    np.testing.assert_array_equal(
        tiles_to_image(tiles, width, height, 16).numpy(),
        np.asarray(j_tiles_to_image(jnp.asarray(tiles.numpy()), width, height, 16)),
    )
    ntx = -(-width // 16)
    ids = torch.arange(tiles.shape[0], dtype=torch.int32)
    px, py = tile_pixel_coords(ids, ntx, 16, torch.float32)
    for t in range(tiles.shape[0]):
        jpx, jpy = _tile_pixel_coords(jnp.int32(t), ntx, 16, jnp.float32)
        np.testing.assert_array_equal(px[t].numpy(), np.asarray(jpx))
        np.testing.assert_array_equal(py[t].numpy(), np.asarray(jpy))
