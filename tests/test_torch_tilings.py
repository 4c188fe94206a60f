"""The port's compositors at every tiling the JAX package takes, held
against JAX.

The JAX package takes any positive ``tile_size`` and any ``pair_block``
that is a multiple of ``chunk_size``; so does the port: on the CPU its
plain compositors, on the card its CUDA kernels (the grid of 8x4 warp
rects rounded up past the tile's edge, one to four pixels a thread, pair
rows staged in sub-batches of at most 256, and a tile above 64 cut into
pixel groups of one thread block each). Here, on the CPU, at tiles 4, 12,
20, 64, 80 and 128 and at pair block 2048, one JAX
preprocess of a 70x50 view is binned by the port at each tiling and the
same binned inputs go through:

* the forward: ``forward_tiles_plain`` against ``forward_tiles_jnp`` and
  ``forward_tiles_pallas`` in interpret mode, at rtol 1e-5 / atol 1e-6;
* the gradient of the features: ``backward_tiles_plain`` and the sorted
  reduction against ``backward_tiles_jnp`` and ``backward_tiles_pallas``
  (sorted reduction) in interpret mode, at rtol 5e-4 / atol 1e-5 of the
  gradient scale, the sorted reduction's tolerance in
  ``tests/test_torch_grad.py``. The Pallas backward sums its per-pair
  pixel terms through moments about the tile's origin on the matrix unit,
  which loses accuracy as the tile grows: against the exact (float64) sum
  of the same walk it is 1.9e-5 of the scale off at tile 64 and 9.3e-5 at
  tile 128, where the port and the jnp path stay within 1e-6. So above 64
  the port is held to the Pallas result at that tolerance plus the Pallas
  result's own distance from the float64 sum, element by element.

The whole render and its gradients at these tilings are in
``tests/test_torch_tilings_render.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as jgs
from gsplat_tpu.kernels.raster_bwd import backward_tiles_pallas
from gsplat_tpu.kernels.raster_fwd import forward_tiles_pallas
from gsplat_tpu.models.gaussians import GaussianModel as JModel
from gsplat_tpu.render.pipeline import preprocess as j_preprocess
from gsplat_tpu.render.tile_jnp import backward_tiles_jnp, forward_tiles_jnp

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles_plain, reduce_pair_grads
from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles_plain
from gsplat_tpu_torch.ops import binning as B
from gsplat_tpu_torch.ops.projection import Preprocessed

from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

WIDTH, HEIGHT = 70, 50
# (tile_size, chunk_size, pair_block)
TILINGS = [(4, 8, 8), (12, 8, 8), (20, 8, 16), (64, 8, 32), (32, 1024, 2048), (80, 8, 16), (128, 8, 32)]


def t(x):
    return torch.from_numpy(np.array(x))


def close_to_scale(got, want, rtol, atol_of_scale):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_of_scale * scale)


@pytest.fixture(scope="module")
def prep():
    """One JAX preprocess of 120 splats grown to span several small tiles."""
    arrays = random_splat_arrays(np.random.default_rng(17), 120)
    arrays["log_scales"] += 0.7
    jcfg = jgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8)
    return j_preprocess(JModel.from_arrays(arrays), orbit_camera(0.2, width=WIDTH, height=HEIGHT), jcfg)


@pytest.mark.parametrize("tiling", TILINGS, ids=lambda x: f"tile{x[0]}_block{x[2]}")
def test_compositors_match_jax(prep, tiling):
    ts, cs, blk = tiling
    cfg = tgs.RasterConfig(tile_size=ts, chunk_size=cs, pair_block=blk, max_pairs=2048)
    jcfg = jgs.RasterConfig(tile_size=ts, chunk_size=cs, pair_block=blk, max_pairs=2048)
    bins = B.bin_gaussians(Preprocessed(*(t(x) for x in prep)), WIDTH, HEIGHT, ts, cfg.max_pairs, align=blk)
    assert int(bins.pair_demand) <= cfg.max_pairs
    ntx = -(-WIDTH // ts)
    tile_ids = torch.arange(ntx * -(-HEIGHT // ts), dtype=torch.int32)
    args = (B.pack_features(Preprocessed(*(t(x) for x in prep))), bins.pair_gaussian, bins.tile_start,
            bins.tile_count, tile_ids)
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    counts = bins.gaussian_counts

    color, trans, done = forward_tiles_plain(*args, ntx, cfg, WIDTH, HEIGHT)
    j_color, j_trans = forward_tiles_jnp(*jargs, ntx, jcfg)
    p_color, p_trans, p_done = forward_tiles_pallas(*jargs, ntx, jcfg, interpret=True, width=WIDTH, height=HEIGHT)
    for want_color, want_trans in ((j_color, j_trans), (p_color, p_trans)):
        np.testing.assert_allclose(color.numpy(), np.asarray(want_color), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(trans.numpy(), np.asarray(want_trans), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(done.numpy(), np.asarray(p_done))

    rng = np.random.default_rng(ts)
    g_color = rng.normal(size=color.shape).astype(np.float32)
    g_trans = rng.normal(size=trans.shape).astype(np.float32)
    rows = backward_tiles_plain(*args, color, trans, t(g_color), t(g_trans), ntx, cfg, done)
    got = reduce_pair_grads(rows, args[1], counts, args[0].shape[0])[:-1, :9].numpy()
    outs = (j_color, j_trans, jnp.asarray(g_color), jnp.asarray(g_trans))
    want_jnp = np.asarray(backward_tiles_jnp(*jargs, *outs, ntx, jcfg))[:-1, :9]
    close_to_scale(got, want_jnp, 5e-4, 1e-5)
    want_pallas = backward_tiles_pallas(*jargs, *outs, ntx, jcfg, blocks_done=p_done,
                                        gaussian_counts=jnp.asarray(counts.numpy()), interpret=True)
    want_pallas = np.asarray(want_pallas)[:-1, :9]
    if ts <= 64:
        close_to_scale(got, want_pallas, 5e-4, 1e-5)
        return
    rows64 = backward_tiles_plain(args[0].double(), *args[1:], color.double(), trans.double(),
                                  t(g_color).double(), t(g_trans).double(), ntx, cfg, done)
    exact = reduce_pair_grads(rows64, args[1], counts, args[0].shape[0])[:-1, :9].numpy()
    close_to_scale(got, exact, 5e-4, 1e-5)
    slack = np.abs(want_pallas - exact)
    bound = 5e-4 * np.abs(want_pallas) + 1e-5 * (np.abs(want_pallas).max() + 1e-8) + slack
    assert (np.abs(got - want_pallas) <= bound).all()
