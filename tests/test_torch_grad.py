"""The port's backward compositor, its gradient reduction and the gradients
of the whole render held against the JAX package.

``backward_tiles_plain`` (the CUDA kernel's plain PyTorch version) +
``reduce_pair_grads`` are held against:

* ``backward_tiles_pallas`` in interpret mode, at the tolerances
  ``tests/test_pallas_kernels.py`` holds it to the jnp twin (rtol 5e-3 for
  the exact reduction and 5e-4 for the sorted one, atol 1e-5 of the
  gradient scale): the Pallas kernel re-expands its pixel sums through
  tile-centred moments, which reorders f32 roundings;
* ``backward_tiles_jnp``, which takes the same direct pixel sums, at
  rtol 1e-4 / atol 1e-6 of the scale (only summation orders differ).

Gradients of the whole render and of the bench step (render + ``rgb_loss``)
are held against ``jax.grad`` through the JAX ``render`` with
``use_pallas=False`` at rtol 2e-3 / atol 5e-5 of each parameter's gradient
scale: the two pipelines agree to about 1e-5 of the scale, the sort-based
reduction and the f32 sums of the SSIM blur reordering additions. The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as jgs
from gsplat_tpu import RasterConfig as JRasterConfig
from gsplat_tpu.kernels.raster_bwd import backward_tiles_pallas
from gsplat_tpu.kernels.raster_fwd import forward_tiles_pallas
from gsplat_tpu.models.gaussians import GaussianModel as JModel
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.render.pipeline import preprocess as j_preprocess
from gsplat_tpu.render.tile_jnp import backward_tiles_jnp, forward_tiles_jnp
from gsplat_tpu.train.loss import rgb_loss as j_rgb_loss

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.kernels import raster as traster
from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles, backward_tiles_plain, blocked_cumsum, reduce_pair_grads
from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles_plain
from gsplat_tpu_torch.ops import binning as B

from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

JCFG = JRasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=4096, use_pallas=True)
CFG = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=4096)
WIDTH, HEIGHT = 48, 32
NTX = -(-WIDTH // CFG.tile_size)
NTY = -(-HEIGHT // CFG.tile_size)
NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")
SMALL = dict(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 12)


def t(x):
    return torch.from_numpy(np.array(x))


def close_to_scale(got, want, rtol, atol_of_scale):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_of_scale * scale)


def _binned(seed, n, grow=0.0):
    arrays = random_splat_arrays(np.random.default_rng(seed), n)
    arrays["log_scales"] += grow
    arrays["opacity_logits"] += grow
    prep = j_preprocess(JModel.from_arrays(arrays), orbit_camera(0.15, width=WIDTH, height=HEIGHT), JCFG)
    bins = jbin.bin_gaussians(prep, WIDTH, HEIGHT, JCFG.tile_size, JCFG.max_pairs, align=JCFG.pair_block)
    jax_args = (jbin.pack_features(prep), bins.pair_gaussian, bins.tile_start, bins.tile_count,
                jnp.arange(NTX * NTY, dtype=jnp.int32))
    return jax_args, tuple(t(a) for a in jax_args), bins.gaussian_counts


def _cotangents(color, trans):
    g_color = jax.random.normal(jax.random.key(0), color.shape, color.dtype)
    g_trans = jax.random.normal(jax.random.key(1), trans.shape, trans.dtype)
    return g_color, g_trans


@pytest.fixture(scope="module")
def binned():
    """The ``tests/test_pallas_kernels.py`` setup, with its forward outputs
    and random cotangents."""
    jax_args, args, counts = _binned(5, 150)
    color, trans = forward_tiles_jnp(*jax_args, NTX, JCFG)
    g_color, g_trans = _cotangents(color, trans)
    outs = (color, trans, g_color, g_trans)
    return jax_args, args, counts, outs, tuple(t(x) for x in outs)


@pytest.mark.parametrize("sorted_reduction", [False, True])
def test_plain_backward_matches_pallas(binned, sorted_reduction):
    jax_args, args, counts, outs, t_outs = binned
    want = backward_tiles_pallas(
        *jax_args, *outs, NTX, JCFG, gaussian_counts=counts if sorted_reduction else None, interpret=True
    )
    rows = backward_tiles_plain(*args, *t_outs, NTX, CFG)
    got = reduce_pair_grads(rows, args[1], t(counts) if sorted_reduction else None, args[0].shape[0])
    assert got.shape == (args[0].shape[0], B.NUM_FEATURES)
    assert not got[-1].any() and not got[:, 9:].any()  # sentinel row and padding columns
    close_to_scale(got[:-1, :9], np.asarray(want)[:-1, :9], 5e-4 if sorted_reduction else 5e-3, 1e-5)


def test_plain_backward_matches_jnp(binned):
    jax_args, args, counts, outs, t_outs = binned
    want = np.asarray(backward_tiles_jnp(*jax_args, *outs, NTX, JCFG))
    rows = backward_tiles_plain(*args, *t_outs, NTX, CFG)
    close_to_scale(reduce_pair_grads(rows, args[1], None, args[0].shape[0])[:-1], want[:-1], 1e-4, 1e-6)
    # The sorted reduction reorders f32 additions: about 1e-5 of the scale.
    got = reduce_pair_grads(rows, args[1], t(counts), args[0].shape[0])
    close_to_scale(got[:-1], want[:-1], 5e-4, 1e-5)


def test_backward_dispatch_on_cpu_is_the_plain_version(binned):
    _, args, _, _, t_outs = binned
    before = backward_tiles.launches
    want = backward_tiles_plain(*args, *t_outs, NTX, CFG)
    got = backward_tiles(*args, *t_outs, NTX, CFG)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert backward_tiles.launches == before  # the CPU path launches no kernel


def test_early_stop_walk_matches_pallas():
    """With early stop, the walk ends at the forward's ``blocks_done``: the
    rows past it stay zero, and the gradient equals the Pallas kernel's
    given the same ``blocks_done``."""
    jax_args, args, counts = _binned(6, 800, grow=2.0)
    jcfg = dataclasses.replace(JCFG, early_stop_transmittance=1e-4)
    cfg = dataclasses.replace(CFG, early_stop_transmittance=1e-4)
    color, trans, done = forward_tiles_pallas(*jax_args, NTX, jcfg, interpret=True, width=WIDTH, height=HEIGHT)
    p_color, p_trans, p_done = forward_tiles_plain(*args, NTX, cfg, WIDTH, HEIGHT)
    np.testing.assert_array_equal(p_done.numpy(), np.asarray(done))
    nblocks = -(-args[3] // CFG.pair_block)
    assert (p_done < nblocks).any(), "the scene should stop some tile early"
    g_color, g_trans = _cotangents(color, trans)
    want = backward_tiles_pallas(*jax_args, color, trans, g_color, g_trans, NTX, jcfg, blocks_done=done,
                                 gaussian_counts=counts, interpret=True)
    rows = backward_tiles_plain(*args, p_color, p_trans, t(g_color), t(g_trans), NTX, cfg, p_done)
    got = reduce_pair_grads(rows, args[1], t(counts), args[0].shape[0])
    close_to_scale(got[:-1, :9], np.asarray(want)[:-1, :9], 5e-4, 1e-5)
    # Every row past a tile's walked blocks is exactly zero.
    starts, counts_t = args[2].long(), args[3].long()
    for tile in range(len(starts)):
        walked = int(p_done[tile]) * CFG.pair_block
        tail = rows[starts[tile] + walked : starts[tile] + counts_t[tile]]
        assert not tail.any()
    full = backward_tiles_plain(*args, p_color, p_trans, t(g_color), t(g_trans), NTX, cfg)
    assert not torch.equal(full, rows)  # walking every block would differ


def _manual_binned(rows, tile_pairs, align):
    """Hand-built binned inputs: per-tile pair lists, aligned with sentinel
    padding (what ops.binning produces)."""
    n = rows.shape[0]
    feat = np.concatenate([rows, np.zeros((1, 16), np.float32)])
    pairs, starts, counts = [], [], []
    for ids in tile_pairs:
        starts.append(len(pairs))
        counts.append(len(ids))
        pairs.extend(ids)
        while len(pairs) % align:
            pairs.append(n)
    return feat, np.asarray(pairs, np.int32), np.asarray(starts, np.int32), np.asarray(counts, np.int32)


def test_zero_opacity_gradient_matches_jnp():
    """A gaussian whose activated opacity underflows to exactly 0 gets zero
    opacity gradient (the alpha > 1/255 gate zeroes d_alpha everywhere),
    mirroring ``tests/test_pallas_kernels.py``."""
    jcfg = JRasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=64)
    cfg = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=64)
    rows = np.zeros((2, 16), np.float32)
    rows[0] = [7.5, 7.5, 0.05, 0.05, 0.0, 0.8, 0.9, 0.2, 0.1, 0, 0, 16, 16, 0, 0, 0]
    rows[1] = rows[0]
    rows[1, 5] = 0.0
    feat, pg, ts_, tc = _manual_binned(rows, [[0, 1]], 8)
    ids = np.asarray([0], np.int32)
    jargs = tuple(jnp.asarray(a) for a in (feat, pg, ts_, tc, ids))
    color, trans = forward_tiles_jnp(*jargs, 1, jcfg)
    g_color, g_trans = jnp.ones_like(color), jnp.zeros_like(trans)
    want = np.asarray(backward_tiles_jnp(*jargs, color, trans, g_color, g_trans, 1, jcfg))
    args = tuple(t(a) for a in (feat, pg, ts_, tc, ids))
    p_color, p_trans, _ = forward_tiles_plain(*args, 1, cfg)
    got = reduce_pair_grads(
        backward_tiles_plain(*args, p_color, p_trans, t(g_color), t(g_trans), 1, cfg), args[1], None, 3
    ).numpy()
    assert got[1, B.FEAT_OPACITY] == 0.0
    assert abs(got[0, B.FEAT_OPACITY]) > 0.0
    close_to_scale(got[:-1], want[:-1], 1e-4, 1e-6)


def test_blocked_cumsum_matches_cumsum():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 2500)).astype(np.float32))
    torch.testing.assert_close(blocked_cumsum(x), torch.cumsum(x.double(), 1).float(), rtol=1e-5, atol=1e-4)
    assert blocked_cumsum(x[:, :0]).shape == (3, 0)


def _port(arrays, jcam):
    return tgs.GaussianModel.from_arrays(arrays, device="cpu"), tgs.CameraParams(**dataclasses.asdict(jcam))


def _grads_close(port_grads, jax_grads):
    for name, got in zip(NAMES, port_grads):
        want = np.asarray(getattr(jax_grads, name))
        close_to_scale(got.numpy(), want, 2e-3, 5e-5)


def test_render_grads_match_jax():
    """``torch.autograd.grad`` of ``sum(img*w_img) + sum(trans*w_trans)``
    through the port's ``render`` against ``jax.grad`` through JAX's."""
    arrays = random_splat_arrays(np.random.default_rng(11), 120)
    jcam = orbit_camera(0.25, width=32, height=32)
    rng = np.random.default_rng(21)
    w_img = rng.normal(size=(32, 32, 3)).astype(np.float32) * 0.1
    w_trans = rng.normal(size=(32, 32)).astype(np.float32) * 0.1
    jcfg = jgs.RasterConfig(**SMALL, use_pallas=False)

    def j_loss(m):
        img, trans = jgs.render(m, jcam, jcfg)
        return jnp.sum(img * w_img) + jnp.sum(trans * w_trans)

    j_value, j_grads = jax.value_and_grad(j_loss)(jgs.GaussianModel.from_arrays(arrays))
    model, cam = _port(arrays, jcam)
    img, trans = tgs.render(model, cam, tgs.RasterConfig(**SMALL))
    loss = torch.sum(img * t(w_img)) + torch.sum(trans * t(w_trans))
    assert float(loss.detach()) == pytest.approx(float(j_value), rel=1e-5)
    _grads_close(torch.autograd.grad(loss, [getattr(model, k) for k in NAMES]), j_grads)


def test_transmittance_cotangent_flows():
    """Gradient through the transmittance output alone is finite, nonzero
    and JAX's (the dT_final/d alpha term; the colour cotangent is zero)."""
    arrays = random_splat_arrays(np.random.default_rng(11), 120)
    jcam = orbit_camera(0.25, width=32, height=32)
    jcfg = jgs.RasterConfig(**SMALL, use_pallas=False)
    j_grads = jax.grad(lambda m: jnp.sum(jgs.render(m, jcam, jcfg)[1]))(jgs.GaussianModel.from_arrays(arrays))
    model, cam = _port(arrays, jcam)
    _, trans = tgs.render(model, cam, tgs.RasterConfig(**SMALL))
    grads = torch.autograd.grad(trans.sum(), [getattr(model, k) for k in NAMES])
    assert float(grads[3].abs().max()) > 0.0
    _grads_close(grads, j_grads)


@pytest.mark.parametrize("exact", [False, True])
def test_bench_step_matches_jax(exact, monkeypatch):
    """The bench step at 64x48: ``rgb_loss(render(...), 0.25, 0.2)`` and its
    gradients to all five parameters, with either reduction: the default
    sort-based one, or (``exact``) the exact segment sum that
    ``gaussian_counts=None`` selects."""
    reductions = []

    def reduce(rows, pairs, counts, n):
        reductions.append(exact)
        return reduce_pair_grads(rows, pairs, None if exact else counts, n)

    monkeypatch.setattr(traster, "reduce_pair_grads", reduce)
    arrays = random_splat_arrays(np.random.default_rng(7), 300)
    jcam = orbit_camera(0.2, width=64, height=48)
    target = np.full((48, 64, 3), 0.25, np.float32)
    jcfg = jgs.RasterConfig(**SMALL, use_pallas=False)
    j_value, j_grads = jax.value_and_grad(
        lambda m: j_rgb_loss(jgs.render(m, jcam, jcfg)[0], target, 0.2)
    )(jgs.GaussianModel.from_arrays(arrays))
    model, cam = _port(arrays, jcam)
    img, _ = tgs.render(model, cam, tgs.RasterConfig(**SMALL))
    loss = tgs.rgb_loss(img, t(target), 0.2)
    assert float(loss.detach()) == pytest.approx(float(j_value), rel=1e-5)
    _grads_close(torch.autograd.grad(loss, [getattr(model, k) for k in NAMES]), j_grads)
    assert reductions == [exact]
