"""The port's mesh path (``gsplat_tpu_torch/parallel``) held against the
JAX package's on the CPU: layout, binning and rendering.

The JAX side runs on the 8-virtual-device CPU mesh that ``conftest.py``
forces, through the jnp path; the port's ranks are spawned over gloo
(``torch_mesh_worker.py``, which imports no JAX), one world per world size,
each running all of its cases at once. Setup as ``tests/test_parallel.py``:
64x48, tile 16, pair block 8, a 200-splat fixture.

* ``_factor_stride``, ``_make_layout`` and ``strided_tile_ranges`` equal
  as integers; a shard's ``bin_rects`` from its own counts integer-equal to
  JAX's with the row-summed histogram as its override, under overflow too;
* the sharded render at tile factors 2 and 4 (4 has shard padding tiles)
  and the batch render at 2x2 at rtol 1e-5 / atol 1e-6, the same frame on
  every rank, and the data axis alone bitwise the single-device render;
* the per-shard binning stats of a hot shard equal as integers;
* a rank that raises fails its world at once.
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import MeshConfig as JMeshConfig
from gsplat_tpu import RasterConfig as JRasterConfig
from gsplat_tpu import render as jrender
from gsplat_tpu.models.gaussians import GaussianModel as JGaussianModel
from gsplat_tpu.ops import binning as jbinning
from gsplat_tpu.ops.camera import CameraArrays as JCameraArrays
from gsplat_tpu.parallel import shard as jshard
from gsplat_tpu.parallel.mesh import make_mesh as j_make_mesh
from gsplat_tpu.render.pipeline import binning_stats as j_binning_stats

from gsplat_tpu_torch.ops import binning as tbinning
from gsplat_tpu_torch.parallel import shard as tshard

import torch_mesh_worker as worker
from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

JCFG = JRasterConfig(**worker.SMALL, use_pallas=False)
W, H = worker.W, worker.H


ARRAYS = random_splat_arrays(np.random.default_rng(9), 200)
CAMERAS = [orbit_camera(0.1 * i, width=W, height=H) for i in range(4)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return worker.spawn_world(worker.render_world, 2, tmp_path_factory.mktemp("world2"), ARRAYS,
                              [dataclasses.asdict(c) for c in CAMERAS[:2]], worker.hot_arrays(), [(1, 2), (2, 1)])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return worker.spawn_world(worker.render_world, 4, tmp_path_factory.mktemp("world4"), ARRAYS,
                              [dataclasses.asdict(c) for c in CAMERAS], worker.hot_arrays(), [(1, 4), (2, 2), (4, 1)])


def _world(request, tp):
    return request.getfixturevalue("world2" if tp == 2 else "world4")


@pytest.mark.parametrize("width,height,tile,tp", [
    (64, 48, 16, 1), (64, 48, 16, 2), (64, 48, 16, 4), (64, 48, 16, 8), (200, 150, 16, 4),
    (1920, 1080, 32, 4), (1920, 1080, 32, 6),
])
def test_layout_matches_jax(width, height, tile, tp):
    assert tshard._factor_stride(tp) == jshard._factor_stride(tp)
    got, want = tshard._make_layout(width, height, tile, tp), jshard._make_layout(width, height, tile, tp)
    for field in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, field.name), getattr(want, field.name), err_msg=field.name)
    assert got.tiles_local == want.tiles_local


def _rects_inputs(seed=0, n=500):
    """Pixel bboxes off the frame on every side, empty and frame-wide."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.integers(-40, 120, n), rng.integers(-40, 90, n)
    return np.stack([x0, y0, x0 + rng.integers(-5, 60, n), y0 + rng.integers(-5, 60, n)], 1).astype(np.int32)


@pytest.mark.parametrize("sx,sy", [(1, 1), (2, 1), (2, 2), (3, 2), (4, 2)])
def test_strided_tile_ranges_match_jax(sx, sy):
    bbox = _rects_inputs()
    for ox in range(sx):
        for oy in range(sy):
            want = jbinning.strided_tile_ranges(jnp.asarray(bbox), 16, 7, 5, sx, sy, ox, oy)
            got = tbinning.strided_tile_ranges(torch.from_numpy(bbox), 16, 7, 5, sx, sy, ox, oy)
            for g, w in zip(got, want):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"offset {ox}, {oy}")


@pytest.mark.parametrize("max_pairs", [4096, 40])
@pytest.mark.parametrize("sx,sy", [(1, 1), (2, 1), (2, 2)])
def test_shard_bins_match_jax_histogram_path(sx, sy, max_pairs):
    """A tile shard's bins from its own counts equal, as integers, JAX's bins
    with the row-summed coverage histogram as ``tile_count_override`` (the
    path of ``gsplat_tpu/parallel/shard.py``), at every offset and under
    overflow too (40 pairs overflow)."""
    bbox = _rects_inputs(seed=3, n=300)
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 9.0, len(bbox)).astype(np.float32)
    active = rng.uniform(size=len(bbox)) < 0.8
    ntx, nty = 7, 5
    ntx_l, nty_l = -(-ntx // sx), -(-nty // sy)
    g_rects = jbinning.tile_ranges(jnp.asarray(bbox), 16, ntx, nty)
    keep = jnp.asarray(active) & (g_rects[2] > 0) & (g_rects[3] > 0)
    counts = jnp.pad(jbinning.coverage_histogram(g_rects, keep, ntx, nty),
                     ((0, sy * nty_l - nty), (0, sx * ntx_l - ntx)))
    overflowed = False
    for ox in range(sx):
        for oy in range(sy):
            override = counts.reshape(nty_l, sy, ntx_l, sx)[:, oy, :, ox].reshape(-1).astype(jnp.int32)
            j_rects = jbinning.strided_tile_ranges(jnp.asarray(bbox), 16, ntx, nty, sx, sy, ox, oy)
            want = jbinning.bin_rects(jnp.asarray(depth), jnp.asarray(active), j_rects, ntx_l, nty_l, max_pairs,
                                      align=8, tile_count_override=override)
            t_rects = tbinning.strided_tile_ranges(torch.from_numpy(bbox), 16, ntx, nty, sx, sy, ox, oy)
            got = tbinning.bin_rects(torch.from_numpy(depth), torch.from_numpy(active), t_rects, ntx_l, nty_l,
                                     max_pairs, align=8)
            overflowed |= int(want.pair_demand) > max_pairs
            for name in want._fields:
                np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                              err_msg=f"{name} at offset {ox}, {oy}")
    assert overflowed == (max_pairs == 40)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_render_matches_jax(request, tp):
    results = _world(request, tp)
    mesh = j_make_mesh(JMeshConfig(data=1, tile=tp))
    want, _ = jshard.make_sharded_render(mesh, W, H, JCFG)(JGaussianModel.from_arrays(ARRAYS),
                                                           JCameraArrays.from_params(CAMERAS[0]))
    got = results[0][f"sharded_1x{tp}"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    for other in results[1:]:  # the whole frame on every rank
        np.testing.assert_array_equal(other[f"sharded_1x{tp}"], got)


def test_batch_render_matches_jax(world4):
    mesh = j_make_mesh(JMeshConfig(data=2, tile=2))
    want, _ = jshard.make_batch_render(mesh, W, H, JCFG)(
        JGaussianModel.from_arrays(ARRAYS), JCameraArrays.stack([JCameraArrays.from_params(c) for c in CAMERAS]))
    got = world4[0]["batch_2x2"]
    assert got.shape == (4, H, W, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    for other in world4[1:]:
        np.testing.assert_array_equal(other["batch_2x2"], got)


@pytest.mark.parametrize("mesh", ["2x1", "4x1"])
def test_data_axis_render_is_bitwise_single_device(request, mesh):
    """Without tile sharding each rank renders whole frames exactly as one
    device does (the frames only travel)."""
    for rank in _world(request, int(mesh[0])):
        assert rank[f"batch_bitwise_{mesh}"]


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_binning_stats_match_jax(request, tp):
    """The hot shard's demand, a max over the mesh, far above the whole
    frame's demand over the tile factor."""
    mesh = j_make_mesh(JMeshConfig(data=1, tile=tp))
    hot = JGaussianModel.from_arrays(worker.hot_arrays())
    cam = JCameraArrays.from_params(CAMERAS[0])
    want = jshard.make_sharded_binning_stats(mesh, W, H, JCFG)(hot, cam)
    whole = int(j_binning_stats(hot, cam, W, H, JCFG)["pair_demand"])
    for rank in _world(request, tp):
        got = rank[f"stats_1x{tp}"]
        assert got == {"max_shard_demand": int(want["max_shard_demand"]),
                       "max_shard_pairs": int(want["max_shard_pairs"]), "capacity": JCFG.max_pairs,
                       "overflowed": 0}
    if tp == 4:
        assert got["max_shard_demand"] == 2 * (whole // tp)  # two of the four shards hold every pair


def test_single_device_render_is_jax_render():
    """The reference of the data-axis bitwise check agrees with JAX's."""
    import gsplat_tpu_torch as tgs

    with torch.inference_mode():
        got = tgs.render(tgs.GaussianModel.from_arrays(ARRAYS, device="cpu"),
                         tgs.CameraParams(**dataclasses.asdict(CAMERAS[0])), tgs.RasterConfig(**worker.SMALL))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(jrender(JGaussianModel.from_arrays(ARRAYS), CAMERAS[0], JCFG)[0]),
                               rtol=1e-5, atol=1e-6)


def test_mesh_needs_the_world_size(world2):
    assert world2[0]["wrong_size"] == "mesh MeshConfig(data=1, tile=1) needs 1 devices, have 2"


def test_failed_rank_fails_the_world(tmp_path):
    """A rank that raises stops its world at once: the others, waiting in a
    collective, are ended instead of waiting out the collective timeout."""
    t0 = time.monotonic()
    # The first rank to exit reports: the one that raised, or its peer whose
    # connection it closed.
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="rank failed on purpose|closed by peer"):
        worker.spawn_world(worker.failing_world, 2, tmp_path, 1, timeout=120.0)
    assert time.monotonic() - t0 < worker.COLLECTIVE_TIMEOUT.total_seconds()
