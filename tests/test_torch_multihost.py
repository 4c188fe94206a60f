"""The port's scaling harness (``tools/multihost.py``) and
``ops/binning.py::coverage_histogram`` held against the JAX package on the
CPU.

* ``coverage_histogram`` integer-equal to JAX's on random rects (off the
  grid, empty, ``keep=False``), on 1x1, 7x5 and 34x60 grids;
* at tile factors 1, 2, 4 and 8 on a 64x48 frame at tile 8, the strided
  extraction of the global histogram equal three ways: the port's, JAX's
  (``gsplat_tpu/parallel/shard.py``'s pad, reshape and pick, from its own
  functions), and the port's per-shard ``bin_rects`` ``tile_count``;
* ``model_mode`` on a 300-splat model at 64x48: the record's keys, each
  point's pairs and capacity integer-equal to JAX's ``strided_tile_ranges``
  and ``bin_rects`` on the same arrays, times non-negative, efficiency 1
  at one device;
* ``launch_mode`` in a world of one equal to ``make_parallel_train_step``
  at 1x1 on the same inputs, and ``main`` printing one JSON line in model
  and launch modes on the CPU;
* ``virtual_mode`` on one and two spawned gloo ranks (the fixture model at
  64x48, which keeps the spawned worlds to a few seconds; they start with
  the file's first test and run beside the others);
* the harness imports neither JAX nor the JAX package.
"""

import ast
import contextlib
import dataclasses
import io
import json
import math
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import RasterConfig as JRasterConfig
from gsplat_tpu.models.gaussians import GaussianModel as JGaussianModel
from gsplat_tpu.ops import binning as jbinning
from gsplat_tpu.ops.camera import CameraArrays as JCameraArrays
from gsplat_tpu.parallel import shard as jshard
from gsplat_tpu.render.pipeline import preprocess_traced as j_preprocess_traced

import gsplat_tpu_torch as tgs
import torch.distributed as dist
from gsplat_tpu_torch.ops import binning as tbinning
from gsplat_tpu_torch.parallel import initialize_distributed, make_mesh, make_parallel_train_step
from gsplat_tpu_torch.render.pipeline import preprocess_traced as t_preprocess_traced

from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)  # the spawned ranks of virtual mode import the harness by name too
import multihost  # noqa: E402

W, H = 64, 48
TILE = 8
ARRAYS = random_splat_arrays(np.random.default_rng(21), 300)
CAMERA = orbit_camera(0.3, width=W, height=H)
CFG = dict(tile_size=TILE, chunk_size=8, pair_block=8, early_stop_transmittance=1e-4)
TCFG = tgs.RasterConfig(**CFG)
JCFG = JRasterConfig(**CFG, use_pallas=False)
STEP_CFG = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 13)  # the steps' tiling
STAGES = ("replicated_prologue_sec", "shard_prep_sec", "shard_histogram_sec", "shard_bin_sec", "shard_fwd_sec",
          "shard_bwd_sec", "proj_step_sec")
POINT_KEYS = {"devices", "mesh", "local_pairs", "local_capacity", "serial_fraction", "proj_pixels_per_sec",
              "proj_efficiency_vs_1", *STAGES}


def _tcamera():
    return tgs.CameraParams(**dataclasses.asdict(CAMERA))


def _tmodel():
    return tgs.GaussianModel.from_arrays(ARRAYS, device="cpu")


@pytest.fixture(scope="module")
def preps():
    """Both packages' preprocess of ``ARRAYS`` through ``CAMERA``."""
    jprep = jax.jit(j_preprocess_traced, static_argnums=(2, 3, 4))(
        JGaussianModel.from_arrays(ARRAYS), JCameraArrays.from_params(CAMERA), W, H, JCFG)
    tcam = tgs.CameraArrays.from_params(_tcamera(), device="cpu")
    with torch.no_grad():
        tprep = t_preprocess_traced(_tmodel(), tcam, W, H, TCFG)
    return jprep, tprep


@pytest.fixture(scope="module", autouse=True)
def virtual_worlds(request):
    """``virtual_mode`` on one and two spawned ranks, started in a thread
    before the file's first test so that the ranks' start-up (a fresh
    interpreter each) overlaps the JAX side of the other tests;
    :func:`test_virtual_mode_is_mesh_invariant` reads its result. Started
    only when that test is selected."""
    result = {}
    if not any(item.originalname == "test_virtual_mode_is_mesh_invariant" for item in request.session.items):
        yield None, result
        return

    def run():
        try:
            result["out"] = multihost.virtual_mode(_tmodel(), _tcamera(), STEP_CFG, (1, 2))
        except Exception as exc:  # re-raised by the test that reads it
            result["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield thread, result
    thread.join(multihost.VIRTUAL_TIMEOUT_S + 30)


@pytest.mark.parametrize("n_tiles_y,n_tiles_x", [(1, 1), (7, 5), (34, 60)], ids=["1x1", "7x5", "34x60"])
def test_coverage_histogram_matches_jax(n_tiles_y, n_tiles_x):
    """Counts equal as integers, beyond 256 too (where a bf16 product would
    round), from rects of bboxes off the grid on every side and empty, and
    rows with ``keep`` False."""
    rng = np.random.default_rng(n_tiles_x * 100 + n_tiles_y)
    n = 4000
    x0 = rng.integers(-40, n_tiles_x * 16 + 40, n)
    y0 = rng.integers(-40, n_tiles_y * 16 + 40, n)
    bbox = np.stack([x0, y0, x0 + rng.integers(-5, n_tiles_x * 16, n), y0 + rng.integers(-5, n_tiles_y * 16, n)],
                    1).astype(np.int32)
    keep = rng.uniform(size=n) < 0.8
    j_rects = jbinning.tile_ranges(jnp.asarray(bbox), 16, n_tiles_x, n_tiles_y)
    t_rects = tbinning.tile_ranges(torch.from_numpy(bbox), 16, n_tiles_x, n_tiles_y)
    assert int((t_rects[2] == 0).sum()) > 0 and not keep.all()
    want = np.asarray(jbinning.coverage_histogram(j_rects, jnp.asarray(keep), n_tiles_x, n_tiles_y))
    got = tbinning.coverage_histogram(t_rects, torch.from_numpy(keep), n_tiles_x, n_tiles_y)
    assert got.dtype == torch.float32 and got.shape == (n_tiles_y, n_tiles_x)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 256


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_strided_histogram_extraction_three_ways(preps, tp):
    jprep, tprep = preps
    lay = jshard._make_layout(W, H, TILE, tp)
    g_rects = jbinning.tile_ranges(jprep.cull_bbox, TILE, lay.ntx_g, lay.nty_g)
    keep = jprep.active & (g_rects[2] > 0) & (g_rects[3] > 0)
    c2 = jnp.pad(jbinning.coverage_histogram(g_rects, keep, lay.ntx_g, lay.nty_g),
                 ((0, lay.sy * lay.nty_l - lay.nty_g), (0, lay.sx * lay.ntx_l - lay.ntx_g)))
    setup = multihost.shard_setup(tprep, W, H, TCFG, tp)
    counts2d = multihost.global_histogram(tprep, TILE, setup.lay)
    for oy in range(lay.sy):
        for ox in range(lay.sx):
            want = np.asarray(c2.reshape(lay.nty_l, lay.sy, lay.ntx_l, lay.sx)[:, oy, :, ox].reshape(-1)
                              .astype(jnp.int32))
            got = multihost.strided_counts(counts2d, setup.lay, ox, oy)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"offset {ox}, {oy}")
            rects = tbinning.strided_tile_ranges(tprep.cull_bbox, TILE, lay.ntx_g, lay.nty_g, lay.sx, lay.sy, ox, oy)
            bins = tbinning.bin_rects(tprep.depth, tprep.active, rects, lay.ntx_l, lay.nty_l, setup.capacity,
                                      align=TCFG.pair_block)
            np.testing.assert_array_equal(bins.tile_count.numpy(), want, err_msg=f"bins at offset {ox}, {oy}")
    np.testing.assert_array_equal(setup.histogram_tile_count.numpy(), setup.bins.tile_count.numpy())
    assert int(setup.bins.tile_count.sum()) > 0


def test_model_mode_matches_jax(preps):
    out = multihost.model_mode(_tmodel(), _tcamera(), TCFG, (1, 2, 4, 8), steps=2)
    assert {"mode", "width", "height", "gaussians", "device", "points", "wall_step_sec", "local_count_sec",
            "grad_allreduce_bytes", "assumed_link_bytes_per_sec", "data_parallel_efficiency_model", "note"} == set(out)
    assert set(out["wall_step_sec"]) == {"1", "2", "4", "8"} and min(out["wall_step_sec"].values()) > 0
    assert set(out["local_count_sec"]) == {"1", "2", "4", "8"} and min(out["local_count_sec"].values()) > 0
    assert (out["mode"], out["width"], out["height"], out["gaussians"], out["device"]) == ("model", W, H, 300, "cpu")
    assert out["grad_allreduce_bytes"] == 300 * (3 + 3 + 4 + 1 + 48) * 4
    assert "all_gather_rows" in out["note"] and "all_reduce_sum" in out["note"]
    jprep = preps[0]
    lays = [jshard._make_layout(W, H, TILE, tp) for tp in (1, 2, 4, 8)]

    def shard_rects(cull_bbox, lay):
        return jbinning.strided_tile_ranges(cull_bbox, TILE, lay.ntx_g, lay.nty_g, lay.sx, lay.sy, 0, 0)

    @jax.jit
    def demands(active, cull_bbox):
        return [jnp.sum(jnp.where(active, r[2] * r[3], 0)) for r in (shard_rects(cull_bbox, lay) for lay in lays)]

    capacities = [max(int(int(d) * 1.5) // 128 * 128, 1 << 16) for d in demands(jprep.active, jprep.cull_bbox)]

    @jax.jit
    def num_pairs(depth, active, cull_bbox):
        return [jbinning.bin_rects(depth, active, shard_rects(cull_bbox, lay), lay.ntx_l, lay.nty_l, cap,
                                   align=JCFG.pair_block).num_pairs for lay, cap in zip(lays, capacities)]

    pairs = [int(x) for x in num_pairs(jprep.depth, jprep.active, jprep.cull_bbox)]
    assert [p["devices"] for p in out["points"]] == [1, 2, 4, 8]
    for p, want_pairs, capacity in zip(out["points"], pairs, capacities):
        tp = p["devices"]
        assert set(p) == POINT_KEYS
        assert p["mesh"] == {"data": 1, "tile": tp}
        assert (p["local_pairs"], p["local_capacity"]) == (want_pairs, capacity)
        assert p["local_pairs"] > 0
        for key in STAGES:
            assert math.isfinite(p[key]) and p[key] >= 0.0, (tp, key, p[key])
        step = sum(p[k] for k in STAGES if k not in ("shard_histogram_sec", "proj_step_sec"))
        assert math.isclose(p["proj_step_sec"], step, rel_tol=1e-9)
        assert math.isclose(p["serial_fraction"], p["replicated_prologue_sec"] / p["proj_step_sec"], rel_tol=1e-9)
    assert out["points"][0]["proj_efficiency_vs_1"] == 1.0


def test_launch_mode_world_of_one_matches_the_step():
    initialize_distributed(device="cpu")
    try:
        model, steps = _tmodel(), 1
        out = multihost.launch_mode(model, _tcamera(), STEP_CFG, steps=steps)
        step, init_state, prepare_targets = make_parallel_train_step(
            make_mesh(tgs.MeshConfig(1, 1)), W, H, STEP_CFG, tgs.TrainConfig(ssim_weight=0.2))
        ref = _tmodel()
        optimizer = init_state(ref)
        cams = tgs.CameraArrays.stack([tgs.CameraArrays.from_params(_tcamera(), device="cpu")])
        targets = prepare_targets(torch.full((1, H, W, 3), 0.25))
        for _ in range(1 + steps):
            metrics = step(ref, optimizer, cams, targets)[2]
    finally:
        dist.destroy_process_group()
    assert (out["mode"], out["devices"], out["mesh"], out["hosts"]) == ("launch", 1, {"data": 1, "tile": 1}, 1)
    assert math.isfinite(out["loss"]) and out["loss"] == float(metrics["loss"])
    assert out["sec_per_step"] > 0 and out["frames_per_sec"] == 1 / out["sec_per_step"]
    assert torch.equal(model.means, ref.means)


@pytest.mark.parametrize("mode", ["model", "launch"])
def test_main_prints_one_json_line(mode):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert multihost.main(["--mode", mode, "--device", "cpu", "--gaussians", "300", "--width", "64",
                               "--height", "48", "--devices", "1,2", "--steps", "1"]) == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["mode"] == mode and out["device"] == "cpu"
    if mode == "model":
        assert [p["devices"] for p in out["points"]] == [1, 2]
    else:
        assert math.isfinite(out["loss"]) and out["devices"] == 1
    assert not dist.is_initialized()


def test_virtual_mode_is_mesh_invariant(virtual_worlds):
    thread, result = virtual_worlds
    thread.join(multihost.VIRTUAL_TIMEOUT_S + 30)
    assert not thread.is_alive()
    if "error" in result:
        raise result["error"]
    out = result["out"]
    assert [p["devices"] for p in out["points"]] == [1, 2]
    for p in out["points"]:
        assert p["ok"] and p["max_param_drift_vs_1dev"] < 1e-4 and math.isfinite(p["loss"])


def test_harness_imports_no_jax():
    with open(os.path.join(TOOLS, "multihost.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names]
    names += [node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module]
    assert "torch" in names and "gsplat_tpu_torch" in names
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "gsplat_tpu"), name
