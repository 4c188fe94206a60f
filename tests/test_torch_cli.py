"""The port's command line held against the JAX CLI on the CPU.

Both CLIs run on one synthetic 64x48 scene (``tests/test_cli.py``'s:
``fixtures.write_synthetic_scene``, rng 21, 120 gaussians, tile 16, chunk 8,
max pairs 8192), the JAX one with ``--backend jnp`` and the port's with
``--device cpu``:

* ``render`` and ``orbit``: every written PNG within 1 LSB per pixel;
* ``evaluate`` (one camera, two cameras, ``--test-every 2``): the same view
  names, PSNR within 1e-3 dB and SSIM within 1e-5;
* ``train --steps 3 --no-densify`` from the SfM points and warm-started:
  the exported PLY arrays within rtol 2e-3 plus atol 5e-5 of each array's
  largest magnitude;
* ``progressive_frames``: each frame within rtol 1e-5 / atol 1e-6.

Port only: a resumed ``finetune`` exports the uninterrupted run's PLY
bitwise, the MJPEG AVI fallback, the ``--auto-pairs`` message, the usage
errors, ``log_metrics``' text, the profiling helpers, and what importing the
package loads.
"""

import dataclasses
import json
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from gsplat_tpu.cli import cli as jcli

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.cli import cli

from fixtures import make_camera, write_synthetic_scene
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO_NAME = "video_render.mp4" if shutil.which("ffmpeg") else "video_render.avi"


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    write_synthetic_scene(str(root), np.random.default_rng(21), n_gaussians=120, width=64, height=48, scale_factor=1)
    return str(root)


@pytest.fixture(scope="module")
def two_camera_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene2cam")
    write_synthetic_scene(str(root), np.random.default_rng(7), n_gaussians=120, width=64, height=48, scale_factor=1,
                          two_cameras=True)
    return str(root)


def _args(scene_dir, out, port: bool, model=True):
    args = [
        "--input_dir", scene_dir,
        "--scale-factor", "1",
        "--scene-index", "1",
        "--tile-size", "16",
        "--chunk-size", "8",
        "--max-pairs", str(1 << 13),
        *(["--device", "cpu"] if port else ["--backend", "jnp"]),
        "--output_path", out,
    ]
    if model:
        args += ["--trained_model_path", os.path.join(scene_dir, "model")]
    return args


def _invoke(command, args, port=True):
    result = CliRunner().invoke(cli if port else jcli, [command, *args])
    assert result.exit_code == 0, result.output + repr(result.exception)
    return result


def _run_both(command, scene_dir, tmp_path, *extra, model=True):
    """Run ``command`` through both CLIs; returns (JAX output dir, port's)."""
    outs = []
    for port in (False, True):
        out = str(tmp_path / ("port" if port else "jax"))
        _invoke(command, [*_args(scene_dir, out, port, model), *extra], port)
        outs.append(out)
    return outs


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.int16)


def test_render_matches_jax(scene_dir, tmp_path):
    j_out, out = _run_both("render", scene_dir, tmp_path, "--no-show")
    assert np.abs(_png(os.path.join(out, "render.png")) - _png(os.path.join(j_out, "render.png"))).max() <= 1
    assert os.path.exists(os.path.join(out, "comparison.png"))


def test_orbit_matches_jax(scene_dir, tmp_path):
    j_out, out = _run_both("orbit", scene_dir, tmp_path, "--num-frames", "4")
    frames = sorted(os.listdir(os.path.join(out, "images")))
    assert frames == sorted(os.listdir(os.path.join(j_out, "images"))) and len(frames) == 4 + 40
    for name in frames:
        got, want = (_png(os.path.join(d, "images", name)) for d in (out, j_out))
        assert np.abs(got - want).max() <= 1, name
    assert os.path.exists(os.path.join(out, VIDEO_NAME))


@pytest.mark.parametrize("case", ["one_camera", "two_cameras", "test_every"])
def test_evaluate_matches_jax(scene_dir, two_camera_dir, tmp_path, case):
    root = two_camera_dir if case == "two_cameras" else scene_dir
    extra = ["--test-every", "2"] if case == "test_every" else []
    j_out, out = _run_both("evaluate", root, tmp_path, *extra)
    got, want = (json.load(open(os.path.join(d, "metrics.json"))) for d in (out, j_out))
    assert [v["view"] for v in got["views"]] == [v["view"] for v in want["views"]]
    assert len(got["views"]) == (1 if case == "test_every" else 2)
    for a, b in zip(got["views"], want["views"]):
        assert abs(a["psnr"] - b["psnr"]) < 1e-3, (a, b)
        assert abs(a["ssim"] - b["ssim"]) < 1e-5, (a, b)
    if case == "two_cameras":  # each view renders with its own camera_id's intrinsics
        from gsplat_tpu_torch.cli import _load_views

        views = _load_views(root, 1, "cpu")
        assert views[1][0].focal_x / views[0][0].focal_x == pytest.approx(1.5, rel=1e-6)


@pytest.mark.parametrize("init", ["points3d", "warm_start", "warm_start_schedule"])
def test_train_matches_jax(scene_dir, tmp_path, init):
    """``warm_start_schedule`` also takes the white background, the position
    lr decay and its scaling by the scene extent."""
    from gsplat_tpu_torch.io.ply import load_splat_arrays
    from gsplat_tpu_torch.io.scene import checkpoint_ply_path

    extra = ["--background", "white", "--lr-decay-steps", "3", "--lr-means-final", "1.6e-6", "--lr-scale-extent"]
    j_out, out = _run_both("train", scene_dir, tmp_path, "--steps", "3", "--no-densify",
                           *(extra if init == "warm_start_schedule" else []), model=(init != "points3d"))
    got, want = (load_splat_arrays(checkpoint_ply_path(d)) for d in (out, j_out))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-3, atol=5e-5 * np.abs(w).max(), err_msg=k)


def test_progressive_frames_match_jax(scene_dir):
    from gsplat_tpu import RasterConfig as JRasterConfig
    from gsplat_tpu.io.ply import load_splat_arrays
    from gsplat_tpu.io.scene import checkpoint_ply_path
    from gsplat_tpu.models.gaussians import GaussianModel as JGaussianModel
    from gsplat_tpu.utils.video import progressive_frames as j_progressive_frames

    from gsplat_tpu_torch.utils.video import progressive_frames

    small = dict(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 13)
    arrays = load_splat_arrays(checkpoint_ply_path(os.path.join(scene_dir, "model")))
    jcam = make_camera(64, 48)
    want = j_progressive_frames(JGaussianModel.from_arrays(arrays), jcam, JRasterConfig(**small, use_pallas=False),
                                num_frames=5)
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    camera = tgs.CameraParams(**dataclasses.asdict(jcam))
    cfg = tgs.RasterConfig(**small)
    frames = progressive_frames(model, camera, cfg, num_frames=5)
    assert len(frames) == len(want) == 5  # 120 gaussians in slabs of 24
    for got, w in zip(frames, want):
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
    with torch.inference_mode():
        full = tgs.render(model, camera, cfg)[0].numpy()
    np.testing.assert_allclose(frames[-1], full, rtol=1e-5, atol=1e-6)


def test_finetune_resume_is_bitwise(scene_dir, tmp_path):
    """``finetune --steps 2`` then ``--steps 4 --resume`` exports the PLY of
    an uninterrupted 4-step run, byte for byte."""
    from gsplat_tpu_torch.io.scene import checkpoint_ply_path

    outs = [str(tmp_path / name) for name in ("whole", "split")]
    _invoke("finetune", [*_args(scene_dir, outs[0], True), "--steps", "4", "--checkpoint-every", "2"])
    _invoke("finetune", [*_args(scene_dir, outs[1], True), "--steps", "2"])
    assert os.path.isfile(os.path.join(outs[1], "train_state.pt"))
    _invoke("finetune", [*_args(scene_dir, outs[1], True), "--steps", "4", "--resume"])
    whole, split = (open(checkpoint_ply_path(d, 30001), "rb").read() for d in outs)
    assert whole == split


def test_mjpeg_avi_structure(tmp_path):
    """The no-ffmpeg fallback writes a structurally valid RIFF AVI."""
    import struct

    from gsplat_tpu_torch.utils import video as videolib

    out = str(tmp_path / "avi")
    paths = videolib.write_frames(out, [np.full((32, 48, 3), v, np.float32) for v in (0.2, 0.5, 0.8)])
    tail = {open(p, "rb").read() for p in paths[2:]}
    assert len(paths) == 43 and len(tail) == 1 and (_png(paths[-1]) == 204).all()  # the freeze tail: the last frame
    data = open(videolib.encode_mjpeg_avi(out), "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    assert b"movi" in data and b"MJPG" in data and b"idx1" in data
    assert data.count(b"00dc") == 2 * (3 + 40)  # a chunk and an index entry per frame, the tail included


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _captured(name, fn):
    logger = logging.getLogger(name)
    handler = _Capture()
    logger.addHandler(handler)
    try:
        fn()
    finally:
        logger.removeHandler(handler)
    return handler.lines


def test_orbit_auto_pairs_resizes(scene_dir, tmp_path):
    """--auto-pairs budget-checks the whole orbit trajectory: with a tiny
    max_pairs the run warns on the ``gsplat_tpu_torch`` logger and resizes."""
    out = str(tmp_path / "orbit_ap")
    args = _args(scene_dir, out, True)
    args[args.index("--max-pairs") + 1] = "32"  # far below the demand
    lines = _captured("gsplat_tpu_torch", lambda: _invoke("orbit", [*args, "--num-frames", "3", "--auto-pairs"]))
    assert any("overflow" in r and "using max_pairs" in r for r in lines), lines
    assert os.path.exists(os.path.join(out, VIDEO_NAME))


@pytest.mark.parametrize("tile", [12, 64, 100])
def test_evaluate_at_any_tile_size(scene_dir, tmp_path, tile):
    """Every pixel composites the same gaussians in the same order whatever
    the tiling (early stop off), so ``evaluate`` at tiles 12, 64 and 100
    writes tile 32's ``metrics.json``."""
    outs = []
    for ts in (32, tile):
        out = str(tmp_path / f"tile{ts}")
        args = _args(scene_dir, out, True)
        args[args.index("--tile-size") + 1] = str(ts)
        _invoke("evaluate", args)
        outs.append(json.load(open(os.path.join(out, "metrics.json"))))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("case", ["mesh", "test_every_1", "resume_without_output", "tile_0_cuda", "slice_pairs",
                                  "mesh_cuda_cards", "mesh_without_torchrun", "render_mesh_data_axis"])
def test_usage_errors(scene_dir, tmp_path, case):
    out = str(tmp_path / "out")
    args = _args(scene_dir, out, True)
    command, extra, message = {
        "mesh": ("evaluate", ["--mesh", "2x2", "--slice-pairs", "1024"], "--slice-pairs cannot be combined with --mesh"),
        "mesh_cuda_cards": ("evaluate", ["--mesh", "2x2", "--device", "cuda"], "needs 4 cards, one per rank"),
        "mesh_without_torchrun": ("finetune", ["--mesh", "2x1", "--steps", "1"], "launch with torchrun --nproc-per-node 2"),
        "render_mesh_data_axis": ("render", ["--no-show", "--mesh", "2x1"], "render is a single view"),
        "test_every_1": ("train", ["--steps", "2", "--no-densify", "--test-every", "1"], "holds out every view"),
        "resume_without_output": ("finetune", ["--steps", "2", "--resume"], "--resume requires --output_path"),
        "tile_0_cuda": ("render", ["--no-show", "--tile-size", "0", "--device", "cuda"], "tile_size 0"),
        "slice_pairs": ("evaluate", ["--slice-pairs", "100"], "multiple of pair_block"),
    }[case]
    if case == "resume_without_output":
        args = args[: args.index("--output_path")] + args[args.index("--output_path") + 2:]
    result = CliRunner().invoke(cli, [command, *args, *extra])
    assert result.exit_code == 2, result.output + repr(result.exception)
    assert message in result.output
    assert not os.path.exists(os.path.join(out, "point_cloud")) and not os.path.exists(os.path.join(out, "render.png"))


@pytest.mark.parametrize("tile", [65, 128, 256])
def test_tile_above_64_taken_for_cuda(tile):
    """On the card ``--tile-size`` takes every positive edge: the settings
    check passes tiles above 64 (pixel groups) as the JAX CLI does."""
    from gsplat_tpu_torch.cli import _raster_config

    assert _raster_config(tile, 32, 1 << 22, 1e-4, "cuda").tile_size == tile


def test_cuda_without_card_fails(scene_dir, tmp_path):
    """``--device cuda`` (the default) without a card stops with the
    device error; nothing runs on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "out")
    args = _args(scene_dir, out, True)
    args = args[: args.index("--device")] + args[args.index("--device") + 2:]
    result = CliRunner().invoke(cli, ["evaluate", *args])
    assert result.exit_code == 1 and "no CUDA device is available" in result.output, result.output
    assert not os.path.exists(os.path.join(out, "metrics.json"))


def test_log_metrics_matches_jax():
    from gsplat_tpu.utils.logging import get_logger as j_get_logger
    from gsplat_tpu.utils.logging import log_metrics as j_log_metrics

    from gsplat_tpu_torch.utils.logging import get_logger, log_metrics

    metrics = {"psnr": 23.456789, "loss": np.float32(0.0123456789), "step": 7, "a": torch.tensor(1e-7)}
    j_logger, logger = j_get_logger(), get_logger()
    want = _captured(j_logger.name, lambda: j_log_metrics(j_logger, 7, metrics))
    got = _captured(logger.name, lambda: log_metrics(logger, 7, metrics))
    assert got == want == ["step=7 a=1e-07 loss=0.012346 psnr=23.457 step=7"]


def test_profiling_on_cpu(tmp_path):
    from gsplat_tpu_torch.utils import profiling

    calls = []

    def fn(x):
        calls.append(1)
        return {"out": (x * 2, [x])}

    x = torch.ones(8)
    mean_s, result = profiling.timed(fn, x, warmup=1, iters=3)
    assert mean_s >= 0.0 and torch.equal(result["out"][0], x * 2) and len(calls) == 4
    stats = profiling.benchmark_stats(fn, x, warmup=0, iters=5)
    assert set(stats) == {"mean_s", "min_s", "max_s", "p50_s"}
    assert stats["min_s"] <= stats["p50_s"] <= stats["max_s"] and len(calls) == 9
    assert profiling._first_tensor({"a": [1, (None, x)]}) is x and profiling._first_tensor([1, "a"]) is None
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    trace = json.load(open(os.path.join(log_dir, "trace.json")))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_imports_stay_light():
    """``import gsplat_tpu_torch`` loads none of the CLI's libraries, JAX or
    the JAX package; ``gsplat_tpu_torch.cli`` loads neither JAX nor the JAX
    package."""
    code = (
        "import sys\n"
        "import gsplat_tpu_torch\n"
        "light = [m for m in ('click', 'PIL', 'matplotlib', 'jax', 'gsplat_tpu') if m in sys.modules]\n"
        "import gsplat_tpu_torch.cli\n"
        "print(light, [m for m in ('jax', 'gsplat_tpu') if m in sys.modules])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[] []", out.stdout + out.stderr


@pytest.mark.parametrize("command,mesh", [("render", "1x2"), ("orbit", "2x1"), ("evaluate", "1x2"), ("finetune", "2x2")])
def test_mesh_matches_jax(scene_dir, tmp_path, command, mesh):
    """``--mesh`` on the port's ranks (a spawned gloo world, ``--device
    cpu``) writes what the JAX CLI writes with the same ``--mesh`` on its
    virtual devices, at this file's tolerances; rank 0 alone writes."""
    import torch_mesh_worker as worker

    from gsplat_tpu_torch.io.ply import load_splat_arrays
    from gsplat_tpu_torch.io.scene import checkpoint_ply_path

    extra = {"render": ["--no-show"], "orbit": ["--num-frames", "3"], "evaluate": [],
             "finetune": ["--steps", "2", "--checkpoint-every", "1"]}
    outs = {port: str(tmp_path / ("port" if port else "jax")) for port in (False, True)}
    _invoke(command, [*_args(scene_dir, outs[False], False), *extra[command], "--mesh", mesh], port=False)
    data, tile = (int(x) for x in mesh.split("x"))
    ranks = worker.spawn_world(worker.cli_world, data * tile, tmp_path,
                               [command, *_args(scene_dir, outs[True], True), *extra[command], "--mesh", mesh])
    assert len(ranks) == data * tile
    j_out, out = outs[False], outs[True]
    if command == "render":
        assert np.abs(_png(os.path.join(out, "render.png")) - _png(os.path.join(j_out, "render.png"))).max() <= 1
        assert os.path.exists(os.path.join(out, "comparison.png"))
    elif command == "orbit":
        frames = sorted(os.listdir(os.path.join(out, "images")))
        assert frames == sorted(os.listdir(os.path.join(j_out, "images"))) and len(frames) == 3 + 40
        for name in frames:
            got, want = (_png(os.path.join(d, "images", name)) for d in (out, j_out))
            assert np.abs(got - want).max() <= 1, name
    elif command == "evaluate":
        got, want = (json.load(open(os.path.join(d, "metrics.json"))) for d in (out, j_out))
        assert [v["view"] for v in got["views"]] == [v["view"] for v in want["views"]] and len(got["views"]) == 2
        for a, b in zip(got["views"], want["views"]):
            assert abs(a["psnr"] - b["psnr"]) < 1e-3 and abs(a["ssim"] - b["ssim"]) < 1e-5, (a, b)
    else:
        got, want = (load_splat_arrays(checkpoint_ply_path(d, 30001)) for d in (out, j_out))
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=2e-3, atol=5e-5 * np.abs(w).max(), err_msg=k)
        assert os.path.isfile(os.path.join(out, "train_state.pt"))


def test_mesh_1x1_forms_its_own_world(scene_dir, tmp_path):
    """``--mesh 1x1`` without ``torchrun`` forms a world of one, scores as
    one device does, and leaves no process group behind."""
    import torch.distributed as dist

    outs = [str(tmp_path / name) for name in ("plain", "mesh")]
    _invoke("evaluate", _args(scene_dir, outs[0], True))
    _invoke("evaluate", [*_args(scene_dir, outs[1], True), "--mesh", "1x1"])
    assert not dist.is_initialized()
    got, want = (json.load(open(os.path.join(d, "metrics.json"))) for d in outs[::-1])
    assert got == want
