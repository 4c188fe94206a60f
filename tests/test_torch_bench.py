"""The port's benchmark script (``tools/bench_torch.py``) on the CPU, held
against ``bench.py``'s own functions on the same arrays.

* synthetic mode at toy sizes (patched as ``tests/test_bench.py`` patches
  ``bench``): every extra measured, ``pairs_per_gaussian`` at every point;
  with no budget only the headline, the skips named, every line JSON;
* ``sized_capacity`` integer-equal to ``bench.sized_capacity``;
* the timed step's final loss (``time_fwd_bwd``, one step) within rtol 1e-5
  of ``bench.time_fwd_bwd``'s, in exact mode and with early stop 1e-4;
* ``scene_bench`` on a synthetic on-disk scene against ``bench.scene_bench``:
  views, size, gaussians and capacity equal, mean PSNR within 0.011 dB (both
  round to 2 places);
* ``--selftest`` refused on the CPU, ``main`` on the CPU printing JSON lines
  whose last is the headline, and ``--device cuda`` without a card printing
  the ``device_unreachable`` line and exiting 3;
* the script imports neither JAX nor the JAX package.
"""

import argparse
import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import RasterConfig as JRasterConfig
from gsplat_tpu.models.gaussians import GaussianModel as JGaussianModel
from gsplat_tpu.ops.camera import CameraArrays as JCameraArrays

import gsplat_tpu_torch as tgs

from fixtures import make_camera, random_splat_arrays, write_synthetic_scene
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
sys.path.insert(0, ROOT)  # bench.py
sys.path.insert(0, TOOLS)
import bench  # noqa: E402
import bench_torch  # noqa: E402
from card import json_fields  # noqa: E402

SMALL = dict(WIDTH=128, HEIGHT=96, NUM_GAUSSIANS=800, PAIR_SWEEP_SHIFTS=[0.8], REAL_DENSITY_N=800,
             REAL_DENSITY_SHIFT=1.0, REAL_DENSITY_SLICE=512, REAL_DENSITY_REDUCE=1024, RES_4K=(160, 128),
             CAPACITY_FLOOR=1 << 10, ITERS=(1, 1, 1, 1))
W, H = 64, 48
CAMERA = make_camera(W, H)


@pytest.fixture
def small(monkeypatch):
    """The bench at toy sizes; the depth slice and compacted reduction
    small enough that the real-density point runs several slices."""
    for name, value in SMALL.items():
        monkeypatch.setattr(bench_torch, name, value)


def _json_lines(out: str):
    return [json.loads(line) for line in out.splitlines() if line.strip()]


def _models(arrays):
    return (JGaussianModel.from_arrays(arrays), JCameraArrays.from_params(CAMERA),
            tgs.GaussianModel.from_arrays(arrays, device="cpu"),
            tgs.CameraArrays.from_params(tgs.CameraParams(**dataclasses.asdict(CAMERA)), device="cpu"))


def test_synthetic_mode_on_cpu(small, capsys):
    out = bench_torch.synthetic_bench(quick=False, device="cpu")
    extra = out["extra"]
    assert out["metric"] == "1080p_fwd+bwd_frames_per_sec_per_chip" and out["value"] > 0
    assert np.isfinite(extra["loss"]) and extra["backend"] == "cpu" and "nvidia_smi" not in extra
    assert extra["budget"]["skipped"] == [] and not [v for k, v in json_fields(out) if k == "error"]
    real = extra["real_density"]
    assert min(real["fps"], real["exact_mode_fps"], real["single_sort_fps"]) > 0, real
    assert extra["res_4k"]["fps"] > 0 and extra["early_stop_fps"] > 0
    assert [p["shift"] for p in extra["pair_sweep"]] == [0.8] and extra["pair_sweep"][0]["fps"] > 0
    for point in (extra, real, extra["res_4k"], *extra["pair_sweep"]):
        assert point["pairs_per_gaussian"] > 0, point
    assert real["pair_demand"] > SMALL["REAL_DENSITY_SLICE"], "the real-density point runs several slices"
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) >= 5 and all(line["value"] == out["value"] for line in lines)


def test_synthetic_bench_budget_exhausted(small, monkeypatch, capsys):
    """With no budget every extra is skipped, but the headline is measured,
    emitted, and names the skips."""
    monkeypatch.setattr(bench_torch, "BENCH_BUDGET_S", 0.0)
    out = bench_torch.synthetic_bench(quick=False, device="cpu")
    assert out["value"] > 0
    skipped = out["extra"]["budget"]["skipped"]
    assert skipped == ["real_density", "res_4k", "pair_sweep[0.8]", "early_stop"], skipped
    assert "real_density" not in out["extra"] and out["extra"]["pair_sweep"] == []
    lines = _json_lines(capsys.readouterr().out)
    assert lines, "the headline line is emitted even with no budget"
    for line in lines:
        assert line["value"] == out["value"]


def test_sized_capacity_matches_bench(monkeypatch):
    monkeypatch.setattr(bench, "CAPACITY_FLOOR", 128)
    monkeypatch.setattr(bench_torch, "CAPACITY_FLOOR", 128)
    arrays = random_splat_arrays(np.random.default_rng(5), 600)
    jmodel, jcam, tmodel, tcam = _models(arrays)
    for headroom in (1.1, 1.5):
        want = bench.sized_capacity(jmodel, jcam, headroom, W, H)
        got = bench_torch.sized_capacity(tmodel, tcam, headroom, W, H)
        assert got == want and got[0] > 128, (headroom, got, want)


@pytest.mark.parametrize("early_stop", [0.0, 1e-4], ids=["exact", "early_stop"])
def test_timed_step_loss_matches_bench(early_stop):
    """Grown splats, so that tiles saturate and early stop has work."""
    arrays = random_splat_arrays(np.random.default_rng(8), 400)
    arrays["log_scales"] = arrays["log_scales"] + 1.0
    arrays["opacity_logits"] = arrays["opacity_logits"] + 1.0
    jmodel, jcam, tmodel, tcam = _models(arrays)
    cap = 1 << 10  # the demand is 639 pairs; the jnp step's time grows with the capacity
    jcfg = JRasterConfig(tile_size=32, chunk_size=32, max_pairs=cap, early_stop_transmittance=early_stop,
                         strict_parity=True, use_pallas=False)
    _, want = bench.time_fwd_bwd(jmodel, jcam, jnp.zeros((H, W, 3), jnp.float32) + 0.25, jcfg, iters=1)
    sec, got = bench_torch.time_fwd_bwd(tmodel, tcam, torch.zeros((H, W, 3)) + 0.25,
                                        bench_torch.make_cfg(cap, early_stop), iters=1)
    assert sec > 0 and got == pytest.approx(want, rel=1e-5)
    assert all(p.grad is None for p in tmodel.parameters()), "autograd.grad accumulates nothing"


def test_scene_bench_matches_bench(tmp_path):
    root = str(tmp_path / "scene")
    write_synthetic_scene(root, np.random.default_rng(3), n_gaussians=200, n_images=2)
    want = bench.scene_bench(argparse.Namespace(scene=root, model=root + "/model", scale_factor=1, quick=True))
    got = bench_torch.scene_bench(root, root + "/model", scale_factor=1, quick=True, device="cpu")
    assert got["metric"] == want["metric"] and got["value"] > 0
    for key in ("num_views", "width", "height", "num_gaussians", "max_pairs"):
        assert got["extra"][key] == want["extra"][key], key
    assert got["extra"]["num_views"] == 2
    assert abs(got["extra"]["mean_psnr"] - want["extra"]["mean_psnr"]) <= 0.011, (got, want)


def test_selftest_refuses_the_cpu():
    with pytest.raises(ValueError, match="needs --device cuda"):
        bench_torch.main(["--selftest", "--device", "cpu", "--selftest-gaussians", "100"])


def test_main_quick_on_cpu(small, capsys):
    assert bench_torch.main(["--quick", "--device", "cpu"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) >= 1
    last = lines[-1]
    assert last["metric"] == "1080p_fwd+bwd_frames_per_sec_per_chip" and last["value"] > 0
    assert "budget" not in last["extra"] and last["extra"]["max_pairs"] >= SMALL["CAPACITY_FLOOR"]


def test_no_card_is_device_unreachable():
    """``--device cuda`` (the default) where no card is present: the
    ``device_unreachable`` line and exit 3, never a run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(TOOLS, "bench_torch.py"), "--quick"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 3, proc.stderr[-2000:]
    last = _json_lines(proc.stdout)[-1]
    assert last["value"] == 0.0 and last["extra"]["error"] == "device_unreachable"
    assert "CUDA" in last["extra"]["detail"], last


def test_bench_imports_no_jax():
    for path in (os.path.join(TOOLS, "bench_torch.py"), os.path.join(TOOLS, "card.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names]
        names += [node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module]
        assert "torch" in names, path
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "gsplat_tpu", "bench"), (path, name)
