"""The plain reference against the port's CPU path (the compositors' plain
versions) at a tiny scene: frame, transmittance, loss and the gradients to
the five parameters, unsliced in exact mode and depth-sliced with the
early stop."""

from __future__ import annotations

import pytest
import torch

from splatbench import compare, loops, scene
from splatbench.reference import reference_answer
from splatbench.tests.tiny import CPU, tiny_cell


@pytest.mark.parametrize("name", ["headline_1m.train", "dense_5m.train", "dense_5m.render"])
def test_reference_matches_the_port(name):
    cell = tiny_cell(name)
    params = scene.build_scene(cell.config["n_gaussians"], cell.config["scale_shift"], 11, CPU)
    prog = loops.Program(cell.config, cell.traffic, params, CPU)
    for p in range(len(prog.poses)):
        got = prog.step(p)
        want, counts = reference_answer(params, prog.poses[p], cell.config, cell.traffic)
        assert counts.in_box > counts.passed > 0
        n = compare.numbers(cell.traffic["loop"], got, want, cell.config["early_stop"])
        # f32 against f64. Besides rounding, an alpha within rounding of
        # the 1/255 gate passes on one side only: at this size one such
        # pixel moves the frame's RMS by 2e-5 and a leaf's gradient by
        # 1.5e-3 of its norm (seed 11, pose 0).
        assert n["image_rms"] < 5e-5, n
        if "trans_rms" in n:
            assert n["trans_rms"] < 5e-5, n
        if "grad_rel" in n:
            assert n["loss_rel"] < 1e-5 and n["grad_rel"] < 5e-3, n


def test_early_stop_differs_by_less_than_the_threshold():
    cell = tiny_cell("dense_5m.render")
    params = scene.build_scene(cell.config["n_gaussians"], cell.config["scale_shift"] + 1.0, 5, CPU)
    pose = scene.poses(cell.traffic)[1]
    exact, full = reference_answer(params, pose, dict(cell.config, early_stop=0.0), cell.traffic)
    stopped, cut = reference_answer(params, pose, cell.config, cell.traffic)
    assert cut.in_box < full.in_box  # the stop leaves work out
    stop = cell.config["early_stop"]
    assert float((exact.image - stopped.image).abs().max()) <= stop
    assert float((exact.trans - stopped.trans).abs().max()) <= stop


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    from splatbench.tests.tiny import REPO

    code = ("import sys; import splatbench.reference, splatbench.reference.render, splatbench.reference.loss, "
            "splatbench.counts, splatbench.compare; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'gsplat_tpu_torch', 'gsplat_tpu', 'jax'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert torch is not None
