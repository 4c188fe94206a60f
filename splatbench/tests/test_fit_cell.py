"""The ``recipe_5m.fit`` cell (the 3DGS recipe's step, ``steps/fit.py``) at
``tiny.py``'s size on the CPU: a run reads correct, so does a pass step
(a run's two answers fall on one only now and then), and every fault
planted in the timed path and the control fail the check."""

from __future__ import annotations

import pytest
import torch

from splatbench import compare, loops, run, scene
from splatbench.reference import reference_answer
from splatbench.tests.tiny import CPU, run_tiny, tiny_cell

CELL = "recipe_5m.fit"


@pytest.mark.parametrize("seed", [2147483659, 9000000007])
def test_the_cell_reads_correct(seed):
    result = run_tiny(tiny_cell(CELL), seed=seed)
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"setup_s", "train_frames_per_s"}
    assert set(result["checks"]) == set(compare.load_limits(run.HERE, CELL))


def test_a_pass_step_reads_correct():
    """Step 50 is the recipe's iteration 7,600, on the densify cadence."""
    cell = tiny_cell(CELL)
    params, prog, _ = run.set_up(cell, 2147483659, CPU)
    got = prog.step(50)
    want, _ = reference_answer(params, prog.poses[prog.pose_of(50)], cell.config, cell.traffic)
    assert got.passed and got.stats["pruned"] > 0, got.stats
    values = compare.numbers(cell.traffic["loop"], got, want, cell.config["early_stop"])
    correct, checks = compare.judge(values, compare.load_limits(run.HERE, CELL))
    assert correct is True, checks


@pytest.mark.parametrize("fault", loops.FAULTS)
def test_every_planted_fault_fails_the_check(fault):
    result = run_tiny(tiny_cell(CELL), fault=fault)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("passed", [False, True])
def test_the_control_fails_the_check(passed):
    """The reference computed in bfloat16 in the program's place, as a
    step without and with a pass."""
    cell = tiny_cell(CELL)
    params = scene.build_scene(cell.config["n_gaussians"], cell.config["scale_shift"], 21, CPU)
    pose = scene.poses(cell.traffic)[0]
    want, _ = reference_answer(params, pose, cell.config, cell.traffic)
    control, _ = reference_answer(params, pose, cell.config, cell.traffic, dtype=torch.bfloat16)
    values = compare.numbers(cell.traffic["loop"], control._replace(passed=passed), want, cell.config["early_stop"])
    correct, _ = compare.judge(values, compare.load_limits(run.HERE, CELL))
    assert correct is False, values


@pytest.mark.parametrize("metric, rows", [
    ("train.optimizer_roofline_pct", 10_000_128),  # recipe_5m.fit alone: the pool, 2.0 x the live scene
    ("train.loss_ms", 5_000_000),  # the fwd+bwd cells: no pool, the scene's own rows
    ("train.preprocess_ms", None),  # both kinds listed: no one pool factor
])
def test_adams_rows_follow_the_listed_cells_configurations(metric, rows):
    from splatbench import adam_counts

    assert adam_counts.optimized_rows(5_000_000, metric) == rows
