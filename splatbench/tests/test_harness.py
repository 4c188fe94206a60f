"""The harness end to end on the CPU at a tiny size: the last-line
contract, the refusal without a card, a configuration, a traffic mix and a
metric added as new files alone, and the check failing on every fault
planted in the timed path and on the control."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from splatbench import compare, loops, readers, run, scene, spec
from splatbench.reference import reference_answer
from splatbench.trace import Trace
from splatbench.tests.tiny import BENCH, CPU, REPO, run_tiny, shrink, tiny_cell

CELLS = ["dense_5m.train", "headline_1m.train", "dense_5m.render"]


@pytest.mark.parametrize("name", CELLS)
def test_result_object_keeps_the_contract(name):
    cell = tiny_cell(name)
    result = run_tiny(cell)
    line = json.dumps(result)
    back = json.loads(line)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(back)[-1] == "checks"
    assert back["correct"] is True and back["failed"] == 0 and back["attempted"] >= 3
    assert set(back["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in back["metrics"] and len(back["metrics"]) >= 2
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    limits = compare.load_limits(run.HERE, name)
    assert set(back["checks"]) == set(limits)
    for c in back["checks"].values():
        assert c["value"] <= c["limit"]


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "dense_5m.render", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_a_config_a_mix_and_a_metric_added_as_files_alone(tmp_path):
    root = tmp_path / "splatbench"
    shutil.copytree(run.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    config = json.loads((REPO / "splatbench/configs/headline_1m.json").read_text())
    (root / "configs/tiny_cfg.json").write_text(json.dumps(dict(config, n_gaussians=1500)))
    (root / "traffic/tiny_mix.json").write_text(json.dumps(
        {"loop": "render", "poses": {"count": 2, "yaw_min": 0.0, "yaw_max": 0.05, "shift_per_yaw": 10.0},
         "warmup_seconds": 0.0, "trace_cycles": 1}))
    (root / "metrics/tiny.requests.py").write_text("def read(run):\n    return float(run.completed)\n")
    (root / "metrics/tiny.layer_ms.py").write_text(
        "from splatbench import readers\n\n\ndef read(run):\n    return readers.per_step_ms(run, ['preprocess'])\n")
    (root / "limits/tiny_cfg.tiny_mix.json").write_text(json.dumps(
        json.loads((root / "limits/dense_5m.render.json").read_text())))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny_cfg", "source": "x", "file": "splatbench/configs/tiny_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny_cfg.tiny_mix", "config": "tiny_cfg", "traffic": "tiny_mix",
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "tiny.requests", "unit": "requests", "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": ["tiny_cfg.tiny_mix"]})
    bench["per_layer"].append({"name": "tiny.layer_ms", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "camera, preprocess", "moves": "tiny.requests",
                               "workloads": ["tiny_cfg.tiny_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(bench, "tiny_cfg.tiny_mix", tmp_path, root)
    assert cell.end_to_end == ["setup_s", "tiny.requests"]
    assert cell.per_layer == ["tiny.layer_ms"]
    trace = Trace([[("preprocess", 0.0, 2.5)]], 0.01, 0.005, [], [], [], 1500, 96 * 64)
    assert spec.reader("tiny.layer_ms", root)(readers.Run("render", 1.0, 0.01, 1, [1.0], trace)) == 2.5
    cell = shrink(cell)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    import time

    result = run.run_cell(cell, units, 7, 0.2, False, CPU, time.perf_counter(), root=root)
    assert result["correct"] is True
    assert result["metrics"]["tiny.requests"] == {"value": float(result["attempted"]), "unit": "requests"}
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file() and "__pycache__" not in str(p)}
    assert all(after[k] == v for k, v in before.items())  # nothing that was there was edited


@pytest.mark.parametrize("fault", loops.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_every_planted_fault_fails_the_check(name, fault):
    result = run_tiny(tiny_cell(name), fault=fault)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_check(name):
    """The reference computed in bfloat16 in the program's place."""
    cell = tiny_cell(name)
    params = scene.build_scene(cell.config["n_gaussians"], cell.config["scale_shift"], 21, CPU)
    pose = scene.poses(cell.traffic)[0]
    want, _ = reference_answer(params, pose, cell.config, cell.traffic)
    control, _ = reference_answer(params, pose, cell.config, cell.traffic, dtype=torch.bfloat16)
    values = compare.numbers(cell.traffic["loop"], control, want, cell.config["early_stop"])
    correct, _ = compare.judge(values, compare.load_limits(run.HERE, name))
    assert correct is False, values
