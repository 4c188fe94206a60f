"""The harness end to end on the CPU at a tiny size: the last-line
contract, the refusal without a card, a configuration, a traffic mix and a
metric added as new files alone, a loop and a scene added as new files
alone, and the check failing on every fault planted in the timed path and
on the control."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from splatbench import compare, loops, readers, run, scene, spec
from splatbench.reference import reference_answer
from splatbench.trace import Trace
from splatbench.tests.tiny import BENCH, CPU, REPO, run_tiny, shrink, tiny_cell

CELLS = ["dense_5m.train", "headline_1m.train", "dense_5m.render", "headline_1m.render"]


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


TWICE = '''"""A train step taken twice a call: the loss and the gradients summed."""
from pathlib import Path

from splatbench import spec

TRAIN = spec.step_file("train", Path(__file__).resolve().parents[1])
KIND = "train"
prepare = TRAIN.prepare
numbers = TRAIN.numbers


def step(prog, i):
    a, b = TRAIN.step(prog, i), TRAIN.step(prog, i)
    return b._replace(loss=a.loss + b.loss, grads=[x + y for x, y in zip(a.grads, b.grads)])


def reference(params, pose, config, traffic, dtype, entries):
    want, counts = TRAIN.reference(params, pose, config, traffic, dtype, entries)
    return want._replace(loss=2 * want.loss, grads=[2 * g for g in want.grads]), counts
'''

FLAT = '''"""A wall of gaussians facing the camera, z in [3.5, 4.5]."""
import torch


def build(config, seed, device):
    n = config["n_gaussians"]
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    z = uniform((n,), 3.5, 4.5)
    xy = uniform((n, 2), -0.7, 0.7) * z[:, None]
    return [torch.cat([xy, z[:, None]], -1), uniform((n, 3), -3.6, -2.8), torch.randn((n, 4), generator=g, device=device),
            uniform((n,), -2.0, 2.0), torch.randn((n, 16, 3), generator=g, device=device) * 0.2]
'''


def test_a_loop_and_a_scene_added_as_files_alone(tmp_path):
    """A loop (``steps/tiny_twice.py``), a scene (``scenes/tiny_flat.py``), a
    configuration naming the scene, a mix naming the loop and limits, as new
    files of a copy of the harness: its cell runs correct, each planted
    fault fails its check, and no file that was there is edited."""
    import time

    root = tmp_path / "splatbench"
    shutil.copytree(run.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "steps/tiny_twice.py").write_text(TWICE)
    (root / "scenes/tiny_flat.py").write_text(FLAT)
    config = json.loads((REPO / "splatbench/configs/headline_1m.json").read_text())
    (root / "configs/tiny_wall.json").write_text(json.dumps(dict(config, scene="tiny_flat", n_gaussians=1500)))
    mix = json.loads((root / "traffic/train.json").read_text())
    (root / "traffic/tiny_twice.json").write_text(json.dumps(dict(mix, loop="tiny_twice")))
    (root / "limits/tiny_wall.tiny_twice.json").write_text((root / "limits/headline_1m.train.json").read_text())
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny_wall", "source": "x", "file": "splatbench/configs/tiny_wall.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny_wall.tiny_twice", "config": "tiny_wall", "traffic": "tiny_twice",
                               "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dense_5m.train" in m.get("workloads", []):
            m["workloads"].append("tiny_wall.tiny_twice")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = shrink(spec.load_cell(bench, "tiny_wall.tiny_twice", tmp_path, root))
    assert cell.end_to_end == ["setup_s", "train_frames_per_s"]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    params, prog, _ = run.set_up(cell, 7, CPU, root=root)
    assert float(params[0][:, 2].min()) >= 3.5  # the wall, not the default scene
    assert prog.loop.__file__ == str(root / "steps/tiny_twice.py")
    del params, prog
    result = run.run_cell(cell, units, 7, 0.2, False, CPU, time.perf_counter(), root=root)
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"setup_s", "train_frames_per_s"}
    for fault in loops.FAULTS:
        result = run.run_cell(cell, units, 7, 0.2, False, CPU, time.perf_counter(), root=root, fault=fault)
        assert result["correct"] is False, (fault, result["checks"])
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
