"""The 3DGS recipe on a scene that grows (the benchmark's ``grow_5m.fit``:
``splatbench/scenes/growing.py``, ``configs/grow_5m.json``) on the CPU.

* The scene law: at 1920x1080 its gaussians sit under both size prunes at
  every pose, and the split rule falls inside its band.
* The pass step of the benchmark's ``fit`` loop (``splatbench/steps/fit.py``)
  on the growing scene cut to a tiny size: it clones and splits, its counts
  and touched rows equal the plain float64 reference's
  (``splatbench/reference/fit.py``), and the step reads correct against
  the cell's limits; a run reads correct, each planted fault and the
  bfloat16 control do not.
* The rows the pass writes (``train/densify.py``): clones are copies of
  their sources, split halves and their originals shrink by
  ``log(split_factor)``, a split half's mean is its source's plus
  ``R S eps``, all against a plain computation with the same ``eps``.
* The pass's spans (``densify_select``, ``densify_rows``, ``densify_reset``)
  inside ``densify`` and its ``filled`` counter while recording, none when
  not; the two readers of ``splatbench/metrics/`` on a made-up trace.

The tiny cell is 96x64 with 3,000 gaussians over three poses. The
screen-size law draws world sizes 20 times those of 1920x1080 there, so the
pass's two thresholds in world units (the split rule's ``percent_dense``
and the size prune's ``prune_scale_extent``) are taken 20 times larger
too: the pass then splits and prunes the same screen sizes as at full
size.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.train import densify as D
from gsplat_tpu_torch.utils import stages

from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CELL = "grow_5m.fit"
CPU = torch.device("cpu")
SEED = 2147483659
W, H = 96, 64


def _cell():
    """The cell at the tiny size, as the module docstring says."""
    from splatbench import spec

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = spec.load_cell(bench, CELL, REPO)
    c = cell.config
    ratio = c["width"] / W
    recipe = dict(c["recipe"], percent_dense=c["recipe"]["percent_dense"] * ratio,
                  prune_scale_extent=c["recipe"]["prune_scale_extent"] * ratio)
    config = dict(c, n_gaussians=3000, width=W, height=H, slice_pairs=256, reduce_pairs=1024, recipe=recipe)
    traffic = dict(cell.traffic, poses=dict(cell.traffic["poses"], count=3), warmup_seconds=0.0)
    return cell._replace(config=config, traffic=traffic)


def _limits():
    from splatbench import compare, run

    return compare.load_limits(run.HERE, CELL)


@pytest.fixture(scope="module")
def grow():
    """The tiny cell set up on the CPU: the pool, Adam's state at iteration
    7,550, one pass step."""
    from splatbench import run

    cell = _cell()
    params, prog, _ = run.set_up(cell, SEED, CPU)
    return cell, params, prog


# --- the scene law ---


def test_scene_sits_under_the_size_prunes_and_straddles_the_split_rule():
    """4,000 gaussians of the full-size configuration, seen at the eight
    ``orbit8`` poses through the reference's projection: under 1% of the
    rows drawn at a pose are past the 20-pixel prune (the reference's
    radii) and none past the 0.1-extent prune; the split rule (largest
    scale above ``percent_dense`` of the extent) takes some of the drawn
    rows and leaves some to clone."""
    from splatbench import scene, spec
    from splatbench.reference import fit as ref_fit
    from splatbench.reference import render as ref_render

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = spec.load_cell(bench, CELL, REPO)
    c, r = dict(cell.config, n_gaussians=4000), cell.config["recipe"]
    params = [p.double() for p in spec.scene_file(c).build(c, SEED, CPU)]
    cams = [ref_render.camera(c["width"], c["height"], *q, torch.float64, CPU) for q in scene.poses(cell.traffic)]
    extent = ref_fit.extent(cams)
    largest = torch.exp(params[1].amax(-1))
    assert not bool((largest > r["prune_scale_extent"] * extent).any())
    split = largest > r["percent_dense"] * extent
    for cam in cams:
        radii = ref_fit.radii(ref_render.project(params, cam, c["sh_degree"]).feat, cam)
        drawn = radii > 0
        assert int(drawn.sum()) > 1000
        assert int((radii > r["max_screen_size"]).sum()) < 0.01 * int(drawn.sum())
        assert 0.1 < float(split[drawn].double().mean()) < 0.9


# --- the pass step against the reference ---


def test_pass_step_clones_splits_and_matches_the_reference(grow):
    """Step 50 (iteration 7,600, on the densify cadence): the pass clones
    and splits, its counts and touched rows equal the reference's, and the
    step, its update compared on the rows the pass left alone on both
    sides, reads correct against the cell's limits. Every candidate's
    gradient norm lies at least 1e-3 relative from the threshold, so no
    decision can flip between float32 and float64."""
    from splatbench import compare
    from splatbench.reference import reference_answer

    cell, params, prog = grow
    got = prog.step(50)
    want, _ = reference_answer(params, prog.poses[prog.pose_of(50)], cell.config, cell.traffic)
    assert got.passed and got.stats["cloned"] > 0 and got.stats["split"] > 0, got.stats
    vs = want.vs[want.vs > 0]
    assert float((vs / cell.config["recipe"]["grad_threshold"] - 1).abs().min()) >= 1e-3
    assert got.stats == want.stats
    assert torch.equal(got.touched, want.touched)
    n = want.vs.shape[0]
    assert int(got.touched[:n].sum()) < n  # the update is compared on some live rows
    values = compare.numbers(cell.traffic["loop"], got, want, cell.config["early_stop"])
    correct, checks = compare.judge(values, _limits())
    assert correct, checks
    assert "cloned_rel" in checks and "split_rel" in checks


def test_the_cell_reads_correct():
    from splatbench import run

    result = run.run_cell(_cell(), {"setup_s": "s", "train_frames_per_s": "frames/s"}, SEED, 0.5, False, CPU,
                          0.0)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_every_planted_fault_fails_the_check(fault):
    from splatbench import loops, run

    assert fault in loops.FAULTS
    result = run.run_cell(_cell(), {"setup_s": "s", "train_frames_per_s": "frames/s"}, SEED, 0.5, False, CPU,
                          0.0, fault=fault)
    assert result["correct"] is False, result["checks"]


def test_the_control_fails_the_check(grow):
    """The reference computed in bfloat16 in the program's place, as a
    pass step."""
    from splatbench import compare
    from splatbench.reference import reference_answer

    cell, params, prog = grow
    pose = prog.poses[prog.pose_of(50)]
    want, _ = reference_answer(params, pose, cell.config, cell.traffic)
    control, _ = reference_answer(params, pose, cell.config, cell.traffic, dtype=torch.bfloat16)
    values = compare.numbers(cell.traffic["loop"], control._replace(passed=True), want, cell.config["early_stop"])
    correct, _ = compare.judge(values, _limits())
    assert correct is False, values


# --- the rows the pass writes ---


@pytest.fixture(scope="module")
def written(grow):
    """One pass over a copy of the tiny cell's pool after a step, with the
    accumulator that step left and split samples ``eps``: the pool before
    and after, the pass's stats and the plain pairing of candidates (by
    falling mean gradient, ties in slot order) with free slots (in slot
    order)."""
    from gsplat_tpu_torch import GaussianModel

    cell, _, prog = grow
    out = prog.step(1)
    model = GaussianModel(*(p.detach().clone() for p in out.after))
    r = cell.config["recipe"]
    state = D.DensifyState(*(x.clone() for x in prog.fit["state"].dstate))
    cfg = prog.fit["trainer"].train.densify
    extent = prog.fit["state"].extent
    before = [p.detach().clone() for p in out.after]
    c = before[0].shape[0]
    eps = torch.randn((c, 3), generator=torch.Generator().manual_seed(5))
    _, touched, stats = D._densify_prune_step(model, state, eps, extent, cfg, r["iteration"] + 1)
    after = [getattr(model, name).detach() for name in ("means", "log_scales", "quats", "opacity_logits", "sh")]

    alive = (before[3] > D._ALIVE_THRESHOLD).numpy()
    vs = state.grad_sum.numpy()
    largest = torch.exp(before[1].amax(-1)).numpy()
    assert stats["pruned"] == 0, stats
    want = alive & (vs >= np.float32(r["grad_threshold"]))
    split = want & (largest > np.float32(extent) * np.float32(cfg.percent_dense))
    src = sorted(np.flatnonzero(want), key=lambda i: (-vs[i], i))
    dst = np.flatnonzero(~alive)[: len(src)]
    return dict(before=before, after=after, eps=eps, stats=stats, touched=touched, src=src, dst=dst, split=split,
                log_split=math.log(cfg.split_factor))


@pytest.mark.parametrize("kind", ["clone", "split half", "split original"])
def test_written_rows_match_a_plain_computation(written, kind):
    """Each clone is its source, bitwise; each split half is its source
    with every log scale less ``log(1.6)`` and its mean moved by
    ``R S eps_i`` (R the source's normalised quaternion, S its scales,
    eps_i the i-th candidate's sample), within 1e-6 of the float64
    computation (float32 rounding of the rotation, the exp and the sum);
    each split original keeps its mean and shrinks alike."""
    w = written
    before, after, eps = w["before"], w["after"], w["eps"]
    pairs = [(i, s, d) for i, (s, d) in enumerate(zip(w["src"], w["dst"]))
             if w["split"][s] == (kind != "clone")]
    assert len(pairs) == w["stats"]["cloned" if kind == "clone" else "split"] > 0
    shrink = torch.tensor(w["log_split"], dtype=torch.float32)
    for i, s, d in pairs:
        if kind == "clone":
            for b, a in zip(before, after):
                assert torch.equal(a[d], b[s])
        elif kind == "split original":
            assert torch.equal(after[0][s], before[0][s])
            assert torch.equal(after[1][s], before[1][s] - shrink)
            assert bool(w["touched"][s])
        else:
            assert torch.equal(after[1][d], before[1][s] - shrink)
            for leaf in (2, 3, 4):
                assert torch.equal(after[leaf][d], before[leaf][s])
            q = before[2][s].double()
            q = q / q.norm()
            qw, qx, qy, qz = q.tolist()
            rot = torch.tensor([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
            ], dtype=torch.float64)
            mean = before[0][s].double() + rot @ (torch.exp(before[1][s].double()) * eps[i].double())
            assert float((after[0][d].double() - mean).abs().max()) <= 1e-6 * max(float(mean.abs().max()), 1.0)
    rows = torch.zeros(before[0].shape[0], dtype=torch.bool)
    rows[[d for _, _, d in pairs]] = True
    assert bool(w["touched"][rows].all())


# --- spans, counters and their readers ---


def test_pass_spans_recorded_inside_densify(grow):
    """A pass step under ``record_stages``: ``densify_select``,
    ``densify_rows`` and ``densify_reset`` once each, each caused by the
    ``densify`` span, and the counter ``filled`` at the rows placed."""
    _, _, prog = grow
    with stages.record_stages(events=False) as rec:
        got = prog.step(50)
    by_id = {s.id: s for s in rec.spans}
    for name in ("densify_select", "densify_rows", "densify_reset"):
        found = [s for s in rec.spans if s.name == name]
        assert len(found) == 1, (name, [s.name for s in rec.spans])
        assert by_id[found[0].parent].name == "densify"
    filled = [v for name, _, v in rec.counter_values() if name == "filled"]
    assert filled == [got.stats["cloned"] + got.stats["split"]]


def test_pass_spans_not_recorded_when_off(grow, monkeypatch):
    _, _, prog = grow

    def refuse(*args, **kwargs):
        raise AssertionError("a mark opened a span with recording off")

    monkeypatch.setattr(stages.Recording, "open", refuse)
    got = prog.step(50)
    assert got.passed and stages._rec is None


def _run(steps, kind="train"):
    from splatbench import readers
    from splatbench.trace import Trace

    return readers.Run(kind, 1.0, 0.02, len(steps), [], Trace(steps, 0.02, 0.01, [], [], [], 1000, 1000))


def test_pass_readers_average_over_the_steps_that_pass():
    """Three steps, two with a pass: each reader is the mean of its span
    over those two; ``train.densify_ms`` still counts the nested spans
    once, spread over all three."""
    from splatbench import spec

    plain = [("densify_stats", 0.0, 1.0)]
    pass_a = plain + [("densify_select", 1.0, 2.0), ("densify_rows", 2.0, 5.0), ("densify_reset", 5.0, 6.0),
                      ("densify", 1.0, 7.0)]
    pass_b = plain + [("densify_select", 1.0, 2.0), ("densify_rows", 2.0, 3.0), ("densify_reset", 3.0, 4.0),
                      ("densify", 1.0, 5.0)]
    run = _run([plain, pass_a, pass_b])
    assert spec.reader("train.densify_pass_ms")(run) == pytest.approx((6.0 + 4.0) / 2)
    assert spec.reader("train.densify_rows_ms")(run) == pytest.approx((3.0 + 1.0) / 2)
    assert spec.reader("train.densify_ms")(run) == pytest.approx((1.0 + 7.0 + 5.0) / 3)


def test_pass_readers_find_nothing_without_their_spans():
    """No pass in the window, a program without ``densify_rows`` (the
    parent's), a render run, an untraced run: None, no error."""
    from splatbench import readers, spec

    pass_only = [("densify", 1.0, 3.0)]
    assert spec.reader("train.densify_pass_ms")(_run([[("densify_stats", 0.0, 1.0)]])) is None
    assert spec.reader("train.densify_pass_ms")(_run([pass_only])) == pytest.approx(2.0)
    assert spec.reader("train.densify_rows_ms")(_run([pass_only])) is None
    assert spec.reader("train.densify_pass_ms")(_run([pass_only], kind="render")) is None
    assert spec.reader("train.densify_rows_ms")(readers.Run("train", 1.0, 2.0, 10, [], None)) is None
