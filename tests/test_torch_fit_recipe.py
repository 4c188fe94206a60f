"""The 3DGS recipe's per-step entry on the CPU: ``FitLoop.fit_step`` over a
``FitState``, which ``fit`` iterates, and one step of the recipe held to
the benchmark's plain float64 reference ``splatbench/reference/fit.py``.

* ``fit`` is a loop of ``init_fit`` and ``fit_step``, bitwise, with and
  without densification.
* One step of the benchmark's ``fit`` loop (``splatbench/steps/fit.py``: the
  loop state restored to the recipe's iteration, then ``fit_step``) on a
  small scene of seeded random weights, against the reference: the frame
  on its background, the loss, each parameter's update, the accumulated
  viewspace-gradient norms and radii; at a pass step also the pass's
  counts and touched rows, and the update of the rows it left alone.
* The densify spans and counters while recording, and none when not.
* A densifying fit seen from a camera at the origin, where the pool's dead
  rows sit: every pool row and Adam moment stays finite.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.models.gaussians import random_model
from gsplat_tpu_torch.train import densify as D
from gsplat_tpu_torch.utils import stages

from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

W, H = 48, 32
SMALL = dict(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 14)
NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")


def _views(yaws=(0.0, 0.3), shift=0.5):
    f = 0.5 * W / math.tan(0.5)
    cams = [tgs.CameraParams(W, H, 1.0, 2.0 * math.atan(H / (2.0 * f)), f, f,
                             (math.cos(a / 2), 0.0, math.sin(a / 2), 0.0), (shift, 0.0, 0.0)) for a in yaws]
    rng = np.random.default_rng(4)
    return [(c, torch.from_numpy(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))) for c in cams]


def _model(n=400, seed=3):
    model = random_model(torch.Generator().manual_seed(seed), n, extent=0.8, device="cpu")
    with torch.no_grad():
        model.means[:, 2] += 3.0
        model.log_scales += 0.5
    return model


def _train_config(densify: bool) -> tgs.TrainConfig:
    dense = tgs.DensifyConfig(every=3, start=1, grad_threshold=2e-4, percent_dense=0.4, size_prune_start=4,
                              prune_scale_extent=1.0, max_screen_size=30.0, opacity_reset_every=5, pool_factor=1.5)
    return tgs.TrainConfig(steps=8, log_every=2, background="random", sh_warmup_every=3, lr_means_decay_steps=6,
                           lr_means_final=1e-5, densify=dense if densify else None)


@pytest.mark.parametrize("densify", [False, True])
def test_fit_is_a_loop_of_fit_step(densify):
    """``fit``'s model and history against ``init_fit`` then ``fit_step`` at
    each step, on fresh trainers: bitwise equal; with densification the
    loop passes at steps 3 and 6, and clones, splits and (at 6) prunes."""
    views = _views()
    tc = _train_config(densify)
    cfg = tgs.RasterConfig(**SMALL)
    model, history = tgs.Trainer(raster=cfg, train=tc, show_progress=False).fit(_model(), views)

    trainer = tgs.Trainer(raster=cfg, train=tc, show_progress=False)
    state, start = trainer.init_fit(_model(), views)
    records, passes = [], []
    for step in range(start, tc.steps):
        out = trainer.fit_step(state, step, views, tc.steps)
        assert out.image.shape == (H, W, 3) and out.metrics["loss"].ndim == 0
        if out.record is not None:
            records.append(out.record)
        if out.densified is not None:
            passes.append((step, out.densified[2]))
    assert records == history and [r["step"] for r in records] == [0, 2, 4, 6, 7]
    looped = D.compact(state.model) if densify else state.model
    for name in NAMES:
        assert torch.equal(getattr(model, name), getattr(looped, name)), name
    if densify:
        assert [s for s, _ in passes] == [3, 6]
        assert sum(p["cloned"] for _, p in passes) > 0 and sum(p["split"] for _, p in passes) > 0, passes
        assert passes[1][1]["pruned"] > 0, passes
    else:
        assert passes == []


# --- one recipe step against splatbench/reference/fit.py ---


@pytest.fixture(scope="module")
def recipe():
    """The benchmark's ``recipe_5m.fit`` cell cut to a tiny size
    (``splatbench/tests/tiny.py``: 96x64, 3,000 gaussians) and set up on
    the CPU: the pool, Adam's state at iteration 7,550, one pass step."""
    from splatbench import run
    from splatbench.tests.tiny import CPU, tiny_cell

    cell = tiny_cell("recipe_5m.fit")
    params, prog, _ = run.set_up(cell, 2147483659, CPU)
    return cell, params, prog


def _reference(recipe, i):
    from splatbench.reference import reference_answer

    cell, params, prog = recipe
    return reference_answer(params, prog.poses[prog.pose_of(i)], cell.config, cell.traffic)[0]


def _assert_step_matches(cell, got, want, alone=None):
    """Frame: within the early stop's allowance plus 1e-5 (float32 sums of
    a pixel's terms); loss: rel 1e-5 (float32 sums over the frame); each
    leaf's update over ``alone`` (all rows by default): ||d - d_ref|| at
    most 1e-4 of ||d_ref|| (the float32 gradients' rounding) plus half an
    ulp of each parameter (the rounding of p + d to float32); the
    viewspace norms within 1e-4 of their norm; radii within 1 pixel, and
    equal but for at most 0.5% of the rows drawn (a ceil at a float32
    rounding step)."""
    n = want.vs.shape[0]
    assert float((got.image.double() - want.image).abs().max()) <= cell.config["early_stop"] + 1e-5
    assert float(got.loss) == pytest.approx(float(want.loss), rel=1e-5)
    keep = torch.ones(got.vs.shape[0], dtype=torch.bool) if alone is None else alone
    for leaf, name in enumerate(NAMES):
        before = got.before[leaf]
        d = (got.after[leaf] - before).double()
        ref = torch.cat([want.after[leaf], want.after[leaf].new_zeros((d.shape[0] - n,) + d.shape[1:])])
        mask = keep.reshape((-1,) + (1,) * (d.ndim - 1))
        ulp = (torch.nextafter(before, torch.full_like(before, math.inf)) - before).double()
        err = float(((d - ref) * mask).norm())
        assert err <= 1e-4 * float((ref * mask).norm()) + 0.5 * float((ulp * mask).norm()), name
    vs = got.vs[:n].double()
    assert float((vs - want.vs).norm()) <= 1e-4 * float(want.vs.norm())
    assert torch.equal(got.vs[n:], torch.zeros_like(got.vs[n:]))
    r = got.radii[:n].double()
    drawn = (r > 0) | (want.radii > 0)
    assert float((r - want.radii).abs().max()) <= 1.0
    assert int(((r != want.radii) & drawn).sum()) <= 0.005 * int(drawn.sum())


def test_recipe_step_matches_reference(recipe):
    """Step 1 of a window (recipe iteration 7,551; no pass, no log)."""
    cell, _, prog = recipe
    got = prog.step(1)
    assert not got.passed
    _assert_step_matches(cell, got, _reference(recipe, 1))


def test_pass_step_matches_reference(recipe):
    """Step 50 (iteration 7,600, on the densify cadence): the step as
    above over the rows the pass left alone on both sides; its counts and
    touched rows equal to the reference's. Every candidate's gradient norm
    and every updated opacity and scale lie at least 1e-3 relative from
    the pass's thresholds, so no decision can flip between float32 and
    float64."""
    cell, _, prog = recipe
    got = prog.step(50)
    want = _reference(recipe, 50)
    assert got.passed and got.stats["split"] > 0 and got.stats["pruned"] > 0, got.stats
    r = cell.config["recipe"]
    vs = want.vs[want.vs > 0]
    assert float((vs / r["grad_threshold"] - 1).abs().min()) >= 1e-3
    n = want.vs.shape[0]
    opacity = torch.sigmoid(got.after[3][:n].double())
    assert float((opacity / r["min_opacity"] - 1).abs().min()) >= 1e-3
    assert got.stats == want.stats
    assert torch.equal(got.touched, want.touched)
    _assert_step_matches(cell, got, want, alone=~got.touched)


# --- spans and counters ---


def test_densify_marks_recorded_and_off_when_not(monkeypatch):
    """A pass step under ``record_stages`` records the densify spans (the
    two host reads as sync spans), the capacity re-check's sync and the
    opacity reset, and the pass's counters as it counted them; with
    recording off no span or counter is opened."""
    views = _views()
    tc = _train_config(True)
    trainer = tgs.Trainer(raster=tgs.RasterConfig(**SMALL), train=tc, show_progress=False)
    state, _ = trainer.init_fit(_model(), views)
    for step in range(3):
        trainer.fit_step(state, step, views, tc.steps)
    with stages.record_stages(events=False) as rec:
        out = trainer.fit_step(state, 3, views, tc.steps)
    names = [s.name for s in rec.spans]
    for name in ("forward", "backward", "optimizer", "densify_stats", "densify", "capacity_check"):
        assert name in names, (name, names)
    assert names.count("densify_sync") == 2 and names.count("densify_stats") == 2
    syncs = {s.name for s in rec.spans if s.sync}
    assert syncs == {"densify_sync", "capacity_check"}
    by_id = {s.id: s for s in rec.spans}
    # The counts' read sits in the pass's selection, the stats' read after its writes.
    assert [by_id[s.parent].name for s in rec.spans if s.name == "densify_sync"] == ["densify_select", "densify"]
    counters = {name: value for name, _, value in rec.counter_values()
                if name in ("pruned", "cloned", "split", "densify_wanted", "alive")}
    stats = out.densified[2]
    assert counters == {"pruned": stats["pruned"], "cloned": stats["cloned"], "split": stats["split"],
                        "densify_wanted": stats["wanted"], "alive": stats["alive"]}
    assert sum(v for name, _, v in rec.counter_values() if name == "host_syncs") == 3
    assert {s.step for s in rec.spans} == {3}
    trainer.fit_step(state, 4, views, tc.steps)
    with stages.record_stages(events=False) as rec:
        trainer.fit_step(state, 5, views, tc.steps)  # an opacity reset
    assert "opacity_reset" in [s.name for s in rec.spans]

    def refuse(*args, **kwargs):
        raise AssertionError("a mark opened a span with recording off")

    monkeypatch.setattr(stages.Recording, "open", refuse)
    monkeypatch.setattr(stages.Recording, "counter_values", refuse)
    trainer.fit_step(state, 6, views, tc.steps)  # a pass, recording off
    assert stages._rec is None


def test_pool_rows_stay_finite_from_a_camera_at_the_origin():
    """The pool's dead rows sit at the origin: seen from a camera there they
    are culled at depth 0 with a zero view direction, and their gradients,
    parameters and Adam moments stay finite (zero), as the live rows'."""
    views = _views(yaws=(0.0,), shift=0.0)
    tc = tgs.TrainConfig(steps=4, densify=tgs.DensifyConfig(every=100))
    trainer = tgs.Trainer(raster=tgs.RasterConfig(**SMALL), train=tc, show_progress=False)
    state, _ = trainer.init_fit(_model(300), views)
    for step in range(3):
        trainer.fit_step(state, step, views)
    for name in NAMES:
        p = getattr(state.model, name)
        assert bool(torch.isfinite(p).all()), name
        assert bool(torch.isfinite(p.grad).all()), name
        adam = state.optimizer.state[p]
        assert bool(torch.isfinite(adam["exp_avg"]).all() & torch.isfinite(adam["exp_avg_sq"]).all()), name
        assert torch.equal(p.grad[300:], torch.zeros_like(p.grad[300:])), name
