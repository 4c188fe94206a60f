"""One iteration of the 3DGS training recipe on the program's normal path:
``Trainer.fit_step``, the per-step entry of ``Trainer.fit``, on the
densify pool that ``Trainer.init_fit`` builds from the scene: the random
background, the update with the viewspace probe, Adam with the
per-parameter rates and the position schedule, the probe's accumulation,
the clone / split / prune pass at the densify cadence and the history
record and capacity re-check every ``log_every`` steps.

Before each step the loop state is restored, under the ``bench.restore``
mark, to the one the reference rebuilds from the scene and the
configuration (``reference/fit.py``): the pool's parameters from their
set-up copy (a copy of 59 floats a row), Adam's moments (m = 0, v = the
configuration's ``adam_v``, a fill each) and step count (the recipe's
iteration ``k``), the position schedule's count, an empty accumulator, the
raster configuration, the split generator (seed 0) and the background
generator (seed: the pose's index). Step ``i`` of a window is then the
recipe's iteration ``k + i``, so every step does the same work but those on
the densify cadence, which run the pass too, and those on the logging
cadence. Set-up takes one pass step, so that the window meets no first
pass.

The answer keeps the parameters after the step and the set-up copy, and
the update (after minus before) is taken when it is compared, outside the
window: the restore binds each parameter to a fresh copy of the set-up
one, so the last step's parameters stay with its answer and a restore
costs one copy whether or not its answer is kept.

Compared (``numbers``): the frame on its background, the loss, each
leaf's update over the rows no pass touched on either side (a pass step's
prunes, shrunk originals and filled slots are judged by its counts: the
ranks of near-equal candidates differ between float32 and float64, so the
split samples they draw and the slots they fill are not compared slot by
slot), the accumulated viewspace-gradient norms and radii, and at a pass
step the clone, split and prune counts. A sampled step that is no pass
step reads 0 for the three counts. A count is judged only where the
cell's limits file gives it a limit (``limits/recipe_5m.fit.json`` judges
the prune count alone: on its scene the pass finds no candidate, so the
clone and split counts read 0 whatever the program does).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from splatbench import compare, scene
from splatbench.reference import fit as ref_fit
from splatbench.reference import inputs
from splatbench.reference import render as ref_render

KIND = "train"


class Answer(NamedTuple):
    """A recipe step's answer. ``after`` and ``before`` hold the program's
    pool parameters after the step and its restored copy; the reference
    gives the update itself in ``after`` (its live rows) and no
    ``before``."""

    image: torch.Tensor
    loss: torch.Tensor
    after: List[torch.Tensor]
    before: Optional[List[torch.Tensor]]
    vs: torch.Tensor  # accumulated viewspace-gradient norms (NDC scale)
    radii: torch.Tensor  # accumulated largest radii (pixels)
    stats: Optional[dict]  # the pass's counts
    touched: Optional[torch.Tensor]  # [pool rows] bool: the rows the pass wrote
    passed: bool  # the step ran a pass


def _trainer_class(prog):
    """``Trainer``, or where the ``half`` or ``altered`` fault is planted,
    a ``Trainer`` whose update takes the loss of half the frame's rows or
    adds 0.05 to one block of the frame where it is composited."""
    from gsplat_tpu_torch import Trainer

    if prog.fault not in ("half", "altered"):
        return Trainer
    from gsplat_tpu_torch.render.pipeline import render_with_preprocess
    from gsplat_tpu_torch.train.loss import psnr, rgb_loss
    from gsplat_tpu_torch.train.trainer import optimizer_step

    class Faulted(Trainer):
        def _step(self, model, optimizer, cam, target, bg, width, height, cfg, screen_offset=None):
            optimizer.zero_grad(set_to_none=True)
            image, trans, prep = render_with_preprocess(model, cam, width, height, cfg, screen_offset)
            image = prog.altered(image + trans[..., None] * bg)
            pred, want = (image[::2], target[::2]) if prog.fault == "half" else (image, target)
            loss = rgb_loss(pred, want, self.train.ssim_weight)
            loss.backward()
            optimizer_step(optimizer, self.train)
            image = image.detach()
            with torch.no_grad():
                return {"loss": loss.detach(), "psnr": psnr(image, target)}, prep, image

    return Faulted


def train_config(recipe: dict, traffic: dict, extent: float):
    """The recipe as the program's ``TrainConfig``, the position rates times
    the cameras' extent."""
    from gsplat_tpu_torch import DensifyConfig, TrainConfig

    densify = DensifyConfig(
        every=recipe["densify_every"], start=recipe["densify_from"], until=recipe["densify_until"],
        grad_threshold=recipe["grad_threshold"], min_opacity=recipe["min_opacity"],
        prune_scale_extent=recipe["prune_scale_extent"], max_screen_size=recipe["max_screen_size"],
        size_prune_start=recipe["size_prune_start"], percent_dense=recipe["percent_dense"],
        split_factor=recipe["split_factor"], opacity_reset_every=recipe["opacity_reset_every"],
        pool_factor=recipe["pool_factor"],
    )
    return TrainConfig(
        lr_means=recipe["lr_means"] * extent, lr_scales=recipe["lr_scales"], lr_quats=recipe["lr_quats"],
        lr_opacity=recipe["lr_opacity"], lr_sh=recipe["lr_sh"], lr_means_final=recipe["lr_means_final"] * extent,
        lr_means_decay_steps=recipe["lr_means_steps"], ssim_weight=traffic["ssim_weight"],
        background=traffic["background"], steps=recipe["steps"], log_every=recipe["log_every"],
        checkpoint_every=0, densify=densify, sh_warmup_every=recipe["sh_warmup_every"],
    )


def prepare(prog) -> None:
    """The trainer, its loop state over the pool, the restore's copy, Adam's
    state at the recipe's iteration, and one pass step."""
    from gsplat_tpu_torch.train.trainer import scene_extent

    recipe = prog.config["recipe"]
    target = torch.full((prog.height, prog.width, 3), prog.traffic["target"], device=prog.device)
    # The loop trains on view (k + i) mod n at its step k + i: rotated so that
    # step i is the harness's pose i mod n.
    n, k = len(prog.cameras), recipe["iteration"]
    views = [(prog.cameras[(j - k) % n], target) for j in range(n)]
    tc = train_config(recipe, prog.traffic, scene_extent(prog.cameras))
    trainer = _trainer_class(prog)(raster=prog.cfg, train=tc, show_progress=False)
    state, _ = trainer.init_fit(prog.model, views)
    params = [getattr(state.model, name) for name in scene.PARAM_NAMES]
    for p in params:
        state.optimizer.state[p] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                                    "exp_avg_sq": torch.zeros_like(p)}
    prog.fit = dict(trainer=trainer, state=state, views=views, params=params, k=k,
                    saved=[p.detach().clone() for p in params],
                    v=[float(recipe["adam_v"][name]) for name in scene.PARAM_NAMES])
    step(prog, -k % recipe["densify_every"])


def restore(prog, i: int) -> None:
    """The loop state of the recipe's iteration ``k``, for step ``i``."""
    from gsplat_tpu_torch.train.densify import DensifyState
    from gsplat_tpu_torch.utils.stages import stage

    f = prog.fit
    state = f["state"]
    with stage("bench.restore"):
        for p, saved, v in zip(f["params"], f["saved"], f["v"]):
            p.data = saved.clone()  # the last step's parameters stay with its answer
            adam = state.optimizer.state[p]
            adam["step"].fill_(f["k"])
            adam["exp_avg"].zero_()
            adam["exp_avg_sq"].fill_(v)
        state.optimizer.param_groups[0]["updates"] = f["k"]
        state.dstate = DensifyState.zero(state.model.num_gaussians, prog.device)
        state.generator.manual_seed(0)
        state.bg_rng = np.random.default_rng(prog.pose_of(i))
        f["trainer"].raster = prog.cfg


def step(prog, i: int) -> Answer:
    f = prog.fit
    restore(prog, i)
    out = f["trainer"].fit_step(f["state"], f["k"] + i, f["views"])
    acc, touched, stats = out.densified if out.densified is not None else (f["state"].dstate, None, None)
    return Answer(out.image, out.metrics["loss"], [p.data for p in f["params"]], f["saved"], acc.grad_sum,
                  acc.max_radius, stats, touched, out.densified is not None)


def reference(params, pose, config: dict, traffic: dict, dtype, entries: int):
    cam, p = inputs(params, pose, config, dtype)
    dev = params[0].device
    poses = scene.poses(traffic)
    cams = [ref_render.camera(config["width"], config["height"], *q, dtype, dev) for q in poses]
    bg = torch.from_numpy(ref_fit.background(poses.index(tuple(pose)))).to(dtype=dtype, device=dev)
    target = torch.full((config["height"], config["width"], 3), traffic["target"], dtype=dtype, device=dev)
    s = ref_fit.recipe_step(p, cam, cams, config["recipe"], config["sh_degree"], config["early_stop"], bg, target,
                            traffic["ssim_weight"], entries)
    return Answer(s.image, s.loss, s.update, None, s.vs, s.radii, s.stats, s.touched, False), s.counts


def _update(a: Answer, leaf: int) -> torch.Tensor:
    x = a.after[leaf]
    return (x - a.before[leaf] if a.before is not None else x).double()


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` over ``n`` rows: the rows past its own are zero (a pool's dead
    rows, where the reference keeps its live rows alone)."""
    x = x.double()
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def numbers(got, want, allowance: float) -> dict:
    """``image_rms``, ``image_block_rms``; ``loss_rel``; ``update_rel``: over
    the five raw parameters, the largest ||update - reference update|| /
    max(||reference update||, the median of the five reference norms), the
    difference taken over the rows that no pass touched on either side
    (a pass may prune every row that moved); ``vs_rel``: ||norms -
    reference norms|| / ||reference norms||; ``radii_share``: the share of
    the rows with a radius on either side whose radii differ; at a pass
    step ``cloned_rel``, ``split_rel``, ``pruned_rel``: |count - reference
    count| / max(reference count, 1) (0 at a step without a pass)."""
    out = compare.frame_numbers(got, want, allowance)
    out["loss_rel"] = abs(float(got.loss) - float(want.loss)) / abs(float(want.loss))
    n = max(got.vs.shape[0], want.vs.shape[0])
    alone = ~(got.touched | want.touched)[:n] if got.passed else None
    errs, norms = [], []
    for leaf in range(len(want.after)):
        d, r = _rows(_update(got, leaf), n), _rows(_update(want, leaf), n)
        norms.append(float(r.norm()))
        d = d - r
        if alone is not None:
            d = d * alone.reshape((n,) + (1,) * (d.ndim - 1))
        errs.append(float(d.norm()))
        del d, r
    floor = sorted(norms)[len(norms) // 2]
    out["update_rel"] = max(e / max(m, floor) for e, m in zip(errs, norms))
    vs, vs_ref = _rows(got.vs, n), _rows(want.vs, n)
    out["vs_rel"] = float((vs - vs_ref).norm()) / float(vs_ref.norm())
    r, r_ref = _rows(got.radii, n), _rows(want.radii, n)
    drawn = (r > 0) | (r_ref > 0)
    out["radii_share"] = float(((r != r_ref) & drawn).sum()) / max(float(drawn.sum()), 1.0)
    for name in ("cloned", "split", "pruned"):
        out[f"{name}_rel"] = (abs(got.stats[name] - want.stats[name]) / max(want.stats[name], 1)
                              if got.passed else 0.0)
    return out
