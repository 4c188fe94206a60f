"""Fine-tuning loop: optimize splat parameters against ground-truth views.

The 3DGS recipe, as in ``gsplat_tpu/train/trainer.py``: per-parameter
learning rates, Adam, L1 + D-SSIM loss. One step renders the view with
gradients on, composites it onto the background through its
transmittance, takes the loss, runs the backward (the hand-written
backward compositor, then autograd through the preprocess) and updates
the model in place. With ``TrainConfig.densify`` the step also reads the
viewspace gradient and the projected radii that adaptive density control
accumulates (``train/densify.py``); ``fit`` can checkpoint its whole loop
state and resume from it (``train/checkpoint.py``). ``fit_step`` is one of
``fit``'s steps on that state held in a ``FitState``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.config import RasterConfig, TrainConfig
from gsplat_tpu_torch.models.gaussians import GaussianModel
from gsplat_tpu_torch.ops.camera import CameraArrays, CameraParams, camera_center
from gsplat_tpu_torch.render.pipeline import binning_stats, render_with_preprocess, required_max_pairs
from gsplat_tpu_torch.train import checkpoint as CK
from gsplat_tpu_torch.train import densify as D
from gsplat_tpu_torch.train.loss import psnr, rgb_loss
from gsplat_tpu_torch.utils import stages
from gsplat_tpu_torch.utils.logging import get_logger
from gsplat_tpu_torch.utils.progress import progress
from gsplat_tpu_torch.utils.stages import stage, sync

logger = get_logger()

# Parameter groups of the optimizer, in GaussianModel order, with the
# TrainConfig field that holds each one's learning rate.
_LR_FIELDS = (
    ("means", "lr_means"),
    ("log_scales", "lr_scales"),
    ("quats", "lr_quats"),
    ("opacity_logits", "lr_opacity"),
    ("sh", "lr_sh"),
)


def scene_extent(cameras: Sequence[CameraParams]) -> float:
    """3DGS's ``spatial_lr_scale`` (the Inria trainer's getNerfppNorm):
    1.1x the radius of the camera-center bounding sphere around the
    centroid. The 3DGS position rates are calibrated to be multiplied by
    it on real scenes."""
    centers = np.stack([camera_center(cam.matrices()[0]).numpy() for cam in cameras])
    radius = float(np.linalg.norm(centers - centers.mean(axis=0), axis=1).max())
    return 1.1 * max(radius, 1e-6)


def means_lr(tc: TrainConfig, count: int) -> float:
    """The means' learning rate for the update that follows ``count``
    earlier ones: optax's ``exponential_decay(lr_means, lr_means_decay_steps,
    decay_rate=lr_means_final / lr_means, end_value=lr_means_final)``."""
    if tc.lr_means_decay_steps <= 0 or count <= 0:
        return tc.lr_means
    rate = tc.lr_means_final / tc.lr_means
    lr = tc.lr_means * rate ** (count / tc.lr_means_decay_steps)
    return max(lr, tc.lr_means_final) if rate < 1.0 else min(lr, tc.lr_means_final)


def make_optimizer(model: GaussianModel, tc: TrainConfig) -> torch.optim.Adam:
    """Adam with the 3DGS per-parameter learning rates, one parameter group
    per parameter (named as the parameter). Optax's Adam defaults (betas
    0.9/0.999, eps 1e-8), whose update is the same formula up to rounding.
    With ``lr_means_decay_steps > 0`` the means' rate follows
    :func:`means_lr`; :func:`optimizer_step` sets it before each update."""
    if tc.lr_means_decay_steps > 0 and not 0.0 < tc.lr_means_final <= tc.lr_means:
        raise ValueError(
            "lr_means_final must be in (0, lr_means] when "
            f"lr_means_decay_steps > 0, got {tc.lr_means_final}"
        )
    groups = [
        {"params": [getattr(model, name)], "lr": getattr(tc, field), "name": name}
        for name, field in _LR_FIELDS
    ]
    groups[0]["updates"] = 0  # updates made so far: the schedule's count
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def optimizer_step(optimizer: torch.optim.Adam, tc: TrainConfig) -> None:
    """One Adam update, with the means' rate for it set first."""
    means = optimizer.param_groups[0]
    means["lr"] = means_lr(tc, means["updates"])
    optimizer.step()
    means["updates"] += 1


def check_background(tc: TrainConfig) -> None:
    if tc.background not in ("black", "white", "random"):
        raise ValueError(f"TrainConfig.background must be black|white|random, got {tc.background!r}")


def background(tc: TrainConfig, rng: np.random.Generator, device) -> torch.Tensor:
    """A step's background colour ``[3]`` on ``device``, per
    ``tc.background`` ("random" draws a fresh colour from ``rng``, a numpy
    generator seeded 0 as the JAX trainers seed theirs, so both draw the
    same colours)."""
    if tc.background == "white":
        return torch.ones(3, device=device)
    if tc.background == "random":
        colour = torch.from_numpy(rng.uniform(size=3).astype(np.float32))
        return colour.to(device, non_blocking=True)
    return torch.zeros(3, device=device)


@dataclasses.dataclass
class FitState:
    """The whole state of :class:`FitLoop`'s loop between two steps: the
    model (the pool, when densifying), its optimizer, the background
    generator and, when densifying, the viewspace-gradient accumulator, the
    split-sample generator and the scene extent the pass sizes against."""

    model: GaussianModel
    optimizer: torch.optim.Adam
    bg_rng: np.random.Generator
    dstate: Optional[D.DensifyState] = None
    generator: Optional[torch.Generator] = None
    extent: Optional[float] = None


class StepResult(NamedTuple):
    """What one :meth:`FitLoop.fit_step` did."""

    metrics: Dict[str, torch.Tensor]  # loss, psnr: 0-d on the device, of the frame before the update
    image: Optional[torch.Tensor]  # that frame on its background [H, W, 3] (None where it is sharded)
    record: Optional[Dict[str, float]]  # the history record, on a step that logs one
    densified: Optional[tuple]  # at a pass: (the accumulator it read, the rows it touched [C], its stats)


class FitLoop:
    """The loop that :class:`Trainer` and ``parallel.shard.ParallelTrainer``
    share: resume, the densify pool, SH warmup, the background draws, the
    densify and opacity-reset schedule, the history, the capacity re-checks
    and the loop checkpoints. A trainer provides ``raster``, ``train``,
    ``show_progress`` and ``_bg_rng`` and the hooks below: each step trains
    on ``_views_per_step()`` views taken round-robin.

    ``fit`` runs the whole loop. ``init_fit`` and ``fit_step`` are its parts:
    the state before the first step, and one step on that state."""

    _desc = "finetune"  # the progress bar's label
    _main = True  # this process logs and calls ``log_fn``

    def _views_per_step(self) -> int:
        return 1

    def _start(self, model, views, resumed: bool) -> None:
        """Before the first step (after a restore, when ``resumed``)."""

    def _begin(self, model, views, start_step: int) -> None:
        """Once the pool and optimizer exist: the first capacity check."""
        raise NotImplementedError

    def _train_views(self, model, optimizer, views, idx, bg, sh_degree, with_vs):
        """One update on ``views[i] for i in idx``. Returns (metrics, the
        densify samples ``[(viewspace gradient [C, 2], width, height, radii
        [C]), ...]``, one per view when ``with_vs``, else none; the frame
        on its background, or None where it is sharded)."""
        raise NotImplementedError

    def _recheck(self, model, views, idx) -> None:
        """Re-check the pair budget on ``views[i] for i in idx``."""
        raise NotImplementedError

    def _save(self, checkpoint_dir, *state) -> None:
        CK.save_loop_state(checkpoint_dir, *state)

    def init_fit(
        self,
        model: GaussianModel,
        views: Sequence[Tuple[CameraParams, torch.Tensor]],
        checkpoint_dir: Optional[str] = None,
        resume: bool = False,
    ) -> Tuple[FitState, int]:
        """The loop's state before its first step, and that step's number:
        ``model`` (copied into the densify pool with ``train.densify``) and a
        fresh optimizer, or with ``resume`` the state saved under
        ``checkpoint_dir`` (as :meth:`fit` says). Makes the first capacity
        check."""
        dc = self.train.densify
        dev = model.means.device
        dstate = generator = optimizer = extent = None
        start_step = 0
        resumed = bool(resume and checkpoint_dir and CK.has_loop_state(checkpoint_dir))
        if resumed:
            model, optimizer, start_step, dstate, generator = CK.restore_loop_state(
                checkpoint_dir, lambda m: make_optimizer(m, self.train), device=dev
            )
            if self._main:
                logger.info("resumed from %s at step %d", CK.loop_state_path(checkpoint_dir), start_step)
            if self.train.background == "random":
                # Replay the numpy RNG to the resume point, so the background
                # sequence goes on where the interrupted run left it.
                for _ in range(start_step):
                    self._bg_rng.uniform(size=3)
        self._start(model, views, resumed)
        if dc is not None:
            extent = D.camera_extent([c for c, _ in views])
            if optimizer is None:
                model = D.init_pool(model, dc)
                dstate = D.DensifyState.zero(model.num_gaussians, dev)
                generator = torch.Generator(device=dev).manual_seed(0)
        if optimizer is None:
            optimizer = make_optimizer(model, self.train)
        self._begin(model, views, start_step)
        return FitState(model, optimizer, self._bg_rng, dstate, generator, extent), start_step

    def fit_step(
        self,
        state: FitState,
        step: int,
        views: Sequence[Tuple[CameraParams, torch.Tensor]],
        steps: Optional[int] = None,
        log_fn=None,
    ) -> StepResult:
        """Loop step ``step`` of :meth:`fit` (of ``steps``), on ``state`` in
        place: the background draw; the update on this step's views, with
        the viewspace probe when densifying; the probe's accumulation; at
        the densify cadence the clone/split/prune pass, its optimizer rows
        reset and the capacity re-check; at its cadence the opacity reset;
        every ``log_every`` steps and at the last one the history record
        (handed to ``log_fn``) and, past step 0, the capacity re-check."""
        steps = steps if steps is not None else self.train.steps
        dc = self.train.densify
        dev = state.model.means.device
        per = self._views_per_step()
        idx = [(step * per + i) % len(views) for i in range(per)]
        # 3DGS SH warmup: view-dependent colour is introduced band by band.
        deg = self.raster.sh_degree
        if self.train.sh_warmup_every > 0:
            deg = min(step // self.train.sh_warmup_every, deg)
        record = densified = None
        with stages.step(step):
            bg = background(self.train, state.bg_rng, dev)
            metrics, samples, image = self._train_views(
                state.model, state.optimizer, views, idx, bg, deg, dc is not None
            )
            if dc is not None:
                with stage("densify_stats"):
                    for vs_grad, width, height, radii in samples:
                        state.dstate = D.accumulate(state.dstate, vs_grad, width, height, radii)
                if dc.start <= step < dc.until and step > 0 and step % dc.every == 0:
                    with stage("densify"):
                        _, touched, dstats = D.densify_prune_step(
                            state.model, state.dstate, state.generator, state.extent, dc, step=step
                        )
                        with stage("densify_reset"):
                            D.reset_opt_rows(state.optimizer, touched)
                    densified = (state.dstate, touched, dstats)
                    state.dstate = D.DensifyState.zero(state.model.num_gaussians, dev)
                    if self._main:
                        logger.info(
                            "densify @%d: +%d clone +%d split -%d prune (%d alive)",
                            step, dstats["cloned"], dstats["split"], dstats["pruned"], dstats["alive"],
                        )
                    # Clones and splits grow the pair demand.
                    self._recheck(state.model, views, idx)
                if dc.opacity_reset_every and step > 0 and step % dc.opacity_reset_every == 0:
                    with stage("opacity_reset"):
                        D.reset_opacity(state.model)
            if step % self.train.log_every == 0 or step == steps - 1:
                record = {k: float(v) for k, v in metrics.items()}
                record["step"] = step
                if log_fn is not None and self._main:
                    log_fn(record)
                if step > 0:  # splats grow during training; re-check budget
                    self._recheck(state.model, views, idx[:1])
        return StepResult(metrics, image, record, densified)

    def fit(
        self,
        model: GaussianModel,
        views: Sequence[Tuple[CameraParams, torch.Tensor]],
        steps: Optional[int] = None,
        log_fn=None,
        checkpoint_dir: Optional[str] = None,
        resume: bool = False,
    ) -> Tuple[GaussianModel, List[Dict[str, float]]]:
        """Round-robin over (camera, ground-truth image ``[H, W, 3]``) views.
        Returns (model, history), one history record every ``log_every``
        steps and at the last step.

        Without densification the given ``model`` is updated in place and
        returned. With ``train.densify`` it is first copied into a
        fixed-capacity pool (``train/densify.py``); the viewspace gradient
        and projected radii are accumulated every step, the clone/split/prune
        pass runs at the configured cadence, and the returned model is the
        pool compacted to its live gaussians.

        With ``checkpoint_dir`` the whole loop state (model, optimizer,
        next step, densify accumulator and generator) is saved to
        ``<dir>/train_state.pt`` every ``train.checkpoint_every`` steps and
        at the end; ``resume=True`` restores it, when present, in place of
        ``model`` (on ``model``'s device) and continues from the saved step
        with the same view rotation and random draws, so an interrupted run
        reaches the parameters of an uninterrupted one. History then covers
        the resumed steps only.
        """
        steps = steps if steps is not None else self.train.steps
        state, start_step = self.init_fit(model, views, checkpoint_dir, resume)
        history: List[Dict[str, float]] = []
        for step in progress(range(start_step, steps), desc=self._desc, enabled=self.show_progress):
            record = self.fit_step(state, step, views, steps, log_fn).record
            if record is not None:
                history.append(record)
            if (checkpoint_dir and self.train.checkpoint_every > 0
                    and (step + 1) % self.train.checkpoint_every == 0 and step + 1 < steps):
                self._save(checkpoint_dir, state.model, state.optimizer, step + 1, state.dstate, state.generator)
        if checkpoint_dir:
            # The final state, before compaction (the densify state describes
            # the pool): a later resume with more steps continues from here.
            self._save(checkpoint_dir, state.model, state.optimizer, steps, state.dstate, state.generator)
        if self.train.densify is not None:
            return D.compact(state.model), history
        return state.model, history


@dataclasses.dataclass
class Trainer(FitLoop):
    """Single-device trainer.

    ``auto_pairs``: the pair buffer has a fixed capacity
    (``raster.max_pairs``); a denser scene would silently drop its deepest
    splats (ops/binning.py overflow policy) and train on a truncated scene.
    ``fit`` therefore checks the measured pair demand on its first step and
    every ``log_every`` steps; on overflow it warns and, with
    ``auto_pairs``, resizes the budget to the next power of two above
    ``demand * 1.5``.
    """

    raster: RasterConfig
    train: TrainConfig
    auto_pairs: bool = True
    show_progress: bool = True

    def __post_init__(self):
        check_background(self.train)
        self._bg_rng = np.random.default_rng(0)
        self._steps_taken = 0  # train_step's step id

    def init_state(self, model: GaussianModel) -> torch.optim.Adam:
        """The optimizer over ``model``'s parameters (the loop's state)."""
        return make_optimizer(model, self.train)

    def draw_background(self, device) -> torch.Tensor:
        """This step's background colour ``[3]`` on ``device`` (:func:`background`)."""
        return background(self.train, self._bg_rng, device)

    def _step(self, model, optimizer, cam, target, bg, width, height, cfg, screen_offset=None):
        """One update. Returns (metrics, the preprocess of the model before
        the update, the frame on its background); ``screen_offset`` is
        passed to the render."""
        optimizer.zero_grad(set_to_none=True)
        with stage("forward"):
            image, trans, prep = render_with_preprocess(model, cam, width, height, cfg, screen_offset)
            image = image + trans[..., None] * bg
        loss = rgb_loss(image, target, self.train.ssim_weight)
        with stage("backward"):
            loss.backward()
        with stage("optimizer"):
            optimizer_step(optimizer, self.train)
        image = image.detach()
        with torch.no_grad():
            return {"loss": loss.detach(), "psnr": psnr(image, target)}, prep, image

    def _step_vs(self, model, optimizer, cam, target, bg, width, height, cfg):
        """The densifying step: also differentiates the loss with respect to
        an all-zero pixel-space offset on the projected means, 3DGS's
        viewspace gradient, and reads the view's projected radii (the input
        of the screen-size prune) from the render's own preprocess of the
        model before the update. Returns (metrics, viewspace gradient
        ``[C, 2]``, radii ``[C]``, the frame on its background)."""
        offset = torch.zeros((model.num_gaussians, 2), dtype=model.means.dtype, device=model.means.device,
                             requires_grad=True)
        metrics, prep, image = self._step(model, optimizer, cam, target, bg, width, height, cfg, offset)
        with torch.no_grad(), stage("densify_stats"):
            radii = D.screen_radii(prep.conics, prep.active)
        return metrics, offset.grad, radii, image

    def train_step(
        self,
        model: GaussianModel,
        optimizer: torch.optim.Adam,
        camera: CameraParams,
        target: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        """One optimization step against one view; updates ``model`` (and
        ``optimizer``) in place. Returns ``loss`` and ``psnr`` (of the image
        before the update) as 0-d tensors on the model's device, without a
        host synchronisation."""
        dev = model.means.device
        self._steps_taken += 1
        with stages.step(self._steps_taken - 1):
            with stage("camera"):
                cam = CameraArrays.from_params(camera, dtype=model.means.dtype, device=dev)
                bg = self.draw_background(dev)
            return self._step(model, optimizer, cam, target, bg, camera.width, camera.height, self.raster)[0]

    def check_capacity(self, model: GaussianModel, camera: CameraParams) -> RasterConfig:
        """Warn on pair-buffer overflow for this (model, view); returns the
        (possibly resized, power-of-two) raster config. Also updates
        ``self.raster`` so later steps use the new budget. One host sync."""
        cam = CameraArrays.from_params(camera, dtype=model.means.dtype, device=model.means.device)
        with torch.no_grad():
            stats = binning_stats(model, cam, camera.width, camera.height, self.raster)
        with sync("capacity_check"):
            demand = int(stats["pair_demand"])
        if demand > self.raster.max_pairs:
            target = required_max_pairs(demand)
            if self.auto_pairs:
                logger.warning(
                    "pair buffer overflow (demand %d > capacity %d): resizing max_pairs to %d",
                    demand, self.raster.max_pairs, target,
                )
                self.raster = dataclasses.replace(self.raster, max_pairs=target)
            else:
                logger.warning(
                    "pair buffer overflow (demand %d > capacity %d): the deepest "
                    "splats are being dropped; raise max_pairs (suggested: %d) or "
                    "enable auto_pairs",
                    demand, self.raster.max_pairs, target,
                )
        return self.raster

    def _begin(self, model, views, start_step):
        self.check_capacity(model, views[start_step % len(views)][0])

    def _train_views(self, model, optimizer, views, idx, bg, sh_degree, with_vs):
        camera, target = views[idx[0]]
        cfg = self.raster
        if sh_degree != cfg.sh_degree:
            cfg = dataclasses.replace(cfg, sh_degree=sh_degree)
        cam = CameraArrays.from_params(camera, dtype=model.means.dtype, device=model.means.device)
        args = (model, optimizer, cam, target, bg, camera.width, camera.height, cfg)
        if not with_vs:
            metrics, _, image = self._step(*args)
            return metrics, [], image
        metrics, vs_grad, radii, image = self._step_vs(*args)
        return metrics, [(vs_grad, camera.width, camera.height, radii)], image

    def _recheck(self, model, views, idx):
        self.check_capacity(model, views[idx[0]][0])
