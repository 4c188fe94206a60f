"""Fine-tuning loop: optimize splat parameters against ground-truth views.

The 3DGS recipe, as in ``gsplat_tpu/train/trainer.py``: per-parameter
learning rates, Adam, L1 + D-SSIM loss. One step renders the view with
gradients on, composites it onto the background through its
transmittance, takes the loss, runs the backward (the hand-written
backward compositor, then autograd through the preprocess) and updates
the model in place.

Not ported yet: densification (``TrainConfig.densify``) and checkpointing
of the loop state (``checkpoint_dir``); both raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.config import RasterConfig, TrainConfig
from gsplat_tpu_torch.models.gaussians import GaussianModel
from gsplat_tpu_torch.ops.camera import CameraArrays, CameraParams, camera_center
from gsplat_tpu_torch.render.pipeline import binning_stats, render_traced, required_max_pairs
from gsplat_tpu_torch.train.loss import psnr, rgb_loss
from gsplat_tpu_torch.utils.logging import get_logger
from gsplat_tpu_torch.utils.progress import progress
from gsplat_tpu_torch.utils.stages import stage

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


@dataclasses.dataclass
class Trainer:
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
        if self.train.background not in ("black", "white", "random"):
            raise ValueError(
                f"TrainConfig.background must be black|white|random, got {self.train.background!r}"
            )
        self._bg_rng = np.random.default_rng(0)

    def init_state(self, model: GaussianModel) -> torch.optim.Adam:
        """The optimizer over ``model``'s parameters (the loop's state)."""
        return make_optimizer(model, self.train)

    def draw_background(self, device) -> torch.Tensor:
        """This step's background colour ``[3]`` on ``device``, per ``TrainConfig.background``
        ("random" draws a fresh colour from the trainer's numpy RNG, as the
        JAX trainer does, so both draw the same colours)."""
        if self.train.background == "white":
            return torch.ones(3, device=device)
        if self.train.background == "random":
            colour = torch.from_numpy(self._bg_rng.uniform(size=3).astype(np.float32))
            return colour.to(device, non_blocking=True)
        return torch.zeros(3, device=device)

    def _step(self, model, optimizer, cam, target, bg, width, height, cfg) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        with stage("forward"):
            image, trans = render_traced(model, cam, width, height, cfg)
            image = image + trans[..., None] * bg
        with stage("loss"):
            loss = rgb_loss(image, target, self.train.ssim_weight)
        with stage("backward"):
            loss.backward()
        with stage("optimizer"):
            optimizer_step(optimizer, self.train)
        with torch.no_grad():
            return {"loss": loss.detach(), "psnr": psnr(image, target)}

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
        with stage("camera"):
            cam = CameraArrays.from_params(camera, dtype=model.means.dtype, device=dev)
            bg = self.draw_background(dev)
        return self._step(model, optimizer, cam, target, bg, camera.width, camera.height, self.raster)

    def check_capacity(self, model: GaussianModel, camera: CameraParams) -> RasterConfig:
        """Warn on pair-buffer overflow for this (model, view); returns the
        (possibly resized, power-of-two) raster config. Also updates
        ``self.raster`` so later steps use the new budget. One host sync."""
        cam = CameraArrays.from_params(camera, dtype=model.means.dtype, device=model.means.device)
        with torch.no_grad():
            stats = binning_stats(model, cam, camera.width, camera.height, self.raster)
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

    def fit(
        self,
        model: GaussianModel,
        views: Sequence[Tuple[CameraParams, torch.Tensor]],
        steps: Optional[int] = None,
        log_fn=None,
        checkpoint_dir: Optional[str] = None,
    ) -> Tuple[GaussianModel, List[Dict[str, float]]]:
        """Round-robin over (camera, ground-truth image ``[H, W, 3]``) views,
        updating ``model`` in place. Returns (model, history), one history
        record every ``log_every`` steps and at the last step (the only
        host syncs of the loop besides the capacity checks)."""
        if checkpoint_dir:
            raise NotImplementedError("checkpointing the training loop is not ported yet")
        steps = steps if steps is not None else self.train.steps
        optimizer = self.init_state(model)
        history: List[Dict[str, float]] = []
        self.check_capacity(model, views[0][0])
        for step in progress(range(steps), desc="finetune", enabled=self.show_progress):
            camera, target = views[step % len(views)]
            # 3DGS SH warmup: view-dependent colour is introduced band by band.
            step_cfg = self.raster
            if self.train.sh_warmup_every > 0:
                deg = min(step // self.train.sh_warmup_every, self.raster.sh_degree)
                if deg != self.raster.sh_degree:
                    step_cfg = dataclasses.replace(self.raster, sh_degree=deg)
            dev = model.means.device
            cam = CameraArrays.from_params(camera, dtype=model.means.dtype, device=dev)
            metrics = self._step(
                model, optimizer, cam, target, self.draw_background(dev),
                camera.width, camera.height, step_cfg,
            )
            if step % self.train.log_every == 0 or step == steps - 1:
                record = {k: float(v) for k, v in metrics.items()}
                record["step"] = step
                history.append(record)
                if log_fn is not None:
                    log_fn(record)
                if step > 0:  # splats grow during training; re-check budget
                    self.check_capacity(model, views[step % len(views)][0])
        return model, history
