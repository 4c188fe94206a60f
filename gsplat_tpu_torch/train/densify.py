"""Adaptive density control: the 3DGS clone / split / prune recipe on a
fixed-capacity pool, as in ``gsplat_tpu/train/densify.py``.

The model lives in a pool of ``pool_capacity`` rows (``init_pool``): dead
slots carry ``DEAD_OPACITY_LOGIT`` (sigmoid ~ 1e-13), which empties their
alpha-cull rect, so they emit no (tile, gaussian) pair. A pass never
reshapes the parameters, so the optimizer keeps its ``nn.Parameter``s and
the pass writes its rows into them in place:

  * prune: collapse the opacity of low-opacity (and, past
    ``size_prune_start``, oversized) gaussians, freeing their slots;
  * clone/split: candidates (mean viewspace gradient over the window at or
    above ``grad_threshold``) are matched to free slots by two stable
    sorts: the i-th best candidate fills the i-th free slot, for
    i < min(#candidates, #free);
  * clone (small splat): the new slot is an exact copy;
  * split (large splat): the original and the new slot both shrink by
    ``split_factor``; the new slot's mean is sampled from the original
    gaussian, the original keeps its mean.

The viewspace gradient is the gradient of the loss with respect to an
all-zero pixel-space offset on the projected means (``screen_offset`` of
``render/pipeline.py``), the quantity 3DGS accumulates.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.config import GAUSSIAN_SPREAD, DensifyConfig
from gsplat_tpu_torch.models.gaussians import DEAD_OPACITY_LOGIT, PARAM_NAMES, GaussianModel, pad_model
from gsplat_tpu_torch.ops.quaternion import quaternion_to_rotation_matrix
from gsplat_tpu_torch.utils import stages

# A slot counts as alive while its raw logit is above this; prune writes
# DEAD_OPACITY_LOGIT and all pool padding starts there.
_ALIVE_THRESHOLD = DEAD_OPACITY_LOGIT + 1.0


class DensifyState(NamedTuple):
    """Per-slot viewspace-gradient accumulator between densify passes."""

    grad_sum: torch.Tensor  # [C] f32 sum of per-step viewspace grad norms
    grad_count: torch.Tensor  # [C] int32 steps in which the gaussian got any gradient
    max_radius: torch.Tensor  # [C] f32 max projected radius (px) over the window

    @staticmethod
    def zero(capacity: int, device) -> "DensifyState":
        return DensifyState(
            grad_sum=torch.zeros((capacity,), dtype=torch.float32, device=device),
            grad_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
            max_radius=torch.zeros((capacity,), dtype=torch.float32, device=device),
        )


def alive_mask(model: GaussianModel) -> torch.Tensor:
    return model.opacity_logits.detach() > _ALIVE_THRESHOLD


def num_alive(model: GaussianModel) -> torch.Tensor:
    return alive_mask(model).sum(dtype=torch.int32)


def pool_capacity(n_initial: int, cfg: DensifyConfig) -> int:
    """The pool size: ``pool_factor`` times the initial count, rounded up to
    a multiple of 256 rows."""
    cap = int(n_initial * cfg.pool_factor)
    return max(-(-cap // 256) * 256, 256)


def init_pool(model: GaussianModel, cfg: DensifyConfig) -> GaussianModel:
    return pad_model(model, pool_capacity(model.num_gaussians, cfg))


def screen_radii(conics: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Projected splat radius in pixels, 3DGS's ``max_radii2D`` quantity:
    ``ceil(3 * sqrt(max eigenvalue of the 2D covariance))``, from the conic
    (the covariance's inverse) as ``max_eig(cov) = 1 / min_eig(conic)``.
    Inactive or degenerate splats report radius 0."""
    cx, cy, cxy = conics[:, 0], conics[:, 1], conics[:, 2]
    half_tr = 0.5 * (cx + cy)
    det = cx * cy - cxy * cxy
    disc = torch.sqrt((half_tr * half_tr - det).clamp(min=0.0))
    min_eig = half_tr - disc
    ok = active & (min_eig > 0.0)
    r = GAUSSIAN_SPREAD * torch.sqrt(1.0 / min_eig.clamp(min=1e-30))
    return torch.where(ok, torch.ceil(r), 0.0)


def accumulate(
    state: DensifyState, screen_grad: torch.Tensor, width: int, height: int, radii=None
) -> DensifyState:
    """Fold one step's viewspace gradient (``[C, 2]``, from the zero-offset
    probe) into the accumulator. Only gaussians that received any gradient
    count toward the mean.

    The probe's pixel-space gradients are rescaled per axis to the NDC
    scale that 3DGS's ``grad_threshold`` convention applies to (pix =
    (ndc+1)*W/2, so dL/d_ndc = dL/d_pix * W/2)."""
    gx = screen_grad[:, 0] * (0.5 * width)
    gy = screen_grad[:, 1] * (0.5 * height)
    norm = torch.sqrt(gx * gx + gy * gy)
    return DensifyState(
        grad_sum=state.grad_sum + norm,
        grad_count=state.grad_count + (norm > 0.0).to(torch.int32),
        max_radius=state.max_radius if radii is None else torch.maximum(state.max_radius, radii),
    )


def densify_prune_step(
    model: GaussianModel,
    state: DensifyState,
    generator: torch.Generator,
    scene_extent: float,
    cfg: DensifyConfig,
    step: int = 0,
) -> Tuple[GaussianModel, torch.Tensor, Dict[str, int]]:
    """One clone/split/prune pass over the pool, written into ``model``'s
    parameters in place. Returns (model, touched ``[C]`` bool, stats).

    The split samples are ``C`` standard normal rows drawn from
    ``generator`` (on the model's device); row ``i`` offsets the new half
    of the ``i``-th candidate. The prune rule is the full 3DGS one: low
    opacity always; from ``cfg.size_prune_start`` on (with
    ``cfg.max_screen_size > 0``) also any gaussian whose largest
    world-space scale exceeds ``prune_scale_extent * scene_extent`` or whose
    largest projected radius over the window (``state.max_radius``) exceeds
    ``max_screen_size`` pixels."""
    return _densify_prune_step(model, state, generator, scene_extent, cfg, step)


@torch.no_grad()
def _densify_prune_step(model, state, eps, scene_extent, cfg, step):
    """``densify_prune_step`` with its split samples ``eps [C, 3]`` given, or
    the generator to draw them from.

    Spans (``utils/stages.py``), inside the caller's ``densify``:
    ``densify_select`` (the masks, the mean gradient, the counts' host read
    and the two stable sorts) and ``densify_rows`` (the split samples'
    draw, the new rows' gathers and writes, the originals' shrink); the
    counter ``filled`` is the number of rows placed."""
    c = model.num_gaussians
    dev = model.means.device
    params = {k: getattr(model, k) for k in PARAM_NAMES}
    # Every setting and the extent as an f32 tensor, as the JAX package
    # takes them (weakly typed f32): PyTorch compares an f32 tensor with a
    # Python float at the float's own precision, so a value at f32(x) would
    # fall on the other side of x.
    def f32(value):
        return torch.tensor(value, dtype=torch.float32, device=dev)

    extent = f32(scene_extent)

    with stages.stage("densify_select"):
        alive = alive_mask(model)
        opacity = torch.sigmoid(params["opacity_logits"])
        max_scale = torch.exp(params["log_scales"].amax(dim=-1))
        prune = alive & (opacity < f32(cfg.min_opacity))
        if cfg.max_screen_size > 0 and step >= cfg.size_prune_start:
            big_ws = max_scale > extent * f32(cfg.prune_scale_extent)
            big_vs = state.max_radius > f32(cfg.max_screen_size)
            prune = prune | (alive & (big_ws | big_vs))
        alive = alive & ~prune

        avg_grad = state.grad_sum / state.grad_count.clamp(min=1)
        want = alive & (state.grad_count > 0) & (avg_grad >= f32(cfg.grad_threshold))
        is_split = want & (max_scale > extent * f32(cfg.percent_dense))

        # Match the i-th best candidate with the i-th free slot: two stable
        # sorts (free slots in slot order; candidates by falling avg_grad, ties
        # and non-candidates in slot order). `+ 0.0` turns -0.0 into 0.0, which
        # the JAX sort treats as equal.
        free_count, want_count = (~alive).sum(), want.sum()
        with stages.sync("densify_sync"):
            n_free, n_want = int(free_count), int(want_count)
        k = min(n_free, n_want)
        dst = torch.sort(alive.to(torch.int32), stable=True).indices[:k]
        src = torch.sort(torch.where(want, -avg_grad + 0.0, math.inf), stable=True).indices[:k]
    stages.count("filled", k)

    with stages.stage("densify_rows"):
        if isinstance(eps, torch.Generator):
            eps = torch.randn((c, 3), generator=eps, dtype=params["means"].dtype, device=dev)
        # New-slot parameters, gathered before any write.
        src_split = is_split[src]
        log_split = f32(math.log(cfg.split_factor))
        shrink = torch.where(src_split, -log_split, 0.0)
        new_log_scales = params["log_scales"][src] + shrink[:, None]
        # Split sample: mean + R @ (scale * eps), eps row i for candidate i. The
        # norm and the product are spelled out elementwise (no reduction or
        # matmul kernel), so the card and the CPU round them alike.
        scaled = torch.exp(params["log_scales"][src]) * eps[:k]
        q = params["quats"][src]
        norm = torch.sqrt(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2] + q[:, 3] * q[:, 3])
        rot = quaternion_to_rotation_matrix(q / norm.clamp(min=1e-12)[:, None])
        offset = rot[:, :, 0] * scaled[:, 0:1] + rot[:, :, 1] * scaled[:, 1:2] + rot[:, :, 2] * scaled[:, 2:3]
        new_means = params["means"][src] + torch.where(src_split[:, None], offset, 0.0)
        new_rows = {
            "means": new_means,
            "log_scales": new_log_scales,
            "quats": params["quats"][src],
            "opacity_logits": params["opacity_logits"][src],
            "sh": params["sh"][src],
        }

        params["opacity_logits"].masked_fill_(prune, DEAD_OPACITY_LOGIT)
        for name, value in new_rows.items():
            params[name][dst] = value
        # The split original shrinks too (its slot keeps its mean), but only if
        # its new half got a free slot: the i-th candidate is placed iff i < k.
        placed = torch.zeros((c,), dtype=torch.bool, device=dev)
        placed[src] = True
        shrink_orig = is_split & placed
        params["log_scales"][shrink_orig] -= log_split

    # Rows whose parameters or liveness changed: the trainer zeroes their
    # optimizer moments (a reused slot must not inherit stale Adam state).
    touched = prune | shrink_orig
    touched[dst] = True

    counts = {"pruned": prune.sum(), "cloned": (placed & ~is_split).sum(), "split": (placed & is_split).sum(),
              "wanted": n_want, "alive": num_alive(model)}
    for name, value in counts.items():
        stages.count("densify_wanted" if name == "wanted" else name, value)
    with stages.sync("densify_sync"):
        stats = {name: int(value) for name, value in counts.items()}
    return model, touched, stats


@torch.no_grad()
def reset_opacity(model: GaussianModel, ceiling: float = 0.01) -> GaussianModel:
    """3DGS opacity reset, in place: clamp every live gaussian's opacity to
    at most ``ceiling`` (stale occluders must earn their opacity again)."""
    cap = math.log(ceiling) - math.log1p(-ceiling)  # logit(ceiling)
    logits = model.opacity_logits
    logits.copy_(torch.where(alive_mask(model), logits.clamp(max=cap), logits))
    return model


@torch.no_grad()
def reset_opt_rows(optimizer: torch.optim.Optimizer, mask: torch.Tensor) -> None:
    """Zero, in place, the optimizer-state rows of re-allocated slots (a
    reused slot must not inherit the dead gaussian's Adam moments): every
    state tensor whose leading dimension is the pool's. Adam's ``step``
    (0-d) is left alone, as optax leaves its ``count``."""
    c = mask.shape[0]
    for state in optimizer.state.values():
        for value in state.values():
            if torch.is_tensor(value) and value.ndim >= 1 and value.shape[0] == c:
                value.masked_fill_(mask.reshape((c,) + (1,) * (value.ndim - 1)), 0.0)


def camera_extent(cameras: Sequence) -> float:
    """3DGS scene extent: 1.1x the radius of the camera-position cloud."""
    centers = []
    for cam in cameras:
        q = np.asarray(cam.qvec, np.float64)
        q = q / np.linalg.norm(q)
        w, x, y, z = q
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        centers.append(-r.T @ np.asarray(cam.tvec, np.float64))
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - center, axis=1).max())
    return 1.1 * max(radius, 1e-6)


def compact(model: GaussianModel) -> GaussianModel:
    """The live slots alone, in slot order, as a new model on the same
    device (for export)."""
    keep = alive_mask(model)
    return GaussianModel(*(getattr(model, k).detach()[keep] for k in PARAM_NAMES))
