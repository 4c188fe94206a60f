"""Plain-PyTorch reference of one iteration of the 3DGS training recipe
(Kerbl et al. 2023, arXiv 2308.04079; the Inria ``gaussian-splatting``
``train.py`` with its ``OptimizationParams`` defaults), from a restored
loop state: the frame composited onto the background through its
transmittance, L1 + 0.2 D-SSIM, the gradients, the viewspace gradient's
accumulation with the projected radii, Adam at iteration ``k`` with the
per-parameter rates, and the decisions of the clone / split / prune pass
that a pass step takes after the update.

It imports nothing but ``torch``, ``numpy`` and the benchmark's own
reference (``render.py``'s ``project``, ``_plan`` and ``_slice``;
``loss.py``), and runs in the dtype it is given: float64 for the reference,
with TF32 off while it runs (``no_tf32``; float64 never takes it).

The loop state it starts from is the one the benchmark restores before
each step, rebuilt from the scene and the configuration:

  * the model: the scene's ``N`` gaussians, live, in the first rows of a
    pool of ``C`` rows (``pool_rows``); the other rows are dead (they emit
    no pair, get no gradient and do not move) and are free slots to a pass;
  * Adam: first moments 0, second moments a per-group constant (the
    configuration's ``adam_v``), ``k`` earlier steps (the update is step
    ``k + 1``'s bias correction), the position rate at ``k`` on its
    schedule;
  * the accumulator: empty, so a pass reads this step's viewspace gradient
    alone (``grad_count`` is 1 wherever the gradient is not zero).

Departures from the published recipe:

  * the restored state above, in place of 7,550 iterations of history;
  * one SH rate for all 16 bands (the Inria trainer gives the 15 higher
    bands 1/20 of it): the work is the same;
  * Adam's eps is 1e-8, the program's (optax's default), where the Inria
    trainer gives 1e-15;
  * the radius (``max_radii2D``) is 3 standard deviations along the 2D
    covariance's larger axis, rounded up, with no 0.1 floor under the
    discriminant (the Inria rasterizer's numerical guard);
  * the pass's thresholds are compared in the working precision;
  * the pass is given as its decisions and counts (which rows are pruned,
    which are candidates, which split, which get a slot, which slots are
    filled): the split samples drawn for the new halves and the parameters
    written into the filled slots are not computed. Near-equal candidates
    rank differently in float32 and float64, so the samples they draw and
    the slots they fill are not comparable slot by slot.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from splatbench.reference import loss as ref_loss
from splatbench.reference.render import BLOCK, GAUSSIAN_SPREAD, Camera, Counts, _plan, _slice, project

BETAS = (0.9, 0.999)  # Adam's published defaults, as the Inria trainer takes them
ADAM_EPS = 1e-8  # the program's (optax's default); the Inria trainer's is 1e-15
PARAM_NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")
LR_NAMES = ("lr_means", "lr_scales", "lr_quats", "lr_opacity", "lr_sh")


class Step(NamedTuple):
    """One recipe iteration from the restored state."""

    image: torch.Tensor  # [H, W, 3] on the background
    loss: torch.Tensor  # 0-d
    update: List[torch.Tensor]  # each raw parameter's change over the N live rows (the dead rows do not move)
    vs: torch.Tensor  # [N] the accumulated viewspace-gradient norm, NDC scale
    radii: torch.Tensor  # [N] the accumulated largest radius, pixels
    stats: Dict[str, int]  # the pass's counts, had this step been a pass step
    touched: torch.Tensor  # [C] bool: the rows that pass writes
    counts: Counts  # the view's compositing work


def pool_rows(n: int, pool_factor: float) -> int:
    """The pool's rows: ``pool_factor`` times the scene's, up to a multiple
    of 256."""
    return max(-(-int(n * pool_factor) // 256) * 256, 256)


def extent(cams: List[Camera]) -> float:
    """3DGS's ``cameras_extent``: 1.1 times the largest distance of a
    camera centre from the centres' mean."""
    centers = torch.stack([c.center.double().cpu() for c in cams])
    return 1.1 * max(float((centers - centers.mean(0)).norm(dim=1).max()), 1e-6)


def means_lr(recipe: dict, scene_extent: float, k: int) -> float:
    """The position rate after ``k`` updates: log-linear from ``lr_means`` to
    ``lr_means_final`` (both times the extent) over ``lr_means_steps``."""
    t = min(k / recipe["lr_means_steps"], 1.0)
    return recipe["lr_means"] * scene_extent * (recipe["lr_means_final"] / recipe["lr_means"]) ** t


def radii(feat: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Each gaussian's radius in pixels, 0 where it is not drawn: no
    covering 16-pixel block inside the frame, or a zero conic (culled or
    degenerate)."""
    with torch.no_grad():
        mx, my, cx, cy, cxy = feat[:, 0], feat[:, 1], feat[:, 2], feat[:, 3], feat[:, 4]
        det_conic = cx * cy - cxy * cxy
        ok = (feat[:, 2:5] != 0).all(-1) & (det_conic > 0)
        inv = 1.0 / torch.where(ok, det_conic, torch.ones_like(det_conic))
        a, c, b = cy * inv, cx * inv, -cxy * inv  # the covariance, the conic's inverse
        half = (a + c) / 2.0
        det = a * c - b * b
        spread = torch.ceil(GAUSSIAN_SPREAD * torch.sqrt(half + torch.sqrt(torch.clamp(half * half - det, min=0.1))))

        def px(v, limit):
            return torch.clamp(torch.floor(torch.clamp(v / BLOCK, 0, limit - 1)) * BLOCK, 0, limit - 1)

        area = ((px(mx + spread + BLOCK - 1, cam.width) - px(mx - spread, cam.width))
                * (px(my + spread + BLOCK - 1, cam.height) - px(my - spread, cam.height)))
        r = torch.ceil(GAUSSIAN_SPREAD * torch.sqrt(half + torch.sqrt(torch.clamp(half * half - det, min=0.0))))
        return torch.where(ok & (area > 0), r, torch.zeros_like(r))


def gradients(params, cam: Camera, sh_degree: int, stop: float, bg: torch.Tensor, target: torch.Tensor,
              ssim_weight: float, entries: int):
    """The frame on the background ``bg [3]`` through its transmittance,
    the loss against ``target`` and its gradients. Returns (image, loss,
    gradients of the raw parameters, gradient of the pixel-space means
    [N, 2], Projected, Counts)."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    proj = project(leaves, cam, sh_degree)
    feat = proj.feat.detach().requires_grad_(True)
    with torch.no_grad():
        color, t, slices, counts = _plan(proj, cam.width, cam.height, stop, entries, feat)
    color = color.detach().requires_grad_(True)
    t = t.detach().requires_grad_(True)
    image = color.reshape(cam.height, cam.width, 3) + t.reshape(cam.height, cam.width, 1) * bg
    loss = ref_loss.rgb_loss(image, target, ssim_weight)
    g_color, g_t = torch.autograd.grad(loss, [color, t])
    for ids, t_in in reversed(slices):
        t_leaf = t_in.detach().requires_grad_(True)
        added, t_out, _ = _slice(feat, ids, proj.box, t_leaf, cam.width, stop)
        torch.autograd.backward([added, t_out], [g_color, g_t])
        g_t = t_leaf.grad
    g_feat = feat.grad if feat.grad is not None else torch.zeros_like(feat)
    grads = torch.autograd.grad(proj.feat, leaves, g_feat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return image.detach(), loss.detach(), grads, g_feat[:, :2], proj, counts


def adam_update(params, grads, recipe: dict, scene_extent: float, k: int) -> List[torch.Tensor]:
    """Each parameter's change by Adam's step ``k + 1`` from the restored
    moments (m = 0, v = the group's ``adam_v``)."""
    t = k + 1
    bc1, bc2 = 1.0 - BETAS[0] ** t, 1.0 - BETAS[1] ** t
    out = []
    for name, lr_name, p, g in zip(PARAM_NAMES, LR_NAMES, params, grads):
        lr = means_lr(recipe, scene_extent, k) if name == "means" else recipe[lr_name]
        m = (1.0 - BETAS[0]) * g
        v = BETAS[1] * recipe["adam_v"][name] + (1.0 - BETAS[1]) * g * g
        out.append(-lr * (m / bc1) / (torch.sqrt(v) / math.sqrt(bc2) + ADAM_EPS))
    return out


def densify_pass(params, vs: torch.Tensor, max_radius: torch.Tensor, recipe: dict, scene_extent: float, k: int,
                 capacity: int):
    """The decisions of a clone / split / prune pass at iteration ``k`` over
    the updated live rows ``params`` (the first ``N`` rows of ``capacity``),
    reading this step's accumulation. Returns (stats, touched [C])."""
    means, log_scales, _, opacity_logits, _ = params
    n, dev = means.shape[0], means.device
    opacity = torch.sigmoid(opacity_logits)
    max_scale = torch.exp(log_scales.amax(-1))
    prune = opacity < recipe["min_opacity"]
    if k >= recipe["size_prune_start"]:
        prune |= (max_scale > recipe["prune_scale_extent"] * scene_extent) | (max_radius > recipe["max_screen_size"])
    want = ~prune & (vs > 0) & (vs >= recipe["grad_threshold"])
    is_split = want & (max_scale > recipe["percent_dense"] * scene_extent)
    n_want = int(want.sum())
    n_free = capacity - n + int(prune.sum())
    placed = want
    if n_free < n_want:  # the best-ranked candidates get the slots
        order = torch.sort(torch.where(want, -vs, math.inf), stable=True).indices[:n_free]
        placed = torch.zeros_like(want)
        placed[order] = True
    n_placed = int(placed.sum())
    free = torch.cat([prune, torch.ones(capacity - n, dtype=torch.bool, device=dev)])
    touched = torch.cat([prune | (is_split & placed), torch.zeros(capacity - n, dtype=torch.bool, device=dev)])
    touched[torch.nonzero(free).flatten()[:n_placed]] = True  # the free slots, in slot order, take the new rows
    stats = {"pruned": int(prune.sum()), "cloned": int((placed & ~is_split).sum()),
             "split": int((placed & is_split).sum()), "wanted": n_want, "alive": n - int(prune.sum()) + n_placed}
    return stats, touched


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and convolutions, as it was after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@no_tf32()
def recipe_step(params, cam: Camera, cams: List[Camera], recipe: dict, sh_degree: int, stop: float,
                bg: torch.Tensor, target: torch.Tensor, ssim_weight: float, entries: int) -> Step:
    """One iteration at recipe iteration ``recipe["iteration"]`` from the
    restored state, on the live rows ``params`` of a pool of
    ``pool_rows(N, recipe["pool_factor"])``; ``cams`` are the cameras whose
    extent scales the position rate and the size rules. TF32 is off while
    it runs and as it was after, so the program keeps its own setting."""
    scene_extent = extent(cams)
    k = recipe["iteration"]
    image, loss, grads, screen_grad, proj, counts = gradients(params, cam, sh_degree, stop, bg, target, ssim_weight,
                                                               entries)
    # 3DGS's threshold is on the NDC-scale gradient: pixel = (ndc + 1) W / 2.
    g = screen_grad * torch.tensor([0.5 * cam.width, 0.5 * cam.height], dtype=screen_grad.dtype,
                                   device=screen_grad.device)
    vs = torch.sqrt((g * g).sum(-1))
    r = radii(proj.feat, cam)
    update = adam_update(params, grads, recipe, scene_extent, k)
    moved = [p + u for p, u in zip(params, update)]
    n = params[0].shape[0]
    stats, touched = densify_pass(moved, vs, r, recipe, scene_extent, k, pool_rows(n, recipe["pool_factor"]))
    return Step(image, loss, update, vs, r, stats, touched, counts)


def background(index: int) -> np.ndarray:
    """The random background colour of the step at pose ``index``: the
    first draw of ``numpy.random.default_rng(index)``, as float32."""
    return np.random.default_rng(index).uniform(size=3).astype(np.float32)
