"""bench.py's training step: ``render_traced`` -> ``rgb_loss`` against a
constant target -> ``torch.autograd.grad`` to the five raw parameters.
Nothing syncs inside a step and there is no optimizer, so the work per step
stays fixed; only the window's end is fenced. Compared on the frame, the
loss and the gradients."""

from __future__ import annotations

import torch

from splatbench import compare
from splatbench.reference import Answer, inputs
from splatbench.reference import loss as ref_loss
from splatbench.reference import render as ref_render

KIND = "train"


def prepare(prog) -> None:
    prog.target = torch.full((prog.height, prog.width, 3), prog.traffic["target"], device=prog.device)


def step(prog, i: int) -> Answer:
    from gsplat_tpu_torch import rgb_loss
    from gsplat_tpu_torch.render.pipeline import render_traced
    from gsplat_tpu_torch.utils.stages import stage

    image, _ = render_traced(prog.model, prog.cams[prog.pose_of(i)], prog.width, prog.height, prog.cfg)
    image = prog.altered(image)
    pred, target = image, prog.target
    if prog.fault == "half":
        pred, target = image[::2], target[::2]
    with stage("bench.loss"):
        loss = rgb_loss(pred, target, prog.traffic["ssim_weight"])
    with stage("bench.backward"):
        grads = torch.autograd.grad(loss, prog.params)
    return Answer(image.detach(), None, loss.detach(), list(grads))


def reference(params, pose, config: dict, traffic: dict, dtype, entries: int):
    cam, p = inputs(params, pose, config, dtype)
    target = torch.full((config["height"], config["width"], 3), traffic["target"], dtype=dtype,
                        device=params[0].device)
    view, loss, grads = ref_render.render_backward(
        p, cam, config["sh_degree"], config["early_stop"],
        lambda img: ref_loss.rgb_loss(img, target, traffic["ssim_weight"]), entries)
    return Answer(view.image, view.trans, loss, grads), view.counts


def numbers(got, want, allowance: float) -> dict:
    """``loss_rel``: |loss - reference loss| / reference loss; ``grad_rel``:
    over the five raw parameters, the largest ||gradient - reference
    gradient|| / max(||reference gradient||, the median of the five
    reference norms)."""
    out = compare.frame_numbers(got, want, allowance)
    out["loss_rel"] = abs(float(got.loss) - float(want.loss)) / abs(float(want.loss))
    norms = [float(r.double().norm()) for r in want.grads]
    floor = sorted(norms)[len(norms) // 2]
    out["grad_rel"] = max(float((g.double() - r.double()).norm()) / max(n, floor)
                          for g, r, n in zip(got.grads, want.grads, norms))
    return out
