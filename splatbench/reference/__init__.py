"""The benchmark's plain reference: the view and the training step worked
out again in plain PyTorch from the inputs the benchmark hands the program.
It imports nothing of the program."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from splatbench.reference import loss as ref_loss
from splatbench.reference import render as ref_render


class Answer(NamedTuple):
    """What one step or request produced, on either side."""

    image: torch.Tensor  # [H, W, 3]
    trans: Optional[torch.Tensor]  # [H, W] (requests)
    loss: Optional[torch.Tensor]  # 0-d (steps)
    grads: Optional[list]  # raw-parameter gradients (steps)


def reference_answer(params, pose, config: dict, traffic: dict, dtype=torch.float64, entries: int = 1 << 25):
    """The reference's answer to one step or request at ``pose`` (yaw,
    shift), every float in ``dtype`` (float64 and bfloat16 have no TF32
    path, so the global TF32 flags do not touch it). Returns (Answer,
    Counts)."""
    dev = params[0].device
    cam = ref_render.camera(config["width"], config["height"], pose[0], pose[1], dtype, dev)
    p = [x.detach().to(dtype) for x in params]
    stop = config["early_stop"]
    deg = config["sh_degree"]
    if traffic["loop"] == "render":
        view = ref_render.render(p, cam, deg, stop, entries)
        return Answer(view.image, view.trans, None, None), view.counts
    target = torch.full((config["height"], config["width"], 3), traffic["target"], dtype=dtype, device=dev)
    view, loss, grads = ref_render.render_backward(
        p, cam, deg, stop, lambda img: ref_loss.rgb_loss(img, target, traffic["ssim_weight"]), entries)
    return Answer(view.image, view.trans, loss, grads), view.counts
