"""A view request: ``gsplat_tpu_torch.render(model, camera, cfg)`` under
``torch.no_grad``, fenced, so the frame is ready on the card before the next
request is sent. Compared on the frame and its transmittance."""

from __future__ import annotations

import torch

from splatbench import compare
from splatbench.reference import Answer, inputs
from splatbench.reference import render as ref_render

KIND = "render"


def prepare(prog) -> None:
    """A request holds nothing beyond the common set-up."""


def step(prog, i: int) -> Answer:
    from gsplat_tpu_torch import render

    with torch.no_grad():
        image, trans = render(prog.model, prog.cameras[prog.pose_of(i)], prog.cfg)
        image = prog.altered(image)
        if prog.fault == "half":
            image = image * (torch.arange(prog.height, device=image.device) % 2 == 0)[:, None, None]
    return Answer(image, trans, None, None)


def reference(params, pose, config: dict, traffic: dict, dtype, entries: int):
    cam, p = inputs(params, pose, config, dtype)
    view = ref_render.render(p, cam, config["sh_degree"], config["early_stop"], entries)
    return Answer(view.image, view.trans, None, None), view.counts


def numbers(got, want, allowance: float) -> dict:
    out = compare.frame_numbers(got, want, allowance)
    out["trans_rms"] = compare._rms(got.trans, want.trans, allowance)
    return out
