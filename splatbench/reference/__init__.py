"""The benchmark's plain reference: each loop's call worked out again in
plain PyTorch from the inputs the benchmark hands the program (the loop's
``reference`` in ``steps/<loop>.py``, on ``render`` and ``loss`` here). It
imports nothing of the program."""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import torch

from splatbench import spec
from splatbench.reference import render as ref_render


class Answer(NamedTuple):
    """What one step or request produced, on either side."""

    image: torch.Tensor  # [H, W, 3]
    trans: Optional[torch.Tensor]  # [H, W] (requests)
    loss: Optional[torch.Tensor]  # 0-d (steps)
    grads: Optional[list]  # raw-parameter gradients (steps)


def inputs(params, pose, config: dict, dtype):
    """The reference's camera at ``pose`` (yaw, shift) and the raw
    parameters, every float in ``dtype``."""
    cam = ref_render.camera(config["width"], config["height"], pose[0], pose[1], dtype, params[0].device)
    return cam, [x.detach().to(dtype) for x in params]


def reference_answer(params, pose, config: dict, traffic: dict, dtype=torch.float64, entries: int = 1 << 25,
                     root: Path = spec.HERE):
    """The reference's answer to one call of the mix's loop at ``pose``
    (yaw, shift), every float in ``dtype`` (float64 and bfloat16 have no
    TF32 path, so the global TF32 flags do not touch it), by the step file
    of the loop under ``root``. Returns (Answer, Counts)."""
    return spec.step_file(traffic["loop"], root).reference(params, pose, config, traffic, dtype, entries)
