"""bench.py's training step over the (data x tile) mesh: the update-free
step of ``make_parallel_train_step`` (preprocess of a quarter of the
gaussians a rank, the packed rows all-gathered, each rank binning and
compositing its strided tiles unsliced, the frame all-gathered for the
loss, the gradients summed over the world) on every rank of the
configuration's ``mesh``, against the same constant target as ``train``.

This process is rank 0; ``prepare`` starts the other ranks and builds the
step on all of them (``mesh_world.py``), and replaces the program's pair
capacity and demand with the per-shard ones, so that ``failed`` counts
shard overflows. ``step`` tells the peers the pose, then runs rank 0's
part. Compared as ``train`` is, on the frame, the loss and the gradients.

The faults are planted on rank 0's answer, since the step computes its
loss across the ranks: ``altered`` adds the block to the returned frame,
and ``half`` gives the loss of every other row of the returned frame.
"""

from __future__ import annotations

from pathlib import Path

import torch

from splatbench import mesh_world, spec
from splatbench.reference import Answer

TRAIN = spec.step_file("train", Path(__file__).resolve().parents[1])
KIND = "train"
reference = TRAIN.reference
numbers = TRAIN.numbers


def prepare(prog) -> None:
    prog.world = mesh_world.world(prog.config, prog.device)
    prog.mesh_step = prog.world.prepare(prog.model, prog.config, prog.traffic, prog.device)
    prog.cfg, prog.demand = prog.mesh_step.cfg, prog.mesh_step.demand
    prog.target = torch.full((prog.height, prog.width, 3), prog.traffic["target"], device=prog.device)


def step(prog, i: int) -> Answer:
    pose = prog.pose_of(i)
    prog.world.send("step", pose)
    grads, image, loss = prog.mesh_step(pose)
    image = prog.altered(image)
    if prog.fault == "half":
        from gsplat_tpu_torch import rgb_loss

        with torch.no_grad():
            loss = rgb_loss(image[::2], prog.target[::2], prog.traffic["ssim_weight"])
    return Answer(image, None, loss.detach(), grads)
