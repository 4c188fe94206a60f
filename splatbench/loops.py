"""The system under test and the timed loops.

``Program`` holds what the program's set-up builds for one cell: the model
on the device, the ``RasterConfig`` with its pair capacity, one camera per
pose. ``step`` runs what the cell's traffic asks of it:

  * ``train``: bench.py's step, ``render_traced`` -> ``rgb_loss`` ->
    ``torch.autograd.grad`` to the five parameters; nothing syncs inside a
    step and there is no optimizer, so the work per step stays fixed.
  * ``render``: a view request, ``gsplat_tpu_torch.render(model, camera,
    cfg)`` under ``torch.no_grad``, fenced: the frame is ready on the card
    before the next request is sent.

``fault`` breaks the step on purpose for the tests and the calibration of
the limits (never in a benchmark run): ``stale`` returns the previous
answer, ``half`` leaves half of the frame's rows out (the loss is the mean
over the rest), ``altered`` adds 0.05 to one 32x32 block of the frame where
it is produced.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from splatbench import scene
from splatbench.reference import Answer

FAULTS = ("stale", "half", "altered")


class Program:
    """The port set up for one cell."""

    def __init__(self, config: dict, traffic: dict, params: List[torch.Tensor], device, fault: Optional[str] = None):
        import gsplat_tpu_torch as gs
        from gsplat_tpu_torch.render.pipeline import binning_stats

        self.config, self.traffic, self.fault = config, traffic, fault
        self.kind = traffic["loop"]
        self.width, self.height = config["width"], config["height"]
        self.model = gs.GaussianModel(*params)
        self.poses = scene.poses(traffic)
        self.cameras = [scene.camera_params(self.width, self.height, *p) for p in self.poses]
        self.cams = [gs.CameraArrays.from_params(c, device=device) for c in self.cameras]
        # Pair demand at each pose (bench.py's sized_capacity: a probe at
        # 2^20 pairs), capacity headroom x the largest, 128-aligned.
        probe = gs.RasterConfig(tile_size=config["tile_size"], chunk_size=config["chunk_size"], max_pairs=1 << 20,
                                sh_degree=config["sh_degree"])
        with torch.no_grad():
            self.demand = [int(binning_stats(self.model, c, self.width, self.height, probe)["pair_demand"])
                           for c in self.cams]
        capacity = max(int(max(self.demand) * config["capacity_headroom"]) // 128 * 128, config["capacity_floor"])
        self.cfg = gs.RasterConfig(
            tile_size=config["tile_size"], chunk_size=config["chunk_size"], pair_block=config["pair_block"],
            max_pairs=capacity, sh_degree=config["sh_degree"], early_stop_transmittance=config["early_stop"],
            slice_pairs=config["slice_pairs"], reduce_pairs=config["reduce_pairs"],
        )
        if self.kind == "train":
            self.target = torch.full((self.height, self.width, 3), traffic["target"], device=device)
        self.params = list(self.model.parameters())
        self.last: Optional[Answer] = None
        if fault == "altered":
            self.block = torch.zeros((self.height, self.width, 3), device=device)
            self.block[:32, :32] = 0.05

    def pose_of(self, i: int) -> int:
        return i % len(self.poses)

    def step(self, i: int) -> Answer:
        from gsplat_tpu_torch import render, rgb_loss
        from gsplat_tpu_torch.render.pipeline import render_traced
        from gsplat_tpu_torch.utils.stages import stage

        if self.fault == "stale" and self.last is not None:
            return self.last
        p = self.pose_of(i)
        if self.kind == "render":
            with torch.no_grad():
                image, trans = render(self.model, self.cameras[p], self.cfg)
                image = self._break(image)
            out = Answer(image, trans, None, None)
        else:
            image, _ = render_traced(self.model, self.cams[p], self.width, self.height, self.cfg)
            image = self._break(image)
            pred, target = image, self.target
            if self.fault == "half":
                pred, target = image[::2], target[::2]
            with stage("bench.loss"):
                loss = rgb_loss(pred, target, self.traffic["ssim_weight"])
            with stage("bench.backward"):
                grads = torch.autograd.grad(loss, self.params)
            out = Answer(image.detach(), None, loss.detach(), list(grads))
        self.last = out
        return out

    def _break(self, image: torch.Tensor) -> torch.Tensor:
        if self.fault == "altered":
            return image + self.block
        if self.fault == "half" and self.kind == "render":
            return image * (torch.arange(self.height, device=image.device) % 2 == 0)[:, None, None]
        return image


def sample_plan(seed: int, n_poses: int) -> tuple:
    """The two answers a run compares, drawn from the seed: the first step at
    one pose and the last step at another."""
    rng = np.random.default_rng(scene.seed_value(seed))
    first = int(rng.integers(n_poses))
    last = (first + 1 + int(rng.integers(n_poses - 1))) % n_poses if n_poses > 1 else first
    return first, last


class Window(NamedTuple):
    completed: int
    seconds: float
    latencies_ms: List[float]
    samples: dict  # "first" / "last" -> (pose, Answer)


def fence(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(prog: Program, seconds: float, plan: tuple, device, steps: Optional[int] = None,
               on_step=None) -> Window:
    """A closed loop over the poses for ``seconds`` on the host clock, and at
    least one whole cycle of them (or exactly ``steps`` steps), ended by a
    fence: the rate counts all the work of the window. Keeps the answers
    ``plan`` names."""
    first, last = plan
    samples = {}
    latencies = []
    i = 0
    start = time.perf_counter()
    n_poses = len(prog.poses)
    while (i < steps) if steps is not None else (i < n_poses or time.perf_counter() - start < seconds):
        p = prog.pose_of(i)
        t = time.perf_counter()
        if on_step is not None:
            out = on_step(i)
        else:
            out = prog.step(i)
        if prog.kind == "render":
            fence(device)
            latencies.append((time.perf_counter() - t) * 1e3)
        if p == first and "first" not in samples:
            samples["first"] = (p, out)
        if p == last:
            samples["last"] = (p, out)
        i += 1
    fence(device)
    return Window(i, time.perf_counter() - start, latencies, samples)
