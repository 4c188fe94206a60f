"""The system under test and the timed loops.

``Program`` holds what the program's set-up builds for one cell, whatever
its loop: the model on the device, the ``RasterConfig`` with its pair
capacity, one camera per pose. Its ``step`` runs one call of the mix's loop,
by the loop's step file (``steps/<loop>.py``, ``spec.py`` says what it
gives).

``fault`` breaks the step on purpose for the tests and the calibration of
the limits (never in a benchmark run): ``stale`` returns the previous
answer (here), ``half`` leaves half of the frame's rows out (the loss, where
there is one, is the mean over the rest) and ``altered`` adds 0.05 to one
32x32 block of the frame where it is produced (both in the step file).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from splatbench import scene, spec
from splatbench.reference import Answer

FAULTS = ("stale", "half", "altered")


class Program:
    """The port set up for one cell."""

    def __init__(self, config: dict, traffic: dict, params: List[torch.Tensor], device, fault: Optional[str] = None,
                 root: Path = spec.HERE):
        import gsplat_tpu_torch as gs
        from gsplat_tpu_torch.render.pipeline import binning_stats

        self.config, self.traffic, self.fault, self.device = config, traffic, fault, device
        self.loop = spec.step_file(traffic["loop"], root)
        self.kind = self.loop.KIND
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
        self.loop.prepare(self)
        self.params = list(self.model.parameters())
        self.last: Optional[Answer] = None

    def pose_of(self, i: int) -> int:
        return i % len(self.poses)

    def step(self, i: int) -> Answer:
        if self.fault == "stale" and self.last is not None:
            return self.last
        self.last = self.loop.step(self, i)
        return self.last

    def altered(self, image: torch.Tensor) -> torch.Tensor:
        """The frame with 0.05 added to its first 32x32 block where the
        ``altered`` fault is planted (also after set-up, as the
        calibration plants it)."""
        if self.fault != "altered":
            return image
        block = torch.zeros_like(image)
        block[:32, :32] = 0.05
        return image + block


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
    fence: the rate counts all the work of the window. A loop of the
    ``render`` kind fences each call and records its latency. Keeps the
    answers ``plan`` names."""
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
        if prog.kind == "render":  # a request is fenced and timed; a training step is not
            fence(device)
            latencies.append((time.perf_counter() - t) * 1e3)
        if p == first and "first" not in samples:
            samples["first"] = (p, out)
        if p == last:
            samples["last"] = (p, out)
        i += 1
    fence(device)
    return Window(i, time.perf_counter() - start, latencies, samples)
