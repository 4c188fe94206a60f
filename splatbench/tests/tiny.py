"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: a
96x64 frame, 3,000 gaussians grown by 0.6 in log scale (so that pixels
reach the early stop), three poses, slices of 256 pairs."""

from __future__ import annotations

import json
from pathlib import Path

import torch

from splatbench import run, spec

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
UNITS = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
CPU = torch.device("cpu")


def shrink(cell: spec.Cell) -> spec.Cell:
    c = cell.config
    config = dict(c, n_gaussians=3000, width=96, height=64, scale_shift=c["scale_shift"] + 0.6,
                  slice_pairs=256 if c["slice_pairs"] else 0, reduce_pairs=1024 if c["reduce_pairs"] else 0)
    traffic = dict(cell.traffic, poses=dict(cell.traffic["poses"], count=3), warmup_seconds=0.0)
    return cell._replace(config=config, traffic=traffic)


def tiny_cell(name: str) -> spec.Cell:
    return shrink(spec.load_cell(BENCH, name, REPO))


def run_tiny(cell: spec.Cell, seed: int = 2147483659, fault=None, root: Path = run.HERE) -> dict:
    import time

    return run.run_cell(cell, UNITS, seed, 0.5, False, CPU, time.perf_counter(), root=root, fault=fault)
