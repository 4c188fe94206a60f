#!/usr/bin/env python3
"""Compare two checkouts end to end on one CUDA card, by ``chip_smoke.py``.

Usage: ``python3 tools/ab_smoke.py PARENT_DIR CHANGE_DIR [--pairs 10]
[--out DIR]``, where each directory is a checkout of the repository (for
example ``git archive`` of the parent commit and of the change, unpacked
into a directory that ``.gitignore`` lists). It runs ``python3
chip_smoke.py`` from each checkout in turn, ``--pairs`` times each,
alternating which side runs first (parent, change, change, parent, ...), so
drift of the card or its host falls on both sides alike. Every run must
exit 0; its output is kept under ``--out`` when given. It prints one JSON
line: for each metric below, each side's runs, median and quartiles, the
share of pairs the change wins (lower is better for times, higher for the
``_fps`` metrics: frames/s of ``tools/bench_torch.py``'s step, phase 14), and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# metric name -> path into chip_smoke.py's phase lines (phase, keys...)
METRICS = {
    "headline_request_ms": ("timing", "request_ms"),
    "headline_device_busy_ms": ("timing", "device_busy_ms"),
    "headline_step_ms": ("train", "step_ms"),
    "headline_step_device_busy_ms": ("train", "step_device_busy_ms"),
    "raster_fwd_ms": ("timing", "kernel_ms"),
    "raster_bwd_ms": ("train", "raster_bwd_ms"),
    "real_sliced_request_ms": ("real_density", "sliced_request", "request_ms"),
    "real_sliced_step_ms": ("real_density", "sliced_step", "step_ms"),
    "real_single_sort_request_ms": ("real_density", "single_sort_request", "request_ms"),
    "real_single_sort_step_ms": ("real_density", "single_sort_step", "step_ms"),
    "raster_fwd_carry_ms": ("real_density", "forward_carry_ms"),
    "raster_bwd_carry_ms": ("real_density", "backward_carry_ms"),
    "bench_headline_fps": ("bench", "headline_fps"),
    "bench_real_sliced_fps": ("bench", "real_density_fps"),
    "bench_real_single_sort_fps": ("bench", "real_density_single_sort_fps"),
}


def run(checkout: str, out_path, missing_ok: bool):
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=checkout, capture_output=True, text=True,
                          timeout=1200)
    if out_path:
        with open(out_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"chip_smoke.py in {checkout} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    phases = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{") and '"phase"' in line:
            obj = json.loads(line)
            phases[obj["phase"]] = obj
    values = {}
    for name, (phase, *keys) in METRICS.items():
        if phase not in phases and not missing_ok:
            raise RuntimeError(f"chip_smoke.py in {checkout} printed no {phase!r} phase")
        v = phases.get(phase)  # None where an older parent's script lacks the phase
        for k in keys:
            v = None if v is None else v[k]
        values[name] = v
    smi = [ln for ln in proc.stdout.splitlines() if not ln.startswith("{")]
    return values, smi[-1] if smi else None


def quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 else [xs[0]] * 3
    return {"q1": q[0], "median": q[1], "q3": q[2]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--out", default=None)
    opts = parser.parse_args()
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
    runs = {"parent": [], "change": []}
    smi = None
    for i in range(opts.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            path = os.path.join(opts.out, f"{i:02d}_{side}.txt") if opts.out else None
            values, smi = run(getattr(opts, side), path, missing_ok=side == "parent")
            runs[side].append(values)
    report = {"pairs": opts.pairs, "nvidia_smi": smi, "metrics": {}}
    for name in METRICS:
        p = [r[name] for r in runs["parent"]]
        c = [r[name] for r in runs["change"]]
        ok = [x is not None for x in p + c]
        if not all(ok):
            report["metrics"][name] = {"parent": p, "change": c}
            continue
        report["metrics"][name] = {
            "parent": p, "change": c, "parent_stats": quartiles(p), "change_stats": quartiles(c),
            "change_wins": sum((cv > pv) if name.endswith("_fps") else (cv < pv) for pv, cv in zip(p, c)) / len(p),
        }
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
