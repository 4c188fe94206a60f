"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card, at the cell's own size; not run by the benchmark.

    python splatbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2] [--faults 3]

For each seed, in one process: the cell's set-up, a short window of its
closed loop, and the run's own check (its two answers drawn from the seed
against the reference): the program's readings. At the first answer's pose
also, for the first ``--faults`` seeds: the control (the reference itself
computed in bfloat16, the precision below the float32 the configuration
states, put in the program's place) and the program with each fault of
``loops.FAULTS`` planted in its timed path. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from splatbench import run as bench_run  # noqa: E402


def readings(cell, seed: int, seconds: float, with_faults: bool, device) -> dict:
    import torch

    from splatbench import compare, loops
    from splatbench.reference import reference_answer

    loop = cell.traffic["loop"]
    params, prog, plan = bench_run.set_up(cell, seed, device)
    window = loops.run_window(prog, seconds, plan, device)
    samples, poses = window.samples, prog.poses
    out = {"seed": seed, "completed": window.completed}
    del window
    planted = {}
    if with_faults:
        p = samples["first"][0]
        n = len(poses)
        planted["stale"] = prog.step((p - 1) % n)  # the previous pose's answer
        for fault in ("half", "altered"):
            prog.fault = fault
            planted[fault] = prog.step(p)
        prog.fault = None
        for k, a in planted.items():
            planted[k] = a._replace(grads=None if a.grads is None else [g.detach() for g in a.grads])
    del prog
    bench_run.free(device)
    out["program"], _ = bench_run.check(cell, params, samples, poses)
    if with_faults:
        p = samples["first"][0]
        want, _ = reference_answer(params, poses[p], cell.config, cell.traffic)
        control, _ = reference_answer(params, poses[p], cell.config, cell.traffic, dtype=torch.bfloat16)
        out["control"] = compare.numbers(loop, control, want, cell.config["early_stop"])
        del control
        for k, a in planted.items():
            out[k] = compare.numbers(loop, a, want, cell.config["early_stop"])
    del samples, planted
    bench_run.free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", type=int, default=3, help="seeds (the first ones) that also read the control and faults")
    args = ap.parse_args(argv)
    bench_run.cache_env(bench_run.REPO)
    bench = json.loads((bench_run.REPO / "BENCHMARK.json").read_text())

    import torch

    from splatbench import spec

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(bench, args.workload, bench_run.REPO)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cell, seed, args.seconds, i < args.faults, device)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
