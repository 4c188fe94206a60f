"""Readings of a ``fit`` cell (``steps/fit.py``) on the card, at the cell's
own size, for its limits and its configuration; not run by the benchmark.

    python splatbench/fit_check.py --workload recipe_5m.fit --seeds 1,2,3 [--seconds 2] [--faults 1]
        [--pass-step 50] [--grad-stats]

For each seed, in one process: the cell's set-up, a short window of its
closed loop and the run's own check (its two answers drawn from the seed
against the reference), then the step ``--pass-step`` (a pass step: the
window's two answers fall on one only now and then) against the reference
at its pose. For the first ``--faults`` seeds also: the control (the
reference computed in bfloat16 in the program's place, as a step without
and with a pass) and the program with each fault of ``loops.FAULTS``
planted, at the pass step's pose. With ``--grad-stats``: each parameter
group's mean squared gradient over the live rows at the restored state,
averaged over the poses, by the float64 reference (the configuration's
``adam_v``) and by the program beside it, and the program's accumulated
viewspace-gradient norms' quantiles. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from splatbench import run as bench_run  # noqa: E402


def reference_adam_v(cell, params, poses) -> dict:
    """Mean squared gradient of each group at the restored state, by the
    float64 reference (``reference/fit.py::gradients``), over one step at
    each pose on its background."""
    import torch

    from splatbench import scene
    from splatbench.reference import fit as ref_fit
    from splatbench.reference import inputs

    c, traffic = cell.config, cell.traffic
    sums = {name: 0.0 for name in scene.PARAM_NAMES}
    target = torch.full((c["height"], c["width"], 3), traffic["target"], dtype=torch.float64,
                        device=params[0].device)
    with ref_fit.no_tf32():
        for i, pose in enumerate(poses):
            cam, p = inputs(params, pose, c, torch.float64)
            bg = torch.from_numpy(ref_fit.background(i)).to(dtype=torch.float64, device=params[0].device)
            grads = ref_fit.gradients(p, cam, c["sh_degree"], c["early_stop"], bg, target, traffic["ssim_weight"],
                                      1 << 25)[2]
            for name, g in zip(scene.PARAM_NAMES, grads):
                sums[name] += float(g.pow(2).mean()) / len(poses)
            del cam, p, grads
            bench_run.free(params[0].device)
    return sums


def grad_stats(prog) -> dict:
    """The program's mean squared gradient of each group over the live rows,
    and the viewspace norms' quantiles, over one step at each pose."""
    import torch

    from splatbench import scene

    n = prog.model.means.shape[0]
    sums = {name: 0.0 for name in scene.PARAM_NAMES}
    norms = []
    for i in range(len(prog.poses)):
        answer = prog.step(i)
        for name, p in zip(scene.PARAM_NAMES, prog.fit["params"]):
            sums[name] += float(p.grad[:n].double().pow(2).mean()) / len(prog.poses)
        norms.append(answer.vs[:n].float())
    vs = torch.cat(norms)
    seen = vs[vs > 0]
    q = torch.quantile(seen[torch.randperm(seen.numel(), device=seen.device)[:1 << 24]],
                       torch.tensor([0.5, 0.9, 0.99, 0.999], device=seen.device))
    return {"adam_v_program": sums, "vs_seen_share": float((vs > 0).float().mean()),
            "vs_quantiles": [float(x) for x in q], "vs_at_threshold": float((vs >= prog.config["recipe"][
                "grad_threshold"]).float().mean())}


def readings(cell, seed: int, seconds: float, pass_step: int, with_faults: bool, with_stats: bool,
             device) -> dict:
    import torch

    from splatbench import compare, loops
    from splatbench.reference import reference_answer

    loop = cell.traffic["loop"]
    params, prog, plan = bench_run.set_up(cell, seed, device)
    window = loops.run_window(prog, seconds, plan, device)
    samples, poses = window.samples, prog.poses
    out = {"seed": seed, "completed": window.completed}
    del window
    if with_stats:
        out["stats"] = grad_stats(prog)
    p = prog.pose_of(pass_step)
    planted = {"pass": prog.step(pass_step)}
    out["pass_stats"] = planted["pass"].stats
    if with_faults:
        planted["stale"] = prog.step(pass_step - 1)  # the previous pose's answer
        for fault in ("half", "altered"):
            prog.fault = fault
            prog.loop.prepare(prog)
            planted[fault] = prog.step(pass_step)
        prog.fault = None
    del prog
    bench_run.free(device)
    out["program"], _ = bench_run.check(cell, params, samples, poses)
    del samples
    bench_run.free(device)
    if with_stats:
        out["stats"]["adam_v"] = reference_adam_v(cell, params, poses)
    want, _ = reference_answer(params, poses[p], cell.config, cell.traffic)
    out["reference_stats"] = want.stats
    for k, a in planted.items():
        out[k] = compare.numbers(loop, a, want, cell.config["early_stop"])
    del planted
    bench_run.free(device)
    if with_faults:
        control, _ = reference_answer(params, poses[p], cell.config, cell.traffic, dtype=torch.bfloat16)
        out["control"] = compare.numbers(loop, control, want, cell.config["early_stop"])
        out["control_pass"] = compare.numbers(loop, control._replace(passed=True), want, cell.config["early_stop"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="recipe_5m.fit")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--pass-step", type=int, default=50)
    ap.add_argument("--faults", type=int, default=1, help="seeds (the first ones) that also read the control and faults")
    ap.add_argument("--grad-stats", action="store_true")
    args = ap.parse_args(argv)
    bench_run.cache_env(bench_run.REPO)
    bench = json.loads((bench_run.REPO / "BENCHMARK.json").read_text())

    import torch

    from splatbench import spec

    if not torch.cuda.is_available():
        print("fit_check: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(bench, args.workload, bench_run.REPO)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cell, seed, args.seconds, args.pass_step, i < args.faults, args.grad_stats and i == 0, device)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
