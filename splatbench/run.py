"""Run one cell of the benchmark of ``gsplat_tpu_torch`` once, on the card.

    python splatbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, limits, metric readers, step and
scene are found by the names in ``BENCHMARK.json`` and the files they lead
to (``splatbench/spec.py``). A run:

  1. set-up: the configuration's scene drawn on the card from ``--seed``
     (``scenes/<scene>.py``), the mix's step (``steps/<loop>.py``), the kernels
     loaded from ``build/kernels/`` (built there by the first run in a
     checkout), the program's pair capacity sized over the mix's poses,
     a warm-up of every pose, continued for the mix's ``warmup_seconds``;
  2. the window: ``--seconds`` of the mix's closed loop (``--trace 0``), or
     with ``--trace 1`` a fixed number of whole cycles under the profiler
     and the program's stage marks;
  3. the check: two answers of the window, drawn from the seed, against the
     plain reference (``splatbench/reference``), once the window has closed,
     the memory peak has been read and the program has been freed;
  4. the result: the cell's end-to-end metrics (``--trace 0``) or per-layer
     metrics (``--trace 1``) as the last line of standard output, with each
     compared number beside its limit, also on standard error.

It exits with a code other than 0, and prints no result, without a card
(or with fewer than the cell asks for), or where ``jax``, ``jaxlib``,
``flax`` or ``gsplat_tpu`` is among the loaded modules after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FORBIDDEN = ("jax", "jaxlib", "flax", "gsplat_tpu")
KERNELS = ("raster_fwd", "raster_bwd")


def cache_env(repo: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels build into ``build/kernels``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(repo / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(repo / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX name or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def set_up(cell, seed: int, device, fault=None, root: Path = HERE):
    """The scene and the program, warmed. Returns (params, Program, plan)."""
    import torch

    from splatbench import loops, spec

    c = cell.config
    params = spec.scene_file(c, root).build(c, seed, device)
    if torch.device(device).type == "cuda":
        from gsplat_tpu_torch.kernels import build

        build.build(KERNELS)
    prog = loops.Program(c, cell.traffic, params, device, fault, root)
    plan = loops.sample_plan(seed, len(prog.poses))
    # Every pose once, then on for the mix's warm-up seconds, so that the
    # window starts on a card and a host already at their steady pace.
    loops.run_window(prog, cell.traffic["warmup_seconds"], plan, device)
    prog.last = None
    return params, prog, plan


def free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def check(cell, params, samples: dict, poses: list, root: Path = HERE):
    """Each sampled answer against the reference at its pose, by the step
    file of the mix's loop. Returns (worst readings, {pose: reference
    Counts})."""
    from splatbench import compare
    from splatbench.reference import reference_answer

    readings, counts = [], {}
    for key in sorted(samples):
        p, got = samples[key]
        want, counts[p] = reference_answer(params, poses[p], cell.config, cell.traffic, root=root)
        readings.append(compare.numbers(cell.traffic["loop"], got, want, cell.config["early_stop"], root))
        del want
        free(params[0].device)
    return compare.worst(readings), counts


def pose_counts(cell, params, poses: list, known: dict, wanted) -> dict:
    """The reference's work counts at every pose in ``wanted``."""
    import torch

    from splatbench.reference import render as ref_render

    out = dict(known)
    for p in sorted(set(wanted) - set(out)):
        cam = ref_render.camera(cell.config["width"], cell.config["height"], *poses[p], torch.float64,
                                params[0].device)
        view = ref_render.render([x.double() for x in params], cam, cell.config["sh_degree"],
                                 cell.config["early_stop"])
        out[p] = view.counts
        del view
        free(params[0].device)
    return out


def run_cell(cell, units: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
             root: Path = HERE, fault=None) -> dict:
    """One run of ``cell``; returns the result object."""
    import torch

    from splatbench import compare, loops, readers, spec
    from splatbench import trace as tr

    cuda = torch.device(device).type == "cuda"
    params, prog, plan = set_up(cell, seed, device, fault, root)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    trace = None
    if traced:
        window, trace = tr.traced_window(prog, cell.traffic["trace_cycles"] * len(prog.poses), plan, device)
    else:
        window = loops.run_window(prog, seconds, plan, device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind, poses, n_poses = prog.kind, prog.poses, len(prog.poses)
    failed = sum(prog.demand[prog.pose_of(i)] > prog.cfg.max_pairs for i in range(window.completed))
    samples = window.samples
    host = (window.seconds, window.completed, window.latencies_ms)
    del prog, window
    free(device)

    t_check = time.perf_counter()
    values, counts = check(cell, params, samples, poses, root)
    del samples
    t_counts = time.perf_counter()
    if trace is not None:
        steps = len(trace.steps)
        counts = pose_counts(cell, params, poses, counts, [i % n_poses for i in range(steps)])
        trace = trace._replace(counts=[counts[i % n_poses] for i in range(steps)])
    print(f"splatbench: setup {setup_s:.3f} s, window {host[0]:.3f} s ({host[1]} done), check "
          f"{t_counts - t_check:.3f} s, counts {time.perf_counter() - t_counts:.3f} s", file=sys.stderr)
    correct, checks = compare.judge(values, compare.load_limits(root, cell.name))
    run = readers.Run(kind, setup_s, *host, trace)
    metrics = {}
    for name in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(name, root)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.completed, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.window_s
        result["breakdown"] = tr.breakdown(trace)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(REPO)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())

    from splatbench import spec

    cell = spec.load_cell(bench, args.workload, REPO)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"splatbench: {args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result = run_cell(cell, units, args.seed, args.seconds, bool(args.trace), device, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"splatbench: modules loaded that the benchmark must not load: {bad}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}; peaks: FP32 67 TFLOP/s, HBM 3.35 TB/s (H100 SXM, 700 W)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
