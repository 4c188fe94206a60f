"""The program's own tracer in the benchmark (``gsplat_tpu_torch.utils.stages``):
a light window, an attributed host cycle, and the readers of both.

* The light window runs a number of steps with the program's tracer on,
  host time alone (no CUDA events), and no profiler, each step under
  ``stages.step(i)``, so its host numbers are at close to the untraced pace.
* The host cycle runs one cycle of the poses under ``torch.profiler`` (CPU
  and CUDA activity) with the tracer on. Each device operation is put down
  to the innermost program span open on the host at its launching runtime
  call, found by correlation id; each idle gap of the device to the
  innermost program span open on the host where the gap starts; either, to
  ``OUTSIDE`` where no program span is open. Span host times are on the
  profiler's clock, so no offset is taken.

Spans whose names start with ``bench.`` are the benchmark's own marks, not
the program's. The readers take a step's numbers over the steps recorded:

  * ``host_issue_ms``: host ms a step inside the program's outermost spans
    on both threads (the caller's and autograd's), less its sync spans;
  * ``sync_wait_ms``: host ms a step in sync spans (the host's waits);
  * ``launches``: device operations a step launched inside a program span.

The metric readers ``metrics/{train,render}.{host_issue_ms,sync_wait_ms,
launches}.py`` read them from a traced run's ``trace.light`` (the light
window's spans) and ``trace.by_stage`` (the host cycle's attribution), and
return None where the trace holds neither.

On the card, for a cell's numbers beside the tracer's cost:

    python3 splatbench/hosttrace.py --workload <cell> --seed <n> [--rounds 3]

prints one JSON line: the untraced and the light window's ms a step in
alternating rounds of the same steps, the six readers' values, the host
cycle's ``by_stage``, and the light window's host ms by stage and counters.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

OUTSIDE = "outside the program"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")

Op = Tuple[str, int, int, int]  # device operation: name, correlation id, start ns, end ns


def is_program(name: str) -> bool:
    return not name.startswith("bench.")


def _n_steps(spans) -> int:
    return len({s.step for s in spans if s.step is not None})


def host_issue_ms(spans) -> Optional[float]:
    """Host ms a step inside the program's outermost spans, less the host
    ms of its sync spans; None without a step."""
    steps = _n_steps(spans)
    if not steps:
        return None
    program = {s.id for s in spans if is_program(s.name)}
    outer = sum(s.host_end_ns - s.host_start_ns for s in spans
                if s.id in program and s.parent not in program)
    return (outer - _sync_ns(spans)) / steps / 1e6


def _sync_ns(spans) -> int:
    return sum(s.host_end_ns - s.host_start_ns for s in spans if s.sync)


def sync_wait_ms(spans) -> Optional[float]:
    """Host ms a step in sync spans; None without a step."""
    steps = _n_steps(spans)
    return _sync_ns(spans) / steps / 1e6 if steps else None


def launches(by_stage: Dict[str, dict]) -> Optional[float]:
    """Device operations a step launched inside a program span."""
    found = [v["launches"] for k, v in by_stage.items() if k != OUTSIDE and is_program(k)]
    return sum(found) if found else None


def read_light(run, kind: str, reader) -> Optional[float]:
    """``reader`` on the light window's spans of a traced run of ``kind``;
    None where the trace holds none."""
    spans = getattr(run.trace, "light", None) if run.kind == kind else None
    return reader(spans) if spans else None


def read_by_stage(run, kind: str, reader) -> Optional[float]:
    """``reader`` on the host cycle's attribution of a traced run of
    ``kind``; None where the trace holds none."""
    by_stage = getattr(run.trace, "by_stage", None) if run.kind == kind else None
    return reader(by_stage) if by_stage else None


class _Innermost:
    """The innermost program span open on the host at a time: of those
    open then, the one that started last."""

    def __init__(self, spans):
        self.spans = sorted((s for s in spans if is_program(s.name)), key=lambda s: s.host_start_ns)
        self.starts = [s.host_start_ns for s in self.spans]

    def at(self, t: int) -> str:
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[i].host_end_ns > t:
                return self.spans[i].name
        return OUTSIDE


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def attribute(spans, launch_ns: Dict[int, int], ops: Sequence[Op], steps: int) -> Dict[str, dict]:
    """Per stage, per step: host ms (its spans, nested ones included),
    device ms, launches and device idle ms (each put down to the innermost
    program span open on the host: at the operation's launching runtime
    call, ``launch_ns`` by correlation id, or where the gap starts).
    Operations whose launch was not recorded count under ``OUTSIDE``."""
    out: Dict[str, dict] = defaultdict(lambda: {"host_ms": 0.0, "device_ms": 0.0, "launches": 0.0, "idle_ms": 0.0})
    for s in spans:
        out[s.name]["host_ms"] += (s.host_end_ns - s.host_start_ns) / 1e6 / steps
    inner = _Innermost(spans)
    for _, corr, start, end in ops:
        t = launch_ns.get(corr)
        name = inner.at(t) if t is not None else OUTSIDE
        out[name]["launches"] += 1.0 / steps
        out[name]["device_ms"] += (end - start) / 1e6 / steps
    busy = _union([(s, e) for _, _, s, e in ops])
    for (_, t0), (t1, _) in zip(busy, busy[1:]):
        out[inner.at(t0)]["idle_ms"] += (t1 - t0) / 1e6 / steps
    return dict(out)


def program_share(by_stage: Dict[str, dict]) -> Optional[float]:
    """The share of device operations launched inside a program span."""
    total = sum(v["launches"] for v in by_stage.values())
    inside = launches(by_stage)
    return inside / total if total and inside is not None else None


def counters_per_step(values: List[Tuple[str, Optional[int], int]]) -> Dict[str, dict]:
    """``Recording.counter_values()`` by name: the sum a step (over the
    steps with any counter) and the number of records."""
    steps = len({s for _, s, _ in values if s is not None}) or 1
    out: Dict[str, dict] = {}
    for name, _, v in values:
        c = out.setdefault(name, {"per_step": 0.0, "records": 0})
        c["per_step"] += v / steps
        c["records"] += 1
    return out


def profiler_events(prof) -> Tuple[Dict[int, int], List[Op]]:
    """The runtime calls' host start by correlation id, and the device
    operations, from a finished ``torch.profiler.profile``."""
    import torch

    from splatbench.trace import _activity

    launch_ns, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        kind = _activity(e)
        if kind in DEVICE_ACTIVITIES:
            ops.append((e.name(), e.correlation_id(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif (e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith("cu")
              and "::" not in e.name()):
            launch_ns[e.correlation_id()] = e.start_ns()
    return launch_ns, ops


def _traced_step(prog, stages):
    def on_step(i):
        with stages.step(i), stages.stage("bench.step"):
            return prog.step(i)

    return on_step


def light_window(prog, steps: int, plan: tuple, device):
    """``steps`` steps with the program's tracer on (host time alone) and
    no profiler. Returns (the Window, the Recording), the counters not yet
    read."""
    from gsplat_tpu_torch.utils import stages

    from splatbench.loops import run_window

    with stages.record_stages(events=False) as rec:
        window = run_window(prog, 0.0, plan, device, steps=steps, on_step=_traced_step(prog, stages))
    return window, rec


def host_cycle(prog, plan: tuple, device) -> Dict[str, dict]:
    """One cycle of the poses under the profiler (CPU and CUDA) with the
    tracer on; returns its ``attribute`` by stage."""
    from torch.profiler import ProfilerActivity, profile

    from gsplat_tpu_torch.utils import stages

    from splatbench.loops import run_window

    steps = len(prog.poses)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with stages.record_stages() as rec:
            run_window(prog, 0.0, plan, device, steps=steps, on_step=_traced_step(prog, stages))
    launch_ns, ops = profiler_events(prof)
    return attribute(rec.spans, launch_ns, ops, steps)


def measure(cell, seed: int, device, rounds: int) -> dict:
    """Set-up as a benchmark run's, then ``rounds`` pairs of an untraced
    and a light window of the traced run's step count, then the host
    cycle."""
    from splatbench import loops, run

    params, prog, plan = run.set_up(cell, seed, device)
    steps = cell.traffic["trace_cycles"] * len(prog.poses)
    untraced, light = [], []
    for _ in range(rounds):
        w = loops.run_window(prog, 0.0, plan, device, steps=steps)
        untraced.append(w.seconds / w.completed * 1e3)
        w, rec = light_window(prog, steps, plan, device)
        light.append(w.seconds / w.completed * 1e3)
    by_stage = host_cycle(prog, plan, device)
    kind = prog.kind
    u, li = statistics.median(untraced), statistics.median(light)
    return {
        "workload": cell.name, "seed": seed, "steps": steps,
        "untraced_ms": untraced, "light_ms": light, "tracer_cost_pct": 100.0 * (li / u - 1.0),
        f"{kind}.host_issue_ms": host_issue_ms(rec.spans), f"{kind}.sync_wait_ms": sync_wait_ms(rec.spans),
        f"{kind}.launches": launches(by_stage), "program_launch_share": program_share(by_stage),
        "by_stage": by_stage, "counters": counters_per_step(rec.counter_values()),
        "light_host_ms": {k: v["host_ms"] for k, v in attribute(rec.spans, {}, [], steps).items()},
    }


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    from splatbench import run, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    run.cache_env(run.REPO)
    bench = json.loads((run.REPO / "BENCHMARK.json").read_text())
    cell = spec.load_cell(bench, args.workload, run.REPO)
    if not torch.cuda.is_available():
        print("hosttrace: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = measure(cell, args.seed, torch.device("cuda", 0), args.rounds)
    out["card"] = run.power_limit()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
