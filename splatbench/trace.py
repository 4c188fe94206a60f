"""The traced run: a fixed number of steps under ``torch.profiler`` with the
program's stage marks recording (``gsplat_tpu_torch.utils.stages``), read
into a :class:`Trace` that the per-layer readers take their numbers from.

Spans are CUDA events in stream order, in milliseconds from an event
recorded where the window starts, grouped by step. Device operations
(kernels, copies, sets) come from the profiler's device activity;
``busy_s`` is the union of their intervals and ``window_s`` the window's
length on CUDA events. A window in which the profiler records no device
operation is an error, not a zero.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, NamedTuple, Tuple

import torch

from splatbench.loops import Program, Window, run_window

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")

Span = Tuple[str, float, float]  # name, start ms, end ms


class Trace(NamedTuple):
    steps: List[List[Span]]  # each step's spans, inner ones first
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]  # device operations: name, start s, end s (from the window's start)
    gaps: List[Tuple[str, float]]  # idle seconds by what the host was doing, longest first
    counts: list  # per step: reference.render.Counts of its pose
    n_gaussians: int
    pixels: int


def _activity(e) -> str:
    """The event's kind (``kernel``, ``gpu_memcpy``, ``cpu_op``, ...). Builds
    of torch whose events have no ``activity_type`` (2.11, on the card's
    machine) are told apart by device type."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    user = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if user else "kernel"
    return "user_annotation" if user else "cpu_op"


def _ns(e) -> Tuple[int, int]:
    start = e.start_ns()
    return start, start + e.duration_ns()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _host_at(starts: List[int], ops: list, t: int) -> str:
    """The innermost host operation running at ``t`` (ns)."""
    i = bisect.bisect_right(starts, t) - 1
    best = None
    for j in range(i, max(i - 200, -1), -1):
        s, e, name = ops[j]
        if e >= t:
            best = name
            break
    return best or "host: between operations"


def _device_ops(events) -> List[Tuple[str, int, int]]:
    return [(e.name(), *_ns(e)) for e in events if _activity(e) in DEVICE_ACTIVITIES]


def idle_by_host(prof) -> List[Tuple[str, float]]:
    """Idle seconds of the device between its first and last operation,
    by the innermost host operation running where each gap starts."""
    events = prof.profiler.kineto_results.events()
    ops = _device_ops(events)
    if not ops:
        return []
    host = sorted((*_ns(e), e.name()) for e in events if _activity(e) == "cpu_op")
    starts = [h[0] for h in host]
    busy = _union([(s, t) for _, s, t in ops])
    idle = defaultdict(float)
    for (_, t0), (s1, _) in zip(busy, busy[1:]):
        idle[_host_at(starts, host, t0)] += (s1 - t0) / 1e9
    return sorted(idle.items(), key=lambda kv: -kv[1])


def traced_window(prog: Program, steps: int, plan: tuple, device) -> Tuple[Window, Trace]:
    """Run ``steps`` steps with the program's stage marks recording and the
    profiler tracing the device alone (CUPTI activity, no host-side
    recording, which would slow the host and inflate the idle share). The
    window is timed by CUDA events from before the first step to after the
    last. Then one cycle more under host and device tracing, read only for
    what the host was doing while the device idled. The returned Trace has
    no counts yet (the reference fills them)."""
    from torch.profiler import ProfilerActivity, profile

    from gsplat_tpu_torch.utils.stages import record_stages, stage

    per_step: List[Tuple[int, int]] = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_stages() as spans:
            base, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            base.record()

            def on_step(i):
                k = len(spans)
                with stage("bench.step"):
                    out = prog.step(i)
                per_step.append((k, len(spans)))
                return out

            window = run_window(prog, 0.0, plan, device, steps=steps, on_step=on_step)
            end.record()
            torch.cuda.synchronize(device)
            steps_spans = [[(name, base.elapsed_time(a), base.elapsed_time(b)) for name, a, b in spans[k:m]]
                           for k, m in per_step]
            window_s = base.elapsed_time(end) / 1e3
    ops = _device_ops(prof.profiler.kineto_results.events())
    if not ops:
        raise RuntimeError("the profiler recorded no device operation in the traced window")
    first = min(s for _, s, _ in ops)
    ops = [(name, (s - first) / 1e9, (t - first) / 1e9) for name, s, t in ops]
    busy_s = sum(t - s for s, t in _union([(s, t) for _, s, t in ops]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as host_prof:
        run_window(prog, 0.0, plan, device, steps=len(prog.poses))
        torch.cuda.synchronize(device)
    gaps = idle_by_host(host_prof)
    n = prog.model.means.shape[0]
    return window, Trace(steps_spans, window_s, busy_s, ops, gaps, [], n, prog.width * prog.height)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    time by what the host was doing, in seconds over the traced window."""
    by_name = defaultdict(float)
    for name, s, t in trace.ops:
        by_name[name[:160]] += t - s
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k[:160], v] for k, v in trace.gaps[:top]]}
