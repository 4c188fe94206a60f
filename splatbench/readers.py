"""What the metric readers under ``splatbench/metrics/`` share.

A reader is a file ``metrics/<metric name>.py`` with ``read(run)``, which
returns the metric's value or None where the run holds nothing for it to
read (the harness then leaves the metric out). ``run`` is a :class:`Run`:
the host clock's record of the window, and in a traced run its
:class:`splatbench.trace.Trace`.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional

from splatbench import counts as C


class Run(NamedTuple):
    kind: str  # the step file's KIND: "train" or "render"
    setup_s: float
    window_s: float  # host seconds of the window, from its first call to the fence after its last
    completed: int
    latencies_ms: List[float]  # per request (render)
    trace: Optional[object]  # splatbench.trace.Trace in a traced run


def spans(step, names: Iterable[str]):
    names = set(names)
    return [s for s in step if s[0] in names]


def per_step_ms(run: Run, names: Iterable[str]) -> Optional[float]:
    """Mean over the traced steps of the summed duration of the named
    spans; None where no step has one."""
    t = run.trace
    if t is None or not t.steps:
        return None
    names = list(names)
    found = [spans(step, names) for step in t.steps]
    if not any(found):
        return None
    return sum(e - s for f in found for _, s, e in f) / len(t.steps)


def kernel_s(run: Run, marker: str) -> float:
    """Device seconds of the operations whose name holds ``marker``."""
    return sum(e - s for name, s, e in run.trace.ops if marker in name)


def roofline_pct(run: Run, marker: str, backward: bool) -> Optional[float]:
    """The frozen bound of the traced steps' compositor work over the
    device time of the kernels named ``marker``, in percent."""
    t = run.trace
    if t is None or not t.counts:
        return None
    busy = kernel_s(run, marker)
    if busy <= 0.0:
        return None
    bound = sum(C.compositor_bound_s(c.in_box, c.passed, c.gaussians, t.pixels, backward) for c in t.counts)
    return 100.0 * bound / busy


def mfu_pct(run: Run, train: bool) -> Optional[float]:
    """The traced steps' frozen FP32 count over (window time x the FP32
    peak), in percent."""
    t = run.trace
    if t is None or not t.counts or t.window_s <= 0.0:
        return None
    ops = sum(C.view_ops(t.n_gaussians, t.pixels, c.in_box, c.passed, train) for c in t.counts)
    return 100.0 * ops / (t.window_s * C.PEAK_FP32_OPS)


def idle_pct(run: Run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
