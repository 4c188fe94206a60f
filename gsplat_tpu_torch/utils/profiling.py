"""Profiling and benchmark helpers, as ``gsplat_tpu/utils/profiling.py``.

``timed`` / ``benchmark_stats`` measure steady-state time on the host clock,
and ``trace`` wraps ``torch.profiler`` for kernel-level inspection in
Perfetto or ``chrome://tracing``.

Fencing: PyTorch returns from a CUDA call before the device has finished,
so every timed call is followed by ``torch.cuda.synchronize`` on the device
of the result's first CUDA tensor. A result that holds no CUDA tensor (a
CPU run) is complete when the call returns and takes no fence.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


def _first_tensor(result):
    """The first tensor among ``result``'s leaves (tensors inside tuples,
    lists, dicts and named tuples, in order), or None."""
    if isinstance(result, torch.Tensor):
        return result
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        for item in result:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def _fence(result):
    """Wait until ``result`` is computed: synchronise the CUDA device its
    first tensor lives on; nothing for a result on the CPU."""
    leaf = _first_tensor(result)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return result


def timed(fn: Callable, *args, warmup: int = 2, iters: int = 10, **kwargs):
    """Run fn with warmup, return (mean_seconds, last_result)."""
    result = None
    for _ in range(warmup):
        result = _fence(fn(*args, **kwargs))
    start = time.perf_counter()
    for _ in range(iters):
        result = _fence(fn(*args, **kwargs))
    elapsed = (time.perf_counter() - start) / iters
    return elapsed, result


def benchmark_stats(fn: Callable, *args, warmup: int = 2, iters: int = 10, **kwargs) -> Dict[str, float]:
    """Per-iteration timing stats: mean/min/max/p50 in seconds."""
    for _ in range(warmup):
        _fence(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        _fence(fn(*args, **kwargs))
        times.append(time.perf_counter() - start)
    times.sort()
    return {
        "mean_s": sum(times) / len(times),
        "min_s": times[0],
        "max_s": times[-1],
        "p50_s": times[len(times) // 2],
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block of work with ``torch.profiler`` (CPU activity, and
    CUDA activity where a card is present) and write its Chrome trace to
    ``<log_dir>/trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
