"""The per-layer readers on a made-up trace whose answers are known."""

from __future__ import annotations

import pytest

from splatbench import counts as C
from splatbench import readers, spec
from splatbench.reference.render import Counts
from splatbench.trace import Trace, _union


def made_up(kind):
    step = [("preprocess", 0.0, 2.0), ("pack_features", 2.0, 2.5), ("binning", 2.5, 3.0),
            ("raster_fwd", 3.0, 4.0), ("tiles_to_image", 4.0, 4.2), ("bench.loss", 4.2, 5.0),
            ("raster_bwd", 5.5, 6.5), ("reduction", 6.5, 7.0), ("bench.backward", 5.0, 9.0),
            ("bench.step", 0.0, 9.0)]
    if kind == "render":
        step = [("camera", 0.0, 0.5)] + step[:5]
    ops = [("void raster_fwd_kernel<1>", 0.0030, 0.0040), ("void raster_bwd_kernel<1>", 0.0055, 0.0065),
           ("elementwise", 0.0, 0.002)]
    c = Counts(in_box=1_000_000, passed=500_000, gaussians=10_000)
    return readers.Run(kind, 1.0, 0.02, 2, [], Trace([step, step], 0.02, 0.008, ops * 2, [], [c, c],
                                                      100_000, 2_000_000))


def read(name, run):
    return spec.reader(name)(run)


def test_train_readers():
    run = made_up("train")
    assert read("train.preprocess_ms", run) == pytest.approx(2.0)
    assert read("train.binning_ms", run) == pytest.approx(1.0)
    assert read("train.loss_ms", run) == pytest.approx(0.8 + 0.5)
    assert read("train.reduction_ms", run) == pytest.approx(0.5)
    assert read("train.preprocess_bwd_ms", run) == pytest.approx(2.0)
    assert read("train.device_idle_pct", run) == pytest.approx(60.0)
    assert read("train.device_busy_ms", run) == pytest.approx(4.0)
    fwd = 2 * C.compositor_bound_s(1_000_000, 500_000, 10_000, 2_000_000, False)
    assert read("train.raster_fwd_roofline_pct", run) == pytest.approx(100 * fwd / 0.002)
    ops = 2 * C.view_ops(100_000, 2_000_000, 1_000_000, 500_000, True)
    assert read("train.step_mfu_pct", run) == pytest.approx(100 * ops / (0.02 * 67e12))
    assert read("render.preprocess_ms", run) is None  # another cell's metric finds nothing


def test_render_readers():
    run = made_up("render")
    assert read("render.preprocess_ms", run) == pytest.approx(2.5)
    assert read("render.binning_ms", run) == pytest.approx(1.0)
    assert read("render.device_idle_pct", run) == pytest.approx(60.0)
    assert read("train.device_busy_ms", run) is None
    assert 0 < read("render.raster_fwd_roofline_pct", run) < 100


def test_without_a_trace_readers_find_nothing():
    run = readers.Run("train", 1.0, 2.0, 10, [], None)
    assert read("train.preprocess_ms", run) is None
    assert read("train.raster_fwd_roofline_pct", run) is None
    assert read("train.device_busy_ms", run) is None
    assert read("train_frames_per_s", run) == pytest.approx(5.0)
    assert read("render_p95_ms", readers.Run("render", 1.0, 2.0, 30, [float(i) for i in range(1, 31)], None)) \
        == pytest.approx(28.55)


def test_union_of_intervals():
    assert _union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == [(0, 3), (5, 6)]


def test_event_kinds_without_activity_type():
    """torch builds whose profiler events lack ``activity_type`` (2.11)."""
    import torch

    from splatbench.trace import _activity

    class Event:
        def __init__(self, device, user):
            self.device, self.user = device, user

        def device_type(self):
            return self.device

        def is_user_annotation(self):
            return self.user

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    assert [_activity(Event(cuda, False)), _activity(Event(cpu, False)), _activity(Event(cpu, True))] == \
        ["kernel", "cpu_op", "user_annotation"]
