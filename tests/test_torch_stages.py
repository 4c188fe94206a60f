"""The port's tracer (``gsplat_tpu_torch/utils/stages.py``) on the CPU: the
cost when off, the shared clock with ``torch.profiler``, the parent of a
span on another thread, the sync spans and counters of the sliced and the
compacted paths, and the overflow counter."""

from __future__ import annotations

import math
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.models.gaussians import random_model
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.render import sliced
from gsplat_tpu_torch.render.pipeline import preprocess
from gsplat_tpu_torch.train.loss import rgb_loss
from gsplat_tpu_torch.utils import stages

from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

W, H = 48, 32


def _scene(n=600, seed=3, grow=1.0):
    model = random_model(torch.Generator().manual_seed(seed), n, extent=0.8, device="cpu")
    with torch.no_grad():
        model.log_scales += grow
        model.means[:, 2] += 3.0
    f = 0.5 * W / math.tan(0.5)
    cam = tgs.CameraParams(W, H, 1.0, 2.0 * math.atan(H / (2.0 * f)), f, f, (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    return model, cam


def _demand(model, cam, cfg):
    arrays = tgs.CameraArrays.from_params(cam, device="cpu")
    with torch.no_grad():
        return int(tgs.binning_stats(model, arrays, W, H, cfg)["pair_demand"])


def _step(model, cam, cfg):
    """A render, the loss and the gradients to the parameters."""
    image, _ = tgs.render(model, cam, cfg)
    loss = rgb_loss(image, torch.full_like(image, 0.25), 0.2)
    return torch.autograd.grad(loss, list(model.parameters()))


def test_marks_off_read_one_global_and_nothing_else():
    """Outside ``record_stages`` no mark, sync flag, counter, step id or
    backward mark calls anything: one global read, then out."""
    x = torch.ones(3, requires_grad=True)
    calls = []

    def watch(frame, event, arg):
        if event == "call" and frame.f_back is not None and frame.f_back.f_code.co_filename == stages.__file__:
            calls.append(frame.f_code.co_name)
        elif event == "c_call" and frame.f_code.co_filename == stages.__file__:
            calls.append(getattr(arg, "__name__", repr(arg)))

    sys.setprofile(watch)
    try:
        with stages.stage("a"):
            pass
        with stages.sync("b"):
            pass
        with stages.step(4):
            pass
        stages.end(stages.begin("c"))
        stages.count("d", x)
        stages.count("e", x, above=1)
        y = stages.opens_backward("f", x)
        z = stages.closes_backward("g", x, x)
    finally:
        sys.setprofile(None)
    assert calls == []
    assert y is x and z == (x, x)


def test_off_adds_no_autograd_node_and_keeps_no_counter():
    """A train step's graph with recording off has the nodes it would have
    without the marks (those with recording on, less the four marks) and
    nothing is kept; on, the marks are in it."""
    model, cam = _scene()
    cfg = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 14)

    def nodes():
        image, _ = tgs.render(model, cam, cfg)
        loss = rgb_loss(image, torch.full_like(image, 0.25), 0.2)
        seen, todo, names = set(), [loss.grad_fn], []
        while todo:
            fn = todo.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            names.append(type(fn).__name__)
            todo.extend(f for f, _ in fn.next_functions)
        return sorted(names)

    off = nodes()
    assert stages._rec is None and stages._step is None
    with stages.record_stages() as rec:
        on = nodes()
    marks = [n for n in on if n == "_BackwardMarkBackward"]
    assert len(marks) == 4  # the loss, the tiles, feat and the preprocess's inputs
    assert "_BackwardMarkBackward" not in off
    assert off == [n for n in on if n != "_BackwardMarkBackward"]
    assert rec.counters  # pairs, demand, overflow: recorded only while on
    assert stages._rec is None


def test_step_is_marked_on_the_profiler_clock():
    """An aten op called inside a stage lies, on ``torch.profiler``'s
    clock, within that span's host interval."""
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stages.record_stages() as rec:
            with stages.step(7), stages.stage("matmul"):
                a @ a
    (span,) = rec.spans
    assert span.name == "matmul" and span.step == 7 and span.start is None
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert span.host_start_ns <= start <= end <= span.host_end_ns


def test_first_span_on_another_thread_takes_the_callers_span():
    """The first span on a thread (as on autograd's) has as parent the span
    open on the thread that waits on it; the spans after it on that thread
    nest as usual, and all carry the step id."""
    out = {}

    def worker():
        with stages.stage("inner"):
            with stages.stage("innermost"):
                out["thread"] = threading.get_native_id()

    with stages.record_stages() as rec:
        with stages.step(2), stages.stage("outer"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    by = {s.name: s for s in rec.spans}
    assert [name for name, _, _ in rec] == ["innermost", "inner", "outer"]
    assert by["inner"].parent == by["outer"].id and by["innermost"].parent == by["inner"].id
    assert by["outer"].parent is None
    assert by["inner"].thread == out["thread"] != by["outer"].thread
    assert {s.step for s in rec.spans} == {2}


def test_sliced_render_records_its_slices_and_syncs():
    """A sliced step with ``reduce_pairs`` set: one ``slices`` count, a
    ``pairs`` count a slice (summing to the slices' pairs), a
    ``slice_sync`` span and a ``host_syncs`` count for each host sync the
    loop made, and one more for the backward's compaction check."""
    model, cam = _scene(n=900, grow=1.3)
    cfg = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 15, slice_pairs=64,
                           reduce_pairs=1 << 12, early_stop_transmittance=1e-4)
    with torch.no_grad():
        prep = preprocess(model, cam, cfg)
        feat = binning.pack_features(prep)
        d = sliced._prepare_sliced(prep, 16, 3, 2)
        _, _, want = sliced._forward_impl(feat, d, W, H, cfg)
    k = len(want.ids)
    assert k > 1 and want.host_syncs >= 1
    with stages.record_stages() as rec:
        with stages.step(0):
            _step(model, cam, cfg)
    counts = {}
    for name, step, value in rec.counter_values():
        assert step == 0
        counts.setdefault(name, []).append(value)
    assert counts["slices"] == [k]
    assert len(counts["pairs"]) == k
    n = d.order.shape[0]
    assert sum(counts["pairs"]) == sum(int((ids != n).sum()) for ids in want.ids)
    syncs = [s for s in rec.spans if s.sync]
    assert [s.name for s in syncs] == ["slice_sync"] * (want.host_syncs + 1)
    assert sum(counts["host_syncs"]) == want.host_syncs + 1
    assert counts["reduction"] in ([0], [1])
    assert "slice_budget_hit" not in counts
    names = [s.name for s in rec.spans]
    assert names.count("raster_fwd") == k and names.count("raster_bwd") == k
    assert names.count("slice_loop") == names.count("slice_loop_bwd") == 1


def test_compacted_reduction_records_its_sync():
    """Unsliced with ``reduce_pairs`` below the pair buffer: the backward's
    count of walked blocks is the sync span ``reduction_sync`` inside
    ``reduction``, and the ``reduction`` counter says whether the compacted
    reduction ran."""
    model, cam = _scene()
    demand = _demand(model, cam, tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 15))
    for reduce_pairs, compacted in ((1 << 14, 1), (8, 0)):
        cfg = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 15, reduce_pairs=reduce_pairs)
        assert demand < reduce_pairs or not compacted
        with stages.record_stages() as rec:
            _step(model, cam, cfg)
        by_id = {s.id: s for s in rec.spans}
        (sync,) = [s for s in rec.spans if s.sync]
        assert sync.name == "reduction_sync" and by_id[sync.parent].name == "reduction"
        counts = {name: value for name, _, value in rec.counter_values()}
        assert counts["reduction"] == compacted and counts["host_syncs"] == 1


def test_overflow_counts_the_demand_above_capacity():
    model, cam = _scene()
    demand = _demand(model, cam, tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 15))
    for max_pairs in (1 << 15, 256):
        cfg = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=max_pairs)
        with stages.record_stages() as rec:
            _step(model, cam, cfg)
        counts = {name: value for name, _, value in rec.counter_values()}
        assert counts["pair_demand"] == demand
        assert counts["overflow"] == max(demand - max_pairs, 0)
        # Under overflow the deepest whole gaussians are dropped.
        assert counts["pairs"] == demand if demand <= max_pairs else 0 < counts["pairs"] <= max_pairs
    assert demand > 256


def test_backward_marks_bound_the_loss_and_preprocess_backward():
    """``loss_bwd`` ends before the rasterizer's backward starts and
    ``preprocess_bwd`` starts after its reduction ends, both inside the
    caller's span around the backward; a render under no grad adds none."""
    model, cam = _scene()
    cfg = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 14)
    with stages.record_stages() as rec:
        with stages.step(1):
            image, _ = tgs.render(model, cam, cfg)
            loss = rgb_loss(image, torch.full_like(image, 0.25), 0.2)
            with stages.stage("backward"):
                torch.autograd.grad(loss, list(model.parameters()))
            with torch.no_grad():
                tgs.render(model, cam, cfg)
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
    (lb,), (rb,), (red,), (pb,), (back,) = (by[n] for n in ("loss_bwd", "raster_bwd", "reduction", "preprocess_bwd",
                                                             "backward"))
    assert back.host_start_ns <= lb.host_start_ns <= lb.host_end_ns <= rb.host_start_ns
    assert red.host_end_ns <= pb.host_start_ns <= pb.host_end_ns <= back.host_end_ns
    assert {lb.parent, rb.parent, red.parent, pb.parent} == {back.id}
    assert len(by["loss"]) == 1 and len(by["raster_fwd"]) == 2
    assert {s.step for s in rec.spans} == {1}


@pytest.mark.parametrize("available, events", [(False, True), (True, True), (True, False)])
def test_record_stages_keeps_its_list_of_events(monkeypatch, available, events):
    """The recording is the list of ``(name, start event, end event)`` it
    always was, in the order spans end; CUDA events only where CUDA is
    available and unless asked for host time alone."""

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self):
            pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    with stages.record_stages(events=events) as rec:
        with stages.stage("a"):
            with stages.stage("b"):
                pass
    assert [name for name, _, _ in rec] == ["b", "a"]
    assert [s.name for s in rec.spans] == ["b", "a"] and all(s.host_end_ns >= s.host_start_ns for s in rec.spans)
    kept = available and events
    assert all((isinstance(x, Event) if kept else x is None) for _, s, e in rec for x in (s, e))
