"""The program tracer's readers and the host cycle's attribution on made-up
spans, runtime calls and device operations whose answers are known, the
six metric readers on runs with and without what they read, and the light
window and host cycle at a tiny size on the CPU."""

from __future__ import annotations

from typing import NamedTuple

import pytest

from gsplat_tpu_torch.utils.stages import Span
from splatbench import hosttrace as ht
from splatbench import readers, spec
from splatbench.tests.tiny import CPU, tiny_cell
from splatbench.trace import Trace

MS = 1_000_000  # ns


def span(name, id, parent, start, end, sync=False, step=0, thread=1):
    return Span(name, id, parent, step, thread, start * MS, end * MS, None, None, sync)


def made_up(steps=1):
    """One step: the benchmark's step and backward around a preprocess and,
    on autograd's thread, the loss backward, a sync and the backward
    compositor; repeated ``steps`` times, 100 ms apart."""
    out = []
    for k in range(steps):
        t, i = 100 * k, 10 * k
        out += [span("bench.step", i, None, t, t + 100, step=k),
                span("preprocess", i + 1, i, t + 10, t + 30, step=k),
                span("bench.backward", i + 2, i, t + 40, t + 100, step=k),
                span("loss_bwd", i + 3, i + 2, t + 45, t + 50, step=k, thread=2),
                span("slice_sync", i + 4, i + 2, t + 55, t + 65, sync=True, step=k, thread=2),
                span("raster_bwd", i + 5, i + 2, t + 66, t + 80, step=k, thread=2)]
    return out


LAUNCH = {1: 15 * MS, 2: 46 * MS, 3: 70 * MS, 4: 5 * MS}  # 5: launch not recorded
OPS = [("k1", 1, 20 * MS, 30 * MS), ("k2", 2, 50 * MS, 60 * MS), ("k3", 3, 72 * MS, 90 * MS),
       ("k4", 4, 8 * MS, 12 * MS), ("k5", 5, 95 * MS, 97 * MS)]


def test_span_readers():
    spans = made_up(steps=2)
    # preprocess 20 + loss_bwd 5 + slice_sync 10 + raster_bwd 14, less the sync's 10
    assert ht.host_issue_ms(spans) == pytest.approx(39.0)
    assert ht.sync_wait_ms(spans) == pytest.approx(10.0)
    nested = made_up() + [span("binning", 9, 1, 12, 20)]  # inside preprocess: not outermost
    assert ht.host_issue_ms(nested) == pytest.approx(39.0)
    no_step = [s._replace(step=None) for s in spans]
    assert ht.host_issue_ms(no_step) is None and ht.sync_wait_ms(no_step) is None


def test_attribution_by_stage():
    by = ht.attribute(made_up(), LAUNCH, OPS, steps=1)
    assert by["preprocess"]["launches"] == 1 and by["preprocess"]["device_ms"] == pytest.approx(10.0)
    assert by["loss_bwd"]["launches"] == 1 and by["loss_bwd"]["device_ms"] == pytest.approx(10.0)
    assert by["raster_bwd"]["launches"] == 1 and by["raster_bwd"]["device_ms"] == pytest.approx(18.0)
    # k4 launched inside the benchmark's span alone; k5's launch unknown
    assert by[ht.OUTSIDE]["launches"] == 2 and by[ht.OUTSIDE]["device_ms"] == pytest.approx(6.0)
    # gaps: 12-20 (preprocess open), 30-50 (none: preprocess ends at 30),
    # 60-72 (slice_sync open), 90-95 (none)
    assert by["preprocess"]["idle_ms"] == pytest.approx(8.0)
    assert by["slice_sync"]["idle_ms"] == pytest.approx(12.0)
    assert by[ht.OUTSIDE]["idle_ms"] == pytest.approx(25.0)
    assert by["bench.step"]["host_ms"] == pytest.approx(100.0) and by["bench.step"]["launches"] == 0
    assert by["slice_sync"]["host_ms"] == pytest.approx(10.0)
    assert ht.launches(by) == 3 and ht.program_share(by) == pytest.approx(0.6)
    half = ht.attribute(made_up(), LAUNCH, OPS, steps=2)
    assert ht.launches(half) == 1.5 and half["raster_bwd"]["idle_ms"] == 0.0


def test_innermost_takes_the_span_that_started_last():
    spans = [span("backward", 0, None, 0, 100), span("raster_bwd", 1, 0, 10, 20, thread=2)]
    inner = ht._Innermost(spans)
    assert [inner.at(t * MS) for t in (5, 15, 20, 150)] == ["backward", "raster_bwd", "backward", ht.OUTSIDE]
    assert ht._Innermost([span("bench.step", 0, None, 0, 100)]).at(50 * MS) == ht.OUTSIDE


def test_counters_per_step():
    values = [("pairs", 0, 10), ("pairs", 0, 6), ("pairs", 1, 4), ("reduction", 1, 1), ("host_syncs", 1, 1)]
    got = ht.counters_per_step(values)
    assert got["pairs"] == {"per_step": 10.0, "records": 3}
    assert got["reduction"] == {"per_step": 0.5, "records": 1}


class Traced(NamedTuple):
    light: list
    by_stage: dict


NAMES = ["host_issue_ms", "sync_wait_ms", "launches"]


@pytest.mark.parametrize("kind", ["train", "render"])
def test_metric_readers(kind):
    by = ht.attribute(made_up(), LAUNCH, OPS, steps=1)
    run = readers.Run(kind, 1.0, 0.1, 1, [], Traced(made_up(), by))
    got = {n: spec.reader(f"{kind}.{n}")(run) for n in NAMES}
    assert got == pytest.approx({"host_issue_ms": 39.0, "sync_wait_ms": 10.0, "launches": 3.0})
    other = "render" if kind == "train" else "train"
    assert all(spec.reader(f"{other}.{n}")(run) is None for n in NAMES)


@pytest.mark.parametrize("trace", [None, Trace([[("preprocess", 0.0, 1.0)]], 0.01, 0.005, [], [], [], 10, 10),
                                   Traced([], {})])
def test_metric_readers_find_nothing(trace):
    """A run holding nothing for them to read (untraced, a trace without a
    light window or host cycle, an empty one): None, not an error."""
    for kind in ("train", "render"):
        run = readers.Run(kind, 1.0, 0.1, 1, [], trace)
        assert all(spec.reader(f"{kind}.{n}")(run) is None for n in NAMES)


@pytest.mark.parametrize("name", ["dense_5m.train", "dense_5m.render"])
def test_measure_on_the_cpu(name):
    """The light window and the host cycle at the tiny size: host numbers
    and counters, and no device operation to put down (the CPU has none)."""
    cell = tiny_cell(name)
    cell = cell._replace(traffic=dict(cell.traffic, trace_cycles=1))
    out = ht.measure(cell, 2147483659, CPU, rounds=1)
    kind = cell.traffic["loop"]
    assert out["steps"] == 3 and len(out["untraced_ms"]) == len(out["light_ms"]) == 1
    assert out[f"{kind}.host_issue_ms"] > 0 and out[f"{kind}.sync_wait_ms"] > 0
    assert out[f"{kind}.launches"] == 0 and out["program_launch_share"] is None
    assert out["by_stage"]["raster_fwd"]["host_ms"] > 0 and out["light_host_ms"]["raster_fwd"] > 0
    assert out["counters"]["slices"]["records"] == 3 and out["counters"]["host_syncs"]["per_step"] >= 1
