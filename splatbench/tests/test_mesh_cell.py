"""The mesh cell (``steps/mesh_train.py``) end to end on the CPU at
``tiny.py``'s size, its four ranks over gloo: it comes out correct with the
per-shard capacity and demand in the program's place, and the ``half`` and
``altered`` faults fail it."""

from __future__ import annotations

import pytest

from splatbench import mesh_world
from splatbench.tests.tiny import run_tiny, tiny_cell

CELL = "dense_5m_tile1x4.train"


@pytest.fixture(scope="module")
def cell():
    yield tiny_cell(CELL)
    mesh_world.close()


def test_the_mesh_cell_is_correct(cell):
    result = run_tiny(cell)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 3
    assert set(result["metrics"]) == {"setup_s", "train_frames_per_s"}
    world = mesh_world._world
    assert world is not None and len(world.procs) == 3 and all(p.is_alive() for p in world.procs)


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_a_planted_fault_fails_the_mesh_cell(cell, fault):
    result = run_tiny(cell, fault=fault)
    assert result["correct"] is False, result["checks"]


def test_the_peers_stop_with_the_world(cell):
    run_tiny(cell)
    procs = mesh_world._world.procs
    mesh_world.close()
    assert mesh_world._world is None and not any(p.is_alive() for p in procs)


def test_the_mesh_readers():
    """The three readers on a made-up trace whose answers are known, and
    nothing to read where a step has none of their spans."""
    from splatbench import mesh_counts, readers, spec
    from splatbench.trace import Trace

    step = [("gather", 1.0, 1.5), ("frame_gather", 3.0, 3.25), ("gather_bwd", 4.0, 4.75), ("gather_bwd", 5.0, 5.5),
            ("grad_all_reduce", 6.0, 10.0)]
    n = 5_000_000
    run = readers.Run("train", 1.0, 0.02, 2, [], Trace([step, step], 0.02, 0.01, [], [], [], n, 1920 * 1080))
    assert spec.reader("train.gather_ms")(run) == pytest.approx(2.0)
    assert spec.reader("train.grad_all_reduce_ms")(run) == pytest.approx(4.0)
    bus = 1.5 * 4 * 59 * n  # 2(n - 1)/n of the gradients' bytes over 4 ranks
    assert mesh_counts.mesh_ranks("train.grad_all_reduce_busbw_pct") == 4
    assert spec.reader("train.grad_all_reduce_busbw_pct")(run) == pytest.approx(100 * bus / 450e9 / 4e-3)
    bare = readers.Run("train", 1.0, 0.02, 2, [], Trace([[("binning", 0.0, 1.0)]], 0.02, 0.01, [], [], [], n, 1))
    for name in ("train.gather_ms", "train.grad_all_reduce_ms", "train.grad_all_reduce_busbw_pct"):
        assert spec.reader(name)(bare) is None
