"""The gradient all-reduce's bus bytes (``mesh_counts.py``: 2(n - 1)/n x
the 59 floats of every row, over the mesh's n ranks) over the time of the
program's ``grad_all_reduce`` spans, as a share of NVLink 4's 450 GB/s a
direction, a step."""

from splatbench import mesh_counts, readers

NAME = "train.grad_all_reduce_busbw_pct"


def read(run):
    if run.kind != "train":
        return None
    ms = readers.per_step_ms(run, ["grad_all_reduce"])
    ranks = mesh_counts.mesh_ranks(NAME) if ms else None
    if ranks is None:
        return None
    return 100.0 * mesh_counts.bus_bound_s(run.trace.n_gaussians, ranks) / (ms / 1e3)
