"""The frozen byte count of the mesh's gradient all-reduce
(``steps/mesh_train.py``), held to the H100's NVLink bandwidth.

Every rank holds the whole model, so a step sums the five raw parameters'
gradients over the world: 59 floats a row (``adam_counts.ROW_FLOATS``), 4
bytes each, over every row. The bus bytes of an all-reduce of S bytes over
n ranks are 2(n - 1)/n x S: what each rank sends (and receives) in a ring,
the measure NCCL's own tests report as bus bandwidth, whatever algorithm
NCCL takes. Peak: NVLink 4 on an H100 SXM5, 18 links of 25 GB/s each way,
450 GB/s a direction.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from splatbench.adam_counts import ROW_FLOATS

PEAK_NVLINK_BYTES = 450e9  # bytes/s, one direction
REPO = Path(__file__).resolve().parent.parent


def grad_bytes(rows: int) -> int:
    """Bytes of the gradients of ``rows`` rows."""
    return 4 * ROW_FLOATS * rows


def bus_bytes(rows: int, ranks: int) -> float:
    """Bus bytes of the gradient all-reduce over ``ranks`` ranks."""
    return 2.0 * (ranks - 1) / ranks * grad_bytes(rows)


def bus_bound_s(rows: int, ranks: int) -> float:
    return bus_bytes(rows, ranks) / PEAK_NVLINK_BYTES


def mesh_ranks(metric: str, repo: Path = REPO) -> Optional[int]:
    """The ranks of the mesh of the cells that ``BENCHMARK.json`` lists for
    ``metric``, or None where they differ or none has a mesh: a reader is
    not told which cell it reads (as ``adam_counts.pool_factor``)."""
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    listed = next(m for m in bench["per_layer"] if m["name"] == metric).get("workloads", [])
    files = {c["name"]: c["file"] for c in bench["configs"]}
    ranks = set()
    for w in bench["workloads"]:
        if w["name"] in listed:
            mesh = json.loads((repo / files[w["config"]]).read_text()).get("mesh")
            ranks.add(mesh["data"] * mesh["tile"] if mesh else None)
    return ranks.pop() if len(ranks) == 1 else None
