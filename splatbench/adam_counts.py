"""The frozen byte count of the recipe's optimizer step: Adam over every
row the optimizer holds, held to the H100's HBM peak (``counts.py``).

An Adam update must read each element's parameter, gradient and two
moments and write back the parameter and the two moments: seven 4-byte
accesses an element, whatever the number of kernels it takes. A row
holds 59 parameters (position 3, log scales 3, quaternion 4, opacity
logit 1, SH 48). With densification the optimizer holds the pool, the
configuration's ``recipe.pool_factor`` times the live scene
(``reference/fit.py::pool_rows``); without, the scene's own rows.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from splatbench.counts import PEAK_HBM_BYTES
from splatbench.reference.fit import pool_rows

ROW_FLOATS = 3 + 3 + 4 + 1 + 48
ADAM_ACCESSES = 7
REPO = Path(__file__).resolve().parent.parent


def adam_bytes(rows: int) -> int:
    """Bytes one Adam update over ``rows`` rows must move."""
    return ADAM_ACCESSES * 4 * ROW_FLOATS * rows


def adam_bound_s(rows: int) -> float:
    return adam_bytes(rows) / PEAK_HBM_BYTES


def pool_factor(metric: str, repo: Path = REPO) -> Optional[float]:
    """The pool factor of the cells that ``BENCHMARK.json`` lists for
    ``metric`` (1 for a configuration without a recipe pool), or None where
    they differ: a reader is not told which cell it reads, so it charges a
    pool only where every cell it may read has the same."""
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    listed = next(m for m in bench["per_layer"] if m["name"] == metric).get("workloads", [])
    files = {c["name"]: c["file"] for c in bench["configs"]}
    factors = set()
    for w in bench["workloads"]:
        if w["name"] in listed:
            config = json.loads((repo / files[w["config"]]).read_text())
            factors.add(float(config.get("recipe", {}).get("pool_factor", 1.0)))
    return factors.pop() if len(factors) == 1 else None


def optimized_rows(n_live: int, metric: str, repo: Path = REPO) -> Optional[int]:
    """The rows Adam updates in a run of ``n_live`` live gaussians, or None
    where the pool factor is not one (``pool_factor``)."""
    factor = pool_factor(metric, repo)
    return None if factor is None else (pool_rows(n_live, factor) if factor != 1.0 else n_live)
