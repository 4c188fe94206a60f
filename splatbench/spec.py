"""Where the harness finds a cell's parts, by the names in
``BENCHMARK.json``: the configuration in the file its entry names, the
traffic mix in ``traffic/<traffic>.json``, the limits in
``limits/<cell>.json``, each metric's reader in ``metrics/<metric>.py``.
Adding a configuration, a mix, a cell or a metric adds files and entries and
edits none."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[str]  # metric names this cell reports with --trace 0
    per_layer: List[str]  # ... and with --trace 1


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, repo: Path, root: Path = HERE) -> Cell:
    """The cell ``name`` of the parsed ``BENCHMARK.json`` ``bench``; ``repo``
    is the checkout's root, ``root`` the harness's directory."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((repo / conf["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m["name"] for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = set(e2e)
    per_layer = [m["name"] for m in bench["per_layer"] if m["moves"] in e2e_names and _reports(m, name)]
    return Cell(name, w["chips"], config, traffic, e2e, per_layer)


def reader(metric: str, root: Path = HERE):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"splatbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
