"""Where the harness finds a cell's parts, by the names in
``BENCHMARK.json`` and in the files they lead to: the configuration in the
file its entry names, the traffic mix in ``traffic/<traffic>.json``, the
limits in ``limits/<cell>.json``, each metric's reader in
``metrics/<metric>.py``, the mix's loop in ``steps/<loop>.py`` (its
``"loop"``), the configuration's scene in ``scenes/<scene>.py`` (its
``"scene"``; ``synthetic`` where it names none). Each is found under the
harness's root, so a copy of the harness runs its own files. Adding a
configuration, a mix, a cell, a metric, a loop or a scene adds files and
entries and edits none.

A step file ``steps/<loop>.py`` gives:

  * ``KIND``: ``"train"`` or ``"render"``, the family of metrics its runs
    report (``readers.Run.kind``); the window fences each call of a
    ``render`` loop and records its latency, and only the window's end of
    a ``train`` loop;
  * ``prepare(prog)``: what the step holds beyond ``loops.Program``'s
    common set-up;
  * ``step(prog, i) -> Answer``: the timed call at ``prog.pose_of(i)``,
    with the ``half`` and ``altered`` faults applied where they arise;
  * ``reference(params, pose, config, traffic, dtype, entries) ->
    (Answer, Counts)``: the plain reference's answer to that call;
  * ``numbers(got, want, allowance) -> dict``: the numbers compared.

A scene file ``scenes/<scene>.py`` gives ``build(config, seed, device)``:
the five raw parameters (``scene.PARAM_NAMES``), float32, drawn from the
seed on the device.
"""

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


def _module(root: Path, folder: str, name: str):
    """The module of ``<root>/<folder>/<name>.py``, loaded from its path."""
    path = root / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"splatbench_{folder}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = HERE):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return _module(root, "metrics", metric).read


def step_file(loop: str, root: Path = HERE):
    """The step file ``steps/<loop>.py`` of a mix's ``"loop"``."""
    return _module(root, "steps", loop)


def scene_file(config: dict, root: Path = HERE):
    """The scene file ``scenes/<scene>.py`` of a configuration's
    ``"scene"`` (``synthetic`` where it names none)."""
    return _module(root, "scenes", config.get("scene", "synthetic"))
