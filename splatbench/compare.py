"""The comparison that decides ``correct``: the numbers compared between
an answer of the timed path and the reference's answer at the same pose
(each loop's ``numbers`` in ``steps/<loop>.py``, on the helpers here), and
their limits (``limits/<cell>.json``, set from measured readings:
``PERF.md`` gives them).

  * ``image_rms``: root mean square over the frame's pixels and channels of
    the difference of the two frames, less the early stop's allowance (a
    pixel's colour and transmittance may differ from the exact composite by
    the early-stop threshold the configuration states).
  * ``image_block_rms``: the largest such root mean square over the
    frame's 32x32 pixel blocks (a wrong block is a small share of a
    1920x1080 frame).
  * ``trans_rms`` (``render``): the same for the transmittance.
  * ``loss_rel``, ``grad_rel`` (``train``): the loss's and the gradients'
    relative gaps (``steps/train.py``).

A run takes, for each number, the worst of its compared answers.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from splatbench import spec


def _excess(a: torch.Tensor, b: torch.Tensor, allowance: float) -> torch.Tensor:
    return torch.clamp((a.double() - b.double()).abs() - allowance, min=0.0)


def _rms(a: torch.Tensor, b: torch.Tensor, allowance: float) -> float:
    d = _excess(a, b, allowance)
    return math.sqrt(float((d * d).mean()))


def _block_rms(a: torch.Tensor, b: torch.Tensor, allowance: float, edge: int = 32) -> float:
    d = _excess(a, b, allowance)
    sq = (d * d).sum(-1)  # [H, W]
    h, w = sq.shape
    ph, pw = -(-h // edge) * edge, -(-w // edge) * edge
    pad = torch.nn.functional.pad(sq, (0, pw - w, 0, ph - h))
    count = torch.nn.functional.pad(torch.ones_like(sq), (0, pw - w, 0, ph - h))
    sums = pad.reshape(ph // edge, edge, pw // edge, edge).sum((1, 3))
    n = count.reshape(ph // edge, edge, pw // edge, edge).sum((1, 3)) * d.shape[-1]
    return math.sqrt(float((sums / n).max()))


def frame_numbers(got, want, allowance: float) -> Dict[str, float]:
    """``image_rms`` and ``image_block_rms`` of the two frames."""
    return {"image_rms": _rms(got.image, want.image, allowance),
            "image_block_rms": _block_rms(got.image, want.image, allowance)}


def numbers(kind: str, got, want, allowance: float = 0.0, root: Path = spec.HERE) -> Dict[str, float]:
    """The numbers of the loop ``kind`` (a mix's ``"loop"``), by its step
    file under ``root``. ``allowance``: the early stop's transmittance
    threshold, by which the configuration lets a pixel's colour and
    transmittance differ from the exact composite; the frame and
    transmittance numbers count only what exceeds it."""
    return spec.step_file(kind, root).numbers(got, want, allowance)


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst (largest) reading; NaN counts as worst."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            if k not in out or not v <= out[k]:
                out[k] = v
    return out


def load_limits(root: Path, workload: str) -> Dict[str, float]:
    return json.loads((root / "limits" / f"{workload}.json").read_text())["limits"]


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Every number at or under its limit (a NaN or a missing number is
    not). Returns (correct, {name: {"value", "limit"}})."""
    checks = {k: {"value": values.get(k, float("nan")), "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
