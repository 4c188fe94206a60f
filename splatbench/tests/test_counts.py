"""The frozen count arithmetic: the reference's pixel-entry counts against
a brute-force loop over gaussians and pixels, and the bounds' arithmetic."""

from __future__ import annotations

import math

import pytest
import torch

from splatbench import counts as C
from splatbench import scene
from splatbench.reference import render as R
from splatbench.tests.tiny import CPU


def brute_force(params, cam, stop: float):
    """Walk every active gaussian in depth order over every pixel of the
    frame; count the entries inside its box and its reach (|x - mean| within
    the reach radius plus one), up to each pixel's stop, and those whose
    alpha passes the gate."""
    p = [x.double() for x in params]
    proj = R.project(p, cam, 3)
    f = proj.feat.detach()
    means, log_scales, quats, opacity_logits, sh = p
    w, h = cam.width, cam.height
    xs = torch.arange(w, dtype=torch.float64)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=torch.float64)[:, None].expand(h, w)
    trans = torch.ones((h, w), dtype=torch.float64)
    in_box = passed = 0
    gaussians = set()
    for g in proj.order.tolist():
        x0, y0, x1, y1 = proj.box[g].tolist()
        inside = (xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)
        dx, dy = f[g, 0] - xs, f[g, 1] - ys
        density = -0.5 * (f[g, 2] * dx * dx + f[g, 3] * dy * dy) - f[g, 4] * dx * dy
        alpha = torch.clamp(f[g, 5] * torch.exp(density), max=R.MAX_ALPHA)
        gate = (alpha > R.MIN_ALPHA) & (density <= 0)
        on = inside & (trans >= stop) if stop > 0 else inside
        in_box += int(on.sum())
        passed += int((on & gate).sum())
        if bool(on.any()):
            gaussians.add(g)
        trans = torch.where(on & gate, trans * (1 - alpha), trans)
    return in_box, passed, len(gaussians)


@pytest.mark.parametrize("shift,stop", [(0.6, 0.0), (2.5, 1e-4)])
def test_entry_counts_match_a_brute_force_loop(shift, stop):
    params = scene.build_scene(400, shift, 3, CPU)
    cam = R.camera(48, 40, 0.05, 0.5, torch.float64, CPU)
    view = R.render([x.double() for x in params], cam, 3, stop, entries=1 << 12)
    assert (view.counts.in_box, view.counts.passed, view.counts.gaussians) == brute_force(params, cam, stop)
    assert view.counts.passed > 0


def test_bounds_arithmetic():
    s = C.compositor_bound_s(1_000_000, 400_000, 10_000, 2_000_000, backward=False)
    ops = (1_000_000 * 19 + 400_000 * 9) / 67e12
    assert s == pytest.approx(max(ops, 1_000_000 / C.PEAK_SFU, (10_000 * 64 + 2_000_000 * 16) / 3.35e12))
    assert C.view_ops(10, 100, 1000, 400, train=False) == 10 * C.PREPROCESS_OPS + 1000 * 19 + 400 * 9
    train = C.view_ops(10, 100, 1000, 400, train=True)
    assert train == pytest.approx(10 * 3 * C.PREPROCESS_OPS + 2000 * 19 + 400 * 52 + 300 * (243 + 162 + 5))
    assert math.isfinite(train)
