"""The preprocess's dispatch between the CUDA kernels (``kernels/preprocess.py``,
``csrc/preprocess.cu``) and the eager autograd path, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``).
Here: CPU tensors take the plain path and count ``preprocess_kernel`` 0
(and, under a gradient, ``preprocess_bwd_kernel`` 0); the predicate
``takes_kernel`` as a function, on stand-ins that carry a CUDA device;
``preprocess_traced`` with that predicate seeing the CPU tensors as CUDA
ones, so that each of its branches runs (the kernels' wrappers replaced by
recorders that return the plain versions), the autograd Function's
plumbing among them; gradients through the eager path unchanged; the
wrappers' refusals of what is not a CUDA float32 tensor, on CPU and meta
tensors; and the kernels' bytes bounds.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.kernels import preprocess as kp
from gsplat_tpu_torch.models.gaussians import random_model
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.render import pipeline
from gsplat_tpu_torch.utils import stages

from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

W, H = 48, 32
CFG = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 14)


def _scene(n=300, seed=5):
    model = random_model(torch.Generator().manual_seed(seed), n, extent=0.8, device="cpu")
    with torch.no_grad():
        model.means[:, 2] += 3.0
        model.means[:20, 2] -= 3.5  # behind the near plane: culled, inactive
    f = 0.5 * W / math.tan(0.5)
    camera = tgs.CameraParams(W, H, 1.0, 2.0 * math.atan(H / (2.0 * f)), f, f, (1.0, 0.0, 0.0, 0.0), (0.1, 0.0, 0.0))
    return model, tgs.CameraArrays.from_params(camera, device="cpu")


def _counted(fn, counter="preprocess_kernel"):
    """``fn()`` under the tracer; returns its result and the values of the
    counter ``counter`` (or of each counter of a tuple)."""
    with stages.record_stages() as rec:
        out = fn()
    values = rec.counter_values()
    names = counter if isinstance(counter, tuple) else (counter,)
    counts = [[v for name, _, v in values if name == n] for n in names]
    return out, (counts if isinstance(counter, tuple) else counts[0])


def _plain(model, cam, cfg=CFG, screen_offset=None):
    return kp.preprocess_plain(model.means, model.sh, model.quats, model.scales(), model.opacity(), cam, W, H,
                               cfg.sh_degree, cfg.strict_parity, screen_offset)


def _assert_equal(got, want):
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _seen_on_card(t):
    return SimpleNamespace(device=torch.device("cuda"), dtype=t.dtype, requires_grad=t.requires_grad)


@pytest.fixture
def as_if_on_card(monkeypatch):
    """``preprocess_traced``'s predicate sees every tensor as a CUDA one."""
    real = kp.takes_kernel

    def seen(inputs, cam, off=None):
        return real([_seen_on_card(t) for t in inputs], [_seen_on_card(t) for t in cam],
                    None if off is None else _seen_on_card(off))

    monkeypatch.setattr(pipeline, "takes_kernel", seen)


def test_cpu_tensors_take_the_plain_path():
    model, cam = _scene()
    with torch.no_grad():
        prep, counts = _counted(lambda: pipeline.preprocess_traced(model, cam, W, H, CFG))
        want = _plain(model, cam)
    assert counts == [0]
    _assert_equal(prep, want)
    assert prep.active.any() and not prep.active.all()


@pytest.mark.parametrize("case, grad_on, expected", [
    ("card", True, True),
    ("card", False, True),
    ("float64", False, False),
    ("cpu", False, False),
    ("mixed_devices", False, False),
    ("screen_offset", False, True),
    ("screen_offset", True, True),
    ("cpu_screen_offset", False, False),
    ("requires_grad", True, True),
    ("requires_grad", False, True),
    ("camera_requires_grad", True, False),
    ("camera_requires_grad", False, True),
])
def test_takes_kernel(case, grad_on, expected):
    """CUDA float32 inputs, camera and screen offset: the kernels, with or
    without a gradient and an offset; a gradient to take with respect to
    the camera (the backward kernel computes none), a tensor off the card
    or of another dtype: the eager path."""
    def t(device="cuda", dtype=torch.float32, requires_grad=False):
        return SimpleNamespace(device=torch.device(device), dtype=dtype, requires_grad=requires_grad)

    inputs, cam = [t() for _ in range(5)], [t() for _ in range(5)]
    offset = None
    if case == "float64":
        inputs[1] = t(dtype=torch.float64)
    elif case == "cpu":
        inputs, cam = [t("cpu") for _ in inputs], [t("cpu") for _ in cam]
    elif case == "mixed_devices":
        cam[2] = t("cpu")  # one camera tensor left on the host
    elif case == "screen_offset":
        offset = t(requires_grad=True)
    elif case == "cpu_screen_offset":
        offset = t("cpu")
    elif case == "requires_grad":
        inputs[0] = t(requires_grad=True)
    elif case == "camera_requires_grad":
        cam[0] = t(requires_grad=True)
    with torch.set_grad_enabled(grad_on):
        assert kp.takes_kernel(inputs, cam, offset) is expected


def test_grad_free_preprocess_takes_the_kernel(as_if_on_card, monkeypatch):
    """Under ``torch.no_grad`` (and ``inference_mode``) the preprocess calls
    the kernel's wrapper once, with the model's activated inputs and the
    camera, and counts 1."""
    model, cam = _scene()
    calls = []

    def wrapper(*args):
        calls.append(args[5])
        return kp.preprocess_plain(*args)

    monkeypatch.setattr(pipeline, "preprocess_forward", wrapper)
    with torch.no_grad():
        prep, counts = _counted(lambda: pipeline.preprocess_traced(model, cam, W, H, CFG))
        want = _plain(model, cam)
    with torch.inference_mode():
        _, counts_inference = _counted(lambda: pipeline.preprocess_traced(model, cam, W, H, CFG))
    assert counts == counts_inference == [1] and len(calls) == 2 and calls[0] is cam
    _assert_equal(prep, want)


def test_grad_inputs_keep_the_eager_autograd_path():
    """Parameters that require grad, under grad, on the CPU: the eager path
    (``preprocess_kernel`` and ``preprocess_bwd_kernel`` 0), differentiable,
    with the gradients of the eager functions called directly, bitwise."""
    model, cam = _scene()

    def grads(fn):
        prep = fn()
        loss = (prep.screen_means.sum() + prep.conics.sum() + prep.rgb.sum() + prep.depth.sum()
                + prep.opacity.sum())
        return torch.autograd.grad(loss, list(model.parameters()))

    got, counts = _counted(lambda: grads(lambda: pipeline.preprocess_traced(model, cam, W, H, CFG)),
                           ("preprocess_kernel", "preprocess_bwd_kernel"))
    want = grads(lambda: _plain(model, cam))
    assert counts == [[0], [0]]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(bool(g.abs().sum() > 0) for g in got)


def test_screen_offset_forces_the_eager_path():
    """On the CPU a screen offset (the densifying trainer's probe) takes the
    eager path, without a gradient too, and shifts the means."""
    model, cam = _scene()
    offset = torch.full((model.num_gaussians, 2), 0.25)
    with torch.no_grad():
        prep, counts = _counted(lambda: pipeline.preprocess_traced(model, cam, W, H, CFG, screen_offset=offset))
        want = _plain(model, cam, screen_offset=offset)
    assert counts == [0]
    _assert_equal(prep, want)
    assert torch.equal(prep.screen_means, _plain(model, cam).screen_means + offset)


@pytest.mark.parametrize("cotangents", ["features", "rgb_only"])
@pytest.mark.parametrize("with_offset", [False, True])
def test_grad_taking_preprocess_takes_the_kernel_pair(as_if_on_card, monkeypatch, with_offset, cotangents):
    """Under grad, with or without a screen offset that requires grad, the
    preprocess goes through the kernels' autograd Function (its wrappers
    replaced by recorders that return the plain versions): the forward
    wrapper once, the backward wrapper once, ``preprocess_kernel`` and
    ``preprocess_bwd_kernel`` 1; the gradients those of the eager path
    (opacity's autograd's in both), the offset's bitwise (it is the
    screen means' cotangent), the others up to the order in which the depth
    cotangent's term is added (rtol 1e-6). Cotangents arrive as column
    slices of the packed features' cotangent, or only rgb's (the others
    absent)."""
    model, cam = _scene()
    n = model.num_gaussians
    calls = []

    def forward(*args):
        calls.append("forward")
        with torch.no_grad():
            return kp.preprocess_plain(*args)

    def backward(*args):
        calls.append("backward")
        return kp.preprocess_backward_plain(*args)

    monkeypatch.setattr(kp, "preprocess_forward", forward)
    monkeypatch.setattr(kp, "preprocess_backward", backward)
    g = torch.Generator().manual_seed(3)
    v_feat, v_depth = torch.randn(n + 1, 16, generator=g), torch.randn(n, generator=g)
    offset = torch.zeros(n, 2, requires_grad=True) if with_offset else None

    def grads(fn):
        prep = fn()
        if cotangents == "features":
            loss = (binning.pack_features(prep) * v_feat).sum() + (prep.depth * v_depth).sum()
        else:
            loss = (prep.rgb * v_feat[:n, :3]).sum()
        wrt = list(model.parameters()) + ([offset] if with_offset else [])
        return torch.autograd.grad(loss, wrt, allow_unused=True)  # rgb alone reads no opacity

    got, counts = _counted(lambda: grads(lambda: pipeline.preprocess_traced(model, cam, W, H, CFG, offset)),
                           ("preprocess_kernel", "preprocess_bwd_kernel"))
    want = grads(lambda: _plain(model, cam, screen_offset=offset))
    assert counts == [[1], [1]] and calls == ["forward", "backward"]
    for a, b in zip(got, want):
        if b is None:  # unused by rgb: None through the eager path, zeros through the kernel's
            assert cotangents == "rgb_only" and (a is None or not bool(a.any()))
            continue
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
    if with_offset and cotangents == "features":
        assert torch.equal(got[-1], want[-1])


def _inputs(device, n=8, dtype=torch.float32, k=16):
    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    cam = tgs.CameraArrays(empty(4, 4), empty(4, 4), empty(3), empty(2), empty(2))
    return (empty(n, 3), empty(n, k, 3), empty(n, 4), empty(n, 3), empty(n), cam, W, H, 3, True)


@pytest.mark.parametrize("device, dtype, match", [
    ("meta", torch.float64, "contiguous float32"),
    ("meta", torch.float32, "unsupported device"),
    ("cpu", torch.float32, "unsupported device"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(device, dtype, match):
    """The wrapper launches the kernel or raises: float64 inputs are
    refused before anything else, then any device but CUDA, the CPU
    included (its plain version is ``preprocess_plain``)."""
    before = kp.preprocess_forward.launches
    with pytest.raises(ValueError, match=match):
        kp.preprocess_forward(*_inputs(device, dtype=dtype))
    assert kp.preprocess_forward.launches == before


@pytest.mark.parametrize("device, dtype, match", [
    ("meta", torch.float64, "float32"),
    ("meta", torch.float32, "unsupported device"),
    ("cpu", torch.float32, "unsupported device"),
])
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(device, dtype, match):
    """The backward's wrapper launches its kernel or raises: float64
    cotangents are refused first, then any device but CUDA, the CPU
    included (its plain version is ``preprocess_backward_plain``)."""
    means, sh, quats, scales, _, cam, w, h, degree, _ = _inputs(device, dtype=dtype)
    v = [torch.empty(8, k, dtype=dtype, device=device) for k in (2, 3, 3)]
    before = kp.preprocess_backward.launches
    with pytest.raises(ValueError, match=match):
        kp.preprocess_backward(means, sh, quats, scales, cam, w, h, degree, *v)
    assert kp.preprocess_backward.launches == before


def test_bytes_moved_backward():
    """The backward kernel's bytes bound: 496 a gaussian at SH degree 3
    (means 12, scales 12, quats 16, SH 192 and the cotangents of the screen
    means 8, conic 12 and rgb 12 read; the gradients of means 12, scales 12,
    quats 16 and all 16 SH coefficients 192 written), 2.48 GB at 5M
    gaussians; a lower degree reads fewer coefficients but writes every
    row's zeros."""
    assert kp.bytes_moved_backward(1, 3) == 264 + 232 == 496
    assert kp.bytes_moved_backward(5_000_000, 3) == 2_480_000_000
    assert kp.bytes_moved_backward(1, 0) == 496 - 15 * 12
    assert kp.bytes_moved_backward(1, 3, sh_coeffs=20) == 496 + 4 * 12


def test_bytes_moved():
    """The kernel's bytes bound: 305 a gaussian at SH degree 3 (236 read, 69
    written), 1.525 GB at 5M gaussians; a lower degree reads fewer
    coefficients."""
    assert kp.bytes_moved(1, 3) == 305
    assert kp.bytes_moved(5_000_000, 3) == 1_525_000_000
    assert kp.bytes_moved(1, 0) == 305 - 15 * 12
