"""The preprocess's dispatch between the CUDA kernel (``kernels/preprocess.py``,
``csrc/preprocess.cu``) and the eager autograd path, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``). Here:
CPU tensors take the plain path and count ``preprocess_kernel`` 0; the
predicate ``takes_kernel`` as a function, on stand-ins that carry a CUDA
device; ``preprocess_traced`` with that predicate seeing the CPU tensors as
CUDA ones, so that each of its branches runs (the kernel's wrapper replaced
by a recorder that returns the plain version); gradients through the eager
path unchanged; and the wrapper's refusals of what is not a CUDA float32
tensor, on CPU and meta tensors.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.kernels import preprocess as kp
from gsplat_tpu_torch.models.gaussians import random_model
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


def _counted(fn):
    """``fn()`` under the tracer; returns its result and the values of the
    ``preprocess_kernel`` counter."""
    with stages.record_stages() as rec:
        out = fn()
    return out, [v for name, _, v in rec.counter_values() if name == "preprocess_kernel"]


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
    monkeypatch.setattr(pipeline, "takes_kernel", lambda ts, off=None: real([_seen_on_card(t) for t in ts], off))


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
    ("screen_offset", False, False),
    ("requires_grad", True, False),
    ("requires_grad", False, True),
])
def test_takes_kernel(case, grad_on, expected):
    """CUDA float32 inputs, no screen offset and no gradient to take: the
    kernel; anything else: the eager path."""
    def t(device="cuda", dtype=torch.float32, requires_grad=False):
        return SimpleNamespace(device=torch.device(device), dtype=dtype, requires_grad=requires_grad)

    tensors = [t() for _ in range(10)]
    offset = None
    if case == "float64":
        tensors[1] = t(dtype=torch.float64)
    elif case == "cpu":
        tensors = [t("cpu") for _ in tensors]
    elif case == "mixed_devices":
        tensors[7] = t("cpu")  # one camera tensor left on the host
    elif case == "screen_offset":
        offset = torch.zeros(4, 2)
    elif case == "requires_grad":
        tensors[0] = t(requires_grad=True)
    with torch.set_grad_enabled(grad_on):
        assert kp.takes_kernel(tensors, offset) is expected


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


def test_grad_inputs_keep_the_eager_autograd_path(as_if_on_card):
    """Parameters that require grad, under grad: the eager path (counter 0),
    differentiable, with the gradients of the eager functions called
    directly, bitwise."""
    model, cam = _scene()

    def grads(fn):
        prep = fn()
        loss = (prep.screen_means.sum() + prep.conics.sum() + prep.rgb.sum() + prep.depth.sum()
                + prep.opacity.sum())
        return torch.autograd.grad(loss, list(model.parameters()))

    got, counts = _counted(lambda: grads(lambda: pipeline.preprocess_traced(model, cam, W, H, CFG)))
    want = grads(lambda: _plain(model, cam))
    assert counts == [0]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(bool(g.abs().sum() > 0) for g in got)


def test_screen_offset_forces_the_eager_path(as_if_on_card):
    """A screen offset (the densifying trainer's probe) takes the eager path
    even without a gradient, and shifts the means."""
    model, cam = _scene()
    offset = torch.full((model.num_gaussians, 2), 0.25)
    with torch.no_grad():
        prep, counts = _counted(lambda: pipeline.preprocess_traced(model, cam, W, H, CFG, screen_offset=offset))
        want = _plain(model, cam, screen_offset=offset)
    assert counts == [0]
    _assert_equal(prep, want)
    assert torch.equal(prep.screen_means, _plain(model, cam).screen_means + offset)


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


def test_bytes_moved():
    """The kernel's bytes bound: 305 a gaussian at SH degree 3 (236 read, 69
    written), 1.525 GB at 5M gaussians; a lower degree reads fewer
    coefficients."""
    assert kp.bytes_moved(1, 3) == 305
    assert kp.bytes_moved(5_000_000, 3) == 1_525_000_000
    assert kp.bytes_moved(1, 0) == 305 - 15 * 12
