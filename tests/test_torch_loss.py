"""The training loss's dispatch between the CUDA kernels (``kernels/loss.py``,
``csrc/loss.cu``) and the eager path, and the kernels' algorithm, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``).
Here: the predicate ``takes_kernel`` on stand-ins that carry a CUDA device
(CUDA frames take the kernels or raise); CPU frames take the eager path and
count ``loss_kernel`` 0; ``rgb_loss`` and ``ssim`` with the predicate seeing
CPU frames as CUDA ones (the kernels' wrappers replaced by recorders that
run the plain versions), so that the autograd Function's plumbing runs, at
weight 0 too, and what the card refuses; the wrappers' refusals of CPU and
meta tensors;
the plain version of the kernels' algorithm (forward to the three maps,
backward as blur and combine) held to autograd through the eager
``rgb_loss``; and the kernels' bytes bound.
"""

from __future__ import annotations

import pytest
import torch

from gsplat_tpu_torch.kernels import loss as kl
from gsplat_tpu_torch.train import loss as train_loss
from gsplat_tpu_torch.utils import stages

from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)


class _OnCard:
    """What ``takes_kernel`` reads of a tensor, on a CUDA device."""

    def __init__(self, shape, dtype=torch.float32, requires_grad=False, device="cuda:0"):
        self.shape, self.dtype, self.requires_grad = torch.Size(shape), dtype, requires_grad
        self.device = torch.device(device)

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("pred,target,takes", [
    (_OnCard((32, 48, 3)), _OnCard((32, 48, 3)), True),
    (_OnCard((32, 48, 3), requires_grad=True), _OnCard((32, 48, 3)), True),
    (_OnCard((32, 48, 3), device="cpu"), _OnCard((32, 48, 3), device="cpu"), False),
    (_OnCard((32, 48, 3)), _OnCard((32, 48, 3), device="cpu"), None),
    (_OnCard((32, 48, 3)), _OnCard((32, 48, 3), device="cuda:1"), None),
    (_OnCard((32, 48, 3), dtype=torch.float64), _OnCard((32, 48, 3), dtype=torch.float64), None),
    (_OnCard((32, 48, 3)), _OnCard((32, 48, 3), dtype=torch.bfloat16), None),
    (_OnCard((32 * 48, 3)), _OnCard((32 * 48, 3)), None),
    (_OnCard((1, 32, 48, 3)), _OnCard((1, 32, 48, 3)), None),
    (_OnCard((32, 48, 4)), _OnCard((32, 48, 4)), None),
    (_OnCard((32, 48, 1)), _OnCard((32, 48, 1)), None),
    (_OnCard((32, 48, 3)), _OnCard((16, 48, 3)), None),
    (_OnCard((32, 48, 3)), _OnCard((32, 48, 3), requires_grad=True), None),
    (_OnCard((32, 48, 3), device="cpu"), _OnCard((32, 48, 3)), None),
    (_OnCard((32, 48, 3), device="meta"), _OnCard((32, 48, 3), device="meta"), False),
    (_OnCard((32, 48, 4), device="cpu"), _OnCard((32, 48, 4), device="cpu"), False),
], ids=["cuda", "pred-grad", "cpu", "target-cpu", "two-cards", "f64", "target-bf16", "rank2", "rank4", "c4",
        "c1", "shapes", "target-grad", "pred-cpu", "meta", "cpu-c4"])
def test_takes_kernel(pred, target, takes):
    """CUDA frames take the kernels; frames on no CUDA device take the eager
    path (any shape); CUDA frames the kernels cannot take raise (``None``)."""
    if takes is None:
        with pytest.raises(ValueError, match="the loss kernels take"):
            kl.takes_kernel(pred, target)
    else:
        assert kl.takes_kernel(pred, target) is takes


def test_takes_kernel_with_target_grad_off():
    """A target that requires a gradient takes the kernels where autograd
    records nothing."""
    pred, target = _OnCard((8, 8, 3)), _OnCard((8, 8, 3), requires_grad=True)
    with pytest.raises(ValueError, match="gradient with respect to the target"):
        kl.takes_kernel(pred, target)
    with torch.no_grad():
        assert kl.takes_kernel(pred, target)


def _frames(height, width, tie, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    pred = torch.rand((height, width, 3), generator=g, dtype=dtype)
    target = torch.rand((height, width, 3), generator=g, dtype=dtype)
    if tie:
        target[:, ::2] = pred[:, ::2]  # |p - t| at its kink in every other column
    return pred, target


def _counted(fn):
    with stages.record_stages() as rec:
        out = fn()
    return out, [v for name, _, v in rec.counter_values() if name == "loss_kernel"]


@pytest.fixture
def no_kernels(monkeypatch):
    """The kernels' wrappers raise if called."""
    def launched(*args):
        raise AssertionError("a loss kernel launched")

    monkeypatch.setattr(kl, "loss_forward", launched)
    monkeypatch.setattr(kl, "loss_backward", launched)


@pytest.mark.parametrize("weight", [0.2, 0.0])
def test_cpu_frames_take_the_eager_path(no_kernels, weight):
    """On the CPU ``rgb_loss`` is the eager loss, bitwise, and counts
    ``loss_kernel`` 0; the kernels launch nothing."""
    pred, target = _frames(32, 48, tie=False)
    leaf = pred.clone().requires_grad_()
    loss, counts = _counted(lambda: train_loss.rgb_loss(leaf, target, weight))
    assert counts == [0]
    assert torch.equal(loss, kl.loss_plain(pred, target, weight))
    torch.autograd.grad(loss, leaf)
    assert torch.equal(train_loss.ssim(pred, target), kl.ssim_plain(pred, target))


@pytest.mark.parametrize("tie", [False, True], ids=["no-tie", "tie"])
@pytest.mark.parametrize("weight", [0.2, 1.0])
@pytest.mark.parametrize("height,width", [(32, 48), (7, 11), (3, 5)], ids=["48x32", "11x7", "5x3"])
def test_kernel_algorithm_is_autograd_of_rgb_loss(height, width, weight, tie):
    """The kernels' algorithm in plain PyTorch, in float64: the loss of
    ``loss_maps_plain`` is the eager ``rgb_loss``, its mean SSIM the eager
    ``ssim``, and ``loss_backward_plain`` of its maps, at a cotangent of 1.7,
    autograd's gradient through ``rgb_loss``. Frames under the window's 11
    pixels too; with ties, ``sign(0) = 0`` as autograd's abs gives it."""
    pred, target = _frames(height, width, tie, dtype=torch.float64)
    leaf = pred.clone().requires_grad_()
    want = train_loss.rgb_loss(leaf, target, weight)
    cot = torch.tensor(1.7, dtype=torch.float64)
    (want_grad,) = torch.autograd.grad(want, leaf, cot)
    loss, mean_s, maps = kl.loss_maps_plain(pred, target, weight)
    assert maps.shape == (3, height, width, 3)
    torch.testing.assert_close(loss, want.detach(), rtol=1e-13, atol=0)
    torch.testing.assert_close(mean_s, train_loss.ssim(pred, target), rtol=1e-13, atol=1e-15)
    grad = kl.loss_backward_plain(pred, target, maps, weight, cot)
    torch.testing.assert_close(grad, want_grad, rtol=1e-10, atol=1e-12 * float(want_grad.abs().max()))
    if tie:
        l1_only = kl.loss_backward_plain(pred, target, torch.zeros_like(maps), weight, cot)
        assert bool((l1_only[:, ::2] == 0).all())


@pytest.fixture
def as_if_on_card(monkeypatch):
    """``rgb_loss`` sees CPU frames as CUDA ones, and the kernels' wrappers
    run the plain versions, counting their calls."""
    calls = {"forward": 0, "backward": 0}

    def forward(pred, target, weight):
        assert pred.is_contiguous() and target.is_contiguous()
        calls["forward"] += 1
        loss, mean_s, maps = kl.loss_maps_plain(pred, target, weight)
        return loss.to(pred.dtype), mean_s.to(pred.dtype), maps

    def backward(pred, target, maps, weight, grad_out):
        calls["backward"] += 1
        return kl.loss_backward_plain(pred, target, maps, weight, grad_out)

    real = kl.takes_kernel
    monkeypatch.setattr(kl, "takes_kernel", lambda p, t: real(_seen(p), _seen(t)))
    monkeypatch.setattr(kl, "loss_forward", forward)
    monkeypatch.setattr(kl, "loss_backward", backward)
    return calls


def _seen(t):
    return _OnCard(t.shape, t.dtype, t.requires_grad)


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
def test_rgb_loss_takes_the_kernels_on_the_card(as_if_on_card, strided):
    """Where ``takes_kernel`` holds, ``rgb_loss`` counts ``loss_kernel`` 1,
    runs the forward once and, under ``torch.autograd.grad``, the backward
    once, with the eager path's value and gradient (a strided frame, as the
    benchmark's ``half`` fault takes, is copied first)."""
    pred, target = _frames(40, 24, tie=True)
    view = (lambda x: x[::2]) if strided else (lambda x: x)
    leaf = pred.clone().requires_grad_()
    loss, counts = _counted(lambda: train_loss.rgb_loss(view(leaf), view(target), 0.2))
    assert counts == [1] and as_if_on_card == {"forward": 1, "backward": 0}
    (grad,) = torch.autograd.grad(loss, leaf)
    assert as_if_on_card == {"forward": 1, "backward": 1}
    eager_leaf = pred.clone().requires_grad_()
    want = kl.loss_plain(view(eager_leaf), view(target), 0.2)
    (want_grad,) = torch.autograd.grad(want, eager_leaf)
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(grad, want_grad, rtol=1e-4, atol=1e-5 * float(want_grad.abs().max()))
    if strided:
        assert bool((grad[1::2] == 0).all())


def test_rgb_loss_at_weight_zero_takes_the_kernels(as_if_on_card):
    """At SSIM weight 0 the card's loss is still the kernels (the SSIM term's
    coefficients are 0): the eager L1 loss and its gradient."""
    pred, target = _frames(24, 40, tie=True)
    leaf = pred.clone().requires_grad_()
    loss, counts = _counted(lambda: train_loss.rgb_loss(leaf, target, 0.0))
    (grad,) = torch.autograd.grad(loss, leaf)
    assert counts == [1] and as_if_on_card == {"forward": 1, "backward": 1}
    eager_leaf = pred.clone().requires_grad_()
    want = train_loss.l1_loss(eager_leaf, target)
    (want_grad,) = torch.autograd.grad(want, eager_leaf)
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(grad, want_grad, rtol=1e-6, atol=0)


def test_ssim_takes_the_kernels_on_the_card(as_if_on_card):
    """``ssim`` on the card is one minus the kernels' loss at SSIM weight 1,
    differentiable through the backward kernel: the eager SSIM's value and
    gradient."""
    pred, target = _frames(20, 30, tie=False)
    with torch.no_grad():
        got = train_loss.ssim(pred, target)
    assert as_if_on_card == {"forward": 1, "backward": 0}
    torch.testing.assert_close(got, kl.ssim_plain(pred, target), rtol=1e-6, atol=1e-7)
    leaf = pred.clone().requires_grad_()
    (grad,) = torch.autograd.grad(train_loss.ssim(leaf, target), leaf)
    assert as_if_on_card == {"forward": 2, "backward": 1}
    eager_leaf = pred.clone().requires_grad_()
    (want_grad,) = torch.autograd.grad(kl.ssim_plain(eager_leaf, target), eager_leaf)
    torch.testing.assert_close(grad, want_grad, rtol=1e-4, atol=1e-5 * float(want_grad.abs().max()))


@pytest.mark.parametrize("case", ["f64", "c4", "target-grad"])
def test_the_card_refuses_what_the_kernels_cannot_take(as_if_on_card, case):
    """``rgb_loss`` and ``ssim`` of CUDA frames the kernels cannot take raise
    ValueError; nothing runs eager on the card."""
    pred, target = _frames(16, 16, tie=False, dtype=torch.float64 if case == "f64" else torch.float32)
    if case == "c4":
        pred, target = torch.cat([pred, pred[..., :1]], -1), torch.cat([target, target[..., :1]], -1)
    if case == "target-grad":
        target = target.clone().requires_grad_()
    for fn in (lambda: train_loss.rgb_loss(pred, target, 0.2), lambda: train_loss.ssim(pred, target)):
        with pytest.raises(ValueError, match="the loss kernels take"):
            fn()
    assert as_if_on_card == {"forward": 0, "backward": 0}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrappers_refuse_what_is_not_on_the_card(device):
    """The wrappers raise on CPU and meta frames (and launch nothing)."""
    pred = torch.zeros((8, 12, 3), device=device)
    maps = torch.zeros((3, 8, 12, 3), device=device)
    with pytest.raises(ValueError, match="unsupported device"):
        kl.loss_forward(pred, pred, 0.2)
    with pytest.raises(ValueError, match="unsupported device"):
        kl.loss_backward(pred, pred, maps, 0.2, torch.ones((), device=device))
    with pytest.raises(ValueError, match="float32"):
        kl.loss_forward(pred.double(), pred, 0.2)


def test_bytes_bound():
    """At 1920x1080x3 float32 the two kernels move 11 frames, 273.7 MB:
    0.082 ms at 3.35 TB/s."""
    assert kl.bytes_moved(1080, 1920) == 11 * 1920 * 1080 * 3 * 4 == 273_715_200
    assert kl.bytes_moved(1080, 1920) / 3.35e12 * 1e3 == pytest.approx(0.0817, abs=1e-4)
