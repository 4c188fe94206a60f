"""The port's losses, optimizer and trainer held against the JAX package.

* Losses (``l1_loss``, ``psnr``, ``ssim``, ``rgb_loss``): values and input
  gradients on random images at rtol 1e-5 / atol 1e-6 (f32 sums in other
  orders; the SSIM blur is a zero-padded separable convolution on both
  sides).
* Trainer steps against JAX's ``Trainer`` (jnp path on the CPU): per-step
  losses at rtol 1e-5, and the parameters after the steps within 1% of one
  step's learning rate. Adam's update is close to ``lr * sign(g)``, so two
  correct implementations whose gradients agree to about 1e-5 of their
  scale land well inside that; a wrong or missing gradient moves a
  parameter by about ``lr`` per step.
"""

import dataclasses
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gsplat_tpu as jgs
from gsplat_tpu.train import loss as jloss
from gsplat_tpu.train.trainer import Trainer as JTrainer
from gsplat_tpu.train.trainer import make_optimizer as j_make_optimizer
from gsplat_tpu.train.trainer import scene_extent as j_scene_extent

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.train import loss as tloss
from gsplat_tpu_torch.train.trainer import make_optimizer, means_lr, optimizer_step, scene_extent
from gsplat_tpu_torch.utils import stages

from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

SMALL = dict(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 12)
NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")
LR_FIELD = dict(zip(NAMES, ("lr_means", "lr_scales", "lr_quats", "lr_opacity", "lr_sh")))


def port_camera(jcam):
    return tgs.CameraParams(**dataclasses.asdict(jcam))


@pytest.mark.parametrize(
    "name,fn",
    [
        ("l1_loss", lambda m, a, b: m.l1_loss(a, b)),
        ("psnr", lambda m, a, b: m.psnr(a, b)),
        ("ssim", lambda m, a, b: m.ssim(a, b)),
        ("rgb_loss", lambda m, a, b: m.rgb_loss(a, b, 0.2) + m.rgb_loss(a, b, 0.0)),
    ],
)
def test_loss_matches_jax(name, fn):
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    j_value, j_grad = jax.value_and_grad(lambda x: fn(jloss, x, jnp.asarray(b)))(jnp.asarray(a))
    pred = torch.from_numpy(a).requires_grad_(True)
    value = fn(tloss, pred, torch.from_numpy(b))
    (grad,) = torch.autograd.grad(value, pred)
    assert float(value.detach()) == pytest.approx(float(j_value), rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-6 * np.abs(j_grad).max())


def test_means_schedule_matches_optax():
    """``means_lr`` is optax's exponential decay at the same count, and one
    Adam update per step with unit gradients moves the means by that rate,
    as optax's does; the other rates stay constant."""
    tc = tgs.TrainConfig(lr_means=1e-2, lr_means_final=1e-4, lr_means_decay_steps=50)
    sched = optax.exponential_decay(1e-2, 50, decay_rate=1e-4 / 1e-2, end_value=1e-4)
    for k in (0, 1, 7, 25, 49, 50, 51, 80):
        assert means_lr(tc, k) == pytest.approx(float(sched(k)), rel=1e-5)
    assert means_lr(tgs.TrainConfig(), 123) == tgs.TrainConfig().lr_means

    arrays = random_splat_arrays(np.random.default_rng(11), 16)
    jtc = jgs.TrainConfig(lr_means=1e-2, lr_means_final=1e-4, lr_means_decay_steps=50)
    j_opt = j_make_optimizer(jtc)
    j_model = jgs.GaussianModel.from_arrays(arrays)
    j_state = j_opt.init(j_model)
    j_grads = jax.tree.map(jnp.ones_like, j_model)
    # f64 parameters, so that the movement of a parameter resolves the update
    # exactly. Optax takes Adam's bias corrections 1 - b**t in f32, where
    # 1 - 0.999**t cancels to a few 1e-5 relative; torch takes them in f64.
    model = tgs.GaussianModel.from_arrays(arrays, dtype=torch.float64, device="cpu")
    opt = make_optimizer(model, tc)
    for step in range(60):
        updates, j_state = j_opt.update(j_grads, j_state, j_model)
        before = {k: getattr(model, k).detach().clone() for k in NAMES}
        for k in NAMES:
            getattr(model, k).grad = torch.ones_like(getattr(model, k))
        optimizer_step(opt, tc)
        for k in NAMES:
            moved = float((getattr(model, k).detach() - before[k]).abs().mean())
            want = float(jnp.abs(getattr(updates, k)).mean())
            assert moved == pytest.approx(want, rel=1e-4), (step, k)
    with pytest.raises(ValueError):
        make_optimizer(model, tgs.TrainConfig(lr_means_decay_steps=10, lr_means_final=0.0))


def test_scene_extent_matches_jax():
    cams = [orbit_camera(a, distance=d) for a, d in ((0.0, 4.0), (0.3, 5.0), (-0.2, 3.0))]
    assert scene_extent([port_camera(c) for c in cams]) == pytest.approx(j_scene_extent(cams), rel=1e-6)


def _views(seed=3, n=150):
    arrays = random_splat_arrays(np.random.default_rng(seed), n)
    jcams = [orbit_camera(a, width=48, height=32) for a in (0.0, 0.2)]
    rng = np.random.default_rng(seed + 1)
    targets = [rng.uniform(0, 1, (32, 48, 3)).astype(np.float32) for _ in jcams]
    return arrays, jcams, targets


def _params_close(model, j_model, tc):
    for k in NAMES:
        lr = getattr(tc, LR_FIELD[k])
        np.testing.assert_allclose(
            getattr(model, k).detach().numpy(), np.asarray(getattr(j_model, k)), rtol=0, atol=1e-2 * lr,
            err_msg=k,
        )


@pytest.mark.parametrize("background", ["black", "white", "random"])
def test_train_steps_match_jax(background):
    arrays, jcams, targets = _views()
    kw = dict(ssim_weight=0.2, background=background)
    jt = JTrainer(raster=jgs.RasterConfig(**SMALL, use_pallas=False), train=jgs.TrainConfig(**kw),
                  show_progress=False)
    j_model = jgs.GaussianModel.from_arrays(arrays)
    j_state = jt.init_state(j_model)
    tc = tgs.TrainConfig(**kw)
    trainer = tgs.Trainer(raster=tgs.RasterConfig(**SMALL), train=tc, show_progress=False)
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    opt = trainer.init_state(model)
    for step in range(3):
        j_model, j_state, j_metrics = jt.train_step(j_model, j_state, jcams[step % 2], jnp.asarray(targets[step % 2]))
        metrics = trainer.train_step(model, opt, port_camera(jcams[step % 2]), torch.from_numpy(targets[step % 2]))
        assert metrics["loss"].shape == () and not metrics["loss"].requires_grad
        for k in ("loss", "psnr"):
            assert float(metrics[k]) == pytest.approx(float(j_metrics[k]), rel=1e-5), (step, k)
    _params_close(model, j_model, tc)


def test_fit_with_sh_warmup_matches_jax():
    arrays, jcams, targets = _views(seed=5)
    kw = dict(steps=4, log_every=1, ssim_weight=0.2, sh_warmup_every=2)
    jt = JTrainer(raster=jgs.RasterConfig(**SMALL, use_pallas=False), train=jgs.TrainConfig(**kw),
                  show_progress=False)
    j_model, j_hist = jt.fit(jgs.GaussianModel.from_arrays(arrays),
                             [(c, jnp.asarray(x)) for c, x in zip(jcams, targets)])
    tc = tgs.TrainConfig(**kw)
    trainer = tgs.Trainer(raster=tgs.RasterConfig(**SMALL), train=tc, show_progress=False)
    records = []
    model, hist = trainer.fit(tgs.GaussianModel.from_arrays(arrays, device="cpu"),
                              [(port_camera(c), torch.from_numpy(x)) for c, x in zip(jcams, targets)],
                              log_fn=records.append)
    assert records == hist and [h["step"] for h in hist] == [0, 1, 2, 3]
    for got, want in zip(hist, j_hist):
        assert got["step"] == want["step"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["psnr"] == pytest.approx(want["psnr"], rel=1e-5)
    _params_close(model, j_model, tc)


def test_check_capacity_resizes_like_jax():
    """An overflowing fit is not trained on a truncated scene: with
    ``auto_pairs`` the budget grows to JAX's size and the losses match a
    run with enough capacity; without it, a warning and the same budget."""
    arrays = random_splat_arrays(np.random.default_rng(6), 120)
    jcam = orbit_camera(0.1, width=48, height=32)
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    with torch.no_grad():
        target = tgs.render(model, port_camera(jcam), tgs.RasterConfig(**SMALL))[0]
    tiny = dict(SMALL, max_pairs=64)
    tc = tgs.TrainConfig(steps=3, log_every=10, ssim_weight=0.0)
    jt = JTrainer(raster=jgs.RasterConfig(**tiny, use_pallas=False), train=jgs.TrainConfig(steps=3, log_every=10,
                  ssim_weight=0.0), show_progress=False)
    jt.check_capacity(jgs.GaussianModel.from_arrays(arrays), jcam)

    trainer = tgs.Trainer(raster=tgs.RasterConfig(**tiny), train=tc, show_progress=False)
    _, hist = trainer.fit(tgs.GaussianModel.from_arrays(arrays, device="cpu"), [(port_camera(jcam), target)])
    assert trainer.raster.max_pairs == jt.raster.max_pairs > 64
    roomy = tgs.Trainer(raster=tgs.RasterConfig(**dict(SMALL, max_pairs=trainer.raster.max_pairs)), train=tc,
                        show_progress=False)
    _, hist_roomy = roomy.fit(tgs.GaussianModel.from_arrays(arrays, device="cpu"), [(port_camera(jcam), target)])
    assert hist == hist_roomy

    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("gsplat_tpu_torch")
    handler = Capture()
    logger.addHandler(handler)
    try:
        fixed = tgs.Trainer(raster=tgs.RasterConfig(**tiny), train=tc, auto_pairs=False, show_progress=False)
        fixed.fit(tgs.GaussianModel.from_arrays(arrays, device="cpu"), [(port_camera(jcam), target)], steps=1)
    finally:
        logger.removeHandler(handler)
    assert fixed.raster.max_pairs == 64
    assert any("overflow" in r for r in records), records


def test_invalid_background_is_refused():
    with pytest.raises(ValueError):
        tgs.Trainer(raster=tgs.RasterConfig(**SMALL), train=tgs.TrainConfig(background="blue"))


def test_step_stages_are_marked(monkeypatch):
    """``record_stages`` sees every stage of one real ``train_step``, each
    inner stage inside the one around it, and nothing outside it: the
    backward's own stages (``loss_bwd``, ``preprocess_bwd``) under
    ``backward``, every span with the trainer's step id and the calling
    thread (on the CPU autograd runs the backward there). (A stand-in for
    ``torch.cuda.Event`` that notes the order of its records.)"""
    ticks = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self):
            self.at = len(ticks)
            ticks.append(self)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    arrays, jcams, targets = _views()
    trainer = tgs.Trainer(raster=tgs.RasterConfig(**SMALL), train=tgs.TrainConfig(), show_progress=False)
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    opt = trainer.init_state(model)
    step = (model, opt, port_camera(jcams[0]), torch.from_numpy(targets[0]))
    trainer.train_step(*step)
    assert ticks == []
    with stages.record_stages() as spans:
        trainer.train_step(*step)
    assert [name for name, _, _ in spans] == [
        "camera", "preprocess", "pack_features", "binning", "raster_fwd", "tiles_to_image", "forward",
        "loss", "loss_bwd", "raster_bwd", "reduction", "preprocess_bwd", "backward", "optimizer",
    ]
    at = {name: (start.at, end.at) for name, start, end in spans}
    for inner, outer in (("preprocess", "forward"), ("raster_fwd", "forward"), ("raster_bwd", "backward"),
                         ("reduction", "backward"), ("loss_bwd", "backward"), ("preprocess_bwd", "backward")):
        assert at[outer][0] < at[inner][0] < at[inner][1] < at[outer][1], (inner, outer)
    assert at["loss_bwd"][1] < at["raster_bwd"][0] and at["reduction"][1] < at["preprocess_bwd"][0]
    by_id = {s.id: s for s in spans.spans}
    parents = {s.name: by_id[s.parent].name for s in spans.spans if s.parent is not None}
    assert parents == {
        "preprocess": "forward", "pack_features": "forward", "binning": "forward", "raster_fwd": "forward",
        "tiles_to_image": "forward", "loss_bwd": "backward", "raster_bwd": "backward", "reduction": "backward",
        "preprocess_bwd": "backward",
    }
    assert {s.step for s in spans.spans} == {1}  # the trainer's second step
    assert {s.thread for s in spans.spans} == {threading.get_native_id()}
    assert len(ticks) == 2 * len(spans)
    trainer.train_step(*step)
    assert len(ticks) == 2 * len(spans)
