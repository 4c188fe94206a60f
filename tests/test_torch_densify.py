"""Adaptive density control of the port held against the JAX package.

* The viewspace probe: ``d loss / d screen_offset`` through the port's
  ``render_traced`` against ``jax.grad`` through JAX's, on the single-sort
  path (``use_pallas=False``) and on the depth-sliced one (Pallas in
  interpret mode), at the gradient tolerance of ``tests/test_torch_grad.py``
  (rtol 2e-3 plus atol 5e-5 of the scale).
* ``screen_radii``, ``accumulate``, ``reset_opacity``, ``pool_capacity`` and
  ``camera_extent`` on equal inputs: equal outputs.
* ``densify_prune_step`` with JAX's split samples (the ``eps`` JAX draws
  from the same key): masks, touched rows, stats and every parameter row
  bitwise equal, except the means of new split halves (a 3x3 rotation
  applied in another summation order), within 1e-6 of each row's largest
  component.
* ``reset_opt_rows`` on a real Adam state, ``from_points3d`` and
  ``knn_mean_sq_dist`` (rtol 1e-5), and a densifying ``fit`` against JAX's.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as jgs
from gsplat_tpu.models.gaussians import DEAD_OPACITY_LOGIT
from gsplat_tpu.models.gaussians import knn_mean_sq_dist as j_knn_mean_sq_dist
from gsplat_tpu.ops.camera import CameraArrays as JCameraArrays
from gsplat_tpu.render.pipeline import preprocess_traced as j_preprocess_traced
from gsplat_tpu.render.pipeline import render_traced as j_render_traced
from gsplat_tpu.train import densify as JD
from gsplat_tpu.train.loss import rgb_loss as j_rgb_loss
from gsplat_tpu.train.trainer import Trainer as JTrainer
from gsplat_tpu.train.trainer import make_optimizer as j_make_optimizer

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.models.gaussians import knn_mean_sq_dist
from gsplat_tpu_torch.render.pipeline import render_traced
from gsplat_tpu_torch.train import densify as D
from gsplat_tpu_torch.train.trainer import make_optimizer, optimizer_step

from fixtures import make_camera, orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

SMALL = dict(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 13)
NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")
LR_FIELD = dict(zip(NAMES, ("lr_means", "lr_scales", "lr_quats", "lr_opacity", "lr_sh")))
GRAD_THRESHOLD = 2e-3  # the densifying fit's: clones at both passes, every avg_grad 1e-3 away


def t(x):
    return torch.from_numpy(np.array(x))


def port_camera(jcam):
    return tgs.CameraParams(**dataclasses.asdict(jcam))


def close_to_scale(got, want, rtol, atol_of_scale):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_of_scale * (np.abs(want).max() + 1e-8))


# -- the viewspace probe -------------------------------------------------------


@pytest.mark.parametrize("slice_pairs", [0, 1 << 10])
def test_viewspace_probe_matches_jax(slice_pairs):
    """The densifying step's probe: the gradient of the training loss (the
    render composited onto a background, L1 + SSIM) with respect to a zero
    offset on the projected means. With ``slice_pairs`` the offset enters
    the preprocess before the sliced binning and compositing."""
    n, w, h = 150, 48, 32
    arrays = random_splat_arrays(np.random.default_rng(11), n)
    rng = np.random.default_rng(12)
    target = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    bg = rng.uniform(0, 1, 3).astype(np.float32)
    jcam = orbit_camera(0.2, width=w, height=h)
    if slice_pairs:
        jcfg = jgs.RasterConfig(**SMALL, use_pallas=True, force_pallas_interpret=True, slice_pairs=slice_pairs)
    else:
        jcfg = jgs.RasterConfig(**SMALL, use_pallas=False)
    jmodel = jgs.GaussianModel.from_arrays(arrays)
    jcam_arrays = JCameraArrays.from_params(jcam)

    def j_loss(offset):
        img, trans = j_render_traced(jmodel, jcam_arrays, w, h, jcfg, offset)
        return j_rgb_loss(img + trans[..., None] * bg, target, 0.2)

    want = np.asarray(jax.grad(j_loss)(jnp.zeros((n, 2), jnp.float32)))
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    cam = tgs.CameraArrays.from_params(port_camera(jcam), device="cpu")
    offset = torch.zeros((n, 2), requires_grad=True)
    img, trans = render_traced(model, cam, w, h, tgs.RasterConfig(**SMALL, slice_pairs=slice_pairs), offset)
    loss = tgs.rgb_loss(img + trans[..., None] * t(bg), t(target), 0.2)
    (got,) = torch.autograd.grad(loss, [offset])
    assert (np.abs(want).max(axis=1) > 0).sum() > n // 4, "the probe should reach many gaussians"
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    close_to_scale(got.numpy(), want, 2e-3, 5e-5)


# -- equal inputs --------------------------------------------------------------


def test_screen_radii_matches_jax():
    """On JAX's own conics (a fixture scene, plus degenerate rows):
    integer-equal radii."""
    arrays = random_splat_arrays(np.random.default_rng(3), 300)
    arrays["log_scales"] += np.random.default_rng(4).uniform(-1.0, 2.0, (300, 1)).astype(np.float32)
    jcfg = jgs.RasterConfig(**SMALL, use_pallas=False)
    prep = j_preprocess_traced(jgs.GaussianModel.from_arrays(arrays), JCameraArrays.from_params(make_camera()),
                               64, 48, jcfg)
    conics = np.concatenate([np.asarray(prep.conics), [[0, 0, 0], [1, 1, 2], [1e-30, 1e-30, 0]]]).astype(np.float32)
    active = np.concatenate([np.asarray(prep.active), [True, True, True]])
    want = np.asarray(JD.screen_radii(jnp.asarray(conics), jnp.asarray(active)))
    got = D.screen_radii(t(conics), t(active)).numpy()
    assert (want > 0).sum() > 100 and want.max() > 10
    np.testing.assert_array_equal(got, want)


def test_accumulate_matches_jax():
    rng = np.random.default_rng(5)
    c = 200
    grads = (rng.normal(size=(c, 2)) * 1e-4).astype(np.float32)
    grads[rng.uniform(size=c) < 0.3] = 0.0
    radii = np.ceil(rng.uniform(0, 40, c)).astype(np.float32)
    base = (rng.uniform(0, 1e-3, c).astype(np.float32), rng.integers(0, 5, c).astype(np.int32),
            rng.uniform(0, 30, c).astype(np.float32))
    for r in (radii, None):
        want = JD.accumulate(JD.DensifyState(*(jnp.asarray(x) for x in base)), jnp.asarray(grads), 48, 32,
                             None if r is None else jnp.asarray(r))
        got = D.accumulate(D.DensifyState(*(t(x) for x in base)), t(grads), 48, 32, None if r is None else t(r))
        for name, g, w in zip(D.DensifyState._fields, got, want):
            assert g.dtype == torch.from_numpy(np.asarray(w)).dtype, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_reset_opacity_matches_jax():
    arrays = random_splat_arrays(np.random.default_rng(6), 40)
    arrays["opacity_logits"][::5] = DEAD_OPACITY_LOGIT
    arrays["opacity_logits"][1::5] = -8.0  # below the ceiling already
    want = JD.reset_opacity(jgs.GaussianModel.from_arrays(arrays), 0.01)
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    param = model.opacity_logits
    assert D.reset_opacity(model, 0.01) is model and model.opacity_logits is param  # in place
    np.testing.assert_array_equal(model.opacity_logits.detach().numpy(), np.asarray(want.opacity_logits))
    assert (model.opacity_logits.detach().numpy() < arrays["opacity_logits"]).sum() > 10


def test_pool_capacity_and_camera_extent_match_jax():
    for n in (1, 8, 100, 255, 256, 1000, 12345):
        for factor in (1.0, 1.5, 2.0, 3.7):
            assert D.pool_capacity(n, tgs.DensifyConfig(pool_factor=factor)) == JD.pool_capacity(
                n, jgs.DensifyConfig(pool_factor=factor))
    cams = [orbit_camera(a, distance=d) for a, d in ((0.0, 4.0), (0.3, 5.0), (-0.2, 3.0), (1.1, 2.5))]
    for views in (cams, cams[:1], cams[1:3]):
        assert D.camera_extent([port_camera(c) for c in views]) == JD.camera_extent(views)


# -- densify_prune_step against JAX's, with JAX's split samples ----------------


def _pool(c, seed, alive_share=0.6, ties=False, big=0.0):
    """A random pool of ``c`` slots: dead slots, low-opacity slots, a spread
    of scales, random accumulated viewspace gradients; ``ties`` draws the
    gradient sums from four values (many tied ``avg_grad``); ``big`` is the
    share of slots with a large world scale and screen radius."""
    rng = np.random.default_rng(seed)
    arrays = random_splat_arrays(rng, c)
    arrays["log_scales"] = rng.uniform(-5.0, -0.5, (c, 3)).astype(np.float32)
    arrays["opacity_logits"] = rng.uniform(-7.0, 4.0, c).astype(np.float32)
    arrays["opacity_logits"][rng.uniform(size=c) > alive_share] = DEAD_OPACITY_LOGIT
    count = rng.integers(0, 4, c).astype(np.int32)
    grad_sum = (rng.choice([0.5, 1.0, 2.0, 4.0], c) if ties else rng.uniform(0, 4, c)).astype(np.float32) * 1e-4
    radius = np.ceil(rng.uniform(0, 25, c)).astype(np.float32)
    if big:
        sel = rng.uniform(size=c) < big
        arrays["log_scales"][sel, 0] = 1.0
        radius[rng.uniform(size=c) < big] = 60.0
    return arrays, (grad_sum * count, count, radius)


def _hand_built_semantics():
    """``tests/test_train.py::test_densify_prune_step_semantics``'s pool."""
    c = 8
    arrays = {
        "means": np.arange(c * 3, dtype=np.float32).reshape(c, 3),
        "log_scales": np.full((c, 3), -4.0, np.float32),
        "quats": np.tile(np.float32([1, 0, 0, 0]), (c, 1)),
        "opacity_logits": np.float32([-7.0, 2.0, 2.0, 2.0] + [DEAD_OPACITY_LOGIT] * 4),
        "sh": np.zeros((c, 16, 3), np.float32),
    }
    arrays["log_scales"][2] = 0.0
    arrays["sh"][1, 0, 0] = 0.7
    state = (np.float32([0, 1, 1, 0, 0, 0, 0, 0]), np.int32([1, 1, 1, 1, 0, 0, 0, 0]), np.zeros(8, np.float32))
    return arrays, state


def _hand_built_size_prune():
    """``tests/test_train.py::test_densify_size_prune``'s pool."""
    c = 4
    arrays = {
        "means": np.zeros((c, 3), np.float32),
        "log_scales": np.full((c, 3), -4.0, np.float32),
        "quats": np.tile(np.float32([1, 0, 0, 0]), (c, 1)),
        "opacity_logits": np.float32([2.0, 2.0, 2.0, DEAD_OPACITY_LOGIT]),
        "sh": np.zeros((c, 16, 3), np.float32),
    }
    arrays["log_scales"][0] = 0.5
    return arrays, (np.zeros(c, np.float32), np.zeros(c, np.int32), np.float32([0.0, 37.0, 4.0, 0.0]))


# name: (pool, extent, DensifyConfig fields, step, key seed)
CASES = {
    "semantics": (_hand_built_semantics, 10.0, dict(grad_threshold=0.5, percent_dense=0.01), 0, 0),
    "size_prune_before_start": (_hand_built_size_prune, 10.0, dict(size_prune_start=3000), 0, 0),
    "size_prune_after_start": (_hand_built_size_prune, 10.0, dict(size_prune_start=3000), 3000, 0),
    "size_prune_off": (_hand_built_size_prune, 10.0, dict(max_screen_size=0.0), 9999, 0),
    "more_candidates_than_free": (lambda: _pool(256, 1, alive_share=0.9), 2.0,
                                  dict(grad_threshold=1e-4, percent_dense=0.05), 10, 1),
    "more_free_than_candidates": (lambda: _pool(256, 2, alive_share=0.3), 2.0,
                                  dict(grad_threshold=1e-4, percent_dense=0.05), 10, 2),
    "tied_avg_grad": (lambda: _pool(256, 3, alive_share=0.8, ties=True), 2.0,
                      dict(grad_threshold=1e-4, percent_dense=0.05), 10, 3),
    "size_prune_random_before": (lambda: _pool(300, 4, big=0.1), 3.0,
                                 dict(grad_threshold=1.5e-4, size_prune_start=50), 49, 4),
    "size_prune_random_after": (lambda: _pool(300, 4, big=0.1), 3.0,
                                dict(grad_threshold=1.5e-4, size_prune_start=50), 50, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_densify_prune_step_matches_jax(case):
    make, extent, fields, step, seed = CASES[case]
    arrays, state = make()
    c = arrays["means"].shape[0]
    key = jax.random.key(seed)
    j_new, j_touched, j_stats = JD.densify_prune_step(
        jgs.GaussianModel.from_arrays(arrays), JD.DensifyState(*(jnp.asarray(x) for x in state)), key, extent,
        jgs.DensifyConfig(**fields), step=step)
    eps = np.asarray(jax.random.normal(key, (c, 3), jnp.float32))  # what JAX draws inside

    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    params = [getattr(model, k) for k in NAMES]
    out, touched, stats = D._densify_prune_step(model, D.DensifyState(*(t(x) for x in state)), t(eps), extent,
                                                tgs.DensifyConfig(**fields), step)
    assert out is model and all(getattr(model, k) is p for k, p in zip(NAMES, params))  # in place
    assert stats == {k: int(v) for k, v in j_stats.items()}
    np.testing.assert_array_equal(touched.numpy(), np.asarray(j_touched))
    alive = D.alive_mask(model).numpy()
    np.testing.assert_array_equal(alive, np.asarray(JD.alive_mask(j_new)))
    new_rows = touched.numpy() & alive  # new clones and split halves, and shrunk split originals
    for name in NAMES:
        got, want = getattr(model, name).detach().numpy(), np.asarray(getattr(j_new, name))
        if name == "means":  # mean + R @ (scale * eps) cancels: 1e-6 of each row's largest component
            scale = np.abs(want[new_rows]).max(axis=1, keepdims=True)
            assert (np.abs(got[new_rows] - want[new_rows]) <= 1e-6 * scale).all()
            got, want = got[~new_rows], want[~new_rows]
        np.testing.assert_array_equal(got, want, err_msg=name)
    if case.startswith(("more_", "tied")):
        assert stats["cloned"] > 0 and stats["split"] > 0 and stats["pruned"] > 0, stats
    if case == "more_candidates_than_free":
        assert stats["wanted"] > stats["cloned"] + stats["split"], stats
    if case.startswith("size_prune_random"):
        # Past size_prune_start the size criteria prune more than opacity alone.
        assert (stats["pruned"] > 40) == case.endswith("after"), stats


def test_densify_prune_step_draws_from_its_generator():
    """The public step draws ``C`` normal rows from the generator and gives
    them to the private one: equal generators, equal results."""
    arrays, state = _pool(256, 1, alive_share=0.9)
    cfg = tgs.DensifyConfig(grad_threshold=1e-4, percent_dense=0.05)
    a = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    b = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    gen = torch.Generator().manual_seed(7)
    D.densify_prune_step(a, D.DensifyState(*(t(x) for x in state)), gen, 2.0, cfg, step=10)
    eps = torch.randn((256, 3), generator=torch.Generator().manual_seed(7))
    D._densify_prune_step(b, D.DensifyState(*(t(x) for x in state)), eps, 2.0, cfg, 10)
    for name in NAMES:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_reset_opt_rows_matches_jax():
    """After one Adam update with equal gradients, zeroing the moments of
    the masked rows: the port's ``exp_avg`` / ``exp_avg_sq`` against optax's
    ``mu`` / ``nu`` (rtol 1e-6; the masked rows exactly 0), the other rows
    unchanged and Adam's step count untouched."""
    arrays = random_splat_arrays(np.random.default_rng(7), 32)
    grads = {k: np.random.default_rng(i).normal(size=arrays[k].shape).astype(np.float32) for i, k in enumerate(NAMES)}
    mask = np.random.default_rng(8).uniform(size=32) < 0.4
    tc = tgs.TrainConfig()
    j_model = jgs.GaussianModel.from_arrays(arrays)
    j_opt = j_make_optimizer(jgs.TrainConfig())
    _, j_state = j_opt.update(jgs.GaussianModel(*(jnp.asarray(grads[k]) for k in NAMES)), j_opt.init(j_model), j_model)
    j_state = JD.reset_opt_rows(j_state, jnp.asarray(mask))
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    opt = make_optimizer(model, tc)
    for k in NAMES:
        getattr(model, k).grad = t(grads[k])
    optimizer_step(opt, tc)
    before = {k: {n: v.clone() for n, v in opt.state[getattr(model, k)].items()} for k in NAMES}
    D.reset_opt_rows(opt, t(mask))
    for k in NAMES:
        state = opt.state[getattr(model, k)]
        adam = j_state.inner_states[k].inner_state[0]
        assert torch.equal(state["step"], before[k]["step"])
        for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            got = state[ours].numpy()
            assert not got[mask].any() and np.array_equal(got[~mask], before[k][ours].numpy()[~mask]), (k, ours)
            np.testing.assert_allclose(got, np.asarray(getattr(theirs, k)), rtol=1e-6, atol=0, err_msg=f"{k} {ours}")


# -- initialisation from SfM points --------------------------------------------


def test_knn_mean_sq_dist_matches_jax():
    pts = np.random.default_rng(11).normal(size=(37, 3)).astype(np.float32)
    want = np.asarray(j_knn_mean_sq_dist(jnp.asarray(pts), k=3, chunk=8))
    for chunk in (8, 5, None):  # 37 rows: chunks that do not divide it, and the default
        np.testing.assert_allclose(knn_mean_sq_dist(t(pts), k=3, chunk=chunk).numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(knn_mean_sq_dist(t(pts[:1])).numpy(), [1.0])


def test_from_points3d_matches_jax():
    rng = np.random.default_rng(13)
    xyzs = rng.uniform(-1, 1, (50, 3))
    rgbs = rng.integers(0, 256, (50, 3))
    want = jgs.GaussianModel.from_points3d(xyzs, rgbs, initial_opacity=0.2)
    model = tgs.GaussianModel.from_points3d(xyzs, rgbs, initial_opacity=0.2, device="cpu")
    for name in NAMES:
        np.testing.assert_allclose(getattr(model, name).detach().numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=0, err_msg=name)
    if not torch.cuda.is_available():  # the factory defaults to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgs.GaussianModel.from_points3d(xyzs, rgbs)


# -- a densifying fit against JAX's ---------------------------------------------


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _captured(name):
    logger = logging.getLogger(name)
    handler = _Capture()
    logger.addHandler(handler)
    return logger, handler


def test_densifying_fit_matches_jax(monkeypatch):
    """9 densifying steps, passes at steps 3 and 6, no splits (the clone /
    split cut is far above every scale), against JAX's ``fit``: losses at
    rtol 1e-5, each pass's log line (clones, splits, prunes, alive) and the
    compacted size equal, parameters within 1% of one step's learning rate.
    Every accumulated ``avg_grad`` stays at least 1e-3 relative away from
    ``grad_threshold`` and every opacity at a pass 1e-3 relative away from
    ``min_opacity``, so no decision can flip between the two."""
    rng = np.random.default_rng(8)
    arrays = random_splat_arrays(rng, 60)
    jcams = [orbit_camera(a, width=48, height=32) for a in (0.0, 0.25)]
    targets = [rng.uniform(0, 1, (32, 48, 3)).astype(np.float32) for _ in jcams]
    kw = dict(steps=9, log_every=1, ssim_weight=0.2)
    dense = dict(every=3, start=1, grad_threshold=GRAD_THRESHOLD, min_opacity=0.3, percent_dense=1e6,
                 pool_factor=1.5)
    jt = JTrainer(raster=jgs.RasterConfig(**SMALL, use_pallas=False),
                  train=jgs.TrainConfig(**kw, densify=jgs.DensifyConfig(**dense)), show_progress=False)
    tc = tgs.TrainConfig(**kw, densify=tgs.DensifyConfig(**dense))
    trainer = tgs.Trainer(raster=tgs.RasterConfig(**SMALL), train=tc, show_progress=False)

    margins = []
    real = D.densify_prune_step

    def recording(model, state, *args, **kwargs):
        seen = (D.alive_mask(model) & (state.grad_count > 0)).numpy()
        avg = (state.grad_sum / state.grad_count.clamp(min=1)).numpy()[seen]
        opacity = torch.sigmoid(model.opacity_logits.detach()).numpy()[D.alive_mask(model).numpy()]
        margins.append((np.abs(avg / GRAD_THRESHOLD - 1).min(), np.abs(opacity / dense["min_opacity"] - 1).min(),
                        (avg >= GRAD_THRESHOLD).sum(), (opacity < dense["min_opacity"]).sum()))
        return real(model, state, *args, **kwargs)

    monkeypatch.setattr(D, "densify_prune_step", recording)
    j_logger, j_handler = _captured("gsplat_tpu")
    logger, handler = _captured("gsplat_tpu_torch")
    try:
        j_model, j_hist = jt.fit(jgs.GaussianModel.from_arrays(arrays),
                                 [(c, jnp.asarray(x)) for c, x in zip(jcams, targets)])
        model, hist = trainer.fit(tgs.GaussianModel.from_arrays(arrays, device="cpu"),
                                  [(port_camera(c), t(x)) for c, x in zip(jcams, targets)])
    finally:
        j_logger.removeHandler(j_handler)
        logger.removeHandler(handler)
    assert len(margins) == 2
    for avg_margin, opacity_margin, wanted, low in margins:
        assert avg_margin >= 1e-3 and opacity_margin >= 1e-3, margins
        assert wanted > 0 and low > 0, margins  # clones and prunes happen at both passes
    j_lines = [m for m in j_handler.messages if m.startswith("densify")]
    lines = [m for m in handler.messages if m.startswith("densify")]
    assert len(lines) == 2 and lines == j_lines, (lines, j_lines)
    assert [h["step"] for h in hist] == [h["step"] for h in j_hist] == list(range(9))
    for got, want in zip(hist, j_hist):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), got["step"]
    assert model.num_gaussians == j_model.num_gaussians == int(D.num_alive(model))
    for k in NAMES:
        lr = getattr(tc, LR_FIELD[k])
        np.testing.assert_allclose(getattr(model, k).detach().numpy(), np.asarray(getattr(j_model, k)), rtol=0,
                                   atol=1e-2 * lr, err_msg=k)
