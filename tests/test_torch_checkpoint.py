"""Checkpoints of the port: Inria PLY files against the JAX package's, and
resumed training against uninterrupted training.

* PLY: a checkpoint the port writes loads bitwise through JAX's
  ``load_ply_checkpoint`` and its bytes equal the file JAX writes for the
  same model; a JAX checkpoint loads bitwise in the port.
* The loop state (``torch.save``, the port's own format) round-trips the
  model, the optimizer state and the step.
* Resume: the three cases of ``tests/test_train.py`` (plain; densifying,
  interrupted between a checkpoint and the next densify pass; random
  background), each resumed run bitwise equal to the uninterrupted one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsplat_tpu.models.gaussians import GaussianModel as JModel
from gsplat_tpu.train import checkpoint as JCK

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.train import checkpoint as CK
from gsplat_tpu_torch.train import densify as D

from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

CFG = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 13)
NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")


def port_camera(jcam):
    return tgs.CameraParams(**dataclasses.asdict(jcam))


def assert_models_equal(a, b):
    for name in NAMES:
        assert torch.equal(getattr(a, name).detach(), getattr(b, name).detach()), name


def test_ply_checkpoint_matches_jax(tmp_path):
    arrays = random_splat_arrays(np.random.default_rng(4), 31)
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    path = CK.save_ply_checkpoint(str(tmp_path / "port"), model, iteration=7000)
    assert path.endswith("point_cloud/iteration_7000/point_cloud.ply")
    j_path = JCK.save_ply_checkpoint(str(tmp_path / "jax"), JModel.from_arrays(arrays), 7000)
    with open(path, "rb") as f, open(j_path, "rb") as g:
        assert f.read() == g.read()
    loaded = JCK.load_ply_checkpoint(str(tmp_path / "port"), iteration=7000)
    for name in NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(loaded, name)), arrays[name], err_msg=name)
    back = CK.load_ply_checkpoint(str(tmp_path / "jax"), iteration=7000, device="cpu")
    assert_models_equal(back, model)


def test_train_state_roundtrip(tmp_path):
    """Model, Adam moments and steps, each group's settings (the means'
    schedule count among them) and extras come back; the file loads with
    ``weights_only=True``."""
    model = tgs.GaussianModel.from_arrays(random_splat_arrays(np.random.default_rng(5), 17), device="cpu")
    trainer = tgs.Trainer(raster=CFG, train=tgs.TrainConfig(lr_means_decay_steps=10, lr_means_final=1e-6),
                          show_progress=False)
    opt = trainer.init_state(model)
    views = [(port_camera(orbit_camera(0.0, width=48, height=32)), torch.full((32, 48, 3), 0.5))]
    trainer.train_step(model, opt, *views[0])
    path = str(tmp_path / "ckpt" / "state.pt")
    CK.save_train_state(path, model, opt, step=42, extras={"note": torch.arange(3)})
    torch.load(path, weights_only=True)
    restored, r_opt, step, extras = CK.restore_train_state(path, trainer.init_state, with_extras=True, device="cpu")
    assert step == 42 and torch.equal(extras["note"], torch.arange(3))
    assert_models_equal(restored, model)
    assert r_opt.param_groups[0]["updates"] == 1
    for p, q in zip(model.parameters(), restored.parameters()):
        for key, value in opt.state[p].items():
            assert torch.equal(r_opt.state[q][key], value), key
    raw = CK.restore_train_state(path, device="cpu")[1]
    assert raw["param_groups"][0]["updates"] == 1 and len(raw["state"]) == 5


def _resume_fixture(seed, n=120):
    """``tests/test_train.py``'s resume fixture: two views rendered from a
    model, and that model with perturbed means."""
    rng = np.random.default_rng(seed)
    arrays = random_splat_arrays(rng, n)
    target_model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    cameras = [port_camera(orbit_camera(a, width=48, height=32)) for a in (0.0, 0.2)]
    with torch.no_grad():
        views = [(cam, tgs.render(target_model, cam, CFG)[0]) for cam in cameras]
    arrays["means"] = arrays["means"] + rng.normal(0, 0.01, arrays["means"].shape).astype(np.float32)
    return arrays, views


# name: (seed, TrainConfig fields, steps before the interruption)
RESUME_CASES = {
    "plain": (9, dict(steps=6, log_every=100, ssim_weight=0.2, checkpoint_every=3), 3),
    # Interrupted between the checkpoint at step 3 and the pass at step 4:
    # the viewspace accumulator of steps 0-2 and the generator must survive.
    "densify": (11, dict(steps=10, log_every=100, ssim_weight=0.0, checkpoint_every=3,
                         densify=tgs.DensifyConfig(every=4, start=0, grad_threshold=1e-6, pool_factor=1.5)), 3),
    "random_background": (13, dict(steps=4, log_every=100, ssim_weight=0.0, checkpoint_every=2,
                                   background="random"), 2),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_matches_uninterrupted(tmp_path, case):
    seed, fields, cut = RESUME_CASES[case]
    arrays, views = _resume_fixture(seed)
    tc = tgs.TrainConfig(**fields)

    def fresh():
        return tgs.GaussianModel.from_arrays(arrays, device="cpu")

    m_ref, _ = tgs.Trainer(raster=CFG, train=tc, show_progress=False).fit(fresh(), views)
    ckpt = str(tmp_path / "run")
    tgs.Trainer(raster=CFG, train=tc, show_progress=False).fit(fresh(), views, steps=cut, checkpoint_dir=ckpt)
    assert CK.has_loop_state(ckpt)
    m_res, history = tgs.Trainer(raster=CFG, train=tc, show_progress=False).fit(
        fresh(), views, checkpoint_dir=ckpt, resume=True)
    assert history[0]["step"] >= cut  # resumed, not restarted
    assert_models_equal(m_res, m_ref)
    if tc.densify is not None:
        assert m_ref.num_gaussians == int(D.num_alive(m_ref)) > len(arrays["means"])  # compacted, and it grew
