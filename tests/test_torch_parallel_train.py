"""The port's mesh training (``make_parallel_train_step``,
``ParallelTrainer``) held against the JAX package's on the CPU.

As ``test_torch_parallel.py``: the JAX side on the 8-virtual-device CPU
mesh (jnp path), the port's ranks spawned over gloo by
``torch_mesh_worker.py``, 64x48, tile 16, pair block 8, the 200-splat
fixture, with random targets so that the gradients are far from zero.

* one train step at 1x2, 2x1 and 2x2, SSIM weight 0.2 and 0: loss and PSNR
  at rtol 1e-5, the updated parameters within rtol 2e-3 + atol 5e-5 of each
  array's largest magnitude, the replicas bitwise equal;
* the per-view viewspace probe under dp 2 at rtol 1e-4 / atol 1e-6 of its
  scale (``test_parallel.py``'s tolerance), and the per-view screen radii
  the step returns beside it, equal to JAX's;
* ``ParallelTrainer.fit`` on 2x2 (3 steps, no densification): losses at
  rtol 1e-5 and the parameters within 1% of one step's learning rate, as
  ``test_torch_train.py`` holds ``Trainer.fit``;
* port only (``test_parallel.py``'s checks): SH warmup, the background,
  the capacity resize on a hot shard, bitwise resume of a densifying fit,
  and every replica bitwise equal after every fit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gsplat_tpu import MeshConfig as JMeshConfig
from gsplat_tpu import RasterConfig as JRasterConfig
from gsplat_tpu import TrainConfig as JTrainConfig
from gsplat_tpu.models.gaussians import GaussianModel as JGaussianModel
from gsplat_tpu.ops.camera import CameraArrays as JCameraArrays
from gsplat_tpu.parallel.mesh import make_mesh as j_make_mesh
from gsplat_tpu.parallel.shard import ParallelTrainer as JParallelTrainer
from gsplat_tpu.parallel.shard import make_parallel_train_step as j_make_parallel_train_step
from gsplat_tpu.render.pipeline import preprocess_traced as j_preprocess_traced
from gsplat_tpu.train import densify as JD

import gsplat_tpu_torch as tgs

import torch_mesh_worker as worker
from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

JCFG = JRasterConfig(**worker.SMALL, use_pallas=False)
W, H = worker.W, worker.H
NAMES = worker.NAMES
LR_FIELD = dict(zip(NAMES, ("lr_means", "lr_scales", "lr_quats", "lr_opacity", "lr_sh")))

ARRAYS = random_splat_arrays(np.random.default_rng(9), 200)
CAMERAS = [orbit_camera(a, width=W, height=H) for a in (0.0, 0.35, 0.2)]
TARGETS = np.random.default_rng(10).uniform(0, 1, (3, H, W, 3)).astype(np.float32)
SSIM = [0.2, 0.0]


def _fields(cams):
    return [dataclasses.asdict(c) for c in cams]


@pytest.fixture(scope="module")
def steps2(tmp_path_factory):
    return worker.spawn_world(worker.step_world, 2, tmp_path_factory.mktemp("steps2"), ARRAYS, _fields(CAMERAS),
                              TARGETS, [(1, 2), (2, 1)], SSIM, (2, 1))


@pytest.fixture(scope="module")
def steps4(tmp_path_factory):
    return worker.spawn_world(worker.step_world, 4, tmp_path_factory.mktemp("steps4"), ARRAYS, _fields(CAMERAS),
                              TARGETS, [(2, 2)], SSIM, None)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fits")
    return worker.spawn_world(worker.fit_world, 4, tmp, ARRAYS, _fields(CAMERAS), TARGETS, worker.hot_arrays(), str(tmp))


def _jax_step(data, tile, ssim_weight, with_viewspace_grad=False):
    mesh = j_make_mesh(JMeshConfig(data=data, tile=tile))
    step, init_state, prepare = j_make_parallel_train_step(
        mesh, W, H, JCFG, JTrainConfig(ssim_weight=ssim_weight), with_viewspace_grad=with_viewspace_grad)
    model = JGaussianModel.from_arrays(ARRAYS)
    cams = JCameraArrays.stack([JCameraArrays.from_params(c) for c in CAMERAS[:data]])
    return step(model, init_state(model), cams, prepare(jnp.asarray(TARGETS[:data])))


@pytest.mark.parametrize("ssim_weight", SSIM)
@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2"])
def test_train_step_matches_jax(request, mesh, ssim_weight):
    data, tile = (int(x) for x in mesh.split("x"))
    ranks = request.getfixturevalue("steps4" if data * tile == 4 else "steps2")
    j_model, _, j_metrics = _jax_step(data, tile, ssim_weight)[:3]
    got = ranks[0][f"{mesh}_{ssim_weight}"]
    for k in ("loss", "psnr"):
        assert got[k] == pytest.approx(float(j_metrics[k]), rel=1e-5), k
    for k in NAMES:
        want = np.asarray(getattr(j_model, k))
        np.testing.assert_allclose(got["params"][k], want, rtol=2e-3, atol=5e-5 * np.abs(want).max(), err_msg=k)
    assert len({r[f"{mesh}_{ssim_weight}"]["digest"] for r in ranks}) == 1  # the replicas agree bitwise


def test_viewspace_probe_per_view_matches_jax(steps2):
    """Under dp 2 the step returns one probe row per camera, each the
    gradient of its own view's loss, on every rank."""
    want = np.asarray(_jax_step(2, 1, 0.0, with_viewspace_grad=True)[3])
    got = steps2[0]["2x1_0.0"]["viewspace"]
    assert got.shape == want.shape == (2, len(ARRAYS["means"]), 2)
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(want[1] - want[0]).max() > 1e-6 * scale
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_array_equal(steps2[1]["2x1_0.0"]["viewspace"], got)


def test_viewspace_radii_per_view_match_jax(steps2):
    """Under dp 2 the step also returns each view's screen radii, gathered
    with the rows, equal to those of JAX's whole-model preprocess (what
    JAX's ``ParallelTrainer`` takes them from), on every rank."""
    model = JGaussianModel.from_arrays(ARRAYS)
    want = np.stack([np.asarray(JD.screen_radii(p.conics, p.active)) for p in (
        j_preprocess_traced(model, JCameraArrays.from_params(c), W, H, JCFG) for c in CAMERAS[:2])])
    got = steps2[0]["2x1_0.0"]["radii"]
    assert got.shape == want.shape == (2, len(ARRAYS["means"])) and (want > 0).sum() > 100
    assert np.any(want[0] != want[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(steps2[1]["2x1_0.0"]["radii"], got)


def test_fit_matches_jax(fits):
    tc = JTrainConfig(steps=3, log_every=1, ssim_weight=0.2)
    trainer = JParallelTrainer(mesh=j_make_mesh(JMeshConfig(data=2, tile=2)), raster=JCFG, train=tc,
                               show_progress=False)
    j_model, j_hist = trainer.fit(JGaussianModel.from_arrays(ARRAYS),
                                  [(c, jnp.asarray(t)) for c, t in zip(CAMERAS, TARGETS)])
    got = fits[0]["fit"]
    assert got["records"] == got["history"] and [h["step"] for h in got["history"]] == [0, 1, 2]
    assert all(r["fit"]["records"] == [] for r in fits[1:])  # rank 0 alone logs
    for g, w in zip(got["history"], j_hist):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["psnr"] == pytest.approx(w["psnr"], rel=1e-5)
    for k in NAMES:
        np.testing.assert_allclose(got["params"][k], np.asarray(getattr(j_model, k)), rtol=0,
                                   atol=1e-2 * getattr(tc, LR_FIELD[k]), err_msg=k)


def test_fit_sh_warmup(fits):
    """With warmup the first step trains at SH degree 0: bands 1-3 change
    nothing; without it they do."""
    base, shifted = fits[0]["warmup_2"]
    assert base == pytest.approx(shifted, rel=1e-6)
    base, shifted = fits[0]["warmup_0"]
    assert abs(base - shifted) > 1e-6


def test_fit_background(fits):
    """A transparent scene against white targets: L1 1 on black, 0 on white."""
    assert fits[0]["background_black"] == pytest.approx(1.0, abs=1e-5)
    assert fits[0]["background_white"] == pytest.approx(0.0, abs=1e-5)


def test_fit_resizes_on_a_hot_shard(fits):
    hot = fits[0]["hot"]
    assert hot["grew"] and hot["max_pairs"] == tgs.required_max_pairs(hot["demand"]) >= hot["demand"]


def test_densifying_fit_resumes_bitwise(fits):
    for rank in fits:
        assert rank["resume"]["digest"] == rank["resume"]["resumed_digest"]
    assert fits[0]["resume"]["alive"] > len(ARRAYS["means"])  # clones were made


@pytest.mark.parametrize("case", ["fit", "resume", "split"])
def test_replicas_stay_bitwise_equal(fits, case):
    assert len({rank[case]["digest"] for rank in fits}) == 1
