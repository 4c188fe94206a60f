"""The step functions of the port's preprocess (``gsplat_tpu_torch/ops/
projection.py``) held against the JAX package's of the same names
(``gsplat_tpu/ops/projection.py``): ``project_to_camera_space``,
``project_to_screen``, ``ewa_project_covariance``, ``conic_from_cov2d``,
``covering_bbox``, ``preprocess_active_mask`` and the array-of-structs
``preprocess_gaussians``.

Both packages get the same numpy arrays, made from seeds with
``fixtures.py`` (splats, orbit cameras whose frusta cull some of them).
Float results are compared at rtol=1e-5 (atol=1e-6 for values near zero,
as ``tests/test_torch_ops.py``); bboxes and masks must be equal. Where a
step takes another step's output, each side takes the JAX package's, so
every step is held on the same inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.models.gaussians import GaussianModel as JModel
from gsplat_tpu.ops import projection as jproj
from gsplat_tpu.ops.camera import CameraArrays as JCameraArrays

from gsplat_tpu_torch.ops import projection as tproj
from gsplat_tpu_torch.ops.camera import CameraArrays, CameraParams

from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-6
# (seed, gaussians, orbit angle, width, height)
SCENES = [(0, 300, 0.3, 64, 48), (11, 500, -0.4, 50, 35), (5, 200, 1.2, 160, 120)]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=SCENES, ids=lambda s: f"seed{s[0]}")
def inputs(request):
    """Per scene: the JAX camera arrays, the port's, the model's means,
    covariances, opacity and colours (numpy), and the frame size."""
    seed, n, angle, width, height = request.param
    arrays = random_splat_arrays(np.random.default_rng(seed), n)
    jm = JModel.from_arrays(arrays)
    jcam = orbit_camera(angle, width=width, height=height)
    rng = np.random.default_rng(seed + 1)
    data = {"means": np.asarray(jm.means), "cov3d": np.asarray(jm.covariances()),
            "opacity": np.asarray(jm.opacity()), "rgb": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    cam = CameraArrays.from_params(CameraParams(**dataclasses.asdict(jcam)), device="cpu")
    return JCameraArrays.from_params(jcam), cam, data, width, height


def _culled(jcam, data):
    cam_z = np.asarray(jproj.project_to_camera_space(jnp.asarray(data["means"]), jcam.w2c_t))[:, 2]
    return cam_z < 0.2


def test_camera_space_and_screen(inputs):
    jcam, cam, data, w, h = inputs
    assert cam.w2c_t.dtype == torch.float32
    j_points = jproj.project_to_camera_space(jnp.asarray(data["means"]), jcam.w2c_t)
    close(tproj.project_to_camera_space(t(data["means"]), cam.w2c_t), j_points)
    cam_z = np.asarray(j_points)[:, 2]
    want = jproj.project_to_screen(jnp.asarray(data["means"]), jcam.full_proj_t, jnp.asarray(cam_z), w, h)
    got = tproj.project_to_screen(t(data["means"]), cam.full_proj_t, t(cam_z), w, h)
    close(got, want)
    assert _culled(jcam, data).any() and not _culled(jcam, data).all(), "the scene culls some splats, not all"


def test_ewa_conic_bbox_and_mask(inputs):
    jcam, cam, data, w, h = inputs
    j_points = np.asarray(jproj.project_to_camera_space(jnp.asarray(data["means"]), jcam.w2c_t))
    tan = [float(x) for x in np.asarray(jcam.tan_fov)]
    focal = [float(x) for x in np.asarray(jcam.focal)]
    want_cov = jproj.ewa_project_covariance(jnp.asarray(data["cov3d"]), jnp.asarray(j_points), *tan, *focal,
                                            jcam.w2c_t)
    got_cov = tproj.ewa_project_covariance(t(data["cov3d"]), t(j_points), *tan, *focal, cam.w2c_t)
    live = ~_culled(jcam, data)  # behind the near plane z may be ~0 and the Jacobian huge
    close(got_cov[torch.from_numpy(live)], np.asarray(want_cov)[live])

    cov2d = np.where(_culled(jcam, data)[:, None, None], 0.0, np.asarray(want_cov)).astype(np.float32)
    j_conic, j_det = jproj.conic_from_cov2d(jnp.asarray(cov2d))
    conic, det = tproj.conic_from_cov2d(t(cov2d))
    close(conic, j_conic)
    close(det, j_det)
    assert (np.asarray(j_det) == 0).any(), "culled splats give the zero conic"

    screen = np.asarray(jproj.project_to_screen(jnp.asarray(data["means"]), jcam.full_proj_t,
                                                jnp.asarray(j_points[:, 2]), w, h))
    j_bbox = np.asarray(jproj.covering_bbox(jnp.asarray(screen), jnp.asarray(cov2d), w, h))
    bbox = tproj.covering_bbox(t(screen), t(cov2d), w, h)
    assert bbox.dtype == torch.int32
    np.testing.assert_array_equal(bbox.numpy(), j_bbox)

    j_conic = np.asarray(j_conic).copy()
    j_conic[::7, 2] = 0.0  # axis-aligned splats: only strict parity drops them
    for strict in (True, False):
        want = np.asarray(jproj.preprocess_active_mask(jnp.asarray(j_bbox), jnp.asarray(j_conic), strict))
        got = tproj.preprocess_active_mask(t(j_bbox), t(j_conic), strict)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any() and not want.all()


@pytest.mark.parametrize("strict", [True, False])
def test_preprocess_gaussians_aos(inputs, strict):
    jcam, cam, data, w, h = inputs
    tan = [float(x) for x in np.asarray(jcam.tan_fov)]
    focal = [float(x) for x in np.asarray(jcam.focal)]
    want = jproj.preprocess_gaussians(*(jnp.asarray(data[k]) for k in ("means", "cov3d", "opacity", "rgb")),
                                      jcam.w2c_t, jcam.full_proj_t, *tan, *focal, w, h, strict_parity=strict)
    got = tproj.preprocess_gaussians(*(t(data[k]) for k in ("means", "cov3d", "opacity", "rgb")),
                                     cam.w2c_t, cam.full_proj_t, *tan, *focal, w, h, strict_parity=strict)
    assert isinstance(got, tproj.Preprocessed)
    for field in ("bbox", "cull_bbox", "active"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    for field in ("screen_means", "conics", "rgb", "opacity", "depth"):
        close(getattr(got, field), getattr(want, field))
    assert np.asarray(want.active).sum() > 10
