"""The port's per-gaussian ops and binning held against the JAX package.

Inputs come from numpy seeds and ``fixtures.py``; both packages get the
same arrays. Float fields are compared at rtol=1e-5 (atol=1e-6 for values
near zero); integer fields (bboxes, activity, every binning output) must be
equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import RasterConfig as JRasterConfig
from gsplat_tpu.models.gaussians import GaussianModel as JModel
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops import quaternion as jquat
from gsplat_tpu.ops.camera import CameraArrays as JCameraArrays
from gsplat_tpu.ops.projection import Preprocessed as JPrep
from gsplat_tpu.ops.sh import sh_to_rgb as j_sh_to_rgb
from gsplat_tpu.render.pipeline import preprocess as j_preprocess

from gsplat_tpu_torch import RasterConfig, random_model
from gsplat_tpu_torch.models.gaussians import GaussianModel, pad_model
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops import quaternion as tquat
from gsplat_tpu_torch.ops.camera import CameraArrays, CameraParams
from gsplat_tpu_torch.ops.projection import Preprocessed
from gsplat_tpu_torch.ops.sh import sh_to_rgb
from gsplat_tpu_torch.render.pipeline import preprocess

from fixtures import make_camera, orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-6
CPU = "cpu"


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def port_camera(jcam) -> CameraParams:
    return CameraParams(**dataclasses.asdict(jcam))


def test_quaternion_ops():
    q = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
    close(tquat.normalize_quaternion(torch.from_numpy(q)), jquat.normalize_quaternion(jnp.asarray(q)))
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    close(
        tquat.quaternion_to_rotation_matrix(torch.from_numpy(qn)),
        jquat.quaternion_to_rotation_matrix(jnp.asarray(qn)),
    )


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_to_rgb(degree):
    rng = np.random.default_rng(degree)
    means = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    sh = (rng.normal(size=(200, 16, 3)) * 0.5).astype(np.float32)
    center = np.array([0.3, -0.2, 4.0], np.float32)
    got = sh_to_rgb(torch.from_numpy(means), torch.from_numpy(sh), torch.from_numpy(center), degree)
    want = j_sh_to_rgb(jnp.asarray(means), jnp.asarray(sh), jnp.asarray(center), degree)
    close(got, want)


def test_sh_to_rgb_grad_at_the_clamp_edges():
    """A colour exactly 0 or 1 (``from_points3d`` of an SfM colour 0 or 255)
    takes half the gradient through the clamp, as through ``jnp.clip``;
    inside (0, 1) all of it, outside none."""
    import jax

    from gsplat_tpu_torch.ops.sh import SH_C0

    rgb = np.array([[0.0, 1.0, 0.5], [-0.25, 1.25, 0.0]], np.float32)
    sh = np.zeros((2, 16, 3), np.float32)
    sh[:, 0] = (rgb - 0.5) / SH_C0
    means = np.array([[0.0, 0.0, 1.0], [0.5, 0.0, 2.0]], np.float32)
    center = np.zeros(3, np.float32)
    want = jax.grad(lambda s: j_sh_to_rgb(jnp.asarray(means), s, jnp.asarray(center), 0).sum())(jnp.asarray(sh))
    sh_t = torch.from_numpy(sh).requires_grad_(True)
    colors = sh_to_rgb(torch.from_numpy(means), sh_t, torch.from_numpy(center), 0)
    assert torch.equal(colors.detach(), torch.from_numpy(np.clip(rgb, 0, 1)))
    (got,) = torch.autograd.grad(colors.sum(), [sh_t])
    close(got, want)
    np.testing.assert_array_equal(got[:, 0].numpy() / SH_C0, [[0.5, 0.5, 1.0], [0.0, 0.0, 0.5]])


@pytest.mark.parametrize("angle", [0.0, 0.15, -0.7])
def test_camera_matrices_and_arrays(angle):
    jcam = orbit_camera(angle, width=64, height=48)
    cam = port_camera(jcam)
    for got, want in zip(cam.matrices(), jcam.matrices()):
        close(got, want)
    arrays = CameraArrays.from_params(cam, device=CPU)
    jarrays = JCameraArrays.from_params(jcam)
    for field in JCameraArrays._fields:
        close(getattr(arrays, field), getattr(jarrays, field))
    stacked = CameraArrays.stack([arrays, arrays])
    jstacked = JCameraArrays.stack([jarrays, jarrays])
    for field in JCameraArrays._fields:
        close(getattr(stacked, field), getattr(jstacked, field))


def test_model_activations_and_pad():
    arrays = random_splat_arrays(np.random.default_rng(3), 40)
    jm = JModel.from_arrays(arrays)
    m = GaussianModel.from_arrays(jm.to_arrays(), device=CPU)
    for key, value in jm.to_arrays().items():
        np.testing.assert_array_equal(m.to_arrays()[key], value)
    with torch.no_grad():
        close(m.scales(), jm.scales())
        close(m.opacity(), jm.opacity())
        close(m.covariances(), jm.covariances())
        padded = pad_model(m, 50)
    from gsplat_tpu.models.gaussians import pad_model as j_pad_model

    for key, value in j_pad_model(jm, 50).to_arrays().items():
        np.testing.assert_array_equal(padded.to_arrays()[key], value)


def test_random_model_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    m = random_model(g, 1000, extent=2.0, device=CPU)
    assert m.means.shape == (1000, 3) and m.sh.shape == (1000, 16, 3)
    assert m.means.abs().max() <= 2.0
    assert -5.0 <= m.log_scales.min() and m.log_scales.max() <= -2.0
    assert -2.0 <= m.opacity_logits.min() and m.opacity_logits.max() <= 3.0
    m2 = random_model(torch.Generator().manual_seed(0), 1000, extent=2.0, device=CPU)
    torch.testing.assert_close(m.quats, m2.quats, rtol=0, atol=0)


SCENES = [(0, 300, 0.3, 64, 48), (7, 300, 0.2, 64, 48), (11, 500, -0.4, 50, 35), (5, 150, 0.15, 48, 32)]


@pytest.mark.parametrize("seed,n,angle,width,height", SCENES)
@pytest.mark.parametrize("strict_parity", [True, False])
def test_preprocess_matches_jax(seed, n, angle, width, height, strict_parity):
    arrays = random_splat_arrays(np.random.default_rng(seed), n)
    jcam = orbit_camera(angle, width=width, height=height)
    jprep = j_preprocess(JModel.from_arrays(arrays), jcam, JRasterConfig(strict_parity=strict_parity))
    with torch.no_grad():
        prep = preprocess(
            GaussianModel.from_arrays(arrays, device=CPU), port_camera(jcam),
            RasterConfig(strict_parity=strict_parity),
        )
    for field in ("screen_means", "conics", "rgb", "opacity", "depth"):
        close(getattr(prep, field), getattr(jprep, field))
    for field in ("bbox", "cull_bbox", "active"):
        np.testing.assert_array_equal(
            getattr(prep, field).numpy(), np.asarray(getattr(jprep, field)), err_msg=field
        )


def to_port_prep(jprep) -> Preprocessed:
    return Preprocessed(*(torch.from_numpy(np.array(x)) for x in jprep))


def assert_bins_equal(got, want):
    for field in jbin.TileBinning._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )


@pytest.mark.parametrize("seed,n,angle,width,height", SCENES)
@pytest.mark.parametrize("max_pairs,align", [(4096, 8), (96, 8), (37, 4), (1, 8)])
def test_binning_matches_jax_on_fixture_scenes(seed, n, angle, width, height, max_pairs, align):
    """Integer-equal binning on the same preprocess, with and without
    capacity overflow (the small ``max_pairs`` drop deepest gaussians)."""
    arrays = random_splat_arrays(np.random.default_rng(seed), n)
    jprep = j_preprocess(JModel.from_arrays(arrays), orbit_camera(angle, width, height), JRasterConfig())
    want = jbin.bin_gaussians(jprep, width, height, 16, max_pairs, align=align)
    got = tbin.bin_gaussians(to_port_prep(jprep), width, height, 16, max_pairs, align=align)
    assert_bins_equal(got, want)
    np.testing.assert_array_equal(
        tbin.pack_features(to_port_prep(jprep)).numpy(), np.asarray(jbin.pack_features(jprep))
    )


def hand_built_prep(rng, n, width=64, height=64):
    """Square bboxes, tie-heavy depths and interleaved inactive gaussians
    (the cases ``tests/test_binning.py`` fuzzes)."""
    means = rng.uniform(-8, 72, (n, 2)).astype(np.float32)
    r = rng.uniform(0, 16, n).astype(np.float32)
    bbox = np.stack(
        [
            np.clip(means[:, 0] - r, 0, width - 1), np.clip(means[:, 1] - r, 0, height - 1),
            np.clip(means[:, 0] + r, 0, width - 1), np.clip(means[:, 1] + r, 0, height - 1),
        ],
        axis=-1,
    ).astype(np.int32)
    return JPrep(
        screen_means=jnp.asarray(means),
        conics=jnp.ones((n, 3), jnp.float32),
        rgb=jnp.ones((n, 3), jnp.float32),
        opacity=jnp.ones((n,), jnp.float32),
        depth=jnp.asarray(np.round(rng.uniform(1, 5, n), 1).astype(np.float32)),
        bbox=jnp.asarray(bbox),
        cull_bbox=jnp.asarray(bbox),
        active=jnp.asarray(rng.uniform(size=n) < 0.8),
    )


@pytest.mark.parametrize("seed", range(3))
def test_binning_matches_jax_fuzz(seed):
    rng = np.random.default_rng(100 + seed)
    jprep = hand_built_prep(rng, int(rng.integers(20, 120)))
    prep = to_port_prep(jprep)
    align = (1, 4, 8)[seed % 3]
    demand = int(tbin.bin_gaussians(prep, 64, 64, 16, 1 << 10).pair_demand)
    # One pair over the capacity, and deep overflow.
    for max_pairs in (demand - 1, demand // 3):
        want = jbin.bin_gaussians(jprep, 64, 64, 16, max_pairs, align=align)
        got = tbin.bin_gaussians(prep, 64, 64, 16, max_pairs, align=align)
        assert_bins_equal(got, want)


def test_depth_key_is_monotone():
    d = torch.tensor([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 0.2, 2.0, 1e30, np.inf])
    k = tbin.depth_key(d)
    assert (k[1:] >= k[:-1]).all() and k.min() >= 0 and k.max() < 2**32
