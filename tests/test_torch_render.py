"""The port's whole render slice, its I/O and its device rules, held
against the JAX package.

``render`` on the CPU (the plain compositor) is compared with JAX ``render``
(``use_pallas=False``, the jnp tile renderer) and with the sequential oracle
at rtol=1e-5 / atol=1e-6.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as jgs
from gsplat_tpu.io.ply import load_splat_arrays as j_load_splat_arrays
from gsplat_tpu.io.scene import checkpoint_ply_path as j_checkpoint_ply_path
from gsplat_tpu.io.scene import read_points3d as j_read_points3d
from gsplat_tpu.io.scene import read_scene as j_read_scene

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.io.ply import load_splat_arrays, save_splat_arrays
from gsplat_tpu_torch.io.scene import checkpoint_ply_path, read_points3d, read_scene

from fixtures import make_camera, orbit_camera, random_splat_arrays, write_synthetic_scene
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


SMALL = dict(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 14)


def jax_cfg(**kw):
    return jgs.RasterConfig(**{**SMALL, "use_pallas": False, **kw})


def port_cfg(**kw):
    return tgs.RasterConfig(**{**SMALL, **kw})


def port_camera(jcam):
    return tgs.CameraParams(**dataclasses.asdict(jcam))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "seed,n,angle,width,height,sh_degree",
    [(7, 300, 0.2, 64, 48, 3), (3, 200, -0.3, 50, 35, 1), (9, 250, 0.0, 48, 32, 0)],
)
def test_render_matches_jax_and_oracle(seed, n, angle, width, height, sh_degree):
    arrays = random_splat_arrays(np.random.default_rng(seed), n)
    jcam = orbit_camera(angle, width=width, height=height)
    jmodel = jgs.GaussianModel.from_arrays(arrays)
    j_img, j_trans = jgs.render(jmodel, jcam, jax_cfg(sh_degree=sh_degree))
    j_oimg, j_otrans = jgs.render_reference_oracle(jmodel, jcam, jax_cfg(sh_degree=sh_degree))
    model = tgs.GaussianModel.from_arrays(jmodel.to_arrays(), device="cpu")
    with torch.no_grad():
        img, trans = tgs.render(model, port_camera(jcam), port_cfg(sh_degree=sh_degree))
        o_img, o_trans = tgs.render_reference_oracle(model, port_camera(jcam), port_cfg(sh_degree=sh_degree))
    assert img.shape == (height, width, 3) and trans.shape == (height, width)
    for got, want in ((img, j_img), (trans, j_trans), (img, j_oimg), (trans, j_otrans)):
        close(got, want)
    close(o_img, j_oimg)
    close(o_trans, j_otrans)


@pytest.mark.parametrize("near,far", [(0.2, 100.0), (3.5, 4.5)])
def test_render_depth_matches_jax(near, far):
    """The expected-depth map and its transmittance against JAX's at rtol
    1e-5 / atol 1e-6, and the gradient of a weighted sum of the depth with
    respect to the means against ``jax.grad`` at rtol 2e-3 / atol 5e-5 of
    the scale (``tests/test_torch_grad.py``). The (3.5, 4.5) range clamps
    the depths of the nearest and farthest splats."""
    import jax

    arrays = random_splat_arrays(np.random.default_rng(17), 200)
    jcam = orbit_camera(0.3, width=48, height=32)
    weights = np.random.default_rng(18).normal(size=(32, 48)).astype(np.float32)
    jmodel = jgs.GaussianModel.from_arrays(arrays)
    jcam_arrays = jgs.CameraArrays.from_params(jcam)
    j_depth, j_trans = jgs.render_depth(jmodel, jcam_arrays, 48, 32, jax_cfg(), near, far)

    def j_loss(means):
        model = jgs.GaussianModel(means, jmodel.log_scales, jmodel.quats, jmodel.opacity_logits, jmodel.sh)
        return jnp.sum(jgs.render_depth(model, jcam_arrays, 48, 32, jax_cfg(), near, far)[0] * weights)

    j_grad = np.asarray(jax.grad(j_loss)(jmodel.means))
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    depth, trans = tgs.render_depth(model, tgs.CameraArrays.from_params(port_camera(jcam), device="cpu"), 48, 32,
                                    port_cfg(), near, far)
    close(depth.detach(), j_depth)
    close(trans.detach(), j_trans)
    d, tr = depth.detach().numpy(), trans.detach().numpy()
    assert (tr < 0.5).mean() > 0.1
    assert (d >= near * (1 - tr) - 1e-5).all() and (d <= far * (1 - tr) + 1e-4).all()
    (grad,) = torch.autograd.grad((depth * torch.from_numpy(weights)).sum(), [model.means])
    assert np.abs(j_grad).max() > 0
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=2e-3, atol=5e-5 * np.abs(j_grad).max())


def test_render_batch_and_stats_match_jax():
    arrays = random_splat_arrays(np.random.default_rng(2), 200)
    jmodel = jgs.GaussianModel.from_arrays(arrays)
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    jcams = [orbit_camera(a) for a in (0.0, 0.25)]
    jstack = jgs.CameraArrays.stack([jgs.CameraArrays.from_params(c) for c in jcams])
    stack = tgs.CameraArrays.stack([tgs.CameraArrays.from_params(port_camera(c), device="cpu") for c in jcams])
    j_imgs, j_trans = jgs.render_batch(jmodel, jstack, 64, 48, jax_cfg())
    with torch.no_grad():
        imgs, trans = tgs.render_batch(model, stack, 64, 48, port_cfg())
        cam0 = tgs.CameraArrays(*(x[0] for x in stack))
        for cfg_kw in ({}, {"max_pairs": 16}):
            j_stats = jgs.binning_stats(jmodel, jgs.CameraArrays(*(x[0] for x in jstack)), 64, 48, jax_cfg(**cfg_kw))
            stats = tgs.binning_stats(model, cam0, 64, 48, port_cfg(**cfg_kw))
            assert {k: int(v) for k, v in stats.items()} == {k: int(v) for k, v in j_stats.items()}
        tiny = port_cfg(max_pairs=16)
        assert tgs.suggest_max_pairs(model, port_camera(jcams[0]), tiny) == jgs.suggest_max_pairs(
            jmodel, jcams[0], jax_cfg(max_pairs=16)
        )
    close(imgs, j_imgs)
    close(trans, j_trans)


def test_weights_carry_over_from_jax():
    jmodel = jgs.random_model(__import__("jax").random.key(3), 120)
    model = tgs.GaussianModel.from_arrays(jmodel.to_arrays(), device="cpu")
    for key, value in jmodel.to_arrays().items():
        np.testing.assert_array_equal(getattr(model, key).detach().numpy(), value)
    with torch.no_grad():
        img, _ = tgs.render(model, port_camera(make_camera()), port_cfg())
    j_img, _ = jgs.render(jmodel, make_camera(), jax_cfg())
    close(img, j_img)


def test_io_readers_match_jax(tmp_path):
    root = write_synthetic_scene(str(tmp_path / "scene"), np.random.default_rng(4), n_gaussians=120, two_cameras=True)
    images, cameras = read_scene(root)
    j_images, j_cameras = j_read_scene(root)
    assert images.keys() == j_images.keys() and cameras.keys() == j_cameras.keys()
    for k in images:
        for field in ("id", "camera_id", "name"):
            assert getattr(images[k], field) == getattr(j_images[k], field)
        for field in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(images[k], field), getattr(j_images[k], field))
        cam = tgs.CameraParams.from_colmap(images[k], cameras[images[k].camera_id], 64, 48)
        j_cam = jgs.CameraParams.from_colmap(j_images[k], j_cameras[images[k].camera_id], 64, 48)
        assert dataclasses.asdict(cam) == dataclasses.asdict(j_cam)
    for k in cameras:
        assert (cameras[k].model, cameras[k].width, cameras[k].height) == (
            j_cameras[k].model, j_cameras[k].width, j_cameras[k].height)
        np.testing.assert_array_equal(cameras[k].params, j_cameras[k].params)
    for got, want in zip(read_points3d(root), j_read_points3d(root)):
        np.testing.assert_array_equal(got, want)
    arrays = load_splat_arrays(checkpoint_ply_path(os.path.join(root, "model")))
    j_arrays = j_load_splat_arrays(j_checkpoint_ply_path(os.path.join(root, "model")))
    for key in j_arrays:
        np.testing.assert_array_equal(arrays[key], j_arrays[key])
    # The port's writer round-trips through the JAX package's reader.
    path = str(tmp_path / "out.ply")
    save_splat_arrays(path, arrays)
    for key, value in j_load_splat_arrays(path).items():
        np.testing.assert_array_equal(arrays[key], value)


def test_quickstart_flow_matches_jax(tmp_path):
    """The README Quickstart on a synthetic on-disk scene, port vs JAX."""
    root = write_synthetic_scene(str(tmp_path / "scene"), np.random.default_rng(8), n_gaussians=200)
    images, cameras = read_scene(root)
    model = tgs.GaussianModel.from_arrays(
        load_splat_arrays(checkpoint_ply_path(os.path.join(root, "model"))), device="cpu"
    )
    cam = tgs.CameraParams.from_colmap(images[1], cameras[1], 64, 48)
    with torch.inference_mode():
        image, trans = tgs.render(model, cam, port_cfg())
    j_images, j_cameras = j_read_scene(root)
    j_model = jgs.GaussianModel.from_arrays(j_load_splat_arrays(j_checkpoint_ply_path(os.path.join(root, "model"))))
    j_image, j_trans = jgs.render(j_model, jgs.CameraParams.from_colmap(j_images[1], j_cameras[1], 64, 48), jax_cfg())
    close(image, j_image)
    close(trans, j_trans)


def test_render_under_grad_gives_finite_grads():
    """Rendering under grad gives finite gradients to every parameter, on
    the single-sort and the depth-sliced path, with and without the
    compacted reduction."""
    model = tgs.GaussianModel.from_arrays(random_splat_arrays(np.random.default_rng(1), 50), device="cpu")
    for kw in ({}, {"reduce_pairs": 1024}, {"slice_pairs": 1024, "reduce_pairs": 1024}):
        img, trans = tgs.render(model, port_camera(make_camera()), port_cfg(early_stop_transmittance=1e-4, **kw))
        grads = torch.autograd.grad(img.sum() + trans.sum(), list(model.parameters()))
        assert all(bool(torch.isfinite(g).all()) for g in grads), kw
        assert any(float(g.abs().max()) > 0 for g in grads), kw


def test_default_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    arrays = random_splat_arrays(np.random.default_rng(1), 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgs.GaussianModel.from_arrays(arrays)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgs.CameraArrays.from_params(port_camera(make_camera()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgs.random_model(torch.Generator(), 10)


def test_slice_pairs_validation():
    """``slice_pairs`` must be a ``pair_block`` multiple (checked by the
    config) and at least the frame's tile count (checked at render time,
    where the frame size is known)."""
    with pytest.raises(ValueError, match="multiple of pair_block"):
        tgs.RasterConfig(pair_block=128, slice_pairs=1000)
    model = tgs.GaussianModel.from_arrays(random_splat_arrays(np.random.default_rng(1), 20), device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="tile count"):
        tgs.render(model, port_camera(make_camera()), port_cfg(tile_size=8, slice_pairs=40))  # 48 tiles


_NO_JAX_SCRIPT = """
import sys
import numpy as np, torch
import gsplat_tpu_torch as tgs
sys.path.insert(0, "tools")
import card  # noqa: F401  (the card helpers and the splatbench modules they import)
rng = np.random.default_rng(0)
n = 64
arrays = {
    "means": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
    "log_scales": rng.uniform(-4, -1.5, (n, 3)).astype(np.float32),
    "quats": rng.normal(size=(n, 4)).astype(np.float32),
    "opacity_logits": rng.uniform(-1, 4, n).astype(np.float32),
    "sh": (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32),
}
model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
cam = tgs.CameraParams(32, 24, 1.0, 0.8, 25.6, 25.6, (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 4.0))
with torch.no_grad():
    img, trans = tgs.render(model, cam, tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=4096))
    s_img, s_trans = tgs.render(model, cam, tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=4096,
                                                             slice_pairs=64))
assert img.shape == (24, 32, 3) and bool(torch.isfinite(img).all())
assert torch.equal(s_img, img) and torch.equal(s_trans, trans)
assert "gsplat_tpu_torch.render.sliced" in sys.modules
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "gsplat_tpu.")) or m == "gsplat_tpu")
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    """The port renders, single-sort and depth-sliced, and ``tools/card.py``
    (with the ``splatbench`` modules it imports) loads, without importing
    JAX or gsplat_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
