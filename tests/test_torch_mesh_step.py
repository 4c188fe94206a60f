"""The mesh's train step without its update (``make_parallel_train_step``'s
``train_step(model, None, ...)``), held to the one-device step of
``splatbench/steps/train.py``: ``render_traced``, ``rgb_loss`` and
``torch.autograd.grad`` to the five raw parameters.

The ranks are spawned over gloo by ``torch_mesh_worker.py`` (each world
under its own time limit), 64x48 at tile 16, the 200-splat fixture, random
targets, on a 1x4 and a 2x2 mesh (a camera a data row), at SSIM weight 0.2
and 0:

* the frames are bitwise the one-device frames, on every rank;
* the loss at rtol 1e-5 (the mesh tests' tolerance) and each gradient
  within rtol 1e-4 + atol 1e-5 of its largest magnitude (the backward's
  tolerance in the card tests: the ranks' partial rows are summed in
  another order, which exceeds the result where terms cancel), the same
  on every rank;
* the model is left as it was, no ``.grad`` is written, and a second call
  gives the same gradients (nothing accumulates);
* with an optimizer the step keeps its contract: (model, optimizer,
  metrics), the same loss, the summed gradients in ``.grad``, an update;
* the counters ``gather_bytes`` and ``reduce_bytes`` read the bytes of the
  shapes the step gathers and sums, and the spans ``frame_gather`` and
  ``gather_bwd`` are recorded.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.render.pipeline import render_traced

import torch_mesh_worker as worker
from fixtures import orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

W, H = worker.W, worker.H
ARRAYS = random_splat_arrays(np.random.default_rng(9), 200)
CAMERAS = [orbit_camera(a, width=W, height=H) for a in (0.0, 0.35)]
TARGETS = np.random.default_rng(10).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
SSIM = [0.2, 0.0]
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
ROW_COLUMNS = 22  # the gathered row: 16 packed features, depth, active, 4 bbox bounds


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request, tmp_path_factory):
    mesh = MESHES[request.param]
    fields = [dataclasses.asdict(c) for c in CAMERAS]
    return request.param, worker.spawn_world(worker.update_free_world, 4, tmp_path_factory.mktemp(request.param),
                                             ARRAYS, fields, TARGETS, [mesh], SSIM)


def _one_device(data: int, ssim_weight: float):
    """Frames, loss (the mean over the batch) and gradients of the
    one-device step over the first ``data`` cameras."""
    model = tgs.GaussianModel.from_arrays(ARRAYS, device="cpu")
    cfg = tgs.RasterConfig(**worker.SMALL)
    frames, loss = [], 0.0
    for cam, target in zip(CAMERAS[:data], TARGETS):
        image = render_traced(model, tgs.CameraArrays.from_params(worker.camera(dataclasses.asdict(cam)),
                                                                   device="cpu"), W, H, cfg)[0]
        frames.append(image.detach())
        loss = loss + tgs.rgb_loss(image, torch.from_numpy(target), ssim_weight)
    loss = loss / data
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return torch.stack(frames).numpy(), float(loss.detach()), [g.numpy() for g in grads]


def _close(got, want, what):
    scale = np.abs(want).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale, err_msg=what)


@pytest.mark.parametrize("ssim_weight", SSIM)
def test_update_free_step_matches_one_device(ranks, ssim_weight):
    mesh, results = ranks
    data = MESHES[mesh][0]
    frames, loss, grads = _one_device(data, ssim_weight)
    key = f"{mesh}_{ssim_weight}"
    for r in results:
        got = r[key]
        assert got["frames"].shape == (data, H, W, 3)
        np.testing.assert_array_equal(got["frames"], frames)
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        for name, g, w in zip(worker.NAMES, got["grads"], grads):
            _close(g, w, name)
        for g, g0 in zip(got["grads"], results[0][key]["grads"]):
            np.testing.assert_array_equal(g, g0)  # summed over the world: the same on every rank


@pytest.mark.parametrize("ssim_weight", SSIM)
def test_update_free_step_leaves_the_model(ranks, ssim_weight):
    """Nothing is updated or accumulated, and no ``.grad`` is written."""
    _, results = ranks
    for r in results:
        got = r[f"{ranks[0]}_{ssim_weight}"]
        assert got["unchanged"] and got["no_grad"] and got["again_equal"]


@pytest.mark.parametrize("ssim_weight", SSIM)
def test_step_with_an_optimizer_keeps_its_contract(ranks, ssim_weight):
    mesh, results = ranks
    got = results[0][f"{mesh}_{ssim_weight}"]
    with_opt = got["with_optimizer"]
    assert with_opt["is_model"] and with_opt["len"] == 3
    assert with_opt["loss"] == got["loss"]
    for name, g, w in zip(worker.NAMES, with_opt["p_grads"], got["grads"]):
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert not np.array_equal(with_opt["params"][name], ARRAYS[name]), name  # Adam moved every array


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def test_collective_counters_read_their_shapes(ranks):
    """Per view on each rank: the rows' gather ``[tp * ceil(N / tp), 22]``,
    the frame's ``[tp * T_l, 256, 3]`` (with SSIM also summed back by its
    backward), the rows' cotangent, the five gradients and the [loss, mse]
    pair; under dp > 1 the frames gathered over the column."""
    mesh, results = ranks
    data, tile = MESHES[mesh]
    n = len(ARRAYS["means"])
    sy = 2 if tile == 4 else 1  # parallel/shard.py's stride: near-square, the larger factor on x
    sx = tile // sy
    tiles_local = _ceil(_ceil(W, 16), sx) * _ceil(_ceil(H, 16), sy)
    rows = tile * _ceil(n, tile) * ROW_COLUMNS * 4
    frame = tile * tiles_local * 256 * 3 * 4
    grads = [a.size * 4 for a in (ARRAYS[k] for k in worker.NAMES)]
    assert sum(grads) == 59 * n * 4
    frames = [data * H * W * 3 * 4] if data > 1 else []
    for w in SSIM:
        want_gather = [("gather_bytes", rows), ("gather_bytes", frame)] + [("gather_bytes", b) for b in frames]
        summed = [frame, rows] if w > 0 else [rows]
        want_reduce = [("reduce_bytes", b) for b in summed + grads + [8]]
        for r in results:
            got = r[f"{mesh}_{w}"]
            assert [c for c in got["counters"] if c[0] == "gather_bytes"] == want_gather
            assert [c for c in got["counters"] if c[0] == "reduce_bytes"] == want_reduce
            assert got["spans"].count("frame_gather") == 1 and got["spans"].count("gather") == 1
            assert got["spans"].count("gather_bwd") == (2 if w > 0 else 1)
