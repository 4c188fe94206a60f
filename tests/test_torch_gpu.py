"""The port's CUDA kernel on the card, held against its plain version.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package (nor ``fixtures.py``), so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Kernel and plain version round every product and sum alike, so they are
compared at rtol=1e-5 / atol=1e-6 and ``blocks_done`` must be equal.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_plain
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.render.pipeline import preprocess

pytestmark = pytest.mark.gpu
RTOL, ATOL = 1e-5, 1e-6
WIDTH, HEIGHT = 48, 32
CFG = tgs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=8192)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene(device, n=800, grow=2.0, seed=6):
    """Random splats in front of a camera at +z (the ``fixtures.py``
    distribution, grown so that tiles saturate and early stop triggers)."""
    rng = np.random.default_rng(seed)
    arrays = {
        "means": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "log_scales": (rng.uniform(-4.0, -1.5, (n, 3)) + grow).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity_logits": (rng.uniform(-1.0, 4.0, n) + grow).astype(np.float32),
        "sh": (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32),
    }
    fx = 0.8 * WIDTH
    camera = tgs.CameraParams(
        WIDTH, HEIGHT, 2 * math.atan(WIDTH / (2 * fx)), 2 * math.atan(HEIGHT / (2 * fx)), fx, fx,
        (math.cos(0.075), 0.0, math.sin(0.075), 0.0), (0.0, 0.0, 4.0),
    )
    return tgs.GaussianModel.from_arrays(arrays, device=device), camera


@pytest.fixture(scope="module")
def binned(device):
    model, camera = scene(device)
    with torch.no_grad():
        prep = preprocess(model, camera, CFG)
        bins = binning.bin_gaussians(prep, WIDTH, HEIGHT, CFG.tile_size, CFG.max_pairs, align=CFG.pair_block)
        ntx = -(-WIDTH // CFG.tile_size)
        tile_ids = torch.arange(ntx * -(-HEIGHT // CFG.tile_size), dtype=torch.int32, device=device)
        return (binning.pack_features(prep), bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids), ntx


@pytest.mark.parametrize("threshold", [0.0, 1e-4, 0.3])
def test_kernel_matches_plain(binned, threshold):
    args, ntx = binned
    cfg = dataclasses.replace(CFG, early_stop_transmittance=threshold)
    before = forward_tiles.launches
    got = forward_tiles(*args, ntx, cfg, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    assert forward_tiles.launches == before + 1
    want = forward_tiles_plain(*args, ntx, cfg, WIDTH, HEIGHT)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    if threshold > 0:
        assert (got[2] < -(-args[3] // CFG.pair_block)).any(), "some tile should stop early"


def test_render_on_card_matches_oracle(device):
    model, camera = scene(device, n=300, grow=0.0, seed=7)
    with torch.inference_mode():
        before = forward_tiles.launches
        img, trans = tgs.render(model, camera, CFG)
        assert forward_tiles.launches == before + 1
        o_img, o_trans = tgs.render_reference_oracle(model, camera, CFG)
    assert img.device.type == "cuda"
    torch.testing.assert_close(img, o_img, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(trans, o_trans, rtol=RTOL, atol=ATOL)


def test_kernel_rejects_bad_inputs(binned):
    (feat, *rest), ntx = binned
    with pytest.raises(ValueError, match="pair_gaussian"):
        forward_tiles(feat, rest[0].long(), *rest[1:], ntx, CFG)
    with pytest.raises(ValueError, match="feat"):
        forward_tiles(feat[:, :8].contiguous(), *rest, ntx, CFG)
