"""The port's depth-sliced path held against the JAX package's.

The JAX side runs its sliced path on the Pallas kernels in interpret mode
(``use_pallas=True, force_pallas_interpret=True``, as
``tests/test_sliced.py`` does), at that file's sizes: tile 16, chunk 8,
pair block 8, 64x48 and 50x35 frames, 150-600 gaussians. Inputs are made
with numpy from a seed.

* The carry kernels' plain versions against ``forward_tiles_carry`` /
  ``backward_tiles_carry`` in interpret mode from a random carry: colour and
  T at rtol 1e-5 / atol 1e-6 with ``blocks_done`` equal; rows at 5e-3 of
  their scale, the Pallas moment re-expansion's tolerance
  (``tests/test_pallas_kernels.py:79-81``).
* The slice records (``k``, ``ids``, ``starts``, ``countc``, ``bdone``,
  ``gb``) integer-equal to JAX's ``_forward_impl`` on the same preprocess,
  and the sliced image and T at rtol 1e-5 / atol 1e-6.
* Gradients through ``torch.autograd``: against the unsliced port at 5e-5
  of each parameter's scale (``tests/test_sliced.py``'s own tolerance) and
  against ``jax.grad`` through the JAX sliced render at 5e-3; the compacted
  reductions against the per-slice or full ones at 5e-5, an overflowing
  compact capacity bitwise equal to the per-slice reduction.
* With early stop off, the sliced forward equals the unsliced port bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import GaussianModel as JModel
from gsplat_tpu import RasterConfig as JRasterConfig
from gsplat_tpu.kernels.raster_bwd import backward_tiles_carry as j_backward_tiles_carry
from gsplat_tpu.kernels.raster_bwd import backward_tiles_pallas, pack_tile_rows, reduction_basis
from gsplat_tpu.kernels.raster_fwd import build_pair_feat, forward_tiles_carry as j_forward_tiles_carry
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops.camera import CameraArrays as JCameraArrays
from gsplat_tpu.render import sliced as jsliced
from gsplat_tpu.render.pipeline import preprocess_traced as j_preprocess_traced
from gsplat_tpu.render.pipeline import render_traced as j_render_traced

import gsplat_tpu_torch as tgs
from gsplat_tpu_torch.kernels import raster as traster
from gsplat_tpu_torch.kernels.raster import rasterize_tiles
from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles_carry, backward_tiles_plain, reduce_pair_grads
from gsplat_tpu_torch.kernels.raster_bwd import pair_counts, reduce_sorted, walk_state
from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles_carry, forward_tiles_plain
from gsplat_tpu_torch.ops.projection import Preprocessed
from gsplat_tpu_torch.render import sliced
from gsplat_tpu_torch.render.pipeline import render_traced

from fixtures import make_camera, orbit_camera, random_splat_arrays
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 13)
JBASE = JRasterConfig(**SMALL, use_pallas=True, force_pallas_interpret=True)
BASE = tgs.RasterConfig(**SMALL)
NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")


def t(x):
    return torch.from_numpy(np.array(x))


def scale_err(got, want):
    """Largest absolute difference over the largest magnitude of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-8))


def arrays_for(n, seed, opaque=False, dead=0.0):
    """``tests/test_sliced.py``'s scenes: random splats, optionally opaque,
    optionally with a share of them pushed behind the camera (long runs of
    culled gaussians on the depth-sorted axis)."""
    rng = np.random.default_rng(seed)
    arrays = random_splat_arrays(rng, n)
    if opaque:
        arrays["opacity_logits"] = np.full(n, 4.0, np.float32)
    if dead:
        arrays["means"][rng.uniform(size=n) < dead, 2] = -5.0
    return arrays


def port_camera(jcam):
    return tgs.CameraParams(**dataclasses.asdict(jcam))


# name: (gaussians, seed, opaque, dead share, width, height, early stop, slice_pairs, max_pairs)
SCENES = {
    "exact": (300, 7, False, 0.0, 64, 48, 0.0, 1 << 10, 1 << 13),
    "early_stop": (400, 7, True, 0.0, 64, 48, 1e-4, 512, 1 << 13),
    "early_stop_tiny_slices_odd": (600, 5, True, 0.0, 50, 35, 1e-4, 128, 1 << 13),
    "tiny_slices_odd": (200, 3, False, 0.0, 50, 35, 0.0, 128, 1 << 13),
    "sparse_alive": (600, 11, False, 0.9, 64, 48, 0.0, 64, 1 << 13),
    "overflow": (300, 7, False, 0.0, 64, 48, 0.0, 128, 256),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """JAX's slice loop (``_forward_impl``, Pallas in interpret mode) and the
    port's, on the same preprocess and features."""
    n, seed, opaque, dead, w, h, es, s_pairs, max_pairs = SCENES[request.param]
    jcfg = dataclasses.replace(JBASE, early_stop_transmittance=es, slice_pairs=s_pairs, max_pairs=max_pairs)
    cfg = dataclasses.replace(BASE, early_stop_transmittance=es, slice_pairs=s_pairs, max_pairs=max_pairs)
    jmodel = JModel.from_arrays(arrays_for(n, seed, opaque, dead))
    jcam = JCameraArrays.from_params(make_camera(width=w, height=h))
    jprep = j_preprocess_traced(jmodel, jcam, w, h, jcfg)
    jfeat = jbin.pack_features(jprep).astype(jnp.float32)
    ntxg, ntyg = -(-w // 16), -(-h // 16)
    order, w0s, w1s = jsliced._prepare_sliced(jprep, 16, ntxg, ntyg)
    j_color, j_trans, j_out = jax.jit(jsliced._forward_impl, static_argnums=(4, 5, 6))(
        jfeat, order, w0s, w1s, w, h, jcfg)
    prep = Preprocessed(*(t(x) for x in jprep))
    d = sliced._prepare_sliced(prep, 16, ntxg, ntyg)
    color, trans, rec = sliced._forward_impl(t(jfeat), d, w, h, cfg)
    return dict(name=request.param, cfg=cfg, n=n, j=(j_color, j_trans, j_out), port=(color, trans, rec))


def test_slice_records_match_jax(scene):
    j_color, j_trans, out = scene["j"]
    color, trans, rec = scene["port"]
    k = int(out["k"])
    assert len(rec.ids) == k >= 1
    for name, got in (("ids", rec.ids), ("starts", rec.starts), ("countc", rec.countc), ("bdone", rec.bdone)):
        np.testing.assert_array_equal(torch.stack(got).numpy(), np.asarray(out[name])[:k], err_msg=name)
    np.testing.assert_array_equal(torch.stack(rec.gb).numpy(), np.asarray(out["gb"])[: k + 1])
    assert rec.host_syncs == min(k, int(np.ceil(scene["cfg"].max_pairs / scene["cfg"].slice_pairs)) - 1)
    if scene["name"].startswith("early_stop") or scene["name"] == "overflow":
        assert k > 1, "the scene should run several slices"
    if scene["name"] == "overflow":
        assert k == 2 and int(rec.gb[-1]) < scene["n"], "the budget should drop the deepest gaussians"
    np.testing.assert_allclose(color.numpy(), np.asarray(j_color), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(trans.numpy(), np.asarray(j_trans), rtol=RTOL, atol=ATOL)


def _binned(seed, n, grow=0.0, width=48, height=32):
    """``tests/test_pallas_kernels.py``'s binned setup, both frameworks."""
    cfg = dataclasses.replace(JBASE, max_pairs=4096)
    arrays = random_splat_arrays(np.random.default_rng(seed), n)
    arrays["log_scales"] += grow
    arrays["opacity_logits"] += grow
    jcam = JCameraArrays.from_params(orbit_camera(0.15, width=width, height=height))
    prep = j_preprocess_traced(JModel.from_arrays(arrays), jcam, width, height, cfg)
    bins = jbin.bin_gaussians(prep, width, height, 16, cfg.max_pairs, align=8)
    ntx = -(-width // 16)
    jax_args = (jbin.pack_features(prep), bins.pair_gaussian, bins.tile_start, bins.tile_count,
                jnp.arange(ntx * -(-height // 16), dtype=jnp.int32))
    return jax_args, tuple(t(a) for a in jax_args), ntx


@pytest.fixture(scope="module")
def carried():
    """A dense scene (early stop ends some tiles) and a random carry: colour
    so far, running T, and a walk state (S, T)."""
    jax_args, args, ntx = _binned(6, 800, grow=2.0)
    num_t, npix = args[4].shape[0], 256
    rng = np.random.default_rng(3)
    carry_color = rng.uniform(0.0, 0.5, (num_t, npix, 3)).astype(np.float32)
    carry_trans = rng.uniform(0.05, 1.0, (num_t, npix)).astype(np.float32)
    walk = np.stack([rng.normal(size=(num_t, npix)), rng.uniform(0.05, 1.0, (num_t, npix))], 1).astype(np.float32)
    g_color = rng.normal(size=(num_t, npix, 3)).astype(np.float32)
    return jax_args, args, ntx, carry_color, carry_trans, walk, g_color


@pytest.mark.parametrize("es", [0.0, 1e-4])
def test_carry_plain_matches_pallas(carried, es):
    jax_args, args, ntx, carry_color, carry_trans, walk, g_color = carried
    jcfg = dataclasses.replace(JBASE, max_pairs=4096, early_stop_transmittance=es)
    cfg = dataclasses.replace(BASE, max_pairs=4096, early_stop_transmittance=es)
    feat, pair_gaussian, tile_start, tile_count, tile_ids = jax_args
    num_t, npix = carry_trans.shape
    pair_feat = build_pair_feat(feat, pair_gaussian, 8)
    init = np.zeros((num_t, 8, npix), np.float32)
    init[:, 0:3] = np.moveaxis(carry_color, 2, 1)
    init[:, 3] = carry_trans
    out = np.asarray(j_forward_tiles_carry(pair_feat, tile_start, tile_count, tile_ids, jnp.asarray(init), ntx, jcfg,
                                           interpret=True, width=48, height=32))
    color, trans, done = forward_tiles_carry(*args, t(carry_color), t(carry_trans), ntx, cfg, 48, 32)
    np.testing.assert_allclose(color.numpy(), np.moveaxis(out[:, 0:3], 1, 2), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(trans.numpy(), out[:, 3], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(done.numpy(), out[:, 4, 0].astype(np.int32))
    nblocks = -(-args[3] // 8)
    assert (done < nblocks).any() == (es > 0), "early stop should end some tiles early"

    # The backward walk from a random state, up to the forward's blocks.
    g_out = pack_tile_rows(jnp.asarray(g_color), jnp.zeros((num_t, npix), jnp.float32))
    basis = reduction_basis(jnp.asarray(g_color), 16)
    j_rows, j_carry = j_backward_tiles_carry(pair_feat, tile_start, tile_count, tile_ids, jnp.asarray(done.numpy()),
                                             g_out, basis, jnp.asarray(walk), ntx, jcfg, interpret=True)
    rows, carry = backward_tiles_carry(*args, t(walk), t(g_color), ntx, cfg, done)
    j_rows = np.asarray(j_rows).transpose(0, 2, 1).reshape(-1, 16)[: rows.shape[0], :9]
    # Compare the rows the walk wrote (Pallas leaves the others unwritten).
    written = np.zeros(rows.shape[0], bool)
    for s, c, b in zip(args[2].tolist(), args[3].tolist(), done.tolist()):
        written[s: s + min(c, b * 8)] = True
    assert not rows[~torch.from_numpy(written)].any()
    for col in range(9):
        assert scale_err(rows[written, col], j_rows[written, col]) < 5e-3, col
    np.testing.assert_allclose(carry[:, 1].numpy(), np.asarray(j_carry)[:, 1], rtol=RTOL, atol=ATOL)
    assert scale_err(carry[:, 0], np.asarray(j_carry)[:, 0]) < 1e-5
    # A tile with nothing to walk passes its state through.
    idle = (done == 0).numpy()
    np.testing.assert_array_equal(carry.numpy()[idle], walk[idle])


def test_carry_chain_equals_one_walk(carried):
    """Walking one frame in two calls through the carry forms gives the
    single forward's and backward's results bitwise: the second call
    resumes from the exact state the first left."""
    _, args, ntx, *_ = carried
    feat, pair_gaussian, tile_start, tile_count, tile_ids = args
    first = torch.minimum(tile_count, torch.full_like(tile_count, 16))  # two blocks of each tile
    second = tile_count - first
    num_t, npix = tile_ids.shape[0], 256
    c1 = forward_tiles_carry(feat, pair_gaussian, tile_start, first, tile_ids,
                             torch.zeros(num_t, npix, 3), torch.ones(num_t, npix), ntx, BASE)
    c2 = forward_tiles_carry(feat, pair_gaussian, tile_start + first, second, tile_ids, c1[0], c1[1], ntx, BASE)
    whole = forward_tiles_plain(*args, ntx, BASE)
    assert torch.equal(c2[0], whole[0]) and torch.equal(c2[1], whole[1])
    torch.testing.assert_close(c1[2] + c2[2], -(-first // 8) + -(-second // 8), rtol=0, atol=0)
    rng = np.random.default_rng(4)
    g_color, g_trans = t(rng.normal(size=(num_t, npix, 3)).astype(np.float32)), t(rng.normal(size=(num_t, npix)).astype(np.float32))
    state = walk_state(whole[0], whole[1], g_color, g_trans)
    r1, s1 = backward_tiles_carry(feat, pair_gaussian, tile_start, first, tile_ids, state, g_color, ntx, BASE)
    r2, s2 = backward_tiles_carry(feat, pair_gaussian, tile_start + first, second, tile_ids, s1, g_color, ntx, BASE)
    rows = backward_tiles_plain(*args, whole[0], whole[1], g_color, g_trans, ntx, BASE)
    assert torch.equal(r1 + r2, rows)


def _loss_fns(width, height, seed):
    rng = np.random.default_rng(seed)
    w_img = rng.normal(size=(height, width, 3)).astype(np.float32)
    w_tr = rng.normal(size=(height, width)).astype(np.float32)
    return (lambda img, tr: jnp.sum(img * w_img) + jnp.sum(tr * w_tr),
            lambda img, tr: torch.sum(img * t(w_img)) + torch.sum(tr * t(w_tr)))


def _port_grads(model, cam, w, h, cfg, loss, offset=None):
    img, tr = render_traced(model, cam, w, h, cfg, offset)
    wrt = [getattr(model, k) for k in NAMES] if offset is None else [offset]
    return [g.numpy() for g in torch.autograd.grad(loss(img, tr), wrt)]


@pytest.mark.parametrize("scene_name", ["exact", "early_stop"])
def test_sliced_grads_match_unsliced_and_jax(scene_name):
    n, seed, opaque, dead, w, h, es, s_pairs, _ = SCENES[scene_name]
    arrays = arrays_for(n, seed, opaque, dead)
    jcfg = dataclasses.replace(JBASE, early_stop_transmittance=es, slice_pairs=s_pairs)
    cfg = dataclasses.replace(BASE, early_stop_transmittance=es)
    j_loss, loss = _loss_fns(w, h, 21)
    jcam = JCameraArrays.from_params(make_camera(width=w, height=h))
    j_grads = jax.grad(lambda m: j_loss(*j_render_traced(m, jcam, w, h, jcfg)))(JModel.from_arrays(arrays))
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    cam = tgs.CameraArrays.from_params(port_camera(make_camera(width=w, height=h)), device="cpu")
    unsliced = _port_grads(model, cam, w, h, cfg, loss)
    before = forward_tiles_carry.launches, backward_tiles_carry.launches
    got = _port_grads(model, cam, w, h, dataclasses.replace(cfg, slice_pairs=s_pairs), loss)
    assert (forward_tiles_carry.launches, backward_tiles_carry.launches) == before  # plain versions on the CPU
    for name, g, u in zip(NAMES, got, unsliced):
        assert scale_err(g, u) < 5e-5, name
        assert scale_err(g, getattr(j_grads, name)) < 5e-3, name


def test_sliced_viewspace_probe_gradient():
    """The zero screen-offset probe differentiates through the sliced path:
    against the unsliced port and against JAX's sliced path."""
    arrays = arrays_for(150, 11)
    j_loss, loss = _loss_fns(64, 48, 22)
    jcfg = dataclasses.replace(JBASE, slice_pairs=1 << 10)
    jcam = JCameraArrays.from_params(make_camera())
    jmodel = JModel.from_arrays(arrays)
    want = jax.grad(lambda o: j_loss(*j_render_traced(jmodel, jcam, 64, 48, jcfg, o)))(jnp.zeros((150, 2), jnp.float32))
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    cam = tgs.CameraArrays.from_params(port_camera(make_camera()), device="cpu")
    grads = [_port_grads(model, cam, 64, 48, dataclasses.replace(BASE, slice_pairs=s), loss,
                         torch.zeros(150, 2, requires_grad=True))[0] for s in (0, 1 << 10)]
    assert np.abs(grads[1]).max() > 0
    assert scale_err(grads[1], grads[0]) < 5e-5
    assert scale_err(grads[1], want) < 5e-3


def test_sliced_compact_reduction(monkeypatch):
    """``reduce_pairs`` with slicing: the cross-slice compact buffer against
    the per-slice reduction, and an overflowing capacity bitwise equal to
    the per-slice reduction."""
    gathered = []
    real = sliced.written_slots
    monkeypatch.setattr(sliced, "written_slots", lambda *a: gathered.append(a[2]) or real(*a))
    arrays = arrays_for(300, 7)
    _, loss = _loss_fns(64, 48, 23)
    model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
    cam = tgs.CameraArrays.from_params(port_camera(make_camera()), device="cpu")
    cfg = dataclasses.replace(BASE, early_stop_transmittance=1e-4, slice_pairs=1 << 10)
    per_slice = _port_grads(model, cam, 64, 48, cfg, loss)
    compact = _port_grads(model, cam, 64, 48, dataclasses.replace(cfg, reduce_pairs=1 << 12), loss)
    overflow = _port_grads(model, cam, 64, 48, dataclasses.replace(cfg, reduce_pairs=64), loss)
    assert gathered and 64 // 8 < sum(gathered) <= (1 << 12) // 8, "only the 4096-pair capacity should compact"
    for name, a, c, o in zip(NAMES, per_slice, compact, overflow):
        assert scale_err(c, a) < 5e-5, name
        np.testing.assert_array_equal(o, a, err_msg=name)


def test_unsliced_compacted_reduction(monkeypatch):
    """``reduce_pairs`` without slicing: the walked blocks alone against the
    full reduction (and JAX's compacted reduction) when they fit the
    capacity, and the full reduction when they overflow it by one block."""
    from gsplat_tpu.kernels.raster_fwd import forward_tiles_pallas

    jax_args, args, ntx = _binned(6, 800, grow=2.0)
    counts = torch.bincount(args[1].long(), minlength=args[0].shape[0])[:-1].to(torch.int32)
    cfg = dataclasses.replace(BASE, max_pairs=4096, early_stop_transmittance=1e-4)
    color, trans, done = forward_tiles_plain(*args, ntx, cfg, 48, 32)
    total = int(done.sum())
    assert total < args[1].shape[0] // 8, "early stop should leave blocks unwalked"
    rng = np.random.default_rng(5)
    g = [t(rng.normal(size=x.shape).astype(np.float32)) for x in (color, trans)]
    calls = []
    real = traster.reduce_compacted
    monkeypatch.setattr(traster, "reduce_compacted", lambda *a: calls.append(a[4]) or real(*a))
    d_feats = {}
    for reduce_pairs in (0, total * 8, (total - 1) * 8):
        feat = args[0].clone().requires_grad_(True)
        out = rasterize_tiles(feat, *args[1:], counts, ntx, dataclasses.replace(cfg, reduce_pairs=reduce_pairs), 48, 32)
        (d_feats[reduce_pairs],) = torch.autograd.grad(out, feat, g)
    assert calls == [total], "only the capacity the walked blocks fit should compact"
    assert scale_err(d_feats[total * 8], d_feats[0]) < 5e-5
    assert torch.equal(d_feats[(total - 1) * 8], d_feats[0])
    jcfg = dataclasses.replace(JBASE, max_pairs=4096, early_stop_transmittance=1e-4, reduce_pairs=total * 8)
    j_color, j_trans, j_done = forward_tiles_pallas(*jax_args, ntx, jcfg, interpret=True, width=48, height=32)
    want = backward_tiles_pallas(*jax_args, j_color, j_trans, jnp.asarray(g[0].numpy()), jnp.asarray(g[1].numpy()),
                                 ntx, jcfg, blocks_done=j_done, gaussian_counts=jnp.asarray(counts.numpy()),
                                 interpret=True)
    assert scale_err(d_feats[total * 8][:-1, :9], np.asarray(want)[:-1, :9]) < 5e-3


def _reduce_case(name):
    """(num_rows, ids [P] or [K, P] int32, rows [..., P, 9]) of one
    ``reduce_sorted`` case; the sentinel id is ``num_rows - 1``."""
    rng = np.random.default_rng(8)
    if name == "mixed":  # 40 gaussians + the sentinel 40, zero rows at the sentinel
        ids = rng.integers(0, 41, 500)
        rows = rng.normal(size=(500, 9))
        rows[ids == 40] = 0.0
        return 41, t(ids.astype(np.int32)), t(rows.astype(np.float32))
    n, ids = {
        "pool_above_pairs": (100_000, rng.choice(rng.choice(100_001, 120), 300)),  # ties, and the sentinel maybe
        "all_sentinel": (40, np.full(64, 40)),
        "no_pairs": (40, np.zeros(0, np.int64)),
        "one_gaussian": (1, rng.integers(0, 2, 200)),
        "many_scan_blocks": (100, rng.integers(0, 101, 5 * 1024 + 37)),  # long ties across blocks
        "descending": (60, np.insert(np.repeat(np.arange(60)[::-1], 3), np.arange(0, 180, 5), 60)),
        # K sets on disjoint ids, reduced in one pass: the sentinel mixed in, alone, and absent.
        "disjoint_sets": (150, np.stack([rng.integers(0, 50, 700), rng.choice([*range(50, 100), 150], 700),
                                         np.full(700, 150), rng.integers(100, 150, 700)])),
    }[name]
    rows = rng.normal(size=(*ids.shape, 9))  # sentinel rows too: they must not count
    return n + 1, t(ids.astype(np.int32)), t(rows.astype(np.float32))


@pytest.mark.parametrize("case", ["mixed", "pool_above_pairs", "all_sentinel", "no_pairs", "one_gaussian",
                                  "many_scan_blocks", "descending", "disjoint_sets"])
def test_reduce_sorted_matches_reduce_pair_grads(case):
    """Without ``gaussian_counts`` the per-id segments are found from the
    sorted ids alone: bitwise the counts-driven reduction with each id's
    pair count (of each set, summed, where K sets are reduced at once), and
    into a given ``out`` only the ids' rows."""
    num_rows, ids, rows = _reduce_case(case)
    got = reduce_sorted(rows, ids, num_rows)
    if ids.shape[-1]:
        want = torch.zeros_like(got)
        for r, i in zip(rows.reshape(-1, ids.shape[-1], 9), ids.reshape(-1, ids.shape[-1])):
            want = want + reduce_pair_grads(r, i, pair_counts(i, num_rows), num_rows)
        assert torch.equal(got, want)
        exact = reduce_pair_grads(rows.reshape(-1, 9), ids.reshape(-1), None, num_rows)
        # The cumsum reorders f32 additions: each sum is a difference of two
        # running sums, each off by a few roundings at its magnitude.
        atol = 1e-5
        if case != "mixed":
            by_id = [r.double()[torch.sort(i, stable=True).indices] for r, i in zip(rows.reshape(-1, ids.shape[-1], 9),
                                                                                   ids.reshape(-1, ids.shape[-1]))]
            atol += 8 * 2.0 ** -24 * max(float(x.cumsum(0).abs().max()) for x in by_id)
        torch.testing.assert_close(got, exact, rtol=1e-5, atol=atol)
    else:  # nothing to sum (the counts-driven form indexes its empty cumsum)
        assert not got.any()
    assert got.shape == (num_rows, 16) and not got[-1].any() and not got[:, 9:].any()
    # Into a given ``out`` (its sentinel row zero): the ids' sums written,
    # the rest left.
    out = torch.full((num_rows, 16), 7.0)
    out[-1] = 0.0
    want = out.clone()
    want[ids.long(), :9] = got[ids.long(), :9]
    assert reduce_sorted(rows, ids, num_rows, out=out) is out and torch.equal(out, want)


@pytest.mark.parametrize("reduce_pairs,compacted", [(8, 0), (1 << 12, 1)])
def test_sliced_backward_reduces_into_one_d_feat(monkeypatch, reduce_pairs, compacted):
    """The sliced backward's ``d_feat``, per slice (a ``reduce_pairs`` the
    walked blocks overflow: the slices reduced as sets in one pass) and
    compacted: bitwise the earlier formula, each slice's (or the compacted
    buffer's) counts-driven result (``pair_counts`` over the pool) summed
    into a zeroed ``d_feat``; ``reduced_pairs`` counts the rows the
    reduction reads, and ``reduction`` the path taken."""
    from gsplat_tpu_torch.utils import stages

    calls, d_feats = [], []
    real_reduce, real_backward = sliced.reduce_sorted, sliced._backward_impl
    monkeypatch.setattr(sliced, "reduce_sorted", lambda rows, ids, n, out: calls.append(
        (rows.clone(), ids.clone())) or real_reduce(rows, ids, n, out=out))
    monkeypatch.setattr(sliced, "_backward_impl", lambda *a: d_feats.append(real_backward(*a)) or d_feats[-1])
    _, loss = _loss_fns(50, 35, 24)
    model = tgs.GaussianModel.from_arrays(arrays_for(600, 5, opaque=True), device="cpu")
    cam = tgs.CameraArrays.from_params(port_camera(make_camera(width=50, height=35)), device="cpu")
    cfg = dataclasses.replace(BASE, early_stop_transmittance=1e-4, slice_pairs=128, reduce_pairs=reduce_pairs)
    with stages.record_stages() as rec:
        _port_grads(model, cam, 50, 35, cfg, loss)
    counts = {}
    for name, _, value in rec.counter_values():
        counts.setdefault(name, []).append(value)
    (d_feat,) = d_feats
    n_rows = d_feat.shape[0]
    ((rows, ids),) = calls  # one pass: the compacted pairs, or each slice's as a set
    sets = list(zip(rows, ids)) if ids.dim() == 2 else [(rows, ids)]
    assert counts["reduction"] == [compacted]
    assert len(sets) == (1 if compacted else counts["slices"][0]) and counts["slices"][0] >= 3
    assert counts["reduced_pairs"] == [sum(i.shape[0] for _, i in sets)]
    want = torch.zeros_like(d_feat)
    for r, i in sets:
        want = want + reduce_pair_grads(r, i, pair_counts(i, n_rows), n_rows)
    assert d_feat.abs().max() > 0 and torch.equal(d_feat, want)


@pytest.mark.parametrize("size", [(64, 48), (50, 35)])
def test_sliced_forward_equals_unsliced_bitwise(size):
    """Early stop off: the same pairs in the same order and an exact carry,
    so the sliced image and T are the single-sort port's bitwise."""
    w, h = size
    model = tgs.GaussianModel.from_arrays(arrays_for(300, 7), device="cpu")
    cam = tgs.CameraArrays.from_params(port_camera(make_camera(width=w, height=h)), device="cpu")
    with torch.no_grad():
        want = render_traced(model, cam, w, h, BASE)
        for s_pairs in (128, 1 << 10):
            got = render_traced(model, cam, w, h, dataclasses.replace(BASE, slice_pairs=s_pairs))
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), s_pairs


def test_trainer_step_takes_sliced_path(monkeypatch):
    """``Trainer.train_step`` with ``slice_pairs > 0`` renders and walks back
    through the carry forms (the plain versions on the CPU): its loss equals
    the single-sort step's, and its parameters after the Adam update are
    within 1% of one step's learning rate of them (Adam normalises the
    update, so a gradient near zero that the reductions round differently
    can move its parameter by a visible share of the rate)."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key, mod in (("forward_tiles_carry", "fwd", sliced), ("backward_tiles_carry", "bwd", sliced)):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _k=key, **k: calls.__setitem__(_k, calls[_k] + 1) or _r(*a, **k))
    arrays = arrays_for(300, 7)
    target = t(np.full((48, 64, 3), 0.25, np.float32))
    cam = port_camera(make_camera())
    tc = tgs.TrainConfig()
    results = []
    for s_pairs in (0, 256):
        model = tgs.GaussianModel.from_arrays(arrays, device="cpu")
        trainer = tgs.Trainer(raster=dataclasses.replace(BASE, slice_pairs=s_pairs), train=tc, show_progress=False)
        metrics = trainer.train_step(model, trainer.init_state(model), cam, target)
        results.append((float(metrics["loss"]), [getattr(model, k).detach().numpy() for k in NAMES]))
    assert calls["fwd"] == calls["bwd"] > 1, calls
    assert results[1][0] == results[0][0]  # the same image: early stop is off
    lrs = (tc.lr_means, tc.lr_scales, tc.lr_quats, tc.lr_opacity, tc.lr_sh)
    for name, lr, got, want in zip(NAMES, lrs, results[1][1], results[0][1]):
        np.testing.assert_allclose(got, want, rtol=0, atol=0.01 * lr, err_msg=name)
