"""Spawned ranks for the port's mesh tests: each world runs on gloo (or on
nccl, one card a rank), with a file store in the test's temporary directory
(no port to clash over between test workers), and every rank saves what it
computed for the parent to compare.

This module imports neither JAX nor the JAX package, so that the spawned
ranks do not either. The world functions take numpy arrays and plain
camera fields from the parent, and return dicts of numpy arrays and
numbers.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import card  # noqa: E402
import gsplat_tpu_torch as tgs  # noqa: E402
from gsplat_tpu_torch.parallel import (  # noqa: E402
    ParallelTrainer,
    initialize_distributed,
    make_batch_render,
    make_mesh,
    make_parallel_train_step,
    make_sharded_binning_stats,
    make_sharded_render,
)

# Each collective waits at most this long for its peers.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)

SMALL = dict(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 13)
W, H = 64, 48
NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")


def spawn_world(fn, world_size: int, tmp_dir, *args, timeout: float = 240.0, device: str = "cpu",
                backend: str = "gloo"):
    """Run ``fn(device, *args)`` on each rank of a new ``world_size``-rank
    world (``backend``: gloo, or nccl with one card a rank) and return the
    list of their results, by rank. A rank that raises fails the call (the
    others are stopped), and so does a world that runs past ``timeout``
    seconds."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, f"store-{fn.__name__}-{time.monotonic_ns()}")
    card.spawn_ranks([(_rank_main, (fn, world_size, store, tmp_dir, device, backend, args), world_size)], timeout,
                     f"{fn.__name__} on {world_size} ranks")
    return [torch.load(os.path.join(tmp_dir, f"{fn.__name__}-rank{r}.pt"), weights_only=False)
            for r in range(world_size)]


def _rank_main(rank, fn, world_size, store, tmp_dir, device, backend, args):
    torch.set_num_threads(1)  # the ranks share the host's cores
    if backend == "nccl":
        os.environ["LOCAL_RANK"] = str(rank)  # one card a rank
    dev = initialize_distributed(
        backend=backend, device=device, init_method=f"file://{store}", rank=rank, world_size=world_size,
        timeout=COLLECTIVE_TIMEOUT,
    )
    try:
        result = fn(dev, *args)
        torch.save(result, os.path.join(tmp_dir, f"{fn.__name__}-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def hot_arrays(seed=13, n=120):
    """Splats piled onto a few tiles, all of one shard (as in ``test_parallel.py``)."""
    rng = np.random.default_rng(seed)
    return {
        "means": np.concatenate([rng.uniform(-0.04, 0.04, (n, 2)), rng.uniform(-0.1, 0.1, (n, 1))],
                                axis=1).astype(np.float32),
        "log_scales": np.full((n, 3), -3.0, np.float32),
        "quats": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        "opacity_logits": np.full((n,), 2.0, np.float32),
        "sh": rng.normal(size=(n, 16, 3)).astype(np.float32) * 0.2,
    }


def camera(fields: dict) -> tgs.CameraParams:
    return tgs.CameraParams(**fields)


def model_of(arrays: dict, dev) -> tgs.GaussianModel:
    return tgs.GaussianModel.from_arrays(arrays, device=dev)


def arrays_of(model) -> dict:
    return {k: getattr(model, k).detach().cpu().numpy() for k in NAMES}


def digest(model) -> str:
    """A hash of every parameter's bytes (replicas must agree bitwise)."""
    h = hashlib.sha256()
    for k in NAMES:
        h.update(getattr(model, k).detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _stack(cams, dev):
    return tgs.CameraArrays.stack([tgs.CameraArrays.from_params(c, device=dev) for c in cams])


def render_world(dev, arrays, cam_fields, hot_arrays, meshes):
    """Sharded renders, batch renders and the per-shard binning stats on
    every mesh of ``meshes`` (``(data, tile)``, each the world's size);
    also the single-device render each is bitwise held to."""
    model = model_of(arrays, dev)
    cams = [camera(f) for f in cam_fields]
    cfg = tgs.RasterConfig(**SMALL)
    out = {}
    if dist.get_world_size() > 1:
        try:
            make_mesh(tgs.MeshConfig(1, 1))
        except ValueError as e:
            out["wrong_size"] = str(e)
    with torch.inference_mode():
        single = [tgs.render(model, c, cfg) for c in cams]
        for data, tile in meshes:
            mesh = make_mesh(tgs.MeshConfig(data, tile))
            key = f"{data}x{tile}"
            if data == 1:
                img, trans = make_sharded_render(mesh, W, H, cfg)(model, tgs.CameraArrays.from_params(cams[0], device=dev))
                out[f"sharded_{key}"] = img.numpy()
                out[f"sharded_bitwise_{key}"] = torch.equal(img, single[0][0]) and torch.equal(trans, single[0][1])
                hot = model_of(hot_arrays, dev)
                stats = make_sharded_binning_stats(mesh, W, H, cfg)(hot, tgs.CameraArrays.from_params(cams[0], device=dev))
                out[f"stats_{key}"] = {k: int(v) for k, v in stats.items()}
            imgs, trans = make_batch_render(mesh, W, H, cfg)(model, _stack(cams, dev))
            out[f"batch_{key}"] = imgs.numpy()
            out[f"batch_bitwise_{key}"] = all(
                torch.equal(imgs[i], s[0]) and torch.equal(trans[i], s[1]) for i, s in enumerate(single))
    return out


def failing_world(dev, bad_rank):
    """Rank ``bad_rank`` raises before the first collective; the others wait
    in it."""
    mesh = make_mesh(tgs.MeshConfig(1, dist.get_world_size()))
    if mesh.rank == bad_rank:
        raise RuntimeError("rank failed on purpose")
    dist.barrier()
    return {}


def step_world(dev, arrays, cam_fields, targets, meshes, ssim_weights, probe_mesh):
    """One train step on every (mesh, ssim weight), from ``arrays`` each
    time, and the per-view viewspace probe on ``probe_mesh``. Each camera
    batch is the first ``data`` cameras with their targets."""
    out = {}
    for data, tile in meshes:
        mesh = make_mesh(tgs.MeshConfig(data, tile))
        cams = _stack([camera(f) for f in cam_fields[:data]], dev)
        for w in ssim_weights:
            tc = tgs.TrainConfig(ssim_weight=w)
            step, init_state, prepare = make_parallel_train_step(mesh, W, H, tgs.RasterConfig(**SMALL), tc,
                                                                 with_viewspace_grad=(data, tile) == probe_mesh)
            model = model_of(arrays, dev)
            result = step(model, init_state(model), cams, prepare(torch.from_numpy(targets[:data]).to(dev)))
            key = f"{data}x{tile}_{w}"
            out[key] = {"loss": float(result[2]["loss"]), "psnr": float(result[2]["psnr"]),
                        "params": arrays_of(model), "digest": digest(model)}
            if len(result) == 5:
                out[key]["viewspace"] = result[3].cpu().numpy()
                out[key]["radii"] = result[4].cpu().numpy()
    return out


def fit_world(dev, arrays, cam_fields, targets, hot_arrays, tmp_dir):
    """``ParallelTrainer.fit`` on 2x2 (plain, with SH warmup, with a
    background, resumed, densifying) and a hot shard on 1x4."""
    views = [(camera(f), torch.from_numpy(t).to(dev)) for f, t in zip(cam_fields, targets)]
    cfg = tgs.RasterConfig(**SMALL)
    mesh = make_mesh(tgs.MeshConfig(2, 2))
    out = {}

    def fit(model, tc, **kw):
        trainer = ParallelTrainer(mesh=mesh, raster=cfg, train=tc, show_progress=False)
        records = []
        model, hist = trainer.fit(model, views, log_fn=records.append, **kw)
        return model, hist, records

    tc = tgs.TrainConfig(steps=3, log_every=1, ssim_weight=0.2)
    model, hist, records = fit(model_of(arrays, dev), tc)
    out["fit"] = {"history": hist, "records": records, "params": arrays_of(model), "digest": digest(model)}

    # SH warmup: the first steps train at degree 0, blind to bands 1-3.
    shifted = dict(arrays, sh=arrays["sh"].copy())
    shifted["sh"][:, 1:, :] += 0.5
    for warm in (2, 0):
        tcw = tgs.TrainConfig(steps=1, log_every=1, ssim_weight=0.0, sh_warmup_every=warm)
        out[f"warmup_{warm}"] = [fit(model_of(a, dev), tcw)[1][0]["loss"] for a in (arrays, shifted)]

    # A transparent scene against white targets: L1 1 on black, 0 on white.
    clear = dict(arrays, opacity_logits=np.full_like(arrays["opacity_logits"], -12.0))
    white = [(c, torch.ones_like(t)) for c, t in views]
    for bg in ("black", "white"):
        trainer = ParallelTrainer(mesh=mesh, raster=cfg, show_progress=False,
                                  train=tgs.TrainConfig(steps=1, log_every=1, ssim_weight=0.0, background=bg))
        out[f"background_{bg}"] = trainer.fit(model_of(clear, dev), white)[1][0]["loss"]

    # Resume: 2 steps then 2 more from the loop state, against 4 at once,
    # with the random background and densification (no split), bitwise.
    dense = tgs.DensifyConfig(every=2, start=1, grad_threshold=1e-7, pool_factor=1.5, percent_dense=10.0,
                              max_screen_size=0.0)
    tcr = tgs.TrainConfig(steps=4, log_every=1, ssim_weight=0.2, checkpoint_every=2, background="random",
                          densify=dense)
    whole = fit(model_of(arrays, dev), tcr)[0]
    ckpt = os.path.join(tmp_dir, "resume")
    fit(model_of(arrays, dev), dataclasses.replace(tcr, steps=2), checkpoint_dir=ckpt)
    resumed = fit(model_of(arrays, dev), tcr, checkpoint_dir=ckpt, resume=True)[0]
    out["resume"] = {"digest": digest(whole), "resumed_digest": digest(resumed), "alive": whole.num_gaussians,
                     "pool": int(1.5 * len(arrays["means"]))}

    # A densifying fit with splits: the replicas stay bitwise equal.
    split = dataclasses.replace(dense, percent_dense=0.0)
    out["split"] = {"digest": digest(fit(model_of(arrays, dev), dataclasses.replace(tcr, densify=split))[0])}

    # Hot shard on 1x4: capacity resized to the largest shard's demand.
    hot_mesh = make_mesh(tgs.MeshConfig(1, 4))
    hot = model_of(hot_arrays, dev)
    with torch.no_grad():
        demand = int(make_sharded_binning_stats(hot_mesh, W, H, cfg)(
            hot, tgs.CameraArrays.from_params(views[0][0], device=dev))["max_shard_demand"])
    tiny = dataclasses.replace(cfg, max_pairs=8)
    trainer = ParallelTrainer(mesh=hot_mesh, raster=tiny, show_progress=False,
                              train=tgs.TrainConfig(steps=2, log_every=10, ssim_weight=0.0))
    grew = trainer.check_capacity(hot, [tgs.CameraArrays.from_params(views[0][0], device=dev)], W, H)
    trainer.fit(hot, views[:1])
    out["hot"] = {"demand": demand, "grew": grew, "max_pairs": trainer.raster.max_pairs}
    return out


def cli_world(dev, args):
    """The port's command line on every rank of the world (``--mesh`` takes
    the world up as it finds it)."""
    import traceback

    from click.testing import CliRunner

    from gsplat_tpu_torch.cli import cli

    result = CliRunner().invoke(cli, args)
    if result.exit_code != 0:
        tb = "".join(traceback.format_exception(*result.exc_info)) if result.exc_info else ""
        raise RuntimeError(f"exit {result.exit_code}: {result.output}\n{tb}")
    return {"output": result.output}


def padded_frame_world(dev, arrays, cam_fields, cfg_fields):
    """A 1x4 sharded render of ``cam_fields``' frame and the single-device
    render, and the forward kernel's launches in this rank."""
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles

    model, cam, cfg = model_of(arrays, dev), camera(cam_fields), tgs.RasterConfig(**cfg_fields)
    mesh = make_mesh(tgs.MeshConfig(1, 4))
    with torch.inference_mode():
        single = tgs.render(model, cam, cfg)
        sharded = make_sharded_render(mesh, cam.width, cam.height, cfg)(
            model, tgs.CameraArrays.from_params(cam, device=dev))
    return {"bitwise": all(torch.equal(a, b) for a, b in zip(sharded, single)),
            "max_abs_diff": max(float((a - b).abs().max()) for a, b in zip(sharded, single)),
            "launches": forward_tiles.launches}


def repeated_step_world(dev, arrays, cam_fields, target, data, tile):
    """One train step (SSIM weight 0) on a ``data x tile`` mesh with one
    camera repeated over the batch, so that every mesh shape takes the same
    gradient."""
    mesh = make_mesh(tgs.MeshConfig(data, tile))
    step, init_state, prepare = make_parallel_train_step(mesh, W, H, tgs.RasterConfig(**SMALL),
                                                         tgs.TrainConfig(ssim_weight=0.0))
    model = model_of(arrays, dev)
    targets = torch.from_numpy(np.stack([target] * data)).to(dev)
    metrics = step(model, init_state(model), _stack([camera(cam_fields)] * data, dev), prepare(targets))[2]
    return {"loss": float(metrics["loss"]), "params": arrays_of(model), "digest": digest(model)}


def update_free_world(dev, arrays, cam_fields, targets, meshes, ssim_weights):
    """The step without its update (``optimizer=None``) on every (mesh, ssim
    weight), from ``arrays``, its camera batch the first ``data`` cameras:
    its gradients, frames and loss, the stage counters and spans it
    records, whether the model is left as it was, whether a second call
    gives the same gradients; then the step with an optimizer on the same
    inputs."""
    from gsplat_tpu_torch.utils import stages

    out = {}
    for data, tile in meshes:
        mesh = make_mesh(tgs.MeshConfig(data, tile))
        cams = _stack([camera(f) for f in cam_fields[:data]], dev)
        for w in ssim_weights:
            step, init_state, prepare = make_parallel_train_step(mesh, W, H, tgs.RasterConfig(**SMALL),
                                                                 tgs.TrainConfig(ssim_weight=w))
            model = model_of(arrays, dev)
            tiles = prepare(torch.from_numpy(targets[:data]).to(dev))
            with stages.record_stages(events=False) as rec:
                grads, frames, metrics = step(model, None, cams, tiles)
            again = step(model, None, cams, tiles)[0]
            unchanged = digest(model) == digest(model_of(arrays, dev))
            no_grad = all(p.grad is None for p in model.parameters())
            result = step(model, init_state(model), cams, tiles)
            out[f"{data}x{tile}_{w}"] = {
                "grads": [g.cpu().numpy() for g in grads], "frames": frames.cpu().numpy(),
                "loss": float(metrics["loss"]), "unchanged": unchanged, "no_grad": no_grad,
                "again_equal": all(torch.equal(a, b) for a, b in zip(grads, again)),
                "counters": [(n, v) for n, _, v in rec.counter_values() if n in ("gather_bytes", "reduce_bytes")],
                "spans": [sp.name for sp in rec.spans],
                "with_optimizer": {
                    "is_model": result[0] is model, "len": len(result), "loss": float(result[2]["loss"]),
                    "p_grads": [p.grad.cpu().numpy() for p in model.parameters()], "params": arrays_of(model),
                },
            }
    return out


def dense_step_world(dev):
    """The dense scene (``card``'s 5M gaussians at scale shift 1.9, the bench
    pose, early stop 1e-4) through the 1x4 mesh's step without its update,
    a shard's capacity 1.1x the largest shard demand; on rank 0 also the
    one-card unsliced step (capacity 1.1x the view's demand), against the
    constant 0.25 target at SSIM weight 0.2. Both reduce the pair rows
    exactly (``exact_grad_reduction``): the f32 reduction's error follows
    the magnitude of its running sums, which differ between a shard's pairs
    and the whole frame's. Rank 0 returns whether the frames are bitwise
    equal, both losses, and for each gradient the count of entries outside
    rtol 1e-4 + atol 1e-5 of their column's largest magnitude (and of
    entries whose finiteness differs), with the worst excess over that
    tolerance in units of it."""
    from gsplat_tpu_torch.parallel import replicated
    from gsplat_tpu_torch.render.pipeline import binning_stats, render_traced

    width, height = card.WIDTH, card.HEIGHT
    mesh = make_mesh(tgs.MeshConfig(1, 4))
    model = replicated(mesh, card.build_scene(card.REAL_N, card.REAL_SHIFT, dev))
    cam = tgs.CameraArrays.from_params(card.camera_params(width, height, 0.0, 0.0), device=dev)
    base = dict(tile_size=32, chunk_size=32, pair_block=128, sh_degree=3, early_stop_transmittance=1e-4)
    probe = tgs.RasterConfig(max_pairs=1 << 20, **base)
    with torch.no_grad():
        shard = int(make_sharded_binning_stats(mesh, width, height, probe)(model, cam)["max_shard_demand"])
    cfg = tgs.RasterConfig(max_pairs=int(shard * 1.1) // 128 * 128, exact_grad_reduction=True, **base)
    step, _, prepare = make_parallel_train_step(mesh, width, height, cfg, tgs.TrainConfig(ssim_weight=0.2))
    target = torch.full((1, height, width, 3), 0.25, device=dev)
    grads, frames, metrics = step(model, None, tgs.CameraArrays.stack([cam]), prepare(target))
    if mesh.rank != 0:
        return {}
    with torch.no_grad():
        demand = int(binning_stats(model, cam, width, height, probe)["pair_demand"])
    one = tgs.RasterConfig(max_pairs=int(demand * 1.1) // 128 * 128, exact_grad_reduction=True, **base)
    image = render_traced(model, cam, width, height, one)[0]
    loss = tgs.rgb_loss(image, target[0], 0.2)
    want = torch.autograd.grad(loss, list(model.parameters()))
    out = {"bitwise": torch.equal(frames[0], image.detach()), "loss": float(metrics["loss"]),
           "want_loss": float(loss.detach()), "shard_demand": shard, "demand": demand}
    for name, g, w in zip(NAMES, grads, want):
        g, w = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
        finite = torch.isfinite(w)
        scale = torch.where(finite, w.abs(), torch.zeros_like(w)).amax(0, keepdim=True)
        tol = 1e-4 * w.abs() + 1e-5 * scale
        excess = torch.where(finite, (g - w).abs() / tol, torch.zeros_like(w))
        out[name] = int((finite & ~(excess <= 1.0)).sum()) + int((torch.isfinite(g) != finite).sum())
        out[f"{name}_worst"] = float(excess.max())
    return out
