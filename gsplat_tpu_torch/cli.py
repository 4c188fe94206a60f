"""Command-line interface of the PyTorch port, the counterpart of
``gsplat_tpu/cli.py``.

``render`` preserves the reference CLI's six flags and behavior
(rasterize.py:308-314: --input_dir, --trained_model_path, --output_path,
--scene-index, --scale-factor, --generate_video), including the hardcoded
camera id 1 (rasterize.py:336), the ``images_{scale_factor}/`` ground-truth
lookup (rasterize.py:333) and the ``point_cloud/iteration_30000`` checkpoint
path (rasterize.py:351-353). Extras the reference lacks: ``finetune`` (the
backward-pass workload), ``train`` (from the SfM points), ``orbit``
(camera-pose video) and ``evaluate`` (PSNR/SSIM per view).

Differences from the JAX CLI:

* ``--device cuda|cpu`` (default ``cuda``) takes the place of ``--backend
  pallas|jnp``: the port dispatches by the device of its tensors, so the
  model and the targets live on that device. ``cuda`` without a card fails;
  nothing falls back to the CPU.
* ``--tile-size`` takes any positive edge, as the JAX CLI does (on the
  card a tile above 64 runs as pixel groups of one thread block each,
  ``kernels/cull.py``). ``--slice-pairs`` must be a ``pair_block`` multiple
  and at least the frame's tile count.
* ``--mesh DATAxTILE`` runs one process (rank) per mesh position: under
  ``torchrun --nproc-per-node DATA*TILE`` (a ``1x1`` mesh started without it
  forms a world of one by itself). ``--device cuda`` takes one card per
  rank over NCCL, so a mesh larger than the card count is a usage error;
  ``--device cpu`` runs the ranks over gloo. Rank 0 alone writes files and
  logs. ``--slice-pairs`` with ``--mesh`` is a usage error: the mesh path is
  unsliced, and the JAX CLI ignores the flag there.
* The loop checkpoint is ``<output_path>/train_state.pt``, a ``torch.save``
  file, where the JAX CLI writes an orbax ``train_state`` directory.

Run as ``python -m gsplat_tpu_torch.cli <command> ...`` or, installed, as
``gsplat-tpu-torch <command> ...``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os

import click
import numpy as np
import torch
import torch.distributed as dist

from gsplat_tpu_torch.config import RasterConfig, TrainConfig
from gsplat_tpu_torch.utils.logging import get_logger

logger = get_logger()


def _load_scene(input_dir: str, trained_model_path: str, scene_index: int, scale_factor: int, device):
    """Shared loading path; returns (model, camera, gt image ``[H, W, 3]``
    float numpy, gt image path)."""
    from PIL import Image

    from gsplat_tpu_torch.io.ply import load_splat_arrays
    from gsplat_tpu_torch.io.scene import checkpoint_ply_path, read_scene
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.ops.camera import CameraParams

    logger.info("Fetching scenes from: %s", input_dir)
    scenes, cam_info = read_scene(input_dir)
    scene = scenes[scene_index]

    gt_img_path = os.path.join(input_dir, f"images_{scale_factor}", scene.name)
    img = Image.open(gt_img_path).convert("RGB")
    width, height = img.size

    ply_path = checkpoint_ply_path(trained_model_path)
    logger.info("Fetching trained model from: %s", ply_path)
    model = GaussianModel.from_arrays(load_splat_arrays(ply_path), device=device)
    camera = CameraParams.from_colmap(scene, cam_info[1], width, height)
    gt = np.asarray(img).astype(np.float32) / 255.0
    return model, camera, gt, gt_img_path


def _scene_views(input_dir, scale_factor, device):
    """(image name, camera, GT image ``[H, W, 3]`` on ``device``) for every
    image of the scene that has a ground-truth file at the given scale, in
    image-id order."""
    from PIL import Image

    from gsplat_tpu_torch.io.scene import read_scene
    from gsplat_tpu_torch.ops.camera import CameraParams

    scenes, cam_info = read_scene(input_dir)
    views = []
    for _, scene in sorted(scenes.items()):
        path = os.path.join(input_dir, f"images_{scale_factor}", scene.name)
        if not os.path.exists(path):
            continue
        img = Image.open(path).convert("RGB")
        gt = torch.from_numpy(np.asarray(img, dtype=np.float32) / 255.0).to(device)
        # Per-view intrinsics via the image's own camera_id (the reference's
        # cam_info[1] hardcode is kept only in the parity `render` command).
        cam = CameraParams.from_colmap(scene, cam_info[scene.camera_id], img.size[0], img.size[1])
        views.append((scene.name, cam, gt))
    return views


def _load_views(input_dir, scale_factor, device):
    """Every (camera, GT image) pair of the scene at the given scale."""
    return [(cam, gt) for _, cam, gt in _scene_views(input_dir, scale_factor, device)]


def _raster_config(tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs=0) -> RasterConfig:
    """The settings of the raster options, checked before any scene I/O:
    a ``pair_block`` multiple for ``--slice-pairs`` and, on the card, a
    tiling the compositors take (a positive tile edge). The
    depth-sliced path reuses the slice size as its compact reduction
    capacity (``render/sliced.py`` falls back exactly on overflow)."""
    from gsplat_tpu_torch.kernels import cull

    try:
        cfg = RasterConfig(
            tile_size=tile_size,
            chunk_size=chunk_size,
            max_pairs=max_pairs,
            early_stop_transmittance=early_stop,
            slice_pairs=slice_pairs,
            reduce_pairs=slice_pairs if slice_pairs > 0 else 0,
        )
        if device == "cuda":
            cull.check_tiling("--tile-size", tile_size, cfg.pair_block, cull.staging_bytes(cfg.pair_block))
    except ValueError as e:
        raise click.UsageError(str(e))
    return cfg


def _check_slice_pairs(cfg: RasterConfig, cameras) -> None:
    """``--slice-pairs`` must cover the frame's tile count (the most pairs
    one gaussian can have), for every frame size of ``cameras``."""
    for camera in cameras:
        tiles = -(-camera.width // cfg.tile_size) * -(-camera.height // cfg.tile_size)
        if 0 < cfg.slice_pairs < tiles:
            raise click.UsageError(
                f"--slice-pairs {cfg.slice_pairs} is below the {camera.width}x{camera.height} "
                f"frame's tile count ({tiles})"
            )


def _resolve(device: str) -> torch.device:
    """``--device`` as a ``torch.device``; ``cuda`` without a card is an
    error, never a fallback to the CPU."""
    from gsplat_tpu_torch.utils.device import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise click.ClickException(f"{e} (--device cpu)")


_COMMON = [
    click.option("--input_dir", type=str, default=""),
    click.option("--trained_model_path", type=str, default=""),
    click.option("--scene-index", type=int, default=0),
    click.option("--scale-factor", type=int, default=2),
    click.option("--tile-size", type=int, default=32,
                 help="pixel tile edge (positive; on the card above 64 as pixel groups)"),
    click.option("--chunk-size", type=int, default=32, help="gaussians per inner step"),
    click.option("--max-pairs", type=int, default=1 << 22, help="tile/gaussian pair capacity"),
    click.option("--early-stop", type=float, default=0.0,
                 help="transmittance below which a tile stops compositing (0 = exact reference semantics)"),
    click.option("--device", type=click.Choice(["cuda", "cpu"]), default="cuda",
                 help="where the model, the targets and the kernels run (cuda: the CUDA "
                      "compositors; cpu: their plain PyTorch versions)"),
    click.option("--slice-pairs", type=int, default=0,
                 help="depth-sliced lazy binning: per-slice pair capacity, a multiple of "
                      "the pair block (128) and at least the frame's tile count "
                      "(0 = single-sort pipeline; render/sliced.py)"),
    click.option("--auto-pairs/--no-auto-pairs", default=True,
                 help="check the measured pair demand and grow max_pairs "
                      "(next power of two) instead of silently dropping the "
                      "deepest splats on overflow"),
]


def _check_pairs(model, cameras, cfg: RasterConfig, auto_pairs: bool) -> RasterConfig:
    """Warn on pair-buffer overflow for the *worst* of the given camera
    poses; optionally return a resized config. ``cameras`` is one
    CameraParams or a sequence (orbit frames / evaluation views: a pose
    rotating more splats into frustum can overflow even when the base view
    fits)."""
    from gsplat_tpu_torch.ops.camera import CameraArrays
    from gsplat_tpu_torch.render.pipeline import binning_stats

    if not isinstance(cameras, (list, tuple)):
        cameras = [cameras]
    demand = 0
    with torch.no_grad():
        for camera in cameras:
            cam = CameraArrays.from_params(camera, device=model.means.device)
            stats = binning_stats(model, cam, camera.width, camera.height, cfg)
            demand = max(demand, int(stats["pair_demand"]))
    return _fit_budget(cfg, demand, auto_pairs, "pair buffer overflow")


def _fit_budget(cfg: RasterConfig, demand: int, auto_pairs: bool, what: str) -> RasterConfig:
    """``cfg`` with ``max_pairs`` covering ``demand`` (with ``auto_pairs``),
    or unchanged with a warning that the deepest splats will be dropped."""
    from gsplat_tpu_torch.render.pipeline import required_max_pairs

    if demand > cfg.max_pairs:
        target = required_max_pairs(demand)
        if auto_pairs:
            logger.warning("%s (demand %d > capacity %d): using max_pairs=%d", what, demand, cfg.max_pairs, target)
            return dataclasses.replace(cfg, max_pairs=target)
        logger.warning(
            "%s (demand %d > capacity %d): deepest splats will be dropped — use --max-pairs %d or --auto-pairs",
            what, demand, cfg.max_pairs, target,
        )
    return cfg


def _check_pairs_sharded(model, cameras, cfg: RasterConfig, auto_pairs: bool, mesh) -> RasterConfig:
    """:func:`_check_pairs` on a mesh: ``max_pairs`` is the PER-SHARD
    capacity and the strided tile layout only decorrelates load, so the
    binding number is the largest shard's own demand
    (``make_sharded_binning_stats``); whole-frame demand would size every
    shard about tile-fold too large."""
    from gsplat_tpu_torch.ops.camera import CameraArrays
    from gsplat_tpu_torch.parallel import make_sharded_binning_stats

    if not isinstance(cameras, (list, tuple)):
        cameras = [cameras]
    stats_fn = make_sharded_binning_stats(mesh, cameras[0].width, cameras[0].height, cfg)
    demand = 0
    with torch.no_grad():
        for camera in cameras:
            cam = CameraArrays.from_params(camera, device=model.means.device)
            demand = max(demand, int(stats_fn(model, cam)["max_shard_demand"]))
    return _fit_budget(cfg, demand, auto_pairs, "per-shard pair overflow")


def _parse_mesh(mesh: str):
    """'DATAxTILE' -> (data, tile), validated (both >= 1)."""
    try:
        data, tile = (int(x) for x in mesh.lower().split("x"))
    except ValueError:
        raise click.BadParameter(f"--mesh must be DATAxTILE, got {mesh!r}")
    if data < 1 or tile < 1:
        raise click.BadParameter(
            f"--mesh dimensions must be >= 1, got {data}x{tile}"
        )
    return data, tile


def _mesh_dims(mesh: str, device: str, slice_pairs: int):
    """``--mesh`` checked before any scene I/O: ``(data, tile)``, or None
    without it."""
    if not mesh:
        return None
    data, tile = _parse_mesh(mesh)
    ranks = data * tile
    if slice_pairs > 0:
        raise click.UsageError("--slice-pairs cannot be combined with --mesh: the mesh path is unsliced")
    if device == "cuda" and ranks > torch.cuda.device_count():
        raise click.UsageError(
            f"--mesh {data}x{tile} needs {ranks} cards, one per rank; {torch.cuda.device_count()} visible"
        )
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))
    if world != ranks:
        raise click.UsageError(
            f"--mesh {data}x{tile} runs on {ranks} ranks, this world has {world}: "
            f"launch with torchrun --nproc-per-node {ranks}"
        )
    return data, tile


@contextlib.contextmanager
def _mesh_world(dims, device: str):
    """Yields (the mesh of ``--mesh`` or None, this rank's device). Joins the
    world ``torchrun`` started (or forms a world of one) unless one is
    already up, and leaves it on exit if it joined here. On ranks other than
    0 the package logs errors only (``utils/logging.py``)."""
    if dims is None:
        yield None, _resolve(device)
        return
    from gsplat_tpu_torch.config import MeshConfig
    from gsplat_tpu_torch.parallel import initialize_distributed, make_mesh

    started = not dist.is_initialized()
    dev = initialize_distributed(device=device) if started else _resolve(device)
    try:
        mesh = make_mesh(MeshConfig(data=dims[0], tile=dims[1]))
        get_logger()  # rank 0 alone logs below ERROR
        logger.info("running on a %dx%d (data x tile) mesh", *dims)
        yield mesh, dev
    finally:
        if started:
            dist.destroy_process_group()
        get_logger()


def _is_main(mesh) -> bool:
    """Whether this rank writes the command's files (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


def common_options(fn):
    for opt in reversed(_COMMON):
        fn = opt(fn)
    return fn


_MESH_RUN = (" One rank per mesh position, under torchrun (a 1x1 mesh starts alone); not with "
             "--slice-pairs. Empty = one device")


@click.group()
def cli():
    """Gaussian splatting in PyTorch, with hand-written CUDA compositors."""


@cli.command()
@common_options
@click.option("--output_path", type=str, default="")
@click.option("--generate_video", is_flag=True, type=bool, default=False)
@click.option("--show/--no-show", default=True, help="display the matplotlib comparison figure")
@click.option("--mesh", type=str, default="",
              help="render over a mesh, '1xTILE': the frame's tile grid split over the tile axis "
                   "(a single view, so the data axis must be 1)." + _MESH_RUN)
def render(
    input_dir, trained_model_path, scene_index, scale_factor,
    tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs,
    auto_pairs,
    output_path, generate_video, show, mesh,
):
    """Render one scene view next to its ground-truth photo."""
    if mesh and _parse_mesh(mesh)[0] != 1:  # fail before scene I/O
        raise click.BadParameter(
            f"render is a single view: --mesh must be 1xTILE (got {mesh}; use "
            "orbit/evaluate for data-parallel batches)"
        )
    dims = _mesh_dims(mesh, device, slice_pairs)
    cfg = _raster_config(tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs)

    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt

    from gsplat_tpu_torch.ops.camera import CameraArrays
    from gsplat_tpu_torch.parallel import make_sharded_render
    from gsplat_tpu_torch.render.pipeline import render as render_fn
    from gsplat_tpu_torch.utils import video as videolib

    with _mesh_world(dims, device) as (device_mesh, dev):
        model, camera, gt, gt_img_path = _load_scene(input_dir, trained_model_path, scene_index, scale_factor, dev)
        _check_slice_pairs(cfg, [camera])
        with torch.inference_mode():
            if device_mesh is None:
                cfg = _check_pairs(model, camera, cfg, auto_pairs)
                image = render_fn(model, camera, cfg)[0]
            else:
                cfg = _check_pairs_sharded(model, camera, cfg, auto_pairs, device_mesh)
                sharded = make_sharded_render(device_mesh, camera.width, camera.height, cfg)
                image = sharded(model, CameraArrays.from_params(camera, device=dev))[0]
            image = image.cpu().numpy()
        if not _is_main(device_mesh):
            return
    logger.info("rendered %dx%d from %d gaussians", camera.width, camera.height, model.num_gaussians)

    if output_path:
        os.makedirs(output_path, exist_ok=True)
        videolib.save_frame(os.path.join(output_path, "render.png"), image)

    if generate_video:
        os.makedirs(os.path.join(output_path, "images"), exist_ok=True)
        frames = videolib.progressive_frames(model, camera, cfg, num_frames=40)
        videolib.write_frames(output_path, frames)
        video_path = videolib.encode_video(output_path, camera.width, camera.height)
        logger.info("wrote %s", video_path)

    plt.figure(figsize=(10, 10))
    plt.subplot(2, 1, 1)
    plt.imshow(np.clip(image, 0, 1))
    plt.title("Rendered Image")
    plt.subplot(2, 1, 2)
    plt.imshow(mpimg.imread(gt_img_path))
    plt.title("Reference Image")
    if output_path:
        plt.savefig(os.path.join(output_path, "comparison.png"), dpi=120)
    if show:
        plt.show()
    plt.close()


@cli.command()
@common_options
@click.option("--output_path", type=str, default="")
@click.option("--num-frames", type=int, default=60)
@click.option("--orbit-degrees", type=float, default=360.0)
@click.option("--mesh", type=str, default="",
              help="render over a mesh, 'DATAxTILE': frames split over the data axis, the tiles "
                   "of a frame over the tile axis (make_batch_render)." + _MESH_RUN)
def orbit(
    input_dir, trained_model_path, scene_index, scale_factor,
    tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs,
    auto_pairs,
    output_path, num_frames, orbit_degrees, mesh,
):
    """Render a camera orbit around the scene view as a video
    (BASELINE.json config 2: batched camera poses)."""
    from gsplat_tpu_torch.ops.camera import CameraArrays
    from gsplat_tpu_torch.parallel import make_batch_render
    from gsplat_tpu_torch.render.pipeline import render_batch
    from gsplat_tpu_torch.utils import video as videolib
    from gsplat_tpu_torch.utils.progress import progress

    dims = _mesh_dims(mesh, device, slice_pairs)  # fail before scene I/O
    cfg = _raster_config(tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs)
    with _mesh_world(dims, device) as (device_mesh, dev):
        model, camera, _, _ = _load_scene(input_dir, trained_model_path, scene_index, scale_factor, dev)
        _check_slice_pairs(cfg, [camera])
        poses = _orbit_poses(camera, num_frames, orbit_degrees)
        images = []
        with torch.inference_mode():
            # An orbit pose can rotate more splats into frustum than the base
            # view: budget-check the whole trajectory (per shard on a mesh).
            if device_mesh is None:
                cfg = _check_pairs(model, poses, cfg, auto_pairs)
                data, group = 1, 8
                batch_render = functools.partial(render_batch, width=camera.width, height=camera.height, cfg=cfg)
            else:
                cfg = _check_pairs_sharded(model, poses, cfg, auto_pairs, device_mesh)
                data = dims[0]
                group = max(data * 4, 8)  # every data row busy in each batch
                batch_render = make_batch_render(device_mesh, camera.width, camera.height, cfg)
            cams = [CameraArrays.from_params(p, device=dev) for p in poses]
            # Render in small batches so progress is visible on long orbits.
            for i in progress(range(0, num_frames, group), desc="orbit frames"):
                batch = cams[i : i + group]
                n_real = len(batch)
                batch += batch[-1:] * (-n_real % data)  # pad to a data-axis multiple
                imgs, _ = batch_render(model, CameraArrays.stack(batch))
                images.extend(imgs[:n_real].cpu().numpy())
        if not _is_main(device_mesh):
            return
    os.makedirs(output_path or ".", exist_ok=True)
    videolib.write_frames(output_path or ".", images)
    video_path = videolib.encode_video(output_path or ".", camera.width, camera.height)
    logger.info("wrote %s (%d frames)", video_path, num_frames)


def _orbit_poses(camera, num_frames: int, orbit_degrees: float):
    """``num_frames`` poses yawed about the camera's own y axis by up to
    ``orbit_degrees``, from ``camera``."""
    from gsplat_tpu_torch.ops.camera import CameraParams

    poses = []
    for i in range(num_frames):
        angle = math.radians(orbit_degrees) * i / num_frames
        half = angle / 2.0
        # Compose an extra yaw (about the camera-frame y axis) onto the pose.
        q = np.array([math.cos(half), 0.0, math.sin(half), 0.0])
        w, x, y, z = camera.qvec
        # Hamilton product q * qvec.
        composed = (
            q[0] * w - q[1] * x - q[2] * y - q[3] * z,
            q[0] * x + q[1] * w + q[2] * z - q[3] * y,
            q[0] * y - q[1] * z + q[2] * w + q[3] * x,
            q[0] * z + q[1] * y - q[2] * x + q[3] * w,
        )
        poses.append(
            CameraParams(
                width=camera.width, height=camera.height,
                fov_x=camera.fov_x, fov_y=camera.fov_y,
                focal_x=camera.focal_x, focal_y=camera.focal_y,
                qvec=tuple(float(v) for v in composed), tvec=camera.tvec,
            )
        )
    return poses


@cli.command()
@common_options
@click.option("--output_path", type=str, default="", help="optional metrics.json destination")
@click.option("--mesh", type=str, default="",
              help="evaluate over a mesh, 'DATAxTILE': views split over the data axis, the tiles "
                   "of a view over the tile axis (all views at one resolution)." + _MESH_RUN)
@click.option("--test-every", type=int, default=0,
              help="score only every Nth view (index %% N == 0) — the "
                   "held-out split of train/finetune --test-every. 0 = all")
def evaluate(
    input_dir, trained_model_path, scene_index, scale_factor,
    tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs,
    auto_pairs,
    output_path, mesh, test_every,
):
    """Render every ground-truth view and report PSNR/SSIM per view + mean
    (quality metrics the reference never published; SURVEY.md §6)."""
    import json

    from gsplat_tpu_torch.ops.camera import CameraArrays
    from gsplat_tpu_torch.parallel import make_batch_render
    from gsplat_tpu_torch.render.pipeline import render_traced
    from gsplat_tpu_torch.train.loss import psnr, ssim
    from gsplat_tpu_torch.utils.progress import progress

    dims = _mesh_dims(mesh, device, slice_pairs)  # fail before scene I/O
    cfg = _raster_config(tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs)
    with _mesh_world(dims, device) as (device_mesh, dev):
        model, _, _, _ = _load_scene(input_dir, trained_model_path, scene_index, scale_factor, dev)
        views = _scene_views(input_dir, scale_factor, dev)
        if test_every > 0:
            views = views[::test_every]
            logger.info("evaluating the held-out split: %d views", len(views))
        _check_slice_pairs(cfg, [cam for _, cam, _ in views])

        def scored(name, pred, gt):
            row = {"view": name, "psnr": float(psnr(pred, gt)), "ssim": float(ssim(pred, gt))}
            logger.info("%s: psnr=%.2f ssim=%.4f", row["view"], row["psnr"], row["ssim"])
            return row

        rows = []
        with torch.inference_mode():
            # Budget-check every view (any pose can have the peak pair demand).
            if device_mesh is None:
                cfg = _check_pairs(model, [cam for _, cam, _ in views], cfg, auto_pairs)
                for name, cam, gt in progress(views, desc="evaluate views"):
                    pred, _ = render_traced(model, CameraArrays.from_params(cam, device=dev), cam.width, cam.height,
                                            cfg)
                    rows.append(scored(name, pred, gt))
            else:
                w0, h0 = views[0][1].width, views[0][1].height
                if any(c.width != w0 or c.height != h0 for _, c, _ in views):
                    raise click.UsageError("--mesh evaluation requires all views at one resolution")
                cfg = _check_pairs_sharded(model, [c for _, c, _ in views], cfg, auto_pairs, device_mesh)
                batch_render = make_batch_render(device_mesh, w0, h0, cfg)
                data = dims[0]
                group = max(data * 4, 8)
                for i in progress(range(0, len(views), group), desc="evaluate views"):
                    batch = views[i : i + group]
                    cams = [CameraArrays.from_params(c, device=dev) for _, c, _ in batch]
                    cams += cams[-1:] * (-len(cams) % data)  # pad to a data-axis multiple
                    preds, _ = batch_render(model, CameraArrays.stack(cams))
                    rows.extend(scored(name, pred, gt) for (name, _, gt), pred in zip(batch, preds))
        if not _is_main(device_mesh):
            return
    summary = {
        "mean_psnr": float(np.mean([r["psnr"] for r in rows])) if rows else float("nan"),
        "mean_ssim": float(np.mean([r["ssim"] for r in rows])) if rows else float("nan"),
        "views": rows,
    }
    logger.info("mean psnr=%.2f ssim=%.4f over %d views",
                summary["mean_psnr"], summary["mean_ssim"], len(rows))
    if output_path:
        os.makedirs(output_path, exist_ok=True)
        with open(os.path.join(output_path, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)


def _training_options(fn):
    """The options ``finetune`` and ``train`` share, after their own."""
    options = [
        click.option("--densify-every", type=int, default=100),
        click.option("--densify-grad-threshold", type=float, default=2e-4),
        click.option("--sh-warmup-every", type=int, default=0,
                     help="bump the trained SH degree every N steps (3DGS warmup; "
                          "0 = full degree from the start)"),
        click.option("--mesh", type=str, default="",
                     help="train on a mesh, 'DATAxTILE' (e.g. 2x4): the camera batch split over the data "
                          "axis, the tiles over the tile axis (ParallelTrainer)." + _MESH_RUN),
        click.option("--background", type=click.Choice(["black", "white", "random"]),
                     default="black",
                     help="training background composited via the residual "
                          "transmittance ('random' = fresh color per step, the "
                          "3DGS floater-suppression trick)"),
        click.option("--lr-decay-steps", type=int, default=0,
                     help="decay the position lr log-linearly to --lr-means-final "
                          "over this many steps (0 = constant, the 3DGS schedule)"),
        click.option("--lr-means-final", type=float, default=1.6e-6),
        click.option("--lr-scale-extent/--no-lr-scale-extent", default=False,
                     help="multiply the position lr (and its decay floor) by the "
                          "scene extent (1.1x the camera-center bounding-sphere "
                          "radius) -- 3DGS's spatial_lr_scale; its lr defaults "
                          "assume this on real scenes"),
        click.option("--test-every", type=int, default=0,
                     help="hold out every Nth view (index %% N == 0, 3DGS's "
                          "llffhold convention; 8 is the paper's value) from "
                          "training and report held-out PSNR/SSIM at the end. "
                          "0 = train on every view"),
        click.option("--checkpoint-every", type=int, default=500,
                     help="save the full loop state (model + optimizer + step) to "
                          "<output_path>/train_state.pt (a torch.save file) every N "
                          "steps (0 = only at completion); continue an interrupted "
                          "run with --resume"),
        click.option("--resume", is_flag=True, default=False,
                     help="resume from <output_path>/train_state.pt if present "
                          "(same view rotation and RNG path as the killed run)"),
    ]
    for opt in reversed(options):
        fn = opt(fn)
    return fn


@cli.command()
@common_options
@click.option("--output_path", type=str, default="")
@click.option("--steps", type=int, default=300)
@click.option("--ssim-weight", type=float, default=0.2)
@click.option("--save-iteration", type=int, default=30001,
              help="iteration label for the exported PLY checkpoint")
@click.option("--densify/--no-densify", default=False,
              help="adaptive density control (3DGS clone/split/prune on a "
                   "fixed-capacity pool; see DensifyConfig)")
@_training_options
def finetune(
    input_dir, trained_model_path, scene_index, scale_factor,
    tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs,
    auto_pairs,
    output_path, steps, ssim_weight, save_iteration, densify,
    densify_every, densify_grad_threshold, sh_warmup_every, mesh,
    background, lr_decay_steps, lr_means_final, lr_scale_extent, test_every,
    checkpoint_every, resume,
):
    """Fine-tune the splat model against the scene's ground-truth views
    (BASELINE.json config 4: the full-VJP workload)."""
    dims = _mesh_dims(mesh, device, slice_pairs)  # fail before scene I/O
    cfg = _raster_config(tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs)
    with _mesh_world(dims, device) as (device_mesh, dev):
        model, _, _, _ = _load_scene(input_dir, trained_model_path, scene_index, scale_factor, dev)
        views = _load_views(input_dir, scale_factor, dev)
        logger.info("fine-tuning on %d views for %d steps", len(views), steps)
        _run_training(
            model, views, cfg, auto_pairs, output_path, steps, ssim_weight,
            save_iteration, densify, densify_every, densify_grad_threshold,
            sh_warmup_every, background, lr_decay_steps, lr_means_final,
            lr_scale_extent, test_every, checkpoint_every, resume, device_mesh,
        )


@cli.command()
@common_options
@click.option("--output_path", type=str, default="")
@click.option("--steps", type=int, default=2000)
@click.option("--ssim-weight", type=float, default=0.2)
@click.option("--save-iteration", type=int, default=30000,
              help="iteration label for the exported PLY checkpoint")
@click.option("--densify/--no-densify", default=True,
              help="adaptive density control (on by default when training "
                   "from scratch; see DensifyConfig)")
@click.option("--initial-opacity", type=float, default=0.1)
@_training_options
def train(
    input_dir, trained_model_path, scene_index, scale_factor,
    tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs,
    auto_pairs,
    output_path, steps, ssim_weight, save_iteration, densify,
    initial_opacity, densify_every, densify_grad_threshold, sh_warmup_every,
    mesh, background, lr_decay_steps, lr_means_final, lr_scale_extent,
    test_every, checkpoint_every, resume,
):
    """Train a splat model FROM SCRATCH: initialize from the scene's COLMAP
    SfM points (sparse/0/points3D) and optimize against its ground-truth
    views — the full 3DGS loop (init -> densify -> optimize). With
    --trained_model_path the run WARM-STARTS from that Inria checkpoint
    instead of the SfM points (same as finetune, but with this command's
    densify-on default)."""
    from gsplat_tpu_torch.io.scene import read_points3d
    from gsplat_tpu_torch.models.gaussians import GaussianModel

    dims = _mesh_dims(mesh, device, slice_pairs)  # fail before scene I/O
    cfg = _raster_config(tile_size, chunk_size, max_pairs, early_stop, device, slice_pairs)
    with _mesh_world(dims, device) as (device_mesh, dev):
        if trained_model_path:
            from gsplat_tpu_torch.io.ply import load_splat_arrays
            from gsplat_tpu_torch.io.scene import checkpoint_ply_path

            model = GaussianModel.from_arrays(load_splat_arrays(checkpoint_ply_path(trained_model_path)), device=dev)
            init_desc = f"checkpoint {trained_model_path} ({model.num_gaussians} splats)"
        else:
            xyzs, rgbs, _ = read_points3d(input_dir)
            model = GaussianModel.from_points3d(xyzs, rgbs, initial_opacity=initial_opacity, device=dev)
            init_desc = f"{model.num_gaussians} SfM points"
        views = _load_views(input_dir, scale_factor, dev)
        logger.info("training from %s on %d views for %d steps", init_desc, len(views), steps)
        _run_training(
            model, views, cfg, auto_pairs, output_path, steps, ssim_weight,
            save_iteration, densify, densify_every, densify_grad_threshold,
            sh_warmup_every, background, lr_decay_steps, lr_means_final,
            lr_scale_extent, test_every, checkpoint_every, resume, device_mesh,
        )


def _run_training(
    model, views, cfg, auto_pairs, output_path, steps, ssim_weight,
    save_iteration, densify, densify_every, densify_grad_threshold,
    sh_warmup_every, background="black", lr_decay_steps=0,
    lr_means_final=1.6e-6, lr_scale_extent=False, test_every=0,
    checkpoint_every=500, resume=False, device_mesh=None,
):
    """Train ``model`` on ``views`` with the options of ``finetune`` /
    ``train`` (on ``device_mesh``, a ``parallel.Mesh``, when given), report
    the held-out split, export the PLY (rank 0). Returns (model, history);
    without densification ``model`` is updated in place."""
    from gsplat_tpu_torch.config import DensifyConfig
    from gsplat_tpu_torch.parallel import ParallelTrainer
    from gsplat_tpu_torch.train.checkpoint import save_ply_checkpoint
    from gsplat_tpu_torch.train.trainer import Trainer
    from gsplat_tpu_torch.utils.logging import log_metrics

    test_views = []
    if test_every > 0:
        test_views = views[::test_every]  # index % N == 0: 3DGS llffhold
        views = [v for i, v in enumerate(views) if i % test_every != 0]
        if not views:
            raise click.UsageError(
                f"--test-every {test_every} holds out every view; nothing "
                "left to train on"
            )
        logger.info(
            "holding out %d of %d views for evaluation",
            len(test_views), len(views) + len(test_views),
        )
    _check_slice_pairs(cfg, [camera for camera, _ in views + test_views])

    dcfg = (
        DensifyConfig(every=densify_every, grad_threshold=densify_grad_threshold)
        if densify
        else None
    )
    extent = 1.0
    if lr_scale_extent:
        from gsplat_tpu_torch.train.trainer import scene_extent

        extent = scene_extent([camera for camera, _ in views])
        logger.info("scene extent %.3f: position lr scaled accordingly", extent)
    base = TrainConfig()
    train_cfg = TrainConfig(
        steps=steps, ssim_weight=ssim_weight, densify=dcfg,
        sh_warmup_every=sh_warmup_every, background=background,
        lr_means=base.lr_means * extent,
        lr_means_decay_steps=lr_decay_steps,
        lr_means_final=lr_means_final * extent if lr_decay_steps > 0 else 0.0,
        checkpoint_every=checkpoint_every,
    )
    if resume and not output_path:
        raise click.UsageError("--resume requires --output_path (the "
                               "checkpoint lives at <output_path>/train_state.pt)")
    if device_mesh is None:
        trainer = Trainer(raster=cfg, train=train_cfg, auto_pairs=auto_pairs)
    else:
        trainer = ParallelTrainer(mesh=device_mesh, raster=cfg, train=train_cfg, auto_pairs=auto_pairs)
    model, history = trainer.fit(
        model, views, log_fn=lambda r: log_metrics(logger, r["step"], r),
        checkpoint_dir=output_path or None, resume=resume,
    )
    if test_views:
        from gsplat_tpu_torch.render.pipeline import render as render_fn
        from gsplat_tpu_torch.train.loss import psnr, ssim

        vals = []
        with torch.inference_mode():
            for camera, gt in test_views:
                pred, _ = render_fn(model, camera, trainer.raster)
                vals.append((float(psnr(pred, gt)), float(ssim(pred, gt))))
        mean_psnr = sum(v[0] for v in vals) / len(vals)
        mean_ssim = sum(v[1] for v in vals) / len(vals)
        logger.info(
            "held-out (%d views): PSNR %.2f  SSIM %.4f",
            len(vals), mean_psnr, mean_ssim,
        )
    if output_path and _is_main(device_mesh):
        ply = save_ply_checkpoint(output_path, model, iteration=save_iteration)
        logger.info("saved trained checkpoint to %s", ply)
    return model, history


if __name__ == "__main__":
    cli()
