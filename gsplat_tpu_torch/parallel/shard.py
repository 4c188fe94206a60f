"""Multi-GPU rendering and training over a (data x tile) mesh.

The counterpart of ``gsplat_tpu/parallel/shard.py`` on ``torch.distributed``
(``parallel/mesh.py``), with its layout:

  * camera batch: split over the ``data`` axis, each row of the mesh
    rendering its own cameras one after another;
  * framebuffer tiles: split over the ``tile`` axis with a 2D-strided
    ownership. The tile factor tp = sy*sx, and the rank at column
    d = oy*sx + ox owns the tiles {(tx, ty) : tx = ox (mod sx), ty = oy (mod
    sy)}. Striding decorrelates per-rank load while keeping rect coverage
    separable per axis, so every rank bins its own tiles only;
  * per-gaussian preprocess: split over the ``tile`` axis by gaussian
    range. Each rank of a row preprocesses ``n_local = ceil(N/tp)`` rows of
    the model (padded past N with inert splats) and the packed feature rows
    and binning inputs are all-gathered over the row;
  * splat parameters: replicated on every rank. Each rank differentiates
    its own loss terms; the gradient of its feature slice arrives through
    the gather's backward (the cotangent summed over the row), and the
    parameter gradients are summed over the world before an identical Adam
    update on every rank.

Every function returns the whole result on every rank (frames, losses,
viewspace gradients), and every rank must call it, with the same model and
cameras, in the same order: the collectives inside pair up across ranks.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from gsplat_tpu_torch.config import RasterConfig, TrainConfig
from gsplat_tpu_torch.kernels.raster import rasterize_tiles
from gsplat_tpu_torch.models.gaussians import DEAD_OPACITY_LOGIT, GaussianModel
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.ops.camera import CameraArrays
from gsplat_tpu_torch.parallel.collectives import all_gather_rows, all_reduce_max, all_reduce_sum
from gsplat_tpu_torch.parallel.mesh import DATA_AXIS, TILE_AXIS, Mesh, replicated
from gsplat_tpu_torch.render.pipeline import preprocess_traced, required_max_pairs
from gsplat_tpu_torch.render.tile_torch import image_to_tiles, tiles_to_image
from gsplat_tpu_torch.train.densify import screen_radii
from gsplat_tpu_torch.train.loss import rgb_loss
from gsplat_tpu_torch.train.trainer import FitLoop, check_background, make_optimizer, optimizer_step
from gsplat_tpu_torch.utils.logging import get_logger
from gsplat_tpu_torch.utils.stages import stage, sync

logger = get_logger()


def _factor_stride(tp: int) -> Tuple[int, int]:
    """tp -> (sy, sx), sy*sx == tp, near-square with the larger factor on x
    (frames are wider than tall, so x usually has more tile columns)."""
    f = max(int(math.isqrt(tp)), 1)
    while tp % f:
        f -= 1
    return f, tp // f


@dataclasses.dataclass(frozen=True)
class _ShardLayout:
    """Static bookkeeping for the strided tile -> rank assignment.

    Stacked order (the tile slabs of a row's ranks, concatenated in column
    order) is ``pos = d * tiles_local + local`` with
    ``d = (ty % sy)*sx + (tx % sx)`` and ``local = (ty // sy)*ntx_l + (tx // sx)``.
    """

    sy: int
    sx: int
    ntx_g: int
    nty_g: int
    ntx_l: int
    nty_l: int
    pos_of_global: np.ndarray  # [T_global] -> index into the stacked tiles
    src_of_stacked: np.ndarray  # [tp*T_local] -> global tile id, or -1 (pad)

    @property
    def tiles_local(self) -> int:
        return self.ntx_l * self.nty_l


def _make_layout(width: int, height: int, tile_size: int, tp: int) -> _ShardLayout:
    ntx_g = -(-width // tile_size)
    nty_g = -(-height // tile_size)
    sy, sx = _factor_stride(tp)
    ntx_l = -(-ntx_g // sx)
    nty_l = -(-nty_g // sy)
    t_l = ntx_l * nty_l
    ty, tx = np.divmod(np.arange(nty_g * ntx_g), ntx_g)
    d = (ty % sy) * sx + (tx % sx)
    local = (ty // sy) * ntx_l + (tx // sx)
    pos = d * t_l + local
    src = np.full(tp * t_l, -1, np.int64)
    src[pos] = np.arange(nty_g * ntx_g)
    return _ShardLayout(sy, sx, ntx_g, nty_g, ntx_l, nty_l, pos, src)


def _model_rows(model: GaussianModel, start: int, count: int):
    """Rows ``[start, start + count)`` of ``model``, past its end the inert
    rows ``models.gaussians.pad_model`` pads with, in the form
    ``preprocess_traced`` reads. Differentiable with respect to the model's
    parameters."""
    n = model.num_gaussians
    stop = min(start + count, n)
    extra = count - max(stop - start, 0)

    def rows(x, fill):
        part = x[min(start, n) : stop]
        if extra:
            part = torch.cat([part, x.new_tensor(fill).expand((extra,) + x.shape[1:])])
        return part

    log_scales = rows(model.log_scales, 0.0)
    opacity_logits = rows(model.opacity_logits, DEAD_OPACITY_LOGIT)
    return SimpleNamespace(
        means=rows(model.means, 0.0),
        quats=rows(model.quats, [1.0, 0.0, 0.0, 0.0]),
        sh=rows(model.sh, 0.0),
        scales=lambda: torch.exp(log_scales),
        opacity=lambda: torch.sigmoid(opacity_logits),
    )


def _shard_bin(model, cam, lay: _ShardLayout, width, height, cfg: RasterConfig, n_local: int, mesh: Mesh,
               screen_offset=None):
    """One rank's preprocess and binning: preprocess this rank's gaussian
    slice, all-gather the packed rows over the row, bin this rank's strided
    tile subset. Returns (feat ``[tp*n_local + 1, 16]``, bins, tile_ids
    ``[T_l]`` global tile ids, radii).

    ``screen_offset``: this rank's ``[n_local, 2]`` slice of the viewspace
    probe (``train/densify.py``); with it, the screen radii of every row
    (``[tp*n_local]``, from this preprocess) travel in the gather as one
    more column and come back as ``radii``, else ``radii`` is None. Each
    rank counts its own tiles' pairs;
    the JAX package sums a histogram over the row instead, which gives the
    same counts whenever nothing overflows, and takes its own otherwise."""
    tp = lay.sy * lay.sx
    d = mesh.tile_index
    ox, oy = d % lay.sx, d // lay.sx
    with stage("preprocess"):
        prep = preprocess_traced(_model_rows(model, d * n_local, n_local), cam, width, height, cfg, screen_offset)
    with stage("pack_features"):
        cols = [
            binning.pack_feature_rows(prep),
            prep.depth.detach()[:, None],
            prep.active.to(prep.depth.dtype)[:, None],
            prep.cull_bbox.to(prep.depth.dtype),  # pixel coordinates: exact in f32
        ]
        if screen_offset is not None:  # whole pixels: exact in f32
            cols.append(screen_radii(prep.conics.detach(), prep.active)[:, None])
        rows = torch.cat(cols, dim=1)  # [n_local, 22 or 23]
    if tp > 1:
        with stage("gather"):
            rows = all_gather_rows(rows, mesh.row_group)
    nf = binning.NUM_FEATURES
    feat_rows = rows[:, :nf]
    with stage("binning"):
        rects = binning.strided_tile_ranges(
            rows[:, nf + 2 : nf + 6].detach().to(torch.int32), cfg.tile_size, lay.ntx_g, lay.nty_g,
            lay.sx, lay.sy, ox, oy,
        )
        bins = binning.bin_rects(
            rows[:, nf].detach(), rows[:, nf + 1].detach() > 0.5, rects, lay.ntx_l, lay.nty_l, cfg.max_pairs,
            align=cfg.pair_block,
        )
    feat = torch.cat([feat_rows, feat_rows.new_zeros((1, nf))])
    li = torch.arange(lay.tiles_local, dtype=torch.int32, device=feat.device)
    tile_ids = (oy + (li // lay.ntx_l) * lay.sy) * lay.ntx_g + ox + (li % lay.ntx_l) * lay.sx
    radii = rows[:, nf + 6].detach() if screen_offset is not None else None
    return feat, bins, tile_ids.to(torch.int32), radii


def _shard_render_tiles(model, cam, lay, width, height, cfg, n_local, mesh, screen_offset=None):
    """One rank's render (see :func:`_shard_bin`): bin this rank's strided
    tile subset, then rasterize it. Returns (color ``[T_l, npix, 3]``,
    trans ``[T_l, npix]``, radii: see :func:`_shard_bin`)."""
    feat, bins, tile_ids, radii = _shard_bin(model, cam, lay, width, height, cfg, n_local, mesh, screen_offset)
    color, trans = rasterize_tiles(
        feat, bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids, bins.gaussian_counts, lay.ntx_g,
        cfg, width=width, height=height,
    )
    return color, trans, radii


def make_sharded_binning_stats(mesh: Mesh, width: int, height: int, cfg: RasterConfig):
    """Per-shard pair-budget diagnostics under the strided tile sharding.

    ``cfg.max_pairs`` is the PER-SHARD capacity, and the strided layout only
    decorrelates per-shard load, so the binding number is the largest
    shard's own ``pair_demand`` (a max over the world), not whole-frame
    demand divided by the tile factor. Returns fn(model, cam) -> dict of 0-d
    tensors: ``max_shard_demand``, ``max_shard_pairs``, ``capacity``,
    ``overflowed``."""
    tp = mesh.shape[TILE_AXIS]
    lay = _make_layout(width, height, cfg.tile_size, tp)

    @torch.no_grad()
    def stats_fn(model: GaussianModel, cam: CameraArrays) -> dict:
        n_local = -(-model.num_gaussians // tp)
        bins = _shard_bin(model, cam, lay, width, height, cfg, n_local, mesh)[1]
        demand, num_pairs = all_reduce_max(torch.stack([bins.pair_demand, bins.num_pairs]), mesh.world_group)
        return {
            "max_shard_demand": demand,
            "max_shard_pairs": num_pairs,
            "capacity": torch.tensor(cfg.max_pairs, dtype=torch.int32, device=demand.device),
            "overflowed": demand > cfg.max_pairs,
        }

    return stats_fn


def _frame(stacked, lay: _ShardLayout, width, height, tile_size):
    """``[tp*T_l, npix, C...]`` tiles in stacked order -> ``[H, W, C...]``."""
    pos = torch.as_tensor(lay.pos_of_global, device=stacked.device)
    return tiles_to_image(stacked[pos], width, height, tile_size)


def _stacked_to_image(slab, mesh: Mesh, lay: _ShardLayout, width, height, tile_size):
    """This rank's ``[T_l, npix, C...]`` tile slab -> the whole
    ``[H, W, C...]`` frame, all-gathered over the row (differentiably)."""
    stacked = slab
    if lay.sy * lay.sx > 1:
        with stage("frame_gather"):
            stacked = all_gather_rows(slab, mesh.row_group)
    return _frame(stacked, lay, width, height, tile_size)


def _render_frame(model, cam, lay, width, height, cfg, n_local, mesh):
    """One view through the tile shards: ``[H, W, 4]``, colour then T."""
    color, trans, _ = _shard_render_tiles(model, cam, lay, width, height, cfg, n_local, mesh)
    with stage("tiles_to_image"):
        return _stacked_to_image(torch.cat([color, trans[..., None]], -1), mesh, lay, width, height, cfg.tile_size)


def make_sharded_render(mesh: Mesh, width: int, height: int, cfg: RasterConfig):
    """Tile-sharded single-view render: returns fn(model, cam) -> (image
    ``[H, W, 3]``, transmittance ``[H, W]``), the whole frame on every rank."""
    tp = mesh.shape[TILE_AXIS]
    lay = _make_layout(width, height, cfg.tile_size, tp)

    def render_fn(model: GaussianModel, cam: CameraArrays):
        n_local = -(-model.num_gaussians // tp)
        frame = _render_frame(model, cam, lay, width, height, cfg, n_local, mesh)
        return frame[..., :3], frame[..., 3]

    return render_fn


def make_batch_render(mesh: Mesh, width: int, height: int, cfg: RasterConfig):
    """Batched multi-view render over the whole (data x tile) mesh, the
    serving and orbit-video workload: the camera batch is split over the
    ``data`` axis (each row renders its own frames one after another) and
    each frame's tiles over the ``tile`` axis. Returns fn(model, cams) ->
    (images ``[B, H, W, 3]``, trans ``[B, H, W]``), every frame on every
    rank, with ``cams`` stacked CameraArrays (``[B, ...]`` leaves) and B
    divisible by the data-axis size."""
    dp = mesh.shape[DATA_AXIS]
    tp = mesh.shape[TILE_AXIS]
    lay = _make_layout(width, height, cfg.tile_size, tp)

    def render_fn(model: GaussianModel, cams: CameraArrays):
        batch = cams.w2c_t.shape[0]
        if batch % dp != 0:
            raise ValueError(
                f"camera batch ({batch}) must be divisible by the data-axis "
                f"size ({dp}); pad the batch (see cli.py orbit)"
            )
        bl = batch // dp
        n_local = -(-model.num_gaussians // tp)
        first = mesh.data_index * bl
        frames = torch.stack([
            _render_frame(model, CameraArrays(*(x[b] for x in cams)), lay, width, height, cfg, n_local, mesh)
            for b in range(first, first + bl)
        ])
        if dp > 1:
            frames = all_gather_rows(frames, mesh.column_group)
        return frames[..., :3], frames[..., 3]

    return render_fn


def make_parallel_train_step(
    mesh: Mesh,
    width: int,
    height: int,
    raster_cfg: RasterConfig,
    train_cfg: TrainConfig,
    with_viewspace_grad: bool = False,
):
    """Build a (data x tile)-parallel train step.

    Returns (train_step, init_state, prepare_targets):
      * ``train_step(model, optimizer, cams, targets_tiles, bg=None)``
        consumes a camera batch (stacked CameraArrays, leaves ``[B, ...]``;
        B divisible by the data axis) and pre-tiled targets
        ``[B, tp*T_l, npix, 3]`` (from ``prepare_targets``), the same on
        every rank, and applies one Adam update (in place, identical on
        every rank) from gradients summed over the whole mesh. ``bg``
        (``[3]``) is composited through the residual transmittance
        (TrainConfig.background; None = black). Returns (model, optimizer,
        metrics) with ``loss`` and ``psnr`` as 0-d tensors, the same on
        every rank;
      * loss is (1-w)*L1 + w*(1-SSIM) averaged over the batch; under tile
        sharding the frame is all-gathered over the row for the windowed
        SSIM term, and each rank of the row takes 1/tp of it;
      * with ``with_viewspace_grad`` it also returns the PER-VIEW viewspace
        positional gradients ``[B, N, 2]``, each row ``d(loss of view
        b)/d(offset)``, as the single-device trainer's per-view probe, so
        ``DensifyConfig.grad_threshold`` needs no recalibration under dp,
        and (beyond the JAX package's contract) each view's screen radii
        ``[B, N]`` from the step's own preprocess of the model before the
        update, the input of the screen-size prune;
      * ``init_state(model)`` is the optimizer (``train/trainer.py``);
      * with ``optimizer=None`` the step runs the same forward, loss,
        backward and gradient all-reduce, leaves the model as it is and
        returns (grads, frames, metrics): the five raw parameters'
        gradients summed over the world (fresh tensors each call), the
        whole frames ``[B, H, W, 3]`` (background composited) on every
        rank, and ``metrics`` as above (not with ``with_viewspace_grad``).
    """
    dp = mesh.shape[DATA_AXIS]
    tp = mesh.shape[TILE_AXIS]
    lay = _make_layout(width, height, raster_cfg.tile_size, tp)
    t_l = lay.tiles_local
    valid_src = lay.src_of_stacked >= 0
    safe_src = np.where(valid_src, lay.src_of_stacked, 0)
    ssim_w = train_cfg.ssim_weight
    npixels = width * height * 3
    # Per-tile pixel validity in stacked order (image edge tiles include
    # padding pixels; shard padding tiles are all invalid), per device.
    masks = {}

    def pixel_mask(dev):
        if dev not in masks:
            tiles = image_to_tiles(torch.ones((height, width), device=dev), raster_cfg.tile_size)
            valid = torch.as_tensor(valid_src, device=dev)[:, None]
            masks[dev] = torch.where(valid, tiles[torch.as_tensor(safe_src, device=dev)], 0.0)
        return masks[dev]

    def train_step(model, optimizer, cams, targets_tiles, bg=None):
        batch = cams.w2c_t.shape[0]
        if batch % dp != 0:
            raise ValueError(f"camera batch ({batch}) must be divisible by the data-axis size ({dp})")
        bl = batch // dp
        dev = model.means.device
        n_local = -(-model.num_gaussians // tp)
        d = mesh.tile_index
        mask_l = pixel_mask(dev)[d * t_l : (d + 1) * t_l, :, None]
        if bg is None:
            bg = torch.zeros(3, device=dev)
        if optimizer is not None:
            optimizer.zero_grad(set_to_none=True)
        elif with_viewspace_grad:
            raise ValueError("the step without an update takes no viewspace probe")
        offset = None
        if with_viewspace_grad:
            offset = torch.zeros((bl, n_local, 2), dtype=model.means.dtype, device=dev, requires_grad=True)
        loss_sum = mse_sum = 0.0
        radii, frames = [], []
        with stage("forward"):
            for i in range(bl):
                b = mesh.data_index * bl + i
                cam = CameraArrays(*(x[b] for x in cams))
                color, trans, r = _shard_render_tiles(
                    model, cam, lay, width, height, raster_cfg, n_local, mesh, None if offset is None else offset[i]
                )
                radii.append(r)
                color = color + trans[..., None] * bg
                target_l = targets_tiles[b, d * t_l : (d + 1) * t_l]
                with stage("loss"):
                    mse_sum = mse_sum + (((color - target_l) ** 2) * mask_l).sum().detach() / npixels
                    if ssim_w > 0.0:
                        # SSIM's window crosses shard boundaries, so every rank
                        # of the row assembles the whole frame; the loss is
                        # then the same on each of them, and each takes 1/tp.
                        image = _stacked_to_image(color, mesh, lay, width, height, raster_cfg.tile_size)
                        target = _frame(targets_tiles[b], lay, width, height, raster_cfg.tile_size)
                        loss_sum = loss_sum + rgb_loss(image, target, ssim_w) / tp
                    else:
                        loss_sum = loss_sum + ((color - target_l).abs() * mask_l).sum() / npixels
                        if optimizer is None:
                            image = _stacked_to_image(color.detach(), mesh, lay, width, height,
                                                      raster_cfg.tile_size)
                    if optimizer is None:
                        frames.append(image.detach())
        params = list(model.parameters())
        with stage("backward"):
            if optimizer is None:
                grads = list(torch.autograd.grad(loss_sum / batch, params, allow_unused=True))
            else:
                (loss_sum / batch).backward()
                grads = [p.grad for p in params]
        with stage("grad_all_reduce"):
            for k, p in enumerate(params):
                if grads[k] is None:  # a rank whose slice is all padding
                    grads[k] = torch.zeros_like(p)
                    if optimizer is not None:
                        p.grad = grads[k]
                all_reduce_sum(grads[k], mesh.world_group)
        if optimizer is not None:
            with stage("optimizer"):
                optimizer_step(optimizer, train_cfg)
        totals = all_reduce_sum(torch.stack([loss_sum.detach(), mse_sum]), mesh.world_group) / batch
        metrics = {"loss": totals[0], "psnr": -10.0 * torch.log10(torch.clamp(totals[1], min=1e-12))}
        if optimizer is None:
            frames = torch.stack(frames)
            if dp > 1:
                frames = all_gather_rows(frames, mesh.column_group)
            return grads, frames, metrics
        if not with_viewspace_grad:
            return model, optimizer, metrics
        # The loss averages over the batch, so each probe row carries a
        # 1/batch factor; undo it so that row b is d(loss of view b)/d(offset).
        vs = offset.grad
        if tp > 1:
            vs = all_gather_rows(vs.transpose(0, 1).contiguous(), mesh.row_group).transpose(0, 1)
        radii = torch.stack(radii)  # [bl, tp*n_local]: gathered over the row already
        if dp > 1:
            vs = all_gather_rows(vs.contiguous(), mesh.column_group)
            radii = all_gather_rows(radii, mesh.column_group)
        n = model.num_gaussians
        return model, optimizer, metrics, vs[:, :n] * batch, radii[:, :n]

    def init_state(model):
        return make_optimizer(model, train_cfg)

    def prepare_targets(targets: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` images -> ``[B, tp*T_l, npix, 3]`` in stacked order."""
        tiles = torch.stack([image_to_tiles(im, raster_cfg.tile_size) for im in targets])
        dev = tiles.device
        picked = tiles[:, torch.as_tensor(safe_src, device=dev)]
        return torch.where(torch.as_tensor(valid_src, device=dev)[None, :, None, None], picked, 0.0)

    return train_step, init_state, prepare_targets


@dataclasses.dataclass
class ParallelTrainer(FitLoop):
    """Multi-GPU counterpart of ``train.trainer.Trainer``: the same
    ``fit(model, views)`` (the loop of ``train.trainer.FitLoop``), run as
    (data x tile)-sharded steps on every rank of ``mesh``.

    Views are batched round-robin, one per data row per step (every row
    trains a different camera of the batch); all frames must share one
    resolution. Without densification the given ``model`` is first
    broadcast from rank 0. Densification runs on the replicated pool between
    sharded steps, fed by the gathered viewspace probe and radii; every rank
    draws the same split samples from its own generator seeded alike, so the
    replicas stay bitwise equal. Rank 0 alone logs, calls ``log_fn`` and
    writes loop checkpoints.
    """

    mesh: Mesh
    raster: RasterConfig
    train: TrainConfig
    auto_pairs: bool = True
    show_progress: bool = True

    _desc = "fit"

    def __post_init__(self):
        check_background(self.train)
        self._bg_rng = np.random.default_rng(0)
        self._stats_fn = None  # cached per-shard demand probe (check_capacity)

    @property
    def _main(self) -> bool:
        return self.mesh.rank == 0

    def check_capacity(self, model, cams, width, height) -> bool:
        """Measure the largest per-shard pair demand of the strided binning
        over the given CameraArrays (the same on every rank). On overflow:
        resize ``self.raster`` (with ``auto_pairs``) and return True, or
        warn."""
        if self._stats_fn is None:
            self._stats_fn = make_sharded_binning_stats(self.mesh, width, height, self.raster)
        stats = [self._stats_fn(model, cam)["max_shard_demand"] for cam in cams]
        with sync("capacity_check"):
            demand = max(int(d) for d in stats)
        if demand <= self.raster.max_pairs:
            return False
        target = required_max_pairs(demand)
        if self.auto_pairs:
            if self._main:
                logger.warning("per-shard pair demand %d exceeds capacity %d: resizing max_pairs to %d",
                               demand, self.raster.max_pairs, target)
            self.raster = dataclasses.replace(self.raster, max_pairs=target)
            self._stats_fn = None  # the probe bins at the capacity
            return True
        if self._main:
            logger.warning("per-shard pair demand %d exceeds capacity %d: deepest splats will be dropped "
                           "(suggested max_pairs=%d)", demand, self.raster.max_pairs, target)
        return False

    def _views_per_step(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    def _start(self, model, views, resumed):
        self._size = (views[0][0].width, views[0][0].height)
        if any((c.width, c.height) != self._size for c, _ in views):
            raise ValueError("all views must share one resolution")
        if not resumed:
            replicated(self.mesh, model)

    def _begin(self, model, views, start_step):
        dev = model.means.device
        self._cams = [CameraArrays.from_params(c, dtype=model.means.dtype, device=dev) for c, _ in views]
        self._step_fn = self._step_key = None
        self._stats_fn = None
        self.check_capacity(model, self._cams, *self._size)
        prepare_targets = make_parallel_train_step(self.mesh, *self._size, self.raster, self.train)[2]
        self._targets = [prepare_targets(t[None]) for _, t in views]

    def _train_views(self, model, optimizer, views, idx, bg, sh_degree, with_vs):
        # The step is rebuilt when SH warmup or a capacity resize changes
        # the config it was built for.
        key = (sh_degree, self.raster)
        if key != self._step_key:
            cfg = dataclasses.replace(self.raster, sh_degree=sh_degree)
            self._step_fn = make_parallel_train_step(self.mesh, *self._size, cfg, self.train,
                                                     with_viewspace_grad=with_vs)[0]
            self._step_key = key
        cams = CameraArrays.stack([self._cams[i] for i in idx])
        targets = torch.cat([self._targets[i] for i in idx])
        result = self._step_fn(model, optimizer, cams, targets, bg)
        if not with_vs:
            return result[2], [], None
        vs, radii = result[3], result[4]
        return result[2], [(vs[b], *self._size, radii[b]) for b in range(len(idx))], None

    def _recheck(self, model, views, idx):
        self.check_capacity(model, [self._cams[i] for i in idx], *self._size)

    def _save(self, checkpoint_dir, *state):
        """Rank 0 writes the loop state; every rank waits for it."""
        if self._main:
            super()._save(checkpoint_dir, *state)
        dist.barrier(group=self.mesh.world_group)
