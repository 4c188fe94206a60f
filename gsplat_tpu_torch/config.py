"""Configuration of the PyTorch port: the reference constants, the
rasterization settings and the training settings.

Mirrors ``gsplat_tpu/config.py``, ``MeshConfig`` included. The kernel/plain choice is not a setting
here: every rasterizer call dispatches on the device of its tensors (a CUDA
tensor launches the hand-written kernel, a CPU tensor takes its plain
PyTorch version), so ``use_pallas`` and ``force_pallas_interpret`` have no
counterpart. Nor has ``share_pair_feat``: the CUDA kernels gather each
pair's row from ``feat`` directly, so there is no TPU-layout pair-feature
slab to keep between the forward and the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# --- Constants matching the reference semantics (rasterize.py:29-38) ---
Z_FAR = 100.0
Z_NEAR = 0.01
GAUSSIAN_SPREAD = 3  # bbox radius = ceil(3 * max std-dev)
BLOCK_SIZE = 16  # reference's CUDA block size used for bbox rounding
MAX_GAUSSIAN_DENSITY = 0.99  # alpha clamp
MIN_ALPHA = 1.0 / 255.0  # contributions below this are skipped
FRUSTUM_NEAR_Z = 0.2  # camera-space z below which gaussians are culled
EIGENVALUE_FLOOR = 0.1  # floor inside sqrt when computing 2D spread
COV2D_LOWPASS = 0.3  # added to the diagonal of the projected covariance
PERSPECTIVE_EPS = 1e-7  # epsilon added to w before the perspective divide
EWA_TAN_CLAMP = 1.3  # view-cone clamp multiplier on tan(fov)


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterization settings.

    Attributes:
      tile_size: pixel tile edge, any positive size. Up to 64 one CUDA
        thread block composites one tile, each thread owning one pixel
        (two or four above 1024 pixels); a larger tile is cut into pixel
        groups of at most 64 a side, one thread block each.
      chunk_size: pairs whose alphas the plain version evaluates at once.
      pair_block: pairs per block of the early-stop test (it runs once
        per block), and the alignment of every tile's pair segment (binning
        pads segments to a multiple of it). The kernels stage a block in
        shared memory in sub-batches of at most 256 rows. Must be a
        multiple of ``chunk_size``.
      max_pairs: capacity of the (tile, gaussian) pair buffer. Overflow
        drops the deepest whole gaussians and is reported by
        ``binning_stats``.
      sh_degree: spherical-harmonics degree for view-dependent color (0-3).
      early_stop_transmittance: if > 0, a tile stops once the transmittance
        of every coverable pixel is below this (checked per pair block).
        The reference has no early stop, so parity runs use 0.0.
      strict_parity: skip gaussians where *any* conic coefficient is zero,
        as the reference does (rasterize.py:441).
      exact_grad_reduction: the unsliced backward sums each gaussian's
        per-pair gradient rows exactly (an f64 sorted cumsum differenced at
        the segment ends, rounded to f32 once), ahead of any compaction, as
        the JAX package's exact segment sum; deterministic, so bitwise
        repeatable on the card. False: the f32 sorted cumsum (about 1e-5 of
        the gradient scale). The sliced path ignores it, as JAX's does.
      reduce_pairs: pair capacity of the compacted gradient reduction (0 =
        off). With early stop the forward composites only a few percent of
        the pair blocks at real-scene density; the backward then gathers
        just the blocks it wrote into a buffer of at most this many pairs
        and reduces those. When a frame's composited blocks exceed it, the
        full reduction runs instead (exact either way).
      slice_pairs: depth-sliced rendering (``render/sliced.py``; 0 = the
        single-sort pipeline): pairs are binned and composited in
        front-to-back depth slices of this many pairs (a ``pair_block``
        multiple, and at least the frame's tile count), stopping once every
        tile's transmittance is below ``early_stop_transmittance``. At most
        ``ceil(max_pairs / slice_pairs)`` slices run.
    """

    tile_size: int = 32
    chunk_size: int = 32
    pair_block: int = 128
    max_pairs: int = 1 << 20
    sh_degree: int = 3
    early_stop_transmittance: float = 0.0
    strict_parity: bool = True
    exact_grad_reduction: bool = False
    reduce_pairs: int = 0
    slice_pairs: int = 0

    def __post_init__(self):
        if self.slice_pairs > 0 and self.slice_pairs % self.pair_block != 0:
            raise ValueError(
                f"slice_pairs ({self.slice_pairs}) must be a multiple of "
                f"pair_block ({self.pair_block})"
            )
        if self.pair_block % self.chunk_size != 0:
            raise ValueError(
                f"pair_block ({self.pair_block}) must be a multiple of "
                f"chunk_size ({self.chunk_size})"
            )

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_size * self.tile_size


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """Adaptive density control (the 3DGS clone/split/prune recipe) on a
    fixed-capacity gaussian pool (``train/densify.py``): pruned slots become
    inert (opacity collapsed, so they emit no pairs) and later clones and
    splits reuse them.

    Attributes:
      every/start/until: run the densify+prune pass every ``every`` steps
        within [start, until).
      grad_threshold: mean viewspace positional-gradient norm (NDC scale, the
        3DGS convention: the pixel-space probe is rescaled by 0.5*W/H in
        ``densify.accumulate``) above which a gaussian is densified. The mean
        is over the steps in which the gaussian received any gradient.
      min_opacity: activated opacity below which a gaussian is pruned.
      prune_scale_extent: world-space size prune: a gaussian whose largest
        scale exceeds this fraction of the scene extent is pruned (3DGS's
        ``big_points_ws``).
      max_screen_size: screen-space size prune: a gaussian whose largest
        projected radius over the accumulation window exceeds this many
        pixels is pruned (3DGS's ``big_points_vs``). 0 disables both
        size-prune criteria.
      size_prune_start: step at which the two size-prune criteria engage.
      percent_dense: scale cutoff (fraction of the camera extent) separating
        clone (small splat) from split (large splat).
      split_factor: scale shrink for split gaussians.
      opacity_reset_every: clamp opacity to <= 0.01 at this cadence
        (0 = never).
      pool_factor: pool capacity = pool_factor * initial gaussian count.
    """

    every: int = 100
    start: int = 100
    until: int = 1 << 30
    grad_threshold: float = 2e-4
    min_opacity: float = 0.005
    prune_scale_extent: float = 0.1
    max_screen_size: float = 20.0
    size_prune_start: int = 3000
    percent_dense: float = 0.01
    split_factor: float = 1.6
    opacity_reset_every: int = 0
    pool_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training / fine-tuning settings (the 3DGS recipe).

    Attributes:
      lr_means, lr_scales, lr_quats, lr_opacity, lr_sh: Adam learning rate
        of each parameter.
      lr_means_final, lr_means_decay_steps: the 3DGS position schedule,
        log-linear decay of ``lr_means`` to ``lr_means_final`` over that
        many optimizer updates, clamped there after (0 steps = constant).
      ssim_weight: loss = (1-w)*L1 + w*(1-SSIM).
      background: "black", "white" or "random" (a fresh colour every step);
        the render is composited onto it through its transmittance.
      steps, log_every, checkpoint_every: loop length and cadences.
      densify: adaptive density control (None = a fixed set of gaussians).
      sh_warmup_every: train with SH degree ``min(step // this, degree)``
        (0 = full degree from step 0).
    """

    lr_means: float = 1.6e-4
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 5e-2
    lr_sh: float = 2.5e-3
    lr_means_final: float = 0.0
    lr_means_decay_steps: int = 0
    ssim_weight: float = 0.2
    background: str = "black"
    steps: int = 1000
    log_every: int = 50
    checkpoint_every: int = 500
    densify: Optional[DensifyConfig] = None
    sh_warmup_every: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout, axes data (camera batch) x tile (framebuffer
    tiles); one process (rank) per mesh position (``parallel/mesh.py``)."""

    data: int = 1
    tile: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.tile
