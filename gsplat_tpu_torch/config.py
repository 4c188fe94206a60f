"""Configuration of the PyTorch port: the reference constants and the
rasterization settings.

Mirrors ``gsplat_tpu/config.py``. The kernel/plain choice is not a setting
here: every rasterizer call dispatches on the device of its tensors (a CUDA
tensor launches the hand-written kernel, a CPU tensor takes its plain
PyTorch version), so ``use_pallas`` and ``force_pallas_interpret`` have no
counterpart.
"""

from __future__ import annotations

import dataclasses

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
      tile_size: pixel tile edge; one CUDA thread block of
        ``tile_size**2`` threads composites one tile.
      chunk_size: pairs whose alphas the plain version evaluates at once.
      pair_block: pairs per batch the kernel stages in shared memory, and
        the alignment of every tile's pair segment (binning pads segments
        to a multiple of it). The early-stop test runs once per batch.
        Must be a multiple of ``chunk_size``.
      max_pairs: capacity of the (tile, gaussian) pair buffer. Overflow
        drops the deepest whole gaussians and is reported by
        ``binning_stats``.
      sh_degree: spherical-harmonics degree for view-dependent color (0-3).
      early_stop_transmittance: if > 0, a tile stops once the transmittance
        of every coverable pixel is below this (checked per pair block).
        The reference has no early stop, so parity runs use 0.0.
      strict_parity: skip gaussians where *any* conic coefficient is zero,
        as the reference does (rasterize.py:441).
      slice_pairs: depth-sliced rendering; not ported yet, must be 0.
    """

    tile_size: int = 32
    chunk_size: int = 32
    pair_block: int = 128
    max_pairs: int = 1 << 20
    sh_degree: int = 3
    early_stop_transmittance: float = 0.0
    strict_parity: bool = True
    slice_pairs: int = 0

    def __post_init__(self):
        if self.slice_pairs > 0:
            raise NotImplementedError(
                "slice_pairs > 0 (the depth-sliced path) is not ported yet; "
                "use slice_pairs=0"
            )
        if self.pair_block % self.chunk_size != 0:
            raise ValueError(
                f"pair_block ({self.pair_block}) must be a multiple of "
                f"chunk_size ({self.chunk_size})"
            )

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_size * self.tile_size
