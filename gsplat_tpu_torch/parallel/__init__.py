"""Multi-GPU rendering and training over a (data x tile) mesh of ranks on
``torch.distributed``, the counterpart of ``gsplat_tpu.parallel``."""

from gsplat_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    TILE_AXIS,
    Mesh,
    initialize_distributed,
    make_mesh,
    replicated,
    single_device_mesh,
)
from gsplat_tpu_torch.parallel.shard import (
    ParallelTrainer,
    make_batch_render,
    make_parallel_train_step,
    make_sharded_binning_stats,
    make_sharded_render,
)

__all__ = [
    "DATA_AXIS",
    "TILE_AXIS",
    "Mesh",
    "ParallelTrainer",
    "initialize_distributed",
    "make_batch_render",
    "make_mesh",
    "make_parallel_train_step",
    "make_sharded_binning_stats",
    "make_sharded_render",
    "replicated",
    "single_device_mesh",
]
