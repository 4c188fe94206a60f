"""The (data x tile) device mesh on ``torch.distributed``.

The counterpart of ``gsplat_tpu/parallel/mesh.py``. One process (rank) runs
each position of a ``data x tile`` grid, rank ``d * tile + t`` at row ``d``
and column ``t``:

  * ``data``: the camera batch is split over the rows (data parallelism);
  * ``tile``: the frame's tiles are split over the columns of one row; the
    ranks of a row also split the gaussians for the preprocess and
    all-gather the packed feature rows (``parallel/shard.py``).

The splat parameters are replicated: every rank holds the whole model, and
the gradients are summed over the world. The backend follows the device:
NCCL for CUDA tensors, one card per rank; gloo for CPU tensors. gloo also
takes CUDA tensors (staged through the host), which lets several ranks
share one card; a caller asks for that by naming ``backend="gloo"``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from gsplat_tpu_torch.config import MeshConfig
from gsplat_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
TILE_AXIS = "tile"

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``data x tile`` mesh and the process groups it
    talks over.

    Attributes:
      shape: ``{DATA_AXIS: data, TILE_AXIS: tile}``.
      data_index, tile_index: this rank's row and column.
      row_group: the ranks of this rank's row (one data index, every tile
        index): the tile axis's collectives.
      column_group: the ranks of this rank's column (one tile index, every
        data index): the data axis's collectives.
      world_group: every rank of the mesh.
    """

    shape: dict
    data_index: int
    tile_index: int
    row_group: object
    column_group: object
    world_group: object

    @property
    def rank(self) -> int:
        return self.data_index * self.shape[TILE_AXIS] + self.tile_index


def make_mesh(cfg: MeshConfig = MeshConfig()) -> Mesh:
    """This rank's ``cfg.data x cfg.tile`` mesh over the initialized world
    (:func:`initialize_distributed`), whose size must be
    ``cfg.num_devices``. Every rank must call it, in the same order as any
    other ``make_mesh``, since creating process groups is collective."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: call initialize_distributed() first")
    need, have = cfg.num_devices, dist.get_world_size()
    if have != need:
        raise ValueError(f"mesh {cfg} needs {need} devices, have {have}")
    rank = dist.get_rank()
    data_index, tile_index = divmod(rank, cfg.tile)
    # new_group is collective over the world: every rank creates every group.
    rows = [dist.new_group([d * cfg.tile + t for t in range(cfg.tile)]) for d in range(cfg.data)]
    columns = [dist.new_group([d * cfg.tile + t for d in range(cfg.data)]) for t in range(cfg.tile)]
    return Mesh(
        shape={DATA_AXIS: cfg.data, TILE_AXIS: cfg.tile},
        data_index=data_index,
        tile_index=tile_index,
        row_group=rows[data_index],
        column_group=columns[tile_index],
        world_group=dist.group.WORLD,
    )


def single_device_mesh() -> Mesh:
    return make_mesh(MeshConfig(data=1, tile=1))


@torch.no_grad()
def replicated(mesh: Mesh, model):
    """Broadcast ``model``'s parameters from rank 0 of the mesh, in place,
    so that every replica starts bitwise equal. Returns ``model``."""
    for p in model.parameters():
        dist.broadcast(p.data, 0, group=mesh.world_group)
    return model


def initialize_distributed(
    backend: Optional[str] = None,
    device="cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
    **kwargs,
) -> torch.device:
    """Join the process group, once per process, before :func:`make_mesh`.
    Returns this rank's device.

    The backend follows ``device``: ``nccl`` for ``cuda``, with this rank on
    card ``LOCAL_RANK`` (as ``torchrun`` sets it); ``gloo`` for ``cpu``.
    ``backend="gloo"`` with ``device="cuda"`` keeps every rank on the given
    card, so that ranks can share it. ``kwargs`` go to
    ``torch.distributed.init_process_group`` (``init_method``, ``rank``,
    ``world_size``, ``store``); without them the rendezvous is read from the
    environment ``torchrun`` sets, and a process started without it forms a
    world of one. Collectives that wait longer than ``timeout`` fail."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs device='cuda', got {device!r}")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank with LOCAL_RANK {local} has no card: {torch.cuda.device_count()} visible; "
                "nccl takes one card per rank (ranks that share a card need backend='gloo')"
            )
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    rendezvous = ("init_method", "store", "world_size")
    if not any(k in kwargs for k in rendezvous) and "WORLD_SIZE" not in os.environ:
        kwargs.update(store=dist.HashStore(), rank=0, world_size=1)
    try:
        dist.init_process_group(backend=backend, timeout=timeout, **kwargs)
    except Exception as exc:  # the rendezvous's own errors vary by store and backend
        raise RuntimeError(
            "torch.distributed.init_process_group failed — check the rendezvous "
            f"address, world size and rank: {exc}"
        ) from exc
    return dev
