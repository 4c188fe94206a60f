"""The ranks of a mesh cell (``steps/mesh_train.py``) and the step each of
them builds.

The benchmark's process is rank 0, on the device ``run.py`` gives it. The
other ranks are started here by ``spawn``, one card each (rank k on
``cuda:k``, over NCCL), or on the CPU over gloo, and meet rank 0 over a
file store in a temporary directory. Each peer then follows rank 0's
commands, one pipe a peer: build the step for a configuration (the
parameters arrive by broadcast from rank 0), run the step at a pose, stop.
A step's command is a few bytes on the host, so rank 0 sends it without
waiting on its device.

The world outlives one ``loops.Program`` (the calibration sets up a cell
once a seed in one process) and is closed when the process exits, or by
:func:`close`: the peers are told to stop, and every rank leaves the
process group at once. A lost rank ends the run with an error, never a
hang: a collective that waits longer than ``TIMEOUT`` fails, a peer that
fails or whose pipe closes exits, and rank 0 exits with an error where its
world does not close cleanly.
"""

from __future__ import annotations

import atexit
import datetime
import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Optional

import torch

TIMEOUT = datetime.timedelta(seconds=120)
CLOSE_SECONDS = 60.0
PROBE_PAIRS = 1 << 20  # the capacity of the set-up's demand probe (loops.Program's)


def _key(config: dict, device) -> tuple:
    return torch.device(device).type, config["mesh"]["data"], config["mesh"]["tile"]


class MeshStep:
    """One rank's update-free step of ``make_parallel_train_step`` for a
    configuration and a traffic mix: the pair capacity a shard is sized to,
    from the largest shard demand at each pose (``demand``), and a call at
    a pose that returns (grads, frame, loss). Every rank builds it, in the
    same order, since the demand probe's collectives pair up."""

    def __init__(self, mesh, model, config: dict, traffic: dict, device):
        import gsplat_tpu_torch as gs
        from gsplat_tpu_torch.parallel import make_parallel_train_step, make_sharded_binning_stats

        from splatbench import scene

        width, height = config["width"], config["height"]
        cams = [gs.CameraArrays.from_params(scene.camera_params(width, height, *p), device=device)
                for p in scene.poses(traffic)]
        probe = gs.RasterConfig(tile_size=config["tile_size"], chunk_size=config["chunk_size"],
                                max_pairs=PROBE_PAIRS, sh_degree=config["sh_degree"])
        stats = make_sharded_binning_stats(mesh, width, height, probe)
        with torch.no_grad():
            self.demand = [int(stats(model, c)["max_shard_demand"]) for c in cams]
        capacity = max(int(max(self.demand) * config["capacity_headroom"]) // 128 * 128, config["capacity_floor"])
        self.cfg = gs.RasterConfig(
            tile_size=config["tile_size"], chunk_size=config["chunk_size"], pair_block=config["pair_block"],
            max_pairs=capacity, sh_degree=config["sh_degree"], early_stop_transmittance=config["early_stop"],
            slice_pairs=config["slice_pairs"], reduce_pairs=config["reduce_pairs"],
        )
        step, _, prepare_targets = make_parallel_train_step(
            mesh, width, height, self.cfg, gs.TrainConfig(ssim_weight=traffic["ssim_weight"]))
        self.model, self._step = model, step
        self.cams = [gs.CameraArrays.stack([c]) for c in cams]
        self.targets = prepare_targets(torch.full((1, height, width, 3), traffic["target"], device=device))

    def __call__(self, pose: int):
        grads, frames, metrics = self._step(self.model, None, self.cams[pose], self.targets)
        return grads, frames[0], metrics["loss"]


def _model(config: dict, device):
    """A model of the configuration's shape, to be overwritten by rank 0's
    broadcast."""
    import gsplat_tpu_torch as gs

    n = config["n_gaussians"]
    shapes = ((n, 3), (n, 3), (n, 4), (n,), (n, 16, 3))
    return gs.GaussianModel(*(torch.empty(s, device=device) for s in shapes))


def _join(rank: int, ranks: int, config: dict, device_type: str, store: str):
    """This process's place in the world: (mesh, device)."""
    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.parallel import initialize_distributed, make_mesh

    if device_type == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)  # nccl: rank k on card k
    dev = initialize_distributed(device=device_type, init_method=f"file://{store}", rank=rank, world_size=ranks,
                                 timeout=TIMEOUT)
    return make_mesh(gs.MeshConfig(**config["mesh"])), dev


def _peer(rank: int, ranks: int, config: dict, device_type: str, store: str, conn) -> None:
    """A peer's life: join, then follow rank 0's commands until ``stop``,
    and leave the group as rank 0 leaves it (NCCL's teardown pairs up
    across the ranks). A peer that fails, or whose pipe closes, exits at
    once."""
    import torch.distributed as dist

    from gsplat_tpu_torch.parallel import replicated

    torch.set_num_threads(1)
    try:
        mesh, dev = _join(rank, ranks, config, device_type, store)
        step = None
        while True:
            cmd, arg = conn.recv()
            if cmd == "stop":
                break
            if cmd == "prepare":
                step = None
                config, traffic = arg
                model = replicated(mesh, _model(config, dev))
                step = MeshStep(mesh, model, config, traffic, dev)
            else:
                step(arg)
    except BaseException as exc:
        if not isinstance(exc, EOFError):
            traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


class World:
    """Rank 0's side of the world: the peers and their pipes."""

    def __init__(self, config: dict, device):
        device = torch.device(device)
        self.key = _key(config, device)
        ranks = config["mesh"]["data"] * config["mesh"]["tile"]
        if device.type == "cuda" and torch.cuda.device_count() < ranks:
            raise RuntimeError(f"a {ranks}-rank mesh takes {ranks} cards, one a rank; "
                               f"{torch.cuda.device_count()} visible")
        self.dir = tempfile.mkdtemp(prefix="splatbench-mesh-")
        store = os.path.join(self.dir, "store")
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        for r in range(1, ranks):
            mine, theirs = ctx.Pipe()
            proc = ctx.Process(target=_peer, args=(r, ranks, config, device.type, store, theirs), daemon=True)
            proc.start()
            theirs.close()
            self.conns.append(mine)
            self.procs.append(proc)
        self.mesh, _ = _join(0, ranks, config, device.type, store)

    def send(self, cmd: str, arg=None) -> None:
        for conn in self.conns:
            conn.send((cmd, arg))

    def prepare(self, model, config: dict, traffic: dict, device) -> MeshStep:
        """Every rank's step for ``config`` and ``traffic``, from rank 0's
        ``model``; returns rank 0's."""
        from gsplat_tpu_torch.parallel import replicated

        self.send("prepare", (config, traffic))
        return MeshStep(self.mesh, replicated(self.mesh, model), config, traffic, device)

    def close(self) -> bool:
        """Stop the peers and leave the group with them. Returns whether
        every rank left it: False where a peer had gone or the teardown ran
        past ``CLOSE_SECONDS``."""
        import torch.distributed as dist

        t = time.perf_counter()
        clean = all(proc.is_alive() for proc in self.procs)
        for conn in self.conns:
            try:
                conn.send(("stop", None))
            except OSError:  # the peer has gone
                clean = False
        if clean and dist.is_initialized():
            # At once with the peers': a rank that waits for the others to
            # exit first waits for ever.
            leave = threading.Thread(target=dist.destroy_process_group, daemon=True)
            leave.start()
            leave.join(CLOSE_SECONDS)
            clean = not leave.is_alive()
        for proc in self.procs:
            proc.join(CLOSE_SECONDS)
            if proc.is_alive():
                proc.kill()
                proc.join(10)
                clean = False
        shutil.rmtree(self.dir, ignore_errors=True)
        print(f"splatbench: the mesh's {len(self.procs) + 1} ranks left {'' if clean else 'un'}cleanly in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
        return clean


_world: Optional[World] = None


def world(config: dict, device) -> World:
    """The running world for ``config``'s mesh on ``device``'s kind, started
    on first use."""
    global _world
    if _world is not None and _world.key != _key(config, device):
        close()
    if _world is None:
        if torch.device(device).type == "cuda":
            from gsplat_tpu_torch.kernels import build

            build.build(("raster_fwd", "raster_bwd", "preprocess", "loss"))  # once, before the peers load them
        _world = World(config, device)
    return _world


def close() -> bool:
    """Stop the peers and leave the process group, if a world runs; see
    :meth:`World.close`."""
    global _world
    if _world is None:
        return True
    w, _world = _world, None
    return w.close()


def _at_exit() -> None:
    """A process whose world did not leave cleanly exits at once, with an
    error: the group's teardown would wait on the ranks that are gone."""
    if not close():
        sys.stdout.flush()
        os._exit(1)


atexit.register(_at_exit)
