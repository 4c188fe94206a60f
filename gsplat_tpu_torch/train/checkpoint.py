"""Checkpointing: Inria-layout PLY export and import, and the training
loop's full state for resumable runs.

  * :func:`save_ply_checkpoint` / :func:`load_ply_checkpoint` write and read
    ``<dir>/point_cloud/iteration_{k}/point_cloud.ply`` in the Inria field
    layout, byte for byte as the JAX package writes it, so either package
    loads the other's checkpoints;
  * :func:`save_train_state` / :func:`restore_train_state` keep the model,
    the optimizer state and the step in one ``torch.save`` file (the JAX
    package uses orbax; the two formats are not interchangeable). Only
    tensors, numbers, strings, lists and dicts are stored, so the file loads
    with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from gsplat_tpu_torch.io.ply import load_splat_arrays, save_splat_arrays
from gsplat_tpu_torch.io.scene import checkpoint_ply_path
from gsplat_tpu_torch.models.gaussians import PARAM_NAMES, GaussianModel
from gsplat_tpu_torch.utils.device import resolve_device


def save_ply_checkpoint(model_dir: str, model: GaussianModel, iteration: int) -> str:
    """Write the model as ``<dir>/point_cloud/iteration_{k}/point_cloud.ply``."""
    path = checkpoint_ply_path(model_dir, iteration)
    save_splat_arrays(path, model.to_arrays())
    return path


def load_ply_checkpoint(model_dir: str, iteration: int = 30000, device="cuda") -> GaussianModel:
    return GaussianModel.from_arrays(load_splat_arrays(checkpoint_ply_path(model_dir, iteration)), device=device)


def save_train_state(
    path: str, model: GaussianModel, optimizer: torch.optim.Optimizer, step: int, extras: Optional[dict] = None
) -> None:
    """Persist (model parameters, optimizer state, step) at ``path``.

    ``step`` is the next step to run on resume. ``extras``: a dict of
    further tensors and numbers (the trainer keeps the densify state
    there). The file is written beside ``path`` and renamed over it, so an
    interrupted save leaves the previous state whole."""
    payload = {
        "model": {k: getattr(model, k).detach() for k in PARAM_NAMES},
        "optimizer": optimizer.state_dict(),
        "step": int(step),
        "extras": extras if extras is not None else {},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_train_state(
    path: str,
    make_optimizer: Optional[Callable[[GaussianModel], torch.optim.Optimizer]] = None,
    with_extras: bool = False,
    device="cuda",
):
    """Restore :func:`save_train_state` output onto ``device``. Returns
    (model, optimizer, step) or, with ``with_extras``, (model, optimizer,
    step, extras).

    With ``make_optimizer`` (model -> a fresh optimizer over its
    parameters, e.g. ``Trainer.init_state``) the optimizer is rebuilt and
    loaded with the saved state (moments, steps and each group's settings,
    the means' schedule count among them); without it the saved state dict
    is returned in its place."""
    dev = resolve_device(device)
    # Loaded on the host: the optimizer moves each moment to its parameter's
    # device and keeps Adam's step counts on the host, where a fresh Adam
    # keeps them (a step count on the card costs a host sync per update).
    saved = torch.load(path, map_location="cpu", weights_only=True)
    model = GaussianModel(*(saved["model"][k].to(dev) for k in PARAM_NAMES))
    optimizer = saved["optimizer"]
    if make_optimizer is not None:
        state = optimizer
        optimizer = make_optimizer(model)
        optimizer.load_state_dict(state)
    if with_extras:
        return model, optimizer, saved["step"], saved["extras"]
    return model, optimizer, saved["step"]


# ---- The trainer's loop state (Trainer.fit with checkpoint_dir / resume) ----

TRAIN_STATE_FILE = "train_state.pt"


def loop_state_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, TRAIN_STATE_FILE)


def save_loop_state(
    checkpoint_dir: str,
    model: GaussianModel,
    optimizer: torch.optim.Optimizer,
    next_step: int,
    dstate=None,
    generator: Optional[torch.Generator] = None,
) -> str:
    """Persist a trainer's full loop state at ``<dir>/train_state.pt``: the
    model (the pool model when densifying), the optimizer state, the next
    step to run and, when densifying, the viewspace-gradient accumulator
    and the state of the densify generator, so that a resumed run replays
    the same trajectory."""
    extras = {}
    if dstate is not None:
        extras["densify"] = {**dstate._asdict(), "generator": generator.get_state()}  # the state: a uint8 tensor
    path = loop_state_path(checkpoint_dir)
    save_train_state(path, model, optimizer, next_step, extras)
    return path


def has_loop_state(checkpoint_dir: str) -> bool:
    return os.path.isfile(loop_state_path(checkpoint_dir))


def restore_loop_state(checkpoint_dir: str, make_optimizer, device="cuda"):
    """Restore :func:`save_loop_state` output. ``make_optimizer``: model ->
    a fresh optimizer over its parameters. Returns (model, optimizer,
    next_step, densify state or None, generator or None); the generator
    lives on ``device``."""
    from gsplat_tpu_torch.train.densify import DensifyState

    model, optimizer, step, extras = restore_train_state(
        loop_state_path(checkpoint_dir), make_optimizer, with_extras=True, device=device
    )
    dstate = generator = None
    if "densify" in extras:
        d = extras["densify"]
        dev = model.means.device
        dstate = DensifyState(*(d[k].to(dev) for k in DensifyState._fields))
        generator = torch.Generator(device=dev)
        generator.set_state(d["generator"])
    return model, optimizer, step, dstate, generator
