"""Device resolution for the port's factories.

Entry points run on the card unless the caller asks for the CPU: a factory
defaults to ``device="cuda"`` and raises when no card is present instead of
quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no CUDA
    device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
