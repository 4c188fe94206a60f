"""Quaternion utilities (batched).

Parity target: reference ``rasterize.py:41-56`` (quaternion -> rotation
matrix, w-first convention) and the L2 normalization of learned quaternions
at ``rasterize.py:112``.
"""

from __future__ import annotations

import torch


def normalize_quaternion(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """L2-normalize quaternions along the last axis, with the norm clamped at
    ``max(eps, 1e-12)`` (torch's ``F.normalize`` default the reference uses)."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / norm.clamp(min=max(eps, 1e-12))


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions ``[..., 4]`` (w, x, y, z) -> ``[..., 3, 3]`` rotation
    matrices (reference rasterize.py:41-56)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1
    )
    row1 = torch.stack(
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1
    )
    row2 = torch.stack(
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)
