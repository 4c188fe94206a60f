"""Collectives of the mesh path, over ``torch.distributed`` process groups.

Only ``all_gather``, ``all_reduce`` and ``broadcast`` are used: both the
NCCL and the gloo backends take CUDA tensors for those three.
``torch.distributed.nn``'s differentiable all-gather is not used, since its
backward needs a reduce-scatter, which gloo does not do on CUDA tensors.

While stages are recorded (``utils/stages.py``), the gather's backward is
the span ``gather_bwd``, and two counters note what a step moves, host
ints from shapes: ``gather_bytes``, the bytes each all-gather outputs, and
``reduce_bytes``, the bytes each summing all-reduce sums (the gather's
backward included).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gsplat_tpu_torch.utils import stages


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _AllGatherRows(torch.autograd.Function):
    """All-gather along dim 0 over a group, in group-rank order. The
    backward is the transpose of the gather: the cotangent of the whole is
    summed over the group, and this rank keeps the rows it contributed."""

    @staticmethod
    def forward(ctx, x, group):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.rows = group, x.shape[0]
        out = torch.cat(parts)
        stages.count("gather_bytes", _nbytes(out))
        return out

    @staticmethod
    def backward(ctx, grad):
        with stages.stage("gather_bwd"):
            grad = grad.contiguous().clone()
            stages.count("reduce_bytes", _nbytes(grad))
            dist.all_reduce(grad, group=ctx.group)
            start = dist.get_rank(ctx.group) * ctx.rows
            return grad[start : start + ctx.rows], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along dim 0 in
    group-rank order (every rank's ``x`` has the same shape);
    differentiable."""
    return _AllGatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place; returns ``x``."""
    stages.count("reduce_bytes", _nbytes(x))
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s elementwise maximum over ``group``, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x
