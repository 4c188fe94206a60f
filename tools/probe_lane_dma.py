#!/usr/bin/env python3
"""Lane-slice DMA probe of the PyTorch port on a CUDA card: the counterpart
of ``scripts/probe_lane_dma.py`` for ``gsplat_tpu_torch``.

The TPU probe asked whether a kernel can DMA ``[16, 128]`` lane slices of a
``[16, M]`` array in HBM at dynamic, 128-aligned offsets (scalar-prefetched
starts), double them in VMEM and DMA them back. Here the same function
(``gsplat_tpu_torch.kernels.probes.lane_dma``, the kernel in
``gsplat_tpu_torch/csrc/probe_lane_dma.cu``) copies each slice with the
Tensor Memory Accelerator: a 2-D tensor map over the array, one
``cp.async.bulk.tensor`` load on an mbarrier and one TMA store a block, each
block reading its start from device memory. The probe's inputs:
``np.random.RandomState(0).randn(16, 512)`` and starts ``256, 0, 384, 128``.

One JSON line: the TPU probe's check (``bitwise_equal``: the output is
``2 * x``; the TPU probe checked ``allclose``, and doubling is exact), the
kernel against its plain version (``plain_bitwise_equal`` and
``max_abs_err``), and on the card the kernel's, the plain version's and
``x * 2``'s milliseconds (``x * 2`` computes the same function here because
the starts cover every column), the least time the card needs for the bytes
moved, and the card's ``nvidia-smi`` name and power limit. Each time is
that of ``ITERS`` calls captured in a CUDA graph after ``WARMUP`` calls,
replayed between two CUDA events, over ``ITERS`` (``card.graph_ms``):
device time with no host work in it (the wrapper copies the starts to the
card at its first call with them, before the capture). Exit status 1 if a
check fails::

    python3 tools/probe_lane_dma.py                 # on the card
    python3 tools/probe_lane_dma.py --device cpu    # the plain version

Without a card and without ``--device cpu`` it raises. This script imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import card  # noqa: E402
from gsplat_tpu_torch.kernels import probes as P  # noqa: E402
from gsplat_tpu_torch.utils.device import resolve_device  # noqa: E402

WARMUP, ITERS = 3, 10
M = 512
STARTS = (256, 0, 384, 128)  # dynamic, 128-aligned (the TPU probe's)


def probe_lane_dma(dev) -> dict:
    """The probe of ``scripts/probe_lane_dma.py`` on ``dev``: one record (one
    launch, then ``WARMUP + ITERS`` on the card)."""

    def timed_ms(fn):
        return card.graph_ms(fn, ITERS, WARMUP) if dev.type == "cuda" else None

    smi = card.nvidia_smi_line() if dev.type == "cuda" else None
    x = torch.from_numpy(np.random.RandomState(0).randn(P.SLAB[0], M).astype(np.float32)).to(dev)
    got, want = P.lane_dma(x, STARTS), P.lane_dma_plain(x, STARTS)
    bitwise = bool(torch.equal(got, x * 2.0))
    plain_bitwise = bool(torch.equal(got, want))
    nbytes = 2 * len(STARTS) * P.SLAB[0] * P.SLAB[1] * 4 + 4 * len(STARTS)  # slices in and out, the starts
    return {
        "probe": "2D dynamic lane-offset DMA", "kernel": "lane_dma", "device": dev.type, "nvidia_smi": smi,
        "shape": list(got.shape), "starts": list(STARTS), "bitwise_equal": bitwise,
        "plain_bitwise_equal": plain_bitwise, "max_abs_err": (got - want).abs().max().item(),
        "ok": bitwise and plain_bitwise, "ms": timed_ms(lambda: P.lane_dma(x, STARTS)), "plain_ms": timed_ms(lambda: P.lane_dma_plain(x, STARTS)),
        "library_ms": timed_ms(lambda: x * 2.0), "bytes": nbytes,
        "bound_ms": nbytes / card.PEAK_HBM_BYTES * 1e3, "bound_by": "bytes",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    rec = probe_lane_dma(resolve_device(args.device))
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
