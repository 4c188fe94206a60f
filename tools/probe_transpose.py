#!/usr/bin/env python3
"""Transpose probes of the PyTorch port on a CUDA card: the counterpart of
``scripts/probe_transpose.py`` for ``gsplat_tpu_torch``.

The TPU probe asked whether Mosaic lowers the in-kernel transposes a
column-major pair slab needs, and measured an exact transpose on the MXU
beside them. Here each of its kernels is a hand-written CUDA kernel
(``gsplat_tpu_torch/csrc/probe_transpose.cu``, wrappers in
``gsplat_tpu_torch/kernels/probes.py``), run on the probe's own inputs
(``np.random.RandomState(0..2).randn``):

* ``t1``: ``[16, 128] -> [128, 16]`` through shared memory
  (``transpose_smem``), bitwise ``x.T``;
* ``mxu``: ``eye(128) . x^T`` on the tensor cores (``transpose_mma``), in
  TF32 rounded once (``mode`` ``tf32``: bitwise x rounded to TF32, off
  ``x.T`` by up to 2^-11 relative) and as three TF32 parts (``3xtf32``:
  bitwise ``x.T``);
* ``t2``: ``[128, 16] -> [16, 128]`` (``transpose_smem``);
* ``dma``: four ``[16, 128]`` slabs, each brought into shared memory by one
  bulk copy on an mbarrier and written transposed
  (``transpose_block_async``).

One JSON line a probe: the TPU probe's check (``bitwise_equal``), the
kernel against its plain version (``plain_bitwise_equal``, bitwise in every
mode, and ``max_abs_err``), and on the card the kernel's, the plain
version's and the library call's milliseconds, the least time the card
needs for the bytes moved, and the card's ``nvidia-smi`` name and power
limit. The kernels take microseconds, less than the host takes to call
them, so each time is that of ``ITERS`` calls captured in a CUDA graph after
``WARMUP`` calls, replayed between two CUDA events, over ``ITERS``
(``chip_smoke.graph_ms``): device time with no host work in it. Exit status
1 if a check fails::

    python3 tools/probe_transpose.py                 # on the card
    python3 tools/probe_transpose.py --device cpu    # the plain versions

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

import chip_smoke  # noqa: E402
from gsplat_tpu_torch.kernels import probes as P  # noqa: E402
from gsplat_tpu_torch.utils.device import resolve_device  # noqa: E402

WARMUP, ITERS = 3, 10
NBLK = 4  # slabs of the block probe (the TPU probe's grid)
PEAK_TF32_OPS = 495e12  # dense TF32 on the tensor cores (NVIDIA's H100 SXM data sheet)


def timed_ms(fn, dev) -> float | None:
    """Device milliseconds of one ``fn()`` (``chip_smoke.graph_ms`` of
    ``ITERS`` calls after ``WARMUP``); None (not measured) off the card."""
    return chip_smoke.graph_ms(fn, ITERS, WARMUP) if dev.type == "cuda" else None


def probe_record(name, wrapper, run, expected, plain, library, nbytes: int, dev, smi, ops: float = 0.0,
                 exact: bool = True, **extra) -> dict:
    """Run one probe: its output against the TPU probe's expectation and the
    plain version, then the times (kernel, plain, library) and the bound
    (``nbytes`` over the memory rate, ``ops`` over the TF32 rate): one
    launch, then ``WARMUP + ITERS`` on the card. ``exact``: the TPU probe's
    check must hold too (not for one-pass TF32)."""
    got, want = run(), plain()
    bitwise = bool(torch.equal(got, expected))
    plain_bitwise = bool(torch.equal(got, want))
    bytes_ms = nbytes / chip_smoke.PEAK_HBM_BYTES * 1e3
    ops_ms = ops / PEAK_TF32_OPS * 1e3
    return {
        "probe": name, "kernel": wrapper.__name__, "device": dev.type, "nvidia_smi": smi, "shape": list(got.shape),
        "bitwise_equal": bitwise, "max_rel_err": ((got - expected).abs() / expected.abs()).max().item(),
        "plain_bitwise_equal": plain_bitwise, "max_abs_err": (got - want).abs().max().item(),
        "ok": plain_bitwise and (bitwise or not exact), **extra,
        "ms": timed_ms(run, dev), "plain_ms": timed_ms(plain, dev),
        "library_ms": None if library is None else timed_ms(library, dev),
        "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def probe_transposes(dev) -> list:
    """Every probe of ``scripts/probe_transpose.py`` on ``dev``, in its
    order; one record each."""
    smi = chip_smoke.nvidia_smi_line() if dev.type == "cuda" else None

    def tensor(seed, shape):
        return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(dev)

    x, y, xb = tensor(0, P.SLAB), tensor(1, P.SLAB[::-1]), tensor(2, (NBLK, *P.SLAB))
    slab_bytes = 2 * x.numel() * 4
    records = [probe_record("t1 transpose 16x128->128x16", P.transpose_smem, lambda: P.transpose_smem(x), x.t(),
                            lambda: P.transpose_plain(x), lambda: x.t().contiguous(), slab_bytes, dev, smi)]
    for mode, split3 in (("tf32", False), ("3xtf32", True)):
        records.append(probe_record(
            f"mxu eye-transpose ({mode})", P.transpose_mma, lambda s=split3: P.transpose_mma(x, s), x.t(),
            lambda s=split3: P.transpose_mma_plain(x, s), (lambda: x.t().contiguous()) if split3 else None,
            slab_bytes, dev, smi, ops=(3 if split3 else 1) * 2.0 * 128 * 128 * 16, exact=split3, mode=mode))
    records.append(probe_record("t2 transpose 128x16->16x128", P.transpose_smem, lambda: P.transpose_smem(y), y.t(),
                                lambda: P.transpose_plain(y), lambda: y.t().contiguous(), slab_bytes, dev, smi))
    records.append(probe_record("dma block + transpose", P.transpose_block_async, lambda: P.transpose_block_async(xb),
                                xb.transpose(1, 2), lambda: P.transpose_block_plain(xb),
                                lambda: xb.transpose(1, 2).contiguous(), NBLK * slab_bytes, dev, smi, nblk=NBLK))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    records = probe_transposes(resolve_device(args.device))
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0 if all(rec["ok"] for rec in records) else 1


if __name__ == "__main__":
    sys.exit(main())
