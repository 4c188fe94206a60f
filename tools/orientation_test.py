#!/usr/bin/env python3
"""The compositor's inner loop in both orientations, on one SM of a CUDA
card: the counterpart of ``scripts/orientation_test.py`` for
``gsplat_tpu_torch``.

The TPU probe timed the forward compositor's chunk math on one 32x32 tile
in both vector-register orientations, 268,435,456 pair-pixels each:

* A, pairs in sequence (``REPS_A`` = 8192 chunks of 32 pairs of a
  ``[32, 128]`` block). Here one thread a pixel walks each chunk's staged
  rows through the compositors' own gate (``eval_pair`` of
  ``gsplat_tpu_torch/csrc/raster_common.cuh``): the port's orientation.
* B, pairs across lanes (``REPS_B`` = 2048 chunks of 128 pairs of a
  ``[16, 128]`` feature-major block). Here the 32 lanes of a warp hold 32
  pairs, with a shuffle scan for the transmittance and shuffle sums for the
  colour.

Both are one thread block of 1024 threads on one SM, as the TPU probe is one
grid step on one core (``gsplat_tpu_torch/csrc/probe_orientation.cu``,
wrappers ``orientation_a`` / ``orientation_b`` in
``gsplat_tpu_torch/kernels/probes.py``). They compute the TPU kernels'
function, with one more argument: the starting transmittance ``t0``. The
TPU kernels start from 0, so their output is zero; ``t0 = 1`` is a real
composite. Each orientation runs at three feature sets:

* ``jax``: the TPU probe's own inputs (``default_rng(0).uniform(0, 1)``),
  at ``t0 = 0``: the TPU kernels' function. Every bbox lies inside
  ``[0, 1)``, so no pair passes the gate, and the output must be zero.
* ``passing``: a seeded set whose splats lie inside the tile with the whole
  tile as bbox (``passing_features``), at ``t0 = 1``; ``passed_share`` is
  the share of pair-pixels that pass the gate, counted by the plain gate.
  T falls to 0 within the first chunks, after which every chunk adds 0.
* ``sparse``: a seeded set in which each pixel passes exactly one pair a
  chunk, at alpha 0.004-0.006 (``sparse_features``), at ``t0 = 1``. T stays
  above zero through the whole walk (5e-22 to 8e-17 after A's 8192 chunks), so
  every chunk moves the output, and T must be bitwise the plain version's
  (``trans_bitwise``).

One JSON line a run: the output against the plain version
(``max_abs_err``, within rtol 1e-5 / atol 1e-6 of it: the card's ``expf``
against PyTorch's ``exp``), the milliseconds (CUDA events, median of
``ITERS`` after ``WARMUP``) and nanoseconds a pair-pixel, the plain
version's milliseconds (at the passing set), and the least time one SM
needs: 19 FP32 operations a pair-pixel for the gate and 9 more a passed one
at the SM's share of ``PEAK_FP32_OPS`` (an FMA counts two), or the expf at
its share of ``PEAK_SFU_EXP``, whichever is longer (``bound_ms``), and the
operations at one instruction each (``instruction_bound_ms``: half that
rate; the gate rounds every product and sum on its own, no FMA). With the
card's ``nvidia-smi`` name and power limit. Exit status 1 if a check
fails::

    python3 tools/orientation_test.py                 # on the card
    python3 tools/orientation_test.py --device cpu    # the plain versions (minutes at full size)

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

REPS_A = 8192  # chunks of 32 pairs (the TPU probe's)
REPS_B = 2048  # chunks of 128 pairs (the same pairs in all)
WARMUP, ITERS = 1, 10
PLAIN_RUNS = 3  # timed plain runs (passing set)
RTOL, ATOL = 1e-5, 1e-6
SMS = 132  # an H100 SXM's streaming multiprocessors: the peaks are the card's, a kernel here has one
PASSING_SEED = 1
SPARSE_SEED = 2
FEATURE_SETS = ("jax", "passing", "sparse")


def jax_features(orientation: str) -> np.ndarray:
    """The TPU probe's block: ``default_rng(0).uniform(0, 1)`` of ``[32, 128]``
    (A) or ``[16, 128]`` (B), drawn afresh for each (``run``)."""
    shape = (P.PAIRS_A, 128) if orientation == "a" else (16, P.PAIRS_B)
    return np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)


def passing_features(orientation: str, seed: int = PASSING_SEED) -> np.ndarray:
    """A block whose pairs pass the gate at many pixels: means uniform in the
    tile, standard deviations of 2-8 pixels along each axis with a
    correlation in [-0.5, 0.5] (the conic is the covariance's inverse),
    opacity in [0.3, 1], rgb in [0, 1], bbox the whole tile. Laid out as the
    TPU probe's blocks: a pair a row of ``[32, 128]`` (A, zeros past feature
    15) or a pair a column of ``[16, 128]`` (B)."""
    n = P.PAIRS_A if orientation == "a" else P.PAIRS_B
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 16), np.float64)
    rows[:, 0:2] = rng.uniform(0, P.EDGE - 1, (n, 2))
    sx, sy = rng.uniform(2.0, 8.0, n), rng.uniform(2.0, 8.0, n)
    rho = rng.uniform(-0.5, 0.5, n)
    det = (sx * sy) ** 2 * (1 - rho**2)
    rows[:, 2], rows[:, 3], rows[:, 4] = sy**2 / det, sx**2 / det, -rho * sx * sy / det
    rows[:, 5] = rng.uniform(0.3, 1.0, n)
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    rows[:, 9:13] = (0.0, 0.0, P.EDGE, P.EDGE)
    rows = rows.astype(np.float32)
    if orientation == "b":
        return np.ascontiguousarray(rows.T)
    block = np.zeros((n, 128), np.float32)
    block[:, :16] = rows
    return block


def sparse_features(orientation: str, seed: int = SPARSE_SEED) -> np.ndarray:
    """A block in which each pixel of the tile lies in exactly one pair's
    bbox: in A pair k's bbox is row k of the tile, in B pair k's the 8
    pixels ``[8 (k % 4), 8 (k % 4) + 8)`` of row ``k // 4``. The bbox edges
    sit half a pixel off the pixels, so every chunk's scale (at most 1.0082)
    keeps the same pixels inside. Each splat is nearly flat over the tile
    (standard deviations of 150-300 pixels, correlation in [-0.5, 0.5]),
    with opacity 0.0045-0.006, so that alpha at every pixel of its bbox is
    above the gate's 1/255: each pixel passes one pair a chunk. Laid out as
    :func:`passing_features`."""
    n = P.PAIRS_A if orientation == "a" else P.PAIRS_B
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 16), np.float64)
    rows[:, 0:2] = rng.uniform(0, P.EDGE - 1, (n, 2))
    sx, sy = rng.uniform(150.0, 300.0, n), rng.uniform(150.0, 300.0, n)
    rho = rng.uniform(-0.5, 0.5, n)
    det = (sx * sy) ** 2 * (1 - rho**2)
    rows[:, 2], rows[:, 3], rows[:, 4] = sy**2 / det, sx**2 / det, -rho * sx * sy / det
    rows[:, 5] = rng.uniform(0.0045, 0.006, n)
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    k = np.arange(n)
    if orientation == "a":
        x0, y0, width = np.zeros(n), k, P.EDGE
    else:
        x0, y0, width = 8 * (k % 4), k // 4, 8
    rows[:, 9], rows[:, 10], rows[:, 11], rows[:, 12] = x0 - 0.5, y0 - 0.5, x0 + width - 0.5, y0 + 0.5
    rows = rows.astype(np.float32)
    if orientation == "b":
        return np.ascontiguousarray(rows.T)
    block = np.zeros((n, 128), np.float32)
    block[:, :16] = rows
    return block


def features_block(orientation: str, features: str) -> np.ndarray:
    """The block of one of ``FEATURE_SETS``."""
    return {"jax": jax_features, "passing": passing_features, "sparse": sparse_features}[features](orientation)


def transmittance(out: torch.Tensor, orientation: str) -> torch.Tensor:
    """The T row of an orientation kernel's output (``[8, 1024]`` for A,
    ``[1024, 8]`` for B)."""
    return out[3] if orientation == "a" else out[:, 3]


def one_sm_bound(pair_pixels: int, passed: int) -> dict:
    """One SM's least time for the walk: the gate at every pair-pixel and the
    compositing at every passed one, against its expf."""
    ops = pair_pixels * card.GATE_OPS + passed * card.FWD_PASSED_OPS
    fp32_ms = ops / (card.PEAK_FP32_OPS / SMS) * 1e3
    sfu_ms = pair_pixels / (card.PEAK_SFU / SMS) * 1e3
    return {"fp32_ops": ops, "fp32_ms": fp32_ms, "sfu_ms": sfu_ms, "bound_ms": max(fp32_ms, sfu_ms),
            "bound_by": "operations", "instruction_bound_ms": max(2 * fp32_ms, sfu_ms)}


def orientation_run(orientation: str, features: str, reps: int, dev, smi) -> dict:
    """One orientation at one feature set: one launch checked against the
    plain version (zero at ``t0 = 0``; for the sparse set T bitwise, above
    zero, and one passed pair a pixel a chunk), then ``WARMUP + ITERS`` timed
    launches on the card."""
    wrapper, plain = ((P.orientation_a, P.orientation_a_plain) if orientation == "a"
                      else (P.orientation_b, P.orientation_b_plain))
    feat = torch.from_numpy(features_block(orientation, features)).to(dev)
    t0 = 0.0 if features == "jax" else 1.0
    got = wrapper(feat, reps, t0)
    want = plain(feat, reps, t0)
    pairs = reps * (P.PAIRS_A if orientation == "a" else P.PAIRS_B)
    pair_pixels = pairs * P.NPIX
    passed = P.orientation_passed(feat, reps, orientation)
    close = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
    zero = bool((got == 0).all()) if t0 == 0.0 else None
    trans = transmittance(got, orientation)
    sparse = features == "sparse"
    trans_bitwise = bool(torch.equal(trans, transmittance(want, orientation))) if sparse else None
    sparse_ok = not sparse or (trans_bitwise and passed == reps * P.NPIX and bool((trans > 0).all()))
    on_card = dev.type == "cuda"
    ms = card.cuda_ms(lambda: wrapper(feat, reps, t0), ITERS, WARMUP) if on_card else None
    plain_ms = card.cuda_ms(lambda: plain(feat, reps, t0), PLAIN_RUNS) if on_card and features == "passing" else None
    bound = one_sm_bound(pair_pixels, passed)
    return {
        "probe": f"{orientation.upper()} ({'pairs in sequence' if orientation == 'a' else 'pairs across lanes'})",
        "kernel": wrapper.__name__, "device": dev.type, "nvidia_smi": smi, "features": features, "t0": t0,
        "reps": reps, "pairs": pairs, "pair_pixels": pair_pixels, "passed_pair_pixels": passed,
        "passed_share": passed / pair_pixels if pair_pixels else 0.0, "shape": list(got.shape),
        "zero": zero, "plain_close": close, "max_abs_err": (got - want).abs().max().item(),
        "trans_bitwise": trans_bitwise, "trans_min": trans.min().item(), "trans_max": trans.max().item(),
        "ok": close and bool(torch.isfinite(got).all()) and zero is not False and sparse_ok,
        "ms": ms, "ns_per_pair_pixel": None if ms is None or not pair_pixels else ms * 1e6 / pair_pixels,
        "plain_ms": plain_ms, "library_ms": None, **bound,
        "share_of_bound": None if ms is None else bound["bound_ms"] / ms,
        "share_of_instruction_bound": None if ms is None else bound["instruction_bound_ms"] / ms,
    }


def orientation_runs(dev) -> list:
    """A (``REPS_A`` chunks) and B (``REPS_B``) at every feature set on
    ``dev``, one record each."""
    smi = card.nvidia_smi_line() if dev.type == "cuda" else None
    return [orientation_run(o, features, REPS_A if o == "a" else REPS_B, dev, smi)
            for o in ("a", "b") for features in FEATURE_SETS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    records = orientation_runs(resolve_device(args.device))
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0 if all(rec["ok"] for rec in records) else 1


if __name__ == "__main__":
    sys.exit(main())
