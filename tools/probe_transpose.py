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
mode, and ``max_abs_err``), and for ``t1``, ``mxu`` and ``t2`` the same at
every block of :func:`special_blocks` (``special_bitwise_equal``: inf, NaN,
signed zeros, subnormals, the smallest and largest normals, TF32 ties and,
for the shared-memory transpose, random 32-bit patterns; NaN positions
compared by ``isnan``, every other element by its bits), with 3xTF32
bitwise ``x.T`` at the blocks that hold only finite normal values
(``special_x_t_equal``). On the card each record has the kernel's, the
plain version's and the library call's milliseconds, the least time the
card needs for the bytes moved, and the card's ``nvidia-smi`` name and
power limit. The kernels take microseconds, less than the host takes to
call them, so each quantity is ``ITERS`` calls captured in a CUDA graph
after ``WARMUP`` calls (``card.capture_graph``), and the graphs of a
probe are replayed between two CUDA events in ``ROUNDS`` rounds, each
round in another order, so that no quantity always runs first; before each
timed replay the device spins ``QUEUE_SLEEP_CYCLES`` while the host
enqueues it (``card.replay_ms``), so the events time the calls'
kernels back to back (launch latency inside the graph, no host work):
``ms`` is the median over the rounds, ``ms_quartiles`` the first and third
quartile (likewise ``plain_ms``, ``library_ms``). Exit status 1 if a check
fails::

    python3 tools/probe_transpose.py                 # on the card
    python3 tools/probe_transpose.py --device cpu    # the plain versions
    python3 tools/probe_transpose.py --profile       # + torch.profiler kernel times

``--profile`` adds each quantity's device time a call from
``torch.profiler``'s kernel events over ``PROFILE_CALLS`` calls
(``profiler_ms``, ``profiler_plain_ms``, ...; no launch latency in them).
``tools/ab_kernels.py PARENT_DIR --probes`` times another checkout's
kernels of this file against this one's with :func:`timed_rounds`.
Without a card and without ``--device cpu`` it raises. This script imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import card  # noqa: E402
from gsplat_tpu_torch.kernels import probes as P  # noqa: E402
from gsplat_tpu_torch.utils.device import resolve_device  # noqa: E402

WARMUP, ITERS = 3, 10
ROUNDS = 9  # replays of each graph, the order rotating each round
QUEUE_SLEEP_CYCLES = 2_000_000  # about 1 ms at 1.98 GHz, far longer than the host takes to enqueue a replay
PROFILE_CALLS = 20
NBLK = 4  # slabs of the block probe (the TPU probe's grid)
PEAK_TF32_OPS = 495e12  # dense TF32 on the tensor cores (NVIDIA's H100 SXM data sheet)
FINITE_NORMAL = ("tiny_normal", "huge", "ties")  # special blocks without zeros, subnormals, inf or NaN


def tf32_ties(rng: np.random.Generator, shape) -> np.ndarray:
    """f32 values whose 13 bits below TF32's mantissa are exactly half a
    unit (ties for the rounding), of both signs and exponents 2^-20-2^20."""
    bits = rng.integers(0, 1 << 23, shape, dtype=np.int64) & ~0x1FFF | 0x1000
    bits |= (rng.integers(127 - 20, 127 + 20, shape, dtype=np.int64) << 23) | (rng.integers(0, 2, shape) << 31)
    return bits.astype(np.uint32).view(np.float32)


def special_blocks(seed: int = 16) -> dict:
    """``[16, 128]`` f32 blocks of the edge cases of the product
    ``eye(128) . x^T`` and of a transpose, each on normal draws with some
    rows left clean: ``inf`` (one inf or -inf in rows 0-7, both in row 8,
    two infs in row 9), ``nan`` (quiet NaNs, NaNs with payloads, NaN beside
    inf), ``signed_zero`` (-0.0 among normals, a row of negatives with one
    -0.0, rows of -0.0 and of +0.0), ``subnormal`` (both signs, the
    smallest and largest among them), ``tiny_normal`` (2^-126 to 2^-60,
    both signs: 3xTF32 splits those below 2^-63 scaled), ``huge`` (both
    signs up to the largest f32, some past TF32's largest) and ``ties``
    (:func:`tf32_ties`)."""
    rng = np.random.default_rng(seed)

    def base():
        return rng.normal(size=P.SLAB).astype(np.float32)

    def put(block, rows, values):
        for r in rows:
            block[r, rng.choice(P.SLAB[1], size=len(values), replace=False)] = values
        return block

    def signs(shape):
        return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)

    nan_payloads = np.array([0x7F800001, 0xFFC00123, 0x7FBFFFFF], np.uint32).view(np.float32)
    inf = put(put(put(put(base(), range(0, 4), [np.inf]), range(4, 8), [-np.inf]), [8], [np.inf, -np.inf]),
              [9], [np.inf, np.inf])
    nan = put(put(put(base(), range(0, 4), [np.nan]), range(4, 7), nan_payloads), [7], [np.nan, np.inf])
    zero = put(base(), range(0, 6), [-0.0])
    zero[6] = -np.abs(zero[6])
    zero[6, 5] = -0.0
    zero[7], zero[8] = -0.0, 0.0
    subnormal = base()
    mant = rng.integers(1, 1 << 23, P.SLAB).astype(np.uint32)
    mant[0, :2], mant[1, :2] = (1, (1 << 23) - 1), (1, (1 << 23) - 1)
    subnormal[:12] = (mant.view(np.float32) * signs(P.SLAB))[:12]
    tiny = (np.float32(2.0) ** rng.integers(-126, -59, P.SLAB).astype(np.float32)
            * rng.uniform(1, 2, P.SLAB).astype(np.float32) * signs(P.SLAB))
    tiny[0, :3] = (np.float32(2.0**-126), np.float32(-(2.0**-126)), np.float32(2.0**-63))
    huge = (np.float32(2.0) ** rng.integers(100, 128, P.SLAB).astype(np.float32)
            * rng.uniform(1, 1.999, P.SLAB).astype(np.float32) * signs(P.SLAB))
    huge[0, :3] = np.array([0x7F7FFFFF, 0xFF7FF000, 0x7F7FEFFF], np.uint32).view(np.float32)
    return {"inf": inf, "nan": nan, "signed_zero": zero, "subnormal": subnormal, "tiny_normal": tiny,
            "huge": huge, "ties": tf32_ties(rng, P.SLAB)}


def random_bits(seed: int = 17) -> np.ndarray:
    """A ``[16, 128]`` block of uniformly random 32-bit patterns (NaNs with
    payloads, infs, subnormals, signed zeros among them by chance)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, P.SLAB, dtype=np.uint64).astype(np.uint32).view(np.float32)


def same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN at the same positions and every other element bitwise equal."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    bits = a.view(torch.int32).masked_fill(nan_a, 0), b.view(torch.int32).masked_fill(nan_b, 0)
    return bool(torch.equal(nan_a, nan_b) and torch.equal(*bits))


def special_checks(dev) -> dict:
    """The kernels at every special block on ``dev`` (one launch a block):
    ``transpose_smem`` bitwise ``x.T`` at both shapes (with
    :func:`random_bits` too), ``transpose_mma`` in both modes against its
    plain version by :func:`same_values`, and 3xTF32 bitwise ``x.T`` at the
    finite normal blocks. Returns each check's outcome."""
    blocks = {name: torch.from_numpy(b).to(dev) for name, b in special_blocks().items()}
    bits = {**blocks, "bits": torch.from_numpy(random_bits()).to(dev)}
    smem = {shape: all(torch.equal(P.transpose_smem(t).view(torch.int32), t.t().contiguous().view(torch.int32))
                       for t in (b if shape == "t1" else b.t().contiguous() for b in bits.values()))
            for shape in ("t1", "t2")}
    mma = {}
    for mode, split3 in (("tf32", False), ("3xtf32", True)):
        outs = {name: P.transpose_mma(x, split3) for name, x in blocks.items()}
        mma[mode] = all(same_values(outs[name], P.transpose_mma_plain(x, split3)) for name, x in blocks.items())
        if split3:
            mma["x_t"] = all(torch.equal(outs[name], blocks[name].t()) for name in FINITE_NORMAL)
    return {"smem": smem, "mma": mma}


def timed_rounds(fns: dict, rounds: int = ROUNDS) -> dict:
    """Median and quartiles of each named ``fn``'s device milliseconds a
    call: one graph of ``ITERS`` calls each, replayed after the device's
    queue sleep in ``rounds`` rounds whose order rotates, so each quantity
    leads in turn."""
    graphs = {name: card.capture_graph(fn, ITERS, WARMUP) for name, fn in fns.items()}
    names, times = list(graphs), {name: [] for name in graphs}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            times[name].append(card.replay_ms(graphs[name], ITERS, QUEUE_SLEEP_CYCLES))
    out = {}
    for name, ts in times.items():
        q1, _, q3 = statistics.quantiles(ts, n=4)
        out[name] = {"ms": statistics.median(ts), "ms_quartiles": [q1, q3]}
    return out


def profiler_ms(fn) -> float | None:
    """Device milliseconds a call of ``fn()`` from ``torch.profiler``'s kernel
    events over ``PROFILE_CALLS`` calls; None where it records no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_CALLS):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
             if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    return us / PROFILE_CALLS / 1e3 if us > 0 else None


def probe_record(name, wrapper, run, expected, plain, library, nbytes: int, dev, smi, ops: float = 0.0,
                 exact: bool = True, special=None, profile=False, **extra) -> dict:
    """Run one probe: its output against the TPU probe's expectation and the
    plain version, the special blocks' checks (``special``: a dict of
    named outcomes, all of which must hold), then on the card the times
    (kernel, plain and library) and the bound
    (``nbytes`` over the memory rate, ``ops`` over the TF32 rate): one
    launch, then ``WARMUP + ITERS`` on the card. ``exact``: the TPU probe's
    check must hold too (not for one-pass TF32)."""
    got, want = run(), plain()
    bitwise = bool(torch.equal(got, expected))
    plain_bitwise = bool(torch.equal(got, want))
    special = special or {}
    bytes_ms = nbytes / card.PEAK_HBM_BYTES * 1e3
    ops_ms = ops / PEAK_TF32_OPS * 1e3
    rec = {
        "probe": name, "kernel": wrapper.__name__, "device": dev.type, "nvidia_smi": smi, "shape": list(got.shape),
        "bitwise_equal": bitwise, "max_rel_err": ((got - expected).abs() / expected.abs()).max().item(),
        "plain_bitwise_equal": plain_bitwise, "max_abs_err": (got - want).abs().max().item(), **special,
        "ok": plain_bitwise and (bitwise or not exact) and all(special.values()), **extra,
        "ms": None, "plain_ms": None, "library_ms": None, "rounds": None,
        "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    if dev.type != "cuda":
        return rec
    fns = {"ms": run, "plain_ms": plain}
    if library is not None:
        fns["library_ms"] = library
    for key, t in timed_rounds(fns).items():
        rec[key], rec[f"{key}_quartiles"] = t["ms"], t["ms_quartiles"]
    rec["rounds"] = ROUNDS
    if profile:
        for key, fn in fns.items():
            rec[f"profiler_{key}"] = profiler_ms(fn)
    return rec


def probe_transposes(dev, profile: bool = False) -> list:
    """Every probe of ``scripts/probe_transpose.py`` on ``dev``, in its
    order; one record each."""
    smi = card.nvidia_smi_line() if dev.type == "cuda" else None

    def tensor(seed, shape):
        return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(dev)

    x, y, xb = tensor(0, P.SLAB), tensor(1, P.SLAB[::-1]), tensor(2, (NBLK, *P.SLAB))
    checks = special_checks(dev)
    slab_bytes = 2 * x.numel() * 4
    kw = {"dev": dev, "smi": smi, "profile": profile}
    records = [probe_record("t1 transpose 16x128->128x16", P.transpose_smem, lambda: P.transpose_smem(x), x.t(),
                            lambda: P.transpose_plain(x), lambda: x.t().contiguous(), slab_bytes,
                            special={"special_bitwise_equal": checks["smem"]["t1"]}, **kw)]
    for mode, split3 in (("tf32", False), ("3xtf32", True)):
        special = {"special_bitwise_equal": checks["mma"][mode]}
        if split3:
            special["special_x_t_equal"] = checks["mma"]["x_t"]
        records.append(probe_record(
            f"mxu eye-transpose ({mode})", P.transpose_mma, lambda s=split3: P.transpose_mma(x, s), x.t(),
            lambda s=split3: P.transpose_mma_plain(x, s), (lambda: x.t().contiguous()) if split3 else None,
            slab_bytes, ops=(3 if split3 else 1) * 2.0 * 128 * 128 * 16, exact=split3, special=special,
            mode=mode, **kw))
    records.append(probe_record("t2 transpose 128x16->16x128", P.transpose_smem, lambda: P.transpose_smem(y), y.t(),
                                lambda: P.transpose_plain(y), lambda: y.t().contiguous(), slab_bytes,
                                special={"special_bitwise_equal": checks["smem"]["t2"]}, **kw))
    records.append(probe_record("dma block + transpose", P.transpose_block_async, lambda: P.transpose_block_async(xb),
                                xb.transpose(1, 2), lambda: P.transpose_block_plain(xb),
                                lambda: xb.transpose(1, 2).contiguous(), NBLK * slab_bytes, nblk=NBLK, **kw))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--profile", action="store_true", help="add torch.profiler kernel times (card only)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda" and args.profile:
        ap.error("--profile times kernels: it needs the card")
    records = probe_transposes(dev, args.profile)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0 if all(rec["ok"] for rec in records) else 1


if __name__ == "__main__":
    sys.exit(main())
