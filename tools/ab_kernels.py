#!/usr/bin/env python3
"""Compare two checkouts' CUDA compositors alone, in one process on one card.

Usage: ``python3 tools/ab_kernels.py PARENT_DIR [--rounds 8] [--tiles
16,32,64] [--out DIR]`` from the root of the change's checkout, on a
machine with a CUDA card and ``nvcc``. It builds
``gsplat_tpu_torch/csrc/raster_fwd.cu`` and ``raster_bwd.cu`` of both
checkouts with the change's ``build.NVCC_FLAGS`` (one ``nvcc`` per source,
all started together) into ``--out`` (default a temporary directory),
prints each kernel's registers and spill bytes from the ``-Xptxas -v``
report, then calls both sides through ``ctypes`` on the same inputs, at
each tile edge of ``--tiles`` (each one thread block a tile: 1 to 64): the
benchmark's synthetic headline scene (``card.build_scene``: 1M gaussians,
1920x1080, pair block 128, capacity 1.5x the tiling's demand, exact mode)
binned by the change's Python, random cotangents, and a carry state from
the single pass. It checks that the change's forward, backward and both
carry forms are bitwise the parent's, and times each kernel with CUDA
events (median of 20 launches) over ``--rounds`` rounds that alternate
which side runs first. The last line is one JSON object: at each tile,
each kernel's bitwise check, median, quartiles and runs per side and the
share of rounds the change wins, and for the forward and backward the
kernel's bound on this card beside the change's median (``bound``:
``card.compositor_bound`` over the pair-pixels ``card.pair_pixels``
counts, and its share of the time); and the card's name and power
limit. Both sides must keep the C entry points' signatures
(``gsplat_raster_fwd``, ``gsplat_raster_bwd``).

With ``--probes`` it compares ``probe_transpose.cu`` instead: both sides'
``gsplat_probe_transpose_smem`` (``t1`` at ``[16, 128]``, ``t2`` at
``[128, 16]``) and ``gsplat_probe_transpose_mma`` (TF32 and 3xTF32), held to each
other at the TPU probe's inputs (``bitwise``, which decides the exit
status) and at each special block of ``tools/probe_transpose.py``
(``special_bitwise``, by name: NaN positions by ``isnan``, every other
element by its bits; a change may mean to differ there), and timed with that tool's ``timed_rounds`` beside
``x.t().contiguous()`` in ``--rounds`` rounds of rotating order, with
``torch.profiler``'s kernel times (``profiler_ms``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent")
    parser.add_argument("--rounds", type=int, default=8)
    parser.add_argument("--tiles", default="16,32,64", help="tile edges, comma-separated, each 1 to 64")
    parser.add_argument("--out", default=None)
    parser.add_argument("--probes", action="store_true", help="compare probe_transpose.cu's kernels instead")
    opts = parser.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    import card
    from gsplat_tpu_torch.kernels import build
    from gsplat_tpu_torch.kernels import raster_bwd as RB
    from gsplat_tpu_torch.kernels import raster_fwd as RF

    out_dir = opts.out or tempfile.mkdtemp(prefix="ab_kernels_")
    os.makedirs(out_dir, exist_ok=True)
    sides = {"parent": os.path.join(opts.parent, "gsplat_tpu_torch", "csrc"),
             "change": os.path.join(HERE, "gsplat_tpu_torch", "csrc")}
    v, i = ctypes.c_void_p, ctypes.c_int
    # source -> its C entry points (without the gsplat_ prefix) and their argument types
    sources = ({"probe_transpose": {"probe_transpose_smem": [v, v, i, i, v], "probe_transpose_mma": [v, v, i, v]}}
               if opts.probes else
               {"raster_fwd": {"raster_fwd": list(RF._ARGTYPES)}, "raster_bwd": {"raster_bwd": list(RB._ARGTYPES)}})
    procs = []
    for side, csrc in sides.items():
        for name in sources:
            lib = os.path.join(out_dir, f"{side}_{name}.so")
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, os.path.join(csrc, f"{name}.cu")]
            procs.append((side, name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                            text=True)))
    fns, resources = {}, {}
    for side, name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{side} {name}: nvcc exited {proc.returncode}\n{log}")
        resources[f"{side} {name}"] = card.ptxas_by_kernel(log)
        dll = ctypes.CDLL(lib)
        for entry, argtypes in sources[name].items():
            fn = getattr(dll, f"gsplat_{entry}")
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[side, entry] = fn
    print(json.dumps({"resources": resources}), flush=True)

    if opts.probes:
        result = {"nvidia_smi": card.nvidia_smi_line(), "rounds": opts.rounds,
                  "probes": compare_probes(fns, opts.rounds)}
        print(json.dumps(result), flush=True)
        return 0 if all(p["bitwise"] for p in result["probes"].values()) else 1
    dev = torch.device("cuda")
    model = card.build_scene(card.NUM_GAUSSIANS, 0.0, dev)
    cam0 = card.camera_params(card.WIDTH, card.HEIGHT, 0.0, 0.0)
    result = {"nvidia_smi": card.nvidia_smi_line(), "rounds": opts.rounds, "tiles": {}}
    for ts in (int(x) for x in opts.tiles.split(",")):
        result["tiles"][str(ts)] = compare(fns, model, cam0, ts, opts.rounds)
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0 if all(k["bitwise"] for tile in result["tiles"].values() for k in tile.values()) else 1


def compare(fns, model, cam0, tile_size, rounds) -> dict:
    """Both sides' four kernels at one tile edge: bitwise checks and times."""
    import torch

    import card
    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.kernels import raster_bwd as RB
    from gsplat_tpu_torch.ops.compositing import MAX_GAUSSIAN_DENSITY_F32, MIN_ALPHA_F32

    dev = model.means.device
    with torch.inference_mode():
        probe = gs.RasterConfig(tile_size=tile_size, chunk_size=32, max_pairs=1 << 20)
        demand = int(gs.binning_stats(model, gs.CameraArrays.from_params(cam0, device=dev), card.WIDTH, card.HEIGHT,
                                      probe)["pair_demand"])
        cfg = gs.RasterConfig(tile_size=tile_size, chunk_size=32, pair_block=128, sh_degree=3,
                              max_pairs=max(int(demand * 1.5) // 128 * 128, card.CAPACITY_FLOOR))
        args, _, ntx = card.binned_inputs(model, cam0, cfg)
    num_t, npix = args[4].shape[0], cfg.tile_size ** 2
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    def fwd(side, carry=(None, None)):
        color = torch.empty((num_t, npix, 3), device=dev)
        trans = torch.empty((num_t, npix), device=dev)
        done = torch.empty((num_t,), dtype=torch.int32, device=dev)
        err = fns[side, "raster_fwd"](
            *(ptr(a) for a in args), *(ptr(c) for c in carry), num_t, ntx, cfg.tile_size, cfg.pair_block, 0.0,
            card.WIDTH, card.HEIGHT, MIN_ALPHA_F32, MAX_GAUSSIAN_DENSITY_F32, ptr(color), ptr(trans), ptr(done), stream)
        if err:
            raise RuntimeError(f"{side} forward: cudaError_t {err}")
        return color, trans, done

    first = fwd("parent")
    color, trans, done = first
    g_color, g_trans = card.random_cotangents(color, trans, seed=3)
    carry = (color * 0.5, torch.sqrt(trans))  # a state to resume from
    state = RB.walk_state(color, trans, g_color, g_trans)

    def bwd(side, carry_in=None):
        rows = torch.zeros((args[1].shape[0], RB.NUM_GRAD), device=dev)
        c_out = None if carry_in is None else torch.empty_like(carry_in)
        outs = (None, None, g_color, None) if carry_in is not None else (color, trans, g_color, g_trans)
        err = fns[side, "raster_bwd"](
            *(ptr(a) for a in args), ptr(done), *(ptr(t) for t in outs), ptr(carry_in), num_t, ntx, cfg.tile_size,
            cfg.pair_block, MIN_ALPHA_F32, MAX_GAUSSIAN_DENSITY_F32, ptr(rows), ptr(c_out), stream)
        if err:
            raise RuntimeError(f"{side} backward: cudaError_t {err}")
        return rows, c_out

    kernels = {"raster_fwd": lambda side: fwd(side), "raster_bwd": lambda side: bwd(side)[:1],
               "raster_fwd_carry": lambda side: fwd(side, carry), "raster_bwd_carry": lambda side: bwd(side, state)}
    out = {}
    for name, run in kernels.items():
        a, b = run("parent"), run("change")
        torch.cuda.synchronize()
        out[name] = {"bitwise": all(torch.equal(x, y) for x, y in zip(a, b))}
    times = {(name, side): [] for name in kernels for side in ("parent", "change")}
    for r in range(rounds):
        for side in ("parent", "change") if r % 2 == 0 else ("change", "parent"):
            for name, run in kernels.items():
                times[name, side].append(card.cuda_ms(lambda: run(side), 20))

    def stats(v):
        q = statistics.quantiles(v, n=4)
        return {"median": statistics.median(v), "quartiles": [q[0], q[2]], "runs": v}

    for name in kernels:
        p, c = times[name, "parent"], times[name, "change"]
        out[name].update({"parent": stats(p), "change": stats(c),
                          "change_wins": sum(x < y for x, y in zip(c, p)) / len(p)})
    # Exact mode walks every pair slot. The bytes: the inputs read once and,
    # per pixel, colour, T and blocks_done written (the forward); the
    # inputs, the frame, its cotangents and blocks_done read and the [P, 9]
    # rows written (the backward).
    counts = card.pair_pixels(args, ntx, cfg)
    nbytes = {"raster_fwd": sum(t.numel() * t.element_size() for t in args) + num_t * (npix * 16 + 4),
              "raster_bwd": sum(t.numel() * t.element_size() for t in (*args, color, trans, g_color, g_trans, done))
              + args[1].numel() * 36}
    for name, n in nbytes.items():
        bound = card.compositor_bound(counts, n, backward=name == "raster_bwd")
        out[name]["bound"] = card.bound_fields(bound, out[name]["change"]["median"])
    return out


def compare_probes(fns, rounds) -> dict:
    """Both sides' transpose probes: bitwise checks and times."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import probe_transpose as PT

    dev = torch.device("cuda")

    def launch(side, entry, x, *args):  # on the current stream: the capture's, inside a graph capture
        out = torch.empty(x.shape[::-1], dtype=x.dtype, device=dev)
        err = fns[side, entry](x.data_ptr(), out.data_ptr(), *args, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{side} {entry}: cudaError_t {err}")
        return out

    def tensor(seed, shape):
        return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(dev)

    x, y = tensor(0, (16, 128)), tensor(1, (128, 16))
    blocks = {name: torch.from_numpy(b).to(dev) for name, b in PT.special_blocks().items()}
    bits = {**blocks, "bits": torch.from_numpy(PT.random_bits()).to(dev)}
    probes = {  # name: (kernel of (side, x), the probe's input, the special inputs by name)
        "t1": (lambda side, t: launch(side, "probe_transpose_smem", t, *t.shape), x, bits),
        "t2": (lambda side, t: launch(side, "probe_transpose_smem", t, *t.shape), y,
               {name: b.t().contiguous() for name, b in bits.items()}),
        "mma_tf32": (lambda side, t: launch(side, "probe_transpose_mma", t, 0), x, blocks),
        "mma_3xtf32": (lambda side, t: launch(side, "probe_transpose_mma", t, 1), x, blocks),
    }
    out = {}
    for name, (run, t, special) in probes.items():
        bitwise = bool(torch.equal(run("parent", t).view(torch.int32), run("change", t).view(torch.int32)))
        special_bitwise = {n: PT.same_values(run("parent", b), run("change", b)) for n, b in special.items()}
        fn = {"parent": lambda run=run, t=t: run("parent", t), "change": lambda run=run, t=t: run("change", t),
              "library": lambda t=t: t.t().contiguous()}
        times = PT.timed_rounds(fn, rounds)
        for side, f in fn.items():
            times[side]["profiler_ms"] = PT.profiler_ms(f)
        out[name] = {"bitwise": bitwise, "special_bitwise": special_bitwise, **times}
    return out


if __name__ == "__main__":
    sys.exit(main())
