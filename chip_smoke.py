#!/usr/bin/env python3
"""Drive the PyTorch port's render path on one CUDA card.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one NVIDIA H100 (or another sm_90a card) and the CUDA toolkit. It builds the
port's CUDA kernels from ``gsplat_tpu_torch/csrc`` (into ``build/kernels``),
then runs four phases, each printing one JSON line:

  1. device: the card's name and power limit, torch/CUDA versions, kernel
     build time and the compiler's register report;
  2. small: the forward kernel against its plain PyTorch version on a
     256x192 frame of 20K gaussians (early stop off and 1e-4, where most
     tiles stop early), and a 64x48 render against the sequential oracle;
  3. served: the bench scene (1M gaussians, 1920x1080, SH degree 3,
     tile 32, chunk 32, pair block 128, capacity 1.5x the measured demand)
     answers three render requests through ``gsplat_tpu_torch.render``;
     the kernel's launch count over those requests must be exactly 3, and
     one full frame is held against the plain version;
  4. timing: the kernel alone and the plain version at the phase-3 shapes,
     with the kernel's bound on this card, and one request taken apart by
     stage, with its device-busy time and host synchronisations.

It then prints ``nvidia-smi``'s name/power-limit line, the ``kernels`` JSON
line and, last, ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result; it also refuses to run
without a CUDA device or without the ``gsplat_tpu_torch`` package beside it.
It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet; CUDA programming guide throughput table
# for compute capability 9.0: 16 exp2 results per clock per SM on the SFU).
PEAK_FP32_OPS = 67e12  # FP32 outside the tensor cores, ops/s
PEAK_SFU_EXP = 132 * 16 * 1.98e9  # SMs x exp/clock/SM x boost clock, exps/s
PEAK_HBM_BYTES = 3.35e12  # bytes/s
FP32_OPS_PER_PAIR_PIXEL = 20  # density, alpha, gates and compositing

# Headline scene and settings (bench.py:71-72, 172-231, 282-307).
WIDTH, HEIGHT = 1920, 1080
NUM_GAUSSIANS = 1_000_000
CAPACITY_FLOOR = 1 << 17


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_scene(n: int, scale_shift: float, device):
    """The bench scene distribution (bench.py:172-200), drawn on the device
    from a seeded generator: camera at the origin looking down +z, z in
    [2, 10], the view frustum filled."""
    import torch

    from gsplat_tpu_torch import GaussianModel

    g = torch.Generator(device=device).manual_seed(0)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    z = uniform((n,), 2.0, 10.0)
    x = uniform((n,), -0.9, 0.9) * z
    y = uniform((n,), -0.55, 0.55) * z
    return GaussianModel(
        means=torch.stack([x, y, z], -1),
        log_scales=uniform((n, 3), -5.2, -3.6) + scale_shift,
        quats=torch.randn((n, 4), generator=g, device=device),
        opacity_logits=uniform((n,), -2.0, 2.0),
        sh=torch.randn((n, 48), generator=g, device=device).reshape(n, 16, 3) * 0.2,
    )


def bench_camera(width: int, height: int, yaw: float = 0.0):
    """The bench camera (bench.py:220-231), optionally turned by ``yaw``
    radians about +y."""
    from gsplat_tpu_torch import CameraParams

    fx = 0.8 * width
    return CameraParams(
        width=width, height=height,
        fov_x=2 * math.atan(width / (2 * fx)), fov_y=2 * math.atan(height / (2 * fx)),
        focal_x=fx, focal_y=fx,
        qvec=(math.cos(yaw / 2), 0.0, math.sin(yaw / 2), 0.0), tvec=(0.0, 0.0, 0.0),
    )


def binned_inputs(model, camera, cfg):
    """The forward kernel's inputs for one view, through the port's stages."""
    import torch

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.render.pipeline import preprocess_traced

    cam = gs.CameraArrays.from_params(camera, device=model.means.device)
    prep = preprocess_traced(model, cam, camera.width, camera.height, cfg)
    bins = binning.bin_gaussians(prep, camera.width, camera.height, cfg.tile_size, cfg.max_pairs, align=cfg.pair_block)
    n_tiles_x = -(-camera.width // cfg.tile_size)
    n_tiles = n_tiles_x * -(-camera.height // cfg.tile_size)
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=prep.depth.device)
    args = (binning.pack_features(prep), bins.pair_gaussian, bins.tile_start, bins.tile_count, tile_ids)
    return args, bins, n_tiles_x


def cuda_ms(fn, runs: int):
    """Median milliseconds of ``fn()`` over ``runs`` calls, CUDA events."""
    import torch

    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def request_breakdown(model, camera, cfg, runs: int = 5) -> dict:
    """One render request taken apart: the median CUDA-event milliseconds of
    each stage of ``render_traced`` called one by one, of the whole request,
    the device-busy milliseconds of one request from ``torch.profiler``
    (None where the profiler records no device time), and the host
    synchronisations one request and its binning make."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.kernels.raster import rasterize_tiles
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.render.pipeline import preprocess_traced
    from gsplat_tpu_torch.render.tile_torch import tiles_to_image

    dev = model.means.device
    w, h, ts = camera.width, camera.height, cfg.tile_size
    ntx = -(-w // ts)
    tile_ids = torch.arange(ntx * -(-h // ts), dtype=torch.int32, device=dev)
    names = ("camera", "preprocess", "pack_features", "binning", "raster_fwd", "tiles_to_image")
    samples = {k: [] for k in names}
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        cam = gs.CameraArrays.from_params(camera, device=dev)
        ev[1].record()
        prep = preprocess_traced(model, cam, w, h, cfg)
        ev[2].record()
        feat = binning.pack_features(prep)
        ev[3].record()
        bins = binning.bin_gaussians(prep, w, h, ts, cfg.max_pairs, align=cfg.pair_block)
        ev[4].record()
        color, trans = rasterize_tiles(feat, bins.pair_gaussian, bins.tile_start, bins.tile_count,
                                       tile_ids, bins.gaussian_counts, ntx, cfg, w, h)
        ev[5].record()
        tiles_to_image(color, w, h, ts), tiles_to_image(trans, w, h, ts)
        ev[6].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            samples[k].append(ev[i].elapsed_time(ev[i + 1]))
    out = {"stage_ms": {k: statistics.median(v) for k, v in samples.items()},
           "request_ms": cuda_ms(lambda: gs.render(model, camera, cfg), runs)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gs.render(model, camera, cfg)
        torch.cuda.synchronize()
    busy_us = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    )
    out["device_busy_ms"] = busy_us / 1e3 if busy_us > 0 else None

    def host_syncs(fn) -> int:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(c.message) for c in caught)

    out["request_host_syncs"] = host_syncs(lambda: gs.render(model, camera, cfg))
    out["binning_host_syncs"] = host_syncs(
        lambda: binning.bin_gaussians(prep, w, h, ts, cfg.max_pairs, align=cfg.pair_block))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "gsplat_tpu_torch")):
        print("chip_smoke: the gsplat_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import dataclasses

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.kernels import build
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_plain
    from gsplat_tpu_torch.render.tile_torch import tiles_to_image

    dev = torch.device("cuda")
    smi = nvidia_smi_line()

    # -- phase 1: device and build --
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log("raster_fwd").splitlines() if "registers" in ln or "smem" in ln]
    emit({
        "phase": "device", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "build_s": build_s, "compiled": sorted(built),
        "ptxas": ptxas,
    })

    # -- phase 2: kernel vs plain, small; render vs oracle, tiny --
    small_cfg = gs.RasterConfig(tile_size=32, chunk_size=32, pair_block=128, max_pairs=1 << 18)
    with torch.inference_mode():
        model = build_scene(20_000, 2.5, dev)  # splats big enough to saturate tiles
        args, bins, ntx = binned_inputs(model, bench_camera(256, 192), small_cfg)
        small = {"num_pairs": int(bins.num_pairs), "pair_demand": int(bins.pair_demand)}
        check(small["pair_demand"] <= small_cfg.max_pairs, "phase 2 capacity")
        for stop in (0.0, 1e-4):
            cfg = dataclasses.replace(small_cfg, early_stop_transmittance=stop)
            got = forward_tiles(*args, ntx, cfg, 256, 192)
            torch.cuda.synchronize()
            want = forward_tiles_plain(*args, ntx, cfg, 256, 192)
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
            check(torch.equal(got[2], want[2]), f"phase 2 blocks_done (early stop {stop})")
            all_blocks = -(-args[3] // cfg.pair_block)
            small[f"max_abs_err_stop_{stop}"] = max(
                float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
            small[f"tiles_stopped_early_{stop}"] = int((got[2] < all_blocks).sum())
        check(small["tiles_stopped_early_0.0001"] > 0, "phase 2 exercises the early stop")
        tiny_model = build_scene(300, 1.5, dev)
        tiny_cam = bench_camera(64, 48)
        tiny_cfg = gs.RasterConfig(tile_size=16, chunk_size=8, pair_block=8, max_pairs=1 << 14)
        img, trans = gs.render(tiny_model, tiny_cam, tiny_cfg)
        o_img, o_trans = gs.render_reference_oracle(tiny_model, tiny_cam, tiny_cfg)
        torch.testing.assert_close(img, o_img, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(trans, o_trans, rtol=1e-5, atol=1e-6)
        small["oracle_max_abs_err"] = float((img - o_img).abs().max())
    emit({"phase": "small", **small})

    # -- phase 3: the served path at full width --
    with torch.inference_mode():
        model = build_scene(NUM_GAUSSIANS, 0.0, dev)
        probe = gs.RasterConfig(tile_size=32, chunk_size=32, max_pairs=1 << 20)
        cam0 = bench_camera(WIDTH, HEIGHT)
        demand = int(gs.binning_stats(model, gs.CameraArrays.from_params(cam0, device=dev), WIDTH, HEIGHT, probe)["pair_demand"])
        capacity = max(int(demand * 1.5) // 128 * 128, CAPACITY_FLOOR)
        cfg = gs.RasterConfig(tile_size=32, chunk_size=32, pair_block=128, max_pairs=capacity, sh_degree=3,
                              early_stop_transmittance=0.0, strict_parity=True)
        poses = [("bench", 0.0), ("yaw+0.05", 0.05), ("yaw-0.05", -0.05)]
        gs.render(model, cam0, cfg)  # warm-up: allocator and library kernels
        torch.cuda.synchronize()
        requests, frames = [], []
        forward_tiles.launches = 0
        for name, yaw in poses:
            camera = bench_camera(WIDTH, HEIGHT, yaw)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            host0 = time.perf_counter()
            start.record()
            img, trans = gs.render(model, camera, cfg)
            end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - host0) * 1e3
            frames.append((img, trans))
            requests.append({"pose": name, "ms": start.elapsed_time(end), "host_ms": host_ms})
        launches = forward_tiles.launches
        check(launches == len(poses), f"kernel launches over the requests: {launches} != {len(poses)}")
        for req, (name, yaw), (img, trans) in zip(requests, poses, frames):
            stats = gs.binning_stats(
                model, gs.CameraArrays.from_params(bench_camera(WIDTH, HEIGHT, yaw), device=dev), WIDTH, HEIGHT, cfg)
            req.update({k: int(stats[k]) for k in ("num_pairs", "pair_demand", "max_tile_count")})
            req["overflowed"] = bool(stats["overflowed"])
            check(img.shape == (HEIGHT, WIDTH, 3) and trans.shape == (HEIGHT, WIDTH), "frame shape")
            check(bool(torch.isfinite(img).all() and torch.isfinite(trans).all()), "finite frame")
            check(float(trans.min()) >= 0.0 and float(trans.max()) <= 1.0, "transmittance in [0, 1]")
            check(not req["overflowed"], "no overflow at 1.5x capacity")

        # One full frame: kernel against the plain version on the same inputs.
        args, bins, ntx = binned_inputs(model, cam0, cfg)
        k_out = forward_tiles(*args, ntx, cfg, WIDTH, HEIGHT)
        torch.cuda.synchronize()
        p_out = forward_tiles_plain(*args, ntx, cfg, WIDTH, HEIGHT)
        # Per pixel of the frame: the larger of the colour and T errors.
        err = tiles_to_image(
            torch.maximum((k_out[0] - p_out[0]).abs().amax(-1), (k_out[1] - p_out[1]).abs()),
            WIDTH, HEIGHT, cfg.tile_size)
        n_pix = err.numel()
        within_1e4 = int((err <= 1e-4).sum())
        within_5e3 = int((err <= 5e-3).sum())
        frame_err = float(err.max())
        check(within_1e4 >= 0.99999 * n_pix, f"{n_pix - within_1e4} pixels beyond 1e-4")
        check(within_5e3 == n_pix, f"{n_pix - within_5e3} pixels beyond 5e-3")
        check(torch.equal(k_out[2], p_out[2]), "full-frame blocks_done")
        # The first request rendered these very inputs through the kernel.
        check(torch.equal(frames[0][0], tiles_to_image(k_out[0], WIDTH, HEIGHT, cfg.tile_size)),
              "the first request's frame equals the checked kernel frame")
    emit({
        "phase": "served", "num_gaussians": NUM_GAUSSIANS, "width": WIDTH, "height": HEIGHT,
        "pair_demand_probe": demand, "pairs_per_gaussian": demand / NUM_GAUSSIANS, "capacity": capacity,
        "requests": requests, "kernel_launches": launches, "pixels": n_pix,
        "within_1e-4": within_1e4, "within_5e-3": within_5e3, "max_abs_err": frame_err,
    })

    # -- phase 4: kernel timing and bound at the phase-3 shapes --
    with torch.inference_mode():
        for _ in range(3):
            forward_tiles(*args, ntx, cfg, WIDTH, HEIGHT)
        kernel_ms = cuda_ms(lambda: forward_tiles(*args, ntx, cfg, WIDTH, HEIGHT), 20)
        plain_ms = cuda_ms(lambda: forward_tiles_plain(*args, ntx, cfg, WIDTH, HEIGHT), 3)
        breakdown = request_breakdown(model, cam0, cfg)
    feat, pair_gaussian, tile_start, tile_count, tile_ids = args
    npix = cfg.tile_size * cfg.tile_size
    pair_pixels = int(tile_count.sum()) * npix  # the kernel skips alignment pads
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    out_bytes = len(tile_ids) * (npix * 4 * 4 + 4)
    bytes_ms = (in_bytes + out_bytes) / PEAK_HBM_BYTES * 1e3
    ops_ms = max(pair_pixels * FP32_OPS_PER_PAIR_PIXEL / PEAK_FP32_OPS, pair_pixels / PEAK_SFU_EXP) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit({
        "phase": "timing", "kernel_ms": kernel_ms, "plain_ms": plain_ms, "pair_pixels": pair_pixels,
        "bytes": in_bytes + out_bytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": bound_ms,
        "pair_slots": pair_gaussian.numel(), "tiles": len(tile_ids), **breakdown,
    })

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "raster_fwd", "route": "cuda", "source": "gsplat_tpu_torch/csrc/raster_fwd.cu",
        "replaces": "gsplat_tpu/kernels/raster_fwd.py:68", "launches": launches,
        "max_abs_err": frame_err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
