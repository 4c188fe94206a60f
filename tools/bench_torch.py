#!/usr/bin/env python3
"""Benchmark script of the PyTorch port: the counterpart of ``bench.py`` for
``gsplat_tpu_torch``, timing forward+backward render rate on one CUDA card.

Prints JSON lines of the form
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, "extra": {...}}
incrementally: the headline line is flushed the moment it is measured, and
each completed extra stage re-emits the enriched line, so the LAST line on
stdout is always the most complete artifact, on every exit path (finish,
budget skip, a kill from outside). The whole default run keeps itself
inside ``GSPLAT_BENCH_BUDGET_S`` wall-clock seconds (default 780), skipping
extras that do not fit; the skips are named in ``extra.budget.skipped``.

The timed step is ``bench.py``'s (``time_fwd_bwd``): ``render_traced``,
``rgb_loss`` against a 0.25 target with SSIM weight 0.2, and
``torch.autograd.grad`` of the loss to the model's five parameters. It runs
no optimizer and composites no background, so its frames/s is not the
inverse of ``Trainer.train_step``'s time. ``vs_baseline`` is the speedup
over the torch reference's one forward-only frame in about 5 minutes
(``BASELINE.md``).

Three modes:

* synthetic (default): the benchmark's synthetic scene (``card.build_scene``,
  the distribution of ``bench.py``) of 1M gaussians at 1920x1080, tile 32, chunk
  32, capacity 1.5x the measured pair demand, exact mode (early stop 0).
  Then the extras in ``bench.py``'s order, each behind its budget reserve:
  real density (5M gaussians at scale shift 1.9, capacity 1.1x: depth-sliced
  with early stop 1e-4, then exact mode, then single-sort with
  ``reduce_pairs`` capacity/4), 4K, the pair sweep over
  ``PAIR_SWEEP_SHIFTS``, and the headline with early stop 1e-4.
  ``--quick`` stops after the headline::

      python3 tools/bench_torch.py [--quick] [--device cuda|cpu]

* ``--scene DIR [--model DIR] [--scale-factor K]``: forward+backward over
  every view of a COLMAP scene with an Inria checkpoint, and the mean PSNR,
  the pair capacity sized for the worst view.

* ``--selftest [--selftest-gaussians N]``: the CUDA forward kernel against
  its plain PyTorch version on the same binned inputs of one 1080p view at
  tile 32, chunk 32, pair block 128, exact mode; ``ok`` below 1e-4. It runs
  only on a CUDA device: on the CPU both sides would be the plain version.

``--device`` (default ``cuda``) picks where it runs; a first operation on the
device, under a timeout, comes before anything else, and where it fails
(no card with ``--device cuda``) the script prints a ``device_unreachable``
line and exits 3: it never carries on on the CPU. On the card ``extra``
names the card and its power limit (``nvidia-smi``). ``bench.py``'s
persistent compilation cache has no counterpart: ``kernels/build.py``
already caches the ``nvcc`` build in ``build/kernels/``.

This script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import card  # noqa: E402
from gsplat_tpu_torch import CameraArrays, CameraParams, GaussianModel, RasterConfig  # noqa: E402
from gsplat_tpu_torch.render.pipeline import binning_stats, render_traced, suggest_max_pairs  # noqa: E402
from gsplat_tpu_torch.train.loss import psnr, rgb_loss  # noqa: E402
from gsplat_tpu_torch.utils.device import resolve_device  # noqa: E402

WIDTH, HEIGHT = card.WIDTH, card.HEIGHT
NUM_GAUSSIANS = card.NUM_GAUSSIANS
BASELINE_FPS = 1.0 / 300.0  # the reference: about 5 minutes per forward-only frame

# Wall-clock budget of the whole default run. The headline line is printed
# the moment it is measured, and extras that do not fit what is left are
# skipped and named, so the run ends inside the caller's limit with a line.
BENCH_BUDGET_S = float(os.environ.get("GSPLAT_BENCH_BUDGET_S", "780"))
_BENCH_T0 = [time.monotonic()]  # reset at synthetic_bench() entry


def _start_budget() -> None:
    _BENCH_T0[0] = time.monotonic()


def _time_left() -> float:
    return BENCH_BUDGET_S - (time.monotonic() - _BENCH_T0[0])


# Scale shifts of the pair-density sweep: each grows every splat by
# e^shift, raising pairs per gaussian from about 1 toward real
# MipNeRF-360 tile densities; each point is sized to 1.5x its own demand.
PAIR_SWEEP_SHIFTS = [0.0, 0.8, 1.4, 2.0]

# The real-MipNeRF-360-density point (a garden/iteration_30000-sized
# workload: about 8 pairs per gaussian, 40M pairs at 1080p) and its
# depth-sliced settings (``tools/card.py``).
REAL_DENSITY_N = card.REAL_N
REAL_DENSITY_SHIFT = card.REAL_SHIFT
REAL_DENSITY_SLICE = card.REAL_SLICE
REAL_DENSITY_REDUCE = card.REAL_REDUCE

RES_4K = (3840, 2160)

# Least pair capacity handed to a timed step (keeps a tiny demand from
# giving degenerate buffers).
CAPACITY_FLOOR = card.CAPACITY_FLOOR

# Timed steps per point: headline and early stop / sweep / real density / 4K.
ITERS = (20, 8, 4, 6)

_EMITTED = [False]


def emit(result: dict) -> None:
    """Print one JSON line and flush: every exit path after the first emit
    leaves a complete line last."""
    _EMITTED[0] = True
    print(json.dumps(result), flush=True)


def _provisional_artifact_timer(metric: str, deadline_s: float) -> threading.Timer:
    """If nothing has been emitted ``deadline_s`` seconds from now, print a
    tagged zero-value line and keep running: a later real line supersedes
    it, and a kill before that still finds a line. Returns the started
    timer, which the caller cancels once it has its result."""

    def fire():
        if not _EMITTED[0]:
            print(json.dumps({
                "metric": metric, "value": 0.0, "unit": "frames/s", "vs_baseline": 0.0,
                "extra": {"error": "no_headline_yet",
                          "detail": (f"no measurement completed within {deadline_s:.0f}s; bench still "
                                     "running — a later line supersedes this one")},
            }), flush=True)

    timer = threading.Timer(deadline_s, fire)
    timer.daemon = True
    timer.start()
    return timer


def make_cfg(max_pairs: int, early_stop: float, reduce_pairs: int = 0, slice_pairs: int = 0) -> RasterConfig:
    """The bench's settings: tile 32, chunk 32, strict parity. The kernel
    or its plain version is chosen by the device of the tensors."""
    return RasterConfig(tile_size=32, chunk_size=32, max_pairs=max_pairs, early_stop_transmittance=early_stop,
                        strict_parity=True, reduce_pairs=reduce_pairs, slice_pairs=slice_pairs)


def sized_capacity(model, cam, headroom: float = 1.5, width=None, height=None, tile_size: int = 32) -> tuple:
    """(capacity, demand): the pair demand a ``binning_stats`` probe at
    ``max_pairs`` 2^20 measures, times ``headroom``, aligned to 128, at
    least ``CAPACITY_FLOOR``. ``width``/``height`` default to the module's
    headline size at call time; the probe's tile must match the step's."""
    width = WIDTH if width is None else width
    height = HEIGHT if height is None else height
    probe = RasterConfig(tile_size=tile_size, chunk_size=32, max_pairs=1 << 20)
    with torch.no_grad():
        demand = int(binning_stats(model, cam, width, height, probe)["pair_demand"])
    return max(int(demand * headroom) // 128 * 128, CAPACITY_FLOOR), demand


def time_fwd_bwd(model, cam, target, cfg, iters: int = 20) -> tuple:
    """(seconds per step, final loss) of the forward+backward step: render,
    ``rgb_loss`` with SSIM weight 0.2, gradients to the five parameters
    (``torch.autograd.grad``: nothing accumulates in ``.grad``).

    One warm-up step, then ``iters`` steps on the host clock, fenced by
    ``float(loss)`` of the last step: the device-to-host copy waits for all
    the work queued before it on the stream, the last step's gradients
    included. The loop adds no host synchronisation to a step."""
    width, height = target.shape[1], target.shape[0]
    params = list(model.parameters())

    def step():
        image, _ = render_traced(model, cam, width, height, cfg)
        loss = rgb_loss(image, target, 0.2)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), grads

    loss, grads = step()
    if not math.isfinite(float(loss)):
        raise RuntimeError(f"warm-up step gave a non-finite loss: {float(loss)}")
    start = time.perf_counter()
    for _ in range(iters):
        loss, grads = step()
    final_loss = float(loss)
    elapsed = (time.perf_counter() - start) / iters
    return elapsed, final_loss


def pair_stats(model, cam, cfg) -> tuple:
    """(num_pairs, pair_demand, overflowed) of the headline view."""
    with torch.no_grad():
        s = binning_stats(model, cam, WIDTH, HEIGHT, cfg)
    return int(s["num_pairs"]), int(s["pair_demand"]), bool(s["overflowed"])


def _error(exc: BaseException) -> dict:
    return {"error": type(exc).__name__, "message": str(exc)}


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev: torch.device):
    """Peak device bytes since the last :func:`_reset_peak` (None on the CPU)."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def _device_fields(dev: torch.device) -> dict:
    fields = {"backend": dev.type}
    if dev.type == "cuda":
        fields.update(device=torch.cuda.get_device_name(dev), nvidia_smi=card.nvidia_smi_line())
    return fields


def synthetic_bench(quick: bool = False, device="cuda") -> dict:
    """The headline and, unless ``quick``, the extras (see the module
    docstring). Emits a line after the headline and after each extra;
    returns the final result."""
    _start_budget()
    dev = resolve_device(device)
    cam = CameraArrays.from_params(card.camera_params(WIDTH, HEIGHT, 0.0, 0.0), device=dev)
    target = torch.zeros((HEIGHT, WIDTH, 3), device=dev) + 0.25

    # Headline: exact mode (early stop 0), the configuration every parity
    # test runs; at about 1 pair per gaussian early stop has little to skip.
    _reset_peak(dev)
    model = card.build_scene(NUM_GAUSSIANS, 0.0, dev)
    max_pairs, num_pairs = sized_capacity(model, cam)
    # At 1.5x the demand the step cannot overflow, so num_pairs is the demand.
    if num_pairs > max_pairs:
        raise RuntimeError(f"headline demand {num_pairs} over capacity {max_pairs}")
    elapsed, final_loss = time_fwd_bwd(model, cam, target, make_cfg(max_pairs, 0.0), iters=ITERS[0])
    fps = 1.0 / elapsed
    extra = {
        "mpixels_per_sec": round(fps * WIDTH * HEIGHT / 1e6, 2),
        "num_gaussians": NUM_GAUSSIANS,
        "max_pairs": max_pairs,
        **_device_fields(dev),
        "sec_per_frame": round(elapsed, 4),
        "loss": final_loss,
        "pairs_per_gaussian": round(num_pairs / NUM_GAUSSIANS, 2),
        "peak_bytes": _peak(dev),
    }
    result = {
        "metric": "1080p_fwd+bwd_frames_per_sec_per_chip",
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 1),
        "extra": extra,
    }
    emit(result)  # the headline line exists from here on
    if quick:
        return result

    budget = extra["budget"] = {"total_s": BENCH_BUDGET_S, "skipped": []}

    def fits(name: str, reserve_s: float) -> bool:
        """True if ``reserve_s`` seconds of the budget remain for stage
        ``name``; else the skip is recorded."""
        if _time_left() < reserve_s:
            budget["skipped"].append(name)
            return False
        return True

    # Real density first (the reference's own workload class), capacity at
    # 1.1x (the scene is fixed and pair-scale stages pay for slack):
    # depth-sliced with early stop, then exact mode, then single-sort.
    if fits("real_density", 420.0):
        _reset_peak(dev)
        m = card.build_scene(REAL_DENSITY_N, REAL_DENSITY_SHIFT, dev)
        try:
            cap, dem = sized_capacity(m, cam, headroom=1.1)
            c = make_cfg(cap, 1e-4, slice_pairs=REAL_DENSITY_SLICE, reduce_pairs=REAL_DENSITY_REDUCE)
            el, _ = time_fwd_bwd(m, cam, target, c, iters=ITERS[2])
            real = extra["real_density"] = {
                "num_gaussians": REAL_DENSITY_N,
                "pair_demand": dem,
                "pairs_per_gaussian": round(dem / REAL_DENSITY_N, 2),
                "max_pairs": cap,
                "slice_pairs": REAL_DENSITY_SLICE,
                "fps": round(1.0 / el, 3),
                "sec_per_frame": round(el, 4),
            }
            emit(result)
            if fits("real_density.exact_mode", 150.0):
                el_exact, _ = time_fwd_bwd(m, cam, target, make_cfg(cap, 0.0), iters=ITERS[2])
                real["exact_mode_fps"] = round(1.0 / el_exact, 3)
                emit(result)
            if fits("real_density.single_sort", 170.0):
                el_ss, _ = time_fwd_bwd(m, cam, target, make_cfg(cap, 1e-4, reduce_pairs=cap // 4), iters=ITERS[2])
                real["single_sort_fps"] = round(1.0 / el_ss, 3)
            real["peak_bytes"] = _peak(dev)
        except Exception as exc:  # recorded, so that the last line survives
            extra["real_density"] = _error(exc)
        del m
        emit(result)

    # 4K on the headline scene: per-pair fixed costs spread over more pixels.
    if fits("res_4k", 110.0):
        _reset_peak(dev)
        try:
            w4, h4 = RES_4K
            cam4 = CameraArrays.from_params(card.camera_params(w4, h4, 0.0, 0.0), device=dev)
            t4 = torch.zeros((h4, w4, 3), device=dev) + 0.25
            cap4, dem4 = sized_capacity(model, cam4, width=w4, height=h4)
            el4, _ = time_fwd_bwd(model, cam4, t4, make_cfg(cap4, 0.0), iters=ITERS[3])
            extra["res_4k"] = {
                "width": w4, "height": h4,
                "pair_demand": dem4,
                "pairs_per_gaussian": round(dem4 / NUM_GAUSSIANS, 2),
                "fps": round(1.0 / el4, 3),
                "sec_per_frame": round(el4, 4),
                "mpixels_per_sec": round(w4 * h4 / el4 / 1e6, 2),
                "peak_bytes": _peak(dev),
            }
            del t4
        except Exception as exc:
            extra["res_4k"] = _error(exc)
        emit(result)

    # Pair-density sweep: grow the splats, size each point to 1.5x its demand.
    sweep = extra["pair_sweep"] = []
    for shift in PAIR_SWEEP_SHIFTS:
        if not fits(f"pair_sweep[{shift}]", 80.0):
            continue
        _reset_peak(dev)
        m = model if shift == 0.0 else card.build_scene(NUM_GAUSSIANS, shift, dev)
        try:
            cap, _ = sized_capacity(m, cam)
            c = make_cfg(cap, 1e-4)
            np_, dem, ovf = pair_stats(m, cam, c)
            el, _ = time_fwd_bwd(m, cam, target, c, iters=ITERS[1])
        except Exception as exc:
            sweep.append({"shift": shift, **_error(exc)})
            continue
        finally:
            del m
        sweep.append({
            "shift": shift,
            "pairs_per_gaussian": round(np_ / NUM_GAUSSIANS, 2),
            "num_pairs": np_,
            "pair_demand": dem,
            "max_pairs": cap,
            "overflowed": ovf,
            "fps": round(1.0 / el, 3),
            "peak_bytes": _peak(dev),
        })
        emit(result)

    # The CUDA original's early termination (T < 1e-4) on the headline scene.
    if fits("early_stop", 70.0):
        el_es, _ = time_fwd_bwd(model, cam, target, make_cfg(max_pairs, 1e-4), iters=ITERS[0])
        extra["early_stop_fps"] = round(1.0 / el_es, 3)

    budget["spent_s"] = round(time.monotonic() - _BENCH_T0[0], 1)
    return result


def scene_bench(scene: str, model_dir=None, scale_factor: int = 4, quick: bool = False, device="cuda") -> dict:
    """Forward+backward over every view of a COLMAP scene (views whose
    image ``images_{scale_factor}/<name>`` exists), timed back to back after
    a warm-up on the first, and the mean PSNR of the renders against the
    images. Capacity: ``suggest_max_pairs`` at headroom 1.5 of the worst
    view; early stop 1e-4."""
    from PIL import Image

    from gsplat_tpu_torch.io.ply import load_splat_arrays
    from gsplat_tpu_torch.io.scene import checkpoint_ply_path, read_scene
    from gsplat_tpu_torch.utils.progress import progress

    dev = resolve_device(device)
    images, cameras = read_scene(scene)
    model = GaussianModel.from_arrays(load_splat_arrays(checkpoint_ply_path(model_dir or scene)), device=dev)

    views = []
    for key in sorted(images):
        info = images[key]
        path = os.path.join(scene, f"images_{scale_factor}", info.name)
        if not os.path.exists(path):
            continue
        gt = np.asarray(Image.open(path), dtype=np.float32) / 255.0
        h, w = gt.shape[:2]
        views.append((CameraParams.from_colmap(info, cameras[info.camera_id], w, h),
                      torch.as_tensor(gt, device=dev)))
    if not views:
        print(json.dumps({"error": f"no views found under {scene}"}))
        sys.exit(1)

    probe = RasterConfig(tile_size=32, chunk_size=32, max_pairs=1 << 21)
    with torch.no_grad():
        max_pairs = max(suggest_max_pairs(model, c, probe, headroom=1.5) for c, _ in views)
    cfg = RasterConfig(tile_size=32, chunk_size=32, max_pairs=max_pairs, early_stop_transmittance=1e-4)
    w, h = views[0][0].width, views[0][0].height
    params = list(model.parameters())

    def fwd_bwd(cam, gt, vw, vh):
        image, _ = render_traced(model, cam, vw, vh, cfg)
        loss = rgb_loss(image, gt, 0.2)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), grads

    cams = [CameraArrays.from_params(c, device=dev) for c, _ in views]
    sizes = [(c.width, c.height) for c, _ in views]
    loss, _ = fwd_bwd(cams[0], views[0][1], *sizes[0])  # warm-up
    float(loss)
    start = time.perf_counter()
    for cam, (_, gt), size in progress(list(zip(cams, views, sizes)), desc="bench views", enabled=not quick):
        loss, _ = fwd_bwd(cam, gt, *size)
    float(loss)
    elapsed = (time.perf_counter() - start) / len(views)

    with torch.inference_mode():
        psnrs = [float(psnr(render_traced(model, cam, *size, cfg)[0], gt))
                 for cam, (_, gt), size in zip(cams, views, sizes)]
    fps = 1.0 / elapsed
    return {
        "metric": f"{h}p_real_scene_fwd+bwd_frames_per_sec_per_chip",
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 1),
        "extra": {
            "scene": scene,
            "num_views": len(views),
            "width": w,
            "height": h,
            "num_gaussians": model.num_gaussians,
            "max_pairs": max_pairs,
            "mean_psnr": round(float(np.mean(psnrs)), 2),
            **_device_fields(dev),
            "sec_per_frame": round(elapsed, 4),
        },
    }


def selftest(n: int = 1_000_000, device="cuda") -> dict:
    """The CUDA forward kernel (``kernels/raster_fwd.py::forward_tiles``)
    against its plain version on the same binned inputs of one view of the
    ``n``-gaussian bench scene at ``WIDTH x HEIGHT``: tile 32, chunk 32, pair
    block 128, exact mode, capacity 1.5x the demand. The CPU tests hold the
    plain version to JAX at small shapes; this checks the kernel at
    production shapes on the card. ``ok``: colour and transmittance within
    1e-4, ``blocks_done`` equal, finite mean."""
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_plain
    from gsplat_tpu_torch.render.tile_torch import tiles_to_image

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the selftest holds the CUDA forward kernel against its plain version and needs "
                         f"--device cuda; on {dev.type} both sides would be the plain version")
    with torch.inference_mode():
        model = card.build_scene(n, 0.0, dev)
        camera = card.camera_params(WIDTH, HEIGHT, 0.0, 0.0)
        max_pairs, demand = sized_capacity(model, CameraArrays.from_params(camera, device=dev))
        cfg = RasterConfig(tile_size=32, chunk_size=32, pair_block=128, max_pairs=max_pairs, strict_parity=True,
                           early_stop_transmittance=0.0)
        args, _, ntx = card.binned_inputs(model, camera, cfg)
        color, trans, done = forward_tiles(*args, ntx, cfg, WIDTH, HEIGHT)
        p_color, p_trans, p_done = forward_tiles_plain(*args, ntx, cfg, WIDTH, HEIGHT)
        err_img = float((color - p_color).abs().max())
        err_trans = float((trans - p_trans).abs().max())
        done_equal = bool(torch.equal(done, p_done))
        mean_img = float(tiles_to_image(color, WIDTH, HEIGHT, cfg.tile_size).mean())
    ok = bool(err_img < 1e-4 and err_trans < 1e-4 and done_equal and np.isfinite(mean_img))
    return {
        "metric": "selftest_cuda_vs_plain_max_abs_err",
        "value": err_img,
        "unit": "abs_err",
        "vs_baseline": 1.0 if ok else 0.0,
        "extra": {
            "ok": ok,
            "num_gaussians": n,
            "pair_demand": demand,
            "max_pairs": max_pairs,
            "config": "ts=32 chunk=32 pair_block=128 (production)",
            "max_abs_err_image": err_img,
            "max_abs_err_transmittance": err_trans,
            "blocks_done_equal": done_equal,
            "mean_image": mean_img,
            **_device_fields(dev),
        },
    }


def _device_probe(metric: str, device: str, timeout_s: float = 300.0) -> None:
    """A first operation on ``device`` (resolved there, so that a missing
    card is reported too), read back under a timeout. On a raise or a hang
    print a ``device_unreachable`` line and exit 3."""
    done = threading.Event()
    failure = []

    def probe():
        try:
            x = torch.ones((8, 128), device=resolve_device(device)) + 1
            float(x[0, 0])
        except BaseException as exc:  # noqa: BLE001 — reported, then the process exits
            failure.append(f"{type(exc).__name__}: {exc}")
        done.set()

    threading.Thread(target=probe, daemon=True).start()
    timed_out = not done.wait(timeout_s)
    if timed_out or failure:
        detail = (f"first device op did not complete within {timeout_s:.0f}s" if timed_out
                  else f"device init failed: {failure[0]}")
        print(json.dumps({
            "metric": metric, "value": 0.0, "unit": "frames/s", "vs_baseline": 0.0,
            "extra": {"error": "device_unreachable", "detail": detail},
        }), flush=True)
        os._exit(3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default=None, help="COLMAP scene dir (real-scene mode)")
    ap.add_argument("--model", default=None, help="Inria checkpoint dir (defaults to --scene)")
    ap.add_argument("--scale-factor", type=int, default=4)
    ap.add_argument("--quick", action="store_true", help="headline number only")
    ap.add_argument("--selftest", action="store_true",
                    help="the CUDA forward kernel against its plain version at production shape")
    ap.add_argument("--selftest-gaussians", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    metric = ("selftest_cuda_vs_plain_max_abs_err" if args.selftest
              else "real_scene_fwd+bwd_frames_per_sec_per_chip" if args.scene
              else "1080p_fwd+bwd_frames_per_sec_per_chip")
    _device_probe(metric, args.device)
    timer = _provisional_artifact_timer(metric, float(os.environ.get("GSPLAT_BENCH_PROVISIONAL_S", "420")))
    try:
        if args.selftest:
            result = selftest(args.selftest_gaussians, args.device)
        elif args.scene:
            result = scene_bench(args.scene, args.model, args.scale_factor, args.quick, args.device)
        else:
            result = synthetic_bench(quick=args.quick, device=args.device)
    finally:
        timer.cancel()
    emit(result)
    return 1 if args.selftest and not result["extra"]["ok"] else 0


if __name__ == "__main__":
    sys.exit(main())
