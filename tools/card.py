"""Helpers the card tests and the tools share: timers on the card, the
card's ``nvidia-smi`` line and the compiler's register report, the
compositors' work counts and bounds, the headline scene and its settings,
and worlds of spawned ranks.

The scene, the camera, the peaks and the operations a pair-pixel needs are
the benchmark's own: ``splatbench/scenes/synthetic.py`` (at seed 0),
``splatbench/scene.py::camera_params`` and ``splatbench/counts.py``. This
module imports neither JAX nor the JAX package. A tool imports it as
``card`` from its own directory; a test puts ``tools/`` on ``sys.path``
first.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from splatbench.counts import (  # noqa: E402
    BWD_PASSED_OPS, FWD_PASSED_OPS, GATE_OPS, PEAK_FP32_OPS, PEAK_HBM_BYTES, PEAK_SFU,
)
from splatbench.scene import camera_params  # noqa: E402,F401  (the tools' camera)
from splatbench.scenes import synthetic  # noqa: E402

# Headline scene and settings (bench.py:71-72, 172-231, 282-307).
WIDTH, HEIGHT = 1920, 1080
NUM_GAUSSIANS = 1_000_000
CAPACITY_FLOOR = 1 << 17
# The real-MipNeRF-360-density point and its depth-sliced production
# settings (bench.py:146-158, 349-382): 5M gaussians at scale shift 1.9,
# early stop 1e-4, capacity 1.1x the demand.
REAL_N = 5_000_000
REAL_SHIFT = 1.9
REAL_SLICE = 1 << 19
REAL_REDUCE = 1 << 20


def build_scene(n: int, scale_shift: float, device):
    """The benchmark's synthetic scene (``bench.py:172-200``) of ``n``
    gaussians at ``scale_shift``, drawn on ``device`` at seed 0, as a
    ``GaussianModel``."""
    from gsplat_tpu_torch import GaussianModel

    return GaussianModel(*synthetic.build({"n_gaussians": n, "scale_shift": scale_shift}, 0, device))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_resources(lines) -> dict:
    """Registers and spill bytes of a kernel's ``-Xptxas -v`` report (one
    kernel per source; None where the report does not say)."""
    import re

    text = " ".join(lines)

    def first(pattern):
        m = re.search(pattern, text)
        return int(m.group(1)) if m else None

    return {"registers": first(r"Used (\d+) registers"), "spill_stores": first(r"(\d+) bytes spill stores"),
            "spill_loads": first(r"(\d+) bytes spill loads")}


def ptxas_by_kernel(log: str) -> dict:
    """:func:`ptxas_resources` of each kernel entry in a ``-Xptxas -v``
    report, keyed by its template arguments: the warp block ``FXxFY``,
    ``split`` where pair blocks are staged in several sub-batches, and
    ``groups`` where a block is a pixel group of a tile above 64."""
    import re

    entries = {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            args = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)E(?:Lb(\d)E)?", m.group(1))
            name = (f"{args.group(1)}x{args.group(2)}{' split' if args.group(3) == '1' else ''}"
                    f"{' groups' if args.group(4) == '1' else ''}") if args else m.group(1)
            entries[name] = []
        elif entries:
            entries[name].append(line)
    return {name: ptxas_resources(lines) for name, lines in entries.items()}


def binned_inputs(model, camera, cfg):
    """The forward kernel's inputs for one view, through the port's stages."""
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


def cuda_ms(fn, runs: int, warmup: int = 0):
    """Median milliseconds of ``fn()`` over ``runs`` calls after ``warmup``
    untimed ones, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def capture_graph(fn, runs: int, warmup: int = 0):
    """``runs`` calls of ``fn()`` captured in one CUDA graph after ``warmup``
    calls, and replayed once untimed (the first replay uploads it). A
    wrapper counts a captured call's launch once."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(runs):
            fn()
    graph.replay()
    return graph


def replay_ms(graph, runs: int, sleep_cycles: int = 0) -> float:
    """Device milliseconds of one of the ``runs`` calls in ``graph``: one
    replay between two CUDA events, over ``runs``. With ``sleep_cycles``
    the device first spins that many clock cycles (``torch.cuda._sleep``)
    while the host enqueues the events and the replay, so that the events
    time the graph's kernels back to back and not the host's launch of the
    graph; a replay that takes the host longer to enqueue raises."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        slept.record()
        torch.cuda._sleep(sleep_cycles)
    start.record()
    t0 = time.perf_counter()
    graph.replay()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if sleep_cycles and enqueue_ms >= slept.elapsed_time(start):
        raise RuntimeError(f"the host took {enqueue_ms} ms to enqueue a graph replay, longer than the device slept "
                           f"({slept.elapsed_time(start)} ms): raise sleep_cycles")
    return start.elapsed_time(end) / runs


def graph_ms(fn, runs: int, warmup: int = 0):
    """Device milliseconds of one ``fn()``, for calls whose host work
    outlasts their device work (CUDA events around one call would time the
    host): one timed replay of :func:`capture_graph`'s graph of ``runs``
    calls, over ``runs``."""
    return replay_ms(capture_graph(fn, runs, warmup), runs)


def random_cotangents(color, trans, seed: int):
    """Normal cotangents of the compositor's outputs, from a seeded
    generator on their device."""
    gen = torch.Generator(device=color.device).manual_seed(seed)
    return (torch.randn(color.shape, generator=gen, device=color.device),
            torch.randn(trans.shape, generator=gen, device=color.device))


def pair_pixels(args, n_tiles_x: int, cfg, blocks_done=None, chunk: int = 1 << 13) -> dict:
    """The pair-pixels a compositor pass over these inputs evaluates without
    culling (each pair slot a tile walks, up to ``blocks_done`` blocks, at
    each of the tile's pixels; alignment pads are not walked: ``walked``),
    those among them inside the pair's alpha-bound rect (``rect``), those
    at which the pair passes its gates (alpha, density, bbox: ``passed``),
    and the (warp, pair) evaluations of the culled kernels (``warp_pairs``,
    each 32 pair-pixels)."""
    from gsplat_tpu_torch.kernels import cull
    from gsplat_tpu_torch.ops import binning as B
    from gsplat_tpu_torch.ops.compositing import gaussian_alpha
    from gsplat_tpu_torch.render.tile_torch import tile_pixel_coords

    feat, pair_gaussian, tile_start, tile_count, tile_ids = args
    dev = feat.device
    ts = cfg.tile_size
    chunk = min(chunk, max((1 << 25) // ts ** 2, 1))  # at most 2^25 pair-pixels a chunk
    walked = tile_count.long()
    if blocks_done is not None:
        walked = torch.minimum(walked, blocks_done.long() * cfg.pair_block)
    tiles = torch.repeat_interleave(torch.arange(len(tile_ids), device=dev), walked)
    first = torch.cumsum(walked, 0) - walked
    slots = tile_start.long()[tiles] + torch.arange(len(tiles), device=dev) - first[tiles]
    px, py = tile_pixel_coords(tile_ids, n_tiles_x, ts, feat.dtype)
    passed = torch.zeros((), dtype=torch.int64, device=dev)
    rect_pixels = torch.zeros((), dtype=torch.int64, device=dev)
    warp_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(0, len(slots), chunk):
        rows = feat[pair_gaussian[slots[i:i + chunk]].long()]
        f = rows[:, :, None]  # [c, 16, 1]
        t = tile_ids[tiles[i:i + chunk]].long()
        x, y = px[tiles[i:i + chunk]], py[tiles[i:i + chunk]]  # [c, npix]
        at = gaussian_alpha(x, y, *(f[:, k] for k in (B.FEAT_MEAN_X, B.FEAT_MEAN_Y, B.FEAT_CONIC_X,
                                                      B.FEAT_CONIC_Y, B.FEAT_CONIC_XY, B.FEAT_OPACITY)))
        inside = ((x >= f[:, B.FEAT_X_MIN]) & (x < f[:, B.FEAT_X_MAX])
                  & (y >= f[:, B.FEAT_Y_MIN]) & (y < f[:, B.FEAT_Y_MAX]))
        passed += (at.valid & inside).sum()
        pixels, warps = cull.cull_counts(cull.pair_alpha_rect(rows), (t % n_tiles_x) * ts, (t // n_tiles_x) * ts, ts)
        rect_pixels += pixels.sum()
        warp_pairs += warps.sum()
    return {"walked": len(slots) * ts ** 2, "rect": int(rect_pixels), "passed": int(passed),
            "warp_pairs": int(warp_pairs)}


def compositor_bound(counts: dict, nbytes: int, backward: bool) -> dict:
    """A compositor's least time on this card for the work these inputs
    need (``counts`` from :func:`pair_pixels`): the gate and its expf at
    the walked pair-pixels inside each pair's alpha-bound rect
    (``bound_ms``; ``bound_unculled_ms`` at every walked pair-pixel), the
    rest only where the gate passes, against the bytes read and written
    once; the peaks and operations a pair-pixel are ``splatbench/counts.py``'s."""
    walked, rect, passed = counts["walked"], counts["rect"], counts["passed"]
    per_pass = BWD_PASSED_OPS if backward else FWD_PASSED_OPS
    out = {"pair_pixels": walked, "rect_pair_pixels": rect, "passed_pair_pixels": passed,
           "warp_pairs": counts["warp_pairs"], "passed_share": passed / max(walked, 1),
           "rect_share": rect / max(walked, 1), "warp_share": counts["warp_pairs"] * 32 / max(walked, 1),
           "bytes": nbytes, "bytes_ms": nbytes / PEAK_HBM_BYTES * 1e3}
    for suffix, gated in (("", rect), ("_unculled", walked)):
        fp32_ms = (gated * GATE_OPS + passed * per_pass) / PEAK_FP32_OPS * 1e3
        sfu_ms = (gated + (passed if backward else 0)) / PEAK_SFU * 1e3  # expf; the backward's division
        ops_ms = max(fp32_ms, sfu_ms)
        out.update({f"fp32{suffix}_ms": fp32_ms, f"sfu{suffix}_ms": sfu_ms, f"ops{suffix}_ms": ops_ms,
                    f"bound{suffix}_ms": max(out["bytes_ms"], ops_ms),
                    f"bound{suffix}_by": "operations" if ops_ms >= out["bytes_ms"] else "bytes"})
    return out


def bound_fields(bound: dict, ms: float) -> dict:
    """A kernel's bound, the unculled bound, their shares of the kernel's
    time and the culling counts."""
    return {"bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "share_of_bound": bound["bound_ms"] / ms,
            "bound_unculled_ms": bound["bound_unculled_ms"],
            "share_of_bound_unculled": bound["bound_unculled_ms"] / ms, "pair_pixels": bound["pair_pixels"],
            "rect_pair_pixels": bound["rect_pair_pixels"], "passed_pair_pixels": bound["passed_pair_pixels"],
            "warp_pairs": bound["warp_pairs"]}


def json_fields(obj):
    """(key, value) of every field of a JSON record, nested ones included."""
    if isinstance(obj, dict):
        for key, value in obj.items():
            yield key, value
            yield from json_fields(value)
    elif isinstance(obj, list):
        for value in obj:
            yield from json_fields(value)


def spawn_ranks(worlds, timeout_s: float, what: str) -> None:
    """Run worlds of ranks started by spawn, all at once: each entry of
    ``worlds`` is ``(fn, args, nprocs)``, and rank r runs ``fn(r, *args)``.
    Returns once every rank has exited 0 (a rank's exception is raised
    here); fails past ``timeout_s`` seconds from the start, and kills every
    rank still alive on the way out."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctxs = []
    try:
        for fn, args, nprocs in worlds:
            ctxs.append(mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn"))
        for ctx in ctxs:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 >= timeout_s:
                    raise RuntimeError(f"{what} ran past {timeout_s} s")
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(30)
