#!/usr/bin/env python3
"""Drive the PyTorch port's render path and training step on one CUDA card.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one NVIDIA H100 (or another sm_90a card) and the CUDA toolkit. It builds the
port's CUDA kernels from ``gsplat_tpu_torch/csrc`` (into ``build/kernels``),
then runs sixteen phases, each printing one JSON line:

  1. device: the card's name and power limit, torch/CUDA versions, kernel
     build time, the compiler's register report and each kernel's
     registers and spill bytes;
  2. small: the forward kernel against its plain PyTorch version on a
     256x192 frame of 20K gaussians (early stop off and 1e-4, where most
     tiles stop early), and a 64x48 render against the sequential oracle;
  3. served: the bench scene (1M gaussians, 1920x1080, SH degree 3,
     tile 32, chunk 32, pair block 128, capacity 1.5x the measured demand)
     answers three render requests through ``gsplat_tpu_torch.render``;
     the forward kernel's and the preprocess kernel's launch counts over
     those requests must be exactly 3 and the backward kernel's 0, and one
     full frame is held against the plain version;
  4. timing: the forward kernel alone and the plain version at the phase-3
     shapes, with the kernel's bounds on this card, and one request taken
     apart by the program's tracer (``stage_breakdown``: each stage's
     device and host ms, the host ms in sync spans and the counters), with
     its device-busy time and host synchronisations;
  5. grad_small: the backward kernel and the gradient reduction against
     their plain versions on the phase-2 frame (early stop off and 1e-4),
     every element within tolerance, two runs bitwise equal, and autograd
     through ``render`` on a 64x48 scene against autograd through the
     sequential oracle;
  6. train: the bench training step at the phase-3 scene (exact mode,
     ``rgb_loss`` against 0.25 with SSIM weight 0.2): one full-frame
     backward kernel against its plain version, then ``Trainer.fit`` for 3
     steps over the three phase-3 poses (finite losses, one forward, one
     backward and one preprocess backward launch per step, every parameter
     changed), the step's median
     time, device-busy time and the stages ``train_step`` marks (the
     backward's as ``loss_bwd``, ``raster_bwd``, ``reduction`` and
     ``preprocess_bwd``), the
     backward kernel's time against its bounds and the plain version's, the
     peak device memory, and the seconds the script has run so far;
  7. sliced_small: both carry kernels against their plain versions on every
     depth slice of the phase-2 frame (early stop off and 1e-4), two sliced
     runs under grad bitwise equal, and the sliced frame bitwise equal to
     the single-sort frame with early stop off;
  8. real_density: 5M gaussians at scale shift 1.9 (1080p, early stop 1e-4,
     capacity 1.1x the demand), depth-sliced and single-sort: three requests
     with their carry launches, the first slice's carry kernels against
     their plain versions, timed and bounded, and 3 ``fit`` steps and the
     step time of both paths;
  9. densify: training from SfM points (``densify_phase``): 500K points
     drawn from the phase-3 model, ``from_points3d`` (its
     ``knn_mean_sq_dist`` timed), 12 densifying ``fit`` steps on a pool of
     1M rows (``DENSIFY``; clone, split and prune counts from the log, one
     forward and one backward launch per step, the model compacted), a
     6-step ``fit`` with a loop checkpoint resumed by a fresh trainer to
     the same parameters bitwise, one densify pass, the densifying step
     against the plain one, checkpoint save and restore, the PLY round
     trip and ``render_depth`` (one forward launch, depth in range);
 10. cli: the command line (``cli_phase``) on a scene written to a
     temporary directory (``write_cli_scene``: the phase-3 model as the
     checkpoint, four views whose targets are its own renders, 100K SfM
     points drawn from it), driven in this process by
     ``click.testing.CliRunner``: ``evaluate`` (one forward launch per
     view, PSNR above 50 dB, SSIM above 0.99, each view's render ms), the
     same with ``--slice-pairs`` (forward carry launches only, the same
     ``metrics.json``), ``render``'s path (``render.png`` equal to the
     view's target, 40 progressive frames whose last is within 1e-5 of the
     render, the video), ``orbit`` (frame 0 equal to the target),
     ``finetune`` for 6 steps and as 3 steps resumed to 6 (the same PLY
     bytes), and ``train`` from the SfM points with a held-out view; each
     command's launches and seconds.
 11. mesh: the (data x tile) mesh path (``mesh_phase``). (a) A world of one
     over NCCL in this process: the phase-3 model's sharded render and
     batch render bitwise the phase-3 frames, the sharded binning stats
     equal to ``binning_stats``, one sharded step (SSIM weight 0.2) held to
     ``Trainer.train_step`` from the same state, the request and step ms,
     their stages and device-busy ms.
     (b) Four ranks spawned on this one card over gloo (``mesh_rank``), on
     1x4, 2x2 and 4x1 meshes of one world: the 1x4 sharded render and the
     2x2 batch render of four poses bitwise the single-device renders, a
     200x150 frame at tile 16 on 1x4 (shard padding tiles alias the next
     row or lie past the grid) bitwise, one SSIM-free step with one camera
     repeated over the batch on each mesh against the 1x1 step, and the same
     step with the pair reduction made exact (``RasterConfig.
     exact_grad_reduction``) on every mesh and on 1x1: with it, the means
     after the step at rtol 1e-4 / atol 1e-7 of 1x1's on every element;
     with the f32 reduction, the loss, and the means gradient no further
     from 1x1's exact-reduction gradient than twice 1x1's own f32 gradient
     is. Then a densifying 2x2 ``ParallelTrainer.fit`` from phase 9's cloud leaving the
     replicas bitwise equal. Its times are four processes sharing one card
     through the host, not multi-GPU times. (c) The command line with
     ``--mesh 1x1 --device cuda`` on phase 10's scene: ``orbit`` frames and
     ``evaluate``'s ``metrics.json`` equal to phase 10's, a 3-step
     ``finetune`` PLY bitwise a 1x1 ``ParallelTrainer``'s.
 12. tilings: the kernels at other tilings (``tilings_phase``). The phase-3
     model at tiles 16, 64 and 128 (capacity 1.5x each tiling's demand;
     128 runs as 2x2 pixel groups of one thread block each): a request and
     a depth-sliced request, each frame bitwise phase 3's tile-32 frame; the
     forward kernel bitwise its plain version, the backward and both carry
     kernels (first slice) against theirs, each timed with both bounds; the
     feature gradient with the exact pair reduction (bitwise repeatable)
     within the backward tolerance of tile 32's; at tiles 64 and 128 a
     one-step ``fit``, unsliced and sliced, its loss bitwise tile 32's.
     Then phase 2's frame at tiles 4, 12, 20, 40, 64, 65, 100, 128 and 256
     (above 64 as pixel groups; at 256 some groups lie wholly outside the
     frame) by pair blocks 8, 128 and 2048, early stop 0 and 1e-4: all
     four kernels against their plain versions (the carry forms on every
     depth slice), each twice bitwise; above 64 with early stop on, every
     forward call with its resume launch.
 13. scaling: the scaling harness (``scaling_phase``,
     ``tools/multihost.py``). Model mode on the phase-3 scene at tile
     factors 1, 2, 4 and 8 (tile 32, early stop 1e-4): shard (0, 0)'s
     stages timed on this card, every time finite and positive, each
     shard's pairs within its capacity, tp=1's pairs the unsharded
     binning's, and the strided extraction of the global
     ``coverage_histogram`` equal to the shard's tile counts at every tp;
     at every tp the forward on the shard's inputs bitwise its plain
     version and, tile by tile, the unsharded render, and the backward
     within ``rows_error`` of its plain version; then launch mode at 1x1
     under ``torch.distributed.run`` in a subprocess (exit 0, one forward
     and one backward launch a step, its loss within rel 1e-5 of as many
     ``Trainer.train_step`` calls in this process).
 14. bench: the benchmark script (``bench_phase``, ``tools/bench_torch.py``).
     (a) ``synthetic_bench`` in this process at its full sizes, ``ITERS``
     and budget: every line JSON, no extra skipped or in error, every fps
     positive, the headline's capacity and pairs per gaussian phase 3's,
     the real-density demand phase 8's, the headline loss within rel 1e-6
     of a step taken here on a fresh scene, and each kernel's launches over
     the call the plan's (the forward and backward: warm-up plus timed
     steps at each unsliced point; both carry kernels: phase 8's ``k_exec``
     per sliced step); then, at 4K, the densest sweep point and the
     real-density scene unsliced (exact mode and early stop 1e-4), the
     forward kernel bitwise its plain version and the backward's rows
     within ``rows_error`` of its plain version's, on the binned inputs
     of each point as the bench sized it. (b) ``tools/bench_torch.py
     --selftest`` as a command: exit 0, ``ok``, the image error 0.0.
 15. probes: the TPU probes' counterparts (``probes_phase``): the three
     tools ``tools/probe_transpose.py``, ``tools/probe_lane_dma.py`` and
     ``tools/orientation_test.py`` in this process at full size, every line
     JSON and every check of theirs holding on this card: the transposes,
     the bulk-copy slabs, both tensor-core modes and the TMA lane copy
     bitwise their plain versions, and all but one-pass TF32 bitwise the
     TPU probes' expectation; the transposes and both tensor-core modes
     at the tool's special blocks too (inf, NaN, signed zeros, subnormals,
     the smallest and largest normals, TF32 ties; random 32-bit patterns
     through the shared-memory transpose): NaN where the plain version
     has it, every other element's bits equal, and 3xTF32 bitwise ``x.T``
     at the finite normal blocks; both orientation kernels at 268M pair-pixels
     within rtol 1e-5 of their plain versions, zero at the TPU probe's
     inputs, and at the sparse set (one passed pair a pixel a chunk, T
     above zero to the end) T bitwise theirs; each probe kernel's launches
     the tools' plan. Then the orientation kernels at 2 chunks
     (``probe_checks``): exactly zero at t0 = 0 and within rtol 1e-5 of
     their plain versions at t0 = 1. Their times (the transposes: medians
     and quartiles of alternating rounds; orientation: ms and ns a
     pair-pixel at each feature set beside the one-SM bounds) go to the
     ``kernels`` line.
 16. preprocess: the preprocess kernels (``preprocess_phase``,
     ``kernels/preprocess.py``) at the headline (1M) and dense (5M) scenes
     at the eight ``orbit8`` poses of ``splatbench/traffic/render.json``:
     every forward output but rgb bitwise the eager path's, rgb within
     ``RGB_ATOL`` (its sums in another order); the forward's device ms in
     queued rounds and from the profiler beside its bytes bound, the eager
     path's ms, the device operations of a grad-free preprocess (at most 4,
     the nodes of its CUDA graph capture) and of the eager one (the
     profiler's); the backward kernel's gradients against the eager
     autograd and its times beside its bytes bound and the eager
     backward's, at both scenes and at ``recipe_5m``'s pool of 10,000,128
     rows (the forward's time there too); a dense request's and training
     step's stages, with ``preprocess_kernel`` counted 1 on both,
     ``preprocess_bwd_kernel`` 1 on the step, and each kernel launched once
     a step.

A kernel's bound counts the work its inputs need. ``bound_ms`` charges the
gate (and its expf) only at the walked pair-pixels inside each pair's
alpha-bound rect (``kernels/cull.py``): outside it the gate cannot pass, so
that work is not needed, and the kernels skip it in each warp whose pixels
the rect misses. ``bound_unculled_ms``, kept for comparison with the first
ports' rows, charges the gate at every pair-pixel walked. Both charge the
compositing or gradient work only at the pair-pixels that pass the gate, and
the bytes read and written once. The script counts the pair-pixels of each
kind and the (warp, pair) evaluations the culled kernels make
(``warp_pairs``).

The card's machine has no matplotlib (``PERF.md`` §3), which ``render``
draws its comparison figure with, so phase 10 runs that command's path
through its own helpers and ``gsplat_tpu_torch/utils/video.py`` and does not
invoke it.

It then prints ``nvidia-smi``'s name/power-limit line, the ``kernels`` JSON
line (each compositor's launches on the main path and in phases 9, 10, 11,
12, 13 and 14, phase 11's summed over every rank and phase 13's over model
mode and the launch run, and its times and bounds at phase 12's tilings;
then each probe kernel's launches, times and bounds from phase 15, and
the preprocess kernel's launches on the main path (phase 3) and over
phase 16, with its times and bounds from phase 16, and the preprocess
backward kernel's over phase 6's steps and phase 16) and,
last, ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result; it also refuses to run
without a CUDA device or without the ``gsplat_tpu_torch`` package beside it.
It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import logging
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
# Operations per pair-pixel (csrc/raster_common.cuh, raster_fwd.cu,
# raster_bwd.cu). Every walked pair-pixel needs its gate: d = mean - pixel
# (2), the quadratic form and density (9), raw and the alpha clamp (2), the
# bbox (4) and the alpha and density tests (2), and one expf on the SFU.
# Only where the gate passes is there more to do: the forward's compositing
# (w, three colour multiply-adds, T: 9); the backward's walk (w, u, S, 1-a,
# d_a, the raw clamp, d_density, T: 14, and a division on the SFU), its nine
# per-pixel gradient terms (20) and their pixel sums (9). Where the gate
# fails, alpha is 0 and colour, T, S and every gradient stay as they were.
GATE_FP32_OPS = 19
FWD_PASSED_FP32_OPS = 9
BWD_PASSED_FP32_OPS = 43

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
# Training from SfM points (phase 9): a cloud of MipNeRF-360 size drawn from
# the headline model, its pool the headline's N, 12 densifying steps with
# passes at steps 4 and 8, an opacity reset at 6 and the size prune from 4.
# The views are the three headline poses moved sideways, so that the
# cameras' centres spread and the scene extent is 0.55 (the headline poses
# share one centre, which gives camera_extent its 1e-6 floor). The
# thresholds are set from this cloud's spread (PERF.md, PR 5): the
# viewspace gradient's 99th percentile at step 4 is about 3e-5 (the 3DGS
# default 2e-4 makes no candidate), the initial scales are 0.05-0.26 of the
# extent and the radii up to about 60 px, so that every pass clones, splits
# and prunes.
SFM_POINTS = 500_000
DENSIFY_STEPS = 12
DENSIFY_POSES = [("bench", 0.0, 0.0), ("left", 0.05, 0.5), ("right", -0.05, -0.5)]  # name, yaw, x shift
DENSIFY = dict(every=4, start=4, grad_threshold=1e-5, prune_scale_extent=0.25, max_screen_size=55.0,
               size_prune_start=4, percent_dense=0.1, opacity_reset_every=6, pool_factor=2.0)
# The command line (phase 10) on a scene written to disk: the headline model
# as the trained checkpoint; four views, the bench pose and three yaw and
# x-shift moves, whose ground truth is the model's own render; an SfM cloud
# drawn from the model (100K points: at 500K, knn_mean_sq_dist alone takes
# 9.2 s, and phase 9 covers that size). The sliced `evaluate` slices 2^17
# pairs.
CLI_POSES = DENSIFY_POSES + [("far_left", 0.1, 1.0)]
CLI_SFM_POINTS = 100_000
CLI_SLICE_PAIRS = 1 << 17
# The mesh path (phase 11): the phase-3 poses and one more, a frame whose
# 16-pixel tile grid (13x10) does not divide by the 1x4 mesh's 2x2 stride,
# and a densifying 2x2 fit from phase 9's cloud, passing at step 4.
MESH_POSES = [("bench", 0.0), ("yaw+0.05", 0.05), ("yaw-0.05", -0.05), ("yaw+0.1", 0.1)]
MESH_PAD = (200, 150)
MESH_FIT_STEPS = 6
MESH_TIMEOUT_S = 600  # each collective's limit, and the gloo world's from spawn to join
# Tilings (phase 12): the headline at tiles 16, 64 and 128 beside phase 3's
# 32, its depth-sliced path at 2^17 pairs a slice; phase 2's scene and frame
# at every tile and pair block below (above 64: pixel groups).
TILING_FULL = (16, 64, 128)
TILING_SLICE = 1 << 17
TILING_SMALL_N, TILING_SMALL_FRAME = 20_000, (256, 192)
TILING_SMALL_TILES = (4, 12, 20, 40, 64, 65, 100, 128, 256)
# Above 64 the frame takes fewer, larger splats (the bench distribution at
# scale shift 3.5): every 64-pixel group saturates within a few pair blocks,
# so groups of one tile stop at different blocks and the resume has work; a
# tile holds all its pairs, whose count sets the plain versions' time.
TILING_LARGE_N, TILING_LARGE_SHIFT = 6_000, 3.5
TILING_SMALL_BLOCKS = (8, 128, 2048)
# The scaling harness (phase 13): tools/multihost.py's model mode on the
# headline scene at these tile factors, each stage the median of this many
# calls, and its launch mode at 1x1 for as many steps.
SCALING_TP = (1, 2, 4, 8)
SCALING_STEPS = 8
SCALING_LAUNCH_TIMEOUT_S = 300
# The benchmark script (phase 14): its selftest command's time limit, and
# the most tiles a plain version walks at once where phase 14 holds the
# kernels to them (a 4K frame's 8160 tiles at once would hold tens of GB of
# [tiles, chunk, pixels] temporaries; a 1080p frame's 2040 are one group).
BENCH_SELFTEST_TIMEOUT_S = 300
BENCH_PLAIN_TILES = 2048


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


def bench_camera(width: int, height: int, yaw: float = 0.0, shift: float = 0.0):
    """The bench camera (bench.py:220-231), optionally turned by ``yaw``
    radians about +y and moved by ``shift`` along its x axis (tvec)."""
    from gsplat_tpu_torch import CameraParams

    fx = 0.8 * width
    return CameraParams(
        width=width, height=height,
        fov_x=2 * math.atan(width / (2 * fx)), fov_y=2 * math.atan(height / (2 * fx)),
        focal_x=fx, focal_y=fx,
        qvec=(math.cos(yaw / 2), 0.0, math.sin(yaw / 2), 0.0), tvec=(shift, 0.0, 0.0),
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


def cuda_ms(fn, runs: int, warmup: int = 0):
    """Median milliseconds of ``fn()`` over ``runs`` calls after ``warmup``
    untimed ones, CUDA events."""
    import torch

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


def device_busy_ms(fn):
    """Milliseconds the device spends in kernels during one ``fn()``, from
    ``torch.profiler`` (None where it records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    )
    return busy_us / 1e3 if busy_us > 0 else None


def capture_graph(fn, runs: int, warmup: int = 0):
    """``runs`` calls of ``fn()`` captured in one CUDA graph after ``warmup``
    calls, and replayed once untimed (the first replay uploads it). A
    wrapper counts a captured call's launch once."""
    import torch

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
    import torch

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


def host_syncs(fn) -> int:
    """Host synchronisations PyTorch reports during one ``fn()``
    (``torch.cuda.set_sync_debug_mode``, a prototype that may miss some)."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(c.message) for c in caught)


def random_cotangents(color, trans, seed: int):
    """Normal cotangents of the compositor's outputs, from a seeded
    generator on their device."""
    import torch

    gen = torch.Generator(device=color.device).manual_seed(seed)
    return (torch.randn(color.shape, generator=gen, device=color.device),
            torch.randn(trans.shape, generator=gen, device=color.device))


def rows_error(got, want, what: str) -> dict:
    """Gradient rows of the kernel (per-pair rows, or reduced ``d_feat``)
    against the plain version's, column by column: every element must be
    within rtol 1e-4 plus atol 1e-5 of its own column's largest magnitude
    (the pixel sums run in another order, and the sort + cumsum reduction
    turns a last-bit difference of a row into about an ulp of its running
    sum; see tests/test_torch_gpu.py). Raises otherwise; returns the rows
    either makes nonzero, the largest absolute error, and each column's
    largest absolute error and largest magnitude."""
    err = (got - want).abs()
    col_max = want.abs().amax(0)
    outside = int((err > 1e-4 * want.abs() + 1e-5 * col_max).any(1).sum())
    out = {"rows_walked": int(((got != 0) | (want != 0)).any(1).sum()), "rows_outside": outside,
           "max_abs_err": float(err.max()), "col_max_abs_err": err.amax(0)[:9].tolist(),
           "col_max": col_max[:9].tolist()}
    check(outside == 0, f"{what}: {outside} rows beyond tolerance: {out}")
    return out


def pair_pixels(args, n_tiles_x: int, cfg, blocks_done=None, chunk: int = 1 << 13) -> dict:
    """The pair-pixels a compositor pass over these inputs evaluates without
    culling (each pair slot a tile walks, up to ``blocks_done`` blocks, at
    each of the tile's pixels; alignment pads are not walked: ``walked``),
    those among them inside the pair's alpha-bound rect (``rect``), those
    at which the pair passes its gates (alpha, density, bbox: ``passed``),
    and the (warp, pair) evaluations of the culled kernels (``warp_pairs``,
    each 32 pair-pixels)."""
    import torch

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
    need (``counts`` from :func:`pair_pixels`): the gate and its expf at the
    walked pair-pixels inside each pair's alpha-bound rect (``bound_ms``;
    ``bound_unculled_ms`` at every walked pair-pixel), the rest only where
    the gate passes, against the bytes read and written once."""
    walked, rect, passed = counts["walked"], counts["rect"], counts["passed"]
    per_pass = BWD_PASSED_FP32_OPS if backward else FWD_PASSED_FP32_OPS
    out = {"pair_pixels": walked, "rect_pair_pixels": rect, "passed_pair_pixels": passed,
           "warp_pairs": counts["warp_pairs"], "passed_share": passed / max(walked, 1),
           "rect_share": rect / max(walked, 1), "warp_share": counts["warp_pairs"] * 32 / max(walked, 1),
           "bytes": nbytes, "bytes_ms": nbytes / PEAK_HBM_BYTES * 1e3}
    for suffix, gated in (("", rect), ("_unculled", walked)):
        fp32_ms = (gated * GATE_FP32_OPS + passed * per_pass) / PEAK_FP32_OPS * 1e3
        sfu_ms = (gated + (passed if backward else 0)) / PEAK_SFU_EXP * 1e3  # expf; the backward's division
        ops_ms = max(fp32_ms, sfu_ms)
        out.update({f"fp32{suffix}_ms": fp32_ms, f"sfu{suffix}_ms": sfu_ms, f"ops{suffix}_ms": ops_ms,
                    f"bound{suffix}_ms": max(out["bytes_ms"], ops_ms),
                    f"bound{suffix}_by": "operations" if ops_ms >= out["bytes_ms"] else "bytes"})
    return out


def bound_fields(bound: dict, ms: float) -> dict:
    """A kernel's bound, the unculled bound, their shares of the kernel's
    time and the culling counts, for the ``kernels`` line."""
    return {"bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "share_of_bound": bound["bound_ms"] / ms,
            "bound_unculled_ms": bound["bound_unculled_ms"],
            "share_of_bound_unculled": bound["bound_unculled_ms"] / ms, "pair_pixels": bound["pair_pixels"],
            "rect_pair_pixels": bound["rect_pair_pixels"], "passed_pair_pixels": bound["passed_pair_pixels"],
            "warp_pairs": bound["warp_pairs"]}


def stage_breakdown(fn, runs: int = 5) -> dict:
    """One ``fn()`` taken apart by the program's tracer
    (``gsplat_tpu_torch/utils/stages.py``), the median over ``runs`` calls
    of each stage's CUDA-event milliseconds (``device_ms``) and host
    milliseconds (``host_ms``), of the host milliseconds in sync spans
    (``sync_wait_ms``) and of each counter's sum (``counters``). A stage
    marked several times in one call (the depth-sliced path marks each
    slice) counts the sum of its spans; a span inside one of its own name
    is not counted again. A training step's backward shows as its own
    stages: ``loss_bwd`` (the loss's and the image assembly's backward),
    ``raster_bwd``, ``reduction`` and ``preprocess_bwd`` (autograd through
    pack_features and the preprocess)."""
    import torch

    from gsplat_tpu_torch.utils.stages import record_stages

    samples = {"device_ms": {}, "host_ms": {}, "counters": {}}
    waits = []
    for _ in range(runs):
        with record_stages() as rec:
            fn()
        torch.cuda.synchronize()
        by_id = {s.id: s for s in rec.spans}
        dev, host, counters = {}, {}, {}
        for s in rec.spans:
            up = by_id.get(s.parent)
            while up is not None and up.name != s.name:
                up = by_id.get(up.parent)
            if up is not None:
                continue
            dev[s.name] = dev.get(s.name, 0.0) + s.start.elapsed_time(s.end)
            host[s.name] = host.get(s.name, 0.0) + (s.host_end_ns - s.host_start_ns) / 1e6
        for name, _, value in rec.counter_values():
            counters[name] = counters.get(name, 0) + value
        for key, got in (("device_ms", dev), ("host_ms", host), ("counters", counters)):
            for name, value in got.items():
                samples[key].setdefault(name, []).append(value)
        waits.append(sum(s.host_end_ns - s.host_start_ns for s in rec.spans if s.sync) / 1e6)
    out = {key: {name: statistics.median(v) for name, v in got.items()} for key, got in samples.items()}
    out["sync_wait_ms"] = statistics.median(waits)
    return out


def request_breakdown(model, camera, cfg, runs: int = 5) -> dict:
    """One render request taken apart: the stages ``gs.render`` marks
    (median of ``runs``), the whole request (CUDA events), the device-busy
    milliseconds of one request from ``torch.profiler`` (None where the
    profiler records no device time), and the host synchronisations one
    request and its binning make."""
    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.render.pipeline import preprocess

    w, h = camera.width, camera.height
    out = {"stages": stage_breakdown(lambda: gs.render(model, camera, cfg), runs),
           "request_ms": cuda_ms(lambda: gs.render(model, camera, cfg), runs)}
    out["device_busy_ms"] = device_busy_ms(lambda: gs.render(model, camera, cfg))
    out["request_host_syncs"] = host_syncs(lambda: gs.render(model, camera, cfg))
    prep = preprocess(model, camera, cfg)
    out["binning_host_syncs"] = host_syncs(
        lambda: binning.bin_gaussians(prep, w, h, cfg.tile_size, cfg.max_pairs, align=cfg.pair_block))
    return out


def sliced_records(model, camera, cfg):
    """One depth-sliced forward through the port's stages, keeping what the
    slice loop records: (feat, color, trans, records; ``render/sliced.py``)."""
    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.render import sliced
    from gsplat_tpu_torch.render.pipeline import preprocess_traced

    w, h, ts = camera.width, camera.height, cfg.tile_size
    prep = preprocess_traced(model, gs.CameraArrays.from_params(camera, device=model.means.device), w, h, cfg)
    feat = binning.pack_features(prep)
    d = sliced._prepare_sliced(prep, ts, -(-w // ts), -(-h // ts))
    return (feat, *sliced._forward_impl(feat, d, w, h, cfg))


def carry_chain(feat, rec, n_tiles_x, cfg, width, height, g_color, g_trans) -> dict:
    """Walk the recorded slices through both carry kernels and their plain
    versions, each from the kernel chain's state before the slice: the
    forward's colour and T bitwise, ``blocks_done`` equal to the plain
    version's and to the record; the backward's rows and
    reduced ``d_feat`` by ``rows_error``, its T at rtol 1e-5 / atol 1e-6 and
    its S by ``rows_error``. Returns the largest errors and the chain's end."""
    import torch

    from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles_carry, backward_tiles_plain, reduce_sorted, walk_state
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles_carry, forward_tiles_plain

    num_t, npix = g_trans.shape
    tile_ids = torch.arange(num_t, dtype=torch.int32, device=feat.device)
    carry = (torch.zeros(num_t, npix, 3, device=feat.device), torch.ones(num_t, npix, device=feat.device))
    out = {"fwd_max_abs_err": 0.0, "rows_max_abs_err": 0.0, "state_max_abs_err": 0.0}
    for k in range(len(rec.ids)):
        args = (feat, rec.ids[k], rec.starts[k], rec.countc[k], tile_ids)
        got = forward_tiles_carry(*args, *carry, n_tiles_x, cfg, width, height)
        torch.cuda.synchronize()
        want = forward_tiles_plain(*args, n_tiles_x, cfg, width, height, carry=carry)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"slice {k} forward bitwise")
        check(torch.equal(got[2], want[2]) and torch.equal(got[2], rec.bdone[k]), f"slice {k} blocks_done")
        out["fwd_max_abs_err"] = max(out["fwd_max_abs_err"], float((got[0] - want[0]).abs().max()),
                                     float((got[1] - want[1]).abs().max()))
        carry = got[:2]
    state = walk_state(*carry, g_color, g_trans)
    n_rows = feat.shape[0]
    d_feat = p_feat = torch.zeros(n_rows, 16, device=feat.device)
    for k in range(len(rec.ids)):
        args = (feat, rec.ids[k], rec.starts[k], rec.countc[k], tile_ids)
        rows, s_out = backward_tiles_carry(*args, state, g_color, n_tiles_x, cfg, rec.bdone[k])
        torch.cuda.synchronize()
        p_rows, p_out = backward_tiles_plain(*args, None, None, g_color, None, n_tiles_x, cfg, rec.bdone[k], state)
        out["rows_max_abs_err"] = max(out["rows_max_abs_err"], rows_error(rows, p_rows, f"slice {k} rows")["max_abs_err"])
        torch.testing.assert_close(s_out[:, 1], p_out[:, 1], rtol=1e-5, atol=1e-6)
        err = rows_error(s_out[:, 0].reshape(-1, 1), p_out[:, 0].reshape(-1, 1), f"slice {k} S")["max_abs_err"]
        out["state_max_abs_err"] = max(out["state_max_abs_err"], err, float((s_out[:, 1] - p_out[:, 1]).abs().max()))
        d_feat = d_feat + reduce_sorted(rows, rec.ids[k], n_rows)
        p_feat = p_feat + reduce_sorted(p_rows, rec.ids[k], n_rows)
        state = s_out
    out["d_feat"] = rows_error(d_feat, p_feat, "sliced d_feat")
    out["color"], out["trans"] = carry
    return out


def quantiles(x) -> list:
    """The 1st, 10th, 50th, 90th and 99th percentiles of the values of ``x``."""
    import torch

    x = x.reshape(-1).float()
    if x.numel() == 0:
        return []
    return torch.quantile(x, torch.tensor([0.01, 0.1, 0.5, 0.9, 0.99], device=x.device)).tolist()


class LogLines(logging.Handler):
    """A logging handler that keeps each record's message."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def densify_inputs(cfg, dev):
    """Phase 9's views and SfM cloud: the headline model seen from
    ``DENSIFY_POSES`` as the targets, and ``SFM_POINTS`` points drawn from
    its means, coloured by its DC band, as COLMAP's reader gives them (f64
    positions, uint8 colours). Returns (views, xyzs, rgbs)."""
    import torch

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.ops.sh import SH_C0

    cams = [bench_camera(WIDTH, HEIGHT, yaw, shift) for _, yaw, shift in DENSIFY_POSES]
    with torch.inference_mode():
        bench = build_scene(NUM_GAUSSIANS, 0.0, dev)
        frames = [gs.render(bench, cam, cfg)[0] for cam in cams]
        pick = torch.randperm(NUM_GAUSSIANS, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        pick = pick[:SFM_POINTS]
        xyzs = bench.means[pick].double().cpu().numpy()
        rgbs = ((bench.sh[pick, 0] * SH_C0 + 0.5).clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).cpu().numpy()
    return [(cam, img.clone()) for cam, img in zip(cams, frames)], xyzs, rgbs  # normal tensors: loss targets


def densify_phase(cfg, dev, t_main: float):
    """Phase 9: train from an SfM cloud with densification, a loop
    checkpoint and a resume, then export and render depth, on ``dev``.
    Returns (the phase's record, the fit's launches, render_depth's forward
    launches)."""
    import dataclasses
    import re
    import tempfile

    import torch

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles, backward_tiles_carry
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_carry
    from gsplat_tpu_torch.models.gaussians import PARAM_NAMES
    from gsplat_tpu_torch.train import checkpoint as CK
    from gsplat_tpu_torch.train import densify as D
    from gsplat_tpu_torch.utils.logging import get_logger
    from gsplat_tpu_torch.utils.stages import record_stages

    out = {"sfm_points": SFM_POINTS, "steps": DENSIFY_STEPS, "poses": DENSIFY_POSES, "config": DENSIFY}
    views, xyzs, rgbs = densify_inputs(cfg, dev)
    cams = [cam for cam, _ in views]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record_stages() as spans:  # from_points3d marks its knn_mean_sq_dist
        init = gs.GaussianModel.from_points3d(xyzs, rgbs, device=dev)
    torch.cuda.synchronize()
    out["from_points3d_s"] = time.perf_counter() - t0
    out["knn_mean_sq_dist_s"] = sum(a.elapsed_time(b) for name, a, b in spans if name == "knn_mean_sq_dist") / 1e3
    with torch.inference_mode():
        probe = dataclasses.replace(cfg, max_pairs=1 << 20)
        demand = max(int(gs.binning_stats(init, gs.CameraArrays.from_params(cam, device=dev), WIDTH, HEIGHT,
                                          probe)["pair_demand"]) for cam in cams)
    dcfg = dataclasses.replace(cfg, max_pairs=max(int(demand * 2) // 128 * 128, CAPACITY_FLOOR))
    out.update({"pair_demand": demand, "capacity": dcfg.max_pairs, "scene_extent": D.camera_extent(cams),
                "pool": D.pool_capacity(SFM_POINTS, gs.DensifyConfig(**DENSIFY))})

    dc = gs.DensifyConfig(**DENSIFY)
    tc = gs.TrainConfig(ssim_weight=0.2, steps=DENSIFY_STEPS, log_every=1, densify=dc)
    # What each pass decides on: the accumulated state's spread.
    pass_inputs = []
    real_pass = D.densify_prune_step

    def recording_pass(model, state, generator, extent, config, step):
        alive = D.alive_mask(model)
        seen = alive & (state.grad_count > 0)
        avg_grad = state.grad_sum / state.grad_count.clamp(min=1)
        size = torch.exp(model.log_scales.detach().amax(-1)) / extent
        pass_inputs.append({
            "step": step, "alive": int(alive.sum()), "seen": int(seen.sum()),
            "avg_grad_q": quantiles(avg_grad[seen]), "max_scale_over_extent_q": quantiles(size[alive]),
            "candidate_max_scale_over_extent_q": quantiles(size[seen & (avg_grad >= config.grad_threshold)]),
            "max_radius_q": quantiles(state.max_radius[alive]),
        })
        return real_pass(model, state, generator, extent, config, step=step)

    log = LogLines()
    logger = get_logger()
    logger.addHandler(log)
    D.densify_prune_step = recording_pass
    trainer = gs.Trainer(raster=dcfg, train=tc, show_progress=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forward_tiles.launches = backward_tiles.launches = forward_tiles_carry.launches = backward_tiles_carry.launches = 0
    fit0 = time.perf_counter()
    ticks = [fit0]  # a history record (a host sync) closes every step
    final, history = trainer.fit(init, views, log_fn=lambda record: ticks.append(time.perf_counter()))
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - fit0
    out["fit_step_s"] = [b - a for a, b in zip(ticks, ticks[1:])]
    launches = {"raster_fwd": forward_tiles.launches, "raster_bwd": backward_tiles.launches,
                "raster_fwd_carry": forward_tiles_carry.launches, "raster_bwd_carry": backward_tiles_carry.launches}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    D.densify_prune_step = real_pass
    logger.removeHandler(log)
    passes = []
    for line in log.lines:
        m = re.fullmatch(r"densify @(\d+): \+(\d+) clone \+(\d+) split -(\d+) prune \((\d+) alive\)", line)
        if m:
            passes.append(dict(zip(("step", "cloned", "split", "pruned", "alive"), map(int, m.groups()))))
    out.update({"losses": [h["loss"] for h in history], "psnr": [h["psnr"] for h in history], "launches": launches,
                "passes": passes, "pass_inputs": pass_inputs, "num_gaussians": final.num_gaussians})
    check(len(history) == DENSIFY_STEPS and all(math.isfinite(h["loss"]) for h in history), f"finite losses: {history}")
    check(launches == {"raster_fwd": DENSIFY_STEPS, "raster_bwd": DENSIFY_STEPS, "raster_fwd_carry": 0,
                       "raster_bwd_carry": 0}, f"one forward and one backward launch per step: {launches}")
    check([p["step"] for p in passes] == [4, 8], f"passes at steps 4 and 8: {passes}")
    for key in ("cloned", "split", "pruned"):
        check(all(p[key] > 0 for p in passes), f"every pass has {key} gaussians: {passes}")
    check(final.num_gaussians == int(D.num_alive(final)) == passes[-1]["alive"], "the returned model is compacted")
    check(trainer.raster == dcfg, "no capacity resize at 2x the initial demand")

    # Interrupted at half way, resumed by a fresh trainer: bitwise the same.
    with tempfile.TemporaryDirectory() as tmp:
        gs.Trainer(raster=dcfg, train=tc, show_progress=False).fit(init, views, steps=DENSIFY_STEPS // 2,
                                                                   checkpoint_dir=tmp)
        resumed, r_history = gs.Trainer(raster=dcfg, train=tc, show_progress=False).fit(
            init, views, checkpoint_dir=tmp, resume=True)
        check(r_history[0]["step"] == DENSIFY_STEPS // 2, "the second fit resumed")
        check(all(torch.equal(getattr(resumed, k), getattr(final, k)) for k in PARAM_NAMES),
              "the resumed run reaches the uninterrupted run's parameters bitwise")
        check([h["loss"] for h in r_history] == out["losses"][DENSIFY_STEPS // 2:], "resumed losses bitwise")
        del resumed
        # Checkpoint I/O at the pool's size: the state saved at the end.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool, optimizer, next_step, dstate, generator = CK.restore_loop_state(tmp, trainer.init_state, device=dev)
        torch.cuda.synchronize()
        out["checkpoint_restore_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        CK.save_loop_state(tmp, pool, optimizer, next_step, dstate, generator)
        out["checkpoint_save_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = os.path.getsize(CK.loop_state_path(tmp))
    check(next_step == DENSIFY_STEPS and pool.num_gaussians == out["pool"], "the saved state is the final pool")

    # One pass on copies of the final pool (its last window's state).
    times, stats = [], None
    extent = D.camera_extent(cams)
    for _ in range(5):
        copy = gs.GaussianModel(*(getattr(pool, k).detach().clone() for k in PARAM_NAMES))
        gen = torch.Generator(device=dev)
        gen.set_state(generator.get_state())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, _, stats = D.densify_prune_step(copy, dstate, gen, extent, dc, step=DENSIFY_STEPS)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del copy
    out["densify_prune_step"] = {"ms": statistics.median(times), "pool": pool.num_gaussians, "stats": stats}

    # The densifying step (viewspace probe and radii) beside a plain step.
    cam0 = gs.CameraArrays.from_params(cams[0], device=dev)
    target, bg = views[0][1], torch.zeros(3, device=dev)

    def densifying_step():
        trainer._step_vs(pool, optimizer, cam0, target, bg, WIDTH, HEIGHT, dcfg)

    def plain_step():
        trainer.train_step(pool, optimizer, cams[0], target)

    densifying_step()
    plain_step()
    times = {densifying_step: [], plain_step: []}
    for i in range(5):  # in turns, each side first in alternate rounds
        for fn in (densifying_step, plain_step)[:: 1 - 2 * (i % 2)]:
            times[fn].append(cuda_ms(fn, 1))
    out["step"] = {"densifying_ms": statistics.median(times[densifying_step]),
                   "plain_ms": statistics.median(times[plain_step]),
                   "densifying_device_busy_ms": device_busy_ms(densifying_step),
                   "plain_device_busy_ms": device_busy_ms(plain_step)}
    del pool, optimizer, dstate

    # Export: the compacted model's PLY loads back bitwise.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        CK.save_ply_checkpoint(tmp, final, DENSIFY_STEPS)
        back = CK.load_ply_checkpoint(tmp, DENSIFY_STEPS, device=dev)
        out["ply_roundtrip_s"] = time.perf_counter() - t0
    check(all(torch.equal(getattr(back, k), getattr(final, k)) for k in PARAM_NAMES), "PLY round trip bitwise")
    del back

    # The depth map of the trained model: one forward launch.
    with torch.inference_mode():
        forward_tiles.launches = backward_tiles.launches = 0
        depth, trans = gs.render_depth(final, cam0, WIDTH, HEIGHT, dcfg)
        torch.cuda.synchronize()
        depth_launches = forward_tiles.launches
        check((depth_launches, backward_tiles.launches) == (1, 0), "render_depth: one forward launch")
        check(bool(torch.isfinite(depth).all()), "finite depth")
        covered = 1.0 - trans
        check(bool((depth >= 0.2 * covered - 1e-4).all() and (depth <= 100.0 * covered + 1e-3).all()),
              "depth within [near (1 - T), far (1 - T)]")
        out["depth"] = {"covered_share": float((trans < 0.5).float().mean()),
                        "median_normalised_depth": float((depth / covered.clamp(min=1e-6))[trans < 0.5].median())}
    out["elapsed_s"] = time.perf_counter() - t_main  # since main() began, the build included
    return out, launches, depth_launches


def write_cli_scene(root: str, dev) -> dict:
    """The scene phase 10 runs the command line on, written with the port's
    own writers: ``sparse/0`` (one PINHOLE camera at the bench focal, the
    ``CLI_POSES`` images, ``CLI_SFM_POINTS`` points drawn from the headline
    model and coloured by its DC band), the headline model as
    ``model/point_cloud/iteration_30000/point_cloud.ply``, and as each
    view's ground truth ``images_1/<pose>.png`` the model's render from the
    camera read back through ``read_scene`` and ``CameraParams.from_colmap``
    with the CLI's default raster settings, saved by ``save_frame``.
    Returns the seconds of each part."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch import cli as C
    from gsplat_tpu_torch.io import colmap
    from gsplat_tpu_torch.io.ply import save_splat_arrays
    from gsplat_tpu_torch.io.scene import checkpoint_ply_path, read_scene
    from gsplat_tpu_torch.ops.sh import SH_C0
    from gsplat_tpu_torch.utils.video import save_frame

    out = {}
    t0 = time.perf_counter()
    sparse = os.path.join(root, "sparse/0")
    fx = 0.8 * WIDTH  # bench_camera's focal
    colmap.write_intrinsics_binary(os.path.join(sparse, "cameras.bin"), {1: colmap.Camera(
        id=1, model="PINHOLE", width=WIDTH, height=HEIGHT, params=np.array([fx, fx, WIDTH / 2, HEIGHT / 2]))})
    images = {}
    for i, (name, yaw, shift) in enumerate(CLI_POSES):
        cam = bench_camera(WIDTH, HEIGHT, yaw, shift)
        images[i] = colmap.BaseImage(id=i, qvec=np.array(cam.qvec), tvec=np.array(cam.tvec), camera_id=1,
                                     name=f"{name}.png", xys=np.zeros((0, 2)), point3D_ids=np.zeros((0,), np.int64))
    colmap.write_extrinsics_binary(os.path.join(sparse, "images.bin"), images)
    with torch.inference_mode():
        model = build_scene(NUM_GAUSSIANS, 0.0, dev)
        pick = torch.randperm(NUM_GAUSSIANS, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        pick = pick[:CLI_SFM_POINTS]
        rgbs = ((model.sh[pick, 0] * SH_C0 + 0.5).clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).cpu().numpy()
        colmap.write_points3D_binary(os.path.join(sparse, "points3D.bin"), model.means[pick].double().cpu().numpy(),
                                     rgbs)
    save_splat_arrays(checkpoint_ply_path(os.path.join(root, "model")), model.to_arrays())
    out["write_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = C._raster_config(32, 32, 1 << 22, 0.0, dev.type)
    scenes, cams = read_scene(root)
    os.makedirs(os.path.join(root, "images_1"))
    with torch.inference_mode():
        frames = {image.name: gs.render(model, gs.CameraParams.from_colmap(image, cams[image.camera_id], WIDTH, HEIGHT),
                                        cfg)[0].cpu().numpy() for image in scenes.values()}
    with ThreadPoolExecutor(len(frames)) as pool:  # a 1080p PNG takes about a second to compress
        for done in [pool.submit(save_frame, os.path.join(root, "images_1", name), f) for name, f in frames.items()]:
            done.result()
    out["targets_s"] = time.perf_counter() - t0
    return out


def cli_invoke(args) -> None:
    """Run the port's command line in this process; raise on a failed exit."""
    import traceback

    from click.testing import CliRunner

    from gsplat_tpu_torch import cli as C

    result = CliRunner().invoke(C.cli, args)
    if result.exit_code != 0:
        tb = "".join(traceback.format_exception(*result.exc_info)) if result.exc_info else ""
        raise RuntimeError(f"{' '.join(args[:1])} exited {result.exit_code}: {result.output[-4000:]}\n{tb}")


def read_png(path):
    import numpy as np
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def cli_phase(dev, t_main: float, root: str):
    """Phase 10: the command line (``gsplat_tpu_torch/cli.py``) on the
    scene of :func:`write_cli_scene`, written into ``root`` (phase 11 reads
    it, its orbit frames and its ``evaluate`` metrics), driven in this process through
    ``click.testing.CliRunner`` so that the kernels' counts see every launch:
    ``evaluate`` unsliced and sliced, ``render``'s path with its progressive
    video, ``orbit``, ``finetune`` (and its resume) and ``train`` from the
    SfM points. Each command's counts are set to 0 just before it and read
    just after. Returns (the phase's record, each kernel's launches over
    the phase)."""
    import json
    import re
    import shutil

    import numpy as np
    import torch

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch import cli as C
    from gsplat_tpu_torch.io.scene import checkpoint_ply_path
    from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles, backward_tiles_carry
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_carry
    from gsplat_tpu_torch.render import pipeline
    from gsplat_tpu_torch.utils import video
    from gsplat_tpu_torch.utils.logging import get_logger

    kernels = {"raster_fwd": forward_tiles, "raster_bwd": backward_tiles, "raster_fwd_carry": forward_tiles_carry,
               "raster_bwd_carry": backward_tiles_carry}
    total = dict.fromkeys(kernels, 0)
    out = {"poses": CLI_POSES, "sfm_points": CLI_SFM_POINTS, "ffmpeg": shutil.which("ffmpeg"), "commands": {}}

    def counted(name, fn):
        """Run ``fn`` with every count set to 0 first; record its seconds
        and the launches it made."""
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in kernels.items()}
        out["commands"][name] = {"s": time.perf_counter() - t0, "launches": launches}
        for k, n in launches.items():
            total[k] += n
        return launches

    invoke, png = cli_invoke, read_png

    def only(launches, **want):
        return launches == {k: want.get(k, 0) for k in kernels}

    log = LogLines()
    logger = get_logger()
    logger.addHandler(log)
    out["scene"] = write_cli_scene(root, dev)
    n_views = len(CLI_POSES)
    target0 = os.path.join(root, "images_1", f"{CLI_POSES[0][0]}.png")
    common = ["--input_dir", root, "--trained_model_path", os.path.join(root, "model"), "--scale-factor", "1",
              "--scene-index", "0", "--device", dev.type]

    # evaluate: each view's render timed by CUDA events around render_traced.
    spans, real_render_traced = [], pipeline.render_traced

    def timed_render_traced(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = real_render_traced(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return result

    pipeline.render_traced = timed_render_traced
    try:
        launches = counted("evaluate", lambda: invoke(["evaluate", *common, "--output_path", f"{root}/eval"]))
    finally:
        pipeline.render_traced = real_render_traced
    metrics = json.load(open(f"{root}/eval/metrics.json"))
    out["evaluate"] = {"render_ms_per_view": [a.elapsed_time(b) for a, b in spans], "metrics": metrics}
    check(only(launches, raster_fwd=n_views), f"evaluate: one forward launch per view: {launches}")
    check(len(metrics["views"]) == n_views and metrics["mean_psnr"] > 50.0, f"evaluate PSNR: {metrics}")
    check(all(v["ssim"] > 0.99 for v in metrics["views"]), f"evaluate SSIM: {metrics}")

    launches = counted("evaluate_sliced", lambda: invoke(
        ["evaluate", *common, "--slice-pairs", str(CLI_SLICE_PAIRS), "--output_path", f"{root}/eval_sliced"]))
    check(launches["raster_fwd_carry"] >= n_views and only(launches, raster_fwd_carry=launches["raster_fwd_carry"]),
          f"sliced evaluate: forward carry launches only: {launches}")
    check(json.load(open(f"{root}/eval_sliced/metrics.json")) == metrics,
          "the sliced evaluate's metrics.json equals the unsliced one")

    # render's path without its matplotlib figure (the card's machine has
    # no matplotlib, PERF.md §3): the view, render.png and the
    # progressive video, through the command's own helpers.
    render_dir = os.path.join(root, "render")
    parts = {}

    def render_path():
        t0 = time.perf_counter()
        cfg = C._raster_config(32, 32, 1 << 22, 0.0, dev.type)
        model, camera, _, gt_path = C._load_scene(root, os.path.join(root, "model"), 0, 1, dev)
        with torch.inference_mode():
            cfg = C._check_pairs(model, camera, cfg, True)
            image = gs.render(model, camera, cfg)[0].cpu().numpy()
        os.makedirs(render_dir)
        video.save_frame(os.path.join(render_dir, "render.png"), image)
        parts["render_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        frames = video.progressive_frames(model, camera, cfg, num_frames=40)
        torch.cuda.synchronize()
        parts["progressive_frames_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        video.write_frames(render_dir, frames)
        parts["write_frames_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        parts["video"] = os.path.basename(video.encode_video(render_dir, camera.width, camera.height))
        parts["encode_s"] = time.perf_counter() - t0
        parts["frames"] = len(frames)
        parts["last_frame_max_abs_diff"] = float(np.abs(frames[-1] - image).max())

    launches = counted("render", render_path)
    out["render"] = parts
    check(only(launches, raster_fwd=1 + parts["frames"]) and parts["frames"] == 40,
          f"render: one forward launch for the view and one per progressive frame: {launches}")
    check(np.array_equal(png(os.path.join(render_dir, "render.png")), png(target0)),
          "render.png equals the view's target PNG")
    check(parts["last_frame_max_abs_diff"] <= 1e-5, f"last progressive frame vs the render: {parts}")
    shutil.rmtree(render_dir)

    orbit_dir = os.path.join(root, "orbit")
    launches = counted("orbit", lambda: invoke(["orbit", *common, "--num-frames", "8", "--output_path", orbit_dir]))
    check(only(launches, raster_fwd=8), f"orbit: one forward launch per frame: {launches}")
    check(np.array_equal(png(os.path.join(orbit_dir, "images", "image_iter_0000000.png")), png(target0)),
          "orbit frame 0 (yaw 0) equals the bench view's target PNG")
    out["orbit"] = {"video": [f for f in os.listdir(orbit_dir) if f.startswith("video_render")]}

    # finetune, uninterrupted and as 3 steps then a resume to 6.
    ft = ["finetune", *common, "--no-densify"]
    whole, split = os.path.join(root, "ft_whole"), os.path.join(root, "ft_split")
    log.lines.clear()
    launches = counted("finetune", lambda: invoke([*ft, "--steps", "6", "--checkpoint-every", "3",
                                                   "--output_path", whole]))
    losses = [float(m.group(1)) for m in map(re.compile(r"step=\d+ loss=(\S+)").match, log.lines) if m]
    out["finetune"] = {"logged_losses": losses}
    check(only(launches, raster_fwd=6, raster_bwd=6), f"finetune: a forward and a backward per step: {launches}")
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses), f"finetune losses: {log.lines}")
    counted("finetune_3", lambda: invoke([*ft, "--steps", "3", "--output_path", split]))
    launches = counted("finetune_resume", lambda: invoke([*ft, "--steps", "6", "--resume", "--output_path", split]))
    check(only(launches, raster_fwd=3, raster_bwd=3), f"the resumed finetune runs steps 3-5: {launches}")
    plys = [open(checkpoint_ply_path(d, 30001), "rb").read() for d in (whole, split)]
    check(plys[0] == plys[1], "the resumed finetune's PLY equals the uninterrupted run's bitwise")
    out["finetune"]["ply_bytes"] = len(plys[0])
    del plys
    shutil.rmtree(whole)
    shutil.rmtree(split)

    # train from the SfM points, holding out view 0.
    train_dir = os.path.join(root, "train")
    log.lines.clear()
    launches = counted("train", lambda: invoke(
        ["train", "--input_dir", root, "--scale-factor", "1", "--device", dev.type, "--steps", "4",
         "--no-densify", "--test-every", "4", "--output_path", train_dir]))
    held = [m.groups() for m in map(re.compile(r"held-out \((\d+) views\): PSNR (\S+)  SSIM (\S+)").match,
                                    log.lines) if m]
    check(len(held) == 1 and held[0][0] == "1" and math.isfinite(float(held[0][1])), f"held-out: {log.lines}")
    out["train"] = {"held_out_psnr": float(held[0][1]), "held_out_ssim": float(held[0][2]),
                    "logged_losses": [float(m.group(1)) for m in
                                      map(re.compile(r"step=\d+ loss=(\S+)").match, log.lines) if m]}
    check(only(launches, raster_fwd=4 + 1, raster_bwd=4),
          f"train: a forward and a backward per step, a forward for the held-out view: {launches}")
    check(os.path.isfile(checkpoint_ply_path(train_dir, 30000)), "train exported its PLY")
    logger.removeHandler(log)
    out["launches"] = total
    out["elapsed_s"] = time.perf_counter() - t_main  # since main() began, the build included
    return out, total


def _digest(model) -> str:
    """A hash of every parameter's bytes (replicas must agree bitwise)."""
    import hashlib

    from gsplat_tpu_torch.models.gaussians import PARAM_NAMES

    h = hashlib.sha256()
    for k in PARAM_NAMES:
        h.update(getattr(model, k).detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _clone(model):
    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.models.gaussians import PARAM_NAMES

    return gs.GaussianModel(*(getattr(model, k).detach().clone() for k in PARAM_NAMES))


def mesh_rank(rank: int, world: int, tmp: str, cfg_fields: dict, dense_capacity: int, device: str) -> None:
    """One of phase 11's gloo ranks, all on this card: the headline renders
    and steps on the 1x4, 2x2 and 4x1 meshes, the padded frame on 1x4 and a
    densifying 2x2 ``ParallelTrainer.fit``. Writes ``rank<r>.json`` (and, on
    rank 0, each step's means and their gradient) into ``tmp``."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch import parallel as P
    from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles
    from gsplat_tpu_torch.utils.logging import get_logger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = P.initialize_distributed(backend="gloo", device=device, init_method=f"file://{tmp}/store", rank=rank,
                                   world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    out = {"rank": rank, "launches": {}, "s": {}}

    def counted(name, fn):
        forward_tiles.launches = backward_tiles.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out["s"][name] = time.perf_counter() - t0
        out["launches"][name] = {"raster_fwd": forward_tiles.launches, "raster_bwd": backward_tiles.launches}
        return result

    try:
        meshes = {f"{d}x{t}": P.make_mesh(gs.MeshConfig(d, t)) for d, t in ((1, 4), (2, 2), (4, 1))}
        cfg = gs.RasterConfig(**cfg_fields)
        model = build_scene(NUM_GAUSSIANS, 0.0, dev)
        cams = [gs.CameraArrays.from_params(bench_camera(WIDTH, HEIGHT, yaw), device=dev) for _, yaw in MESH_POSES]
        with torch.inference_mode():
            single = [gs.render(model, bench_camera(WIDTH, HEIGHT, yaw), cfg) for _, yaw in MESH_POSES]
            got = counted("render_1x4", lambda: P.make_sharded_render(meshes["1x4"], WIDTH, HEIGHT, cfg)(model, cams[0]))
            out["render_1x4_bitwise"] = all(torch.equal(a, b) for a, b in zip(got, single[0]))
            imgs, trans = counted("batch_2x2", lambda: P.make_batch_render(meshes["2x2"], WIDTH, HEIGHT, cfg)(
                model, gs.CameraArrays.stack(cams)))
            out["batch_2x2_bitwise"] = all(torch.equal(imgs[i], a) and torch.equal(trans[i], b)
                                           for i, (a, b) in enumerate(single))
            # A frame whose tile grid does not divide by the stride: shard
            # padding tiles alias the next row or lie past the grid.
            small = build_scene(20_000, 2.5, dev)
            pad_cfg = gs.RasterConfig(tile_size=16, chunk_size=32, pair_block=128, max_pairs=1 << 19)
            pad_cam = bench_camera(*MESH_PAD)
            pad_single = gs.render(small, pad_cam, pad_cfg)
            stats = gs.binning_stats(small, gs.CameraArrays.from_params(pad_cam, device=dev), *MESH_PAD, pad_cfg)
            out["pad_pair_demand"] = int(stats["pair_demand"])
            got = counted("pad_1x4", lambda: P.make_sharded_render(meshes["1x4"], *MESH_PAD, pad_cfg)(
                small, gs.CameraArrays.from_params(pad_cam, device=dev)))
            out["pad_bitwise"] = all(torch.equal(a, b) for a, b in zip(got, pad_single))
            del single, imgs, trans, small, pad_single, got
        # One step with one camera repeated over the batch, every mesh shape,
        # with the f32 pair reduction and with the exact one.
        target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=dev)
        for name, mesh in meshes.items():
            batch = mesh.shape[P.DATA_AXIS]
            for key, exact in ((name, False), (f"{name}_exact", True)):
                step, init_state, prepare = P.make_parallel_train_step(
                    mesh, WIDTH, HEIGHT, dataclasses.replace(cfg, exact_grad_reduction=exact),
                    gs.TrainConfig(ssim_weight=0.0))
                targets = prepare(target.expand(batch, -1, -1, -1))
                m = _clone(model)
                optimizer = init_state(m)
                metrics = counted(f"step_{key}", lambda: step(
                    m, optimizer, gs.CameraArrays.stack([cams[0]] * batch), targets)[2])
                out[f"step_{key}"] = {"loss": float(metrics["loss"]), "digest": _digest(m)}
                if rank == 0:  # the means after the step and their gradient, summed over the world
                    torch.save((m.means.detach().cpu(), m.means.grad.cpu()), os.path.join(tmp, f"means_{key}.pt"))
                del m, optimizer
            del targets
        del model
        torch.cuda.empty_cache()
        # A densifying fit from phase 9's cloud on 2x2. Rank 0 alone builds
        # the cloud's model; the fit broadcasts it to the other replicas.
        views, xyzs, rgbs = densify_inputs(cfg, dev)
        if rank == 0:
            init = gs.GaussianModel.from_points3d(xyzs, rgbs, device=dev)
        else:
            n = len(xyzs)
            init = gs.GaussianModel(*(torch.zeros(shape, device=dev) for shape in
                                      ((n, 3), (n, 3), (n, 4), (n,), (n, 16, 3))))
        log = LogLines()
        get_logger().addHandler(log)
        trainer = P.ParallelTrainer(
            mesh=meshes["2x2"], raster=dataclasses.replace(cfg, max_pairs=dense_capacity), show_progress=False,
            train=gs.TrainConfig(ssim_weight=0.2, steps=MESH_FIT_STEPS, log_every=1,
                                 densify=gs.DensifyConfig(**DENSIFY)))
        final, history = counted("fit_2x2", lambda: trainer.fit(init, views))
        out["fit_2x2"] = {"digest": _digest(final), "num_gaussians": final.num_gaussians,
                          "losses": [h["loss"] for h in history], "max_pairs": trainer.raster.max_pairs,
                          "log": [ln for ln in log.lines if ln.startswith("densify @")]}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


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
                check(time.perf_counter() - t0 < timeout_s, f"{what} ran past {timeout_s} s")
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(30)


def mesh_phase(cfg, frames, dense_capacity: int, dev, t_main: float, cli_root: str):
    """Phase 11: the mesh path (``gsplat_tpu_torch/parallel``). (a) A world
    of one over NCCL in this process, on the phase-3 model and poses: the
    sharded and batch renders bitwise the phase-3 ``frames``, the sharded
    binning stats, and a step held to ``Trainer.train_step``. (b) Four gloo
    ranks spawned on this one card (:func:`mesh_rank`). (c) The command line
    with ``--mesh 1x1 --device cuda`` on phase 10's scene in ``cli_root``.
    Returns (the phase's record, the launches of each kernel over the phase,
    summed over every rank)."""
    import dataclasses
    import datetime
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch import cli as C
    from gsplat_tpu_torch import parallel as P
    from gsplat_tpu_torch.io.scene import checkpoint_ply_path
    from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles
    from gsplat_tpu_torch.models.gaussians import PARAM_NAMES
    from gsplat_tpu_torch.train.checkpoint import save_ply_checkpoint

    out = {"poses": MESH_POSES, "launches": {}}
    total = {"raster_fwd": 0, "raster_bwd": 0}

    def counted(name, fn):
        forward_tiles.launches = backward_tiles.launches = 0
        result = fn()
        torch.cuda.synchronize()
        launches = {"raster_fwd": forward_tiles.launches, "raster_bwd": backward_tiles.launches}
        out["launches"][name] = launches
        for k, n in launches.items():
            total[k] += n
        return result, launches

    # -- (a) a world of one over NCCL --
    model = build_scene(NUM_GAUSSIANS, 0.0, dev)
    cams = [gs.CameraArrays.from_params(bench_camera(WIDTH, HEIGHT, yaw), device=dev) for _, yaw in MESH_POSES]
    target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        P.initialize_distributed(device=dev.type, init_method=f"file://{tmp}/store", rank=0, world_size=1,
                                 timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            mesh = P.make_mesh(gs.MeshConfig(1, 1))
            sharded = P.make_sharded_render(mesh, WIDTH, HEIGHT, cfg)
            with torch.inference_mode():
                got, launches = counted("a_render", lambda: sharded(model, cams[0]))
                check(torch.equal(got[0], frames[0][0]) and torch.equal(got[1], frames[0][1]),
                      "the 1x1 sharded render is bitwise the phase-3 render")
                check(launches == {"raster_fwd": 1, "raster_bwd": 0}, f"1x1 render launches: {launches}")
                (imgs, trans), launches = counted("a_batch", lambda: P.make_batch_render(mesh, WIDTH, HEIGHT, cfg)(
                    model, gs.CameraArrays.stack(cams[:3])))
                check(all(torch.equal(imgs[i], a) and torch.equal(trans[i], b) for i, (a, b) in enumerate(frames)),
                      "the 1x1 batch render is bitwise the three phase-3 renders")
                check(launches == {"raster_fwd": 3, "raster_bwd": 0}, f"1x1 batch launches: {launches}")
                stats = P.make_sharded_binning_stats(mesh, WIDTH, HEIGHT, cfg)(model, cams[0])
                demand = int(gs.binning_stats(model, cams[0], WIDTH, HEIGHT, cfg)["pair_demand"])
                check(int(stats["max_shard_demand"]) == demand, f"1x1 shard demand {stats} != {demand}")
                out["a_request_ms"] = [cuda_ms(lambda: sharded(model, cam), 1) for cam in cams[:3]]
                out["a_request_stages"] = stage_breakdown(lambda: sharded(model, cams[0]))
                out["a_request_device_busy_ms"] = device_busy_ms(lambda: sharded(model, cams[0]))
                del got, imgs, trans
            # The step from the same state as Trainer.train_step's.
            tc = gs.TrainConfig(ssim_weight=0.2)
            ref, m = _clone(model), _clone(model)
            trainer = gs.Trainer(raster=cfg, train=tc, show_progress=False)
            ref_metrics = trainer.train_step(ref, trainer.init_state(ref), bench_camera(WIDTH, HEIGHT), target)
            step, init_state, prepare = P.make_parallel_train_step(mesh, WIDTH, HEIGHT, cfg, tc)
            optimizer, targets, batch = init_state(m), prepare(target[None]), gs.CameraArrays.stack(cams[:1])
            (_, _, metrics), launches = counted("a_step", lambda: step(m, optimizer, batch, targets))
            check(launches == {"raster_fwd": 1, "raster_bwd": 1}, f"1x1 step launches: {launches}")
            check(math.isclose(float(metrics["loss"]), float(ref_metrics["loss"]), rel_tol=1e-5),
                  f"1x1 step loss {float(metrics['loss'])} vs Trainer {float(ref_metrics['loss'])}")
            out["a_step_param_err"] = {}
            for k in PARAM_NAMES:
                a, b = getattr(m, k).detach(), getattr(ref, k).detach()
                scale = float(b.abs().max())
                check(bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-5 * scale).all()), f"1x1 step {k} vs Trainer")
                out["a_step_param_err"][k] = float((a - b).abs().max()) / scale
            out["a_step_ms"] = cuda_ms(lambda: step(m, optimizer, batch, targets), 5)
            out["a_step_stages"] = stage_breakdown(lambda: step(m, optimizer, batch, targets))
            out["a_step_device_busy_ms"] = device_busy_ms(lambda: step(m, optimizer, batch, targets))
            # The SSIM-free step the gloo meshes are held to, with the f32
            # pair reduction and with the exact one.
            one = {}
            for exact in (False, True):
                step0, init0, _ = P.make_parallel_train_step(
                    mesh, WIDTH, HEIGHT, dataclasses.replace(cfg, exact_grad_reduction=exact),
                    gs.TrainConfig(ssim_weight=0.0))
                m0 = _clone(model)
                loss = float(step0(m0, init0(m0), batch, targets)[2]["loss"])
                one[exact] = (loss, m0.means.detach().cpu(), m0.means.grad.cpu())
                del m0
            del ref, m, trainer, optimizer, targets
        finally:
            dist.destroy_process_group()
    del model
    torch.cuda.empty_cache()

    # -- (b) four gloo ranks sharing this card; the kernels were built in phase 1 --
    cfg_fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks([(mesh_rank, (4, tmp, cfg_fields, dense_capacity, dev.type), 4)], MESH_TIMEOUT_S, "the gloo world")
        out["b_world_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(4):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        means = {key: torch.load(os.path.join(tmp, f"means_{key}.pt"))
                 for name in ("1x4", "2x2", "4x1") for key in (name, f"{name}_exact")}
    print(json.dumps({"mesh_ranks": ranks}), file=sys.stderr, flush=True)  # the raw record, before any check
    for rank in ranks:
        r = rank["rank"]
        check(rank["render_1x4_bitwise"], f"rank {r}: the 1x4 sharded render is bitwise the single-device one")
        check(rank["batch_2x2_bitwise"], f"rank {r}: the 2x2 batch render is bitwise the four renders")
        check(rank["pad_bitwise"], f"rank {r}: the padded 200x150 frame is bitwise the single-device one")
        for name, launches in rank["launches"].items():
            want_bwd = name.startswith("step") or name.startswith("fit")
            check(launches["raster_fwd"] > 0 and (launches["raster_bwd"] > 0) == want_bwd,
                  f"rank {r} {name} launches: {launches}")
            for k, n in launches.items():
                total[k] += n
    # Adam's first update is lr * g / (|g| + eps), steep in g where |g| is
    # near eps, so the means after one step are as close as the gradients
    # are in the last bits. With the exact pair reduction the gradients of
    # every mesh and of 1x1 are the same sums, and the means are held at
    # rtol 1e-4 / atol 1e-7 on every element. With the f32 reduction each
    # path's gradient carries its own cumsum's rounding; the mesh's is held
    # to twice 1x1's own distance from the exact-reduction gradient.
    one_loss, one_means, one_grad = one[False]
    _, x_means, x_grad = one[True]
    grad_scale = float(x_grad.abs().max())
    one_err = float((one_grad - x_grad).abs().max())
    out["b_steps"] = {"grad_scale": grad_scale, "1x1_f32_grad_err_over_scale": one_err / grad_scale}
    for name in ("1x4", "2x2", "4x1"):
        m, g = means[name]
        mx, gx = means[f"{name}_exact"]
        out["b_steps"][name] = {
            "loss": ranks[0][f"step_{name}"]["loss"],
            "f32_grad_err_over_scale": float((g - x_grad).abs().max()) / grad_scale,
            "f32_grad_vs_1x1_f32_over_scale": float((g - one_grad).abs().max()) / grad_scale,
            "f32_means_max_abs_err": float((m - one_means).abs().max()),
            "f32_means_outside_rtol_1e-4_atol_1e-7": int(((m - one_means).abs() > 1e-4 * one_means.abs() + 1e-7).sum()),
            "exact_grad_err_over_scale": float((gx - x_grad).abs().max()) / grad_scale,
            "exact_grad_max_rel_err": float(((gx - x_grad).abs() / x_grad.abs().clamp(min=1e-30)).max()),
            "exact_means_max_abs_err": float((mx - x_means).abs().max()),
        }
    print(json.dumps({"mesh_steps": out["b_steps"]}), file=sys.stderr, flush=True)
    check(0.0 < one_err, "the exact pair reduction changes 1x1's gradient")
    for name in ("1x4", "2x2", "4x1"):
        for key in (name, f"{name}_exact"):
            check(len({rank[f"step_{key}"]["digest"] for rank in ranks}) == 1, f"{key} step replicas bitwise equal")
            loss = ranks[0][f"step_{key}"]["loss"]
            check(math.isclose(loss, one_loss, rel_tol=1e-5), f"{key} step loss {loss} vs 1x1 {one_loss}")
        m, g = means[name]
        mx, _ = means[f"{name}_exact"]
        check(torch.allclose(mx, x_means, rtol=1e-4, atol=1e-7), f"{name} step means vs 1x1, exact pair reduction")
        check(float((g - x_grad).abs().max()) <= 2 * one_err,
              f"{name} step means gradient within twice 1x1's f32 error of the exact-reduction gradient")
    fit = [rank["fit_2x2"] for rank in ranks]
    check(len({f["digest"] for f in fit}) == 1, "the densifying 2x2 fit leaves the four replicas bitwise equal")
    check(len(fit[0]["losses"]) == MESH_FIT_STEPS and all(math.isfinite(x) for x in fit[0]["losses"]),
          f"2x2 fit losses: {fit[0]['losses']}")
    check(len(fit[0]["log"]) >= 1 and all(not f["log"] for f in fit[1:]), f"rank 0 alone logs the passes: {fit}")
    out["b"] = {"note": "four processes share one card over gloo, staged through the host: not a multi-GPU time",
                "ranks": ranks, "step_loss_1x1": one_loss}

    # -- (c) the command line, --mesh 1x1 --device cuda, on phase 10's scene --
    common = ["--input_dir", cli_root, "--trained_model_path", os.path.join(cli_root, "model"), "--scale-factor", "1",
              "--scene-index", "0", "--device", dev.type, "--mesh", "1x1"]
    orbit_dir = os.path.join(cli_root, "orbit_mesh")
    _, launches = counted("c_orbit", lambda: cli_invoke(["orbit", *common, "--num-frames", "8",
                                                         "--output_path", orbit_dir]))
    check(launches == {"raster_fwd": 8, "raster_bwd": 0}, f"orbit --mesh 1x1 launches: {launches}")
    names = sorted(os.listdir(os.path.join(cli_root, "orbit", "images")))
    check(names == sorted(os.listdir(os.path.join(orbit_dir, "images"))), "orbit --mesh 1x1 writes phase 10's frames")
    check(all(np.array_equal(read_png(os.path.join(orbit_dir, "images", n)),
                             read_png(os.path.join(cli_root, "orbit", "images", n))) for n in names),
          "orbit --mesh 1x1 frames equal phase 10's")
    _, launches = counted("c_evaluate", lambda: cli_invoke(["evaluate", *common, "--output_path",
                                                            os.path.join(cli_root, "eval_mesh")]))
    check(launches["raster_fwd"] == len(CLI_POSES) and launches["raster_bwd"] == 0, f"evaluate --mesh: {launches}")
    with open(os.path.join(cli_root, "eval_mesh", "metrics.json")) as f, \
            open(os.path.join(cli_root, "eval", "metrics.json")) as g:
        check(json.load(f) == json.load(g), "evaluate --mesh 1x1 metrics.json equals phase 10's")
    ft_dir = os.path.join(cli_root, "ft_mesh")
    _, launches = counted("c_finetune", lambda: cli_invoke(["finetune", *common, "--steps", "3", "--no-densify",
                                                            "--output_path", ft_dir]))
    check(launches == {"raster_fwd": 3, "raster_bwd": 3}, f"finetune --mesh 1x1 launches: {launches}")
    # The same run through a 1x1 ParallelTrainer in this process.
    P.initialize_distributed(device=dev.type)
    try:
        ft_cfg = C._raster_config(32, 32, 1 << 22, 0.0, dev.type)
        ft_model = C._load_scene(cli_root, os.path.join(cli_root, "model"), 0, 1, dev)[0]
        ft_trainer = P.ParallelTrainer(mesh=P.single_device_mesh(), raster=ft_cfg, show_progress=False,
                                       train=gs.TrainConfig(steps=3))
        ft_model, _ = ft_trainer.fit(ft_model, C._load_views(cli_root, 1, dev))
        save_ply_checkpoint(os.path.join(cli_root, "ft_ref"), ft_model, iteration=30001)
    finally:
        dist.destroy_process_group()
    plys = [open(checkpoint_ply_path(d, 30001), "rb").read() for d in (ft_dir, os.path.join(cli_root, "ft_ref"))]
    check(plys[0] == plys[1], "finetune --mesh 1x1's PLY is bitwise a 1x1 ParallelTrainer's")
    out["mesh_launches"] = total
    out["elapsed_s"] = time.perf_counter() - t_main  # since main() began, the build included
    return out, total


def frame_feature_grad(model, camera, cfg, w_img, w_trans):
    """The gradient of ``sum(img * w_img) + sum(trans * w_trans)`` with
    respect to one view's packed features, through ``rasterize_tiles`` and
    the image assembly: one forward and one backward launch."""
    import torch

    from gsplat_tpu_torch.kernels.raster import rasterize_tiles
    from gsplat_tpu_torch.render.tile_torch import tiles_to_image

    with torch.no_grad():
        args, bins, ntx = binned_inputs(model, camera, cfg)
    feat = args[0].detach().requires_grad_(True)
    w, h, ts = camera.width, camera.height, cfg.tile_size
    color, trans = rasterize_tiles(feat, *args[1:], bins.gaussian_counts, ntx, cfg, w, h)
    loss = (tiles_to_image(color, w, h, ts) * w_img).sum() + (tiles_to_image(trans, w, h, ts) * w_trans).sum()
    return torch.autograd.grad(loss, [feat])[0]


def first_slice_kernels(feat, rec, color, trans, n_tiles_x, cfg, width, height, seed: int) -> dict:
    """Both carry kernels on the first depth slice of ``rec`` (from
    :func:`sliced_records`): the forward from (0, 1) bitwise its plain
    version and ``blocks_done`` the record's; the backward from the walk
    state of the frame (``color``, ``trans`` and seeded cotangents), its
    rows and S by ``rows_error``, its T at rtol 1e-5 / atol 1e-6; each timed
    beside its plain version and bounded as in phase 8."""
    import torch

    from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles_carry, backward_tiles_plain, walk_state, written_slots
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles_carry, forward_tiles_plain

    tile_ids = torch.arange(len(rec.starts[0]), dtype=torch.int32, device=feat.device)
    args0 = (feat, rec.ids[0], rec.starts[0], rec.countc[0], tile_ids)
    zero = (torch.zeros_like(color), torch.ones_like(trans))
    k_out = forward_tiles_carry(*args0, *zero, n_tiles_x, cfg, width, height)
    torch.cuda.synchronize()
    p_out = forward_tiles_plain(*args0, n_tiles_x, cfg, width, height, carry=zero)
    what = f"tile {cfg.tile_size} first slice"
    check(all(torch.equal(a, b) for a, b in zip(k_out, p_out)), f"{what}: forward carry bitwise its plain version")
    check(torch.equal(k_out[2], rec.bdone[0]), f"{what}: blocks_done")
    fwd_err = max(float((a - b).abs().max()) for a, b in zip(k_out[:2], p_out[:2]))
    g_color, g_trans = random_cotangents(color, trans, seed=seed)
    state = walk_state(color, trans, g_color, g_trans)
    rows, s_out = backward_tiles_carry(*args0, state, g_color, n_tiles_x, cfg, rec.bdone[0])
    torch.cuda.synchronize()
    p_rows, p_state = backward_tiles_plain(*args0, None, None, g_color, None, n_tiles_x, cfg, rec.bdone[0], state)
    out = {"first_slice_forward_max_abs_err": fwd_err,
           "first_slice_bwd": {"rows": rows_error(rows, p_rows, f"{what} rows"),
                               "S": rows_error(s_out[:, 0].reshape(-1, 1), p_state[:, 0].reshape(-1, 1), f"{what} S")}}
    torch.testing.assert_close(s_out[:, 1], p_state[:, 1], rtol=1e-5, atol=1e-6)
    out["forward_carry_ms"] = cuda_ms(lambda: forward_tiles_carry(*args0, *zero, n_tiles_x, cfg, width, height), 20)
    out["forward_carry_plain_ms"] = cuda_ms(
        lambda: forward_tiles_plain(*args0, n_tiles_x, cfg, width, height, carry=zero), 1)
    out["backward_carry_ms"] = cuda_ms(
        lambda: backward_tiles_carry(*args0, state, g_color, n_tiles_x, cfg, rec.bdone[0]), 20)
    out["backward_carry_plain_ms"] = cuda_ms(lambda: backward_tiles_plain(
        *args0, None, None, g_color, None, n_tiles_x, cfg, rec.bdone[0], state), 1)
    # The bytes of phase 8's bound: the rows of the gaussians the walked
    # pairs name, the pair ids, four words per tile, per pixel the state in
    # and out, and the backward's [P, 9] rows.
    walked = written_slots(rec.starts[0], rec.bdone[0], int(rec.bdone[0].sum()), cfg.pair_block)
    common = int(torch.unique(rec.ids[0][walked]).numel()) * 64 + rec.ids[0].numel() * 4 + len(tile_ids) * 16
    counts = pair_pixels(args0, n_tiles_x, cfg, rec.bdone[0])
    pixels = color.numel() // 3
    out["forward_carry_bound"] = compositor_bound(counts, common + pixels * 32, backward=False)
    out["backward_carry_bound"] = compositor_bound(counts, common + pixels * 28 + rec.ids[0].numel() * 36,
                                                   backward=True)
    return out


def tilings_phase(cfg, frame32, dev, t_main: float):
    """Phase 12: the four kernels at tilings other than the headline's.
    (a) The headline model of phase 3 at each tile of ``TILING_FULL``, each
    tiling's capacity 1.5x its own demand: a render request, bitwise the
    phase-3 tile-32 ``frame32`` (early stop off: every pixel composites the
    same gaussians in the same order) and bitwise the forward kernel's plain
    version; the backward kernel against its plain version; a depth-sliced
    request at ``TILING_SLICE`` pairs a slice, bitwise the same frame, and
    both carry kernels on its first slice; every kernel timed with its
    bounds; the feature gradient of a seeded image-space loss with the exact
    pair reduction (tile 32's twice, bitwise equal) within the backward
    tolerance of tile 32's; at tile 64 a
    one-step ``Trainer.fit``, unsliced and sliced, its loss bitwise tile
    32's. (b) Phase 2's scene and frame at every tile of
    ``TILING_SMALL_TILES`` and pair block of ``TILING_SMALL_BLOCKS``, early
    stop 0 and 1e-4: the forward kernel bitwise its plain version, the
    backward within ``rows_error``, each twice bitwise, and both carry
    kernels on every depth slice (``carry_chain``). Returns (the phase's
    record, each kernel's launches over the entry-point calls of (a), each
    call counted from 0 just before it)."""
    import dataclasses

    import torch

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.kernels import cull
    from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles, backward_tiles_carry, backward_tiles_plain
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_carry, forward_tiles_plain
    from gsplat_tpu_torch.render.tile_torch import tiles_to_image

    kernels = {"raster_fwd": forward_tiles, "raster_bwd": backward_tiles, "raster_fwd_carry": forward_tiles_carry,
               "raster_bwd_carry": backward_tiles_carry}
    resumable = (forward_tiles, forward_tiles_carry)
    launches = dict.fromkeys(kernels, 0)

    def entry(fn):
        """One call of the port's entry points, every count set to 0 just
        before it; returns (its result, the launches it made). Every call
        here has early stop off, so it makes no resume launch."""
        for k in kernels.values():
            k.launches = 0
        for k in resumable:
            k.resume_launches = 0
        result = fn()
        torch.cuda.synchronize()
        made = {name: k.launches for name, k in kernels.items()}
        for name, n in made.items():
            launches[name] += n
        check(all(k.resume_launches == 0 for k in resumable), "no resume launch with early stop off")
        return result, made

    def only(made, **want):
        return made == {**dict.fromkeys(kernels, 0), **want}

    out = {"full": {}, "small": {}, "small_seconds": {}}
    model = build_scene(NUM_GAUSSIANS, 0.0, dev)
    cam0 = bench_camera(WIDTH, HEIGHT)
    cams = gs.CameraArrays.from_params(cam0, device=dev)
    target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=dev)
    train = gs.TrainConfig(ssim_weight=0.2, steps=1, log_every=1)
    w_img, w_trans = random_cotangents(*frame32, seed=6)
    exact_cfg = dataclasses.replace(cfg, exact_grad_reduction=True)
    exact32 = frame_feature_grad(model, cam0, exact_cfg, w_img, w_trans)
    check(torch.equal(exact32, frame_feature_grad(model, cam0, exact_cfg, w_img, w_trans)),
          "the exact pair reduction is bitwise repeatable")
    loss32 = gs.Trainer(raster=cfg, train=train, show_progress=False).fit(_clone(model), [(cam0, target)])[1][0]["loss"]
    for ts in TILING_FULL:
        t_tile = time.perf_counter()
        with torch.inference_mode():
            demand = int(gs.binning_stats(model, cams, WIDTH, HEIGHT, dataclasses.replace(cfg, tile_size=ts))["pair_demand"])
            tcfg = dataclasses.replace(cfg, tile_size=ts, max_pairs=max(int(demand * 1.5) // 128 * 128, CAPACITY_FLOOR))
            rec = {"pair_demand": demand, "capacity": tcfg.max_pairs}
            check(not bool(gs.binning_stats(model, cams, WIDTH, HEIGHT, tcfg)["overflowed"]), f"tile {ts}: no overflow")
            (img, trans), made = entry(lambda: gs.render(model, cam0, tcfg))
            check(only(made, raster_fwd=1), f"tile {ts} request launches: {made}")
            check(torch.equal(img, frame32[0]) and torch.equal(trans, frame32[1]),
                  f"tile {ts}: the frame is bitwise phase 3's tile-32 frame")
            args, bins, ntx = binned_inputs(model, cam0, tcfg)
            k_out = forward_tiles(*args, ntx, tcfg, WIDTH, HEIGHT)
            torch.cuda.synchronize()
            p_out = forward_tiles_plain(*args, ntx, tcfg, WIDTH, HEIGHT)
            check(all(torch.equal(a, b) for a, b in zip(k_out, p_out)), f"tile {ts}: forward bitwise its plain version")
            check(torch.equal(tiles_to_image(k_out[0], WIDTH, HEIGHT, ts), img), f"tile {ts}: the request's frame")
            counts = pair_pixels(args, ntx, tcfg)
            fwd_bytes = sum(t.numel() * t.element_size() for t in args) + len(args[4]) * (ts ** 2 * 16 + 4)
            rec["forward"] = {"ms": cuda_ms(lambda: forward_tiles(*args, ntx, tcfg, WIDTH, HEIGHT), 20),
                              "plain_ms": cuda_ms(lambda: forward_tiles_plain(*args, ntx, tcfg, WIDTH, HEIGHT), 1),
                              "bound": compositor_bound(counts, fwd_bytes, backward=False)}
            color, tr, done = k_out
            outs = (color, tr, *random_cotangents(color, tr, seed=3))
            rows = backward_tiles(*args, *outs, ntx, tcfg, done)
            again = backward_tiles(*args, *outs, ntx, tcfg, done)
            torch.cuda.synchronize()
            p_rows = backward_tiles_plain(*args, *outs, ntx, tcfg, done)
            check(torch.equal(rows, again), f"tile {ts}: two backward runs bitwise equal")
            bwd_bytes = sum(t.numel() * t.element_size() for t in (*args, *outs, done)) + args[1].numel() * 36
            rec["backward"] = {"rows": rows_error(rows, p_rows, f"tile {ts} rows"),
                               "ms": cuda_ms(lambda: backward_tiles(*args, *outs, ntx, tcfg, done), 20),
                               "plain_ms": cuda_ms(lambda: backward_tiles_plain(*args, *outs, ntx, tcfg, done), 1),
                               "bound": compositor_bound(counts, bwd_bytes, backward=True)}
            del args, bins, k_out, p_out, color, tr, done, outs, rows, again, p_rows
            scfg = dataclasses.replace(tcfg, slice_pairs=TILING_SLICE)
            (s_img, s_trans), made = entry(lambda: gs.render(model, cam0, scfg))
            check(made["raster_fwd_carry"] >= 2 and only(made, raster_fwd_carry=made["raster_fwd_carry"]),
                  f"tile {ts} sliced request launches: {made}")
            check(torch.equal(s_img, frame32[0]) and torch.equal(s_trans, frame32[1]),
                  f"tile {ts}: the sliced frame is bitwise the tile-32 frame")
            feat, s_color, s_tr, srec = sliced_records(model, cam0, scfg)
            rec["sliced"] = {"k_exec": len(srec.ids), "request_launches": made["raster_fwd_carry"],
                             **first_slice_kernels(feat, srec, s_color, s_tr, ntx, scfg, WIDTH, HEIGHT, seed=5)}
            del feat, s_color, s_tr, srec
        grad = frame_feature_grad(model, cam0, dataclasses.replace(tcfg, exact_grad_reduction=True), w_img, w_trans)
        rec["exact_d_feat_vs_tile32"] = rows_error(grad, exact32, f"tile {ts} d_feat against tile 32's (exact reduction)")
        if ts >= 64:
            (_, history), made = entry(lambda: gs.Trainer(raster=tcfg, train=train, show_progress=False).fit(
                _clone(model), [(cam0, target)]))
            check(only(made, raster_fwd=1, raster_bwd=1), f"tile {ts} fit step launches: {made}")
            check(history[0]["loss"] == loss32, f"tile {ts} step loss {history[0]['loss']} is tile 32's {loss32}")
            (_, s_history), made = entry(lambda: gs.Trainer(raster=scfg, train=train, show_progress=False).fit(
                _clone(model), [(cam0, target)]))
            check(made["raster_fwd_carry"] == made["raster_bwd_carry"] >= 2
                  and only(made, raster_fwd_carry=made["raster_fwd_carry"], raster_bwd_carry=made["raster_bwd_carry"]),
                  f"tile {ts} sliced fit step launches: {made}")
            check(s_history[0]["loss"] == loss32, f"tile {ts} sliced step loss is tile 32's")
            rec.update({"step_loss": history[0]["loss"], "sliced_step_launches": made})
        rec["seconds"] = time.perf_counter() - t_tile
        out["full"][str(ts)] = rec
        torch.cuda.empty_cache()
    out["tile32_step_loss"] = loss32
    del model, exact32
    torch.cuda.empty_cache()

    scenes = {False: build_scene(TILING_SMALL_N, 2.5, dev), True: build_scene(TILING_LARGE_N, TILING_LARGE_SHIFT, dev)}
    sw, sh = TILING_SMALL_FRAME
    cam_s = bench_camera(sw, sh)
    for ts in TILING_SMALL_TILES:
        small = scenes[ts > cull.MAX_GROUP]
        ntx = -(-sw // ts)
        n_tiles = ntx * -(-sh // ts)
        t_tile = time.perf_counter()
        for blk in TILING_SMALL_BLOCKS:
            base = gs.RasterConfig(tile_size=ts, chunk_size=8, pair_block=blk, max_pairs=1 << 23)
            with torch.inference_mode():
                args, bins, _ = binned_inputs(small, cam_s, base)
            demand = int(bins.pair_demand)
            check(demand <= base.max_pairs, f"tile {ts} / block {blk}: capacity")
            # A few depth slices: a third of the demand, a pair_block
            # multiple, at least the tile count.
            slice_pairs = -(-max(demand // 3, n_tiles) // blk) * blk
            rec = {"pair_demand": demand, "slice_pairs": slice_pairs}
            for stop in (0.0, 1e-4):
                scfg = dataclasses.replace(base, early_stop_transmittance=stop)
                what = f"tile {ts} / block {blk} / early stop {stop}"
                with torch.inference_mode():
                    resumed = forward_tiles.resume_launches
                    got = forward_tiles(*args, ntx, scfg, sw, sh)
                    again = forward_tiles(*args, ntx, scfg, sw, sh)
                    torch.cuda.synchronize()
                    check(forward_tiles.resume_launches - resumed == (2 if ts > 64 and stop > 0 else 0),
                          f"{what}: resume launches")
                    want = forward_tiles_plain(*args, ntx, scfg, sw, sh)
                    check(all(torch.equal(g, w) and torch.equal(g, a) for g, a, w in zip(got, again, want)),
                          f"{what}: forward twice bitwise its plain version")
                    outs = (got[0], got[1], *random_cotangents(got[0], got[1], seed=7))
                    rows = backward_tiles(*args, *outs, ntx, scfg, got[2])
                    rows2 = backward_tiles(*args, *outs, ntx, scfg, got[2])
                    torch.cuda.synchronize()
                    p_rows = backward_tiles_plain(*args, *outs, ntx, scfg, got[2])
                    check(torch.equal(rows, rows2), f"{what}: two backward runs bitwise equal")
                    stop_rec = {"tiles_stopped_early": int((got[2] < -(-args[3] // blk)).sum()),
                                "rows_max_abs_err": rows_error(rows, p_rows, f"{what} rows")["max_abs_err"]}
                    sl = dataclasses.replace(scfg, slice_pairs=slice_pairs)
                    feat, color, trans, srec = sliced_records(small, cam_s, sl)
                    chain = carry_chain(feat, srec, ntx, sl, sw, sh, *random_cotangents(color, trans, seed=8))
                    check(torch.equal(chain.pop("color"), color) and torch.equal(chain.pop("trans"), trans),
                          f"{what}: the checked chain ends at the sliced forward's frame")
                    if stop == 0.0:
                        check(torch.equal(color, got[0]) and torch.equal(trans, got[1]),
                              f"{what}: the sliced frame is bitwise the single pass's")
                    stop_rec.update({"k_exec": len(srec.ids), **chain})
                rec[f"stop_{stop}"] = stop_rec
                del got, again, want, outs, rows, rows2, p_rows, feat, color, trans, srec
            out["small"][f"{ts}x{blk}"] = rec
            del args, bins
        out["small_seconds"][str(ts)] = time.perf_counter() - t_tile
    check(any(rec["stop_0.0001"]["tiles_stopped_early"] > 0 for rec in out["small"].values()),
          "the small sweep exercises the early stop")
    out["elapsed_s"] = time.perf_counter() - t_main  # since main() began, the build included
    return out, launches


def free_port() -> int:
    """A TCP port on this host that no socket holds now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def scaling_phase(dev, t_main: float):
    """Phase 13: the scaling harness (``tools/multihost.py``). Model mode in
    this process on the headline scene (``NUM_GAUSSIANS``, ``WIDTH x
    HEIGHT``) at the tile factors of ``SCALING_TP``: every stage time finite
    and positive, each shard's pairs within its capacity, tp=1's pairs those
    of the unsharded binning of the same scene and config, and at every tp
    the strided extraction of the global ``coverage_histogram`` equal to
    shard (0, 0)'s ``bin_rects`` ``tile_count``. At every tp the kernels on
    the shard's own inputs, as model mode gives them: the forward bitwise
    its plain version (colour, T and ``blocks_done``), each of its tiles
    bitwise that tile (``tile_ids``) of the unsharded render, and the
    backward's rows (cotangents 0.1 and 0, as model mode's) within
    ``rows_error`` of the plain version's. Then launch mode at 1x1 in a
    subprocess under ``torch.distributed.run`` on a free port: exit 0, one
    forward and one backward launch a step, and its loss within rel 1e-5 of
    ``Trainer.train_step``'s after as many steps in this process (phase
    11's tolerance for its 1x1 step). Returns (the phase's record, each
    kernel's launches over model mode and the launch run)."""
    import dataclasses

    import torch

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles, backward_tiles_plain
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_plain
    from gsplat_tpu_torch.ops.binning import pack_features
    from gsplat_tpu_torch.render.pipeline import preprocess_traced
    from gsplat_tpu_torch.render.tile_torch import tiles_to_image

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import multihost as MH

    t0 = time.perf_counter()
    model = build_scene(NUM_GAUSSIANS, 0.0, dev)
    camera = bench_camera(WIDTH, HEIGHT)
    cfg = MH.harness_config()
    forward_tiles.launches = backward_tiles.launches = 0
    rec = MH.model_mode(model, camera, cfg, SCALING_TP, steps=SCALING_STEPS)
    torch.cuda.synchronize()
    launches = {"raster_fwd": forward_tiles.launches, "raster_bwd": backward_tiles.launches}
    check(launches["raster_fwd"] > 0 and launches["raster_bwd"] > 0, f"model mode launches: {launches}")
    points = rec["points"]
    check([p["devices"] for p in points] == list(SCALING_TP), f"model mode points: {[p['devices'] for p in points]}")
    check(sorted(rec["local_count_sec"]) == sorted(str(tp) for tp in SCALING_TP), "the own count timed at every tp")
    for p in points:
        for key in (k for k in p if k.endswith("_sec")):
            check(math.isfinite(p[key]) and p[key] > 0.0, f"tp={p['devices']}: {key} = {p[key]}")
        check(p["local_pairs"] <= p["local_capacity"], f"tp={p['devices']}: {p['local_pairs']} pairs over capacity")
    cam = gs.CameraArrays.from_params(camera, device=dev)
    whole = gs.binning_stats(model, cam, WIDTH, HEIGHT, dataclasses.replace(cfg, max_pairs=points[0]["local_capacity"]))
    check(points[0]["local_pairs"] == int(whole["num_pairs"]),
          f"tp=1 pairs {points[0]['local_pairs']} vs the unsharded binning's {int(whole['num_pairs'])}")
    kernels = {}
    with torch.inference_mode():
        img, trans_img = gs.render(model, camera, cfg)
        prep = preprocess_traced(model, cam, WIDTH, HEIGHT, cfg)
        feat = pack_features(prep)
        frame = None  # tp=1's forward: the whole frame's tiles
        for p in points:
            tp = p["devices"]
            s = MH.shard_setup(prep, WIDTH, HEIGHT, cfg, tp)
            check((s.capacity, int(s.bins.num_pairs)) == (p["local_capacity"], p["local_pairs"]),
                  f"tp={tp}: the shard's binning repeats")
            check(torch.equal(s.histogram_tile_count, s.bins.tile_count),
                  f"tp={tp}: the histogram's strided extraction equals the shard's tile counts")
            args = (feat, s.bins.pair_gaussian, s.bins.tile_start, s.bins.tile_count, s.tile_ids)
            k_out = forward_tiles(*args, s.lay.ntx_g, s.cfg, WIDTH, HEIGHT)
            torch.cuda.synchronize()
            p_out = forward_tiles_plain(*args, s.lay.ntx_g, s.cfg, WIDTH, HEIGHT)
            check(all(torch.equal(a, b) for a, b in zip(k_out, p_out)),
                  f"tp={tp}: the forward (colour, T, blocks_done) bitwise its plain version")
            if frame is None:
                check(torch.equal(tiles_to_image(k_out[0], WIDTH, HEIGHT, cfg.tile_size), img)
                      and torch.equal(tiles_to_image(k_out[1], WIDTH, HEIGHT, cfg.tile_size), trans_img),
                      "tp=1: the shard's frame is bitwise the unsharded render")
                frame = k_out[:2]
            ids = s.tile_ids.long()
            check(torch.equal(k_out[0], frame[0][ids]) and torch.equal(k_out[1], frame[1][ids]),
                  f"tp={tp}: each shard tile is bitwise that tile of the whole frame")
            color, trans, done = k_out
            outs = (color, trans, torch.full_like(color, 0.1), torch.zeros_like(trans))
            rows = backward_tiles(*args, *outs, s.lay.ntx_g, s.cfg, done)
            torch.cuda.synchronize()
            p_rows = backward_tiles_plain(*args, *outs, s.lay.ntx_g, s.cfg, done)
            kernels[str(tp)] = {"forward_bitwise": True, "tiles": int(ids.numel()),
                                "backward": rows_error(rows, p_rows, f"tp={tp} backward rows")}
            del args, k_out, p_out, color, trans, done, outs, rows, p_rows
    del model, prep, feat, s, whole, frame, img, trans_img
    torch.cuda.empty_cache()
    model_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1", "--master_addr=127.0.0.1",
           f"--master_port={free_port()}", os.path.join(HERE, "tools", "multihost.py"), "--mode", "launch",
           "--data", "1", "--tile", "1", "--gaussians", str(NUM_GAUSSIANS), "--width", str(WIDTH),
           "--height", str(HEIGHT), "--steps", str(SCALING_STEPS), "--device", dev.type]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=SCALING_LAUNCH_TIMEOUT_S, cwd=HERE)
    check(proc.returncode == 0, f"launch mode exited {proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(len(lines) == 1, f"launch mode prints one JSON line: {proc.stdout[-4000:]}")
    launch = json.loads(lines[0])
    check(launch["mode"] == "launch" and launch["devices"] == 1 and math.isfinite(launch["loss"]),
          f"launch record: {launch}")
    check(launch["launches"]["raster_fwd"] == SCALING_STEPS + 1 and launch["launches"]["raster_bwd"] == SCALING_STEPS + 1,
          f"launch mode: one forward and one backward launch a step: {launch['launches']}")
    launch_s = time.perf_counter() - t1
    for k in launches:
        launches[k] += launch["launches"][k]
    # The single-device reference: Trainer.train_step from the same scene,
    # config and target, as many steps.
    ref = build_scene(NUM_GAUSSIANS, 0.0, dev)
    trainer = gs.Trainer(raster=cfg, train=gs.TrainConfig(ssim_weight=0.2), show_progress=False)
    state = trainer.init_state(ref)
    target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=dev)
    for _ in range(1 + SCALING_STEPS):
        ref_loss = float(trainer.train_step(ref, state, camera, target)["loss"])
    check(math.isclose(launch["loss"], ref_loss, rel_tol=1e-5),
          f"launch mode's loss {launch['loss']} vs Trainer.train_step's {ref_loss} after {1 + SCALING_STEPS} steps")
    del ref, trainer, state, target
    torch.cuda.empty_cache()
    out = {**rec, "kernels_vs_plain": kernels, "launch": launch, "trainer_loss": ref_loss, "model_s": model_s,
           "launch_s": launch_s, "scaling_launches": launches, "elapsed_s": time.perf_counter() - t_main}
    return out, launches


def json_fields(obj):
    """(key, value) of every field of a JSON record, nested ones included."""
    if isinstance(obj, dict):
        for key, value in obj.items():
            yield key, value
            yield from json_fields(value)
    elif isinstance(obj, list):
        for value in obj:
            yield from json_fields(value)


def kernels_vs_plain(model, camera, cfg, seed: int, what: str) -> dict:
    """The forward and backward kernels on one view's binned inputs (as the
    unsliced render bins them) against their plain versions: the forward's
    colour, T and ``blocks_done`` bitwise, the backward's rows (seeded
    cotangents, the forward's ``blocks_done``) within :func:`rows_error`.
    The plain versions walk ``BENCH_PLAIN_TILES`` tiles at a time; a slot
    belongs to one tile, so the groups' rows add up to the whole walk's.
    Returns the pairs, the pair-pixels walked and the errors."""
    import torch

    from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles, backward_tiles_plain
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_plain

    w, h = camera.width, camera.height
    args, bins, ntx = binned_inputs(model, camera, cfg)
    feat, pair_gaussian, tile_start, tile_count, tile_ids = args
    groups = [slice(i, i + BENCH_PLAIN_TILES) for i in range(0, len(tile_ids), BENCH_PLAIN_TILES)]

    def tiles(g):
        return tile_start[g], tile_count[g], tile_ids[g]

    k_out = forward_tiles(*args, ntx, cfg, w, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts = [forward_tiles_plain(feat, pair_gaussian, *tiles(g), ntx, cfg, w, h) for g in groups]
    p_out = [torch.cat(x) for x in zip(*parts)]
    check(all(torch.equal(a, b) for a, b in zip(k_out, p_out)),
          f"{what}: the forward (colour, T, blocks_done) bitwise its plain version")
    plain_fwd_s = time.perf_counter() - t0
    color, trans, done = k_out
    del parts, p_out
    g_color, g_trans = random_cotangents(color, trans, seed=seed)
    rows = backward_tiles(*args, color, trans, g_color, g_trans, ntx, cfg, done)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_rows = None
    for g in groups:
        part = backward_tiles_plain(feat, pair_gaussian, *tiles(g), color[g], trans[g], g_color[g], g_trans[g],
                                    ntx, cfg, done[g])
        p_rows = part if p_rows is None else p_rows.add_(part)
        del part
    bwd = rows_error(rows, p_rows, f"{what}: backward rows")
    walked = torch.minimum(tile_count.long(), done.long() * cfg.pair_block)
    return {"width": w, "height": h, "tiles": len(tile_ids), "pairs": int(bins.num_pairs),
            "pair_slots": cfg.max_pairs, "early_stop": cfg.early_stop_transmittance, "blocks_done": int(done.sum()),
            "walked_pair_pixels": int(walked.sum()) * cfg.tile_size ** 2, "forward_bitwise": True, "backward": bwd,
            "plain_forward_s": plain_fwd_s, "plain_backward_s": time.perf_counter() - t0}


def bench_phase(dev, t_main: float, capacity: int, demand: int, real_demand: int, real_k_exec: int):
    """Phase 14: the benchmark script (``tools/bench_torch.py``).

    (a) ``synthetic_bench`` in this process at its full sizes, ``ITERS``
    and budget, its stdout captured: every line JSON with the headline's
    value, no extra skipped, no ``error`` field anywhere, every fps positive
    and the loss finite; the headline's capacity and pairs per gaussian
    those phase 3 measured (``capacity``, ``demand``: the same scene and
    sizing), the real-density demand phase 8's (``real_demand``); the
    headline loss within rel 1e-6 of a step (render, ``rgb_loss``,
    gradients) taken here on a fresh scene at the headline config (cuDNN
    may choose other convolution algorithms in another call, so not
    bitwise); each kernel's launches over the call the plan's: forward and
    backward one a step (the warm-up and ``ITERS[i]``) at each unsliced
    point, both carry kernels ``real_k_exec`` (phase 8's slices at the
    bench pose and settings) a sliced step. Then the forward and backward
    kernels against their plain versions (:func:`kernels_vs_plain`) at the
    bench's points that no earlier phase reaches, each sized as the bench
    sized it (its capacity or demand checked against the bench's record):
    4K, the last sweep point (the densest), and the real-density scene
    unsliced in exact mode (every one of its 40M pairs walked) and with
    early stop 1e-4 (the single-sort step's). (b) ``tools/bench_torch.py
    --selftest`` as a command: exit 0, ``ok`` and an image error of 0.0
    (the forward is bitwise its plain version). Returns (the phase's
    record, each kernel's launches over (a))."""
    import contextlib
    import io

    import torch

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.kernels.raster_bwd import backward_tiles, backward_tiles_carry
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_carry

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import bench_torch as BT

    t0 = time.perf_counter()
    counted = {"raster_fwd": forward_tiles, "raster_bwd": backward_tiles, "raster_fwd_carry": forward_tiles_carry,
               "raster_bwd_carry": backward_tiles_carry}
    torch.cuda.synchronize()
    for wrapper in counted.values():
        wrapper.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = BT.synthetic_bench(quick=False, device=dev.type)
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in counted.items()}
    bench_s = time.perf_counter() - t0
    lines = []
    for line in out.getvalue().splitlines():
        try:
            lines.append(json.loads(line))
        except json.JSONDecodeError:
            check(False, f"bench line is JSON: {line!r}")
    check(len(lines) >= 2 and all(line["value"] == result["value"] for line in lines),
          f"every bench line carries the headline value: {[line['value'] for line in lines]}")
    extra = result["extra"]
    check(extra["budget"]["skipped"] == [], f"no bench extra skipped: {extra['budget']}")
    errors = [(k, v) for k, v in json_fields(result) if k in ("error", "message")]
    check(not errors, f"no bench extra in error: {errors}")
    real, sweep = extra["real_density"], extra["pair_sweep"]
    fps = [result["value"], real["fps"], real["exact_mode_fps"], real["single_sort_fps"], extra["res_4k"]["fps"],
           *(p["fps"] for p in sweep), extra["early_stop_fps"]]
    check(len(sweep) == len(BT.PAIR_SWEEP_SHIFTS) and all(v > 0 for v in fps), f"every fps positive: {fps}")
    check(math.isfinite(extra["loss"]), f"finite headline loss: {extra['loss']}")
    check(extra["max_pairs"] == capacity and extra["pairs_per_gaussian"] == round(demand / BT.NUM_GAUSSIANS, 2),
          f"headline capacity and pairs per gaussian {extra['max_pairs']}, {extra['pairs_per_gaussian']} "
          f"are phase 3's {capacity}, {round(demand / BT.NUM_GAUSSIANS, 2)}")
    check(real["pair_demand"] == real_demand, f"real-density demand {real['pair_demand']} is phase 8's {real_demand}")
    it = BT.ITERS
    unsliced = 2 * (1 + it[0]) + 2 * (1 + it[2]) + (1 + it[3]) + len(BT.PAIR_SWEEP_SHIFTS) * (1 + it[1])
    sliced = (1 + it[2]) * real_k_exec
    plan = {"raster_fwd": unsliced, "raster_bwd": unsliced, "raster_fwd_carry": sliced, "raster_bwd_carry": sliced}
    check(launches == plan, f"bench launches {launches} are the plan's {plan}")

    model = build_scene(BT.NUM_GAUSSIANS, 0.0, dev)
    cam = gs.CameraArrays.from_params(bench_camera(BT.WIDTH, BT.HEIGHT), device=dev)
    target = torch.full((BT.HEIGHT, BT.WIDTH, 3), 0.25, device=dev)
    loss = gs.rgb_loss(gs.render_traced(model, cam, BT.WIDTH, BT.HEIGHT, BT.make_cfg(capacity, 0.0))[0], target, 0.2)
    torch.autograd.grad(loss, list(model.parameters()))
    step_loss = float(loss.detach())
    check(math.isclose(extra["loss"], step_loss, rel_tol=1e-6),
          f"bench headline loss {extra['loss']} vs a step here {step_loss}")
    del cam, target, loss

    # The kernels against their plain versions at the bench's points that
    # no earlier phase reaches, sized as the bench sized them.
    t_plain = time.perf_counter()
    k4, (w4, h4) = {}, BT.RES_4K
    with torch.inference_mode():
        cam4 = bench_camera(w4, h4)
        cap4, dem4 = BT.sized_capacity(model, gs.CameraArrays.from_params(cam4, device=dev), width=w4, height=h4)
        check(dem4 == extra["res_4k"]["pair_demand"], f"4K demand {dem4} is the bench's")
        k4["res_4k"] = kernels_vs_plain(model, cam4, BT.make_cfg(cap4, 0.0), 41, "bench 4K")
        del model
        shift, point = BT.PAIR_SWEEP_SHIFTS[-1], sweep[-1]
        model = build_scene(BT.NUM_GAUSSIANS, shift, dev)
        camera = bench_camera(BT.WIDTH, BT.HEIGHT)
        cam = gs.CameraArrays.from_params(camera, device=dev)
        cap, _ = BT.sized_capacity(model, cam)
        check(cap == point["max_pairs"], f"sweep[{shift}] capacity {cap} is the bench's {point['max_pairs']}")
        k4[f"pair_sweep[{shift}]"] = kernels_vs_plain(model, camera, BT.make_cfg(cap, 1e-4), 42,
                                                      f"bench sweep[{shift}]")
        del model
        model = build_scene(BT.REAL_DENSITY_N, BT.REAL_DENSITY_SHIFT, dev)
        cap, dem = BT.sized_capacity(model, cam, headroom=1.1)
        check((cap, dem) == (real["max_pairs"], real["pair_demand"]), "the real-density capacity is the bench's")
        k4["real_density_exact"] = kernels_vs_plain(model, camera, BT.make_cfg(cap, 0.0), 43,
                                                    "bench real density, exact mode")
        # The single-sort step: early stop 1e-4 (``reduce_pairs`` shapes the
        # reduction after the backward kernel, not the kernel's inputs).
        k4["real_density_single_sort"] = kernels_vs_plain(
            model, camera, BT.make_cfg(cap, 1e-4, reduce_pairs=cap // 4), 44, "bench real density, single sort")
        del model, cam
    torch.cuda.empty_cache()  # the selftest's process needs the card's memory
    kernels_s = time.perf_counter() - t_plain

    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(HERE, "tools", "bench_torch.py"), "--selftest"],
                          capture_output=True, text=True, timeout=BENCH_SELFTEST_TIMEOUT_S, cwd=HERE)
    check(proc.returncode == 0, f"--selftest exited {proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    selftest = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    check(selftest["extra"]["ok"] is True and selftest["extra"]["max_abs_err_image"] == 0.0,
          f"selftest: {selftest}")
    selftest_s = time.perf_counter() - t1
    rec = {
        "headline_fps": result["value"], "headline_sec_per_frame": extra["sec_per_frame"],
        "real_density_fps": real["fps"], "real_density_exact_mode_fps": real["exact_mode_fps"],
        "real_density_single_sort_fps": real["single_sort_fps"], "res_4k_fps": extra["res_4k"]["fps"],
        "pair_sweep": [{"pairs_per_gaussian": p["pairs_per_gaussian"], "fps": p["fps"]} for p in sweep],
        "early_stop_fps": extra["early_stop_fps"], "headline_loss": extra["loss"], "step_loss_here": step_loss,
        "bench_launches": launches, "kernels_vs_plain": k4, "selftest": selftest["extra"], "bench_s": bench_s,
        "kernels_s": kernels_s, "selftest_s": selftest_s,
        "phase_s": time.perf_counter() - t0, "elapsed_s": time.perf_counter() - t_main, "last_line": result,
    }
    return rec, launches


# Phase 15: the TPU probes' kernels (kernels/probes.py), each with the
# function of ``scripts/`` it replaces (file:line of its Pallas body).
PROBE_KERNELS = {
    "transpose_smem": ("gsplat_tpu_torch/csrc/probe_transpose.cu", "scripts/probe_transpose.py:19"),
    "transpose_mma": ("gsplat_tpu_torch/csrc/probe_transpose.cu", "scripts/probe_transpose.py:27"),
    "transpose_block_async": ("gsplat_tpu_torch/csrc/probe_transpose.cu", "scripts/probe_transpose.py:38"),
    "lane_dma": ("gsplat_tpu_torch/csrc/probe_lane_dma.cu", "scripts/probe_lane_dma.py:11"),
    "orientation_a": ("gsplat_tpu_torch/csrc/probe_orientation.cu", "scripts/orientation_test.py:32"),
    "orientation_b": ("gsplat_tpu_torch/csrc/probe_orientation.cu", "scripts/orientation_test.py:69"),
}
PROBE_CHECK_REPS = 2  # chunks at which phase 15 holds the orientation kernels to their plain versions
PROBE_RTOL, PROBE_ATOL = 1e-5, 1e-6  # the card's expf against PyTorch's exp


def probe_checks(dev) -> dict:
    """The orientation kernels against their plain versions on the card at
    ``PROBE_CHECK_REPS`` chunks, at the TPU probe's inputs and the passing
    set: exactly zero at ``t0 = 0``, within rtol 1e-5 / atol 1e-6 of theirs
    at ``t0 = 1``. Returns each kernel's largest absolute error."""
    import torch

    from gsplat_tpu_torch.kernels import probes as P

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import orientation_test as OT

    errs = {}
    for name, wrapper, plain in (("orientation_a", P.orientation_a, P.orientation_a_plain),
                                 ("orientation_b", P.orientation_b, P.orientation_b_plain)):
        orientation = name[-1]
        for features in ("jax", "passing"):
            feat = torch.from_numpy(OT.features_block(orientation, features)).to(dev)
            check(bool((wrapper(feat, PROBE_CHECK_REPS, 0.0) == 0).all()), f"{name} at t0 = 0 is zero ({features})")
            got, want = wrapper(feat, PROBE_CHECK_REPS, 1.0), plain(feat, PROBE_CHECK_REPS, 1.0)
            check(bool(torch.allclose(got, want, rtol=PROBE_RTOL, atol=PROBE_ATOL)),
                  f"{name} at t0 = 1 within rtol 1e-5 of its plain version ({features}): "
                  f"max abs err {(got - want).abs().max().item()}")
            errs[name] = max(errs.get(name, 0.0), (got - want).abs().max().item())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return errs


def probes_phase(dev, t_main: float):
    """Phase 15: the TPU probes' counterparts (``tools/probe_transpose.py``,
    ``tools/probe_lane_dma.py``, ``tools/orientation_test.py``) run in this
    process as a user runs them (``main``, at full size, on ``dev``), their
    output captured: every line JSON, every check of theirs holding, each
    on this card (a positive time and the card's ``nvidia-smi`` line), and
    each probe kernel's launches over the three the tools' plan (one
    checked launch a probe, and on the card its timed ones). Then
    :func:`probe_checks` holds the orientation kernels to their plain
    versions at 2 chunks. Returns (the phase's record, the ``kernels``
    line's rows of the six kernels)."""
    import contextlib
    import io

    import torch

    from gsplat_tpu_torch.kernels import probes as P

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import orientation_test as OT
    import probe_lane_dma as PLD
    import probe_transpose as PT

    t0 = time.perf_counter()
    wrappers = {name: getattr(P, name) for name in PROBE_KERNELS}
    torch.cuda.synchronize()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        flags = ["--device", dev.type]
        rcs = {"probe_transpose": PT.main(flags), "probe_lane_dma": PLD.main(flags), "orientation_test": OT.main(flags)}
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    tools_s = time.perf_counter() - t0
    records = []
    for line in out.getvalue().splitlines():
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            check(False, f"probe line is JSON: {line!r}")
    check(rcs == {name: 0 for name in rcs}, f"every probe tool exits 0: {rcs}")
    on_card = dev.type == "cuda"
    smi = nvidia_smi_line() if on_card else None
    for rec in records:
        check(rec["ok"] and rec["device"] == dev.type and rec["nvidia_smi"] == smi and (not on_card or rec["ms"] > 0),
              f"probe {rec['probe']} ({rec.get('features', rec.get('mode', ''))}) holds on this card: {rec}")
    per_t, per_o = 1 + on_card * (PT.WARMUP + PT.ITERS), len(OT.FEATURE_SETS) * (1 + on_card * (OT.WARMUP + OT.ITERS))
    n_special = len(PT.special_blocks())  # one launch a block and mode, a block and shape with the random bits
    planned = {"transpose_smem": 2 * (per_t + n_special + 1), "transpose_mma": 2 * (per_t + n_special),
               "transpose_block_async": per_t,
               "lane_dma": 1 + on_card * (PLD.WARMUP + PLD.ITERS), "orientation_a": per_o, "orientation_b": per_o}
    check(launches == planned, f"probe kernel launches {launches} are the tools' plan {planned}")
    by = {}
    for rec in records:
        by.setdefault(rec["kernel"], []).append(rec)
    n_sets = len(OT.FEATURE_SETS)
    check([len(by[name]) for name in PROBE_KERNELS] == [2, 2, 1, 1, n_sets, n_sets], f"one record a probe: {list(by)}")
    mma = {rec["mode"]: rec for rec in by["transpose_mma"]}
    check(mma["3xtf32"]["bitwise_equal"], "3xTF32 on the tensor cores is bitwise x.T")
    check(mma["3xtf32"]["special_x_t_equal"], "3xTF32 is bitwise x.T at the finite normal special blocks")
    for rec in by["transpose_smem"] + by["transpose_mma"]:
        check(rec["special_bitwise_equal"], f"{rec['probe']} holds its plain version at every special block")
    orient = {(rec["kernel"], rec["features"]): rec for rec in records if "features" in rec}
    for name in ("orientation_a", "orientation_b"):
        reps = OT.REPS_A if name[-1] == "a" else OT.REPS_B
        check(all(orient[(name, f)]["reps"] == reps for f in OT.FEATURE_SETS), f"{name} runs the TPU probe's size")
        check(orient[(name, "jax")]["zero"], f"{name} at the TPU probe's own inputs and size is zero")
        check(orient[(name, "passing")]["passed_share"] > 0.1, f"{name}'s passing set passes the gate")
        sparse = orient[(name, "sparse")]
        check(sparse["trans_bitwise"] and sparse["passed_pair_pixels"] == reps * P.NPIX and sparse["trans_min"] > 0,
              f"{name}'s sparse set keeps T above zero through the walk, bitwise its plain version's: {sparse}")
    t1 = time.perf_counter()
    errs = {name: max(rec["max_abs_err"] for rec in by[name]) for name in PROBE_KERNELS}
    for name, err in probe_checks(dev).items():
        errs[name] = max(errs[name], err)
    checks_s = time.perf_counter() - t1

    def row(name, rec, **extra):
        source, replaces = PROBE_KERNELS[name]
        quartiles = {k: rec[k] for k in ("ms_quartiles", "plain_ms_quartiles", "library_ms_quartiles") if k in rec}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "share_of_bound": rec["bound_ms"] / rec["ms"] if rec["ms"] else None, **quartiles, **extra}

    def orientation_row(name):
        rec, jax, sparse = orient[(name, "passing")], orient[(name, "jax")], orient[(name, "sparse")]
        keys = ("ns_per_pair_pixel", "pair_pixels", "passed_pair_pixels", "passed_share", "instruction_bound_ms",
                "share_of_instruction_bound")
        other = ("ms", "bound_ms", "share_of_bound", *keys)
        return row(name, rec, features="passing", t0=1.0, **{k: rec[k] for k in keys},
                   jax_inputs={k: jax[k] for k in other},
                   sparse={k: sparse[k] for k in (*other, "trans_min", "trans_max")})

    t1_rec, t2_rec = by["transpose_smem"]
    timed = ("ms", "ms_quartiles", "plain_ms", "plain_ms_quartiles")
    rows = [
        row("transpose_smem", t1_rec, also_replaces="scripts/probe_transpose.py:23",
            t2={k: t2_rec.get(k) for k in (*timed, "library_ms", "library_ms_quartiles", "bound_ms")}),
        row("transpose_mma", mma["3xtf32"], mode="3xtf32",
            tf32={k: mma["tf32"].get(k) for k in (*timed, "bitwise_equal", "max_rel_err", "bound_ms")}),
        row("transpose_block_async", by["transpose_block_async"][0]),
        row("lane_dma", by["lane_dma"][0]),
        orientation_row("orientation_a"),
        orientation_row("orientation_b"),
    ]
    keep = ("probe", "kernel", "features", "mode", "ms", "ms_quartiles", "plain_ms", "library_ms", "bound_ms",
            "bitwise_equal", "special_bitwise_equal", "max_rel_err", "ns_per_pair_pixel", "passed_share",
            "instruction_bound_ms", "max_abs_err", "trans_bitwise", "trans_min")
    return {"launches": launches, "tools_s": tools_s, "checks_s": checks_s, "max_abs_err": errs,
            "records": [{k: rec[k] for k in keep if k in rec} for rec in records],
            "script_s_so_far": time.perf_counter() - t_main}, rows


# Phase 16: the preprocess kernel at the benchmark's pose set orbit8, at the
# headline (1M) and dense (5M) scenes.
PREP_TRAFFIC = os.path.join(HERE, "splatbench", "traffic", "render.json")
PREP_ITERS, PREP_ROUNDS = 10, 9  # calls a graph, rounds of alternating replays
PREP_SLEEP_CYCLES = 2_000_000  # about 1 ms of device spin before each replay
PREP_PROFILE_CALLS = 50
CU_GRAPH_DEVICE_NODES = (0, 1, 2)  # CUgraphNodeType: kernel, memcpy, memset


def orbit8_poses():
    """(yaw, shift) of each pose the benchmark's render traffic serves,
    read through its own generator (``splatbench/scene.py::poses``)."""
    from splatbench.scene import poses

    with open(PREP_TRAFFIC) as f:
        traffic = json.load(f)
    check(traffic["poses"]["name"] == "orbit8", f"{PREP_TRAFFIC} serves orbit8")
    return poses(traffic)


def graph_ops(fn) -> int:
    """Device operations (kernels, copies, fills) one ``fn()`` launches: the
    kernel, memcpy and memset nodes of its CUDA graph capture, counted by
    the driver (``cuGraphGetNodes``), which sees every launch on the
    captured stream, the port's own kernels included. ``fn`` runs once
    before, uncaptured, and must not synchronise the host."""
    import ctypes

    import torch

    driver = ctypes.CDLL("libcuda.so.1")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    raw = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    count = ctypes.c_size_t(0)
    check(driver.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0, "cuGraphGetNodes counts the nodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(driver.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0, "cuGraphGetNodes lists the nodes")
    ops, kind = 0, ctypes.c_int(0)
    for node in nodes:
        check(driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0, "cuGraphNodeGetType")
        ops += kind.value in CU_GRAPH_DEVICE_NODES
    graph.reset()
    return ops


def profiled_ops(fn):
    """Device operations one ``fn()`` launches as ``torch.profiler`` records
    them (None where it records none). Late in a long process the profiler
    has been seen to miss the first 28 device operations of a session, so
    this is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages() if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    return ops or None


def profiled_kernel_ms(fn, name: str):
    """(mean device ms of one launch of the kernels whose name holds
    ``name``, launches recorded) over one ``fn()``, from ``torch.profiler``
    ((None, 0) where it records none of them). A mean over the launches it
    recorded, so one that misses some still reads the kernel's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in hits)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in hits)
    return (busy_us / 1e3 / count if count else None), count


def queued_kernel_ms(fn, name: str) -> dict:
    """One kernel call ``fn()`` timed as phase 16 times it: device ms in
    queued rounds (graphs of ``PREP_ITERS`` calls replayed after a device
    spin; median and quartiles) and from the profiler (a mean over the
    launches of the kernels named ``name`` it recorded)."""
    graph = capture_graph(fn, PREP_ITERS, warmup=3)
    rounds = sorted(replay_ms(graph, PREP_ITERS, PREP_SLEEP_CYCLES) for _ in range(PREP_ROUNDS))
    q1, med, q3 = statistics.quantiles(rounds, n=4)
    del graph

    def calls():
        for _ in range(PREP_PROFILE_CALLS):
            fn()  # each call's outputs freed before the next: the pool's gradients are 2.3 GB a call

    prof_ms, prof_launches = profiled_kernel_ms(calls, name)
    return {"kernel_ms": med, "kernel_ms_quartiles": [q1, q3], "kernel_profiler_ms": prof_ms,
            "kernel_profiler_launches": prof_launches}


def preprocess_backward_record(model, cam, label: str) -> dict:
    """The preprocess backward kernel at one model and camera: its
    gradients against the eager path's autograd for a random cotangent of
    the packed features (read as ``pack_features``' column slices; rgb's
    entries zero where either path's colour lies within ``RGB_ATOL`` of the
    clamp's kinks at 0 and 1), within rtol 1e-4 + atol 1e-5 of each
    column's largest magnitude (``err_ratio``: the worst error over that
    tolerance); its device ms (``queued_kernel_ms``) beside its bytes bound
    (``bytes_moved_backward``); the eager backward's ms (CUDA events) and
    profiler ms, over a graph built once."""
    import torch

    from gsplat_tpu_torch.kernels import preprocess as kp

    n = model.num_gaussians
    dev = model.means.device
    cam = type(cam)(*(t.clone() for t in cam))  # not inference tensors: the eager graph saves them
    with torch.no_grad():
        inputs = tuple(t.detach().clone() for t in (model.means, model.sh, model.quats, model.scales()))
        opacity = model.opacity().detach().clone()
        kink = torch.zeros((n, 3), dtype=torch.bool, device=dev)
        for prep in (kp.preprocess_forward(*inputs, opacity, cam, WIDTH, HEIGHT, 3, True),
                     kp.preprocess_plain(*inputs, opacity, cam, WIDTH, HEIGHT, 3, True)):
            kink |= (prep.rgb <= kp.RGB_ATOL) | (prep.rgb >= 1.0 - kp.RGB_ATOL)
        del prep
    g = torch.Generator(device=dev).manual_seed(1)
    v_feat = torch.randn((n + 1, 16), generator=g, device=dev)
    v_feat[:n, 6:9][kink] = 0.0
    del kink
    cot = (v_feat[:n, 0:2], v_feat[:n, 2:5], v_feat[:n, 6:9])  # pack_features' columns

    def kernel():
        return kp.preprocess_backward(*inputs, cam, WIDTH, HEIGHT, 3, *cot)

    leaves = [t.clone().requires_grad_() for t in inputs]
    prep = kp.preprocess_plain(*leaves, opacity, cam, WIDTH, HEIGHT, 3, True)
    outs = (prep.screen_means, prep.conics, prep.rgb)
    del prep

    def eager():
        return torch.autograd.grad(outs, leaves, cot, retain_graph=True)

    ratio = 0.0
    for name, got, want in zip(("means", "sh", "quats", "scales"), kernel(), eager()):
        got, want = got.reshape(n, -1), want.reshape(n, -1)
        finite = torch.isfinite(want)
        check(torch.equal(torch.isfinite(got), finite), f"{label}: {name} gradient finite where the eager path's is")
        scale = torch.where(finite, want.abs(), torch.zeros_like(want)).amax(0, keepdim=True)
        tol = 1e-4 * want.abs() + 1e-5 * scale
        worst = float(torch.where(finite, (got - want).abs() / tol.clamp(min=1e-38), torch.zeros_like(want)).max())
        check(worst <= 1.0, f"{label}: {name} gradient within rtol 1e-4 + atol 1e-5 of its columns' scale: {worst}")
        ratio = max(ratio, worst)
        del got, want, finite, scale, tol
    rec = {"num_gaussians": n, "err_ratio": ratio, "eager_ms": cuda_ms(eager, 3, warmup=1),
           "eager_profiler_ms": device_busy_ms(eager)}
    del outs, leaves  # the eager graph, before the kernel's timing graph takes its memory
    torch.cuda.empty_cache()
    nbytes = kp.bytes_moved_backward(n, 3)
    bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
    rec.update({**queued_kernel_ms(kernel, "preprocess_bwd_kernel"), "bytes": nbytes, "bound_ms": bound_ms})
    rec["share_of_bound"] = bound_ms / rec["kernel_ms"]
    return rec


def preprocess_phase(dev, t_main: float):
    """Phase 16: the preprocess kernels (``kernels/preprocess.py``,
    ``csrc/preprocess.cu``) at the headline and the dense scene and at
    ``recipe_5m``'s pool (the dense scene padded to 10,000,128 rows by
    ``train/densify.py::init_pool``). At every orbit8 pose
    (``orbit8_poses``), every forward output but rgb bitwise the eager
    path's and rgb within ``kernels/preprocess.py``'s ``RGB_ATOL``. At the
    first pose: the forward kernel's device ms (``queued_kernel_ms``)
    beside its bytes bound; the eager path's ms (CUDA events) and profiler
    ms; the device operations of a grad-free request's preprocess
    (``graph_ops``: the kernel and the two activations, at most 4, and one
    launch of the wrapper) and of the eager path (``profiled_ops``); the
    backward kernel (``preprocess_backward_record``: gradients, times,
    bound, the eager backward); a grad-free request's and a training step's
    stages, ``preprocess_kernel`` counted 1 on both and
    ``preprocess_bwd_kernel`` 1 on the step, and each kernel launched once
    a step. Returns (the phase's record, the forward kernel's launches over
    the phase)."""
    import torch

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.config import DensifyConfig
    from gsplat_tpu_torch.kernels import preprocess as kp
    from gsplat_tpu_torch.render.pipeline import preprocess_traced
    from gsplat_tpu_torch.train.densify import init_pool

    t0 = time.perf_counter()
    kp.preprocess_forward.launches = kp.preprocess_backward.launches = 0
    orbit8 = orbit8_poses()
    out = {}
    for name, n, shift in (("headline_1m", NUM_GAUSSIANS, 0.0), ("dense_5m", REAL_N, REAL_SHIFT)):
        model = build_scene(n, shift, dev)
        rec = {"num_gaussians": n, "poses": len(orbit8), "rgb_max_abs_err": []}
        with torch.inference_mode():
            inputs = (model.means, model.sh, model.quats, model.scales(), model.opacity())
            cams = [gs.CameraArrays.from_params(bench_camera(WIDTH, HEIGHT, yaw, sh), device=dev) for yaw, sh in orbit8]
            for i, cam in enumerate(cams):
                got = kp.preprocess_forward(*inputs, cam, WIDTH, HEIGHT, 3, True)
                torch.cuda.synchronize()
                want = kp.preprocess_plain(*inputs, cam, WIDTH, HEIGHT, 3, True)
                for field in want._fields:
                    if field != "rgb":
                        check(kp.same_bits(getattr(got, field), getattr(want, field)),
                              f"{name} pose {i}: preprocess {field} bitwise the eager path's")
                err = float((got.rgb - want.rgb).abs().max())
                check(err <= kp.RGB_ATOL, f"{name} pose {i}: rgb within {kp.RGB_ATOL} of the eager path's: {err}")
                rec["rgb_max_abs_err"].append(err)
                del got, want
            cam = cams[0]

            def kernel():
                return kp.preprocess_forward(*inputs, cam, WIDTH, HEIGHT, 3, True)

            def eager():
                return kp.preprocess_plain(*inputs, cam, WIDTH, HEIGHT, 3, True)

            rec.update(queued_kernel_ms(kernel, "preprocess_kernel"))
            nbytes = kp.bytes_moved(n, 3)
            bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
            eager_busy = device_busy_ms(eager)
            before = kp.preprocess_forward.launches
            ops = graph_ops(lambda: preprocess_traced(model, cam, WIDTH, HEIGHT, gs.RasterConfig()))
            wrapper_launches = kp.preprocess_forward.launches - before
            check(1 <= ops <= 4, f"{name}: a grad-free preprocess launches {ops} device operations")
            check(wrapper_launches == 2, f"{name}: the preprocess kernel launched once uncaptured, once captured: "
                                         f"{wrapper_launches}")
            rec.update({
                "bytes": nbytes, "bound_ms": bound_ms, "share_of_bound": bound_ms / rec["kernel_ms"],
                "eager_ms": cuda_ms(eager, 5, warmup=1), "eager_profiler_ms": eager_busy,
                "request_preprocess_ops": ops,
                "eager_preprocess_ops": profiled_ops(lambda: kp.preprocess_plain(
                    model.means, model.sh, model.quats, model.scales(), model.opacity(), cam, WIDTH, HEIGHT, 3, True)),
            })
        rec["backward"] = preprocess_backward_record(model, cam, name)
        if name == "dense_5m":
            probe = gs.RasterConfig(tile_size=32, chunk_size=32, max_pairs=1 << 20)
            with torch.inference_mode():
                demand = int(gs.binning_stats(model, cam, WIDTH, HEIGHT, probe)["pair_demand"])
            rcfg = gs.RasterConfig(tile_size=32, chunk_size=32, pair_block=128,
                                   max_pairs=max(int(demand * 1.1) // 128 * 128, CAPACITY_FLOOR), sh_degree=3,
                                   early_stop_transmittance=1e-4, slice_pairs=REAL_SLICE, reduce_pairs=REAL_REDUCE)
            camera = bench_camera(WIDTH, HEIGHT, *orbit8[0])
            target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=dev)

            def request():
                with torch.no_grad():
                    return gs.render(model, camera, rcfg)

            def step():
                image, _ = gs.render(model, camera, rcfg)
                return torch.autograd.grad(gs.rgb_loss(image, target, 0.2), list(model.parameters()))

            request()
            rec["request"] = stage_breakdown(request)
            rec["request_ms"] = cuda_ms(request, 5)
            step()  # warm-up: SSIM's convolutions, the backward's buffers
            before = kp.preprocess_forward.launches, kp.preprocess_backward.launches
            step()
            torch.cuda.synchronize()
            rec["step_launches"] = {"preprocess_forward": kp.preprocess_forward.launches - before[0],
                                    "preprocess_backward": kp.preprocess_backward.launches - before[1]}
            check(rec["step_launches"] == {"preprocess_forward": 1, "preprocess_backward": 1},
                  f"a training step launches each preprocess kernel once: {rec['step_launches']}")
            rec["step"] = stage_breakdown(step, runs=2)
            rec["step_ms"] = cuda_ms(step, 3)
            counters = rec["step"]["counters"]
            check(rec["request"]["counters"].get("preprocess_kernel") == 1, "a request counts preprocess_kernel 1")
            check(counters.get("preprocess_kernel") == 1 and counters.get("preprocess_bwd_kernel") == 1,
                  "a training step counts preprocess_kernel 1 and preprocess_bwd_kernel 1")
            del target
            # recipe_5m's pool: the dense scene and its dead rows at the origin.
            pool = init_pool(model, DensifyConfig())
            with torch.inference_mode():
                pool_inputs = (pool.means, pool.sh, pool.quats, pool.scales(), pool.opacity())
                pool_rec = {"num_gaussians": pool.num_gaussians,
                            **queued_kernel_ms(lambda: kp.preprocess_forward(*pool_inputs, cam, WIDTH, HEIGHT, 3,
                                                                             True), "preprocess_kernel")}
                pool_rec["bound_ms"] = kp.bytes_moved(pool.num_gaussians, 3) / PEAK_HBM_BYTES * 1e3
                del pool_inputs
            pool_rec["backward"] = preprocess_backward_record(pool, cam, "recipe_5m pool")
            out["recipe_5m_pool"] = pool_rec
            del pool
        out[name] = rec
        del model, inputs, cams
        torch.cuda.empty_cache()
    launches = kp.preprocess_forward.launches
    out.update({"launches": launches, "backward_launches": kp.preprocess_backward.launches,
                "phase_s": time.perf_counter() - t0, "elapsed_s": time.perf_counter() - t_main})
    return out, launches


def main() -> int:
    t_main = time.perf_counter()
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
    import tempfile

    import gsplat_tpu_torch as gs
    from gsplat_tpu_torch.kernels import build
    from gsplat_tpu_torch.kernels.preprocess import preprocess_backward, preprocess_forward
    from gsplat_tpu_torch.kernels.raster_bwd import (
        backward_tiles, backward_tiles_carry, backward_tiles_plain, reduce_pair_grads,
    )
    from gsplat_tpu_torch.kernels.raster_fwd import forward_tiles, forward_tiles_carry, forward_tiles_plain
    from gsplat_tpu_torch.render.tile_torch import tiles_to_image

    dev = torch.device("cuda")
    smi = nvidia_smi_line()

    # -- phase 1: device and build --
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln or "entry function" in ln]
             for name in build.SOURCES}
    emit({
        "phase": "device", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "build_s": build_s, "compiled": sorted(built),
        "ptxas": ptxas, "resources": {name: ptxas_by_kernel(build.build_log(name)) for name in build.SOURCES},
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
        forward_tiles.launches = backward_tiles.launches = preprocess_forward.launches = 0
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
        check(backward_tiles.launches == 0, "no backward launch while serving")
        prep_launches = preprocess_forward.launches
        check(prep_launches == len(poses), f"preprocess kernel launches over the requests: {prep_launches} != {len(poses)}")
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
        "requests": requests, "kernel_launches": launches, "preprocess_launches": prep_launches, "pixels": n_pix,
        "within_1e-4": within_1e4, "within_5e-3": within_5e3, "max_abs_err": frame_err,
    })
    served_frames = frames  # phase 11's reference
    head_demand = demand  # phase 14's reference

    # -- phase 4: kernel timing and bound at the phase-3 shapes --
    with torch.inference_mode():
        for _ in range(3):
            forward_tiles(*args, ntx, cfg, WIDTH, HEIGHT)
        kernel_ms = cuda_ms(lambda: forward_tiles(*args, ntx, cfg, WIDTH, HEIGHT), 20)
        plain_ms = cuda_ms(lambda: forward_tiles_plain(*args, ntx, cfg, WIDTH, HEIGHT), 3)
        breakdown = request_breakdown(model, cam0, cfg)
        # Exact mode: every tile walks all its pairs (blocks_done = all).
        fwd_bytes = (sum(t.numel() * t.element_size() for t in args)
                     + len(args[4]) * (cfg.tile_size ** 2 * 4 * 4 + 4))  # colour, T, blocks_done
        fwd_bound = compositor_bound(pair_pixels(args, ntx, cfg), fwd_bytes, backward=False)
    emit({
        "phase": "timing", "kernel_ms": kernel_ms, "plain_ms": plain_ms, **fwd_bound,
        "pair_slots": args[1].numel(), "tiles": len(args[4]), **breakdown,
    })

    # -- phase 5: backward kernel vs plain, small; autograd vs oracle, tiny --
    grad_small = {}
    with torch.inference_mode():
        model = build_scene(20_000, 2.5, dev)
        args, bins, ntx = binned_inputs(model, bench_camera(256, 192), small_cfg)
        n_rows = args[0].shape[0]
        for stop in (0.0, 1e-4):
            scfg = dataclasses.replace(small_cfg, early_stop_transmittance=stop)
            color, trans, done = forward_tiles(*args, ntx, scfg, 256, 192)
            outs = (color, trans, *random_cotangents(color, trans, seed=1))
            runs = []
            for _ in range(2):
                rows = backward_tiles(*args, *outs, ntx, scfg, done)
                runs.append((rows, reduce_pair_grads(rows, args[1], bins.gaussian_counts, n_rows)))
            torch.cuda.synchronize()
            p_rows = backward_tiles_plain(*args, *outs, ntx, scfg, done)
            p_feat = reduce_pair_grads(p_rows, args[1], bins.gaussian_counts, n_rows)
            (rows, d_feat), (rows2, d_feat2) = runs
            check(torch.equal(rows, rows2) and torch.equal(d_feat, d_feat2),
                  f"two backward + reduction runs bitwise equal (early stop {stop})")
            grad_small[f"stop_{stop}"] = {
                "rows": rows_error(rows, p_rows, f"phase 5 rows (early stop {stop})"),
                "d_feat": rows_error(d_feat, p_feat, f"phase 5 d_feat (early stop {stop})"),
                "tiles_stopped_early": int((done < -(-args[3] // scfg.pair_block)).sum()),
            }
        check(grad_small["stop_0.0001"]["tiles_stopped_early"] > 0, "phase 5 exercises the early stop")
    tiny_model = build_scene(300, 1.5, dev)
    names = [k for k, _ in tiny_model.named_parameters()]
    w_img, w_trans = random_cotangents(torch.empty(48, 64, 3, device=dev), torch.empty(48, 64, device=dev), seed=2)
    grads = []
    for render_fn in (gs.render, gs.render_reference_oracle):
        img, trans = render_fn(tiny_model, tiny_cam, tiny_cfg)
        loss = (img * w_img).sum() + (trans * w_trans).sum()
        grads.append(torch.autograd.grad(loss, list(tiny_model.parameters())))
    grad_small["oracle_grad_max_abs_err"] = {}
    for name, got, want in zip(names, *grads):
        check(bool(torch.isfinite(got).all()), f"finite {name} gradient")
        scale = float(want.abs().max()) + 1e-8
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-5 * scale + 1e-10)  # tests/test_gradients.py:47
        grad_small["oracle_grad_max_abs_err"][name] = float((got - want).abs().max()) / scale
    emit({"phase": "grad_small", **grad_small})

    # -- phase 6: the training step at full width --
    model = build_scene(NUM_GAUSSIANS, 0.0, dev)
    target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=dev)
    train = {}
    with torch.no_grad():
        args, bins, ntx = binned_inputs(model, cam0, cfg)
        color, trans, done = forward_tiles(*args, ntx, cfg, WIDTH, HEIGHT)
        outs = (color, trans, *random_cotangents(color, trans, seed=3))
        rows = backward_tiles(*args, *outs, ntx, cfg, done)
        torch.cuda.synchronize()
        p_rows = backward_tiles_plain(*args, *outs, ntx, cfg, done)
        d_feat = reduce_pair_grads(rows, args[1], bins.gaussian_counts, args[0].shape[0])
        p_feat = reduce_pair_grads(p_rows, args[1], bins.gaussian_counts, args[0].shape[0])
        frame = {"rows": rows_error(rows, p_rows, "full-frame rows"),
                 "d_feat": rows_error(d_feat, p_feat, "full-frame d_feat")}
        for _ in range(3):
            backward_tiles(*args, *outs, ntx, cfg, done)
        bwd_ms = cuda_ms(lambda: backward_tiles(*args, *outs, ntx, cfg, done), 20)
        bwd_plain_ms = cuda_ms(lambda: backward_tiles_plain(*args, *outs, ntx, cfg, done), 3)
        reduction_ms = cuda_ms(lambda: reduce_pair_grads(rows, args[1], bins.gaussian_counts, args[0].shape[0]), 20)
        bwd_bytes = (sum(t.numel() * t.element_size() for t in (*args, *outs, done))
                     + args[1].numel() * 9 * 4)  # the [P, 9] rows
        bwd_bound = compositor_bound(pair_pixels(args, ntx, cfg, done), bwd_bytes, backward=True)
        del color, trans, outs, rows, p_rows, d_feat, p_feat

    trainer = gs.Trainer(raster=cfg, train=gs.TrainConfig(ssim_weight=0.2, steps=3, log_every=1),
                         show_progress=False)
    views = [(bench_camera(WIDTH, HEIGHT, yaw), target) for _, yaw in poses]
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forward_tiles.launches = backward_tiles.launches = preprocess_backward.launches = 0
    fit0 = time.perf_counter()
    model, history = trainer.fit(model, views)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - fit0
    train_launches = {"raster_fwd": forward_tiles.launches, "raster_bwd": backward_tiles.launches,
                      "preprocess_bwd": preprocess_backward.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    check(len(history) == 3 and all(math.isfinite(h["loss"]) for h in history), f"finite losses: {history}")
    check(train_launches == {"raster_fwd": 3, "raster_bwd": 3, "preprocess_bwd": 3},
          f"launches over 3 steps: {train_launches}")
    check(trainer.raster == cfg, "no capacity resize at 1.5x demand")
    for k, p in model.named_parameters():
        check(not torch.equal(p.detach(), before[k]), f"parameter {k} changed")
    del before

    optimizer = trainer.init_state(model)
    trainer.train_step(model, optimizer, cam0, target)  # warm-up of a fresh optimizer
    step_ms = cuda_ms(lambda: trainer.train_step(model, optimizer, cam0, target), 5)
    step_busy_ms = device_busy_ms(lambda: trainer.train_step(model, optimizer, cam0, target))
    step_syncs = host_syncs(lambda: trainer.train_step(model, optimizer, cam0, target))
    stages = stage_breakdown(lambda: trainer.train_step(model, optimizer, cam0, target))
    train.update({
        "num_gaussians": NUM_GAUSSIANS, "width": WIDTH, "height": HEIGHT, "capacity": capacity,
        "full_frame_bwd": frame, "losses": [h["loss"] for h in history], "psnr": [h["psnr"] for h in history],
        "fit_s": fit_s, "launches": train_launches, "step_ms": step_ms, "step_device_busy_ms": step_busy_ms,
        "step_host_syncs": step_syncs,
        "stages": stages,
        "raster_bwd_ms": bwd_ms, "raster_bwd_plain_ms": bwd_plain_ms, "reduction_ms": reduction_ms,
        "raster_bwd_bound": bwd_bound,
        "max_memory_allocated": peak_bytes,
        "elapsed_s": time.perf_counter() - t_main,  # since main() began, the build included
    })
    emit({"phase": "train", **train})

    # -- phase 7: the carry kernels vs plain, small; sliced vs single-sort --
    sliced_small = {}
    model = build_scene(20_000, 2.5, dev)
    cam_s = bench_camera(256, 192)
    for stop in (0.0, 1e-4):
        scfg = dataclasses.replace(small_cfg, max_pairs=1 << 19, early_stop_transmittance=stop, slice_pairs=1 << 14)
        with torch.inference_mode():
            feat, color, trans, rec = sliced_records(model, cam_s, scfg)
            g_color, g_trans = random_cotangents(color, trans, seed=4)
            chain = carry_chain(feat, rec, 8, scfg, 256, 192, g_color, g_trans)
            check(torch.equal(chain.pop("color"), color) and torch.equal(chain.pop("trans"), trans),
                  "the checked chain ends at the sliced forward's frame")
            forward_tiles.launches = forward_tiles_carry.launches = 0
            img, img_trans = gs.render(model, cam_s, scfg)
            check((forward_tiles.launches, forward_tiles_carry.launches) == (0, len(rec.ids)),
                  f"a sliced request launches k_exec carry kernels: {forward_tiles_carry.launches}")
            check(torch.equal(img, tiles_to_image(color, 256, 192, 32)), "the request's frame is the checked one")
            if stop == 0.0:
                single = gs.render(model, cam_s, dataclasses.replace(scfg, slice_pairs=0))
                check(torch.equal(img, single[0]) and torch.equal(img_trans, single[1]),
                      "early stop off: the sliced frame equals the single-sort frame bitwise")
        runs = []
        for _ in range(2):  # under grad: the whole sliced render and its backward, twice
            r_img, r_trans = gs.render(model, cam_s, dataclasses.replace(scfg, reduce_pairs=1 << 15))
            loss = (r_img * tiles_to_image(g_color, 256, 192, 32)).sum() + (r_trans * tiles_to_image(g_trans, 256, 192, 32)).sum()
            runs.append((r_img.detach(), *torch.autograd.grad(loss, list(model.parameters()))))
        check(all(torch.equal(a, b) for a, b in zip(*runs)), f"two sliced runs bitwise equal (early stop {stop})")
        sliced_small[f"stop_{stop}"] = {"k_exec": len(rec.ids), "host_syncs": rec.host_syncs,
                                        "gb": [int(g) for g in rec.gb], **chain}
    check(sliced_small["stop_0.0"]["k_exec"] > 1 and sliced_small["stop_0.0001"]["k_exec"] > 1,
          "phase 7 runs several slices")
    emit({"phase": "sliced_small", **sliced_small})

    # -- phase 8: the real-density configuration, sliced and single-sort --
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.render.pipeline import preprocess

    real = {}
    model = build_scene(REAL_N, REAL_SHIFT, dev)
    with torch.inference_mode():
        demand = int(gs.binning_stats(model, gs.CameraArrays.from_params(cam0, device=dev), WIDTH, HEIGHT, probe)["pair_demand"])
    real_cap = max(int(demand * 1.1) // 128 * 128, CAPACITY_FLOOR)
    rcfg = gs.RasterConfig(tile_size=32, chunk_size=32, pair_block=128, max_pairs=real_cap, sh_degree=3,
                           early_stop_transmittance=1e-4, slice_pairs=REAL_SLICE, reduce_pairs=REAL_REDUCE)
    ss_cfg = dataclasses.replace(rcfg, slice_pairs=0, reduce_pairs=real_cap // 4)
    real.update({"num_gaussians": REAL_N, "scale_shift": REAL_SHIFT, "pair_demand": demand,
                 "pairs_per_gaussian": demand / REAL_N, "capacity": real_cap})
    with torch.inference_mode():
        gs.render(model, cam0, rcfg)  # warm-up
        torch.cuda.synchronize()
        requests, frames, fwd_carry_launches = [], [], 0
        for name, yaw in poses:
            camera = bench_camera(WIDTH, HEIGHT, yaw)
            _, _, _, rec = sliced_records(model, camera, rcfg)
            forward_tiles.launches = forward_tiles_carry.launches = backward_tiles_carry.launches = 0
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            host0 = time.perf_counter()
            start.record()
            img, trans = gs.render(model, camera, rcfg)
            end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - host0) * 1e3
            check((forward_tiles.launches, forward_tiles_carry.launches, backward_tiles_carry.launches)
                  == (0, len(rec.ids), 0), f"request {name}: k_exec carry launches and no other")
            fwd_carry_launches += forward_tiles_carry.launches
            check(img.shape == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(img).all() and torch.isfinite(trans).all()),
                  "finite frame")
            check(float(trans.min()) >= 0.0 and float(trans.max()) <= 1.0, "transmittance in [0, 1]")
            frames.append(img)
            requests.append({"pose": name, "ms": start.elapsed_time(end), "host_ms": host_ms, "k_exec": len(rec.ids),
                             "host_syncs_in_loop": rec.host_syncs, "gb": [int(g) for g in rec.gb]})
        # The bench pose: slices, blocks, and the first slice's kernels against their plain versions.
        feat, color, trans, rec = sliced_records(model, cam0, rcfg)
        bins = binning.bin_gaussians(preprocess(model, cam0, rcfg), WIDTH, HEIGHT, 32, real_cap, align=128)
        all_blocks = int((-(-bins.tile_count.long() // 128)).sum())
        composited = [int(b.sum()) for b in rec.bdone]
        real.update({"k_exec": len(rec.ids), "composited_blocks": composited,
                     "composited_share_of_single_sort_blocks": sum(composited) / all_blocks,
                     "single_sort_blocks": all_blocks,
                     "compact_overflow": sum(composited) > REAL_REDUCE // 128})
        single = gs.render(model, cam0, ss_cfg)
        diff = float((frames[0] - single[0]).abs().max())
        check(diff <= 1e-4, f"sliced frame within 1e-4 of the single-sort frame: {diff}")
        real["sliced_vs_single_sort_max_abs_diff"] = diff
        real.update(first_slice_kernels(feat, rec, color, trans, -(-WIDTH // 32), rcfg, WIDTH, HEIGHT, seed=5))
        real["sliced_request"] = {
            "stages": stage_breakdown(lambda: gs.render(model, cam0, rcfg)),
            "request_ms": cuda_ms(lambda: gs.render(model, cam0, rcfg), 5),
            "device_busy_ms": device_busy_ms(lambda: gs.render(model, cam0, rcfg)),
            "host_syncs": host_syncs(lambda: gs.render(model, cam0, rcfg))}
        real["single_sort_request"] = {
            "stages": stage_breakdown(lambda: gs.render(model, cam0, ss_cfg)),
            "request_ms": cuda_ms(lambda: gs.render(model, cam0, ss_cfg), 5),
            "device_busy_ms": device_busy_ms(lambda: gs.render(model, cam0, ss_cfg)),
            "host_syncs": host_syncs(lambda: gs.render(model, cam0, ss_cfg))}
        del feat, color, trans, rec, bins, single, frames
    real["requests"] = requests

    target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=dev)
    trainer = gs.Trainer(raster=rcfg, train=gs.TrainConfig(ssim_weight=0.2, steps=3, log_every=1), show_progress=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forward_tiles.launches = backward_tiles.launches = forward_tiles_carry.launches = backward_tiles_carry.launches = 0
    model, history = trainer.fit(model, [(bench_camera(WIDTH, HEIGHT, yaw), target) for _, yaw in poses])
    torch.cuda.synchronize()
    real_launches = {"raster_fwd": forward_tiles.launches, "raster_bwd": backward_tiles.launches,
                     "raster_fwd_carry": forward_tiles_carry.launches, "raster_bwd_carry": backward_tiles_carry.launches}
    check(len(history) == 3 and all(math.isfinite(h["loss"]) for h in history), f"finite losses: {history}")
    check(real_launches["raster_fwd"] == real_launches["raster_bwd"] == 0
          and real_launches["raster_fwd_carry"] == real_launches["raster_bwd_carry"] >= 3,
          f"each fit step walks back the slices it ran: {real_launches}")
    check(trainer.raster == rcfg, "no capacity resize at 1.1x demand")
    optimizer = trainer.init_state(model)
    trainer.train_step(model, optimizer, cam0, target)  # warm-up of a fresh optimizer
    with torch.inference_mode():
        k_step = len(sliced_records(model, cam0, rcfg)[3].ids)
    forward_tiles_carry.launches = backward_tiles_carry.launches = 0
    trainer.train_step(model, optimizer, cam0, target)
    torch.cuda.synchronize()
    check((forward_tiles_carry.launches, backward_tiles_carry.launches) == (k_step, k_step),
          f"a step launches k_exec ({k_step}) of each carry kernel: "
          f"{forward_tiles_carry.launches}, {backward_tiles_carry.launches}")
    real["sliced_step"] = {
        "k_exec": k_step, "losses": [h["loss"] for h in history], "fit_launches": real_launches,
        "step_ms": cuda_ms(lambda: trainer.train_step(model, optimizer, cam0, target), 5),
        "device_busy_ms": device_busy_ms(lambda: trainer.train_step(model, optimizer, cam0, target)),
        "host_syncs": host_syncs(lambda: trainer.train_step(model, optimizer, cam0, target)),
        "stages": stage_breakdown(lambda: trainer.train_step(model, optimizer, cam0, target)),
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    ss_trainer = gs.Trainer(raster=ss_cfg, train=trainer.train, show_progress=False)
    torch.cuda.reset_peak_memory_stats()
    ss_trainer.train_step(model, optimizer, cam0, target)  # warm-up
    real["single_sort_step"] = {
        "step_ms": cuda_ms(lambda: ss_trainer.train_step(model, optimizer, cam0, target), 5),
        "device_busy_ms": device_busy_ms(lambda: ss_trainer.train_step(model, optimizer, cam0, target)),
        "host_syncs": host_syncs(lambda: ss_trainer.train_step(model, optimizer, cam0, target)),
        "stages": stage_breakdown(lambda: ss_trainer.train_step(model, optimizer, cam0, target)),
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    real["elapsed_s"] = time.perf_counter() - t_main  # since main() began, the build included
    emit({"phase": "real_density", **real})
    del model, trainer, ss_trainer, optimizer, target
    torch.cuda.empty_cache()

    # -- phase 9: training from SfM points: densify, checkpoint, resume --
    dense, dense_launches, depth_launches = densify_phase(cfg, dev, t_main)
    emit({"phase": "densify", **dense})

    with tempfile.TemporaryDirectory() as cli_root:
        # -- phase 10: the command line --
        cli, cli_launches = cli_phase(dev, t_main, cli_root)
        emit({"phase": "cli", **cli})

        # -- phase 11: the mesh path --
        mesh, mesh_launches = mesh_phase(cfg, served_frames, dense["capacity"], dev, t_main, cli_root)
        emit({"phase": "mesh", **mesh})

    # -- phase 12: the kernels at other tilings --
    tilings, tilings_launches = tilings_phase(cfg, served_frames[0], dev, t_main)
    emit({"phase": "tilings", **tilings})

    # -- phase 13: the scaling harness --
    scaling, scaling_launches = scaling_phase(dev, t_main)
    emit({"phase": "scaling", **scaling})

    # -- phase 14: the benchmark script --
    bench, bench_launches = bench_phase(dev, t_main, capacity, head_demand, real["pair_demand"], real["k_exec"])
    emit({"phase": "bench", **bench})

    # -- phase 15: the TPU probes' counterparts --
    probes, probe_rows = probes_phase(dev, t_main)
    emit({"phase": "probes", **probes})

    # -- phase 16: the preprocess kernel --
    prep, prep_phase_launches = preprocess_phase(dev, t_main)
    emit({"phase": "preprocess", **prep})

    def at_tiles(kernel):
        """A kernel's times and bounds at each tiling of phase 12 (a)."""
        rows = {}
        for ts, rec in tilings["full"].items():
            part, key = (rec[kernel], "") if kernel in ("forward", "backward") else (rec["sliced"], f"{kernel}_")
            ms, bound = part[f"{key}ms"], part[f"{key}bound"]
            rows[ts] = {"ms": ms, "plain_ms": part[f"{key}plain_ms"], **bound_fields(bound, ms)}
        return rows

    print(smi, flush=True)
    emit({"kernels": [
        {
            "name": "raster_fwd", "route": "cuda", "tilings_launches": tilings_launches["raster_fwd"],
            "bench_launches": bench_launches["raster_fwd"],
            "tilings": at_tiles("forward"), "source": "gsplat_tpu_torch/csrc/raster_fwd.cu",
            "replaces": "gsplat_tpu/kernels/raster_fwd.py:68", "launches": launches,
            "densify_fit_launches": dense_launches["raster_fwd"], "render_depth_launches": depth_launches,
            "cli_launches": cli_launches["raster_fwd"], "mesh_launches": mesh_launches["raster_fwd"],
            "scaling_launches": scaling_launches["raster_fwd"],
            "max_abs_err": frame_err, "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
            **bound_fields(fwd_bound, kernel_ms),
        },
        {
            "name": "raster_bwd", "route": "cuda", "tilings_launches": tilings_launches["raster_bwd"],
            "bench_launches": bench_launches["raster_bwd"],
            "tilings": at_tiles("backward"), "source": "gsplat_tpu_torch/csrc/raster_bwd.cu",
            "replaces": "gsplat_tpu/kernels/raster_bwd.py:45", "launches": train_launches["raster_bwd"],
            "densify_fit_launches": dense_launches["raster_bwd"], "cli_launches": cli_launches["raster_bwd"],
            "mesh_launches": mesh_launches["raster_bwd"], "scaling_launches": scaling_launches["raster_bwd"],
            "max_abs_err": frame["rows"]["max_abs_err"], "ms": bwd_ms, "plain_ms": bwd_plain_ms, "library_ms": None,
            **bound_fields(bwd_bound, bwd_ms),
        },
        {
            "name": "raster_fwd_carry", "route": "cuda", "tilings_launches": tilings_launches["raster_fwd_carry"],
            "bench_launches": bench_launches["raster_fwd_carry"],
            "tilings": at_tiles("forward_carry"), "source": "gsplat_tpu_torch/csrc/raster_fwd.cu",
            "replaces": "gsplat_tpu/kernels/raster_fwd.py:266", "launches": fwd_carry_launches,
            "cli_launches": cli_launches["raster_fwd_carry"],
            "max_abs_err": real["first_slice_forward_max_abs_err"], "ms": real["forward_carry_ms"],
            "plain_ms": real["forward_carry_plain_ms"], "library_ms": None,
            **bound_fields(real["forward_carry_bound"], real["forward_carry_ms"]),
        },
        {
            "name": "raster_bwd_carry", "route": "cuda", "tilings_launches": tilings_launches["raster_bwd_carry"],
            "bench_launches": bench_launches["raster_bwd_carry"],
            "tilings": at_tiles("backward_carry"), "source": "gsplat_tpu_torch/csrc/raster_bwd.cu",
            "replaces": "gsplat_tpu/kernels/raster_bwd.py:339", "launches": real_launches["raster_bwd_carry"],
            "cli_launches": cli_launches["raster_bwd_carry"],
            "max_abs_err": real["first_slice_bwd"]["rows"]["max_abs_err"], "ms": real["backward_carry_ms"],
            "plain_ms": real["backward_carry_plain_ms"], "library_ms": None,
            **bound_fields(real["backward_carry_bound"], real["backward_carry_ms"]),
        },
        *probe_rows,
        {
            "name": "preprocess", "route": "cuda", "source": "gsplat_tpu_torch/csrc/preprocess.cu",
            "replaces": None, "launches": prep_launches, "preprocess_phase_launches": prep_phase_launches,
            **{name: {k: prep[name][k] for k in ("kernel_ms", "kernel_ms_quartiles", "kernel_profiler_ms",
                                                 "kernel_profiler_launches", "bound_ms",
                                                 "share_of_bound", "eager_ms", "eager_profiler_ms",
                                                 "request_preprocess_ops", "eager_preprocess_ops")}
               for name in ("headline_1m", "dense_5m")},
            "recipe_5m_pool": {k: prep["recipe_5m_pool"][k] for k in ("num_gaussians", "kernel_ms", "bound_ms")},
            "library_ms": None,
        },
        {
            "name": "preprocess_bwd", "route": "cuda", "source": "gsplat_tpu_torch/csrc/preprocess.cu",
            "replaces": None, "launches": train_launches["preprocess_bwd"],
            "preprocess_phase_launches": prep["backward_launches"], "step_launches": prep["dense_5m"]["step_launches"],
            **{name: {k: rec["backward"][k] for k in ("num_gaussians", "err_ratio", "kernel_ms", "kernel_ms_quartiles",
                                                      "kernel_profiler_ms", "kernel_profiler_launches", "bound_ms",
                                                      "share_of_bound", "eager_ms", "eager_profiler_ms")}
               for name, rec in (("headline_1m", prep["headline_1m"]), ("dense_5m", prep["dense_5m"]),
                                 ("recipe_5m_pool", prep["recipe_5m_pool"]))},
            "library_ms": None,
        },
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
