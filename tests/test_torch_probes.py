"""The TPU probes' counterparts in the port against the TPU probes' kernels,
on the CPU.

Every Pallas body of ``scripts/probe_transpose.py``,
``scripts/probe_lane_dma.py`` and ``scripts/orientation_test.py`` runs here
through ``pl.pallas_call(..., interpret=True)`` with the script's own specs
and inputs; the scripts are imported unedited, by path and under names of
their own (the tools that replace them have the same file names). Each is
compared with the plain version of its counterpart in
``gsplat_tpu_torch/kernels/probes.py``, which is what the wrappers run on a
CPU tensor:

* the transposes, the slab copy and the lane copy bitwise, the transposes
  at every 32-bit pattern tested too; the tensor-core transpose in 3xTF32
  bitwise the MXU's ``Precision.HIGHEST`` product (``x.T`` for finite
  normal ``x``), and in one-pass TF32 bitwise ``x`` rounded to TF32 by
  numpy (round to nearest, ties away from zero, in float64); at inf, NaN,
  signed zeros, subnormals and the extremes of the normals
  (``tools/probe_transpose.py::special_blocks``) both modes follow the
  product's rules (:func:`_product_rules`), NaN positions compared by
  ``isnan`` and every other element by its bits;
* the orientation kernels, with ``REPS_A`` / ``REPS_B`` patched down to a
  few chunks, at the script's own inputs and ``t0 = 0`` (the TPU kernels'
  function): exactly the TPU kernels' output, which is zero;
* the orientation plain versions at ``t0 = 1`` on the tools' passing and
  sparse sets against ``gsplat_tpu/ops/compositing.py::render_oracle`` (the
  pairs in order as depth, a 32x32 frame) at rtol 1e-5 / atol 1e-6: the oracle
  composites pair by pair, A's plain version takes the running products
  and sums in another association, and B's multiplies the transmittance
  through a scan across each sub-chunk, so they round differently.

The three tools run on the CPU at toy sizes, refuse to run without a card
unless ``--device cpu`` is given, and import neither JAX nor the JAX
package. The kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""

import ast
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gsplat_tpu.ops.compositing import render_oracle
from gsplat_tpu.ops.projection import Preprocessed
from gsplat_tpu_torch.kernels import probes as P
from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
TOOLS = ("probe_transpose", "probe_lane_dma", "orientation_test")
RTOL, ATOL = 1e-5, 1e-6


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    """The TPU probe scripts. ``orientation_test.py`` imports ``timing`` from
    ``scripts/`` and puts that directory on ``sys.path``; the path is put
    back as it was once they are loaded (``timing`` stays in
    ``sys.modules``), so that ``scripts/`` shadows no tool of the same name
    in a later import."""
    saved = list(sys.path)
    sys.path.insert(0, SCRIPTS)
    try:
        return {name: _load(os.path.join(SCRIPTS, f"{name}.py"), f"tpu_{name}") for name in TOOLS}
    finally:
        sys.path[:] = saved


@pytest.fixture(scope="module")
def tools():
    return {name: _load(os.path.join(ROOT, "tools", f"{name}.py"), f"port_{name}") for name in TOOLS}


def _randn(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_transpose(scripts, which: str, x: np.ndarray) -> np.ndarray:
    """One transpose kernel of ``scripts/probe_transpose.py`` in interpret
    mode, with the script's specs."""
    pt = scripts["probe_transpose"]
    if which == "dma":
        nblk = x.shape[0]
        return np.asarray(pl.pallas_call(
            pt.dma_kernel,
            out_shape=jax.ShapeDtypeStruct((nblk, 128, 16), jnp.float32),
            grid=(nblk,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((1, 128, 16), lambda b: (b, 0, 0), memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((16, 128), jnp.float32), pltpu.SemaphoreType.DMA],
            interpret=True,
        )(x))
    kernel = {"t1": pt.t1_kernel, "t2": pt.t2_kernel, "mxu": pt.mxu_t_kernel}[which]
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape[::-1], jnp.float32), interpret=True)(x))


@pytest.mark.parametrize("which, x", [
    ("t1", _randn(0, (16, 128))),
    ("t2", _randn(1, (128, 16))),
    ("dma", _randn(2, (4, 16, 128))),
])
def test_transposes_match_jax(scripts, which, x):
    """``t1_kernel``, ``t2_kernel`` and ``dma_kernel`` (the script's inputs)
    bitwise ``transpose_smem`` / ``transpose_block_async`` on the CPU."""
    want = _jax_transpose(scripts, which, x)
    t = torch.from_numpy(x)
    got = (P.transpose_block_async(t) if which == "dma" else P.transpose_smem(t)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(want, np.swapaxes(x, -1, -2))


def _tf32_numpy(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to 11 significant bits, nearest with ties away from
    zero, in float64 (independent of the port's bit arithmetic)."""
    x64 = x.astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x64))) - 10)
    with np.errstate(over="ignore"):  # past TF32's largest value: inf
        return (np.sign(x64) * np.floor(np.abs(x64) / ulp + 0.5) * ulp).astype(np.float32)


@pytest.mark.parametrize("split3", [False, True], ids=["tf32", "3xtf32"])
def test_mma_transpose_matches_jax(scripts, tools, split3):
    """``mxu_t_kernel`` (``eye(128) . x^T`` at ``Precision.HIGHEST``) is
    ``x.T``; ``transpose_mma``'s plain version gives it bitwise in 3xTF32,
    and in one pass ``x`` rounded to TF32 (checked against numpy on the
    probe's input and on exact ties), within 2^-11 relative of it."""
    x = _randn(0, (16, 128))
    want = _jax_transpose(scripts, "mxu", x)
    assert np.array_equal(want, x.T)
    got = P.transpose_mma(torch.from_numpy(x), split3).numpy()
    if split3:
        assert np.array_equal(got, want)
        return
    ties = tools["probe_transpose"].tf32_ties(np.random.default_rng(0), (16, 128))
    for block in (x, ties):
        assert np.array_equal(P.transpose_mma(torch.from_numpy(block), False).numpy(), _tf32_numpy(block).T)
    assert not np.array_equal(got, want)
    assert np.max(np.abs(got - want) / np.abs(want)) <= 2.0**-11


def _flushed(x: np.ndarray) -> np.ndarray:
    """``x`` with zeros and subnormals as +0 (XLA's CPU dot reads a
    subnormal as zero)."""
    return np.where(np.abs(x) < np.finfo(np.float32).tiny, np.float32(0), x).astype(np.float32)


def _product_rules(v: np.ndarray) -> np.ndarray:
    """``eye(128) . v^T`` for ``v [16, 128]`` by the rules of an f32 product
    with one nonzero term an element and a +0 accumulator: ``out[i, n]`` is
    NaN where ``v[n, i]`` is NaN or another element of ``v[n]`` is inf or
    NaN (``0 * inf``), else ``v[n, i] + 0`` (inf stays, ``-0.0`` becomes
    +0)."""
    bad = ~np.isfinite(v)
    with np.errstate(invalid="ignore"):
        out = v.T.astype(np.float32) + np.float32(0)
    out[np.isnan(v).T | (bad.sum(1)[None, :] - bad.T > 0)] = np.nan
    return out


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """NaN at the same positions, every other element bitwise equal."""
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    return np.array_equal(nan_a, nan_b) and np.array_equal(a.view(np.int32)[~nan_a], b.view(np.int32)[~nan_b])


SPECIAL = ("inf", "nan", "signed_zero", "subnormal", "tiny_normal", "huge", "ties", "bits")


def _special(tools, name: str) -> np.ndarray:
    pt = tools["probe_transpose"]
    return pt.random_bits() if name == "bits" else pt.special_blocks()[name]


@pytest.mark.parametrize("name", SPECIAL)
def test_mma_transpose_special_inputs_match_jax(scripts, tools, name):
    """At inf, -inf, NaN (payloads too), -0.0, subnormals of both signs, the
    smallest and largest normals, TF32 ties and random 32-bit patterns,
    ``mxu_t_kernel`` in interpret mode follows the product's rules on ``x``
    with its subnormals flushed (a column of the output holding inf of
    ``x`` is NaN but for that inf, one holding NaN is all NaN, ``-0.0`` and
    subnormals give +0), and ``transpose_mma``'s plain version in 3xTF32
    gives it bitwise (NaN positions equal); in one-pass TF32 it follows
    the same rules on ``x`` rounded to TF32 by numpy (where the rounding
    passes TF32's largest value it gives inf, and the column NaN)."""
    x = _special(tools, name)
    want = _jax_transpose(scripts, "mxu", x)
    v = _flushed(x)
    assert _same(want, _product_rules(v))
    assert _same(P.transpose_mma(torch.from_numpy(x), True).numpy(), want)
    normal = np.isfinite(v) & (v != 0)
    rounded = np.where(normal, _tf32_numpy(np.where(normal, v, np.float32(1))), v)
    assert _same(P.transpose_mma(torch.from_numpy(x), False).numpy(), _product_rules(rounded))


@pytest.mark.parametrize("which", ["t1", "t2"])
def test_transposes_match_jax_at_every_bit_pattern(scripts, tools, which):
    """``t1_kernel`` / ``t2_kernel`` in interpret mode and ``transpose_smem``
    on the CPU move every 32-bit pattern unchanged: random patterns (NaN
    payloads, infs, subnormals, signed zeros among them) and every special
    block, compared by their bits."""
    for name in SPECIAL:
        x = _special(tools, name)
        x = x if which == "t1" else np.ascontiguousarray(x.T)
        want = _jax_transpose(scripts, which, x)
        got = P.transpose_smem(torch.from_numpy(x)).numpy()
        assert np.array_equal(want.view(np.int32), np.ascontiguousarray(x.T).view(np.int32)), name
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), name


def test_tf32_split_is_exact():
    """hi + mid + lo gives x back, times ``unscale`` (2^-64 below 2^-63,
    else 1), each part with its 13 low bits clear and none subnormal, over
    magnitudes 2^-126-2^127."""
    rng = np.random.default_rng(1)
    x = (rng.uniform(1, 2, 8192) * 2.0 ** rng.integers(-126, 128, 8192)).astype(np.float32)
    x = torch.from_numpy(x * np.where(rng.random(8192) < 0.5, -1, 1).astype(np.float32))
    hi, mid, lo, unscale = P.tf32_split(x)
    for part in (hi, mid, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
        assert not bool(((part != 0) & (part.abs() < torch.finfo(torch.float32).tiny)).any())
    assert torch.equal(unscale, torch.where(x.abs() < 2.0**-63, 2.0**-64, 1.0))
    assert torch.equal(((hi + mid) + lo) * unscale, x)


def test_tf32_split_of_special_values():
    """Zeros of both signs and subnormals split into three +0 parts; inf,
    -inf and NaN pass whole into ``hi`` with +0 ``mid`` and ``lo``; f32's
    largest values split without overflow; ``unscale`` is 1 for all of
    them. One-pass TF32 (``tf32_stage``) keeps inf and NaN, gives +0 for
    zeros and subnormals, and rounds a finite value past TF32's largest to
    inf."""
    x = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-39, -1.1754942e-38, np.inf, -np.inf, np.nan], dtype=torch.float32)
    hi, mid, lo, unscale = P.tf32_split(x)
    assert torch.equal(hi[:6].view(torch.int32), torch.zeros(6, dtype=torch.int32))
    assert torch.equal(hi[6:8], x[6:8]) and bool(torch.isnan(hi[8]))
    for part in (mid, lo):
        assert torch.equal(part.view(torch.int32), torch.zeros(9, dtype=torch.int32))
    assert torch.equal(unscale, torch.ones(9))
    big = torch.from_numpy(np.array([0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FF000], np.uint32).view(np.float32))
    hi, mid, lo, unscale = P.tf32_split(big)
    assert torch.equal((hi + mid) + lo, big) and bool(torch.isfinite(hi).all())
    staged = P.tf32_stage(torch.cat([x, big]))
    assert torch.equal(staged[:6].view(torch.int32), torch.zeros(6, dtype=torch.int32))
    assert torch.equal(staged[6:8], x[6:8]) and bool(torch.isnan(staged[8]))
    assert torch.equal(staged[9:], torch.tensor([np.inf, -np.inf, np.inf]))


def test_lane_dma_matches_jax(scripts):
    """``scripts/probe_lane_dma.py::kernel`` (its input and starts) bitwise
    ``lane_dma`` on the CPU, and both ``2 * x``."""
    pld = scripts["probe_lane_dma"]
    x = _randn(0, (16, 512))
    starts = [256, 0, 384, 128]
    want = np.asarray(pl.pallas_call(
        pld.kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(4,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)], out_specs=pl.BlockSpec(memory_space=pl.ANY),
            scratch_shapes=[pltpu.VMEM((16, 128), jnp.float32), pltpu.SemaphoreType.DMA, pltpu.SemaphoreType.DMA],
        ),
        out_shape=jax.ShapeDtypeStruct((16, 512), jnp.float32),
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True,
    )(jnp.asarray(starts, jnp.int32), x))
    got = P.lane_dma(torch.from_numpy(x), starts).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, x * 2)


@pytest.mark.parametrize("call", [
    lambda: P.transpose_smem(torch.zeros((16, 64))),
    lambda: P.transpose_smem(torch.zeros((16, 128), dtype=torch.float64)),
    lambda: P.transpose_smem(torch.zeros((128, 16)).t()),
    lambda: P.transpose_block_async(torch.zeros((16, 128))),
    lambda: P.transpose_mma(torch.zeros((128, 16)), True),
    lambda: P.lane_dma(torch.zeros((16, 512)), [64]),
    lambda: P.lane_dma(torch.zeros((16, 512)), [512]),
    lambda: P.lane_dma(torch.zeros((16, 512)), []),
    lambda: P.lane_dma(torch.zeros((16, 500)), [0]),
    lambda: P.orientation_a(torch.zeros((16, 128)), 1, 1.0),
    lambda: P.orientation_b(torch.zeros((16, 128)), -1, 1.0),
])
def test_wrappers_reject_bad_inputs(call):
    """Each wrapper checks its arguments alike on both devices."""
    with pytest.raises(ValueError):
        call()


def _jax_orientation(scripts, orientation: str) -> tuple:
    """The script's ``kernel_a`` / ``kernel_b`` in interpret mode on its own
    inputs (``run``'s specs and draws); returns (feat, output)."""
    ot = scripts["orientation_test"]
    if orientation == "a":
        kernel, feat_shape, out_shape, scratch = ot.kernel_a, (32, 128), (8, ot.NPIX), (8, ot.NPIX)
    else:
        kernel, feat_shape, out_shape, scratch = ot.kernel_b, (16, 128), (ot.NPIX, 8), (ot.NPIX, 128)
    f = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM(scratch, jnp.float32)],
        interpret=True,
    )
    rng = np.random.default_rng(0)
    feat = rng.uniform(0, 1, feat_shape).astype(np.float32)
    g = rng.uniform(0, 1, (8, ot.NPIX)).astype(np.float32)
    return feat, np.asarray(f(feat, g))


@pytest.mark.parametrize("orientation, reps", [("a", 4), ("b", 2)])
def test_orientation_matches_jax(scripts, tools, monkeypatch, orientation, reps):
    """``kernel_a`` / ``kernel_b`` at ``reps`` chunks on the script's inputs
    equal the port's plain versions at ``t0 = 0`` exactly (both zero: the
    TPU kernels' transmittance starts at 0, and no bbox of the uniform draws
    holds an integer pixel); the tools draw the same block."""
    monkeypatch.setattr(scripts["orientation_test"], "REPS_A" if orientation == "a" else "REPS_B", reps)
    feat, want = _jax_orientation(scripts, orientation)
    assert np.array_equal(tools["orientation_test"].jax_features(orientation), feat)
    wrapper = P.orientation_a if orientation == "a" else P.orientation_b
    got = wrapper(torch.from_numpy(feat), reps, 0.0).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    assert not want.any()
    assert P.orientation_passed(torch.from_numpy(feat), reps, orientation) == 0


@pytest.mark.parametrize("orientation, reps, features", [
    ("a", 3, "passing"), ("b", 1, "passing"), ("a", 3, "sparse"), ("b", 2, "sparse"),
])
def test_orientation_matches_oracle(tools, orientation, reps, features):
    """At ``t0 = 1`` on the passing and sparse sets, the plain versions'
    colour and T agree with ``render_oracle`` over the same pairs in order
    (chunk c's rows scaled by ``1 + 1e-6 c`` in f32) on the 32x32 tile, at
    rtol 1e-5 / atol 1e-6 (other association of the products and sums, see
    the module docstring). The passing set composites to near T = 0; in the
    sparse set each pixel passes one pair a chunk, also at the last chunk
    of the full walk, the one whose scale moves the bboxes most."""
    ot = tools["orientation_test"]
    block = ot.features_block(orientation, features)
    rows = block[:, :16] if orientation == "a" else block.T
    scales = [np.float32(1.0) + np.float32(1e-6) * np.float32(c) for c in range(reps)]
    pairs = np.concatenate([rows * s for s in scales]).astype(np.float32)  # [reps * n, 16], in order
    n = len(pairs)
    prep = Preprocessed(
        screen_means=jnp.asarray(pairs[:, 0:2]), conics=jnp.asarray(pairs[:, 2:5]), rgb=jnp.asarray(pairs[:, 6:9]),
        opacity=jnp.asarray(pairs[:, 5]), depth=jnp.arange(n, dtype=jnp.float32), bbox=jnp.asarray(pairs[:, 9:13]),
        cull_bbox=jnp.asarray(pairs[:, 9:13]), active=jnp.ones(n, bool),
    )
    image, trans = (np.asarray(a) for a in render_oracle(prep, P.EDGE, P.EDGE))
    wrapper = P.orientation_a if orientation == "a" else P.orientation_b
    out = wrapper(torch.from_numpy(block), reps, 1.0).numpy()
    out = out if orientation == "a" else out.T  # [8, 1024]: colour, T, zeros
    np.testing.assert_allclose(out[:3], image.reshape(-1, 3).T, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[3], trans.reshape(-1), rtol=RTOL, atol=ATOL)
    assert not out[4:].any()
    passed = P.orientation_passed(torch.from_numpy(block), reps, orientation)
    if features == "passing":
        assert trans.min() < 1e-3 and image.max() > 0.1  # the set composites
        assert 0.3 < passed / (n * P.NPIX) < 0.6
        return
    assert passed == reps * P.NPIX and trans.min() > 0.9
    last = (ot.REPS_A if orientation == "a" else ot.REPS_B) - 1
    rows = P._chunk_rows(torch.from_numpy(block), last, 1, orientation).reshape(-1, 1, 16)
    px, py = P._pixels(rows.device)
    assert torch.equal((P.gated_alpha(rows, px, py) > 0).sum(0), torch.ones(P.NPIX, dtype=torch.int64))


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_main_on_cpu(tools, capsys, monkeypatch, tool):
    """Each tool at ``--device cpu`` prints one JSON line a probe, every
    check holding and no time (not measured off the card); the orientation
    tool with ``REPS_A`` / ``REPS_B`` cut to 2 / 1 chunks."""
    monkeypatch.setattr(tools["orientation_test"], "REPS_A", 2)
    monkeypatch.setattr(tools["orientation_test"], "REPS_B", 1)
    assert tools[tool].main(["--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(lines) == {"probe_transpose": 5, "probe_lane_dma": 1, "orientation_test": 6}[tool]
    for rec in lines:
        assert rec["ok"] and rec["device"] == "cpu" and rec["ms"] is None and rec["nvidia_smi"] is None, rec
        assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes", "operations")


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_refuse_without_card(tools, tool):
    """The tools run on the card by default and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tools[tool].main([])


@pytest.mark.parametrize("path", [os.path.join("tools", f"{t}.py") for t in (*TOOLS, "sass_loops")]
                         + [os.path.join("gsplat_tpu_torch", "kernels", "probes.py")])
def test_probes_import_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names]
    names += [node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module]
    assert "torch" in names or path.endswith("sass_loops.py"), path  # it reads compiled code only
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "gsplat_tpu", "bench"), (path, name)


_SASS = """
\t\tFunction : _Z6kernelPf
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
        /*0010*/                   MOV R2, RZ ;                      /* 0x000000ff00027202 */
        /*0020*/                   FADD R3, R3, 1 ;                  /* 0x3f80000003037421 */
        /*0030*/              @!P0 BRA 0x60 ;                        /* 0x0000000000008947 */
        /*0040*/                   FMUL R3, R3, R3 ;                 /* 0x0000000303037220 */
        /*0050*/                   FMUL R3, R3, 2 ;                  /* 0x4000000003037820 */
        /*0060*/                   IADD3 R2, R2, 0x1, RZ ;           /* 0x0000000102027810 */
        /*0070*/                   ISETP.NE.AND P1, PT, R2, 0x8, PT ; /* 0x0000000802007c0c */
        /*0080*/               @P1 BRA 0x20 ;                        /* 0x0000000000001947 */
        /*0090*/                   EXIT ;                            /* 0x000000000000794d */
"""


def test_sass_loops_counts_a_loop():
    """``tools/sass_loops.py`` reads a ``cuobjdump -sass`` listing: one loop
    (0x20 to the branch back at 0x80) of 7 instructions, 2 of them
    skippable by the forward branch."""
    sass_loops = _load(os.path.join(ROOT, "tools", "sass_loops.py"), "port_sass_loops")
    funcs = sass_loops.functions(_SASS)
    assert list(funcs) == ["_Z6kernelPf"] and len(funcs["_Z6kernelPf"]) == 10
    (loop,) = sass_loops.loops(funcs["_Z6kernelPf"])
    assert (loop["head"], loop["branch"], loop["instructions"], loop["skippable"]) == ("0x20", "0x80", 7, 2)
    assert loop["opcodes"] == {"FMUL": 2, "BRA": 2, "FADD": 1, "IADD3": 1, "ISETP": 1}
