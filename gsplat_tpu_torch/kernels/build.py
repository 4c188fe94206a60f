"""Build and load the port's CUDA kernels.

Each kernel source under ``gsplat_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``. Libraries are built at first use into
``build/kernels/`` at the repository root (git-ignored) and cached by a
hash of the source, every header under ``csrc/`` and the flags, so an
edited source or header rebuilds and an unchanged one loads at once.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# Kernel name -> source file under csrc/.
SOURCES = {
    "raster_fwd": "raster_fwd.cu", "raster_bwd": "raster_bwd.cu", "preprocess": "preprocess.cu",
    "loss": "loss.cu",
    # The TPU probes' counterparts (kernels/probes.py).
    "probe_transpose": "probe_transpose.cu", "probe_lane_dma": "probe_lane_dma.cu",
    "probe_orientation": "probe_orientation.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libraries: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives, keyed by the hash of its
    source and of every header under ``csrc/`` (a source may include any)."""
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns each built kernel's compile
    seconds; the compiler's output (``-Xptxas=-v`` register and shared
    memory report) is kept beside the library as ``.log``."""
    pending = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not pending:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    started = time.perf_counter()
    procs = {}
    for name, out in pending.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    seconds = {}
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - started
        out = pending[name]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler output of the current build of kernel ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel ``name``, building its library
    first if needed. The function returns a ``cudaError_t`` as ``int``."""
    lib = _libraries.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libraries[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
