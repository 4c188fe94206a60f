"""Self-contained PLY reader/writer for Inria gaussian-splat checkpoints.

The reference depends on the third-party ``plyfile`` package
(rasterize.py:14, :353); this module implements the subset of the format the
Inria checkpoints use (binary_little_endian / ascii, a single ``vertex``
element of scalar properties) with numpy structured arrays — no external
dependency, and ~10x less parsing overhead than plyfile's property-by-
property extraction.

Field semantics on load (must match the reference bit-for-bit, SURVEY.md C6):
  * x, y, z                -> means (rasterize.py:354-356)
  * scale_0..2             -> log-scales (exp'd at use, rasterize.py:97-99)
  * rot_0..3               -> quaternions (normalized at use, rasterize.py:112)
  * opacity                -> logit (sigmoid'd at use, rasterize.py:358)
  * f_dc_0..2, f_rest_0..44 -> SH coeffs laid out [N, 16, 3] band-major
                              (utils.py:21-31)
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

SH_REST = 45  # 15 coefficients x 3 channels for degree-3 SH


def _parse_header(f) -> Tuple[str, List[Tuple[str, int, np.dtype]]]:
    """Parse a PLY header. Returns (format, [(element_name, count, dtype)])."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii").strip().split()
        if not tokens:
            continue
        if tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                raise ValueError("list properties are not supported")
            elements[-1][2].append((tokens[2], tokens[1]))
        elif tokens[0] == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing format line")
    endian = "<" if fmt != "binary_big_endian" else ">"
    out = []
    for name, count, props in elements:
        dtype = np.dtype([(p, endian + _PLY_DTYPES[t]) for p, t in props])
        out.append((name, count, dtype))
    return fmt, out


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file into ``{property_name: 1-D array}`` for the first
    (vertex) element."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        name, count, dtype = elements[0]
        if fmt == "ascii":
            rows = []
            for _ in range(count):
                rows.append(tuple(float(v) for v in f.readline().split()))
            data = np.array(rows, dtype=dtype)
        else:
            data = np.fromfile(f, dtype=dtype, count=count)
    if data.shape[0] != count:
        raise ValueError(f"expected {count} rows, got {data.shape[0]}")
    return {field: np.ascontiguousarray(data[field]) for field in dtype.names}


def load_splat_arrays(path: str) -> Dict[str, np.ndarray]:
    """Load an Inria checkpoint into the raw-parameter arrays used by
    :class:`gsplat_tpu_torch.models.gaussians.GaussianModel`."""
    props = read_ply(path)
    n = props["x"].shape[0]
    means = np.stack([props["x"], props["y"], props["z"]], axis=-1)
    log_scales = np.stack([props[f"scale_{i}"] for i in range(3)], axis=-1)
    quats = np.stack([props[f"rot_{i}"] for i in range(4)], axis=-1)
    opacity_logits = props["opacity"]
    # SH layout: f_dc_c is band 0 of channel c; f_rest_{c*15 + j} is band j+1
    # of channel c (utils.py:21-31) -> [N, 16, 3].
    sh = np.zeros((n, 16, 3), dtype=np.float32)
    for c in range(3):
        sh[:, 0, c] = props[f"f_dc_{c}"]
        for j in range(15):
            sh[:, j + 1, c] = props[f"f_rest_{c * 15 + j}"]
    return {
        "means": means.astype(np.float32),
        "log_scales": log_scales.astype(np.float32),
        "quats": quats.astype(np.float32),
        "opacity_logits": opacity_logits.astype(np.float32),
        "sh": sh,
    }


def save_splat_arrays(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write raw-parameter arrays back to an Inria-layout PLY checkpoint
    (inverse of :func:`load_splat_arrays`; the reference never writes
    checkpoints — this covers the fine-tune workload's save path)."""
    means = np.asarray(arrays["means"], np.float32)
    log_scales = np.asarray(arrays["log_scales"], np.float32)
    quats = np.asarray(arrays["quats"], np.float32)
    opacity = np.asarray(arrays["opacity_logits"], np.float32)
    sh = np.asarray(arrays["sh"], np.float32)
    n = means.shape[0]

    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{c}" for c in range(3)]
    names += [f"f_rest_{j}" for j in range(SH_REST)]
    names += ["opacity"] + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)]
    dtype = np.dtype([(name, "<f4") for name in names])
    rec = np.zeros(n, dtype=dtype)
    rec["x"], rec["y"], rec["z"] = means[:, 0], means[:, 1], means[:, 2]
    for c in range(3):
        rec[f"f_dc_{c}"] = sh[:, 0, c]
        for j in range(15):
            rec[f"f_rest_{c * 15 + j}"] = sh[:, j + 1, c]
    rec["opacity"] = opacity
    for i in range(3):
        rec[f"scale_{i}"] = log_scales[:, i]
    for i in range(4):
        rec[f"rot_{i}"] = quats[:, i]

    header = io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {n}\n".encode())
    for name in names:
        header.write(f"property float {name}\n".encode())
    header.write(b"end_header\n")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.getvalue())
        rec.tofile(f)
