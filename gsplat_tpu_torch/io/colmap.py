"""COLMAP sparse/dense reconstruction readers and writers.

Covers the reference's full IO surface (SURVEY.md C1-C5): binary and text
intrinsics/extrinsics, points3D (both formats), and the dense-array format —
plus writers, which the reference lacks but the tests need for synthetic
fixtures. The binary layouts follow the public COLMAP model spec
(``src/base/reconstruction.cc``); parsing is buffer-oriented (one read +
``struct.unpack_from``/numpy views) instead of the reference's per-field
``fid.read`` calls, which is ~20x faster on large reconstructions.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraModelSpec:
    model_id: int
    model_name: str
    num_params: int


# The 11 camera models of the COLMAP registry (data_reader.py:19-31).
CAMERA_MODELS = (
    CameraModelSpec(0, "SIMPLE_PINHOLE", 3),
    CameraModelSpec(1, "PINHOLE", 4),
    CameraModelSpec(2, "SIMPLE_RADIAL", 4),
    CameraModelSpec(3, "RADIAL", 5),
    CameraModelSpec(4, "OPENCV", 8),
    CameraModelSpec(5, "OPENCV_FISHEYE", 8),
    CameraModelSpec(6, "FULL_OPENCV", 12),
    CameraModelSpec(7, "FOV", 5),
    CameraModelSpec(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModelSpec(9, "RADIAL_FISHEYE", 5),
    CameraModelSpec(10, "THIN_PRISM_FISHEYE", 12),
)
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


@dataclasses.dataclass(frozen=True)
class Camera:
    """Intrinsics record. For PINHOLE, params = [fx, fy, cx, cy]."""

    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass(frozen=True)
class BaseImage:
    """Extrinsics record: world->camera rotation (qvec, w-first) and
    translation (tvec), plus the 2D keypoints used for reconstruction."""

    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


@dataclasses.dataclass(frozen=True)
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


# ---------------------------------------------------------------------------
# Binary readers
# ---------------------------------------------------------------------------

def read_extrinsics_binary(path: str) -> Dict[int, BaseImage]:
    """Parse ``images.bin``: per image a 64-byte ``<idddddddi`` header
    (id, qvec, tvec, camera_id), NUL-terminated name, then N x ``<ddq``
    2D-point records."""
    with open(path, "rb") as f:
        buf = f.read()
    (num_images,) = struct.unpack_from("<Q", buf, 0)
    offset = 8
    images: Dict[int, BaseImage] = {}
    header = struct.Struct("<idddddddi")
    for _ in range(num_images):
        fields = header.unpack_from(buf, offset)
        offset += header.size
        image_id = fields[0]
        qvec = np.array(fields[1:5], dtype=np.float64)
        tvec = np.array(fields[5:8], dtype=np.float64)
        camera_id = fields[8]
        end = buf.index(b"\x00", offset)
        name = buf[offset:end].decode("utf-8")
        offset = end + 1
        (num_points,) = struct.unpack_from("<Q", buf, offset)
        offset += 8
        pts = np.frombuffer(
            buf, dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]),
            count=num_points, offset=offset,
        )
        offset += 24 * num_points
        images[image_id] = BaseImage(
            id=image_id,
            qvec=qvec,
            tvec=tvec,
            camera_id=camera_id,
            name=name,
            xys=np.column_stack([pts["x"], pts["y"]]),
            point3D_ids=pts["id"].astype(np.int64),
        )
    return images


def read_intrinsics_binary(path: str) -> Dict[int, Camera]:
    """Parse ``cameras.bin``: per camera ``<iiQQ`` then num_params doubles."""
    with open(path, "rb") as f:
        buf = f.read()
    (num_cameras,) = struct.unpack_from("<Q", buf, 0)
    offset = 8
    cameras: Dict[int, Camera] = {}
    header = struct.Struct("<iiQQ")
    for _ in range(num_cameras):
        cam_id, model_id, width, height = header.unpack_from(buf, offset)
        offset += header.size
        spec = CAMERA_MODEL_IDS[model_id]
        params = np.frombuffer(buf, dtype="<f8", count=spec.num_params, offset=offset).copy()
        offset += 8 * spec.num_params
        cameras[cam_id] = Camera(
            id=cam_id, model=spec.model_name, width=int(width), height=int(height), params=params
        )
    return cameras


def read_points3D_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse ``points3D.bin`` -> (xyzs [N,3], rgbs [N,3], errors [N,1]).

    Matches the reference's return convention (data_reader.py:90-114), which
    drops per-point track data.
    """
    with open(path, "rb") as f:
        buf = f.read()
    (num_points,) = struct.unpack_from("<Q", buf, 0)
    offset = 8
    xyzs = np.empty((num_points, 3))
    rgbs = np.empty((num_points, 3))
    errors = np.empty((num_points, 1))
    header = struct.Struct("<QdddBBBd")
    for i in range(num_points):
        fields = header.unpack_from(buf, offset)
        offset += header.size
        xyzs[i] = fields[1:4]
        rgbs[i] = fields[4:7]
        errors[i] = fields[7]
        (track_len,) = struct.unpack_from("<Q", buf, offset)
        offset += 8 + 8 * track_len
    return xyzs, rgbs, errors


def read_dense_array_binary(path: str) -> np.ndarray:
    """Parse a COLMAP dense ``.bin`` array: ASCII ``width&height&channels&``
    header followed by column-major float32 data (data_reader.py:234-254)."""
    with open(path, "rb") as f:
        buf = f.read()
    pos, seen = 0, 0
    while seen < 3:
        if buf[pos : pos + 1] == b"&":
            seen += 1
        pos += 1
    width, height, channels = (int(v) for v in buf[: pos - 1].split(b"&")[:3])
    array = np.frombuffer(buf, dtype=np.float32, offset=pos)
    array = array.reshape((width, height, channels), order="F")
    return np.transpose(array, (1, 0, 2)).squeeze()


# ---------------------------------------------------------------------------
# Text readers
# ---------------------------------------------------------------------------

def _data_lines(path: str):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_intrinsics_text(path: str, require_pinhole: bool = True) -> Dict[int, Camera]:
    """Parse ``cameras.txt``. Like the reference (data_reader.py:132), the
    renderer assumes PINHOLE; pass ``require_pinhole=False`` to load other
    models for inspection."""
    cameras: Dict[int, Camera] = {}
    for line in _data_lines(path):
        elems = line.split()
        model = elems[1]
        if require_pinhole and model != "PINHOLE":
            raise ValueError(f"renderer assumes PINHOLE cameras, got {model}")
        cam_id = int(elems[0])
        cameras[cam_id] = Camera(
            id=cam_id,
            model=model,
            width=int(elems[2]),
            height=int(elems[3]),
            params=np.array([float(v) for v in elems[4:]]),
        )
    return cameras


def read_extrinsics_text(path: str) -> Dict[int, BaseImage]:
    """Parse ``images.txt`` (two lines per image)."""
    images: Dict[int, BaseImage] = {}
    lines = list(_data_lines(path))
    for i in range(0, len(lines), 2):
        elems = lines[i].split()
        image_id = int(elems[0])
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([[float(pts[j]), float(pts[j + 1])] for j in range(0, len(pts), 3)]).reshape(-1, 2)
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)], dtype=np.int64)
        images[image_id] = BaseImage(
            id=image_id,
            qvec=np.array([float(v) for v in elems[1:5]]),
            tvec=np.array([float(v) for v in elems[5:8]]),
            camera_id=int(elems[8]),
            name=elems[9],
            xys=xys,
            point3D_ids=ids,
        )
    return images


def read_points3D_text(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse ``points3D.txt`` -> (xyzs, rgbs, errors), reference convention."""
    rows = list(_data_lines(path))
    xyzs = np.empty((len(rows), 3))
    rgbs = np.empty((len(rows), 3))
    errors = np.empty((len(rows), 1))
    for i, line in enumerate(rows):
        elems = line.split()
        xyzs[i] = [float(v) for v in elems[1:4]]
        rgbs[i] = [int(v) for v in elems[4:7]]
        errors[i] = float(elems[7])
    return xyzs, rgbs, errors


# ---------------------------------------------------------------------------
# Binary writers (fixture generation + checkpoint tooling; no reference
# equivalent — the reference only reads).
# ---------------------------------------------------------------------------

def write_intrinsics_binary(path: str, cameras: Dict[int, Camera]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            spec = CAMERA_MODEL_NAMES[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, spec.model_id, cam.width, cam.height))
            params = np.asarray(cam.params, dtype="<f8")
            if params.shape[0] != spec.num_params:
                raise ValueError(
                    f"{cam.model} expects {spec.num_params} params, got {params.shape[0]}"
                )
            f.write(params.tobytes())


def write_extrinsics_binary(path: str, images: Dict[int, BaseImage]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img in images.values():
            f.write(
                struct.pack(
                    "<idddddddi",
                    img.id,
                    *np.asarray(img.qvec, dtype=np.float64).tolist(),
                    *np.asarray(img.tvec, dtype=np.float64).tolist(),
                    img.camera_id,
                )
            )
            f.write(img.name.encode("utf-8") + b"\x00")
            n = int(np.asarray(img.xys).shape[0])
            f.write(struct.pack("<Q", n))
            if n:
                rec = np.zeros(n, dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]))
                rec["x"] = np.asarray(img.xys)[:, 0]
                rec["y"] = np.asarray(img.xys)[:, 1]
                rec["id"] = np.asarray(img.point3D_ids)
                f.write(rec.tobytes())


def write_points3D_binary(
    path: str,
    xyzs: np.ndarray,
    rgbs: np.ndarray,
    errors: np.ndarray | None = None,
) -> None:
    """Write a ``points3D.bin`` (empty tracks) that ``read_points3D_binary``
    and COLMAP itself can parse. Fixture/tooling helper."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    xyzs = np.asarray(xyzs, np.float64)
    rgbs = np.asarray(rgbs)
    n = xyzs.shape[0]
    if errors is None:
        errors = np.zeros((n, 1))
    header = struct.Struct("<QdddBBBd")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(
                header.pack(
                    i + 1, *xyzs[i].tolist(),
                    *np.asarray(rgbs[i], np.uint8).tolist(),
                    float(np.asarray(errors[i]).ravel()[0]),
                )
            )
            f.write(struct.pack("<Q", 0))  # track length
