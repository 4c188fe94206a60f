"""Progressive-render video generation (reference C19, rasterize.py:427-466),
as ``gsplat_tpu/utils/video.py``.

The reference snapshots the framebuffer every 1000 gaussians inside its
sequential loop. A tile renderer has no such loop, so the progressive effect
is reproduced by rendering depth-prefixes of the gaussian set: frame k
composites only the nearest k*stride gaussians (same visual: the scene
"builds up" front to back). Frames are PNG'd and encoded with the same
ffmpeg settings (libx264, yuv420p, input framerate 20 -> output 10,
even-dimension fix), or packed as a Motion-JPEG AVI where there is no
ffmpeg. Frames are numpy ``[H, W, 3]`` arrays in [0, 1].
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np
import torch

FRAMERATE = 20  # rasterize.py:455
OUTPUT_FRAMERATE = 10  # rasterize.py:465
SNAPSHOT_STRIDE = 1000  # rasterize.py:448
TAIL_SECONDS = 2  # rasterize.py:456-457


def save_frame(path: str, image: np.ndarray) -> None:
    from PIL import Image

    arr = (np.clip(np.asarray(image), 0.0, 1.0) * 255.0).astype(np.uint8)
    Image.fromarray(arr).save(path)


def _encode_all(fn, items) -> list:
    """``[fn(x) for x in items]`` on a pool of threads: PIL's PNG and JPEG
    codecs release the interpreter lock, and a 1080p PNG takes about a
    second to compress."""
    from concurrent.futures import ThreadPoolExecutor

    items = list(items)
    with ThreadPoolExecutor(max_workers=max(1, min(len(items), os.cpu_count() or 1))) as pool:
        return list(pool.map(fn, items))


def write_frames(output_path: str, frames: List[np.ndarray]) -> List[str]:
    """Write frames (plus the 2s freeze tail) as image_iter_*.png files.
    The tail's files are copies of the last frame's."""
    image_dir = os.path.join(output_path, "images")
    os.makedirs(image_dir, exist_ok=True)
    paths = [
        os.path.join(image_dir, f"image_iter_{str(i * SNAPSHOT_STRIDE).zfill(7)}.png")
        for i in range(len(frames) + TAIL_SECONDS * FRAMERATE)
    ]
    _encode_all(lambda job: save_frame(*job), zip(paths, frames))
    for p in paths[len(frames):]:
        shutil.copyfile(paths[len(frames) - 1], p)
    return paths


def encode_video(output_path: str, width: int, height: int) -> str:
    """Encode images/image_iter_*.png into video_render.mp4 via ffmpeg
    (libx264/yuv420p/even-dims, rasterize.py:462-466). Falls back to a
    dependency-free MJPEG AVI when ffmpeg is unavailable."""
    if shutil.which("ffmpeg") is None:
        return encode_mjpeg_avi(output_path)
    video_path = os.path.join(output_path, "video_render.mp4")
    if os.path.exists(video_path):
        os.remove(video_path)
    pattern = os.path.join(output_path, "images", "image_iter_*.png")
    cmd = [
        "ffmpeg", "-y",
        "-framerate", str(FRAMERATE),
        "-pattern_type", "glob", "-i", pattern,
        "-r", str(OUTPUT_FRAMERATE),
        "-vcodec", "libx264",
        "-s", f"{width - width % 2}x{height - height % 2}",
        "-pix_fmt", "yuv420p",
        video_path,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return video_path


def encode_mjpeg_avi(output_path: str) -> str:
    """Pure-Python video encoder: pack the PNG frames as a Motion-JPEG AVI
    (RIFF 'AVI ' + 'MJPG' fourcc — playable by every mainstream player).
    Used when ffmpeg is not on PATH. Frames whose files are byte-equal (the
    freeze tail) share one JPEG."""
    import glob
    import hashlib
    import io as _io
    import struct

    from PIL import Image

    frame_paths = sorted(glob.glob(os.path.join(output_path, "images", "image_iter_*.png")))
    if not frame_paths:
        raise FileNotFoundError(f"no frames under {output_path}/images")

    def to_jpeg(path: str) -> bytes:
        buf = _io.BytesIO()
        with Image.open(path) as im:
            im.convert("RGB").save(buf, "JPEG", quality=92)
        data = buf.getvalue()
        return data + (b"\x00" if len(data) % 2 else b"")

    with Image.open(frame_paths[0]) as first:
        width, height = first.size
    keys = []
    for p in frame_paths:
        with open(p, "rb") as f:
            keys.append(hashlib.sha256(f.read()).digest())
    path_of = dict(zip(keys, frame_paths))  # one file of each content
    encoded = dict(zip(path_of, _encode_all(to_jpeg, path_of.values())))
    jpegs = [encoded[k] for k in keys]

    fps = OUTPUT_FRAMERATE
    n = len(jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack(
        "<14I", 1_000_000 // fps, 0, 0, 0x10, n, 0, 1, 0, width, height, 0, 0, 0, 0
    )
    strh = (
        b"vids" + b"MJPG"
        # flags, priority, language, initialFrames, scale, rate, start,
        # length, suggestedBufferSize, quality, sampleSize
        + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0, n, 0, 0xFFFFFFFF, 0)
        + struct.pack("<4H", 0, 0, width, height)
    )
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG", width * height * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi = lst(b"movi", b"".join(chunk(b"00dc", j) for j in jpegs))

    # idx1 index (offsets relative to the start of 'movi' fourcc + 4)
    idx = b""
    off = 4
    for j in jpegs:
        idx += b"00dc" + struct.pack("<III", 0x10, off, len(j))
        off += 8 + len(j)
    idx1 = chunk(b"idx1", idx)

    riff_payload = b"AVI " + hdrl + movi + idx1
    video_path = os.path.join(output_path, "video_render.avi")
    with open(video_path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)
    return video_path


@torch.inference_mode()
def progressive_frames(
    model, camera, cfg, num_frames: Optional[int] = None, stride: Optional[int] = None
) -> List[np.ndarray]:
    """Render progressive build-up frames: frame k shows the k*stride
    nearest gaussians (the reference's every-1000-gaussians snapshots,
    rasterize.py:448-450). ``stride`` defaults to that 1000-gaussian cadence
    when ``num_frames`` is not given.

    Front-to-back compositing factorizes: given the accumulated frame
    (C, T) and the next depth slab's standalone composite (C_s, T_s), the
    extended frame is exactly (C + T*C_s, T*T_s). So each frame only
    rasterizes its *own* slab's pairs (gaussians outside the slab get the
    opacity logit -30, which empties their alpha-cull rect, so they emit no
    pairs at all) and the raster work over the whole video equals ONE full
    render. Runs on the model's device; returns numpy [H, W, 3] frames."""
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.render.pipeline import preprocess, render
    from gsplat_tpu_torch.utils.progress import progress

    n = model.num_gaussians
    if stride is None:
        stride = SNAPSHOT_STRIDE if num_frames is None else max(1, n // num_frames)
    prep = preprocess(model, camera, cfg)
    # Stable ranks: the renderer breaks depth ties by gaussian id (stable
    # sort in ops/binning.py), so slab partitioning must too, or tied-depth
    # gaussians could composite across slabs in the wrong order.
    order = torch.argsort(prep.depth, stable=True)
    depth_rank = torch.empty_like(order)
    depth_rank[order] = torch.arange(n, device=order.device)
    logits = model.opacity_logits
    hidden = torch.full_like(logits, -30.0)

    frames = []
    color = trans = None
    for k0 in progress(range(0, n, stride), desc="progressive frames"):
        in_slab = (depth_rank >= k0) & (depth_rank < k0 + stride)
        sub = GaussianModel(model.means, model.log_scales, model.quats, torch.where(in_slab, logits, hidden), model.sh)
        c_slab, t_slab = render(sub, camera, cfg)
        if color is None:
            color, trans = c_slab, t_slab
        else:
            color = color + trans[:, :, None] * c_slab
            trans = trans * t_slab
        frames.append(color.cpu().numpy())
    return frames
