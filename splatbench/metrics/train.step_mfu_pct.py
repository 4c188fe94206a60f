"""The traced steps' FP32 operations (the frozen count of ``counts.py``:
preprocess per gaussian, compositors per pixel entry, SSIM and L1 per pixel,
both ways) over (the traced window x the 67 TFLOP/s FP32 peak)."""

from splatbench import readers


def read(run):
    return readers.mfu_pct(run, train=True) if run.kind == "train" else None
