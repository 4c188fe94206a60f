"""The traced requests' FP32 operations (``counts.py``, forward only) over
(the traced window x the 67 TFLOP/s FP32 peak)."""

from splatbench import readers


def read(run):
    return readers.mfu_pct(run, train=False) if run.kind == "render" else None
