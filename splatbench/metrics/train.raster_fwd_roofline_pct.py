"""The forward compositor's frozen bound (``counts.compositor_bound_s`` on
the benchmark's own pixel entries up to each pixel's early stop) over the
device time of the ``raster_fwd_kernel`` launches, per traced step."""

from splatbench import readers


def read(run):
    return readers.roofline_pct(run, "raster_fwd_kernel", backward=False) if run.kind == "train" else None
