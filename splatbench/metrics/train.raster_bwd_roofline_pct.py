"""The backward compositor's frozen bound over the device time of the
``raster_bwd_kernel`` launches, per traced step."""

from splatbench import readers


def read(run):
    return readers.roofline_pct(run, "raster_bwd_kernel", backward=True) if run.kind == "train" else None
