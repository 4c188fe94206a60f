"""As ``train.raster_fwd_roofline_pct``, over the traced requests."""

from splatbench import readers


def read(run):
    return readers.roofline_pct(run, "raster_fwd_kernel", backward=False) if run.kind == "render" else None
