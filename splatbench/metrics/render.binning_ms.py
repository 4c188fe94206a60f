"""Per request, the program's packing and binning spans, as
``train.binning_ms``."""

from splatbench import readers

NAMES = ["pack_features", "binning", "depth_sort", "sliced_binning", "slice_sync"]


def read(run):
    return readers.per_step_ms(run, NAMES) if run.kind == "render" else None
