"""Per step, the program's packing and binning spans: ``pack_features``,
``binning``, ``depth_sort``, ``sliced_binning`` and ``slice_sync``."""

from splatbench import readers

NAMES = ["pack_features", "binning", "depth_sort", "sliced_binning", "slice_sync"]


def read(run):
    return readers.per_step_ms(run, NAMES) if run.kind == "train" else None
