"""Per step, the program's ``preprocess`` spans (activations, SH, EWA,
boxes), device time in stream order."""

from splatbench import readers


def read(run):
    return readers.per_step_ms(run, ["preprocess"]) if run.kind == "train" else None
