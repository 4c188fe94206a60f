"""Per step, the program's ``optimizer`` spans (Adam over the model or the
densify pool, with the position schedule), device time in stream order."""

from splatbench import readers


def read(run):
    return readers.per_step_ms(run, ["optimizer"]) if run.kind == "train" else None
