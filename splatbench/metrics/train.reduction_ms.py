"""Per step, the program's ``reduction`` spans (pair rows to gaussians)."""

from splatbench import readers


def read(run):
    return readers.per_step_ms(run, ["reduction"]) if run.kind == "train" else None
