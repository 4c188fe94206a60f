"""Per step, the mesh's all-gathers both ways: the packed rows' ``gather``,
the frame's ``frame_gather`` and their backward, ``gather_bwd``."""

from splatbench import readers


def read(run):
    return readers.per_step_ms(run, ["gather", "frame_gather", "gather_bwd"]) if run.kind == "train" else None
