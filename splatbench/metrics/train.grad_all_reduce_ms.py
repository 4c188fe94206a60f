"""Per step, the mesh's ``grad_all_reduce`` span: the five raw parameters'
gradients summed over the world."""

from splatbench import readers


def read(run):
    return readers.per_step_ms(run, ["grad_all_reduce"]) if run.kind == "train" else None
