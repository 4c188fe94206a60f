"""Per request, the program's ``camera`` and ``preprocess`` spans."""

from splatbench import readers


def read(run):
    return readers.per_step_ms(run, ["camera", "preprocess"]) if run.kind == "render" else None
