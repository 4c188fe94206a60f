"""Per step, from the end of the last ``reduction`` span to the end of the
benchmark's ``bench.backward`` span: autograd through ``pack_features``
and the preprocess to the five parameters."""

from splatbench import readers


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.steps:
        return None
    total = 0.0
    for step in run.trace.steps:
        back = readers.spans(step, ["bench.backward"])
        red = readers.spans(step, ["reduction"])
        if not (back and red):
            return None
        total += back[0][2] - max(e for _, _, e in red)
    return total / len(run.trace.steps)
