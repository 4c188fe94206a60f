"""Per step, the benchmark's ``bench.loss`` span around ``rgb_loss``, plus
the time from the start of its ``bench.backward`` span to the first
``raster_bwd`` span: the loss's backward and the frame assembly's."""

from splatbench import readers


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.steps:
        return None
    total = 0.0
    for step in run.trace.steps:
        loss = readers.spans(step, ["bench.loss"])
        back = readers.spans(step, ["bench.backward"])
        bwd = readers.spans(step, ["raster_bwd"])
        if not (loss and back and bwd):
            return None
        total += sum(e - s for _, s, e in loss) + min(s for _, s, _ in bwd) - back[0][1]
    return total / len(run.trace.steps)
