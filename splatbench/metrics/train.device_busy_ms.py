"""The union of device operations over the traced window of whole steps,
per step, in ms: the step's device time, which the host's pace leaves
alone (the window's rate and idle share carry that)."""


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or not t.steps:
        return None
    return t.busy_s / len(t.steps) * 1e3
