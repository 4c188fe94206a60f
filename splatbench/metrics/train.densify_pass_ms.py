"""The program's ``densify`` span (the clone / split / prune pass with its
optimizer rows reset), device time in stream order, averaged over the
traced steps that hold one: the pass alone, which ``train.densify_ms``
spreads over the steps between two passes."""

from splatbench import readers

NAME = "densify"


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    found = [f for f in (readers.spans(step, [NAME]) for step in t.steps) if f]
    if not found:
        return None
    return sum(e - s for f in found for _, s, e in f) / len(found)
