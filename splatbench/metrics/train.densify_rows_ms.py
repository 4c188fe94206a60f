"""The program's ``densify_rows`` span (inside ``densify``: the split
samples' draw, the gathers of the new rows, their writes into the free
slots and the shrink of the split originals), device time in stream order,
averaged over the traced steps that hold one: what growth adds to a pass.
A program without the span reads nothing."""

from splatbench import readers

NAME = "densify_rows"


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    found = [f for f in (readers.spans(step, [NAME]) for step in t.steps) if f]
    if not found:
        return None
    return sum(e - s for f in found for _, s, e in f) / len(found)
