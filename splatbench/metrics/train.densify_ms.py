"""Per step, the union of the program's densify spans: ``densify_stats``
(the probe's radii and the accumulation), ``densify`` (the clone / split /
prune pass with its optimizer rows reset), ``densify_sync`` (the pass's
host reads, inside ``densify``) and ``capacity_check`` (the pair-demand
read of a capacity re-check), device time in stream order; nested spans
count once."""

from splatbench import readers

NAMES = ("densify_stats", "densify", "densify_sync", "capacity_check")


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or not t.steps:
        return None
    found = [sorted((s, e) for _, s, e in readers.spans(step, NAMES)) for step in t.steps]
    if not any(found):
        return None
    total = 0.0
    for intervals in found:
        end = float("-inf")
        for s, e in intervals:
            total += max(e - max(s, end), 0.0)
            end = max(end, e)
    return total / len(t.steps)
