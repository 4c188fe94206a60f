"""100 minus the union of device operations over the traced window of
whole steps, in percent of the window."""

from splatbench import readers


def read(run):
    return readers.idle_pct(run) if run.kind == "train" else None
