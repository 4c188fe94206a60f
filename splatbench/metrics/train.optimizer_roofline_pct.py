"""Adam's bytes bound over the time of the program's ``optimizer`` spans, in
percent: seven 4-byte accesses for each of the 59 parameters of every row
the optimizer holds (``adam_counts.py``: the densify pool, sized by the
configurations of the cells this metric lists), at the 3.35 TB/s HBM
peak, a step."""

from splatbench import adam_counts, readers

NAME = "train.optimizer_roofline_pct"


def read(run):
    if run.kind != "train":
        return None
    ms = readers.per_step_ms(run, ["optimizer"])
    rows = adam_counts.optimized_rows(run.trace.n_gaussians, NAME) if ms else None
    if rows is None:
        return None
    return 100.0 * adam_counts.adam_bound_s(rows) / (ms / 1e3)
