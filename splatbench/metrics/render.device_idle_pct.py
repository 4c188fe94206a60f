"""As ``train.device_idle_pct``, over whole fenced requests."""

from splatbench import readers


def read(run):
    return readers.idle_pct(run) if run.kind == "render" else None
