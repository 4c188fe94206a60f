"""Training steps completed over the whole window, per second (host clock,
the window ended by a fence)."""


def read(run):
    if run.kind != "train" or run.window_s <= 0.0:
        return None
    return run.completed / run.window_s
