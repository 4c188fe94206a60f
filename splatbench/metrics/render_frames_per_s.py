"""View requests completed over the whole window, per second (host clock)."""


def read(run):
    if run.kind != "render" or run.window_s <= 0.0:
        return None
    return run.completed / run.window_s
