"""95th percentile over every request of the window of the time from the
call to the frame being ready on the card (host clock)."""

import statistics


def read(run):
    if run.kind != "render" or len(run.latencies_ms) < 20:
        return None
    return statistics.quantiles(run.latencies_ms, n=20, method="inclusive")[-1]
