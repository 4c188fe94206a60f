"""Per request, device operations launched inside a program span, in the host
cycle (profiler and tracer on; each operation put down to the span open at
its launching runtime call, ``splatbench/hosttrace.py``)."""

from splatbench import hosttrace


def read(run):
    return hosttrace.read_by_stage(run, "render", hosttrace.launches)
