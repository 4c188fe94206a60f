"""Per step, host ms inside the program's outermost spans on both threads
(the caller's and autograd's), less its sync spans, in the light window:
the traced run's steps with the program's tracer on and no profiler
(``splatbench/hosttrace.py``)."""

from splatbench import hosttrace


def read(run):
    return hosttrace.read_light(run, "train", hosttrace.host_issue_ms)
