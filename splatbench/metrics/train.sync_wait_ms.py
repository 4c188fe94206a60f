"""Per step, host ms in the program's sync spans (``slice_sync``,
``reduction_sync``: the host's waits on the device), in the light window
(``splatbench/hosttrace.py``)."""

from splatbench import hosttrace


def read(run):
    return hosttrace.read_light(run, "train", hosttrace.sync_wait_ms)
