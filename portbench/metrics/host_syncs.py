"""The host's waits for the card a call: the synchronising CUDA runtime and
driver calls of the trace inside the program's spans (``spans.waits``).
``encode.host_syncs`` and ``learn.host_syncs`` read through this file."""

from portbench import spans


def read(t):
    return spans.waits(t)
