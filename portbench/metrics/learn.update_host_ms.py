"""Host milliseconds a sweep inside the program's ``mptpu.learn.update``
span: the Python loop over the used atoms and the dictionary's norms."""

from portbench import spans


def read(t):
    return spans.host_ms(t, "mptpu.learn.update")
