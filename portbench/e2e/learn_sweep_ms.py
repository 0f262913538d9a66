"""The window's milliseconds over its whole sweeps."""


def read(w):
    return w.seconds / w.calls * 1e3
