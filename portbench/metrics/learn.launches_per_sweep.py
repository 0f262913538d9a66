"""Device kernel launches in the traced window over its sweeps."""


def read(t):
    n = t.kernel_count()
    return n / t.calls if n else None
