"""Device milliseconds a call of everything outside the greedy-loop
kernels (the gram, the initial correlation, pads, the block maxima, the
band split), as the union of their intervals."""

from portbench.tracing import LOOP_KERNELS, base_name


def read(t):
    outside = t.busy_s(lambda name, cat: base_name(name) not in LOOP_KERNELS)
    return outside / t.calls * 1e3 if outside > 0 else None
