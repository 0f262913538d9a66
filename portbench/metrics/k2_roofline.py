"""The greedy loop's bound (roofline.loop_bytes, loop_flops) over K2's
traced device time, in percent; nothing where the window ran no K2."""

from portbench.tracing import K2


def read(t):
    return t.kernel_roofline(K2)
