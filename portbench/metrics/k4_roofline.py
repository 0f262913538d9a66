"""The greedy loop's bound (roofline.loop_bytes, loop_flops) over K4's
traced device time, in percent; nothing where the window ran no K4."""

from portbench.tracing import K4


def read(t):
    return t.kernel_roofline(K4)
