"""Idle milliseconds of the card a call while the host was in the greedy
loop: under the program's ``mptpu.mp.loop`` span (the kernels' launches)."""

from portbench import spans


def read(t):
    return spans.idle_ms(t, ("mptpu.mp.loop",))
