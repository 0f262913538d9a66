"""Idle milliseconds of the card a call while the host was in the encode
state: under the program's ``mptpu.mp.gram`` or ``mptpu.mp.state`` span."""

from portbench import spans


def read(t):
    return spans.idle_ms(t, ("mptpu.mp.gram", "mptpu.mp.state"))
