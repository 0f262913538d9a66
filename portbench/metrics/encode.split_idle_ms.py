"""Idle milliseconds of the card a call while the host was in the
multiband codec's octave split: under the program's
``mptpu.multiband.split`` span."""

from portbench import spans


def read(t):
    return spans.idle_ms(t, ("mptpu.multiband.split",))
