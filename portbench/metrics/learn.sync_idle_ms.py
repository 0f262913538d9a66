"""Idle milliseconds of the card a sweep while the host grouped the events
by atom: under the program's ``mptpu.learn.groups`` span, which holds the
sweep's waits for the card."""

from portbench import spans


def read(t):
    return spans.idle_ms(t, ("mptpu.learn.groups",))
