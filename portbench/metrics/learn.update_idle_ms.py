"""Idle milliseconds of the card a sweep while the host was in the atom
update: under the program's ``mptpu.learn.update`` span."""

from portbench import spans


def read(t):
    return spans.idle_ms(t, ("mptpu.learn.update",))
