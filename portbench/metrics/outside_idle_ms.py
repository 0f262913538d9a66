"""Idle milliseconds of the card a call while the host was in no program
span: the harness between calls and the program outside its spans.
``encode.outside_idle_ms`` and ``learn.outside_idle_ms`` read through this
file."""

from portbench import spans


def read(t):
    return spans.outside_idle_ms(t)
