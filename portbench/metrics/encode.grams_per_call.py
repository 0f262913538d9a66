"""Grams a call: the program's ``mptpu.mp.gram`` spans over the calls (one
a greedy encode, one a band in the multiband codec; a cached gram would
open none)."""

from portbench import spans


def read(t):
    return spans.count(t, "mptpu.mp.gram")
