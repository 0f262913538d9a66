"""The share of the traced window in which no device operation ran."""


def read(t):
    return t.idle_pct()
