"""The operations the traced calls need (the entry's ``needed``, by
roofline's counts) over the traced window's seconds times the card's
float32 peak, in percent."""


def read(t):
    return t.mfu()
