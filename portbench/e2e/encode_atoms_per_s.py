"""Events coded in the window over the window's seconds."""


def read(w):
    return w.work / w.seconds
