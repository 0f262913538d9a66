"""Seconds from the process's start to the window's first call: imports, the
CUDA context, the kernels' library (built on a checkout's first run), the
inputs and weights made on the card, and the warm-up calls."""


def read(w):
    return w.setup_s
