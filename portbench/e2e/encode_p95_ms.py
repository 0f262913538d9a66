"""The 95th percentile (linear between ranks) of every call's latency in
the window, each from its start to the card's synchronisation after it."""

import numpy as np


def read(w):
    return float(np.percentile(np.asarray(w.latencies) * 1e3, 95))
