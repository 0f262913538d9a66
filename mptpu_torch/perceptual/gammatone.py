"""Gammatone FIR filter bank (counterpart of ``mptpu/perceptual/gammatone.py``).

The bank is built on the host with scipy in float64 and returned as float32
numpy, bit for bit ``mptpu``'s; callers move it to their device.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
from scipy.signal import gammatone


def gammatone_filter_bank(
    n_filters: int,
    size: int,
    start_hz: float = 20,
    stop_hz: float = 11000,
    samplerate: int = 22050,
    band_spacing: Union[str, Sequence[float]] = "linear",
) -> np.ndarray:
    """(n_filters, size) float32 4th-order gammatone FIRs, each divided by
    its largest magnitude; centre frequencies ``linear`` or ``geometric``
    from ``start_hz`` to ``stop_hz``, or the sequence given."""
    if isinstance(band_spacing, str) and band_spacing == "linear":
        frequencies = np.linspace(start_hz, stop_hz, num=n_filters)
    elif isinstance(band_spacing, str) and band_spacing == "geometric":
        frequencies = np.geomspace(start_hz, stop_hz, num=n_filters)
    elif hasattr(band_spacing, "__getitem__") and not isinstance(band_spacing, str):
        frequencies = np.asarray(band_spacing)
    else:
        raise ValueError(f"{band_spacing} is not a valid band_spacing value, "
                         "please choose linear or geometric")
    bank = np.zeros((n_filters, size))
    for i, freq in enumerate(frequencies):
        b, _ = gammatone(freq=freq, ftype="fir", order=4, numtaps=size, fs=samplerate)
        bank[i] = b
    bank = bank / np.abs(bank).max(axis=-1, keepdims=True)
    return bank.astype(np.float32)
