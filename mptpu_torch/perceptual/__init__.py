"""Perceptual features (counterpart of ``mptpu.perceptual``; only the
ported names): the FFT-based phase-invariant feature and its distance,
which the SIAM trainer scores at every eval."""

from .distance import pif_distance
from .pif import fft_based_pif

__all__ = ["fft_based_pif", "pif_distance"]
