"""Losses of the port (counterpart of ``mptpu.losses``; only the ported
names)."""

from .iterative import iterative_loss, sort_channels_descending_norm
from .multiband_spec import flattened_multiband_spectrogram, multiband_spectrogram, stft_transform

__all__ = [
    "iterative_loss",
    "sort_channels_descending_norm",
    "flattened_multiband_spectrogram",
    "multiband_spectrogram",
    "stft_transform",
]
