"""Helpers of the port (counterpart of ``mptpu.utils``; only the ported
names)."""

from .music import midi_to_hz, musical_scale_hz
from .wav import read_wav

__all__ = ["midi_to_hz", "musical_scale_hz", "read_wav"]
