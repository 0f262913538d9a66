"""Data of the port (counterpart of ``mptpu.data``; only the ported
names)."""

from .synthetic import streaming_windows, synthetic_audio

__all__ = ["streaming_windows", "synthetic_audio"]
