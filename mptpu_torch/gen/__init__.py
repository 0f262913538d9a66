"""Synthesis helpers of the port (counterpart of ``mptpu.gen``; only the
ported names)."""

from .transfer import make_waves

__all__ = ["make_waves"]
