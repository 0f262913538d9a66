"""Perceptual feature distance for evaluation (counterpart of
``mptpu/perceptual/distance.py``)."""

from __future__ import annotations

import torch

from ..ops import kinks

from .pif import fft_based_pif


def pif_distance(target: torch.Tensor, recon: torch.Tensor, freq_window_size: int = 64,
                 time_window_size: int = 32, eps: float = 1e-8) -> torch.Tensor:
    """``sum |PIF(t) - PIF(r)| / (sum |PIF(t)| + sum |PIF(r)| + eps)`` over
    (batch, 1, n) audio: 0 for a reconstruction the feature cannot tell
    from the target, 1 for silence against sound (and never above 1).
    Invariant to the phase within each time window."""
    ft = fft_based_pif(target, freq_window_size, time_window_size)
    fr = fft_based_pif(recon, freq_window_size, time_window_size)
    return torch.sum(kinks.abs(ft - fr)) / (torch.sum(kinks.abs(ft)) + torch.sum(kinks.abs(fr))
                                            + eps)
