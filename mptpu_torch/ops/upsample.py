"""Upsampling ops: zero-stuffing, linear or nearest interpolation over the
last axis, right-padding, FFT-domain upsampling (counterpart of
``mptpu/ops/upsample.py``).

``interpolate_last_axis`` is ``mptpu``'s explicit gather with clipped
coordinates (``F.interpolate``'s semantics with ``align_corners=False``,
over any number of leading axes), computed in the same float32 order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import grid_dtype
from .fft import irfft, rfft


def upsample_with_holes(low_sr: torch.Tensor, desired_size: int) -> torch.Tensor:
    """Each sample followed by ``factor - 1`` zeros, then right-padded or cut
    to ``desired_size``."""
    factor = desired_size // low_sr.shape[-1]
    zeros = torch.zeros(*low_sr.shape, factor - 1, dtype=low_sr.dtype, device=low_sr.device)
    stuffed = torch.cat([low_sr[..., None], zeros], dim=-1).reshape(
        *low_sr.shape[:-1], low_sr.shape[-1] * factor)
    if stuffed.shape[-1] < desired_size:
        stuffed = F.pad(stuffed, (0, desired_size - stuffed.shape[-1]))
    return stuffed[..., :desired_size]


def interpolate_last_axis(low_sr: torch.Tensor, desired_size: int, mode: str = "linear") -> torch.Tensor:
    """Interpolate the last axis to ``desired_size`` samples."""
    n = low_sr.shape[-1]
    dev = low_sr.device
    if mode == "nearest":
        idx = (torch.arange(desired_size, device=dev) * n) // desired_size
        return low_sr[..., idx]
    if mode != "linear":
        raise ValueError(f"unsupported mode: {mode}")
    scale = n / desired_size
    coords = (torch.arange(desired_size, dtype=grid_dtype(low_sr), device=dev) + 0.5) * scale - 0.5
    coords = torch.clamp(coords, 0.0, n - 1)
    lo = torch.floor(coords).long()
    hi = torch.clamp_max(lo + 1, n - 1)
    w = (coords - lo).to(low_sr.dtype)
    return low_sr[..., lo] * (1.0 - w) + low_sr[..., hi] * w


def ensure_last_axis_length(x: torch.Tensor, desired_size: int) -> torch.Tensor:
    """Right-pad the last axis with zeros up to ``desired_size``."""
    last = x.shape[-1]
    if last > desired_size:
        raise ValueError(
            f"Desired size provided was {desired_size}, but tensor is "
            f"already size {last} along last axis"
        )
    if last == desired_size:
        return x
    return F.pad(x, (0, desired_size - last))


def fft_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Band-limited upsampling: the ortho rFFT zero-padded to the new
    length's coefficients."""
    new_time = x.shape[-1] * factor
    coeffs = rfft(x, norm="ortho")
    coeffs = F.pad(coeffs, (0, (new_time // 2 + 1) - coeffs.shape[-1]))
    return irfft(coeffs, n=new_time, norm="ortho")
