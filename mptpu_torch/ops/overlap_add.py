"""Half-lapped overlap-add synthesis, frames to samples (counterpart of
``mptpu/ops/overlap_add.py``): an optional periodic Hann window, a hop of
half a frame, each frame's halves laid end to end and added.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .windows import hann_window


def overlap_add(x: torch.Tensor, apply_window: bool = True, flip: bool = False,
                trim: int | None = None) -> torch.Tensor:
    """(batch, channels, frames, window) -> (batch, channels, frames *
    window // 2 + window // 2), cut to ``trim`` samples when given; ``flip``
    reverses the sequence of first halves before the sum."""
    batch, channels, frames, samples = x.shape
    if apply_window:
        x = x * hann_window(samples, periodic=True, dtype=x.dtype, device=x.device)
    hop = samples // 2
    first = F.pad(x[..., :hop].reshape(batch, channels, -1), (0, hop))
    second = F.pad(x[..., hop:].reshape(batch, channels, -1), (hop, 0))
    if flip:
        first = first.flip(-1)
    out = first + second
    if trim is not None:
        out = out[..., :trim]
    return out
