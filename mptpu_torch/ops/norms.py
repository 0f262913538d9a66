"""Normalization ops (counterpart of ``mptpu/ops/norms.py``)."""

from __future__ import annotations

import torch

from . import kinks
from .kinks import clip


def _safe_norm(x: torch.Tensor, axis, epsilon: float) -> torch.Tensor:
    """L2 norm with the sqrt input clamped below ``epsilon**2``, so the
    gradient at 0 is 0 rather than NaN (``mptpu/ops/norms.py:9-14``)."""
    sq = torch.sum(x * x, dim=axis, keepdim=True)
    return torch.sqrt(clip(sq, epsilon * epsilon))


def unit_norm(x: torch.Tensor, axis=-1, epsilon: float = 1e-8) -> torch.Tensor:
    return x / (_safe_norm(x, axis, epsilon) + epsilon)


def max_norm(
    x: torch.Tensor, axis=-1, epsilon: float = 1e-8, return_value: bool = False
):
    n = torch.amax(kinks.abs(x), dim=axis, keepdim=True)
    normed = x / (n + epsilon)
    if return_value:
        return normed, n
    return normed


def limit_norm(x: torch.Tensor, axis=2, max_norm_value: float = 0.9999) -> torch.Tensor:
    """Clamp the norm along ``axis`` to at most ``max_norm_value``."""
    norm = _safe_norm(x, axis, 1e-8)
    unit = x / (norm + 1e-8)
    return unit * clip(norm, hi=max_norm_value)


def example_norm(x: torch.Tensor, axis=(1, 2), epsilon: float = 1e-8) -> torch.Tensor:
    """Per-example std normalization with the unbiased (ddof=1) std."""
    stds = torch.std(x, dim=axis, keepdim=True, correction=1)
    return x / (stds + epsilon)
