"""Gaussian and Gamma envelopes of the splatting event generators
(counterpart of ``mptpu/ops/pdf.py``).

``pdf2`` keeps ``jax.scipy.stats.norm.logpdf``'s form, the log of the
normaliser plus the quadratic, halved and negated, then ``exp``: the splat
path passes standard deviations as small as 1e-12, where a rearranged
Gaussian would overflow or lose the peak.
"""

from __future__ import annotations

import math

import torch

from ..device import grid_dtype
from .windows import linspace


def pdf(x: torch.Tensor, mean: torch.Tensor, sd: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Plain normal pdf with ``epsilon`` added to the variance."""
    var = sd**2 + epsilon
    denom = torch.sqrt(2 * math.pi * var)
    num = torch.exp(-((x - mean) ** 2) / (2 * var))
    return num / denom


def _norm_logpdf(x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.stats.norm.logpdf``, operation for operation."""
    scale_sqrd = scale * scale
    log_normalizer = torch.log(2 * math.pi * scale_sqrd)
    quadratic = (x - loc) ** 2 / scale_sqrd
    return (log_normalizer + quadratic) / -2


def _peak_normalize(prob: torch.Tensor) -> torch.Tensor:
    return prob / (torch.amax(prob, dim=-1, keepdim=True) + 1e-8)


def pdf2(means: torch.Tensor, stds: torch.Tensor, n_elements: int, normalize: bool = True) -> torch.Tensor:
    """Normal pdf on ``n_elements`` points of [0, 1], one row per entry of
    ``means`` / ``stds`` (the grid is the last axis), optionally divided by
    its peak + 1e-8."""
    grid = linspace(0.0, 1.0, n_elements, device=means.device, dtype=grid_dtype(means))
    prob = torch.exp(_norm_logpdf(grid, means[..., None], stds[..., None]))
    return _peak_normalize(prob) if normalize else prob


def gamma_pdf(shape: torch.Tensor, rate: torch.Tensor, n_elements: int,
              normalize: bool = True) -> torch.Tensor:
    """Gamma pdf on ``n_elements`` points of [1e-12, 20], optionally divided
    by its peak + 1e-8."""
    grid = linspace(1e-12, 20.0, n_elements, device=shape.device, dtype=grid_dtype(shape))
    a = shape[..., None]
    b = rate[..., None]
    log_prob = a * torch.log(b) + (a - 1.0) * torch.log(grid) - b * grid - torch.lgamma(a)
    prob = torch.exp(log_prob)
    return _peak_normalize(prob) if normalize else prob
