"""Residual MLP stacks, the latent heads of the event generators
(counterpart of ``mptpu/nn/linear.py``).

flax's ``Dense`` finds its input width when first called; an
``nn.Linear`` is told it: a stack without an in-projection takes inputs
``channels`` wide, as ``mptpu``'s callers give it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops import kinks
from ..ops.norms import unit_norm
from .init import uniform_linear


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return kinks.leaky_relu(x, 0.2)


class ResidualBlock(nn.Module):
    """Dense, activation, Dense, then the activation of the shortcut sum;
    ``unit_norm_out`` normalises the output over its last axis."""

    def __init__(self, channels: int, use_bias: bool = True, shortcut: bool = True,
                 unit_norm_out: bool = False, init_scale: float = 0.1,
                 activation: Callable = leaky_relu, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.shortcut = shortcut
        self.unit_norm_out = unit_norm_out
        self.activation = activation
        self.Dense_0 = uniform_linear(channels, channels, use_bias, init_scale, gen, device)
        self.Dense_1 = uniform_linear(channels, channels, use_bias, init_scale, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Dense_1(self.activation(self.Dense_0(x)))
        x = self.activation(x + h) if self.shortcut else self.activation(h)
        return unit_norm(x, axis=-1) if self.unit_norm_out else x


class ResidualStack(nn.Module):
    """``layers`` residual blocks, ``ResidualBlock_0`` first."""

    def __init__(self, channels: int, layers: int, use_bias: bool = True, shortcut: bool = True,
                 unit_norm_out: bool = False, init_scale: float = 0.1,
                 activation: Callable = leaky_relu, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.layers = layers
        for i in range(layers):
            self.add_module(f"ResidualBlock_{i}", ResidualBlock(
                channels, use_bias, shortcut, unit_norm_out, init_scale, activation, gen, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        return x


class LinearOutputStack(nn.Module):
    """[in-projection from ``in_channels``] -> residual stack -> out-projection
    to ``out_channels`` (``channels`` when None), which has no bias when
    ``out_channels == 1``. flax names the projections in call order:
    ``Dense_0`` and ``Dense_1`` with an in-projection, ``Dense_0`` alone
    without."""

    def __init__(self, channels: int, layers: int, out_channels: Optional[int] = None,
                 in_channels: Optional[int] = None, use_bias: bool = True, shortcut: bool = True,
                 unit_norm_out: bool = False, init_scale: float = 0.1,
                 activation: Callable = leaky_relu, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        out_channels = out_channels or channels
        self.in_proj = in_channels is not None
        if self.in_proj:
            self.Dense_0 = uniform_linear(in_channels, channels, use_bias, init_scale, gen, device)
        self.ResidualStack_0 = ResidualStack(channels, layers, use_bias, shortcut, unit_norm_out,
                                             init_scale, activation, gen, device)
        self.out_name = "Dense_1" if self.in_proj else "Dense_0"
        self.add_module(self.out_name, uniform_linear(channels, out_channels, out_channels > 1,
                                                      init_scale, gen, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_proj:
            x = self.Dense_0(x)
        return getattr(self, self.out_name)(self.ResidualStack_0(x))
