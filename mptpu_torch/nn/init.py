"""Weight initialisation (counterpart of ``mptpu/nn/init.py``): weights
uniform in [-scale, scale] or [low, high], biases zero; flax's default
``Dense`` kernel (LeCun normal) for the layers that ``mptpu`` leaves at
flax's default.

Draws come from a CPU ``torch.Generator`` and the tensors are moved
afterwards, so that a module starts from the same numbers on every device.
They are not flax's numbers: ``convert.splat_from_flax`` carries those.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import default_device


def uniform(shape, lo: float, hi: float, generator: torch.Generator | None = None,
            device=None) -> torch.Tensor:
    """Float32 uniform in [lo, hi) from ``generator``, on its device; without
    one, from the default generator of ``default_device(device)``."""
    dev = generator.device if generator is not None else default_device(device)
    return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo


def uniform_init(shape, scale: float, generator: torch.Generator) -> torch.Tensor:
    """Uniform in [-scale, scale) from ``generator`` (a CPU one)."""
    return uniform(shape, -scale, scale, generator)


def uniform_range_init(shape, low: float, high: float,
                       generator: torch.Generator) -> torch.Tensor:
    """Uniform in [low, high) from ``generator`` (``mptpu``'s
    ``uniform_range_init(low, high)``)."""
    return uniform(shape, low, high, generator)


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's default ``Dense`` kernel for ``shape = (in, out)``: a normal
    truncated at two standard deviations, scaled to variance ``1 / in``
    (``variance_scaling(1, "fan_in", "truncated_normal")``), drawn by the
    inverse of the normal's distribution function as JAX draws it."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = uniform(shape, lo, hi, generator)
    std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
    return torch.erfinv(u) * math.sqrt(2) * std


def uniform_linear(in_features: int, out_features: int, bias: bool, scale: float,
                   generator: torch.Generator, device=None) -> nn.Linear:
    """An ``nn.Linear`` with ``uniform_init`` weights and zero bias, on
    ``default_device(device)``."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(uniform_init(layer.weight.shape, scale, generator))
        if bias:
            layer.bias.zero_()
    return layer.to(default_device(device))


def flax_linear(in_features: int, out_features: int, bias: bool,
                generator: torch.Generator, device=None) -> nn.Linear:
    """An ``nn.Linear`` initialised as flax's default ``Dense``: a
    :func:`lecun_normal` kernel and a zero bias, on
    ``default_device(device)``."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(lecun_normal((in_features, out_features), generator).T)
        if bias:
            layer.bias.zero_()
    return layer.to(default_device(device))
