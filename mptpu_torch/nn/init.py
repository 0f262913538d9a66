"""Weight initialisation (counterpart of ``mptpu/nn/init.py``): weights
uniform in [-scale, scale], biases zero.

Draws come from a CPU ``torch.Generator`` and the tensors are moved
afterwards, so that a module starts from the same numbers on every device.
They are not flax's numbers: ``convert.splat_from_flax`` carries those.
"""

from __future__ import annotations

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
