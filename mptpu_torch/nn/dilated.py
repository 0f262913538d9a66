"""The gated dilated convolution stack (counterpart of
``mptpu/nn/dilated.py``). Public shape (batch, channels, time); the
blocks run channels-last, as flax's. Children carry flax's names."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..device import no_tf32
from .init import flax_linear
from .layers import conv_last, flax_conv


class DilatedBlock(nn.Module):
    """(batch, time, channels) -> (next input, output): two dilated
    convolutions of kernel 3 (``Conv_0`` the scale, ``Conv_1`` the gate,
    uniform +-0.1), ``h = tanh(scale) * sigmoid(gate)``, the output
    ``Dense_0(h)`` and the next input ``Dense_1(h) + x``. ``padding``
    ``"only-past"`` pads ``2 * dilation`` on the left, ``"only-future"`` on
    the right, anything else ``dilation`` on both sides."""

    def __init__(self, channels: int, dilation: int, padding: Optional[str] = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        if padding == "only-past":
            self.pad = (2 * dilation, 0)
        elif padding == "only-future":
            self.pad = (0, 2 * dilation)
        else:
            self.pad = (dilation, dilation)
        self.Conv_0 = flax_conv(channels, channels, 3, 0.1, gen, dilation=dilation, device=device)
        self.Conv_1 = flax_conv(channels, channels, 3, 0.1, gen, dilation=dilation, device=device)
        self.Dense_0 = flax_linear(channels, channels, True, gen, device)
        self.Dense_1 = flax_linear(channels, channels, True, gen, device)

    def forward(self, x: torch.Tensor):
        scale = conv_last(self.Conv_0, x, self.pad)
        gate = conv_last(self.Conv_1, x, self.pad)
        h = torch.tanh(scale) * torch.sigmoid(gate)
        with no_tf32():
            return self.Dense_1(h) + x, self.Dense_0(h)


class DilatedStack(nn.Module):
    """(batch, channels, time) -> the sum of the blocks' outputs, (batch,
    channels, time); ``return_features`` also gives each block's next
    input, channels first."""

    def __init__(self, channels: int, dilations: Sequence[int], padding: Optional[str] = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_blocks = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"DilatedBlock_{i}", DilatedBlock(channels, d, padding, gen, device))

    def forward(self, x: torch.Tensor, return_features: bool = False):
        n = x.transpose(1, 2)
        outputs = torch.zeros_like(n)
        features = []
        for i in range(self.n_blocks):
            n, o = getattr(self, f"DilatedBlock_{i}")(n)
            features.append(n.transpose(1, 2))
            outputs = outputs + o
        outputs = outputs.transpose(1, 2)
        return (outputs, features) if return_features else outputs
