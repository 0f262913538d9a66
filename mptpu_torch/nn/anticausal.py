"""The anti-causal (future-looking) gated dilated convolution stack, the
SIAM encoder (counterpart of ``mptpu/nn/anticausal.py``).

Tensors are (batch, channels, time) at the boundary, as in ``mptpu``;
the convolutions run on that layout and the Dense layers on (batch, time,
channels). Children carry flax's names (``Conv_0``, ``AntiCausalConv_0``,
``AntiCausalBlock_0``, ``AntiCausalStack_0``, ``Dense_0``), so that
``convert.siam_from_flax`` finds every layer by its flax path. Weights
are drawn uniform in +-``init_scale`` from a CPU ``torch.Generator``
(default seed 0), biases zero. ``do_norm`` puts flax's ``BatchNorm``
(``BatchNorm_0``, over the channels) after each block; ``train=True``
normalises by the batch and moves its running statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device, no_tf32
from ..ops.ste import straight_through
from .init import uniform_linear
from .layers import BatchNorm, flax_conv
from .pos_encode import n_features_for_freq, pos_encoded


class AntiCausalConv(nn.Module):
    """Dilated convolution padded by ``(kernel_size * dilation) // 2`` on
    the right, so that each step sees the future; ``reverse_causality``
    pads on the left."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, dilation: int,
                 reverse_causality: bool = False, init_scale: float = 0.1,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        pad = (kernel_size * dilation) // 2
        self.padding = (pad, 0) if reverse_causality else (0, pad)
        self.Conv_0 = flax_conv(in_channels, out_channels, kernel_size, init_scale, gen,
                                dilation=dilation, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (batch, channels, time)
        with no_tf32():
            return self.Conv_0(F.pad(x, self.padding))


class AntiCausalBlock(nn.Module):
    """Gated residual block, ``conv(x) * selu(gate(x)) + x`` (or ``tanh(conv
    * tanh_weight) * sigmoid(gate * sigmoid_weight) + x`` with
    ``with_activation_norm``).

    ``activation_clamp`` > 0 clips the block's output to +-that bound with
    an identity backward: the gated product is quadratic in x, so a stack
    of N blocks is a polynomial of degree 2^N that can overflow float32.
    The forward is unchanged while activations stay inside the bound."""

    def __init__(self, channels: int, kernel_size: int, dilation: int,
                 reverse_causality: bool = False, with_activation_norm: bool = False,
                 init_scale: float = 0.1, activation_clamp: float = 0.0,
                 generator: torch.Generator | None = None, device=None, do_norm: bool = False):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.do_norm = do_norm
        self.with_activation_norm = with_activation_norm
        self.activation_clamp = activation_clamp
        self.AntiCausalConv_0 = AntiCausalConv(channels, channels, kernel_size, dilation,
                                               reverse_causality, init_scale, gen, device)
        self.AntiCausalConv_1 = AntiCausalConv(channels, channels, kernel_size, dilation,
                                               reverse_causality, init_scale, gen, device)
        if with_activation_norm:
            dev = default_device(device)
            self.tanh_weight = nn.Parameter(torch.full((1,), 0.5, device=dev))
            self.sigmoid_weight = nn.Parameter(torch.full((1,), 0.5, device=dev))
        if do_norm:
            self.BatchNorm_0 = BatchNorm(channels, axis=1, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        conv = self.AntiCausalConv_0(x)
        gate = self.AntiCausalConv_1(x)
        if self.with_activation_norm:
            h = torch.tanh(conv * self.tanh_weight) * torch.sigmoid(gate * self.sigmoid_weight)
        else:
            h = conv * F.selu(gate)
        h = h + x
        if self.activation_clamp:
            b = self.activation_clamp
            h = straight_through(torch.clamp(h, -b, b), h)
        return self.BatchNorm_0(h, train) if self.do_norm else h


class AntiCausalStack(nn.Module):
    """The blocks in turn; the sum of every block's output goes through a
    Dense (``Dense_0``)."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int],
                 reverse_causality: bool = False, with_activation_norm: bool = False,
                 init_scale: float = 0.1, activation_clamp: float = 0.0,
                 generator: torch.Generator | None = None, device=None, do_norm: bool = False):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_blocks = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"AntiCausalBlock_{i}", AntiCausalBlock(
                channels, kernel_size, d, reverse_causality, with_activation_norm, init_scale,
                activation_clamp, gen, device, do_norm))
        self.Dense_0 = uniform_linear(channels, channels, True, init_scale, gen, device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        output = torch.zeros_like(x)   # x: (batch, channels, time)
        for i in range(self.n_blocks):
            x = getattr(self, f"AntiCausalBlock_{i}")(x, train)
            output = output + x
        with no_tf32():
            return self.Dense_0(output.transpose(1, 2)).transpose(1, 2)


class AntiCausalAnalysis(nn.Module):
    """(batch, in_channels, time) -> (batch, channels, time): a Dense from
    the input channels (``Dense_0``), optional positional encodings through
    ``Dense_1``, then the stack (``AntiCausalStack_0``)."""

    def __init__(self, in_channels: int, channels: int, kernel_size: int,
                 dilations: Sequence[int], pos_encodings: bool = False,
                 reverse_causality: bool = False, with_activation_norm: bool = False,
                 init_scale: float = 0.1, activation_clamp: float = 0.0,
                 generator: torch.Generator | None = None, device=None, do_norm: bool = False):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.pos_encodings = pos_encodings
        self.Dense_0 = uniform_linear(in_channels, channels, True, init_scale, gen, device)
        if pos_encodings:
            self.Dense_1 = uniform_linear(n_features_for_freq(16), channels, True, init_scale,
                                          gen, device)
        self.AntiCausalStack_0 = AntiCausalStack(
            channels, kernel_size, dilations, reverse_causality, with_activation_norm, init_scale,
            activation_clamp, gen, device, do_norm)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        batch, _, time = x.shape
        with no_tf32():
            h = self.Dense_0(x.transpose(1, 2))   # (batch, time, channels)
            if self.pos_encodings:
                h = h + self.Dense_1(pos_encoded(batch, time, n_freqs=16, device=x.device))
        return self.AntiCausalStack_0(h.transpose(1, 2), train)
