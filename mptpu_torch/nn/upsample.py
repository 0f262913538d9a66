"""The learned convolutional upsampler, a latent to a (channels, end_size)
signal (counterpart of ``mptpu/nn/upsample.py``).

Children carry flax's names: ``Dense_0`` (from a latent), per layer a
``ConvTranspose_i`` (mode ``learned``) or a ``Conv_i`` (the other modes)
and a ``BatchNorm_i`` or ``LayerNorm_i``, then the output ``Conv_j``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import no_tf32
from ..ops import kinks
from ..ops.upsample import fft_upsample, interpolate_last_axis
from .init import uniform_linear
from .layers import BatchNorm, ConvTranspose1d, LayerNorm, conv_last, flax_conv


class ConvUpsample(nn.Module):
    """latent (batch, latent_dim) -> (batch, out_channels, end_size), or,
    with ``from_latent=False``, (batch, in_channels, start_size) -> the same
    (``in_channels`` defaults to ``channels``; flax's first layer takes
    the input's width).
    Each of the ``log2(end_size / start_size)`` layers doubles the length:
    ``learned`` by a transposed convolution (kernel 4, stride 2, flax's
    ``SAME``: exactly twice), ``nearest`` / ``linear`` by interpolation
    and ``fft`` by zero-padding the spectrum, each of those three followed
    by a convolution of kernel 3; then a batch or layer norm and a leaky
    ReLU (0.2)."""

    def __init__(self, latent_dim: int, channels: int, start_size: int, end_size: int,
                 mode: str = "nearest", out_channels: int = 1, from_latent: bool = True,
                 batch_norm: bool = False, layer_norm: bool = False, init_scale: float = 0.1,
                 in_channels: int | None = None, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        if mode not in ("nearest", "linear", "learned", "fft"):
            raise ValueError(f"unsupported mode: {mode}")
        gen = generator or torch.Generator().manual_seed(0)
        self.latent_dim, self.channels, self.start_size = latent_dim, channels, start_size
        self.mode, self.from_latent = mode, from_latent
        self.batch_norm, self.layer_norm = batch_norm, layer_norm
        self.n_layers = int(math.log2(end_size) - math.log2(start_size))
        if from_latent:
            self.Dense_0 = uniform_linear(latent_dim, channels * start_size, True, init_scale,
                                          gen, device)
        width = channels if from_latent or in_channels is None else in_channels
        for i in range(self.n_layers):
            if mode == "learned":
                layer = ConvTranspose1d(width, channels, 4, 2, "SAME", init_scale, gen, device)
                self.add_module(f"ConvTranspose_{i}", layer)
            else:
                self.add_module(f"Conv_{i}", flax_conv(width, channels, 3, init_scale, gen,
                                                       device=device))
            width = channels
            if batch_norm:
                self.add_module(f"BatchNorm_{i}", BatchNorm(channels, device=device))
            elif layer_norm:
                self.add_module(f"LayerNorm_{i}", LayerNorm(channels, use_scale=False,
                                                            use_bias=False, device=device))
        self.out_name = f"Conv_{0 if mode == 'learned' else self.n_layers}"
        self.add_module(self.out_name, flax_conv(width, out_channels, 3, init_scale, gen,
                                                 device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.from_latent:
            with no_tf32():
                x = self.Dense_0(x.reshape(-1, self.latent_dim))
            x = x.reshape(-1, self.start_size, self.channels)
        else:
            x = x.transpose(1, 2)
        for i in range(self.n_layers):
            if self.mode == "learned":
                x = getattr(self, f"ConvTranspose_{i}")(x)
            else:
                t = x.transpose(1, 2)
                if self.mode == "fft":
                    t = fft_upsample(t, 2)
                else:
                    t = interpolate_last_axis(t, t.shape[-1] * 2, mode=self.mode)
                x = conv_last(getattr(self, f"Conv_{i}"), t.transpose(1, 2), (1, 1))
            if self.batch_norm:
                x = getattr(self, f"BatchNorm_{i}")(x, train)
            elif self.layer_norm:
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = kinks.leaky_relu(x, 0.2)
        return conv_last(getattr(self, self.out_name), x, (1, 1)).transpose(1, 2)
