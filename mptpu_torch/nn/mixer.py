"""The MLP-Mixer stack with attention over blocks (counterpart of
``mptpu/nn/mixer.py``). Channels-last; children carry flax's names.

Dropout (rate 0.1 at the input of every ``MixerBlock``) is off with
``deterministic=True``; otherwise its masks come, in call order, from
``masks`` or from ``generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device, no_tf32
from .init import flax_linear, uniform_init
from .layers import LayerNorm, Masks, dropout


class MixerBlock(nn.Module):
    """Token mixing (``Dense_0`` from the sequence to the channels, then
    ``Dense_1`` back) beside channel mixing of ``x`` plus a learned
    position (``Dense_2``), ``elu`` of their sum with ``x``, then
    ``LayerNorm_0``."""

    def __init__(self, channels: int, sequence_length: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.pos = nn.Parameter(uniform_init((1, sequence_length, channels), 0.01, gen)
                                .to(default_device(device)))
        self.Dense_0 = flax_linear(sequence_length, channels, True, gen, device)
        self.Dense_1 = flax_linear(channels, sequence_length, True, gen, device)
        self.Dense_2 = flax_linear(channels, channels, True, gen, device)
        self.LayerNorm_0 = LayerNorm(channels, device=device)

    def forward(self, x: torch.Tensor, deterministic: bool = True, masks: Masks = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(x, 0.1, deterministic, masks, generator)
        with no_tf32():
            tr = self.Dense_1(self.Dense_0(x.transpose(1, 2))).transpose(1, 2)
            h = self.Dense_2(x + self.pos)
        return self.LayerNorm_0(F.elu(h + tr + x))


class MixerAttention(nn.Module):
    """``n_modules`` mixer blocks, their outputs weighted by a softmax over
    blocks computed from the input (``Dense_0`` to one channel, ``Dense_1``
    from the sequence to the blocks)."""

    def __init__(self, channels: int, sequence_length: int, n_modules: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.sequence_length, self.n_modules = sequence_length, n_modules
        self.Dense_0 = flax_linear(channels, 1, True, gen, device)
        self.Dense_1 = flax_linear(sequence_length, n_modules, True, gen, device)
        for i in range(n_modules):
            self.add_module(f"MixerBlock_{i}", MixerBlock(channels, sequence_length, gen, device))

    def forward(self, x: torch.Tensor, deterministic: bool = True, masks: Masks = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        with no_tf32():
            attn = self.Dense_0(x).reshape(-1, self.sequence_length)
            attn = self.Dense_1(attn).reshape(-1, self.n_modules, 1, 1)
        attn = torch.softmax(attn, dim=1)
        outputs = torch.stack([getattr(self, f"MixerBlock_{i}")(x, deterministic, masks, generator)
                               for i in range(self.n_modules)], dim=1)
        return torch.sum(outputs * attn, dim=1)


class MixerStack(nn.Module):
    """(batch, seq, in_channels) -> (batch, seq, channels): ``Dense_0`` in,
    ``layers`` attention layers, ``Dense_1`` out; ``channels_last=False``
    takes and gives (batch, channels, seq)."""

    def __init__(self, in_channels: int, channels: int, sequence_length: int, layers: int,
                 attn_blocks: int, channels_last: bool = True,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.layers, self.channels_last = layers, channels_last
        self.Dense_0 = flax_linear(in_channels, channels, True, gen, device)
        for i in range(layers):
            self.add_module(f"MixerAttention_{i}", MixerAttention(
                channels, sequence_length, attn_blocks, gen, device))
        self.Dense_1 = flax_linear(channels, channels, True, gen, device)

    def forward(self, x: torch.Tensor, deterministic: bool = True, masks: Masks = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.channels_last:
            x = x.transpose(1, 2)
        with no_tf32():
            x = self.Dense_0(x)
        for i in range(self.layers):
            x = getattr(self, f"MixerAttention_{i}")(x, deterministic, masks, generator)
        with no_tf32():
            x = self.Dense_1(x)
        return x if self.channels_last else x.transpose(1, 2)
