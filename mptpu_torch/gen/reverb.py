"""Convolution reverb: an impulse-response bank, a room chosen by softmax
or sparse softmax, a dry/wet mix (counterpart of ``mptpu/gen/reverb.py``).

The bank is read from the WAVs of ``config.impulse_response_path()``;
without that directory it is eight synthetic rooms, exponentially decaying
noise drawn by numpy from ``default_rng(0)`` exactly as ``mptpu`` draws
them, so both packages hold the same bank.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import impulse_response_path
from ..device import default_device
from ..nn.init import uniform
from ..nn.linear import LinearOutputStack
from ..ops.fft import simple_fft_convolve
from ..ops.ste import sparse_softmax
from ..utils.wav import read_wav


def _synthetic_rooms(n_rooms: int, n_samples: int, seed: int = 0) -> np.ndarray:
    """Exponentially decaying noise impulse responses of varying RT60."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_rooms, n_samples), dtype=np.float32)
    for i in range(n_rooms):
        decay = np.exp(-np.linspace(0, rng.uniform(4.0, 30.0), n_samples))
        out[i] = rng.standard_normal(n_samples) * decay * 0.1
    return out


def load_impulse_responses(path: Optional[str], n_samples: int, n_fallback_rooms: int = 8,
                           normalize: bool = False) -> np.ndarray:
    """(n_rooms, n_samples) float32 bank: every ``*.wav`` of ``path`` in
    sorted order, mono, cut or zero-padded to ``n_samples``; the synthetic
    rooms when there is none."""
    audio = []
    if path and os.path.isdir(path):
        for p in sorted(glob.iglob(os.path.join(path, "*.wav"))):
            a, _ = read_wav(p, mono=True)
            a = np.pad(a, (0, n_samples - len(a))) if len(a) < n_samples else a[:n_samples]
            audio.append(a[None, :])
    if not audio:
        rooms = _synthetic_rooms(n_fallback_rooms, n_samples)
    else:
        rooms = np.concatenate(audio, axis=0).astype(np.float32)
    if normalize:
        rooms = rooms / (np.max(rooms, axis=-1, keepdims=True) + 1e-8)
    return rooms


class NeuralReverb(nn.Module):
    """A room bank mixed by ``reverb_mix`` (batch, n_rooms) and applied to
    ``x`` by an ortho FFT convolution. ``impulses`` (n_rooms, size) are a
    fixed buffer; without them the rooms are a parameter uniform in
    [-0.01, 0.01) from ``generator``."""

    def __init__(self, size: int, n_rooms: int, impulses: Optional[np.ndarray] = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = default_device(device)
        if impulses is None:
            gen = generator or torch.Generator().manual_seed(0)
            self.rooms = nn.Parameter(uniform((n_rooms, size), -0.01, 0.01, gen).to(dev))
        else:
            self.register_buffer("rooms", torch.from_numpy(np.asarray(impulses, np.float32)).to(dev))

    def forward(self, x: torch.Tensor, reverb_mix: torch.Tensor) -> torch.Tensor:
        mix = reverb_mix[:, None, :] @ self.rooms   # (batch, 1, size)
        wet = simple_fft_convolve(mix, x.reshape(mix.shape[0], -1, mix.shape[-1]))
        return wet.reshape(x.shape)


class ReverbGenerator(nn.Module):
    """Context vectors -> (a room by softmax, a dry/wet pair by softmax) ->
    reverb. ``to_mix`` and ``to_room`` are ``LinearOutputStack``s of
    ``channels`` wide, ``layers`` deep: the context is ``channels`` wide."""

    def __init__(self, channels: int, layers: int, samplerate: int, n_samples: int,
                 hard_choice: bool = False, n_rooms: Optional[int] = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.hard_choice = hard_choice
        rooms = load_impulse_responses(impulse_response_path(), n_samples,
                                       n_fallback_rooms=n_rooms or 8)
        self.n_rooms = rooms.shape[0]
        self.verb = NeuralReverb(n_samples, self.n_rooms, impulses=rooms, device=device)
        self.to_mix = LinearOutputStack(channels, layers, out_channels=2, generator=gen,
                                        device=device)
        self.to_room = LinearOutputStack(channels, layers, out_channels=self.n_rooms,
                                         generator=gen, device=device)

    def forward(self, context: torch.Tensor, dry: torch.Tensor, return_parameters: bool = False):
        room_logits = self.to_room(context).reshape(-1, self.n_rooms)
        if self.hard_choice:
            rm = sparse_softmax(room_logits, normalize=True, axis=-1)
        else:
            rm = torch.softmax(room_logits, dim=-1)
        mx = torch.softmax(self.to_mix(context), dim=-1)
        wet = self.verb(dry, rm)
        stacked = torch.stack([dry, wet], dim=-1)
        mx = mx.reshape(stacked.shape[0], stacked.shape[1], 1, 2)
        mixed = torch.sum(stacked * mx, dim=-1)
        if return_parameters:
            return mixed, rm, mx
        return mixed
