"""DDSP-style audio models, learned oscillator banks with noise and reverb
(counterpart of ``mptpu/gen/audiomodel.py``). Children carry flax's names.

The oscillators' phase is a running sum over every sample, thousands of
radians by the end, where float32 keeps about 1e-3 rad: comparisons across
packages or devices hold these models in float64.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import impulse_response_path
from ..device import no_tf32
from ..nn.init import uniform_linear
from ..nn.linear import LinearOutputStack
from ..ops.upsample import interpolate_last_axis
from .impulse import NoiseModel
from .reverb import NeuralReverb, load_impulse_responses


class OscillatorBank(nn.Module):
    """(batch, input_channels, frames) -> (batch, 1, n_audio_samples): per
    frame an amplitude (``Dense_0``) and a frequency (``Dense_1``) for each
    of ``n_osc`` sines (sigmoids, a squared amplitude, or with
    ``complex_valued`` the magnitude and angle of the pair), the
    frequencies optionally held within evenly or geometrically spaced bands
    from ``lowest_freq`` (``constrain``), upsampled, the sines' mean."""

    def __init__(self, input_channels: int, n_osc: int, n_audio_samples: int,
                 constrain: bool = False, log_frequency: bool = False, lowest_freq: float = 0.01,
                 complex_valued: bool = False, amp_squared: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.input_channels, self.n_osc, self.n_audio_samples = (input_channels, n_osc,
                                                                  n_audio_samples)
        self.constrain, self.complex_valued, self.amp_squared = (constrain, complex_valued,
                                                                 amp_squared)
        self.Dense_0 = uniform_linear(input_channels, n_osc, True, 0.1, gen, device)
        self.Dense_1 = uniform_linear(input_channels, n_osc, True, 0.1, gen, device)
        bands = (np.geomspace if log_frequency else np.linspace)(lowest_freq, 1, n_osc)
        self.bands, self.spans = bands, np.diff(np.concatenate([[0], bands]))

    def forward(self, x: torch.Tensor, return_params: bool = False):
        xt = x.reshape(x.shape[0], self.input_channels, -1).transpose(1, 2)
        with no_tf32():
            amp = self.Dense_0(xt).transpose(1, 2)
            freq = self.Dense_1(xt).transpose(1, 2)
        if self.complex_valued:
            amp, freq = torch.sqrt(amp**2 + freq**2), torch.atan2(freq, amp) / math.pi
        else:
            amp = amp**2 if self.amp_squared else torch.sigmoid(amp)
            freq = torch.sigmoid(freq)
        if self.constrain:
            bands, spans = (torch.from_numpy(a).to(freq.device, freq.dtype)[None, :, None]
                            for a in (self.bands, self.spans))
            freq = bands + freq * spans
        amp_params, freq_params = amp, freq
        amp = interpolate_last_axis(amp, self.n_audio_samples)
        freq = interpolate_last_axis(freq, self.n_audio_samples)
        sig = torch.sin(torch.cumsum(freq * math.pi, dim=-1)) * amp
        out = torch.mean(sig, dim=1, keepdim=True)
        if return_params:
            return out, freq_params, amp_params
        return out


class AudioModel(nn.Module):
    """(batch, model_dim, n_frames) -> (batch, 1, n_samples): a constrained
    oscillator bank (``OscillatorBank_0``) plus filtered noise
    (``NoiseModel_0``), mixed dry / wet (``LinearOutputStack_1``) with a
    room from the impulse-response bank chosen by softmax
    (``LinearOutputStack_0``). The bank is ``load_impulse_responses`` of
    ``config.impulse_response_path()``, eight synthetic rooms without it.
    ``noise`` is the (batch, n_samples) uniform draw of the noise model."""

    def __init__(self, n_samples: int, model_dim: int, samplerate: int, n_frames: int,
                 n_noise_frames: int, complex_valued_osc: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_samples, self.model_dim, self.n_frames = n_samples, model_dim, n_frames
        rooms = load_impulse_responses(impulse_response_path(), n_samples)
        self.LinearOutputStack_0 = LinearOutputStack(model_dim, 1, out_channels=rooms.shape[0],
                                                     generator=gen, device=device)
        self.LinearOutputStack_1 = LinearOutputStack(model_dim, 1, out_channels=1,
                                                     generator=gen, device=device)
        self.OscillatorBank_0 = OscillatorBank(model_dim, model_dim, n_samples, constrain=True,
                                               lowest_freq=40 / (samplerate // 2),
                                               amp_squared=True,
                                               complex_valued=complex_valued_osc,
                                               generator=gen, device=device)
        self.NoiseModel_0 = NoiseModel(model_dim, n_frames, n_noise_frames, n_samples, model_dim,
                                       squared=True, mask_after=1, generator=gen, device=device)
        self.NeuralReverb_0 = NeuralReverb(n_samples, rooms.shape[0], impulses=rooms,
                                           device=device)

    def noise_shape(self, batch: int):
        return (batch, self.n_samples)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.reshape(-1, self.model_dim, self.n_frames)
        agg = torch.mean(x, dim=-1)
        with no_tf32():
            room = torch.softmax(self.LinearOutputStack_0(agg), dim=-1)
            mix = torch.sigmoid(self.LinearOutputStack_1(agg)).reshape(-1, 1, 1)
        dry = self.OscillatorBank_0(x) + self.NoiseModel_0(x, noise, generator)
        wet = self.NeuralReverb_0(dry, room.to(dry.dtype))
        return dry * mix + wet * (1 - mix)
