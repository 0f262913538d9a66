"""The remaining event generators of the SIAM decoder family (counterpart
of ``mptpu/gen/event_variants.py``): a latent-frame lookup rendered by
per-frame magnitudes and a dithered group-delay phase, per-band learned
wavetables deformed over time, and a latent plus positional table rendered
by magnitudes and a noisy phase. Children carry flax's names.

The dither and phase noise, uniform in [-1, 1), are the caller's draws
(``noise``) or come from a ``torch.Generator``. Every ``jnp.abs`` of a
differentiated tensor is ``ops.kinks.abs``, for JAX's gradient at 0.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import impulse_response_path
from ..device import default_device, no_tf32
from ..nn.init import uniform, uniform_init, uniform_linear
from ..nn.linear import LinearOutputStack
from ..ops import kinks
from ..ops.decompose import fft_frequency_recompose
from ..ops.fft import cexp, fft_convolve, real_ends
from ..ops.overlap_add import overlap_add
from ..ops.phase import mag_phase_recomposition
from ..ops.windows import linspace
from .generator import EventGenerator, ShapeSpec
from .overfitresonance import Deformations, Lookup
from .reverb import load_impulse_responses
from .schedule import DiracScheduler


def _noise(noise, shape, generator, like: torch.Tensor) -> torch.Tensor:
    if noise is None:
        noise = uniform(shape, -1.0, 1.0, generator, like.device)
    return noise.to(like.device, like.dtype)


class _DecayedNoiseLookup(Lookup):
    """Items (n_items, latent_dim * frames): uniform noise in [-0.01, 0.01)
    under ``linspace(1, 0, frames) ** d``, one decay ``d`` in [2, 200) per
    item and latent channel."""

    def __init__(self, n_items: int, n_samples: int, selection_type: str = "relu",
                 latent_dim: int = 32, frames: int = 128,
                 generator: torch.Generator | None = None, device=None):
        gen = generator or torch.Generator().manual_seed(0)
        nn.Module.__init__(self)
        self.selection_type = selection_type
        noise = uniform((n_items, latent_dim, frames), -0.01, 0.01, gen)
        env = linspace(1.0, 0.0, frames, device="cpu").reshape(1, 1, -1)
        decay = uniform((n_items, latent_dim, 1), 2.0, 200.0, gen)
        self.items = nn.Parameter((noise * env**decay).reshape(n_items, -1)
                                  .to(default_device(device)))


class AudioModelEventGenerator(nn.Module, EventGenerator):
    """``forward(params, times, amp, noise=None, generator=None)``: params
    (batch, n_events, n_items) select latent frames (``items``) and phase
    frames (``phase_items``); per frame ``|to_mag(latent)|`` and a phase
    that advances by a group delay from 0 to pi, perturbed by
    ``to_phase`` times the dither ``noise`` ((batch n_events, n_frames,
    n_coeffs), uniform in [-1, 1)); inverse rFFTs, overlap-add, times
    ``|amp|``, placed by a dirac scheduler: (batch, n_events, n_samples)."""

    def __init__(self, n_items: int, n_samples: int, n_frames: int, n_events: int,
                 context_dim: int, latent_dim: int = 32,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_items, self.n_samples, self.n_frames = n_items, n_samples, n_frames
        self.n_events, self.latent_dim = n_events, latent_dim
        self.window = (n_samples // n_frames) * 2
        self.n_coeffs = self.window // 2 + 1
        self.items = _DecayedNoiseLookup(n_items, latent_dim * n_frames, "relu", latent_dim,
                                         n_frames, gen, device)
        self.phase_items = Lookup(n_items, latent_dim * n_frames, selection_type="relu",
                                  generator=gen, device=device)
        self.to_mag = uniform_linear(latent_dim, self.n_coeffs, True, 0.1, gen, device)
        self.to_phase = uniform_linear(latent_dim, self.n_coeffs, True, 0.1, gen, device)
        self.scheduler = DiracScheduler(n_events, start_size=n_frames, n_samples=n_samples,
                                        pre_sparse=True)

    @property
    def shape_spec(self) -> ShapeSpec:
        return dict(params=(self.n_items,), amp=(1,))

    def noise_shape(self, batch: int):
        """The dither's shape for ``batch`` items of ``n_events`` events."""
        return (batch * self.n_events, self.n_frames, self.n_coeffs)

    def forward(self, params, times, amp, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        batch = params.shape[0]
        lat = self.items(params).reshape(-1, self.latent_dim, self.n_frames).transpose(1, 2)
        pi = self.phase_items(params).reshape(-1, self.latent_dim, self.n_frames).transpose(1, 2)
        with no_tf32():
            mag = kinks.abs(self.to_mag(lat))
            phase = self.to_phase(pi)
        group_delay = linspace(0.0, math.pi, self.n_coeffs, device=phase.device,
                               dtype=phase.dtype)
        phase = phase * group_delay * 1e-3
        phase = group_delay[None, None, :] + phase * _noise(noise, phase.shape, generator, phase)
        phase = torch.cumsum(phase, dim=1)
        frames = torch.fft.irfft(real_ends(mag * cexp(phase)), n=self.window, dim=-1)
        audio = overlap_add(frames[:, None, :, :])[..., :self.n_samples]
        audio = audio.reshape(batch, -1, self.n_samples) * kinks.abs(amp)
        return self.scheduler.schedule(times, audio)


class WavetableModel(nn.Module, EventGenerator):
    """``forward(params, times)``: per octave band from ``lowest_band`` to
    ``wavetable_samples // 2`` a learned table (``band_{size}``) mixed by
    ``params["mix"]``, recomposed to ``wavetable_samples``, padded to
    ``n_samples``, deformed over time by ``warp`` (``Deformations``),
    mixed dry / wet with a room of the impulse-response bank (``verb``),
    times ``|amplitudes|``, placed by a dirac scheduler."""

    def __init__(self, n_items: int, n_samples: int, n_frames: int, n_events: int,
                 expressivity: int, n_deformations: int = 128, wavetable_samples: int = 16384,
                 lowest_band: int = 512, generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_items, self.n_samples, self.n_frames = n_items, n_samples, n_frames
        self.n_events, self.expressivity = n_events, expressivity
        self.n_deformations, self.wavetable_samples = n_deformations, wavetable_samples
        start = int(np.log2(lowest_band))
        self.n_bands = int(np.log2(wavetable_samples)) - start
        self.band_sizes = [2 ** (start + i) for i in range(self.n_bands)]
        for size in self.band_sizes:
            self.add_module(f"band_{size}", Lookup(n_items, size, selection_type="identity",
                                                   init_scale=0.1, generator=gen, device=device))
        self.warp = Deformations(128, expressivity * 128, full_size=n_samples,
                                 channels=expressivity, frames=128, generator=gen, device=device)
        verbs = load_impulse_responses(impulse_response_path(), n_samples)
        self.verb = Lookup(verbs.shape[0], n_samples, fixed_items=verbs, selection_type="softmax",
                           device=device)
        self.scheduler = DiracScheduler(n_events, start_size=n_frames, n_samples=n_samples,
                                        pre_sparse=True)

    @property
    def shape_spec(self) -> ShapeSpec:
        return dict(amplitudes=(1,), mix=(self.expressivity, self.n_items * self.n_bands),
                    warp=(self.n_deformations,), room_choice=(8,), room_mix=(2,))

    def forward(self, p: Dict[str, torch.Tensor], times: torch.Tensor) -> torch.Tensor:
        batch = p["amplitudes"].shape[0]
        bands = {}
        for i, size in enumerate(self.band_sizes):
            mx = p["mix"][:, :, :, i * self.n_items:(i + 1) * self.n_items]
            bands[size] = getattr(self, f"band_{size}")(mx).reshape(batch, self.expressivity, -1)
        dry = fft_frequency_recompose(bands, self.wavetable_samples)
        dry = dry.reshape(batch, self.expressivity, -1)
        dry = torch.nn.functional.pad(dry, (0, self.n_samples - dry.shape[-1]))
        d, _ = self.warp(p["warp"])
        dry = torch.sum(dry[:, None, :, :] * d, dim=2)
        wet = fft_convolve(dry, self.verb(p["room_choice"]))
        mix = torch.softmax(p["room_mix"], dim=-1)
        final = torch.sum(torch.stack([dry, wet], dim=-1) * mix[:, :, None, :], dim=-1)
        final = final.reshape(batch, -1, self.n_samples) * kinks.abs(p["amplitudes"])
        return self.scheduler.schedule(times, final)


class SimpleEventGenerator(nn.Module, EventGenerator):
    """``forward(param, times, noise=None, generator=None)``: an event vector
    (``Dense_0``) plus a positional table (``pos``) per frame through a
    residual MLP (``LinearOutputStack_0``) to magnitudes and phase
    advances, the advances ``1 + advance * noise`` (noise uniform in
    [-1, 1), one per frame and coefficient), recomposed, inverse rFFTs,
    windowed overlap-add, placed by a dirac scheduler."""

    def __init__(self, context_dim: int, n_frames: int, n_samples: int, n_events: int,
                 channels: int, window_size: int = 512,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.context_dim, self.n_frames, self.n_samples = context_dim, n_frames, n_samples
        self.n_events, self.channels, self.window_size = n_events, channels, window_size
        self.n_coeffs = window_size // 2 + 1
        self.pos = nn.Parameter(uniform_init((1, n_frames, channels), 0.01, gen)
                                .to(default_device(device)))
        self.Dense_0 = uniform_linear(context_dim, channels, True, 0.1, gen, device)
        self.LinearOutputStack_0 = LinearOutputStack(channels, 3, out_channels=self.n_coeffs * 2,
                                                     in_channels=channels, generator=gen,
                                                     device=device)
        self.scheduler = DiracScheduler(n_events, start_size=n_frames, n_samples=n_samples,
                                        pre_sparse=True)

    @property
    def shape_spec(self) -> ShapeSpec:
        return dict(param=(self.context_dim,))

    def noise_shape(self, batch: int):
        """The phase noise's shape for ``batch`` items of ``n_events`` events."""
        return (batch * self.n_events, self.n_frames, self.n_coeffs, 1)

    def forward(self, param, times, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        batch = param.shape[0]
        with no_tf32():
            # any event axis folds into the batch: one event vector per row
            x = self.Dense_0(param).reshape(-1, 1, self.channels) + self.pos
            x = self.LinearOutputStack_0(x)
        x = x.reshape(-1, self.n_frames, self.n_coeffs, 2)
        mags = kinks.abs(x[..., 0:1])
        phase = x[..., 1:]
        phase = torch.ones_like(phase) + phase * _noise(noise, phase.shape, generator, phase)
        freqs = linspace(0.0, 1.0, self.n_coeffs, device=x.device, dtype=x.dtype)
        spec = mag_phase_recomposition(torch.cat([mags, phase], dim=-1), freqs)
        frames = torch.fft.irfft(real_ends(spec), n=self.window_size, dim=-1)
        frames = frames.reshape(-1, 1, self.n_frames, self.window_size)
        audio = overlap_add(frames, apply_window=True)[..., :self.n_samples]
        return self.scheduler.schedule(times, audio.reshape(batch, -1, self.n_samples))
