"""The SIAM decoder, ``OverfitResonanceModel``, and its lookup components
(counterpart of ``mptpu/gen/overfitresonance.py``).

The decoder renders one event from its heads' outputs: noise excitation
-> a noise-filter convolution mixed by deformations -> a long resonance
convolution mixed by deformations -> dry / wet mixes -> reverb from a
fixed room bank -> placement at its frame by a dirac scheduler -> a fine
fractional shift.

The envelopes' noise is the one draw of a forward: ``noise`` (broadcasting
against (batch, n_events, min(8192, n_samples))) or, when it is not
given, a uniform draw in [-1, 1) from ``generator``. A trained model has
memorised its training draw, so a caller that scores one passes that
draw. Parameters are drawn from a CPU ``torch.Generator`` (default seed
0) in the ranges ``mptpu`` draws from, not its numbers;
``convert.siam_from_flax`` carries those. Children and parameters carry
flax's names. ``mptpu``'s ``hierarchical_scheduling`` option is not
ported: no model turns it on.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import impulse_response_path
from ..device import default_device, no_tf32
from ..nn.init import uniform, uniform_init, uniform_linear
from ..ops import kinks
from ..ops.fft import fft_convolve, fft_shift, real_ends
from ..ops.norms import unit_norm
from ..ops.ste import sparse_softmax
from ..ops.upsample import ensure_last_axis_length, interpolate_last_axis
from ..ops.windows import hamming_window, linspace
from ..sparse.quantize import select_items
from .generator import EventGenerator, ShapeSpec
from .reverb import load_impulse_responses
from .schedule import DiracScheduler
from .transfer import damped_harmonic_oscillator


def flatten_envelope(x: torch.Tensor, kernel_size: int, step_size: int) -> torch.Tensor:
    """``x`` over its peak magnitude, divided by its envelope: the running
    maximum of |x| over windows of ``kernel_size`` every ``step_size``
    samples (``-inf`` padding of ``step_size`` on each side), interpolated
    back to ``x``'s length."""
    env = kinks.abs(x)
    normalized = x / (torch.amax(env, dim=-1, keepdim=True) + 1e-3)
    padded = F.pad(env, (step_size, step_size), value=float("-inf"))
    pooled = padded.unfold(-1, kernel_size, step_size).amax(dim=-1)
    return normalized * interpolate_last_axis(1.0 / pooled, x.shape[-1])


class Lookup(nn.Module):
    """An item table (a parameter ``items``, or a fixed buffer) and a
    selection matrix product: ``hard_choice(selections) @ items``."""

    def __init__(self, n_items: int, n_samples: int, selection_type: str = "softmax",
                 fixed_items: Optional[np.ndarray] = None, init_scale: float = 0.02,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = default_device(device)
        self.selection_type = selection_type
        if fixed_items is not None:
            self.register_buffer("items", torch.from_numpy(np.asarray(fixed_items, np.float32))
                                 .to(dev), persistent=False)
        else:
            gen = generator or torch.Generator().manual_seed(0)
            self.items = nn.Parameter(uniform_init((n_items, n_samples), init_scale, gen).to(dev))

    def preprocess_items(self, items: torch.Tensor) -> torch.Tensor:
        return items

    def postprocess_results(self, selected: torch.Tensor, noise=None, generator=None):
        return selected

    def forward(self, selections: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None):
        items = self.preprocess_items(self.items)
        with no_tf32():
            selected = select_items(selections, items, self.selection_type)
        return self.postprocess_results(selected, noise, generator)


class SampleLookup(Lookup):
    """A table of audio samples, each unit-normed (after an optional
    envelope flattening and Hamming window)."""

    def __init__(self, n_items: int, n_samples: int, flatten_kernel_size: Optional[int] = None,
                 windowed: bool = False, selection_type: str = "relu", init_scale: float = 1.0,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(n_items, n_samples, selection_type, None, init_scale, generator, device)
        self.flatten_kernel_size = flatten_kernel_size
        self.windowed = windowed

    def preprocess_items(self, items: torch.Tensor) -> torch.Tensor:
        x = items
        if self.flatten_kernel_size:
            x = flatten_envelope(x, self.flatten_kernel_size, self.flatten_kernel_size // 2)
        if self.windowed:
            x = x * hamming_window(x.shape[-1], dtype=x.dtype, device=x.device)
        return unit_norm(x)


class Envelopes(Lookup):
    """Energy-injection envelopes: the selection is cut into ``max_events``
    segments that are summed, upsampled to ``full_size``, multiplied by the
    noise (``with_noise``; otherwise each segment is a sparse softmax
    first) and padded to ``padded_size``."""

    def __init__(self, n_items: int, n_samples: int, full_size: int = 8192,
                 padded_size: int = 32768, max_events: int = 32, with_noise: bool = False,
                 selection_type: str = "relu", generator: torch.Generator | None = None,
                 device=None):
        super().__init__(n_items, n_samples, selection_type, None, 0.02, generator, device)
        self.full_size = full_size
        self.padded_size = padded_size
        self.max_events = max_events
        self.with_noise = with_noise

    def postprocess_results(self, envelope, noise=None, generator=None):
        amp = envelope.reshape(*envelope.shape[:-1], self.max_events, -1)
        if not self.with_noise:
            amp = sparse_softmax(amp, axis=-1, normalize=False)
        amp = interpolate_last_axis(torch.sum(amp, dim=-2), self.full_size)
        if self.with_noise:
            if noise is None:
                if generator is None:
                    raise ValueError("Envelopes(with_noise=True) needs noise or a generator")
                noise = uniform(amp.shape, -1.0, 1.0, generator).to(amp.device, amp.dtype)
            amp = amp * noise
        return ensure_last_axis_length(amp, self.padded_size)


class Deformations(Lookup):
    """Time-varying weights over ``channels`` expressivity channels: the
    selection as (channels, frames), cumulated over frames, a softmax over
    channels, upsampled to ``full_size``. Returns (weights, weights before
    the upsampling)."""

    def __init__(self, n_items: int, n_samples: int, full_size: int = 32768,
                 channels: int = 1, frames: int = 1, selection_type: str = "relu",
                 generator: torch.Generator | None = None, device=None):
        super().__init__(n_items, n_samples, selection_type, None, 0.02, generator, device)
        self.full_size = full_size
        self.channels = channels
        self.frames = frames

    def postprocess_results(self, items, noise=None, generator=None):
        x = items.reshape(*items.shape[:-1], self.channels, self.frames)
        x = torch.softmax(torch.cumsum(x, dim=-1), dim=-2)
        return interpolate_last_axis(x, self.full_size), x


class DampedHarmonicOscillatorBlock(nn.Module):
    """A bank of (oscillators, resonances, expressivity) damped oscillators
    over a grid of 10 time units, summed over the oscillators: (1, 1,
    resonances, expressivity, n_samples)."""

    RANGES = dict(damping=(0.5, 1.5), mass=(-2.0, 2.0), tension=(4.0, 9.0),
                  initial_displacement=(-1.0, 2.0), amplitudes=(-1.0, 1.0))

    def __init__(self, n_samples: int, n_oscillators: int, n_resonances: int, expressivity: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        self.n_samples = n_samples
        self.n_resonances = n_resonances
        self.expressivity = expressivity
        shape = (n_oscillators, n_resonances, expressivity)
        for name, (lo, hi) in self.RANGES.items():
            s = shape + (1,) if name == "amplitudes" else shape
            setattr(self, name, nn.Parameter(uniform(s, lo, hi, gen).to(dev)))

    def forward(self, tension_modifier: Optional[torch.Tensor] = None,
                scaling: Optional[torch.Tensor] = None) -> torch.Tensor:
        time = linspace(0, 10, self.n_samples, device=self.tension.device).reshape(1, 1, 1, -1)
        t = self.tension[..., None]
        if tension_modifier is not None:
            t = t + tension_modifier[0] * scaling
        x = damped_harmonic_oscillator(
            time=time,
            mass=torch.sigmoid(self.mass[..., None]) * 2,
            damping=torch.sigmoid(self.damping[..., None]) * 30,
            tension=10**t,
            initial_displacement=self.initial_displacement[..., None],
            initial_velocity=0.0,
            do_clamp=False,
        )
        x = torch.sum(x * self.amplitudes, dim=0)
        return x.reshape(1, 1, self.n_resonances, self.expressivity, self.n_samples)


class DampedHarmonicOscillatorStack(nn.Module):
    """Two oscillator blocks; the second's tensions are modulated by the
    first's output times ``influence``."""

    def __init__(self, n_samples: int, n_oscillators: int, n_resonances: int, expressivity: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        shape = (n_oscillators, n_resonances, expressivity, 1)
        self.influence = nn.Parameter(uniform_init(shape, 0.01, gen).to(default_device(device)))
        self.DampedHarmonicOscillatorBlock_0 = DampedHarmonicOscillatorBlock(
            n_samples, n_oscillators, n_resonances, expressivity, gen, device)
        self.DampedHarmonicOscillatorBlock_1 = DampedHarmonicOscillatorBlock(
            n_samples, n_oscillators, n_resonances, expressivity, gen, device)

    def forward(self) -> torch.Tensor:
        x = self.DampedHarmonicOscillatorBlock_0()
        return self.DampedHarmonicOscillatorBlock_1(x, self.influence)


class DampedHarmonicOscillatorResonance(nn.Module):
    """Latent (batch, n_events, expressivity, latent) -> a Dense selection
    over the oscillator stack's resonances -> (batch, n_events,
    expressivity, n_samples)."""

    def __init__(self, latent_dim: int, n_samples: int, n_oscillators: int, n_resonances: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_samples = n_samples
        self.n_resonances = n_resonances
        self.Dense_0 = uniform_linear(latent_dim, n_resonances, True, 0.1, gen, device)
        self.DampedHarmonicOscillatorStack_0 = DampedHarmonicOscillatorStack(
            n_samples, n_oscillators, n_resonances, 1, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, n_events, expressivity, _ = x.shape
        res = self.DampedHarmonicOscillatorStack_0().reshape(
            1, 1, 1, self.n_resonances, self.n_samples)
        with no_tf32():
            out = self.Dense_0(x) @ res
        return out.reshape(batch, n_events, expressivity, self.n_samples)


class SpectralResonance(nn.Module):
    """Latent -> a Dense to the real and imaginary parts of an rFFT ->
    resonance samples (batch, n_events, expressivity, n_samples). The end
    coefficients' imaginary parts are learned numbers, which an inverse
    real FFT drops (``ops.fft.real_ends``)."""

    def __init__(self, latent_dim: int, n_samples: int, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_samples = n_samples
        self.n_coeffs = n_samples // 2 + 1
        self.Dense_0 = uniform_linear(latent_dim, self.n_coeffs * 2, True, 0.1, gen, device)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        batch, n_events, expressivity, _ = latent.shape
        with no_tf32():
            coeffs = self.Dense_0(latent)
        coeffs = coeffs.reshape(batch, n_events, expressivity, self.n_coeffs, 2)
        spec = torch.complex(coeffs[..., 0], coeffs[..., 1])
        return torch.fft.irfft(real_ends(spec), n=self.n_samples, dim=-1) * math.sqrt(
            self.n_samples)


class OverfitResonanceModel(nn.Module, EventGenerator):
    """The SIAM event decoder. ``forward(params, times, noise=None,
    generator=None, return_intermediates=False)``: ``params`` match
    ``shape_spec`` ((batch, n_events, *shape) each), ``times`` are
    (batch, n_events, n_frames); returns (batch, n_events, n_samples).

    The room bank is ``gen.reverb.load_impulse_responses`` of
    ``config.impulse_response_path()``, each room max-normed; without that
    directory it is the eight synthetic rooms."""

    def __init__(self, n_noise_filters: int, noise_expressivity: int, noise_filter_samples: int,
                 noise_deformations: int, instr_expressivity: int, n_events: int,
                 n_resonances: int, n_envelopes: int, n_deformations: int, n_samples: int,
                 n_frames: int, samplerate: int, hidden_channels: int, context_dim: int,
                 fine_positioning: bool = False, fft_resonance: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_noise_filters = n_noise_filters
        self.noise_expressivity = noise_expressivity
        self.noise_deformations = noise_deformations
        self.instr_expressivity = instr_expressivity
        self.n_events = n_events
        self.n_envelopes = n_envelopes
        self.n_deformations = n_deformations
        self.n_samples = n_samples
        self.n_frames = n_frames
        self.context_dim = context_dim
        self.fine_positioning = fine_positioning
        verbs = load_impulse_responses(impulse_response_path(), n_samples, normalize=True)
        self.n_verbs = verbs.shape[0]

        self.envelopes = Envelopes(n_envelopes, 128 * 32, full_size=min(8192, n_samples),
                                   padded_size=n_samples, max_events=32, with_noise=True,
                                   generator=gen, device=device)
        self.noise_lookup = SampleLookup(n_noise_filters, noise_filter_samples, windowed=False,
                                         generator=gen, device=device)
        self.noise_warp = Deformations(noise_deformations, noise_expressivity * n_frames,
                                       full_size=n_samples, channels=noise_expressivity,
                                       frames=n_frames, generator=gen, device=device)
        if fft_resonance:
            self.resonance = SpectralResonance(context_dim, n_samples, gen, device)
        else:
            self.resonance = DampedHarmonicOscillatorResonance(
                latent_dim=context_dim, n_samples=n_samples, n_oscillators=1,
                n_resonances=n_resonances, generator=gen, device=device)
        self.warp = Deformations(n_deformations, instr_expressivity * n_frames,
                                 full_size=n_samples, channels=instr_expressivity,
                                 frames=n_frames, generator=gen, device=device)
        self.verb = Lookup(self.n_verbs, n_samples, selection_type="relu", fixed_items=verbs,
                           device=device)
        self.scheduler = DiracScheduler(n_events, start_size=n_frames, n_samples=n_samples,
                                        pre_sparse=True)

    @property
    def shape_spec(self) -> ShapeSpec:
        params = dict(
            noise_resonance=(self.noise_expressivity, self.n_noise_filters),
            noise_deformations=(self.noise_deformations,),
            deformations=(self.n_deformations,),
            envelopes=(self.n_envelopes,),
            noise_mixes=(2,),
            resonances=(self.instr_expressivity, self.context_dim),
            res_filter=(self.noise_expressivity, self.n_noise_filters),
            mixes=(2,),
            amplitudes=(1,),
            room_choice=(self.n_verbs,),
            room_mix=(2,),
        )
        if self.fine_positioning:
            params["fine"] = (1,)
        return params

    def forward(self, params: Dict[str, torch.Tensor], times: torch.Tensor,
                noise: Optional[torch.Tensor] = None, generator: torch.Generator | None = None,
                return_intermediates: bool = False):
        n = self.n_samples
        frame_ratio = (n // self.n_frames) / n

        # energy injection
        impulses = self.envelopes(params["envelopes"], noise=noise, generator=generator)

        # noise filters
        noise_res = self.noise_lookup(params["noise_resonance"])
        noise_res = F.pad(noise_res, (0, n - noise_res.shape[-1]))
        noise_def, _ = self.noise_warp(params["noise_deformations"])
        noise_mix = torch.softmax(params["noise_mixes"][:, :, None, :], dim=-1)
        noise_wet = fft_convolve(impulses[:, :, None, :], noise_res)
        noise_wet = torch.sum(noise_wet * noise_def, dim=2)
        intermediates = {"impulse": noise_wet}
        impulses = torch.sum(torch.stack([impulses, noise_wet], dim=-1) * noise_mix, dim=-1)

        # long resonances
        resonance = self.resonance(params["resonances"])
        deformations, before_upsample = self.warp(params["deformations"])
        intermediates["deformations"] = before_upsample
        dry = impulses[:, :, None, :]
        conv = fft_convolve(dry, resonance)
        audio_events = torch.sum(conv * deformations, dim=2, keepdim=True)
        mixes = torch.softmax(params["mixes"][:, :, None, None, :], dim=-1)
        final = torch.sum(torch.stack([dry, audio_events], dim=-1) * mixes, dim=-1)
        intermediates["dry"] = final

        # reverb
        verb = self.verb(params["room_choice"])
        final = final.reshape(verb.shape)
        wet = fft_convolve(verb, final)
        verb_mix = torch.softmax(params["room_mix"], dim=-1)[:, :, None, :]
        final = torch.sum(torch.stack([wet, final], dim=-1) * verb_mix, dim=-1)
        intermediates["wet"] = final

        scheduled = self.scheduler.schedule(times, final.reshape(-1, self.n_events, n))
        if self.fine_positioning and "fine" in params:
            scheduled = fft_shift(scheduled, torch.tanh(params["fine"]) * frame_ratio)[..., :n]
        if return_intermediates:
            return scheduled, intermediates
        return scheduled
