"""The full REDS synthesiser (counterpart of ``mptpu/gen/reds_model.py``):
about 16 parameters per atom (envelope, mixes, decays, an F0 harmonic stack
or a wavetable choice, a noise filter, two resonance filters, amplitude,
shift, reverb) rendered through the splatting generator's components with
Gamma positioning envelopes and an FFT-shift placement.

The band-pass noise, one (1, 1, n_samples) uniform draw in [-1, 1) shared
by every atom, is passed in or drawn from a ``torch.Generator``. The only
trainable parameters are the reverb's two MLPs (``verb``). With
``use_wavetables`` the table holds ``n_wavetable_resonances`` waves of
``n_samples`` (4,096 x 2^15 samples: 512 MiB in float32), ``waves`` where
the caller already holds ``make_waves``' table of them, else built here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..device import no_tf32
from ..nn.init import uniform
from ..ops import kinks
from ..ops.fft import fft_convolve, fft_shift
from ..ops.norms import unit_norm
from .generator import EventGenerator, ShapeSpec
from .reds import F0Resonance
from .reverb import ReverbGenerator
from .splat import (BandPassFilteredNoise, EnvelopeAndPosition, EvolvingFilteredResonance,
                    ExponentialDecayEnvelope, Resonance, mix)


class RedsLikeModel(nn.Module, EventGenerator):
    """``forward(p, noise=None, generator=None)``: ``p`` matches
    ``shape_spec``, each (batch, n_atoms, *shape) -> (batch, n_atoms,
    n_samples)."""

    def __init__(self, n_resonance_octaves: int = 64, n_samples: int = 2**15,
                 samplerate: int = 22050, use_wavetables: bool = False,
                 n_wavetable_resonances: int = 4096, generator: torch.Generator | None = None,
                 waves: Optional[torch.Tensor] = None, device=None):
        super().__init__()
        self.n_samples, self.use_wavetables = n_samples, use_wavetables
        if use_wavetables:   # Resonance(hard_choice=False)'s table, as a buffer
            if waves is None:
                waves = Resonance(n_wavetable_resonances, n_samples, samplerate,
                                  device=device).waves
            self.register_buffer("waves", waves.reshape(1, n_wavetable_resonances, n_samples),
                                 persistent=False)
        else:
            self.resonance_generator = F0Resonance(n_resonance_octaves, n_samples)
        self.noise_generator = BandPassFilteredNoise(n_samples)
        self.amp_envelope_generator = ExponentialDecayEnvelope(0.02, 128, n_samples)
        self.evolving_resonance = EvolvingFilteredResonance(0.02, 128, n_samples)
        self.env_and_position = EnvelopeAndPosition(n_samples, envelope_type="Gamma")
        self.verb = ReverbGenerator(4, 2, samplerate, n_samples, generator=generator,
                                    device=device)

    @property
    def shape_spec(self) -> ShapeSpec:
        """``mptpu``'s, but for ``f0_choice``, which the wavetable branch takes
        ``n_wavetable_resonances`` wide (``mptpu`` says 1 in both branches,
        which its wavetable branch cannot multiply into the table)."""
        f0 = (self.waves.shape[-2],) if self.use_wavetables else (1,)
        return dict(noise_osc_mix=(2,), f0_choice=f0, decay_choice=(1,), freq_spacing=(1,),
                    noise_filter=(2,), filter_decays=(1,), resonance_filter=(2,),
                    resonance_filter2=(2,), decays=(1,), shifts=(1,), env=(2,),
                    amplitudes=(1,), verb_params=(4,))

    def _resonances(self, p):
        """A relu choice over the wavetables, or the F0 stack."""
        if self.use_wavetables:
            with no_tf32():
                return torch.relu(p["f0_choice"]) @ self.waves
        return self.resonance_generator(p["f0_choice"], p["decay_choice"], p["freq_spacing"])

    def forward(self, p: Dict[str, torch.Tensor], noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        batch = p["env"].shape[0]
        if noise is None:
            noise = uniform(self.noise_generator.noise_shape, -1.0, 1.0, generator,
                            p["env"].device)
        noise = noise.to(p["env"].device, p["env"].dtype)
        overall_mix = torch.softmax(p["noise_osc_mix"], dim=-1)
        resonances = self._resonances(p)
        filtered_noise = self.noise_generator(noise, p["noise_filter"][:, :, 0],
                                              kinks.abs(p["noise_filter"][:, :, 1]) + 1e-12)
        filt_res, filt_res2, crossfade = self.evolving_resonance(
            resonances=resonances,
            decays=p["filter_decays"],
            start_filter_means=torch.zeros_like(p["resonance_filter"][:, :, 0]),
            start_filter_stds=kinks.abs(p["resonance_filter"][:, :, 1]) + 1e-12,
            end_filter_means=torch.zeros_like(p["resonance_filter2"][:, :, 0]),
            end_filter_stds=kinks.abs(p["resonance_filter2"][:, :, 1]) + 1e-12,
        )
        decays = self.amp_envelope_generator(p["decays"])
        positioned_noise = self.env_and_position(filtered_noise, p["env"][:, :, 0],
                                                 p["env"][:, :, 1])
        res = fft_convolve(positioned_noise, filt_res * decays)
        res2 = fft_convolve(positioned_noise, filt_res2 * decays)
        mixed = mix([res, res2], crossfade)
        final = mix([positioned_noise, mixed], overall_mix[:, :, None, :])
        final = unit_norm(final.reshape(batch, -1, self.n_samples), axis=-1)
        final = final * kinks.abs(p["amplitudes"])
        final = fft_shift(final, p["shifts"])   # placement by a fractional shift
        return self.verb(p["verb_params"], final)
