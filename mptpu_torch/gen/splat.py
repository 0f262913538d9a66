"""The audio-splatting event generator (counterpart of
``mptpu/gen/splat.py``): band-pass filtered noise placed by a Gaussian or
Gamma envelope, convolved with a decaying, cross-fading filtered
resonance (an F0 harmonic stack or a wavetable), scheduled by diracs and
mixed dry/wet with a reverb.

The parameters arrive as a dict matching ``shape_spec``, entries (batch,
n_events, *shape). The noise is the one draw of the forward: one
(1, 1, n_samples) uniform signal in [-1, 1), shared by every event, drawn
from the caller's ``torch.Generator`` or passed in.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..nn.init import uniform
from ..ops import kinks
from ..ops.fft import fft_convolve
from ..ops.norms import unit_norm
from ..ops.pdf import gamma_pdf, pdf2
from ..ops.ste import sparse_softmax
from ..ops.windows import linspace
from ..utils.music import musical_scale_hz
from .generator import EventGenerator, ShapeSpec
from .reds import F0Resonance, exponential_decay
from .reverb import ReverbGenerator
from .schedule import DiracScheduler, HierarchicalDiracModel
from .transfer import gaussian_bandpass_filtered, make_waves


class BandPassFilteredNoise:
    """(1, n_atoms, n_samples) noise filtered by one Gaussian band per event."""

    def __init__(self, n_samples: int, n_atoms: int = 1):
        self.n_samples = n_samples
        self.n_atoms = n_atoms

    @property
    def noise_shape(self):
        return (1, self.n_atoms, self.n_samples)

    def __call__(self, noise: torch.Tensor, means: torch.Tensor, stds: torch.Tensor) -> torch.Tensor:
        return gaussian_bandpass_filtered(means, stds, noise)


class Resonance:
    """Wavetable resonance chooser: ``n_resonances // 4`` musical f0s, each
    as sawtooth, square, triangle and sine (``make_waves``)."""

    def __init__(self, n_resonances: int, n_samples: int, samplerate: int,
                 hard_choice: bool = False, device=None):
        self.hard_choice = hard_choice
        f0s = musical_scale_hz(start_midi=21, stop_midi=106, n_steps=n_resonances // 4)
        self.waves = make_waves(n_samples, f0s.tolist(), samplerate, device=device).reshape(
            1, n_resonances, n_samples)

    def __call__(self, choice: torch.Tensor) -> torch.Tensor:
        if self.hard_choice:
            resonances = sparse_softmax(choice, normalize=True, axis=-1)
        else:
            resonances = torch.relu(choice)
        return resonances @ self.waves


class ExponentialDecayEnvelope:
    def __init__(self, base_resonance: float, n_frames: int, n_samples: int):
        self.base_resonance = base_resonance
        self.n_frames = n_frames
        self.n_samples = n_samples

    def __call__(self, decay_values: torch.Tensor) -> torch.Tensor:
        return exponential_decay(decay_values, n_atoms=decay_values.shape[1],
                                 n_frames=self.n_frames, base_resonance=self.base_resonance,
                                 n_samples=self.n_samples)


class EvolvingFilteredResonance:
    """Two Gaussian-filtered versions of the resonance and the exponential
    crossfade between them (stacked with its complement on a last axis)."""

    def __init__(self, base_crossfade_resonance: float, crossfade_frames: int, n_samples: int):
        self.base_crossfade_resonance = base_crossfade_resonance
        self.crossfade_frames = crossfade_frames
        self.n_samples = n_samples

    def __call__(self, resonances, decays, start_filter_means, start_filter_stds,
                 end_filter_means, end_filter_stds):
        start_resonance = gaussian_bandpass_filtered(start_filter_means, start_filter_stds,
                                                     resonances)
        end_resonance = gaussian_bandpass_filtered(end_filter_means, end_filter_stds, resonances)
        filt_crossfade = exponential_decay(decays, n_atoms=decays.shape[1],
                                           n_frames=self.crossfade_frames,
                                           base_resonance=self.base_crossfade_resonance,
                                           n_samples=self.n_samples)
        stacked = torch.stack([filt_crossfade, 1 - filt_crossfade], dim=-1)
        return start_resonance, end_resonance, stacked


class EnvelopeAndPosition:
    """Gaussian or Gamma positioning envelope."""

    def __init__(self, n_samples: int, envelope_type: str = "Gaussian",
                 gaussian_envelope_factor: float = 0.1):
        self.n_samples = n_samples
        self.envelope_type = envelope_type
        self.gaussian_envelope_factor = gaussian_envelope_factor
        self.gamma_ramp_size = 128
        self.gamma_ramp_exponent = 2

    def __call__(self, signals: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.envelope_type == "Gaussian":
            envelopes = pdf2(a, (kinks.abs(b) + 1e-12) * self.gaussian_envelope_factor,
                             self.n_samples)
        elif self.envelope_type == "Gamma":
            envelopes = gamma_pdf(kinks.abs(a) + 1e-12, kinks.abs(b) + 1e-12, self.n_samples)
            ramp = torch.zeros_like(envelopes)
            ramp[..., : self.gamma_ramp_size] = (
                linspace(0.0, 1.0, self.gamma_ramp_size, device=a.device, dtype=envelopes.dtype)
                ** self.gamma_ramp_exponent)
            envelopes = envelopes * ramp
        else:
            raise ValueError(f"{self.envelope_type} is not supported")
        return signals * envelopes


def mix(signals: List[torch.Tensor], weights: torch.Tensor) -> torch.Tensor:
    """The signals stacked on a last axis, weighted and summed over it."""
    return torch.sum(torch.stack(signals, dim=-1) * weights, dim=-1)


class SplattingEventGenerator(nn.Module, EventGenerator):
    """The splatting decoder. ``forward(params, times, noise=None,
    generator=None)``: ``params`` match ``shape_spec``; the noise is drawn
    from ``generator`` when not given. The only trainable parameters are
    the reverb's two MLPs (``verb.to_room``, ``verb.to_mix``), drawn from
    ``init_generator`` (a CPU generator, default seed 0)."""

    def __init__(self, n_samples: int, samplerate: int, n_resonance_octaves: int, n_frames: int,
                 hard_reverb_choice: bool = False, hierarchical_scheduler: bool = False,
                 wavetable_resonance: bool = False, n_resonances: int = 1024,
                 init_generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.n_samples = n_samples
        self.n_resonance_octaves = n_resonance_octaves
        self.wavetable_resonance = wavetable_resonance
        self.n_resonances = n_resonances
        if wavetable_resonance:
            self.resonance_generator = Resonance(n_resonances, n_samples, samplerate,
                                                 hard_choice=False, device=device)
        else:
            self.resonance_generator = F0Resonance(n_resonance_octaves, n_samples, min_hz=20,
                                                   max_hz=3000, samplerate=samplerate)
        self.noise_generator = BandPassFilteredNoise(n_samples)
        self.amp_envelope_generator = ExponentialDecayEnvelope(0.1, n_frames, n_samples)
        self.evolving_resonance = EvolvingFilteredResonance(0.02, n_frames, n_samples)
        self.env_and_position = EnvelopeAndPosition(n_samples, "Gaussian", 0.5)
        self.verb = ReverbGenerator(4, 2, samplerate, n_samples, hard_choice=hard_reverb_choice,
                                    generator=init_generator, device=device)
        if hierarchical_scheduler:
            self.scheduler = HierarchicalDiracModel(n_events=1, signal_size=n_samples)
        else:
            self.scheduler = DiracScheduler(n_events=1, start_size=n_samples // 256,
                                            n_samples=n_samples)

    @property
    def shape_spec(self) -> ShapeSpec:
        if not self.wavetable_resonance:
            return dict(env=(2,), mix=(2,), decay=(1,), filter_decay=(1,), f0_choice=(1,),
                        decay_choice=(1,), freq_spacing=(1,), noise_filter=(2,),
                        resonance_filter_1=(2,), resonance_filter_2=(2,), amp=(1,),
                        verb_params=(4,), time_decays=(self.n_resonance_octaves,))
        return dict(env=(2,), mix=(2,), filter_decay=(1,), decay_choice=(1,),
                    resonance_choice=(self.n_resonances,), noise_filter=(2,),
                    resonance_filter_1=(2,), resonance_filter_2=(2,), amp=(1,), verb_params=(4,))

    def forward(self, params: Dict[str, torch.Tensor], times: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if noise is None:
            noise = uniform(self.noise_generator.noise_shape, -1.0, 1.0, generator, times.device)
        if self.wavetable_resonance:
            return self.forward_wavetable(params, times, noise)
        return self.forward_f0(params, times, noise)

    def forward_f0(self, p: Dict[str, torch.Tensor], times: torch.Tensor, noise: torch.Tensor):
        resonances = self.resonance_generator(
            p["f0_choice"], p["decay"], p["freq_spacing"], sigmoid_decay=True,
            time_decay=1 + torch.sigmoid(p["time_decays"]) * 80,
        )
        return self._common(p, times, noise, resonances, verb_before_schedule=False)

    def forward_wavetable(self, p: Dict[str, torch.Tensor], times: torch.Tensor,
                          noise: torch.Tensor):
        resonances = self.resonance_generator(p["resonance_choice"])
        decays = self.amp_envelope_generator(p["decay_choice"])
        return self._common(p, times, noise, resonances, decays=decays, verb_before_schedule=True)

    def _common(self, p, times, noise, resonances, decays: Optional[torch.Tensor] = None,
                verb_before_schedule: bool = True) -> torch.Tensor:
        batch = p["env"].shape[0]
        overall_mix = torch.softmax(p["mix"], dim=-1)
        filtered_noise = self.noise_generator(noise, p["noise_filter"][:, :, 0],
                                              kinks.abs(p["noise_filter"][:, :, 1]) + 1e-12)
        filtered_resonance, filt_res_2, filt_crossfade_stacked = self.evolving_resonance(
            resonances=resonances,
            decays=p["filter_decay"],
            start_filter_means=torch.zeros_like(p["resonance_filter_1"][:, :, 0]),
            start_filter_stds=kinks.abs(p["resonance_filter_1"][:, :, 1]) + 1e-12,
            end_filter_means=torch.zeros_like(p["resonance_filter_2"][:, :, 0]),
            end_filter_stds=kinks.abs(p["resonance_filter_2"][:, :, 1]) + 1e-12,
        )
        if decays is not None:
            filtered_resonance = filtered_resonance * decays
            filt_res_2 = filt_res_2 * decays

        positioned_noise = self.env_and_position(filtered_noise, p["env"][:, :, 0],
                                                 p["env"][:, :, 1])
        res = fft_convolve(positioned_noise, filtered_resonance)
        res2 = fft_convolve(positioned_noise, filt_res_2)
        mixed = mix([res, res2], filt_crossfade_stacked)
        final = mix([positioned_noise, mixed], overall_mix[:, :, None, :])
        final = final.reshape(batch, -1, self.n_samples)
        final = unit_norm(final, axis=-1) * kinks.abs(p["amp"])

        if verb_before_schedule:
            return self.scheduler.schedule(times, self.verb(p["verb_params"], final))
        return self.verb(p["verb_params"], self.scheduler.schedule(times, final))
