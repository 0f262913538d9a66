"""Synthesis helpers and event generators of the port (counterpart of
``mptpu.gen``; only the ported names)."""

from .generator import EventGenerator, ShapeSpec
from .reds import F0Resonance, exponential_decay
from .reverb import NeuralReverb, ReverbGenerator, load_impulse_responses
from .schedule import (
    DiracScheduler,
    FFTShiftScheduler,
    HierarchicalDiracModel,
    hierarchical_dirac,
    interpretable_fft_shift,
)
from .splat import SplattingEventGenerator
from .ssm import SSM, HyperNetworkLayer, StateSpaceModelEventGenerator, ssm_scan, state_space_model
from .ssm_complex import ComplexSSM, CompressionModel, param_count
from .roomsim import RoomModel, overfit_room, roomsim, simulate_room
from .transfer import (ResonanceBank, ResonanceBlock, ResonanceChain, TimeVaryingMix,
                       damped_harmonic_oscillator, fft_convolve_correlation,
                       freq_domain_transfer_function_to_resonance, gaussian_bandpass_filtered,
                       make_waves, make_waves_vectorized)
from .ddsp import (HarmonicModel, band_filtered_noise, harmonic_model, noise_bank2, noise_spec,
                   oscillator_bank)
from .impulse import GenerateImpulse, GenerateMix, NoiseModel

__all__ = [
    "EventGenerator",
    "ShapeSpec",
    "F0Resonance",
    "exponential_decay",
    "NeuralReverb",
    "ReverbGenerator",
    "load_impulse_responses",
    "DiracScheduler",
    "FFTShiftScheduler",
    "HierarchicalDiracModel",
    "hierarchical_dirac",
    "interpretable_fft_shift",
    "SplattingEventGenerator",
    "SSM",
    "HyperNetworkLayer",
    "StateSpaceModelEventGenerator",
    "ssm_scan",
    "state_space_model",
    "ComplexSSM",
    "CompressionModel",
    "param_count",
    "damped_harmonic_oscillator",
    "gaussian_bandpass_filtered",
    "make_waves",
    "make_waves_vectorized",
    "fft_convolve_correlation",
    "freq_domain_transfer_function_to_resonance",
    "ResonanceBank",
    "ResonanceBlock",
    "ResonanceChain",
    "TimeVaryingMix",
    "HarmonicModel",
    "band_filtered_noise",
    "harmonic_model",
    "noise_bank2",
    "noise_spec",
    "oscillator_bank",
    "GenerateImpulse",
    "GenerateMix",
    "NoiseModel",
    "RoomModel",
    "roomsim",
    "simulate_room",
    "overfit_room",
]
