"""Synthesis helpers and event generators of the port (counterpart of
``mptpu.gen``: every name of its ``__all__``, and a few more)."""

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
from .overfitresonance import OverfitResonanceModel
from .reds_model import RedsLikeModel
from .convimpulse import ConvImpulseEventGenerator
from .waveguide import WaveguideSynth, waveguide_synth_scan
from .physical import TransferFunctionSegmentGenerator, gaussian_window
from .lookups import (FFTResonanceLookup, MultibandResonanceLookup, MultiSSM,
                      SampleResonanceLookup, WavetableLookup)
from .event_variants import AudioModelEventGenerator, SimpleEventGenerator, WavetableModel
from .instrument import InstrumentLayer, InstrumentStack
from .goo import SpringMesh, pluck_forces, string_mesh
from .goo import simulate as goo_simulate
from .energy import (EnergyBlock, EnergyInstrumentModel, blocks_to_samples,
                     compute_discontinuity, to_blocks)
from .recurrent import FrameSynth, RecurrentSynth
from .audiomodel import AudioModel, OscillatorBank
from .audiomodel import OscillatorBank as OscillatorBankModule

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
    "OverfitResonanceModel",
    "RedsLikeModel",
    "ConvImpulseEventGenerator",
    "WaveguideSynth",
    "waveguide_synth_scan",
    "gaussian_window",
    "TransferFunctionSegmentGenerator",
    "SampleResonanceLookup",
    "FFTResonanceLookup",
    "WavetableLookup",
    "MultibandResonanceLookup",
    "MultiSSM",
    "AudioModelEventGenerator",
    "WavetableModel",
    "SimpleEventGenerator",
    "InstrumentLayer",
    "InstrumentStack",
    "SpringMesh",
    "string_mesh",
    "goo_simulate",
    "pluck_forces",
    "EnergyInstrumentModel",
    "EnergyBlock",
    "to_blocks",
    "blocks_to_samples",
    "compute_discontinuity",
    "FrameSynth",
    "RecurrentSynth",
    "OscillatorBankModule",
    "OscillatorBank",
    "AudioModel",
    "OverfitControlPlane",
]


def __getattr__(name):
    # models.ssm_overfit imports gen's modules, so its OverfitControlPlane is
    # exported lazily (an eager import is circular when gen comes first)
    if name == "OverfitControlPlane":
        from ..models.ssm_overfit import OverfitControlPlane

        return OverfitControlPlane
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
