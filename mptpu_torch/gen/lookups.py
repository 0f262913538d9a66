"""The extended resonance lookups and the multi-SSM event generator
(counterpart of ``mptpu/gen/lookups.py``): item tables of noise under
power-law decays, of frequency-domain transfer functions (one window, or
one per octave band recomposed to full rate), of wavetables, and a
learned control-plane table for a shared SSM.

The tables start from the draws ``mptpu`` makes (uniform, a Bernoulli
mask) from a CPU ``torch.Generator``; ``convert.module_from_flax`` carries
``mptpu``'s numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..device import default_device, no_tf32
from ..nn.init import uniform
from ..ops.decompose import fft_frequency_recompose
from ..ops.norms import unit_norm
from ..ops.upsample import ensure_last_axis_length
from ..ops.windows import linspace
from ..sparse.quantize import select_items
from ..sparse.topk import sparsify
from .generator import EventGenerator, ShapeSpec
from .overfitresonance import Lookup
from .schedule import DiracScheduler
from .ssm import SSM
from .transfer import freq_domain_transfer_function_to_resonance, make_waves_vectorized


def _sparse_uniform(shape, gen: torch.Generator) -> torch.Tensor:
    """Uniform in [-6, 6) where a Bernoulli(0.01) mask is set, else 0."""
    vals = uniform(shape, -6.0, 6.0, gen)
    return vals * (torch.rand(shape, generator=gen) < 0.01)


def _table(lookup: Lookup, items: torch.Tensor, selection_type: str, device) -> None:
    """Set up ``lookup`` as a :class:`Lookup` over the learned ``items``
    (drawn here rather than by ``Lookup.__init__``'s uniform table)."""
    nn.Module.__init__(lookup)
    lookup.selection_type = selection_type
    lookup.items = nn.Parameter(items.to(default_device(device)))


class SampleResonanceLookup(Lookup):
    """Items (n_items, n_samples): uniform noise in [-1, 1) times
    ``linspace(1, 0) ** d`` with decays ``d`` from 2 to 80 over the items;
    the selection is unit-normed."""

    def __init__(self, n_items: int, n_samples: int, selection_type: str = "relu",
                 generator: torch.Generator | None = None, device=None):
        gen = generator or torch.Generator().manual_seed(0)
        ramp = linspace(1.0, 0.0, n_samples, device="cpu")[None, :]
        decays = linspace(2.0, 80.0, n_items, device="cpu")[:, None]
        _table(self, ramp**decays * uniform((n_items, n_samples), -1.0, 1.0, gen),
               selection_type, device)

    def postprocess_results(self, selected, noise=None, generator=None):
        return unit_norm(selected)


class FFTResonanceLookup(Lookup):
    """Items (n_items, 3 (window_size // 2 + 1)): per-bin decays, start
    phases and start magnitudes of a transfer function, the selection
    rendered to ``n_samples`` unit-normed samples."""

    def __init__(self, n_items: int, n_samples: int, window_size: int = 2048,
                 base_resonance: float = 0.5, selection_type: str = "relu",
                 generator: torch.Generator | None = None, device=None):
        gen = generator or torch.Generator().manual_seed(0)
        _table(self, _sparse_uniform((n_items, (window_size // 2 + 1) * 3), gen), selection_type,
               device)
        self.n_samples, self.window_size, self.base_resonance = (n_samples, window_size,
                                                                 base_resonance)

    def postprocess_results(self, items, noise=None, generator=None):
        chunk = self.window_size // 2 + 1
        span = 1 - self.base_resonance
        mags = self.base_resonance + (torch.sigmoid(items[..., :chunk]) * 0.9999) * span
        phases = torch.tanh(items[..., chunk:chunk * 2]) * math.pi
        starts = torch.sigmoid(items[..., -chunk:])
        out = freq_domain_transfer_function_to_resonance(
            self.window_size, mags, self.n_samples // (self.window_size // 2),
            start_phase=phases, start_mags=starts)
        return unit_norm(out.reshape(*items.shape[:-1], -1), axis=-1)


class WavetableLookup(Lookup):
    """A selection (softmax unless asked) over ``n_samples`` waves of
    ``wave_samples`` samples: saw, square, triangle and sine at
    ``n_samples // 4`` frequencies from 20 to 4,000 Hz (``waves``, a
    parameter when ``learnable``), weighted by the item table."""

    def __init__(self, n_items: int, n_samples: int, selection_type: str = "softmax",
                 wave_samples: int = 16384, samplerate: int = 22050, learnable: bool = False,
                 init_scale: float = 0.02, generator: torch.Generator | None = None, device=None):
        super().__init__(n_items, n_samples, selection_type, None, init_scale, generator, device)
        waves = make_waves_vectorized(wave_samples, np.linspace(20, 4000, num=n_samples // 4),
                                      samplerate, device=device)
        if learnable:
            self.waves = nn.Parameter(waves)
        else:
            self.register_buffer("waves", waves, persistent=False)

    def forward(self, selections: torch.Tensor, noise=None, generator=None):
        with no_tf32():
            return select_items(selections, self.items, self.selection_type) @ self.waves


class MultibandResonanceLookup(Lookup):
    """Items of one transfer function (window ``window_size``) per octave
    band from ``smallest_band_size`` to ``out_samples // 2``, each band
    rendered at its own rate, recomposed to full rate and unit-normed:
    (..., out_samples)."""

    def __init__(self, n_items: int, n_samples: int, smallest_band_size: int = 512,
                 base_resonance: float = 0.2, window_size: int = 64, out_samples: int = 16384,
                 selection_type: str = "relu", generator: torch.Generator | None = None,
                 device=None):
        gen = generator or torch.Generator().manual_seed(0)
        lo, hi = int(np.log2(smallest_band_size)), int(np.log2(out_samples))
        band_sizes = [2**x for x in range(lo, hi)]
        total = (window_size // 2 + 1) * 3 * len(band_sizes)
        _table(self, _sparse_uniform((n_items, total), gen), selection_type, device)
        self.band_sizes = band_sizes
        self.base_resonance, self.window_size, self.out_samples = (base_resonance, window_size,
                                                                   out_samples)

    def postprocess_results(self, items, noise=None, generator=None):
        nc = self.window_size // 2 + 1
        per_band = nc * 3
        span = 1 - self.base_resonance
        bands = {}
        for i, size in enumerate(self.band_sizes):
            bp = items[..., i * per_band:(i + 1) * per_band]
            mag = self.base_resonance + (torch.sigmoid(bp[..., :nc]) * span) * 0.9999
            band = freq_domain_transfer_function_to_resonance(
                self.window_size, mag, size // (self.window_size // 2),
                start_phase=torch.tanh(bp[..., nc:nc * 2]) * math.pi,
                start_mags=torch.sigmoid(bp[..., -nc:]))
            bands[size] = ensure_last_axis_length(band, size * 2)
        full = fft_frequency_recompose(bands, self.out_samples * 2)[..., :self.out_samples]
        return unit_norm(full.reshape(*items.shape[:-1], -1))


class MultiSSM(nn.Module, EventGenerator):
    """An event generator choosing a learned control plane
    (``control_plane_selection``, a sparse-softmax lookup) for one shared
    SSM (``ssm``): the plane softmaxed over all its entries and cut to its
    8 largest, the SSM's audio placed by a dirac scheduler. One event a
    call: (batch, 1, n_samples)."""

    def __init__(self, context_dim: int, control_plane_dim: int, n_frames: int, state_dim: int,
                 window_size: int, n_models: int, n_control_planes: int, n_samples: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.control_plane_dim, self.n_frames, self.n_samples = (control_plane_dim, n_frames,
                                                                 n_samples)
        self.n_control_planes = n_control_planes
        self.control_plane_selection = Lookup(n_control_planes, control_plane_dim * n_frames,
                                              selection_type="sparse_softmax", init_scale=1.0,
                                              generator=gen, device=device)
        self.ssm = SSM(control_plane_dim, window_size, state_dim, windowed=True,
                       init_generator=gen, device=device)
        self.scheduler = DiracScheduler(1, n_frames, n_samples)

    @property
    def shape_spec(self) -> ShapeSpec:
        return dict(control_plane_choice=(1, self.n_control_planes))

    def forward(self, control_plane_choice: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        batch = control_plane_choice.shape[0]
        cp = self.control_plane_selection(control_plane_choice)
        cp = torch.softmax(cp.reshape(batch, -1), dim=-1).reshape(
            batch, self.control_plane_dim, self.n_frames)
        samples = self.ssm(sparsify(cp, n_to_keep=8))
        samples = ensure_last_axis_length(samples, self.n_samples)
        return self.scheduler.schedule(times, samples)
