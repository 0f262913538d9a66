"""F0 and harmonic-spacing resonance generator (counterpart of
``mptpu/gen/reds.py``).

``F0Resonance`` builds (batch, events, octaves, samples) sines whose phase
``f0s * (1..n)`` reaches 10^5 to 10^6 radians at 2^16 samples, where one
float32 place of ``f0s`` moves the phase by 0.01 to 0.06 radians at the
end. So ``f0s`` is computed as ``mptpu``'s jitted step computes it: XLA
fuses ``min + f0 * range`` into one multiply-add, rounded once, which the
port takes in float64 (the product is exact there) and rounds to float32;
and the harmonic factors are cumulated by a sequential loop of float32
additions (``jnp.cumsum`` adds in that order on the CPU; ``torch.cumsum``
accumulates in float64 on the CPU and in a scan tree on CUDA). The phase
is then the same float on every device, and only ``sin``'s own rounding
differs.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.norms import max_norm
from ..ops.upsample import interpolate_last_axis
from ..ops.windows import linspace


def exponential_decay(decay_values: torch.Tensor, n_atoms: int, n_frames: int,
                      base_resonance: float, n_samples: int) -> torch.Tensor:
    """sigmoid -> a per-frame decay in [base, ~1) -> exp of the cumulative
    log -> upsampled to ``n_samples``: (batch, n_atoms, n_samples)."""
    decay_values = torch.sigmoid(decay_values.reshape(-1, n_atoms, 1))
    decay_values = decay_values.expand(*decay_values.shape[:2], n_frames)
    resonance_factor = (1 - base_resonance) * 0.99
    decay = base_resonance + decay_values * resonance_factor
    decay = torch.exp(torch.cumsum(torch.log(decay + 1e-12), dim=-1))
    return interpolate_last_axis(decay, n_samples)


def sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis by float32 additions from the
    left, the same floats on every device."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


class F0Resonance:
    """Harmonic stack: squared f0 in [min_hz, max_hz], cumulated harmonic
    spacing, a per-octave exponential decay and an optional global time
    decay. Stateless."""

    def __init__(self, n_octaves: int, n_samples: int, min_hz: int = 20, max_hz: int = 3000,
                 samplerate: int = 22050):
        self.samplerate = samplerate
        self.n_octaves = n_octaves
        self.n_samples = n_samples
        self.min_freq = min_hz / (samplerate // 2)
        self.max_freq = max_hz / (samplerate // 2)
        self.freq_range = self.max_freq - self.min_freq

    def __call__(self, f0: torch.Tensor, decay_coefficients: torch.Tensor,
                 freq_spacing: torch.Tensor, sigmoid_decay: bool = True,
                 apply_exponential_decay: bool = True,
                 time_decay: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch, n_events, _ = f0.shape
        f0 = (f0**2).reshape(batch, n_events, 1)
        exp_decays = exponential_decay(
            torch.sigmoid(decay_coefficients) if sigmoid_decay else decay_coefficients,
            n_atoms=n_events, n_frames=self.n_octaves, base_resonance=0.01,
            n_samples=self.n_octaves,
        )
        # the float32 constants of mptpu, one rounding for the multiply-add;
        # in float64 the exact ones, as mptpu under x64
        lo, span = self.min_freq, self.freq_range
        if f0.dtype != torch.float64:
            lo, span = float(np.float32(lo)), float(np.float32(span))
        f0 = (f0.double() * span + lo).to(f0.dtype) * math.pi
        factors = sequential_cumsum(freq_spacing.expand(batch, n_events, self.n_octaves))
        f0s = f0 * factors   # (batch, n_events, n_octaves) radians a sample

        # the cumulative phase of a constant frequency is freq * (i + 1)
        steps = torch.arange(1, self.n_samples + 1, dtype=f0s.dtype, device=f0s.device)
        osc = torch.sin(f0s[..., None] * steps)
        if apply_exponential_decay:
            osc = osc * exp_decays[..., None]
        if time_decay is not None:
            ramp = linspace(1.0, 0.0, time_decay.shape[-1], device=time_decay.device)
            ramp = interpolate_last_axis(ramp**time_decay, self.n_samples)
            osc = osc * ramp.reshape(batch, n_events, 1, self.n_samples)
        return max_norm(torch.sum(osc, dim=2), axis=-1)
