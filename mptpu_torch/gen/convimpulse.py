"""The conv-impulse event generator (counterpart of
``mptpu/gen/convimpulse.py``): a learned noise transient excites a
resonance chain over a fixed bank of waves, reverb is added and the event
is placed by a dirac scheduler. Children carry flax's names.

The chain has one block, whose ONE shared bank (``ResonanceBank_0``) holds
the ``total_atoms`` waves as a fixed buffer (saw, square, triangle and sine
at ``total_atoms // 4`` musical pitches; ``learnable_resonances=False``):
4,096 waves of 2^15 samples are 512 MiB in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import no_tf32
from ..nn.init import uniform_linear
from ..ops.norms import unit_norm
from ..utils.music import musical_scale_hz
from .generator import EventGenerator, ShapeSpec
from .impulse import GenerateImpulse
from .reverb import ReverbGenerator
from .schedule import DiracScheduler
from .transfer import ResonanceChain, make_waves


class ConvImpulseEventGenerator(nn.Module, EventGenerator):
    """``forward(vecs, times, noise=None, generator=None)``: vecs (batch,
    n_events, context_dim), times (batch, n_events, n_samples // 256) ->
    (batch, n_events, n_samples). ``noise`` is the impulse's (batch
    n_events, impulse_size) uniform draw in [-1, 1). ``waves`` is
    ``make_waves``' table of the resonances' f0s where the caller already
    holds it (at 4,096 atoms of 2^15 samples scipy takes seconds on it)."""

    def __init__(self, context_dim: int, impulse_size: int, resonance_size: int,
                 samplerate: int, n_samples: int, n_events: int = 1, total_atoms: int = 4096,
                 generator: torch.Generator | None = None,
                 waves: Optional[torch.Tensor] = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.context_dim, self.impulse_size, self.resonance_size = (context_dim, impulse_size,
                                                                    resonance_size)
        self.n_samples, self.n_events = n_samples, n_events
        self.Dense_0 = uniform_linear(context_dim, 256, True, 0.1, gen, device)
        self.GenerateImpulse_0 = GenerateImpulse(256, 128, impulse_size, 16, n_events,
                                                 generator=gen, device=device)
        if waves is None:
            f0s = musical_scale_hz(start_midi=21, stop_midi=106, n_steps=total_atoms // 4)
            waves = make_waves(resonance_size, f0s.tolist(), int(samplerate), device=device)
        self.ResonanceChain_0 = ResonanceChain(1, total_atoms, 512, 256, resonance_size, 16, 64,
                                               256, waves, learnable_resonances=False,
                                               generator=gen, device=device)
        del waves
        self.ReverbGenerator_0 = ReverbGenerator(context_dim, 3, samplerate, n_samples,
                                                 generator=gen, device=device)
        self.scheduler = DiracScheduler(n_events, start_size=n_samples // 256,
                                        n_samples=n_samples)

    @property
    def shape_spec(self) -> ShapeSpec:
        return dict(vecs=(self.context_dim,))

    def noise_shape(self, batch: int):
        return (batch * self.n_events, self.impulse_size)

    def forward(self, vecs: torch.Tensor, times: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        batch = vecs.shape[0]
        with no_tf32():
            embeddings = self.Dense_0(vecs)
        amps = torch.sum(times, dim=-1, keepdim=True)
        imp = unit_norm(self.GenerateImpulse_0(embeddings, noise, generator))
        mixed = self.ResonanceChain_0(embeddings, imp).reshape(batch, -1, self.resonance_size)
        mixed = unit_norm(mixed) * amps
        mixed = F.pad(mixed, (0, self.n_samples - self.resonance_size))
        final = self.scheduler.schedule(times, mixed)
        return self.ReverbGenerator_0(unit_norm(vecs, axis=-1), final)
