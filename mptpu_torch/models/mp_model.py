"""Differentiable matching pursuit with learned atoms (counterpart of
``mptpu/models/mp_model.py``, BASELINE #1's gradient-trained variant).

The atoms are parameters. Each iteration FFT-convolves the residual with
the zero-padded atoms, keeps the single largest (atom, time) by
``sparsify2``'s top-1, renders that atom at that time, and subtracts it.
``mptpu``'s ``lax.scan`` over iterations is a Python loop here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device
from ..nn.init import uniform_init
from ..ops.fft import fft_convolve
from ..sparse.topk import sparsify2


class MatchingPursuit(nn.Module):
    """``forward(audio (batch, 1, n_samples))`` -> the channel each
    iteration removed, (batch, n_iterations, n_samples). ``atoms`` (1,
    n_atoms, atom_samples), flax's name and shape, starts uniform in
    [-0.01, 0.01) from ``generator`` (a CPU one, default seed 0); carry
    ``mptpu``'s with ``convert.module_from_flax``."""

    def __init__(self, n_atoms: int, atom_samples: int, n_samples: int, n_iterations: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_atoms = n_atoms
        self.atom_samples = atom_samples
        self.n_samples = n_samples
        self.n_iterations = n_iterations
        self.atoms = nn.Parameter(
            uniform_init((1, n_atoms, atom_samples), 0.01, gen).to(default_device(device)))

    def normalized_atoms(self) -> torch.Tensor:
        """The atoms zero-padded to ``n_samples`` (``mptpu``'s name: no norm)."""
        return F.pad(self.atoms, (0, self.n_samples - self.atom_samples))

    def forward(self, audio: torch.Tensor, return_events: bool = False):
        """The channels; with ``return_events`` also each iteration's atom
        and time indices, (batch, n_iterations) each."""
        na = self.normalized_atoms()
        residual, channels, atoms, times = audio, [], [], []
        for _ in range(self.n_iterations):
            spec = fft_convolve(residual, na)               # (batch, n_atoms, n_samples)
            _, time, atom = sparsify2(spec, n_to_keep=1)    # (batch, 1, n), (batch, 1, n_atoms)
            b = fft_convolve(atom @ na, time)               # (batch, 1, n_samples)
            residual = residual - b
            channels.append(b[:, 0])
            if return_events:
                atoms.append(atom[:, 0].abs().argmax(-1))
                times.append(time[:, 0].abs().argmax(-1))
        channels = torch.stack(channels, dim=1)
        if return_events:
            return channels, torch.stack(atoms, dim=1), torch.stack(times, dim=1)
        return channels
