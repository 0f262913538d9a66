"""The energy-instrument overfit (counterpart of the trainer in
``scripts/energy_overfit.py``): a sparse impulse control signal, 16
learned amplitudes at fixed sites, drives an :class:`EnergyInstrumentModel`;
the loss is the l1 distance of the two STFT magnitudes (window 2048, hop
256, padded) plus ``disc_weight`` times the block-boundary discontinuity.
Both the model and the amplitudes are trained by optax's Adam at lr 1e-3.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..convert import flax_paths
from ..data.audioiter import get_one_audio_segment
from ..device import default_device
from ..gen.energy import EnergyInstrumentModel, compute_discontinuity, to_blocks
from ..ops import kinks
from ..ops.stft import stft
from ..train.optim import Adam, AdamState

# the script's sizes: (n_samples, block, channels, layers)
FULL = (2**15, 512, 128, 3)
TINY = (2**12, 128, 32, 2)
N_IMPULSES = 16


class EnergyOverfit(nn.Module):
    """The trained state of the script, ``{"model", "amps"}``: the
    instrument and the impulse amplitudes (``N_IMPULSES`` of 0.1) at
    ``sites``, evenly spaced over [0, n_samples - block]."""

    def __init__(self, n_samples: int, block: int, channels: int, layers: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = default_device(device)
        self.n_samples, self.block = n_samples, block
        self.model = EnergyInstrumentModel(1, channels, block, layers,
                                           generator=generator or torch.Generator().manual_seed(0),
                                           device=dev)
        self.amps = nn.Parameter(torch.full((N_IMPULSES,), 0.1, device=dev))
        sites = np.linspace(0, n_samples - block, N_IMPULSES).astype(int)
        self.register_buffer("sites", torch.from_numpy(sites).to(dev), persistent=False)

    def control(self) -> torch.Tensor:
        """``zeros((1, 1, n)).at[0, 0, sites].set(amps)``, out of place so
        that the amplitudes get their gradient."""
        ctrl = self.amps.new_zeros((1, 1, self.n_samples))
        return ctrl.index_put((torch.zeros_like(self.sites), torch.zeros_like(self.sites),
                               self.sites), self.amps)

    def forward(self) -> torch.Tensor:
        return self.model(self.control())

    def leaves(self) -> List[nn.Parameter]:
        """The parameters in the order of ``mptpu``'s state tree: ``amps``,
        then the model's leaves by their flax path."""
        paths = flax_paths(self.model)
        named = dict(self.model.named_parameters())
        return [self.amps] + [named[k] for k in sorted(named, key=lambda k: paths[k])]


class EnergyLoss:
    """The script's loss against one target (1, 1, n_samples): (total,
    spectral l1, discontinuity)."""

    def __init__(self, target: torch.Tensor, block: int, disc_weight: float = 0.1):
        self.block = block
        self.disc_weight = disc_weight
        self.target_spec = stft(target, 2048, 256, pad=True)

    def __call__(self, recon: torch.Tensor):
        spec_l = kinks.abs(stft(recon, 2048, 256, pad=True) - self.target_spec).sum()
        disc = compute_discontinuity(to_blocks(recon, self.block))
        return spec_l + self.disc_weight * disc, spec_l, disc


def energy_step(state: EnergyOverfit, adam: Adam, opt: AdamState, loss_fn: EnergyLoss):
    """One Adam step in place, nothing read on the host. Returns (loss,
    spectral l1, discontinuity, the new Adam state)."""
    params = state.leaves()
    loss, spec_l, disc = loss_fn(state())
    updates, opt = adam.update(torch.autograd.grad(loss, params), opt)
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    return loss.detach(), spec_l.detach(), disc.detach(), opt


class EnergyRun(NamedTuple):
    state: EnergyOverfit
    losses: List[float]        # every step's loss, read once after the loop
    step_starts: List[float]   # host clock at each step's start
    t_end: float               # host clock after the loop (synchronised on a card)


def overfit_energy(iterations: int = 500, tiny: bool = False, disc_weight: float = 0.1,
                   target: Optional[torch.Tensor] = None, device=None,
                   log: Callable[[str], None] = print) -> EnergyRun:
    """``scripts/energy_overfit.py:main`` with its flags as keywords:
    overfit the instrument (2^15 samples, block 512, 128 channels, 3 layers;
    ``tiny``: 2^12, 128, 32, 2; parameters seeded with 0) and its impulse
    amplitudes to ``target`` (default ``get_one_audio_segment(n, 22050,
    seed=5)``) by Adam at lr 1e-3, reading the loss on the host every 50th
    step as the script prints it."""
    dev = default_device(device)
    n_samples, block, channels, layers = TINY if tiny else FULL
    if target is None:
        target = get_one_audio_segment(n_samples, 22050, seed=5, device=dev)
    target = target.reshape(1, 1, -1).to(dev)
    state = EnergyOverfit(n_samples, block, channels, layers, device=dev)
    loss_fn = EnergyLoss(target, block, disc_weight)
    adam = Adam(1e-3)
    opt = adam.init(state.leaves())
    losses, starts = [], []
    t0 = time.perf_counter()
    first = last = None
    for i in range(iterations):
        starts.append(time.perf_counter())
        loss, spec_l, disc, opt = energy_step(state, adam, opt, loss_fn)
        losses.append(loss)
        if i % 50 == 0:
            last = float(loss)
            first = last if first is None else first
            log(f"iter {i} loss {last:.2f} (spec {float(spec_l):.2f} disc {float(disc):.3f})")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    if iterations:
        log(f"done: {iterations} iters in {t_end - t0:.1f}s ({iterations / (t_end - t0):.1f} "
            f"steps/s), loss {first:.1f} -> {last:.1f}")
    return EnergyRun(state, torch.stack(losses).tolist() if losses else [], starts, t_end)
