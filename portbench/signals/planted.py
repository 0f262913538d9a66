"""Planted events: per item ``n_steps + extra_plants`` atoms of the given
unit-norm dictionary (distinct where there are enough) at uniform interior
positions and amplitudes ``amp0 * decay**k``, one more atom cut to its
first ``clip_taps`` taps at the very end (amplitudes ``clip_amps`` in turn),
so that the coder's clipped-tail path runs, and Gaussian noise of standard
deviation ``noise``. Each step of a greedy coder then has a clear winner,
as in coding audio with a trained dictionary."""

from __future__ import annotations

import torch


def make(spec, *, batch, n_samples, n_steps, gen, device, dictionary):
    N, A = dictionary.shape
    plants = n_steps + spec["extra_plants"]
    if plants <= N:
        atoms = torch.rand((batch, N), generator=gen, device=device).argsort(-1)[:, :plants]
    else:
        atoms = torch.randint(0, N, (batch, plants), generator=gen, device=device)
    pos = torch.randint(0, n_samples - A, (batch, plants), generator=gen, device=device)
    amps = spec["amp0"] * spec["decay"] ** torch.arange(plants, device=device, dtype=torch.float64)
    # one row per plant, summed by a reduction: the same bits on every run
    dense = torch.zeros((batch, plants, n_samples), device=device)
    cols = pos[..., None] + torch.arange(A, device=device)
    dense.scatter_(2, cols, amps.float()[:, None] * dictionary[atoms])
    sig = dense.sum(1)
    del dense
    taps = min(spec["clip_taps"], A - 1)
    clip_atom = torch.randint(0, N, (batch,), generator=gen, device=device)
    items = torch.arange(batch, device=device)
    clip_amp = torch.tensor(spec["clip_amps"], device=device)[items % len(spec["clip_amps"])]
    sig[:, n_samples - taps :] += dictionary[clip_atom, :taps] * clip_amp[:, None]
    sig += spec["noise"] * torch.randn((batch, n_samples), generator=gen, device=device)
    return sig[:, None, :]
