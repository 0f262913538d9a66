"""Greedy matching pursuit (counterpart of ``mptpu/sparse/matching_pursuit.py``).

Events come back as dense ``(n_steps, batch)`` arrays of (atom index,
position, value). Atoms that run past the signal end are clipped: energy
scattered past the end is dropped and reads past the end see zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.correlation import mp_correlate
from ..ops.norms import unit_norm


class SparseCodeResult(NamedTuple):
    """Step-major event list, one event per batch item per step."""

    atom_indices: torch.Tensor  # (n_steps, batch) int32
    positions: torch.Tensor     # (n_steps, batch) int32
    values: torch.Tensor        # (n_steps, batch) float32
    residual: torch.Tensor      # (batch, channels, n_samples)


def _normalize_dict(d: torch.Tensor) -> torch.Tensor:
    """Unit-norm each atom over all non-leading dims."""
    return unit_norm(d.reshape(d.shape[0], -1)).reshape(d.shape)


def _as3d(d: torch.Tensor) -> torch.Tensor:
    return d if d.ndim == 3 else d[:, None, :]


def _subtract_event(residual, atoms, positions, values):
    """Subtract ``values[b] * atoms[b]`` from each (channels, n_samples)
    residual row at ``positions[b]``, clipping anything past the end.

    residual (B, C, n); atoms (B, C, A); positions (B,); values (B,).
    Returns a new tensor.
    """
    batch, channels, n_samples = residual.shape
    atom_size = atoms.shape[-1]
    padded = torch.nn.functional.pad(residual, (0, atom_size))
    rows = torch.arange(batch, device=residual.device)[:, None, None]
    chans = torch.arange(channels, device=residual.device)[None, :, None]
    cols = (positions.long()[:, None] + torch.arange(atom_size, device=residual.device))[:, None, :]
    # product and difference round separately, as mptpu's ``seg - v * atom``
    prod = values[:, None, None] * atoms
    padded[rows, chans, cols] = padded[rows, chans, cols] - prod
    return padded[..., :n_samples]


def sparse_code(
    signal: torch.Tensor,
    d: torch.Tensor,
    n_steps: int = 100,
    approx=None,
    use_fft: bool = False,
) -> SparseCodeResult:
    """Greedy sparse coding: ``n_steps`` rounds of correlate / pick the
    single best (atom, shift) per batch item / subtract.

    signal: (batch, channels, n_samples) or (batch, n_samples)
    d: (n_atoms, atom_size) or (n_atoms, channels, atom_size), unit-normed
    internally.
    """
    if signal.ndim == 2:
        signal = signal[:, None, :]
    batch, channels, n_samples = signal.shape
    d3 = _normalize_dict(_as3d(d))
    residual = signal
    atoms, positions, values = [], [], []
    for _ in range(n_steps):
        fm = mp_correlate(residual, d3, approx=approx, use_fft=use_fft)
        flat = fm.reshape(batch, -1)
        idx = torch.argmax(flat, dim=-1)
        value = flat.gather(1, idx[:, None])[:, 0]
        atom_index = (idx // n_samples).to(torch.int32)
        position = (idx % n_samples).to(torch.int32)
        residual = _subtract_event(residual, d3[atom_index.long()], position, value)
        atoms.append(atom_index)
        positions.append(position)
        values.append(value)
    return SparseCodeResult(
        torch.stack(atoms), torch.stack(positions), torch.stack(values), residual
    )


def scatter_events(
    atom_indices: torch.Tensor,
    positions: torch.Tensor,
    values: torch.Tensor,
    d: torch.Tensor,
    n_samples: int,
    channels: int = 1,
    batch: int | None = None,
) -> torch.Tensor:
    """Render an event list back to a signal: sum value * atom at each
    position, dropping energy past the signal end."""
    d3 = _as3d(d)
    atom_size = d3.shape[-1]
    S, B = atom_indices.shape
    if batch is None:
        batch = B
    dev = d3.device
    contrib = values[..., None, None] * d3[atom_indices.long()]   # (S, B, C, A)
    padded = torch.zeros((batch, channels, n_samples + atom_size), dtype=contrib.dtype, device=dev)
    window = positions.long()[..., None] + torch.arange(atom_size, device=dev)  # (S, B, A)
    b_idx = torch.arange(B, device=dev)[None, :, None].expand(window.shape)
    for c in range(channels):
        padded[:, c].index_put_((b_idx, window), contrib[:, :, c, :], accumulate=True)
    return padded[..., :n_samples]


def reconstruct_from_events(result: SparseCodeResult, d: torch.Tensor) -> torch.Tensor:
    batch, channels, n_samples = result.residual.shape
    return scatter_events(
        result.atom_indices,
        result.positions,
        result.values,
        _normalize_dict(_as3d(d)),
        n_samples,
        channels=channels,
        batch=batch,
    )
