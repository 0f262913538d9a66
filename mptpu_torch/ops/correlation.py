"""Matching-pursuit correlation (counterpart of ``mptpu/ops/correlation.py``).

``out[b, a, t] = sum_k residual[b, c, t + k] * atoms[a, c, k]`` for ``t``
in ``[0, n_samples)``, with the residual read as zero past its end. The
dense path is ``F.conv1d`` (a cross-correlation) on the right-padded
signal, in full float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import no_tf32
from .fft import next_pow2


def torch_style_conv(signal: torch.Tensor, atoms: torch.Tensor) -> torch.Tensor:
    """Dense MP correlation.

    signal: (batch, channels, n_samples)
    atoms:  (n_atoms, channels, atom_size) or (n_atoms, atom_size)
    returns (batch, n_atoms, n_samples)
    """
    if atoms.ndim == 2:
        atoms = atoms[:, None, :]
    n_samples = signal.shape[-1]
    padded = F.pad(signal, (0, atoms.shape[-1]))
    with no_tf32():
        out = F.conv1d(padded, atoms)
    return out[..., :n_samples]


def _spectra(signal: torch.Tensor, atoms: torch.Tensor):
    """Signal spectrum and conjugate atom spectra, power-of-two padded."""
    fft_len = next_pow2(signal.shape[-1] + atoms.shape[-1])
    sig = torch.fft.rfft(signal, n=fft_len, dim=-1)               # (B, C, F)
    atom = torch.conj(torch.fft.rfft(atoms, n=fft_len, dim=-1))   # (N, C, F)
    return sig, atom, fft_len


def _fft_correlate(signal: torch.Tensor, atoms: torch.Tensor) -> torch.Tensor:
    """Cross-correlation via the conjugate rFFT product."""
    if atoms.ndim == 2:
        atoms = atoms[:, None, :]
    sig, atom, fft_len = _spectra(signal, atoms)
    spec = torch.einsum("bcf,acf->baf", sig, atom)
    return torch.fft.irfft(spec, n=fft_len, dim=-1)[..., : signal.shape[-1]]


def mp_correlate(
    signal: torch.Tensor,
    atoms: torch.Tensor,
    approx: int | slice | None = None,
    use_fft: bool = False,
) -> torch.Tensor:
    """Batched residual-vs-dictionary correlation.

    ``approx``:
      - ``slice``: keep only that slice of rFFT coefficients;
      - ``int k``: keep the top-k magnitude coefficients of the signal
        spectrum (per batch item and channel);
      - ``None``: exact correlation (``F.conv1d`` unless ``use_fft``).
    """
    if signal.ndim == 2:
        signal = signal[:, None, :]
    if approx is None:
        if use_fft:
            return _fft_correlate(signal, atoms)
        return torch_style_conv(signal, atoms)

    if atoms.ndim == 2:
        atoms = atoms[:, None, :]
    sig, atom, fft_len = _spectra(signal, atoms)
    n_coeffs = sig.shape[-1]
    if isinstance(approx, slice):
        mask = torch.zeros(n_coeffs, dtype=torch.float32, device=signal.device)
        mask[torch.arange(n_coeffs, device=signal.device)[approx]] = 1.0
    else:
        mags = torch.abs(sig)
        _, indices = torch.topk(mags, int(approx), dim=-1)
        mask = torch.zeros_like(mags).scatter_(-1, indices, 1.0)
    spec = torch.einsum("bcf,acf->baf", sig * mask, atom)
    return torch.fft.irfft(spec, n=fft_len, dim=-1)[..., : signal.shape[-1]]
