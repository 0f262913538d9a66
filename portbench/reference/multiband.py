"""The octave filterbank and the band decoder, in NumPy float64.

The split (the reference repository's ``modules/multibanddict.py`` over its
``fft_frequency_decompose``): an orthonormal real FFT of the signal; the
band of ``s`` samples takes coefficients ``[s/4, s/2]`` (the lowest band
all of ``[0, s/2]``), the imaginary parts of its first and last set to 0,
and an orthonormal inverse of ``s`` points. A band decodes by adding each
event's value x atom at its position, dropping what runs past the band's
end; the bands are resampled to the signal's length by placing each band's
spectrum (its upper half, all of it for the lowest band) into the matching
coefficients, and summed.

``rounding`` (``"float32"``, ``"float16"``), where given, rounds every
FFT's output, and a rendered band, to that type: the controls, the
configuration's complex64 FFTs with TF32 products, and complex32 FFTs.
"""

from __future__ import annotations

import numpy as np


def _maybe(x: np.ndarray, rounding: str | None) -> np.ndarray:
    """``x`` rounded to ``rounding``'s nearest values, as float64 (complex128
    for complex ``x``); unchanged where ``rounding`` is None."""
    if rounding is None:
        return x
    if np.iscomplexobj(x):
        return _maybe(x.real, rounding) + 1j * _maybe(x.imag, rounding)
    return x.astype(rounding).astype(np.float64)


def band_sizes(n_samples: int, min_size: int) -> list[int]:
    sizes, s = [], min_size
    while s <= n_samples:
        sizes.append(s)
        s *= 2
    return sizes


def decompose(x: np.ndarray, min_size: int,
              rounding: str | None = None) -> dict[int, np.ndarray]:
    """``x`` (B, n) -> {band size: (B, size)}."""
    coeffs = _maybe(np.fft.rfft(x, axis=-1, norm="ortho"), rounding)
    out = {}
    for s in band_sizes(x.shape[-1], min_size):
        sl = coeffs[..., : s // 2 + 1].copy()
        if s > min_size:
            sl[..., : s // 4] = 0.0
        sl[..., 0] = sl[..., 0].real
        sl[..., -1] = sl[..., -1].real
        out[s] = _maybe(np.fft.irfft(sl, n=s, axis=-1, norm="ortho"), rounding)
    return out


def render(d: np.ndarray, atoms: np.ndarray, positions: np.ndarray, values: np.ndarray,
           size: int, rounding: str | None = None) -> np.ndarray:
    """The band (B, size) of the events (each (S, B)) with atoms ``d``
    (N, A); positions out of range give NaN."""
    S, B = atoms.shape
    A = d.shape[-1]
    if atoms.min() < 0 or atoms.max() >= d.shape[0] or positions.min() < 0 \
            or positions.max() >= size:
        return np.full((B, size), np.nan)
    out = np.zeros((B, size + A))
    rows = np.tile(np.arange(B), S)[:, None]
    cols = positions.reshape(-1).astype(np.int64)[:, None] + np.arange(A)
    np.add.at(out, (rows, cols), values.reshape(-1, 1).astype(np.float64) * d[atoms.reshape(-1)])
    return _maybe(out[:, :size], rounding)


def resample(band: np.ndarray, n_samples: int, lowest: bool,
             rounding: str | None = None) -> np.ndarray:
    coeffs = _maybe(np.fft.rfft(band, axis=-1, norm="ortho"), rounding)
    n_coeffs = coeffs.shape[-1]
    new = np.zeros((*coeffs.shape[:-1], n_samples // 2 + 1), dtype=np.complex128)
    lo = 0 if lowest else n_coeffs // 2
    new[..., lo:n_coeffs] = coeffs[..., lo:]
    return _maybe(np.fft.irfft(new, n=n_samples, axis=-1, norm="ortho"), rounding)


def decode(dicts: dict[int, np.ndarray], events: dict[int, tuple], n_samples: int,
           rounding: str | None = None) -> np.ndarray:
    """{size: (atoms, positions, values)} with unit-norm ``dicts`` ->
    (B, n_samples)."""
    lowest = min(events)
    out = None
    for s, (atoms, positions, values) in events.items():
        band = render(dicts[s], atoms, positions, values, s, rounding)
        up = resample(band, n_samples, s == lowest, rounding)
        out = up if out is None else out + up
    return out
