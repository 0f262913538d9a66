"""Frozen counts of the work the cells need, and the cards' peaks.

The counts follow the algorithm's shapes, not an implementation, so they
read the same work whatever computes it.

- A greedy loop's bound (``loop_bytes``, ``loop_flops``): per item-step the
  chosen atom's gram row read, N (2A - 1) floats, and the correlation
  window around the event read and written, N (2A - 1) floats each way;
  per item the signal read once and the events (three words a step) and the
  residual written once. The window is the 2A - 1 lags an event touches, not
  a kernel's block-aligned span, so the count depends on no block size. The
  update's arithmetic is 2 N (2A - 1) operations per item-step.
- A correlation's operations (``correlation_flops``, ``gram_flops``): the
  smaller of the direct count (2 x the multiply-adds of the overlapping
  taps) and the FFT count (real FFTs of the padded length L, a power of two,
  at 2.5 L log2 L each, and 6 operations per complex product), so that an
  exact implementation of either kind stays under the peak.

Peaks are NVIDIA's data-sheet figures (dense, no sparsity): memory bytes/s
and float32 operations/s outside the tensor cores.
"""

from __future__ import annotations

import math

F32 = 4

# card name (``torch.cuda.get_device_name``) -> (memory bytes/s, float32
# operations/s)
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}


def device_peaks(kind: str) -> tuple[float, float]:
    """The peaks of the card named ``kind``; a card with no entry is an
    error, not another card's peaks."""
    if kind not in PEAKS:
        raise ValueError(f"no data-sheet peaks for {kind!r}: add them to roofline.PEAKS")
    return PEAKS[kind]


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def loop_bytes(n_atoms: int, atom_size: int, n_samples: int, items: int, steps: int) -> int:
    window = n_atoms * (2 * atom_size - 1)
    return F32 * (items * steps * 3 * window + items * (2 * n_samples + 3 * steps))


def loop_flops(n_atoms: int, atom_size: int, items: int, steps: int) -> int:
    return 2 * n_atoms * (2 * atom_size - 1) * items * steps


def bound_s(bytes_: float, flops: float, peaks: tuple[float, float]) -> float:
    """The least time the card could take: bytes over bandwidth or
    operations over the float32 peak, whichever is larger."""
    return max(bytes_ / peaks[0], flops / peaks[1])


def fft_flops(length: int) -> float:
    """A real FFT (or its inverse) of ``length`` points."""
    return 2.5 * length * math.log2(length)


def correlation_direct_flops(batch: int, n_atoms: int, n_samples: int, atom_size: int) -> int:
    """``out[b, a, t] = sum_k x[b, t + k] d[a, k]`` for ``t < n_samples``
    with ``x`` zero past its end: positions whose window fits take A taps,
    the last A - 1 positions take A - 1 down to 1."""
    if n_samples >= atom_size:
        taps = atom_size * (n_samples - atom_size + 1) + atom_size * (atom_size - 1) // 2
    else:
        taps = n_samples * (n_samples + 1) // 2
    return 2 * batch * n_atoms * taps


def correlation_fft_flops(batch: int, n_atoms: int, n_samples: int, atom_size: int) -> float:
    length = next_pow2(n_samples + atom_size - 1)
    per_pair = 6 * (length // 2 + 1) + fft_flops(length)
    return (batch + n_atoms) * fft_flops(length) + batch * n_atoms * per_pair


def correlation_flops(batch: int, n_atoms: int, n_samples: int, atom_size: int) -> float:
    return min(correlation_direct_flops(batch, n_atoms, n_samples, atom_size),
               correlation_fft_flops(batch, n_atoms, n_samples, atom_size))


def gram_direct_flops(n_atoms: int, atom_size: int) -> int:
    """Every lag of every pair of atoms: A^2 overlapping taps a pair."""
    return 2 * n_atoms * n_atoms * atom_size * atom_size


def gram_fft_flops(n_atoms: int, atom_size: int) -> float:
    length = next_pow2(2 * atom_size - 1)
    per_pair = 6 * (length // 2 + 1) + fft_flops(length)
    return n_atoms * fft_flops(length) + n_atoms * n_atoms * per_pair


def gram_flops(n_atoms: int, atom_size: int) -> float:
    return min(gram_direct_flops(n_atoms, atom_size), gram_fft_flops(n_atoms, atom_size))


def encode_flops(batch: int, n_atoms: int, n_samples: int, atom_size: int, steps: int) -> float:
    """One greedy encode without its gram: the initial map and the updates."""
    return (correlation_flops(batch, n_atoms, n_samples, atom_size)
            + loop_flops(n_atoms, atom_size, batch, steps))


def band_split_flops(batch: int, n_samples: int, sizes) -> float:
    """The octave split: one real FFT of the signal, one inverse a band."""
    return batch * (fft_flops(n_samples) + sum(fft_flops(s) for s in sizes))
