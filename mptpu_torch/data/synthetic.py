"""Synthetic audio when no dataset is mounted (counterpart of
``synthetic_audio``, ``ensure_demo_dataset`` and ``streaming_windows`` in
``mptpu/data/synthetic.py``): sums of decaying harmonic tones and noise
transients, in numpy. The same seed gives the same float32 samples as
``mptpu``, draw for draw, and the same WAV corpus, so both packages fit
and score one target.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.wav import write_wav


def synthetic_audio(
    n_samples: int,
    samplerate: int = 22050,
    n_events: int = 16,
    seed: int = 0,
    sustained: bool = False,
) -> np.ndarray:
    """One mono segment of decaying-harmonic events (float32, max-normed).

    ``sustained=True`` adds slow-decay pedal tones underneath, so that the
    segment has energy everywhere, as dense music does.
    """
    rng = np.random.default_rng(seed)
    out = np.zeros(n_samples, dtype=np.float64)
    t = np.arange(n_samples) / samplerate
    for _ in range(n_events):
        f0 = rng.uniform(55.0, 1760.0)
        start = rng.integers(0, max(1, n_samples - samplerate // 4))
        dur = int(rng.uniform(0.05, 0.5) * samplerate)
        dur = min(dur, n_samples - start)
        env = np.exp(-np.linspace(0, rng.uniform(3, 12), dur))
        seg = np.zeros(dur)
        for h in range(1, 6):
            if f0 * h < samplerate / 2:
                seg += rng.uniform(0.2, 1.0) / h * np.sin(
                    2 * np.pi * f0 * h * t[:dur] + rng.uniform(0, 2 * np.pi)
                )
        # noise attack transient
        attack = min(256, dur)
        seg[:attack] += rng.standard_normal(attack) * np.linspace(1, 0, attack) * 0.5
        out[start : start + dur] += seg * env * rng.uniform(0.3, 1.0)
    if sustained:
        # pedal tones: long overlapping notes covering the whole segment
        n_pedal = max(4, int(n_samples / samplerate * 1.5))
        for _ in range(n_pedal):
            f0 = rng.uniform(65.0, 880.0)
            start = rng.integers(0, max(1, int(n_samples * 0.9)))
            dur = int(rng.uniform(1.0, 4.0) * samplerate)
            dur = min(dur, n_samples - start)
            env = np.exp(-np.linspace(0, rng.uniform(0.5, 2.0), dur))
            seg = np.zeros(dur)
            for h in range(1, 8):
                if f0 * h < samplerate / 2:
                    seg += rng.uniform(0.2, 1.0) / h * np.sin(
                        2 * np.pi * f0 * h * t[:dur] + rng.uniform(0, 2 * np.pi)
                    )
            out[start : start + dur] += seg * env * rng.uniform(0.2, 0.6)
    mx = np.abs(out).max() + 1e-8
    return (out / mx).astype(np.float32)


def ensure_demo_dataset(directory: str, n_files: int = 4, seconds: float = 12.0,
                        samplerate: int = 22050, dense: bool = False,
                        seed_offset: int = 0) -> str:
    """Write a small synthetic WAV corpus into ``directory`` unless it holds
    one of the kind asked for, and return ``directory``.

    File ``i`` is ``synthetic_audio(seconds * samplerate, seed=seed_offset
    + i)`` with 16 events, or with ``dense`` eight events a second over
    sustained pedal tones, under the prefix ``synthetic_`` or
    ``synthetic_dense_``. Writing one kind removes the other's files, since
    every reader streams the directory's ``*.wav``."""
    os.makedirs(directory, exist_ok=True)
    prefix = "synthetic_dense_" if dense else "synthetic_"

    def is_kind(f: str, want_dense: bool) -> bool:
        if not (f.startswith("synthetic_") and f.endswith(".wav")):
            return False
        return f.startswith("synthetic_dense_") == want_dense

    names = os.listdir(directory)
    if not any(is_kind(f, dense) for f in names):
        for stale in names:
            if is_kind(stale, not dense):
                try:
                    os.remove(os.path.join(directory, stale))
                except OSError:
                    pass
        n = int(seconds * samplerate)
        n_events = int(seconds * 8) if dense else 16
        for i in range(n_files):
            write_wav(os.path.join(directory, f"{prefix}{i}.wav"),
                      synthetic_audio(n, samplerate, n_events=n_events, seed=seed_offset + i,
                                      sustained=dense),
                      samplerate)
    return directory


def streaming_windows(seg: np.ndarray, n_samples: int, n_win: int) -> np.ndarray:
    """The ``n_win`` half-overlap windows of ``n_samples`` that a streaming
    walk visits over ``seg``, stacked ``(n_win, n_samples)``: window ``w``
    starts at ``w * n_samples // 2``. Raises when ``seg`` is shorter than
    ``n_samples + (n_win - 1) * n_samples // 2``."""
    half = n_samples // 2
    needed = n_samples + (n_win - 1) * half
    if seg.shape[-1] < needed:
        raise ValueError(
            f"segment of {seg.shape[-1]} samples too short for {n_win} "
            f"half-overlap windows of {n_samples} (need {needed})"
        )
    return np.stack([seg[w * half : w * half + n_samples] for w in range(n_win)])
