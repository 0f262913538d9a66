"""Musical scales (counterpart of ``mptpu/utils/music.py``), in numpy."""

from __future__ import annotations

import numpy as np


def midi_to_hz(n) -> np.ndarray:
    return 440.0 * (2.0 ** ((np.asarray(n, dtype=np.float64) - 69) / 12))


def musical_scale_hz(start_midi: int = 21, stop_midi: int = 106, n_steps: int = 512) -> np.ndarray:
    return midi_to_hz(np.linspace(start_midi, stop_midi, n_steps))
