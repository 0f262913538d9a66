"""WAV bytes of an array of samples (counterpart of ``encode_audio`` in
``mptpu/obs/collection.py``; the logged-value collection is not ported)."""

from __future__ import annotations

import io
import wave

import numpy as np


def encode_audio(samples: np.ndarray, samplerate: int = 22050) -> bytes:
    """Mono 16-bit PCM WAV bytes of ``samples`` (NaN as 0, clipped to [-1, 1])."""
    buf = io.BytesIO()
    samples = np.nan_to_num(np.asarray(samples, dtype=np.float32).reshape(-1))
    ints = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(samplerate)
        w.writeframes(ints.tobytes())
    return buf.getvalue()
