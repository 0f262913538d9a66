"""Audio as bytes and as a playable array (counterpart of
``mptpu/utils/playable.py``)."""

from __future__ import annotations

import io
import wave

import numpy as np


def encode_audio(samples, samplerate: int = 22050) -> bytes:
    """Float samples -> mono 16-bit PCM WAV bytes, clipped to [-1, 1]."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    ints = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(samplerate)
        w.writeframes(ints.tobytes())
    return buf.getvalue()


def playable(x, samplerate: int = 22050, normalize: bool = True) -> np.ndarray:
    """Mono float32 samples of anything array-like (a tensor is taken to
    the host), divided by their largest magnitude + 1e-8 when
    ``normalize``."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    if normalize:
        x = x / (np.abs(x).max() + 1e-8)
    return x
