"""One audio segment from a URL (counterpart of ``mptpu/data/fetch.py``):
fetch, decode, resample, slice and zero-pad.

The transport is pluggable: ``default_transport`` reads ``file://`` URLs
and plain paths, and ``http(s)`` URLs through ``urllib``; pass
``transport=`` (a ``url -> bytes`` callable) for any other store.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Optional

import numpy as np

from ..utils.wav import fft_resample_np, read_wav


def default_transport(url: str) -> bytes:
    """The bytes at ``url``: a ``file://`` URL or an existing path from the
    disk, an ``http(s)`` URL through ``urllib``."""
    if url.startswith("file://"):
        with open(url[len("file://"):], "rb") as f:
            return f.read()
    if os.path.exists(url):
        with open(url, "rb") as f:
            return f.read()
    if url.startswith(("http://", "https://")):
        from urllib.request import urlopen

        with urlopen(url, timeout=30) as resp:
            return resp.read()
    raise ValueError(f"unsupported url: {url!r}")


def get_audio_segment(url: str, target_samplerate: int, start_sample: int,
                      duration_samples: int,
                      transport: Optional[Callable[[str], bytes]] = None) -> np.ndarray:
    """Samples ``[start_sample, start_sample + duration_samples)`` of the WAV
    at ``url`` resampled to ``target_samplerate`` (``fft_resample_np``),
    zero-padded to ``duration_samples``, float32."""
    raw = (transport or default_transport)(url)
    samples, sr = read_wav(io.BytesIO(raw))
    if sr != target_samplerate:
        samples = fft_resample_np(samples, sr, target_samplerate)
    segment = samples[start_sample: start_sample + duration_samples]
    diff = duration_samples - segment.shape[0]
    if diff > 0:
        segment = np.pad(segment, [(0, diff)])
    return segment.astype(np.float32)
