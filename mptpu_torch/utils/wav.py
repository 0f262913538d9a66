"""WAV files with numpy alone (counterpart of ``mptpu/utils/wav.py``):
``read_wav`` reads PCM 8, 16, 24, 32 bit and float 32, 64 bit RIFF files,
multichannel mixed to mono on request; ``write_wav`` writes 16-bit PCM;
``fft_resample_np`` resamples a whole signal through its spectrum."""

from __future__ import annotations

import struct
import wave

import numpy as np


def read_wav(path, mono: bool = True) -> tuple[np.ndarray, int]:
    """(float32 samples in [-1, 1], samplerate) of the file at ``path``, or
    of an open binary file."""
    if hasattr(path, "read"):
        return _read_wav(path, getattr(path, "name", "<file>"), mono)
    with open(path, "rb") as f:
        return _read_wav(f, path, mono)


def _read_wav(f, path, mono: bool) -> tuple[np.ndarray, int]:
    riff = f.read(12)
    if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a RIFF/WAVE file")
    fmt = data = None
    while True:
        header = f.read(8)
        if len(header) < 8:
            break
        chunk_id, size = struct.unpack("<4sI", header)
        payload = f.read(size)
        if size % 2:
            f.read(1)
        if chunk_id == b"fmt ":
            fmt = payload
        elif chunk_id == b"data":
            data = payload
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, samplerate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:   # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:   # PCM
        if bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128) / 128
        elif bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            ints = (raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / (1 << 23)
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / (1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_format == 3:   # IEEE float
        x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")

    if channels > 1:
        x = x.reshape(-1, channels)
        if mono:
            x = x.mean(axis=-1)
    return np.ascontiguousarray(x), samplerate


def write_wav(path: str, samples: np.ndarray, samplerate: int = 22050) -> None:
    """Write float samples, clipped to [-1, 1], as mono 16-bit PCM."""
    clipped = np.clip(np.asarray(samples).reshape(-1), -1.0, 1.0)
    ints = (clipped * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(samplerate)
        w.writeframes(ints.tobytes())


def fft_resample_np(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """``x`` at ``orig_sr`` resampled to ``target_sr`` by truncating or
    zero-padding its whole rFFT (float32)."""
    if orig_sr == target_sr:
        return x
    n = len(x)
    new_n = int(round(n * target_sr / orig_sr))
    spec = np.fft.rfft(x)
    new_spec = np.zeros(new_n // 2 + 1, dtype=spec.dtype)
    k = min(len(spec), len(new_spec))
    new_spec[:k] = spec[:k]
    return np.fft.irfft(new_spec, new_n).astype(np.float32) * (new_n / n)
