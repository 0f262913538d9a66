"""File discovery, memoised decode and endless batch streams of numpy
audio (counterpart of ``mptpu/data/datastore.py``).

Decoded signals are kept in the sqlite collection ``<cache>/audio.db``
under ``audio:<path>:<samplerate>``, the key and file ``mptpu`` uses, so
the two packages share one cache. Without an audio directory the streams
read the synthetic demo corpus, written under the cache on first use. The
same ``seed`` and corpus give ``mptpu``'s batches bit for bit.
"""

from __future__ import annotations

import os
from fnmatch import fnmatch
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np

from ..config import audio_path, cache_path
from ..utils.wav import fft_resample_np, read_wav
from .kv import KVCollection
from .synthetic import ensure_demo_dataset


def audio_collection() -> KVCollection:
    """The decoded-audio collection under the current ``cache_path()``."""
    return KVCollection(os.path.join(cache_path(), "audio"))


def iter_files(base_path, pattern: Union[str, List[str]]):
    """Every file under ``base_path`` (recursively, in ``os.walk``'s
    order) whose full path matches ``pattern`` or one of a list of them."""

    def matches(path):
        if isinstance(pattern, str):
            return fnmatch(path, pattern)
        return any(fnmatch(path, p) for p in pattern)

    for dirpath, _, filenames in os.walk(base_path):
        for fn in filenames:
            full = os.path.join(dirpath, fn)
            if matches(full):
                yield full


def iter_files_in_random_order(base_path, pattern, rng: np.random.Generator | None = None):
    """``iter_files``' files in the order of ``rng.permutation`` (a fresh
    ``np.random.default_rng()`` when None), ``mptpu``'s order for the same
    generator."""
    filenames = list(iter_files(base_path, pattern))
    rng = rng or np.random.default_rng()
    yield from (filenames[i] for i in rng.permutation(len(filenames)))


def _decode(path: str, samplerate: int = 22050) -> np.ndarray:
    x, sr = read_wav(path, mono=True)
    if sr != samplerate:
        x = fft_resample_np(x, sr, samplerate)
    return x.astype(np.float32)


def audio(path: str, samplerate: int = 22050,
          collection: Optional[KVCollection] = None) -> np.ndarray:
    """The mono float32 samples of the WAV at ``path``, resampled to
    ``samplerate``: from ``collection`` (default ``audio_collection()``)
    when there, else decoded and stored there."""
    coll = collection if collection is not None else audio_collection()
    key = f"audio:{path}:{samplerate}"
    try:
        return coll.get(key)
    except KeyError:
        x = _decode(path, samplerate)
        coll.put(key, x)
        return x


def _resolve_path(path=None) -> str:
    """``path``, else ``config.audio_path()``; when that is no directory
    holding a ``*.wav``, the demo corpus under ``cache_path()``."""
    path = path or audio_path()
    if path is None or not os.path.isdir(path) or not any(True for _ in iter_files(path, "*.wav")):
        path = ensure_demo_dataset(os.path.join(cache_path(), "demo_audio"))
    return path


def batch_stream(path, pattern: Union[str, List[str]], batch_size: int, n_samples: int,
                 overfit: bool = False, normalize: bool = False, step_size: int = 1,
                 return_indices: bool = False, seed: int | None = None):
    """An endless stream of (batch_size, n_samples) float32 batches (with
    each item's (start, end) when ``return_indices``): a file drawn at
    random, padded with zeros to twice ``n_samples`` when shorter, a window
    at a random multiple of ``step_size``, drawn again (up to 8 times) while
    silent; each item divided by its largest magnitude with ``normalize``.
    ``overfit`` repeats one batch of one item. Draws come from
    ``np.random.default_rng(seed)`` in ``mptpu``'s order."""
    path = _resolve_path(path)
    paths = list(iter_files(path, pattern))
    if not paths:
        raise FileNotFoundError(f"no files matching {pattern} under {path}")
    collection = audio_collection()
    rng = np.random.default_rng(seed)
    batch_size = 1 if overfit else batch_size

    while True:
        batch = np.zeros((batch_size, n_samples), dtype=np.float32)
        indices = []
        for i in range(batch_size):
            # a window can land wholly in the zero padding or in recorded
            # silence, and a silent target makes an energy-matching loss
            # degenerate
            for _attempt in range(8):
                p = paths[rng.integers(len(paths))]
                data = audio(p, collection=collection)
                diff = int(np.clip((n_samples * 2) - data.shape[-1], 0, np.inf))
                if diff > 0:
                    data = np.concatenate([data, np.zeros(diff, np.float32)])
                positions = (data.shape[0] - n_samples) // step_size
                start = int(rng.integers(0, positions)) * step_size
                end = start + n_samples
                if float(np.abs(data[start:end]).max()) > 1e-4:
                    break
            indices.append((start, end))
            batch[i] = data[start:end]

        if normalize:
            batch = batch / (np.abs(batch).max(axis=-1, keepdims=True) + 1e-12)

        yield (batch, indices) if return_indices else batch

        if overfit:
            while True:
                yield (batch, indices) if return_indices else batch


def iter_chunks(path, pattern, chunksize: int) -> Iterable[Tuple[str, int, int]]:
    """(file, start, stop) of every ``chunksize`` chunk of every matching
    file, in ``iter_files``' order."""
    collection = audio_collection()
    for fp in iter_files(_resolve_path(path), pattern):
        data = audio(fp, collection=collection)
        for i in range(0, len(data), chunksize):
            yield fp, i, i + chunksize


def iter_audio_segments(path, pattern, chunksize: int,
                        make_key=lambda fp, start, stop: f"{fp}_{start}_{stop}",
                        rng: np.random.Generator | None = None
                        ) -> Iterable[Tuple[str, np.ndarray]]:
    """(key, (1, 1, chunksize) float32 chunk) of every whole chunk but a
    last that ends the file, files in ``iter_files_in_random_order``'s order
    under ``rng``, each chunk divided by its largest value plus 1e-8."""
    collection = audio_collection()
    for fp in iter_files_in_random_order(_resolve_path(path), pattern, rng):
        data = audio(fp, collection=collection).reshape(1, 1, -1)
        for i in range(0, data.shape[-1] - chunksize, chunksize):
            chunk = data[:, :, i: i + chunksize]
            yield make_key(fp, i, i + chunksize), chunk / (chunk.max() + 1e-8)
