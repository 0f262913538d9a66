"""Iterators of audio batches as tensors (counterpart of
``mptpu/data/audioiter.py``): ``batch_stream``'s numpy batches shaped
(batch, 1, n_samples), as float32 tensors on ``default_device(device)``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from ..device import default_device
from .datastore import batch_stream


def audio_stream(batch_size: int, n_samples: int, overfit: bool = False,
                 normalize: bool = False, step_size: int = 1,
                 pattern: Union[str, List[str]] = "*.wav", as_tensor: bool = True,
                 return_indices: bool = False, audio_path: Optional[str] = None,
                 seed: Optional[int] = None, device=None):
    """``batch_stream``'s batches reshaped (batch, 1, n_samples): tensors on
    ``default_device(device)``, or numpy arrays unless ``as_tensor``."""
    dev = default_device(device) if as_tensor else None
    stream = batch_stream(audio_path, pattern, batch_size, n_samples, overfit=overfit,
                          normalize=normalize, step_size=step_size,
                          return_indices=return_indices, seed=seed)
    for item in stream:
        batch, indices = item if return_indices else (item, None)
        batch = batch.reshape(-1, 1, n_samples)
        if as_tensor:
            batch = torch.from_numpy(batch).to(dev)
        yield (batch, indices) if return_indices else batch


class AudioIterator:
    """A re-iterable ``audio_stream`` of fixed settings."""

    def __init__(self, batch_size: int, n_samples: int, samplerate: int = 22050,
                 normalize: bool = False, overfit: bool = False, step_size: int = 1,
                 pattern: Union[str, List[str]] = "*.wav", as_tensor: bool = True,
                 return_indices: bool = False, audio_path: Optional[str] = None,
                 seed: Optional[int] = None, device=None):
        self.batch_size = batch_size
        self.n_samples = n_samples
        self.samplerate = samplerate
        self.normalize = normalize
        self.overfit = overfit
        self.step_size = step_size
        self.pattern = pattern
        self.as_tensor = as_tensor
        self.return_indices = return_indices
        self.audio_path = audio_path
        self.seed = seed
        self.device = device

    def __iter__(self):
        return audio_stream(self.batch_size, self.n_samples, self.overfit, self.normalize,
                            step_size=self.step_size, pattern=self.pattern,
                            as_tensor=self.as_tensor, return_indices=self.return_indices,
                            audio_path=self.audio_path, seed=self.seed, device=self.device)


def get_one_audio_segment(n_samples: int, samplerate: int = 22050,
                          pattern: Union[str, Tuple[str, ...]] = "*.wav",
                          audio_path: Optional[str] = None, seed: Optional[int] = None,
                          device=None) -> torch.Tensor:
    """One max-normalised segment (1, 1, n_samples) on
    ``default_device(device)``."""
    return get_one_audio_batch(1, n_samples, samplerate, pattern, audio_path, seed, device)


def get_one_audio_batch(batch_size: int, n_samples: int, samplerate: int = 22050,
                        pattern: Union[str, Tuple[str, ...]] = "*.wav",
                        audio_path: Optional[str] = None, seed: Optional[int] = None,
                        device=None) -> torch.Tensor:
    """The first batch of an overfit stream, max-normalised, (-1, 1,
    n_samples) on ``default_device(device)``: one item, whatever
    ``batch_size``, as in ``mptpu``."""
    ai = AudioIterator(batch_size=batch_size, n_samples=n_samples, samplerate=samplerate,
                       normalize=True, overfit=True, pattern=pattern, audio_path=audio_path,
                       seed=seed, device=device)
    return next(iter(ai)).reshape(-1, 1, n_samples)
