"""Greedy matching pursuit with dictionary learning (counterpart of
``scripts/mp_train.py``, BASELINE config #1's trainer): learn a
dictionary on streamed segments and report the reconstruction SNR at a
fixed number of atoms, flat (:func:`train_flat`) or per octave band
(:func:`train_multiband`).

The learning sweep is ``dictionary_learning_step``; on a card its encode
is ``sparse_code_fast(fused=True)``, a chain of ``n_steps`` launches of
the cluster step kernel where the shapes pass the fused gate. The
reports code with the naive ``sparse_code``, as the script does.

``DEFAULTS`` are the script's (BASELINE #1's widths), ``TINY`` its
``--tiny``.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import torch

from ..data.audioiter import AudioIterator
from ..device import default_device
from ..sparse.matching_pursuit import (dictionary_learning_step, reconstruct_from_events,
                                       sparse_code)
from ..sparse.multiband import BandSpec, MultibandDictionaryLearning

DEFAULTS = dict(n_atoms=512, atom_size=512, n_samples=16384, n_steps=100, sweeps=25,
                batch_size=2)
TINY = dict(DEFAULTS, n_atoms=64, atom_size=128, n_samples=4096, n_steps=16, sweeps=4)
BAND_SIZES = (512, 1024, 2048, 4096, 8192, 16384)


class MPTrainResult(NamedTuple):
    """What a trainer leaves: the learned dictionary (flat) or model
    (multiband), the SNR before learning, and each report as (sweep,
    SNR in dB, atoms a second of the sweep's learning step (flat) or
    events of the encoding (multiband))."""

    learned: object
    initial_snr_db: float
    reports: List[Tuple[int, float, float]]


def snr_db(target: torch.Tensor, recon: torch.Tensor) -> float:
    """10 log10(energy / error energy + 1e-12), as the script computes it."""
    return float(10 * torch.log10(torch.sum(target**2)
                                  / (torch.sum((target - recon) ** 2) + 1e-12)))


def initial_dictionary(n_atoms: int, atom_size: int, seed: int = 0, device=None) -> torch.Tensor:
    """Uniform draws in [-1, 1) of (n_atoms, atom_size) from a CPU generator
    seeded with ``seed``; ``mptpu`` draws
    ``jax.random.uniform(PRNGKey(0), ..., -1, 1)``, other numbers."""
    gen = torch.Generator().manual_seed(seed)
    d = torch.rand((n_atoms, atom_size), generator=gen) * 2.0 - 1.0
    return d.to(default_device(device))


def _stream(stream, batch_size, n_samples, audio_path, dev) -> Iterator[torch.Tensor]:
    if stream is None:
        stream = AudioIterator(batch_size, n_samples, normalize=True, audio_path=audio_path,
                               device=dev)
    return (b.to(dev) for b in stream)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_flat(n_atoms: int = 512, atom_size: int = 512, n_samples: int = 16384,
               n_steps: int = 100, sweeps: int = 25, batch_size: int = 2,
               audio_path: Optional[str] = None, stream=None, d: Optional[torch.Tensor] = None,
               device=None, log: Callable[[str], None] = print) -> MPTrainResult:
    """The script's ``train_flat``: one batch for the initial SNR, then
    ``sweeps`` batches, each one ``dictionary_learning_step``, timed to the
    card's end, with a report at every fifth sweep and the last (the SNR of
    the naive coder on that sweep's batch with the new dictionary).

    Batches come from ``stream`` (an iterable of (batch, 1, n_samples)
    tensors) or else from ``AudioIterator`` over ``audio_path`` (the demo
    corpus when None); the dictionary starts from ``d`` or else
    :func:`initial_dictionary`. ``device``: ``cuda`` unless ``"cpu"`` is
    asked for."""
    dev = default_device(device)
    batches = _stream(stream, batch_size, n_samples, audio_path, dev)
    d = (initial_dictionary(n_atoms, atom_size, device=dev) if d is None else d.to(dev))

    def coded_snr(batch, d):
        return snr_db(batch, reconstruct_from_events(sparse_code(batch, d, n_steps=n_steps), d))

    batch = next(batches)
    initial = coded_snr(batch, d)
    log(f"initial recon SNR @ {n_steps} atoms: {initial:.2f} dB")
    reports = []
    for i in range(sweeps):
        batch = next(batches)
        _sync(dev)
        t0 = time.perf_counter()
        d = dictionary_learning_step(batch, d, n_steps=n_steps)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        if i % 5 == 0 or i == sweeps - 1:
            s = coded_snr(batch, d)
            rate = n_steps * batch.shape[0] / elapsed
            reports.append((i, s, rate))
            log(f"sweep {i}: recon SNR {s:.2f} dB ({rate:.1f} atoms/sec)")
    return MPTrainResult(d, initial, reports)


def multiband_model(n_atoms: int, atom_size: int, n_samples: int,
                    device=None) -> MultibandDictionaryLearning:
    """The script's bands: 512 to 16,384 samples, as many as fit in
    ``n_samples``, each ``n_atoms`` x ``atom_size`` drawn from a generator
    seeded with its size (``mptpu`` from ``PRNGKey(size)``)."""
    specs = [BandSpec(size, n_atoms=n_atoms, atom_size=atom_size, signal_samples=n_samples,
                      is_lowest_band=(size == 512), device=device)
             for size in BAND_SIZES if size <= n_samples]
    return MultibandDictionaryLearning(specs, n_samples)


def train_multiband(out: str, n_atoms: int = 512, atom_size: int = 512, n_samples: int = 16384,
                    n_steps: int = 100, sweeps: int = 25, batch_size: int = 2,
                    audio_path: Optional[str] = None, stream=None,
                    model: Optional[MultibandDictionaryLearning] = None, device=None,
                    log: Callable[[str], None] = print) -> MPTrainResult:
    """The script's ``train_multiband``: the recon SNR of one batch, then
    ``sweeps`` batches through ``learn``, with a report at every fifth
    sweep and the last (``recon``'s SNR on that batch and its number of
    events), then the band dictionaries stored into ``out`` (the script
    writes into ``trained_weights``). ``model`` is
    :func:`multiband_model` when None; ``stream`` and ``audio_path`` as in
    :func:`train_flat`."""
    dev = default_device(device)
    model = model or multiband_model(n_atoms, atom_size, n_samples, dev)
    batches = _stream(stream, batch_size, n_samples, audio_path, dev)
    batch = next(batches)
    recon, _ = model.recon(batch, steps=n_steps)
    initial = snr_db(batch, recon)
    log(f"initial multiband SNR: {initial:.2f} dB")
    reports = []
    for i in range(sweeps):
        batch = next(batches)
        model.learn(batch, steps=n_steps)
        if i % 5 == 0 or i == sweeps - 1:
            recon, encoding = model.recon(batch, steps=n_steps)
            gi, _, _ = model.flattened_event_tuples(encoding)
            s = snr_db(batch, recon)
            reports.append((i, s, float(gi.shape[0])))
            log(f"sweep {i}: SNR {s:.2f} dB, {gi.shape[0]} events over {model.total_atoms} "
                "global atoms")
    model.store(out)
    return MPTrainResult(model, initial, reports)
