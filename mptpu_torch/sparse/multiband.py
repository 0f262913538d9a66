"""Multiband dictionary learning: per-octave-band matching pursuit over an
FFT frequency decomposition (counterpart of ``mptpu/sparse/multiband.py``).

Each band has its own size and dictionary; the model decomposes a batch,
codes or learns every band, and recomposes. Events travel as
``SparseCodeResult`` per band, and as ``(global_atom_index,
position_unit_time, amplitude)`` tensors globally.

A band runs where its dictionary lies: on the card unless the ``BandSpec``
was made with ``device="cpu"``. With exact coding (``slce=None``) a band's
encode goes through ``sparse_code_fast``, on a card with ``fused=True``,
so through the cluster step kernel when the band's shapes pass the gate.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import default_device
from ..ops.decompose import fft_frequency_decompose, fft_frequency_recompose, fft_resample
from ..ops.norms import unit_norm
from ..tracing import span
from .fast_mp import sparse_code_fast
from .matching_pursuit import (
    SparseCodeResult,
    dictionary_learning_step,
    scatter_events,
    sparse_code,
)


def _sparse_code(signal, d, n_steps: int, approx) -> SparseCodeResult:
    if approx is None:
        # exact single-channel coding: the incremental-gram engine gives the
        # same events; sparse_code_fast checks the fused gate itself and
        # falls back to block_argmax. The block shrinks only when the fused
        # gate can use it (atom_size >= 128).
        atom_size = d.shape[-1]
        block = min(512, atom_size) if atom_size >= 128 else 512
        return sparse_code_fast(
            signal, d, n_steps=n_steps, block=block,
            fused=signal.device.type != "cpu", block_argmax=True,
        )
    return sparse_code(signal, d, n_steps=n_steps, approx=approx)


@dataclass
class BandSpec:
    """One octave band's dictionary and codec.

    Without ``d`` the dictionary is drawn uniformly in [-1, 1) from
    ``generator`` (a CPU ``torch.Generator``; seeded with ``size`` when
    None) and unit-normed. ``mptpu`` draws from ``jax.random.PRNGKey(size)``
    and gets other numbers: carry a dictionary across with
    ``mptpu_torch.convert.band_dicts_from_jax``.
    """

    size: int
    n_atoms: int
    atom_size: int
    slce: Optional[slice] = None
    signal_samples: int = 0
    samplerate: int = 22050
    is_lowest_band: bool = False
    d: torch.Tensor = field(default=None)  # (n_atoms, atom_size), unit-norm
    device: Optional[object] = None
    generator: Optional[torch.Generator] = field(default=None, repr=False)

    def __post_init__(self):
        if self.d is None:
            self.device = default_device(self.device)
            gen = self.generator or torch.Generator().manual_seed(self.size)
            d = torch.rand((self.n_atoms, self.atom_size), generator=gen) * 2.0 - 1.0
            self.d = unit_norm(d.to(self.device))
        else:
            if self.device is not None:
                self.d = self.d.to(default_device(self.device))
            self.device = self.d.device

    @property
    def n_samples_at_native_rate(self) -> int:
        ratio = self.signal_samples // self.size
        return self.atom_size * ratio

    def resampled_atoms(self) -> torch.Tensor:
        """Atoms upsampled to the native signal rate."""
        return fft_resample(
            self.d.reshape(self.n_atoms, 1, self.atom_size),
            self.n_samples_at_native_rate,
            self.is_lowest_band,
        )

    def shape(self, batch_size: int) -> Tuple[int, int, int]:
        return (batch_size, 1, self.size)

    @property
    def filename(self) -> str:
        return f"band_{self.size}.dat"

    def get_atom(self, index, norm):
        return self.d[index] * norm

    def load(self, directory: str = "."):
        """Read ``band_<size>.dat`` (a pickled numpy array, the format
        ``mptpu`` stores) if it is there."""
        path = os.path.join(directory, self.filename)
        try:
            with open(path, "rb") as f:
                arr = np.asarray(pickle.load(f), dtype=np.float32)
        except IOError:
            return
        self.d = torch.from_numpy(arr.copy()).to(self.device)

    def store(self, directory: str = "."):
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, self.filename)
        with open(path, "wb") as f:
            pickle.dump(self.d.detach().cpu().numpy(), f)

    def learn(self, batch: torch.Tensor, steps: int = 16) -> torch.Tensor:
        self.d = unit_norm(dictionary_learning_step(batch, self.d, steps, self.slce))
        return self.d

    def encode(self, batch: torch.Tensor, steps: int = 16) -> SparseCodeResult:
        return _sparse_code(batch, self.d, steps, self.slce)

    def decode(self, events: SparseCodeResult, batch_size: int) -> torch.Tensor:
        return scatter_events(
            events.atom_indices, events.positions, events.values, self.d, self.size,
            channels=1, batch=batch_size,
        )

    def recon(self, batch: torch.Tensor, steps: int = 16):
        events = self.encode(batch, steps)
        return self.decode(events, batch.shape[0]), events

    # ---- local <-> global event-tuple codec

    def to_unit_time(self, sample_position):
        return sample_position / self.size

    def to_sample_time(self, unit_time):
        return (unit_time * self.size).to(torch.int32)

    def to_global(self, events: SparseCodeResult, offset: int):
        """(atom_index, pos, value) -> (global_index, unit_time, amplitude);
        the amplitude is ``|value|``, the norm of the scaled unit atom."""
        return (
            events.atom_indices + offset,
            self.to_unit_time(events.positions),
            events.values.abs(),
        )

    def to_local(self, global_indices, unit_times, amplitudes, offset: int):
        """Inverse transform; the sign of the original value is lost."""
        return SparseCodeResult(
            atom_indices=(global_indices - offset).to(torch.int32),
            positions=self.to_sample_time(unit_times),
            values=amplitudes,
            residual=None,
        )


class MultibandDictionaryLearning:
    """Decompose -> per-band code / learn -> recompose."""

    def __init__(self, specs: List[BandSpec], n_samples: int):
        self.bands: Dict[int, BandSpec] = {spec.size: spec for spec in specs}
        self.min_size = min(spec.size for spec in specs)
        self.n_samples = n_samples
        n_atoms = {spec.n_atoms for spec in specs}
        if len(n_atoms) > 1:
            raise ValueError("Only specs with equal atom counts is currently allowed")
        self.n_atoms = n_atoms.pop()

    def __len__(self):
        return len(self.bands)

    def event_count(self, iterations: int) -> int:
        return len(self) * iterations

    @property
    def total_atoms(self) -> int:
        return sum(v.n_atoms for v in self.bands.values())

    @property
    def band_dicts(self):
        return {size: band.d for size, band in self.bands.items()}

    @property
    def band_sizes(self):
        return list(self.bands.keys())

    def size_at_index(self, index: int) -> int:
        return list(self.bands.keys())[index]

    def index_of_size(self, band_size: int) -> int:
        return list(self.bands.keys()).index(band_size)

    def shape_dict(self, batch_size: int):
        return {size: band.shape(batch_size) for size, band in self.bands.items()}

    def get_band_from_global_atom_index(self, index: int):
        band_index = index // self.n_atoms
        return band_index, list(self.bands.values())[band_index]

    def atom_embeddings(self) -> torch.Tensor:
        device = next(iter(self.bands.values())).device
        return torch.eye(self.total_atoms, device=device)

    def store(self, directory: str = "."):
        for band in self.bands.values():
            band.store(directory)

    def load(self, directory: str = "."):
        for band in self.bands.values():
            band.load(directory)

    def learn(self, batch: torch.Tensor, steps: int = 16):
        with span("mptpu.multiband.split"):
            bands = fft_frequency_decompose(batch, self.min_size)
        for size, band in bands.items():
            self.bands[size].learn(band, steps)

    def encode(self, batch: torch.Tensor, steps: int) -> Dict[int, SparseCodeResult]:
        with span("mptpu.multiband.split"):
            bands = fft_frequency_decompose(batch, self.min_size)
        return {size: band.encode(bands[size], steps) for size, band in self.bands.items()}

    def flattened_event_tuples(self, encoding: Dict[int, SparseCodeResult]):
        """All bands' events in the global (index, unit_time, amplitude)
        space, concatenated over bands."""
        idxs, times, amps = [], [], []
        offset = 0
        for size, events in encoding.items():
            band = self.bands[size]
            gi, ut, amp = band.to_global(events, offset)
            idxs.append(gi.reshape(-1))
            times.append(ut.reshape(-1))
            amps.append(amp.reshape(-1))
            offset += band.n_atoms
        return torch.cat(idxs), torch.cat(times), torch.cat(amps)

    def hierarchical_event_tuples(
        self, global_indices, unit_times, amplitudes
    ) -> Dict[int, SparseCodeResult]:
        """Inverse of ``flattened_event_tuples``: route each global event
        back to its band by its global atom index, so reordered, filtered
        or generated event streams decode correctly. Each band receives the
        full event list with out-of-band events masked to amplitude 0."""
        out: Dict[int, SparseCodeResult] = {}
        offset = 0
        for size, band in self.bands.items():
            in_band = (global_indices >= offset) & (global_indices < offset + band.n_atoms)
            local_idx = torch.where(in_band, global_indices - offset, 0)
            vals = torch.where(in_band, amplitudes, 0.0)
            out[size] = SparseCodeResult(
                atom_indices=local_idx.to(torch.int32),
                positions=band.to_sample_time(unit_times),
                values=vals,
                residual=None,
            )
            offset += band.n_atoms
        return out

    def decode_global(
        self,
        global_indices,
        unit_times,
        amplitudes,
        batch_size: int,
        n_steps: int | None = None,
        batch_indices=None,
    ) -> torch.Tensor:
        """Decode straight from the global event-tuple representation (the
        codec's wire format). Events are routed per event by global atom
        index, so the stream need not be in band-major order.

        Pass ``batch_indices`` (per-event batch row) for arbitrary streams;
        without it event ``i`` belongs to batch row ``i % batch_size`` (the
        layout ``flattened_event_tuples`` emits), which stays correct under
        any permutation of a ``batch_size == 1`` stream but not of a batched
        one. ``n_steps`` is accepted and ignored."""
        n_events = int(global_indices.shape[0])
        if batch_indices is None:
            pad = (-n_events) % batch_size
            if pad:
                global_indices, unit_times, amplitudes = (
                    torch.cat([t, t.new_zeros(pad)])
                    for t in (global_indices, unit_times, amplitudes)
                )
            rows = (n_events + pad) // batch_size
            gi_m = global_indices.reshape(rows, batch_size)
            ut_m = unit_times.reshape(rows, batch_size)
            amp_m = amplitudes.reshape(rows, batch_size)
        else:
            # (n_events, batch): each event contributes only to its own row
            dev = global_indices.device
            batch_indices = torch.as_tensor(batch_indices, dtype=torch.int32, device=dev)
            mask = batch_indices[:, None] == torch.arange(batch_size, device=dev)[None, :]
            gi_m = global_indices[:, None].expand(n_events, batch_size)
            ut_m = unit_times[:, None].expand(n_events, batch_size)
            amp_m = amplitudes[:, None] * mask
        rows = gi_m.shape[0]
        local = self.hierarchical_event_tuples(
            gi_m.reshape(-1), ut_m.reshape(-1), amp_m.reshape(-1)
        )
        output = {}
        for size, ev in local.items():
            output[size] = self.bands[size].decode(
                SparseCodeResult(
                    ev.atom_indices.reshape(rows, batch_size),
                    ev.positions.reshape(rows, batch_size),
                    ev.values.reshape(rows, batch_size),
                    None,
                ),
                batch_size,
            )
        return fft_frequency_recompose(output, self.n_samples)

    def decode(self, encoding: Dict[int, SparseCodeResult], batch_size: int) -> torch.Tensor:
        output = {
            size: self.bands[size].decode(events, batch_size)
            for size, events in encoding.items()
        }
        return fft_frequency_recompose(output, self.n_samples)

    def recon(self, batch: torch.Tensor, steps: int = 16):
        encoding = self.encode(batch, steps)
        return self.decode(encoding, batch.shape[0]), encoding
