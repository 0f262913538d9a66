"""Seeded inputs, made on the device in a few large calls.

Every input is drawn from its own ``torch.Generator`` on the device, seeded
from (``--seed``, a stream name, an index), so an input can be made again
on its own after the window: the reference gets the same numbers as the
program without keeping them. A traffic mix's ``signal`` entry names the
generator under ``portbench/signals/`` that makes its batches.
"""

from __future__ import annotations

import hashlib
import importlib

import torch


def stream_seed(seed: int, stream: str, index: int = 0) -> int:
    digest = hashlib.sha256(f"{seed}/{stream}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream, index))


def dictionary(kind: str, n_atoms: int, atom_size: int, gen: torch.Generator,
               device) -> torch.Tensor:
    """(n_atoms, atom_size) float32: ``normal`` draws N(0, 1), ``uniform``
    U[-1, 1), as the codec's own initialisations do."""
    if kind == "normal":
        return torch.randn((n_atoms, atom_size), generator=gen, device=device)
    if kind == "uniform":
        return torch.rand((n_atoms, atom_size), generator=gen, device=device) * 2.0 - 1.0
    raise ValueError(f"unknown dictionary kind {kind!r}")


def unit_rows(d: torch.Tensor) -> torch.Tensor:
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def signal_batch(spec: dict, *, batch: int, n_samples: int, n_steps: int, gen: torch.Generator,
                 device, dictionary: torch.Tensor | None = None) -> torch.Tensor:
    """(batch, 1, n_samples) float32 from ``portbench/signals/<kind>.py``."""
    module = importlib.import_module(f"portbench.signals.{spec['kind']}")
    return module.make(spec, batch=batch, n_samples=n_samples, n_steps=n_steps, gen=gen,
                       device=device, dictionary=dictionary)
