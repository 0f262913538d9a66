"""The dictionary-learning sweep's update, in NumPy float64.

The algorithm (the reference repository's ``modules/matchingpursuit.py``,
``dictionary_learning_step``): after coding, the used atoms are visited in
the order of their first selection (step-major, then item). For each, its
events' instances (value x old atom) go back into an update residual that
starts as the signal, the residual's segments at its events are summed and
unit-normed into the new atom, and the instances rendered with the new atom
at amplitude |value| come out again. Energy past the signal's end is
dropped. Unused atoms keep their value; every atom is unit-normed at the
end.
"""

from __future__ import annotations

import numpy as np


def unit_norm(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    sq = np.sum(x * x, axis=-1, keepdims=True)
    return x / (np.sqrt(np.maximum(sq, eps * eps)) + eps)


def first_selection_order(atoms: np.ndarray) -> list[int]:
    """The used atoms of ``atoms`` (S, B), in the order of their first
    occurrence in step-major, item-minor order."""
    seen, order = set(), []
    for a in atoms.reshape(-1).tolist():
        if a not in seen:
            seen.add(a)
            order.append(a)
    return order


def learning_update(signal: np.ndarray, d: np.ndarray, atoms: np.ndarray, positions: np.ndarray,
                    values: np.ndarray, dtype=np.float64) -> np.ndarray:
    """The new dictionary (N, A) from ``signal`` (B, n), the coding-time
    dictionary ``d`` (N, A) and the events (each (S, B)), computed in
    ``dtype``."""
    B, n = signal.shape
    A = d.shape[-1]
    dd = unit_norm(d.astype(dtype))
    padded = np.zeros((B, n + A), dtype=dtype)
    padded[:, :n] = signal
    flat_atoms = atoms.reshape(-1)
    items = np.tile(np.arange(B), atoms.shape[0])
    pos = positions.reshape(-1).astype(np.int64)
    val = values.reshape(-1).astype(dtype)
    taps = np.arange(A)
    for a in first_selection_order(atoms):
        sel = np.nonzero(flat_atoms == a)[0]
        rows = items[sel][:, None]
        cols = pos[sel][:, None] + taps
        v = val[sel][:, None]
        np.add.at(padded, (rows, cols), v * dd[a])
        padded[:, n:] = 0.0
        new = unit_norm(padded[rows, cols].sum(0))
        dd[a] = new
        np.add.at(padded, (rows, cols), -np.abs(v) * new)
        padded[:, n:] = 0.0
    return unit_norm(dd)
