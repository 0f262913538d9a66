"""Checkpoints of (params, opt_state, step), written atomically
(counterpart of ``mptpu/train/checkpoint.py``).

A checkpoint is a pickle of plain numpy: ``_to_host`` takes every tensor
of a nested dict / list / tuple to a numpy array, so ``mptpu``'s
checkpoints load here and the port's load there. ``latest()`` falls back
past corrupt files to the newest intact checkpoint.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Optional

import numpy as np
import torch


def _to_host(tree):
    """The same structure with every tensor and array leaf a numpy array;
    other leaves (None, strings, numbers) pass through."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # a NamedTuple (AdamState)
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray):
        return np.asarray(tree)
    return tree


def save_checkpoint(path: str, params, opt_state=None, step: int = 0):
    """Atomic pickle checkpoint of (params, opt_state, step): written to
    ``path + ".tmp"``, then renamed."""
    payload = {
        "params": _to_host(params),
        "opt_state": _to_host(opt_state) if opt_state is not None else None,
        "step": int(step),
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[dict]:
    """The payload at ``path``, or None when it is missing or does not
    unpickle. Unpickling runs code: load only checkpoints this program or
    ``mptpu`` wrote."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:
        # corrupt or version-skewed pickles raise far more than
        # UnpicklingError (AttributeError, ImportError, ValueError,
        # UnicodeDecodeError, ...); latest() must fall back past all of them
        return None


class CheckpointManager:
    """Checkpoints ``ckpt_<step>.pkl`` in ``directory`` every ``every``
    steps, keeping the last ``keep``."""

    # a .tmp older than this is a crash leftover; a younger one may be a
    # concurrent writer's save in flight and is never touched
    STALE_TMP_S = 3600.0

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:09d}.pkl")

    def maybe_save(self, step: int, params, opt_state=None) -> bool:
        if step % self.every != 0:
            return False
        save_checkpoint(self._path(step), params, opt_state, step)
        self._gc()
        return True

    def _list(self):
        """Intact checkpoint files only; ``.tmp`` files never count."""
        return sorted(f for f in os.listdir(self.directory)
                      if f.startswith("ckpt_") and f.endswith(".pkl"))

    def _gc(self):
        for old in self._list()[: -self.keep]:
            os.remove(os.path.join(self.directory, old))
        now = time.time()
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".tmp"):
                path = os.path.join(self.directory, name)
                try:
                    if now - os.path.getmtime(path) > self.STALE_TMP_S:
                        os.remove(path)
                except OSError:
                    pass

    def latest(self) -> Optional[dict]:
        """Newest loadable checkpoint, falling back past corrupt files."""
        for name in reversed(self._list()):
            payload = load_checkpoint(os.path.join(self.directory, name))
            if payload is not None:
                return payload
        return None
