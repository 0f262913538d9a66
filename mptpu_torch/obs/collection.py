"""Logged values for the training dashboard (counterpart of
``mptpu/obs/collection.py``): named loggers over the sqlite KV store, each
keeping its latest value; audio is kept as WAV bytes, which the dashboard
streams into an ``<audio>`` element. The store's keys and encodings are
``mptpu``'s, so either package reads what the other logged.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List

import numpy as np

from ..data.kv import KVCollection
from ..utils.playable import encode_audio as _wav_bytes


def encode_audio(samples: np.ndarray, samplerate: int = 22050) -> bytes:
    """Mono 16-bit PCM WAV bytes of ``samples`` (NaN as 0, clipped to [-1, 1])."""
    samples = np.nan_to_num(np.asarray(samples, dtype=np.float32).reshape(-1))
    return _wav_bytes(samples, samplerate)


class Collection:
    """Named loggers over a persistent KV store at ``path``."""

    def __init__(self, path: str, history: int = 8):
        self.kv = KVCollection(path)
        self.history = history
        self._counters: Dict[str, int] = {}

    def log(self, name: str, value, kind: str = "array", samplerate: int = 22050) -> None:
        """``kind``: ``"array"``, ``"audio"``, ``"scalar"`` or ``"series"``;
        a tensor is taken to the host first."""
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        count = self._counters.get(name, 0)
        meta = {"kind": kind, "count": count, "time": time.time(), "samplerate": samplerate}
        if kind == "audio":
            self.kv.put(f"v:{name}:latest", encode_audio(np.asarray(value), samplerate))
        elif kind == "scalar":
            meta["value"] = float(value)
            self.kv.put(f"v:{name}:latest", np.asarray(float(value)))
        else:
            self.kv.put(f"v:{name}:latest", np.asarray(value))
        self.kv.put(f"m:{name}", json.dumps(meta).encode())
        self._counters[name] = count + 1

    def latest(self, name: str):
        return self.kv.get(f"v:{name}:latest")

    def meta(self, name: str) -> dict:
        return json.loads(bytes(self.kv.get(f"m:{name}")).decode())

    def names(self) -> List[str]:
        return [k[2:] for k in self.kv.keys("m:")]


def loggers(names: List[str], kind: str, collection: Collection, samplerate: int = 22050):
    """One logging callable per name: audio when ``kind`` says so, else
    arrays."""
    k = "audio" if "audio" in kind else "array"

    def make(name):
        def log(value):
            collection.log(name, value, kind=k, samplerate=samplerate)

        return log

    return [make(n) for n in names]
