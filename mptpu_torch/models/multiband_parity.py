"""The multiband dictionary-learning trajectory (counterpart of
``scripts/multiband_parity.py``): ``iterations`` learning iterations at
``e_2024_4_24``'s configuration (7 octave bands from 512 to 32,768
samples, 512 atoms x 128 taps a band, 64 sparse-coding steps a band,
2^15-sample segments, batch 2), from dictionaries drawn uniform in [-1, 1)
by ``np.random.default_rng(99)`` and unit-normed, on the batch
``synthetic_audio(n_samples, seed=100 + i)``; the reconstruction SNR after
each iteration. On a card every band's encode, in ``learn`` and in
``recon``, runs the cluster step kernel where the band's shapes pass its
gate.

Where the caller names the directory of the reference implementation (the
original PyTorch code, ``reference``) and it exists, its
``MultibandDictionaryLearning`` runs beside the port on the CPU from the
same dictionaries and batch, as the script runs it; this module imports
nothing else of it.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import time
import types
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.synthetic import synthetic_audio
from ..device import default_device
from ..ops.norms import unit_norm
from ..sparse import BandSpec, MultibandDictionaryLearning

SIZES = (512, 1024, 2048, 4096, 8192, 16384, 32768)
CONFIG = dict(n_samples=2**15, n_atoms=512, atom_size=128, steps=64, batch_size=2, sizes=SIZES)


def load_reference(ref: str):
    """The reference's ``modules.multibanddict``, loaded with stubs for the
    imports it does not need (``zounds``, ``util``)."""
    zounds = types.ModuleType("zounds")

    class SR22050:
        pass

    zounds.SR22050 = SR22050
    zounds.SampleRate = SR22050
    sys.modules.setdefault("zounds", zounds)
    util = types.ModuleType("util")
    util.device = torch.device("cpu")
    sys.modules.setdefault("util", util)
    pkg = types.ModuleType("modules")
    pkg.__path__ = [os.path.join(ref, "modules")]
    sys.modules.setdefault("modules", pkg)

    def _load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod

    for leaf in ("normalization", "fft", "conv", "softmax", "pos_encode",
                 "sparse", "decompose", "stft"):
        _load(f"modules.{leaf}", f"{ref}/modules/{leaf}.py")
    _load("modules.matchingpursuit", f"{ref}/modules/matchingpursuit.py")
    return _load("modules.multibanddict", f"{ref}/modules/multibanddict.py")


def initial_dictionaries(n_atoms: int, atom_size: int,
                         sizes: Sequence[int]) -> Dict[int, np.ndarray]:
    """The starting dictionaries, before the unit norm: uniform in [-1, 1)
    from ``np.random.default_rng(99)``, drawn band by band in ``sizes``'
    order."""
    rng = np.random.default_rng(99)
    return {s: rng.uniform(-1, 1, (n_atoms, atom_size)).astype(np.float32) for s in sizes}


def parity_batch(n_samples: int, batch_size: int) -> np.ndarray:
    """(batch, 1, n_samples): ``synthetic_audio(n_samples, seed=100 + i)``."""
    return np.stack([synthetic_audio(n_samples, seed=100 + i)
                     for i in range(batch_size)]).reshape(batch_size, 1, n_samples)


def parity_model(init: Dict[int, np.ndarray], n_samples: int, atom_size: int,
                 device) -> MultibandDictionaryLearning:
    """The port's model with the unit-normed ``init`` dictionaries."""
    sizes = sorted(init)
    return MultibandDictionaryLearning(
        [BandSpec(s, init[s].shape[0], atom_size, signal_samples=n_samples,
                  is_lowest_band=(s == sizes[0]),
                  d=unit_norm(torch.from_numpy(init[s]).to(device)))
         for s in sizes],
        n_samples=n_samples)


def recon_snr_db(model, batch: torch.Tensor, steps: int) -> float:
    recon, _ = model.recon(batch, steps)
    num = float(torch.sum(batch.double() ** 2))
    den = float(torch.sum((batch - recon).double() ** 2))
    return 10.0 * np.log10(num / max(den, 1e-12))


def parity_trajectory(iterations: int = 10, device=None, reference: Optional[str] = None,
                      log: Callable[[str], None] = print, sync: Callable[[], None] = lambda: None,
                      on_row: Callable[[dict], None] = lambda row: None, **config) -> dict:
    """The script's rows, one per iteration (0 before any learning):
    ``ours_snr_db`` (the port on ``device``), ``ours_learn_s`` (host clock,
    ``sync`` called before reading it), and where ``reference`` is a
    directory also ``ref_snr_db``, ``delta_db`` and ``ref_learn_s``; each
    row goes to ``on_row`` as it is made. ``config`` overrides ``CONFIG``'s
    keys. ``device``: ``cuda`` unless ``"cpu"``."""
    unknown = set(config) - set(CONFIG)
    if unknown:
        raise TypeError(f"unknown settings {sorted(unknown)}")
    c = dict(CONFIG, **config)
    dev = default_device(device)
    n_samples, n_atoms, atom_size, steps = (c[k] for k in ("n_samples", "n_atoms", "atom_size",
                                                            "steps"))
    init = initial_dictionaries(n_atoms, atom_size, c["sizes"])
    batch_np = parity_batch(n_samples, c["batch_size"]).astype(np.float32)
    batch = torch.from_numpy(batch_np).to(dev)
    model = parity_model(init, n_samples, atom_size, dev)
    ref_model = None
    if reference and os.path.isdir(reference):
        mbd = load_reference(reference)
        cpu = torch.device("cpu")
        ref_model = mbd.MultibandDictionaryLearning(
            [mbd.BandSpec(s, n_atoms, atom_size, device=cpu, signal_samples=n_samples,
                          is_lowest_band=(s == c["sizes"][0])) for s in c["sizes"]],
            n_samples=n_samples)
        for s in c["sizes"]:
            ref_model.bands[s].d = mbd.unit_norm(torch.from_numpy(init[s]))
        ref_batch = torch.from_numpy(batch_np)
    rows: List[dict] = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for it in range(iterations + 1):
            row = {"iteration": it}
            if it > 0:
                ts = time.perf_counter()
                model.learn(batch, steps)
                sync()
                row["ours_learn_s"] = time.perf_counter() - ts
            else:
                row["ours_learn_s"] = 0.0
            row["ours_snr_db"] = recon_snr_db(model, batch, steps)
            if ref_model is not None:
                ts = time.perf_counter()
                if it > 0:
                    ref_model.learn(ref_batch, steps)
                row["ref_learn_s"] = time.perf_counter() - ts if it > 0 else 0.0
                row["ref_snr_db"] = recon_snr_db(ref_model, ref_batch, steps)
                row["delta_db"] = row["ours_snr_db"] - row["ref_snr_db"]
            rows.append(row)
            on_row(row)
            log(" ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                         for k, v in row.items()))
    return {"config": (f"{len(c['sizes'])} bands {c['sizes'][0]}..{c['sizes'][-1]}, {n_atoms} "
                       f"atoms x {atom_size}, {steps} steps/band, batch {c['batch_size']}, "
                       f"2^{int(np.log2(n_samples))} samples, identical init dicts"),
            "rows": rows, "model": model, "wall_s": time.perf_counter() - t0}
