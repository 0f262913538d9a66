"""Multiband encodes through
``mptpu_torch.sparse.multiband.MultibandDictionaryLearning.encode``: the
octave split and one greedy encode a band, with fixed seeded band
dictionaries and a pool of seeded batches cycled (the multiband codec's
encode).

Checked, for each sampled call: every band's events and residual against
the float64 reference walking the same events on the reference's own
split, and the program's decode of those events (``decode``, after the
window) against the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import inputs, roofline
from ..reference import mp as ref
from ..reference import multiband as ref_mb
from .encode import Coded


class Program:
    """The port's multiband codec over the given band dictionaries."""

    def __init__(self, config, dicts):
        from mptpu_torch.sparse import BandSpec, MultibandDictionaryLearning

        sizes, n = config["sizes"], config["n_samples"]
        self.config, self.dicts, self.steps = config, dicts, config["n_steps"]
        self.model = MultibandDictionaryLearning(
            [BandSpec(s, config["n_atoms"], config["atom_size"], signal_samples=n,
                      samplerate=config["samplerate"], is_lowest_band=(s == sizes[0]),
                      d=inputs.unit_rows(dicts[s])) for s in sizes],
            n_samples=n,
        )

    def encode(self, batch):
        return self.model.encode(batch, self.steps)

    def decode(self, encoding, batch_size):
        return self.model.decode(encoding, batch_size)


class Control:
    """The reference in the program's place, one precision below the
    configuration's float32 with TF32 off and complex64 FFTs: its FFTs'
    outputs rounded to ``rounding`` and its products in TF32 where ``tf32``."""

    def __init__(self, config, dicts, rounding, tf32):
        self.config, self.rounding, self.tf32 = config, rounding, tf32
        self.dicts = {s: ref.unit_norm(d.double()).cpu().numpy() for s, d in dicts.items()}
        self.device = next(iter(dicts.values())).device

    def encode(self, batch):
        bands = ref_mb.decompose(batch[:, 0].double().cpu().numpy(), self.config["sizes"][0],
                                 self.rounding)
        out = {}
        for s, band in bands.items():
            x = torch.from_numpy(band).float().to(self.device)
            d = torch.from_numpy(self.dicts[s]).float().to(self.device)
            atoms, positions, values, residual = ref.greedy(x, d, self.config["n_steps"],
                                                            torch.float32, tf32=self.tf32)
            out[s] = Coded(atoms.int(), positions.int(), values, residual[:, None])
        return out

    def decode(self, encoding, batch_size):
        events = {s: tuple(t.cpu().numpy() for t in e[:3]) for s, e in encoding.items()}
        out = ref_mb.decode(self.dicts, events, self.config["n_samples"], self.rounding)
        return torch.from_numpy(out).float()[:, None]


# the controls: the products in TF32 with complex64 FFTs, and complex32 FFTs
# (their outputs in float16) with float32 products
CONTROLS = {
    "tf32": lambda p: Control(p.config, p.dicts, "float32", tf32=True),
    "fft16": lambda p: Control(p.config, p.dicts, "float16", tf32=False),
}


class Faulty:
    """The program with one fault planted in its encode (see ``FAULTS``)."""

    def __init__(self, program, fault):
        self.program, self.fault = program, fault
        self.config, self.dicts = program.config, program.dicts

    def encode(self, batch):
        if self.fault == "half_batch":
            half = self.program.encode(batch[: batch.shape[0] // 2])
            return {s: Coded(*[torch.cat([t, t], dim=1 if t.ndim == 2 else 0) for t in e])
                    for s, e in half.items()}
        out = self.program.encode(batch)
        if self.fault == "unchanged":
            from mptpu_torch.ops.decompose import fft_frequency_decompose

            bands = fft_frequency_decompose(batch, self.config["sizes"][0])
            return {s: Coded(*e[:3], bands[s]) for s, e in out.items()}
        top = max(out)
        atoms = out[top][0].clone()
        atoms[atoms.shape[0] // 2, 0] = (atoms[atoms.shape[0] // 2, 0] + 1) % 2**20
        return {**out, top: Coded(atoms, *out[top][1:])}

    def decode(self, encoding, batch_size):
        return self.program.decode(encoding, batch_size)


# faults planted in the program, for the tests that see ``correct`` fail
FAULTS = {name: (lambda p, name=name: Faulty(p, name))
          for name in ("unchanged", "half_batch", "altered")}


class Entry:
    def __init__(self, config, traffic, seed, device, wrap=None):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        program = Program(config, self.dictionaries())
        self.program = wrap(program) if wrap else program
        self.batch = traffic["batch"]
        self.work_per_call = self.batch * config["n_steps"] * len(config["sizes"])
        self.pool = [self.signal(i) for i in range(traffic["pool"])]

    def dictionaries(self):
        c = self.config
        return {s: inputs.dictionary(self.traffic["dictionary"], c["n_atoms"], c["atom_size"],
                                     inputs.generator(self.seed, "band", s, self.device),
                                     self.device)
                for s in c["sizes"]}

    def signal(self, index):
        gen = inputs.generator(self.seed, "batch", index, self.device)
        return inputs.signal_batch(self.traffic["signal"], batch=self.batch,
                                   n_samples=self.config["n_samples"],
                                   n_steps=self.config["n_steps"], gen=gen, device=self.device)

    def call(self, i):
        return self.program.encode(self.pool[i % len(self.pool)])

    def warm(self):
        self.call(0)

    def keep(self, i, out):
        return dict(index=i % len(self.pool),
                    bands={s: Coded(*(t.detach().clone() for t in e)) for s, e in out.items()})

    def finish(self, kept):
        for k in kept:
            k["decoded"] = self.program.decode(k["bands"], self.batch).detach().clone()
        return kept

    def release(self):
        self.pool = self.program = None

    def check(self, kept):
        """[{number: value}] a kept call, each the worst of its bands."""
        c = self.config
        S, B, sizes = c["n_steps"], self.batch, c["sizes"]
        dicts = {s: d.double() for s, d in self.dictionaries().items()}
        unit = {s: ref.unit_norm(d).cpu().numpy() for s, d in dicts.items()}
        out = []
        for k in kept:
            out.append(self._check_call(k, S, B, sizes, dicts, unit))
        return out

    def _check_call(self, k, S, B, sizes, dicts, unit):
        inf = dict(event_err=float("inf"), residual_err=float("inf"), decode_err=float("inf"))
        worst = dict(event_err=0.0, residual_err=0.0)
        x = self.signal(k["index"])[:, 0].double().cpu().numpy()
        bands = ref_mb.decompose(x, sizes[0])
        if sorted(k["bands"]) != sorted(sizes):
            return inf
        events = {}
        for s in sizes:
            coded = k["bands"][s]
            if tuple(coded.atom_indices.shape) != (S, B):
                return inf
            band = torch.from_numpy(bands[s]).to(self.device)
            err, residual, _ = ref.follow(band, dicts[s], *coded[:3])
            res = ref.residual_err(coded.residual.reshape(coded.residual.shape[0], -1),
                                   residual, torch.linalg.vector_norm(band, dim=-1))
            worst["event_err"] = max(worst["event_err"], float(err.max()))
            worst["residual_err"] = max(worst["residual_err"], float(res.max()))
            events[s] = tuple(t.cpu().numpy() for t in coded[:3])
        want = ref_mb.decode(unit, events, self.config["n_samples"])
        got = k["decoded"].double().cpu().numpy()
        if got.size != want.size:
            return dict(worst, decode_err=float("inf"))
        got = got.reshape(want.shape)
        err = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(x, axis=-1)
        worst["decode_err"] = float(np.where(np.isfinite(err), err, np.inf).max())
        return worst

    def needed(self, calls):
        c, B = self.config, self.batch
        N, A, S, sizes = c["n_atoms"], c["atom_size"], c["n_steps"], c["sizes"]
        per_call = (sum(roofline.encode_flops(B, N, s, A, S) for s in sizes)
                    + roofline.band_split_flops(B, c["n_samples"], sizes))
        return dict(
            flops=calls * per_call + len(sizes) * roofline.gram_flops(N, A),
            loop_bytes=calls * sum(roofline.loop_bytes(N, A, s, B, S) for s in sizes),
            loop_flops=calls * len(sizes) * roofline.loop_flops(N, A, B, S),
        )
