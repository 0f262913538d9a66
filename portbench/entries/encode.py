"""Greedy encodes through ``mptpu_torch.sparse.fast_mp.sparse_code_fast``
with one fixed dictionary and a pool of seeded batches cycled: a codec
service or an index build coding segments with its trained dictionary.

Checked: each sampled call's events and residual against the float64
reference walking the same events (``reference.mp.follow``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import inputs, roofline
from ..reference import mp as ref


class Coded(NamedTuple):
    """The fields of the program's ``SparseCodeResult``."""

    atom_indices: torch.Tensor
    positions: torch.Tensor
    values: torch.Tensor
    residual: torch.Tensor


def port_program():
    from mptpu_torch.sparse.fast_mp import sparse_code_fast

    return sparse_code_fast


def control_program(signal, d, n_steps, **engine):
    """The reference in the program's place, its products in TF32."""
    atoms, positions, values, residual = ref.greedy(signal[:, 0], d, n_steps, torch.float32,
                                                    tf32=True)
    return Coded(atoms.int(), positions.int(), values, residual[:, None])


# the control: the products in TF32
CONTROLS = {"tf32": lambda program: control_program}


def _half(signal, run):
    """The first half of the batch coded, its results standing for the rest."""
    half = run(signal[: signal.shape[0] // 2])
    twice = [torch.cat([t, t], dim=1 if t.ndim == 2 else 0) for t in half]
    return Coded(*twice)


def _altered(out):
    atoms = out[0].clone()
    atoms[atoms.shape[0] // 2, 0] = (atoms[atoms.shape[0] // 2, 0] + 1) % 2**20
    return Coded(atoms, *out[1:])


# faults planted in the program, for the tests that see ``correct`` fail
FAULTS = {
    "unchanged": lambda p: lambda signal, d, **kw: Coded(*p(signal, d, **kw)[:3], signal.clone()),
    "half_batch": lambda p: lambda signal, d, **kw: _half(signal, lambda s: p(s, d, **kw)),
    "altered": lambda p: lambda signal, d, **kw: _altered(p(signal, d, **kw)),
}


class Entry:
    def __init__(self, config, traffic, seed, device, wrap=None):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        program = port_program()
        self.program = wrap(program) if wrap else program
        self.engine = dict(config["engine"], n_steps=config["n_steps"])
        self.batch = traffic["batch"]
        self.work_per_call = self.batch * config["n_steps"]
        self.d = self.dictionary()
        self.pool = [self.signal(i) for i in range(traffic["pool"])]

    def dictionary(self):
        c = self.config
        gen = inputs.generator(self.seed, "dictionary", 0, self.device)
        return inputs.dictionary(self.traffic["dictionary"], c["n_atoms"], c["atom_size"], gen,
                                 self.device)

    def signal(self, index):
        gen = inputs.generator(self.seed, "batch", index, self.device)
        return inputs.signal_batch(self.traffic["signal"], batch=self.batch,
                                   n_samples=self.config["n_samples"],
                                   n_steps=self.config["n_steps"], gen=gen, device=self.device,
                                   dictionary=inputs.unit_rows(self.dictionary()))

    def call(self, i):
        return self.program(self.pool[i % len(self.pool)], self.d, **self.engine)

    def warm(self):
        self.call(0)

    def keep(self, i, out):
        return dict(index=i % len(self.pool),
                    events=[t.detach().clone() for t in out[:3]],
                    residual=out[3].detach().clone())

    def finish(self, kept):
        return kept

    def release(self):
        self.pool = self.d = None

    def check(self, kept):
        """[{number: value}] a kept call."""
        d = self.dictionary()
        S = self.config["n_steps"]
        out = []
        for k in kept:
            signal = self.signal(k["index"])[:, 0].double()
            atoms, positions, values = k["events"]
            if tuple(atoms.shape) != (S, self.batch):
                out.append(dict(event_err=float("inf"), residual_err=float("inf")))
                continue
            err, residual, _ = ref.follow(signal, d, atoms, positions, values)
            res = ref.residual_err(k["residual"].reshape(k["residual"].shape[0], -1), residual,
                                   torch.linalg.vector_norm(signal, dim=-1))
            out.append(dict(event_err=float(err.max()), residual_err=float(res.max())))
        return out

    def needed(self, calls):
        c, B = self.config, self.batch
        N, A, n, S = c["n_atoms"], c["atom_size"], c["n_samples"], c["n_steps"]
        return dict(
            flops=calls * roofline.encode_flops(B, N, n, A, S) + roofline.gram_flops(N, A),
            loop_bytes=calls * roofline.loop_bytes(N, A, n, B, S),
            loop_flops=calls * roofline.loop_flops(N, A, B, S),
        )
