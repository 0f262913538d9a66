"""Dictionary learning through
``mptpu_torch.sparse.matching_pursuit.dictionary_learning_step``: one sweep
a call on the next batch of a pool planted from a seeded "true" dictionary,
the learned dictionary drawn from another seed and carried from sweep to
sweep (the codec's training).

The sweep's coding result (the program's ``sparse_code_fast`` result) is
observed as it is returned, by a recorder installed over
``fast_mp.sparse_code_fast`` for the whole run, set-up and window alike.
Set-up runs the first ``checked_sweeps`` sweeps through the window's own
call on the pool's first batches; the window carries on from that state.
Checked: each of those sweeps, and a seeded sample of ``checked_calls``
sweeps of the window, each from the dictionary the program held before it
(the first from the seed's, made again): its events against the float64
reference walking them, and the new dictionary against the reference's
update along them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import inputs, roofline
from ..reference import learn as ref_learn
from ..reference import mp as ref


class PortProgram:
    """(signal, d, n_steps) -> (the new dictionary, [the coding results the
    sweep made]), through the port's ``dictionary_learning_step`` with the
    recorder installed until ``release()``."""

    def __init__(self):
        from mptpu_torch.sparse import fast_mp, matching_pursuit

        self.step, self.fast_mp = matching_pursuit.dictionary_learning_step, fast_mp
        self.coder, self.seen = fast_mp.sparse_code_fast, []

        def observed(*args, **kwargs):
            out = self.coder(*args, **kwargs)
            self.seen.append(out)
            return out

        fast_mp.sparse_code_fast = observed

    def __call__(self, signal, d, n_steps):
        self.seen = []
        return self.step(signal, d, n_steps=n_steps), self.seen

    def release(self):
        self.fast_mp.sparse_code_fast = self.coder


def control_program(signal, d, n_steps):
    """The reference in the program's place: coding with TF32 products and
    the update in float32."""
    atoms, positions, values, residual = ref.greedy(signal[:, 0], d, n_steps, torch.float32,
                                                    tf32=True)
    new = ref_learn.learning_update(signal[:, 0].cpu().numpy(), d.cpu().numpy(),
                                    atoms.cpu().numpy(), positions.cpu().numpy(),
                                    values.cpu().numpy(), dtype=np.float32)
    return torch.from_numpy(new).to(d.device), [(atoms.int(), positions.int(), values, residual)]


# the control: the coding's products in TF32, the update in float32
CONTROLS = {"tf32": lambda program: control_program}


def _half(p):
    """Coding on the whole batch, the update on its first half only."""
    def run(signal, d, n_steps):
        seen = p(signal, d, n_steps)[1]
        return p(signal[: signal.shape[0] // 2], d, n_steps)[0], seen
    return run


def _altered(p):
    """One atom of the new dictionary changed where it is made."""
    def run(signal, d, n_steps):
        new, seen = p(signal, d, n_steps)
        new = new.clone()
        new[0, : new.shape[1] // 2] *= -1.0
        return new, seen
    return run


# faults planted in the program, for the tests that see ``correct`` fail and
# for the readings that bound the learning cell's limits
FAULTS = {
    "unchanged": lambda p: lambda signal, d, n_steps: (d, p(signal, d, n_steps)[1]),
    "half_batch": _half,
    "altered": _altered,
}


class Entry:
    def __init__(self, config, traffic, seed, device, wrap=None):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.port = PortProgram()
        self.program = wrap(self.port) if wrap else self.port
        self.batch = traffic["batch"]
        self.work_per_call = 1
        self.first = traffic["checked_sweeps"]
        self.pool = [self.signal(i) for i in range(traffic["pool"])]
        self.d = self.initial()
        self.last = None
        self.sweeps = []   # the set-up's sweeps, as ``keep`` keeps a window's

    def dictionary(self, stream):
        c = self.config
        gen = inputs.generator(self.seed, stream, 0, self.device)
        return inputs.dictionary(self.traffic["dictionary"], c["n_atoms"], c["atom_size"], gen,
                                 self.device)

    def initial(self):
        return self.dictionary("learned")

    def signal(self, index):
        gen = inputs.generator(self.seed, "batch", index, self.device)
        return inputs.signal_batch(self.traffic["signal"], batch=self.batch,
                                   n_samples=self.config["n_samples"],
                                   n_steps=self.config["n_steps"], gen=gen, device=self.device,
                                   dictionary=inputs.unit_rows(self.dictionary("true")))

    def sweep(self, index):
        """One sweep on the pool's batch ``index`` from the dictionary held;
        ``last`` keeps what a check of it needs until the next sweep."""
        before = self.d.detach().clone()
        self.d, seen = self.program(self.pool[index], self.d, self.config["n_steps"])
        self.last = (index, before, seen)
        return self.d

    def call(self, i):
        return self.sweep((self.first + i) % len(self.pool))

    def warm(self):
        for k in range(self.first):
            self.sweep(k)
            self.sweeps.append(self.keep(None, self.d))

    def keep(self, i, out):
        index, before, seen = self.last
        return dict(index=index, before=before, after=out.detach().clone(),
                    events=[tuple(t.detach().clone() for t in r[:3]) for r in seen])

    def finish(self, kept):
        return self.sweeps + kept

    def release(self):
        self.port.release()
        self.pool = self.d = self.last = None

    def check(self, kept):
        """[{number: value}] a checked sweep: the set-up's, then the
        window's sample."""
        S, B = self.config["n_steps"], self.batch
        bad = dict(event_err=float("inf"), atom_err=float("inf"))
        out = []
        for n, k in enumerate(kept):
            if len(k["events"]) != 1 or tuple(k["events"][0][0].shape) != (S, B):
                out.append(bad)
                continue
            atoms, positions, values = k["events"][0]
            # the first sweep starts from the seed's dictionary, made again
            d = self.initial() if n == 0 and self.sweeps else k["before"]
            signal = self.signal(k["index"])[:, 0].double()
            err, _, ref_values = ref.follow(signal, d, atoms, positions, values)
            new = ref_learn.learning_update(
                signal.cpu().numpy(), d.double().cpu().numpy(), atoms.cpu().numpy(),
                positions.cpu().numpy(), ref_values.cpu().numpy())
            got = k["after"].double().cpu().numpy()
            if got.shape != new.shape or not np.isfinite(got).all():
                atom_err = float("inf")
            else:
                atom_err = float(np.linalg.norm(got - new, axis=-1).max())
            out.append(dict(event_err=float(err.max()), atom_err=atom_err))
        return out

    def needed(self, calls):
        """A sweep: the coding with its own gram (the dictionary changes
        every sweep); the update's few operations an event are not counted."""
        c, B = self.config, self.batch
        N, A, n, S = c["n_atoms"], c["atom_size"], c["n_samples"], c["n_steps"]
        return dict(
            flops=calls * (roofline.encode_flops(B, N, n, A, S) + roofline.gram_flops(N, A)),
            loop_bytes=calls * roofline.loop_bytes(N, A, n, B, S),
            loop_flops=calls * roofline.loop_flops(N, A, B, S),
        )
