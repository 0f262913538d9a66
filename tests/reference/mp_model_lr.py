#!/usr/bin/env python3
"""The learned-atom matching pursuit's Adam trajectory in ``mptpu`` (JAX on
the CPU) beside the port's (PyTorch on the CPU), from the same atoms, at
several learning rates.

    python3 tests/reference/mp_model_lr.py [--steps 20] [--lrs 1e-2,1e-3,1e-4] [--small]

The configuration is ``chip_smoke.py``'s phase 10(d): BASELINE.md's greedy
MP demo widths (128 atoms x 1,024 samples, a 2^15-sample signal, 25
iterations), batch 1, ``iterative_loss`` over ``stft(x, 2048, 256,
pad=True)``, the signal ``synthetic_audio(2^15, n_events=8, seed=1,
sustained=True)`` and the atoms of the port's ``MatchingPursuit`` drawn
from its default generator, carried into ``mptpu``'s flax tree. For each
learning rate it runs ``--steps`` steps of ``optax.adam`` (jitted, as
``tests/test_models_extra.py`` does) and of ``torch.optim.Adam`` (as
``chip_smoke.py`` does), and prints every step's loss on both sides,
whether the last is below the first, the largest gap between the two over
the target feature's l1 norm (``chip_smoke.py``'s measure), and the
process's peak resident memory. ``--small`` takes ``tests/test_models_extra.py``'s shapes (8
atoms x 32 samples, 512 samples, 3 iterations) for a quick rehearsal.
Imports both packages; needs no card.
"""

from __future__ import annotations

import argparse
import resource
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
FULL = dict(n_atoms=128, atom_samples=1024, n_samples=2**15, n_iterations=25)
SMALL = dict(n_atoms=8, atom_samples=32, n_samples=512, n_iterations=3)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--lrs", default="1e-2,1e-3,1e-4")
    parser.add_argument("--small", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    import torch

    from mptpu.losses import iterative_loss as j_iterative_loss
    from mptpu.models import MatchingPursuit as JMP
    from mptpu.ops import stft as j_stft
    from mptpu_torch.data import synthetic_audio
    from mptpu_torch.losses import iterative_loss as t_iterative_loss
    from mptpu_torch.models import MatchingPursuit as TMP
    from mptpu_torch.ops import stft as t_stft

    torch.set_num_threads(4)
    shape = SMALL if args.small else FULL
    n = shape["n_samples"]
    audio = synthetic_audio(n, 22050, n_events=8, seed=1, sustained=True).reshape(1, 1, -1)
    start = TMP(*shape.values(), device="cpu").state_dict()
    scale = float(t_stft(torch.from_numpy(audio), 2048, 256, pad=True).abs().sum())
    jm = JMP(**shape)
    ja = jnp.asarray(audio)

    def j_loss(p):
        return j_iterative_loss(ja, jm.apply(p, ja), lambda x: j_stft(x, 2048, 256, pad=True))

    print(f"learned-atom MP {shape}, batch 1, {args.steps} Adam steps, the atoms of the port's "
          f"seed-0 generator (max |atom| {float(start['atoms'].abs().max()):.4f})")
    for lr in (float(v) for v in args.lrs.split(",")):
        opt = optax.adam(lr)
        params = {"params": {"atoms": jnp.asarray(start["atoms"].numpy())}}
        state = opt.init(params)

        @jax.jit
        def step(p, s):
            loss, g = jax.value_and_grad(j_loss)(p)
            u, s = opt.update(g, s, p)
            return optax.apply_updates(p, u), s, loss

        j_losses = []
        for _ in range(args.steps):
            params, state, loss = step(params, state)
            j_losses.append(float(loss))

        m = TMP(*shape.values(), device="cpu")
        m.load_state_dict(start)
        t_opt = torch.optim.Adam(m.parameters(), lr=lr)
        a = torch.from_numpy(audio)
        t_losses = []
        for _ in range(args.steps):
            t_opt.zero_grad(set_to_none=True)
            loss = t_iterative_loss(a, m(a), lambda x: t_stft(x, 2048, 256, pad=True))
            loss.backward()
            t_opt.step()
            t_losses.append(float(loss.detach()))
        for name, losses in (("mptpu", j_losses), ("port ", t_losses)):
            print(f"lr {lr:g} {name}: " + ", ".join(f"{v:.6g}" for v in losses)
                  + f"; last below first: {losses[-1] < losses[0]}")
        gap = np.abs(np.subtract(t_losses, j_losses)).max() / scale
        print(f"lr {lr:g}: the port's losses at most {gap:.2e} of the target feature's l1 norm "
              f"{scale:.6g} from mptpu's")
    print(f"peak resident memory {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} "
          f"GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
