#!/usr/bin/env python3
"""The textural trainer's trajectory in ``mptpu`` (JAX on the CPU) beside the
port's (PyTorch on the CPU), from the same parameters: the port's seed-0
``TexturalModel`` carried into ``mptpu`` by ``convert.module_to_flax``, at
``scripts/textural.py``'s defaults (2^16 samples, 64 events, 64 atoms x
2,048, latent 16, lr 1e-3, confidence weight 0.5).

    python3 tests/reference/textural_trajectory.py [--steps 20] [--smoke]

``mptpu`` steps by the script's jitted step (``scripts/textural.py:73-85``),
the port by ``textural_step``. Prints both losses a step and a JSON line of
``mptpu``'s (``chip_smoke.LONGTAIL_REFERENCE``). About 2 minutes and 1 GiB.
"""

from __future__ import annotations

import argparse
import time

from trajectory_common import flax_params, report, setup


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--smoke", action="store_true")
    args = parser.parse_args()
    setup()
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from mptpu.models.textural import TexturalModel as JModel, confidence_loss
    from mptpu.ops.stft import stft as j_stft
    from mptpu_torch.models import textural as ttx
    from mptpu_torch.ops.stft import stft
    from mptpu_torch.train.optim import Adam

    size = dict(n_samples=2**16, n_events=64, n_atoms=64, atom_size=2048)
    if args.smoke:
        size = dict(ttx.SMOKE)
    seg = ttx.textural_target(size["n_samples"])
    tm = ttx.TexturalModel(latent_dim=16, generator=torch.Generator().manual_seed(0),
                           device="cpu", **size)
    jm = JModel(latent_dim=16, **size)
    params = flax_params(tm)
    target = jnp.asarray(seg).reshape(1, 1, -1)
    tspec = j_stft(target, 2048, 256, pad=True)
    opt = optax.adam(1e-3)

    def loss_fn(p):
        recon, logits = jm.apply(p)
        return jnp.sum(jnp.abs(j_stft(recon, 2048, 256, pad=True) - tspec)) \
            + 0.5 * confidence_loss(logits)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    t0 = time.perf_counter()
    state, jl = opt.init(params), []
    for _ in range(args.steps):
        params, state, loss = step(params, state)
        jl.append(float(loss))
    t1 = time.perf_counter()
    adam = Adam(1e-3)
    st = adam.init(list(tm.parameters()))
    t_spec = stft(torch.from_numpy(seg).reshape(1, 1, -1), 2048, 256, pad=True)
    tl = []
    for _ in range(args.steps):
        loss, _, st = ttx.textural_step(tm, adam, st, t_spec)
        tl.append(float(loss))
    report("textural" + (" smoke" if args.smoke else ""), jl, tl,
           (t1 - t0, time.perf_counter() - t1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
