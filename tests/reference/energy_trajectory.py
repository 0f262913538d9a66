#!/usr/bin/env python3
"""The energy-instrument overfit's trajectory in ``mptpu`` (JAX on the CPU)
beside the port's (PyTorch on the CPU), from the same parameters: the
port's seed-0 ``EnergyInstrumentModel`` carried into ``mptpu`` by
``convert.module_to_flax`` and the script's impulse amplitudes (16 of
0.1), at ``scripts/energy_overfit.py``'s defaults (2^15 samples, block
512, 128 channels, 3 layers, lr 1e-3, ``--disc-weight 0.1``; ``--tiny``:
2^12, 128, 32, 2).

    python3 tests/reference/energy_trajectory.py [--steps 100] [--tiny]

``mptpu`` steps by the script's jitted step (``scripts/energy_overfit.py:
65-82``, restated here: it lives inside the script's ``main``); the port by
``overfit_energy``. The target stands in for the script's corpus segment,
which depends on the order in which a machine lists the corpus's files:
``synthetic_audio(n, 22050, n_events=max(4, n / 22050 * 8), seed=5)``.
Prints both losses a step and a JSON line of ``mptpu``'s
(``chip_smoke.ENERGY_REFERENCE``). About a minute at the defaults.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from trajectory_common import flax_params, report, setup


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--tiny", action="store_true")
    args = parser.parse_args()
    setup()
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from mptpu.gen.energy import EnergyInstrumentModel, compute_discontinuity, to_blocks
    from mptpu.ops.stft import stft
    from mptpu_torch.data.synthetic import synthetic_audio
    from mptpu_torch.models import energy_overfit as teo

    n, block, channels, layers = teo.TINY if args.tiny else teo.FULL
    seg = synthetic_audio(n, 22050, n_events=max(4, int(n / 22050 * 8)), seed=5)
    target = jnp.asarray(seg).reshape(1, 1, -1)
    tm = teo.EnergyOverfit(n, block, channels, layers, device="cpu")
    jm = EnergyInstrumentModel(input_channels=1, model_channels=channels, block_size=block,
                               n_layers=layers)
    sites = np.linspace(0, n - block, teo.N_IMPULSES).astype(int)
    state = {"model": flax_params(tm.model), "amps": jnp.ones((teo.N_IMPULSES,)) * 0.1}
    opt = optax.adam(1e-3)

    def control_from_amps(amps):   # scripts/energy_overfit.py:65-67
        return jnp.zeros((1, 1, n)).at[0, 0, jnp.asarray(sites)].set(amps)

    def loss_fn(s):   # scripts/energy_overfit.py:69-75
        recon = jm.apply(s["model"], control_from_amps(s["amps"]))
        spec_l = jnp.abs(stft(recon, 2048, 256, pad=True) - stft(target, 2048, 256, pad=True)).sum()
        return spec_l + 0.1 * compute_discontinuity(to_blocks(recon, block))

    @jax.jit
    def step(s, o):   # scripts/energy_overfit.py:77-82
        loss, grads = jax.value_and_grad(loss_fn)(s)
        updates, o = opt.update(grads, o, s)
        return optax.apply_updates(s, updates), o, loss

    t0 = time.perf_counter()
    o, jl = opt.init(state), []
    for _ in range(args.steps):
        state, o, loss = step(state, o)
        jl.append(float(loss))
    t1 = time.perf_counter()
    run = teo.overfit_energy(iterations=args.steps, tiny=args.tiny,
                             target=torch.from_numpy(seg), device="cpu", log=lambda s: None)
    t2 = time.perf_counter()
    report("energy" + (" tiny" if args.tiny else ""), jl, run.losses, (t1 - t0, t2 - t1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
