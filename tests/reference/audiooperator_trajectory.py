#!/usr/bin/env python3
"""The audio operator trainer's trajectories in ``mptpu`` (JAX on the CPU)
beside the port's (PyTorch on the CPU), from the same parameters and
batches: the port's seed-0 ``AudioOperator`` carried into ``mptpu`` by
``convert.module_to_flax``, every batch drawn by the port's ``make_batch``
from a CPU generator seeded with 0 (as ``train_audiooperator`` draws them)
and fed to both. ``scripts/audiooperator.py``'s widths (512 bands, model
512, latent 64, envelope 128, batch 4, pool 512 / 128, max_freq 2,048, lr
1e-3) at ``--n-samples`` (default 2^13: the script's 2^15 takes some 12 GiB
a package on the CPU), both the random-batch steps and the ``--overfit``
steps on the first batch.

    python3 tests/reference/audiooperator_trajectory.py [--steps 10] [--n-samples 8192]

``mptpu`` steps by the script's jitted step (``scripts/audiooperator.py:
96-119``) with the batch as its argument, the port by ``operator_step``;
each side encodes the sample times itself. Prints both losses a step and
a JSON line of ``mptpu``'s per branch. About 3 minutes and 3 GiB.
"""

from __future__ import annotations

import argparse
import time

from trajectory_common import flax_params, report, setup


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--n-samples", type=int, default=2**13)
    parser.add_argument("--smoke", action="store_true")
    args = parser.parse_args()
    setup()
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from mptpu.models.audiooperator import (AudioOperator as JOperator, band_pos_encode,
                                            envelope_loss)
    from mptpu_torch.models import audiooperator as tao
    from mptpu_torch.train.optim import Adam

    w = dict(n_samples=args.n_samples, n_bands=512, model_dim=512, envelope_resolution=128,
             latent_dim=64, pool_window=512, pool_step=128)
    if args.smoke:
        w = dict(tao.SMOKE)
    n, nb, batch = w["n_samples"], w["n_bands"], 4
    jm = JOperator(envelope_resolution=w["envelope_resolution"], latent_dim=w["latent_dim"],
                   pos_encoding_dim=2 * nb, model_dim=w["model_dim"])
    times = jnp.broadcast_to(jnp.linspace(0.0, 1.0, n).reshape(1, 1, -1), (batch, 1, n))
    times_enc = jax.jit(lambda v: band_pos_encode(v, nb, max_freq=2048.0))(times)
    t_enc = tao.times_encoding(batch, n, nb, 2048.0, "cpu")
    opt = optax.adam(1e-3)

    def loss_fn(p, b):
        target, es, ed, envs, latents = b
        return envelope_loss(target, jm.apply(p, es, ed, envs, latents, times_enc),
                             w["pool_window"], w["pool_step"])

    @jax.jit
    def step(p, s, b):
        loss, grads = jax.value_and_grad(loss_fn)(p, b)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    for overfit in (False, True):
        gen = torch.Generator().manual_seed(0)

        def new_batch():
            return tao.make_batch(gen, batch, n, nb, 2048.0, w["envelope_resolution"],
                                  w["latent_dim"], "cpu")

        first = new_batch()
        batches = [first if overfit else new_batch() for _ in range(args.steps)]
        tm = tao.AudioOperator(w["envelope_resolution"], w["latent_dim"], 2 * nb,
                               w["model_dim"], torch.Generator().manual_seed(0), "cpu")
        params = flax_params(tm)
        t0 = time.perf_counter()
        state, jl = opt.init(params), []
        for b in batches:
            params, state, loss = step(params, state, tuple(jnp.asarray(v.numpy()) for v in b))
            jl.append(float(loss))
        t1 = time.perf_counter()
        adam = Adam(1e-3)
        st = adam.init(list(tm.parameters()))
        tl = []
        for b in batches:
            loss, st = tao.operator_step(tm, adam, st, b, t_enc, w["pool_window"],
                                         w["pool_step"])
            tl.append(float(loss))
        report(f"audiooperator {'overfit' if overfit else 'random'} at {n} samples", jl, tl,
               (t1 - t0, time.perf_counter() - t1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
