#!/usr/bin/env python3
"""Texture synthesis's trajectory in ``mptpu`` (JAX on the CPU) beside the
port's (PyTorch on the CPU), from the same start: 0.01 x a standard normal
draw from a CPU generator seeded with 0, handed to ``mptpu``, at
``scripts/texture.py``'s defaults (2^17 samples, 64 filters, lr 1e-3;
``--tiny``: 2^12 samples, 16 filters), with ``--features texture`` or
``scattering``.

    python3 tests/reference/texture_trajectory.py [--steps 20] [--tiny] [--features texture]

``mptpu`` steps by the script's jitted step (``scripts/texture.py:86-94``),
the port by ``texture_step``. The target stands in for the script's corpus
segment (``get_one_audio_segment(n, seed=5)``, which depends on the order
in which a machine lists the corpus's files): ``synthetic_audio(n, 22050,
n_events=max(4, n / 22050 * 8), seed=5)``, max-normed as the script does.
Prints both losses a step and a JSON line of ``mptpu``'s
(``chip_smoke.TEXTURE_REFERENCE``). The scattering features at 2^17
samples make a (64, 64, 2^17) tensor and its backward, far more than this
CPU takes in minutes: run them at ``--tiny``. About 1 minute at the
defaults with the texture features.
"""

from __future__ import annotations

import argparse
import time

from trajectory_common import report, setup


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--features", choices=("texture", "scattering"), default="texture")
    args = parser.parse_args()
    setup()
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from mptpu.ops.norms import max_norm
    from mptpu.perceptual.gammatone import gammatone_filter_bank
    from mptpu.perceptual.scattering import scattering_transform
    from mptpu.perceptual.texture import AudioTextureFeatures
    from mptpu_torch.data.synthetic import synthetic_audio
    from mptpu_torch.models import texture as ttex
    from mptpu_torch.train.optim import Adam

    n = 2**12 if args.tiny else 2**17
    n_filters = 16 if args.tiny else 64
    seg = synthetic_audio(n, 22050, n_events=max(4, int(n / 22050 * 8)), seed=5)
    target = max_norm(jnp.asarray(seg).reshape(1, 1, -1))
    if args.features == "texture":
        featurize = AudioTextureFeatures(n, n_filters=n_filters, filter_size=64,
                                         min_band_size=min(512, n))
    else:
        bank = jnp.asarray(gammatone_filter_bank(n_filters, 128, band_spacing="geometric"))

        def featurize(x):   # scripts/texture.py:71-76
            c1, c2 = scattering_transform(x.reshape(x.shape[0], -1), bank)
            return jnp.concatenate([c1.reshape(x.shape[0], -1), c2.reshape(x.shape[0], -1)],
                                   axis=-1)

    target_features = featurize(target)
    init = torch.randn((1, 1, n), generator=torch.Generator().manual_seed(0)) * 0.01
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p, s):   # scripts/texture.py:86-94
        def loss_fn(q):
            return jnp.abs(featurize(max_norm(q)) - target_features).sum()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    t0 = time.perf_counter()
    params, jl = jnp.asarray(init.numpy()), []
    state = opt.init(params)
    for _ in range(args.steps):
        params, state, loss = step(params, state)
        jl.append(float(loss))
    t1 = time.perf_counter()
    tf = ttex.texture_featurizer(args.features, n, args.tiny, "cpu")
    tfeat = tf(ttex.max_norm(torch.from_numpy(seg).reshape(1, 1, -1)))
    x = init.clone().requires_grad_()
    adam = Adam(1e-3)
    st, tl = adam.init([x]), []
    for _ in range(args.steps):
        loss, st = ttex.texture_step(x, adam, st, tf, tfeat)
        tl.append(float(loss))
    report(f"texture {args.features}" + (" tiny" if args.tiny else ""), jl, tl,
           (t1 - t0, time.perf_counter() - t1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
