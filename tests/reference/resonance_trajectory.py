#!/usr/bin/env python3
"""The resonance-stack overfit's trajectory in ``mptpu`` (JAX on the CPU)
beside the port's (PyTorch on the CPU), from the same parameters and noise:
the port's seed-0 ``OverfitResonanceStack`` carried into ``mptpu`` by
``convert.module_to_flax``, at ``scripts/resonance_overfit.py``'s
defaults (2^15 samples, 128 f0s, depth 2, lr 1e-3; ``--tiny``: 2^12).

    python3 tests/reference/resonance_trajectory.py [--steps 30] [--tiny] [--write-noise]

``mptpu`` steps by the script's jitted step (``scripts/resonance_overfit.py:
98-116``) with step ``i``'s key ``fold_in(PRNGKey(0), i)``; the port by
``overfit_resonance`` fed those keys' draws, ``uniform(key, (1, 4096), -1,
1)`` (the same at both sizes). The target stands in for the script's
corpus segment, which depends on the order in which a machine lists the
corpus's files: ``synthetic_audio(n, 22050, n_events=max(4, n / 22050 *
8), seed=9)``. Prints both losses a step, the range of the frozen seed-0
model's loss over the same draws, and a JSON line of ``mptpu``'s
(``chip_smoke.PERCEPTUAL_REFERENCE``); ``--write-noise`` saves the draws as
``tests/reference/resonance_noise.npy``, which ``chip_smoke.py`` feeds the
card. About 2 minutes and 3 GiB at the defaults.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time

import numpy as np

from trajectory_common import ROOT, flax_params, report, setup

NOISE = ROOT / "tests" / "reference" / "resonance_noise.npy"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--write-noise", action="store_true")
    args = parser.parse_args()
    setup()
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from mptpu.losses.autocorrelation import AutocorrelationLoss, DecayLoss
    from mptpu.losses.multiband_spec import flattened_multiband_spectrogram as fmbs
    from mptpu_torch.data.synthetic import synthetic_audio
    from mptpu_torch.models import resonance_overfit as tro

    spec = importlib.util.spec_from_file_location("resonance_script",
                                                  ROOT / "scripts" / "resonance_overfit.py")
    script = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = script
    spec.loader.exec_module(script)

    n = 2**12 if args.tiny else 2**15
    seg = synthetic_audio(n, 22050, n_events=max(4, int(n / 22050 * 8)), seed=9)
    target = jnp.asarray(seg).reshape(1, 1, -1)
    tm = tro.OverfitResonanceStack(n, generator=torch.Generator().manual_seed(0), device="cpu")
    params = flax_params(tm)
    jm = script.OverfitResonanceStack(n_samples=n)
    ac = AutocorrelationLoss(n_channels=32, filter_size=128)
    dl = DecayLoss(n, n_decays=8, window_size=256)
    opt = optax.adam(1e-3)

    def loss_fn(p, key):   # scripts/resonance_overfit.py:98-108
        recon = jm.apply(p, key)
        s = jnp.abs(fmbs(recon, stft_spec={"s": (64, 16)}, smallest_band_size=512)
                    - fmbs(target, stft_spec={"s": (64, 16)}, smallest_band_size=512)).sum()
        return s + 0.01 * ac(target, recon) + 0.1 * dl(target, recon), recon

    @jax.jit
    def step(p, s, key):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, key)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    key = jax.random.PRNGKey(0)
    keys = [jax.random.fold_in(key, i) for i in range(args.steps)]
    draws = np.stack([np.asarray(jax.random.uniform(k, (1, 4096), minval=-1.0, maxval=1.0))
                      for k in keys])
    if args.write_noise:
        np.save(NOISE, draws.astype(np.float32))
    t0 = time.perf_counter()
    state, jl = opt.init(params), []
    for k in keys:
        params, state, loss = step(params, state, k)
        jl.append(float(loss))
    t1 = time.perf_counter()
    run = tro.overfit_resonance(iterations=args.steps, tiny=args.tiny,
                                target=torch.from_numpy(seg), noise=lambda i: torch.from_numpy(
                                    draws[i]), device="cpu", log=lambda s: None)
    t2 = time.perf_counter()
    frozen_loss = tro.ResonanceLoss(torch.from_numpy(seg).reshape(1, 1, -1))
    with torch.no_grad():
        frozen = [float(frozen_loss(tm(torch.from_numpy(d)))) for d in draws]
    print(f"frozen seed-0 model over the same draws: {min(frozen):.7g} to {max(frozen):.7g}")
    report("resonance" + (" tiny" if args.tiny else ""), jl, run.losses, (t1 - t0, t2 - t1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
