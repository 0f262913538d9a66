#!/usr/bin/env python3
"""The phase-invariance study's trajectories in ``mptpu`` (JAX on the CPU)
beside the port's (PyTorch on the CPU), from the same start: the port's
(uniform in [-1e-3, 1e-3) from a CPU generator seeded with 0) handed to
``mptpu``'s ``overfit_model``, at ``scripts/phaseinvariance.py``'s
defaults (2^17 samples of its sustained synthetic target, lr 1e-2; the
three transforms: STFT 512 / 256, STFT 2048 / 256, AIM over 128 geometric
gammatone filters of 256 taps; ``--smoke``: 2^13 samples).

    python3 tests/reference/phaseinvariance_trajectory.py [--steps 20] [--smoke]

``mptpu`` steps as ``reconstruct_with_transform`` does
(``scripts/phaseinvariance.py:63-80``: ``overfit_model``, whose jitted
step has the NaN guard) but from the given start; the port by
``tpi.reconstruct_with_transform``. ``mptpu``'s loss of each step is
recorded as the float64 mean of its float32 squared differences, from the
samples the step started from: XLA's float32 mean of the AIM's 2.1M of
them at ``--smoke`` reads 1.8e-5 below that (the port's 1e-8), which the
step itself does not feel (the mean's gradient is exact). Prints both
losses a step and a JSON line of ``mptpu``'s for each transform
(``chip_smoke.PERCEPTUAL_REFERENCE``). About 4 minutes and 5 GiB at the
defaults (the AIM's frames are 128 x 2,045 x 256).
"""

from __future__ import annotations

import argparse
import time

from trajectory_common import report, setup


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--smoke", action="store_true")
    args = parser.parse_args()
    setup()
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from mptpu.ops.stft import stft
    from mptpu.perceptual.aim import auditory_image_model
    from mptpu.perceptual.gammatone import gammatone_filter_bank
    from mptpu.train.overfit import overfit_model
    from mptpu_torch.models import phaseinvariance as tpi
    from mptpu_torch.nn.init import uniform

    n = 2**13 if args.smoke else 2**17
    seg = tpi.phaseinvariance_target(n)
    target = jnp.asarray(seg).reshape(1, 1, -1)
    fb = gammatone_filter_bank(n_filters=128, size=256, band_spacing="geometric")
    jtransforms = {"mag_spec_512": lambda x: stft(x, 512, 256, pad=True),
                   "mag_spec_2048": lambda x: stft(x, 2048, 256, pad=True),
                   "aim": lambda x: auditory_image_model(x, fb, 256, 64)}
    ttransforms = tpi.transforms("cpu")
    init = uniform((1, 1, n), -1e-3, 1e-3, torch.Generator().manual_seed(0))
    for name in tpi.TRANSFORMS:
        transform = jtransforms[name]
        real_repr = transform(target)
        diff = jax.jit(lambda a: transform(a) - real_repr)
        jl, start = [], {"audio": jnp.asarray(init.numpy())}
        prev = [start]

        def record(i, p, loss):
            d = np.asarray(diff(prev[0]["audio"]), np.float64)
            jl.append(float(np.mean(d * d)))
            prev[0] = p

        t0 = time.perf_counter()
        overfit_model(start, lambda p, tgt, key: jnp.mean((transform(p["audio"]) - real_repr) ** 2),
                      target, n_iterations=args.steps, lr=1e-2, after_iteration=record)
        t1 = time.perf_counter()
        run = tpi.reconstruct_with_transform(torch.from_numpy(np.array(seg)).reshape(1, 1, -1),
                                             ttransforms[name], args.steps, init=init)
        report(f"phaseinvariance {name}" + (" smoke" if args.smoke else ""), jl,
               run.step_losses, (t1 - t0, time.perf_counter() - t1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
