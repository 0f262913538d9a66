#!/usr/bin/env python3
"""Whether the splat fit goes silent, on each file of the demo corpus, on a
CUDA card.

    python3 tools/splat_silence.py [--steps 100] [--draws FILE]

``chip_smoke.py``'s phase 15 (b) fits ``scripts/splat.py``'s defaults (2^16
samples, 64 events, context 16, Adam at 1e-3) for 100 steps to
``get_one_audio_segment(seed=0)``. That seed draws a file index, and the
file at that index depends on the order the file system lists the corpus
in. This fits each of the demo corpus's files in turn, placing it at the
drawn index, and prints for each: the means of the first and last 10
losses, how many of the last 10 differ, the step from which the loss stays
constant, the rendered sum's peak, the events whose render is not zero,
and, as phase 15 reads them, the max-normed reconstruction's peak and the
perturbed render's distance from it.

``--draws FILE`` (written by ``tests/reference/splat_draws.py`` on
JAX-CPU) repeats each fit from ``mptpu``'s initial parameters and with its
per-step noise, ``uniform(fold_in(PRNGKey(0), i))`` drawn by
``mptpu_torch.utils.jax_random`` (checked against the file's first steps),
in place of the port's seed-0 draws, and prints the first losses beside
``mptpu``'s. Prints the card's name and power limit first. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N_SAMPLES, N_EVENTS, CONTEXT = 2**16, 64, 16


def segment_at(datastore, get_one_audio_segment, files, k):
    """``get_one_audio_segment(seed=0)`` with ``files[k]`` at the index the
    seed draws."""
    order = list(files)
    drawn = int(np.random.default_rng(0).integers(len(files)))
    order[drawn], order[k] = files[k], files[drawn]
    listing = datastore.iter_files
    datastore.iter_files = lambda base, pattern: iter(order)
    try:
        return get_one_audio_segment(N_SAMPLES, seed=0, device="cpu").reshape(-1)
    finally:
        datastore.iter_files = listing


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--draws", type=str, default=None)
    args = parser.parse_args(argv)
    os.environ["MPTPU_CACHE"] = tempfile.mkdtemp()
    os.environ.pop("AUDIO_PATH", None)

    import torch

    from mptpu_torch import convert
    from mptpu_torch.data import datastore, get_one_audio_segment
    from mptpu_torch.models.splat_overfit import (OverfitHierarchicalEvents, overfit_splat,
                                                  splat_article, splat_loss,
                                                  splat_loss_transform)
    from mptpu_torch.train.optim import make_train_step, optimizer
    from mptpu_torch.utils import jax_random

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    files = sorted(datastore.iter_files(datastore._resolve_path(None), "*.wav"))
    draws = None
    if args.draws:
        with open(args.draws, "rb") as f:
            draws = pickle.load(f)
        key = jax_random.prng_key(0)
        noise = [jax_random.uniform(jax_random.fold_in(key, i), (1, 1, N_SAMPLES), -1.0, 1.0)
                 for i in range(args.steps)]
        for i, want in enumerate(draws["noise"][:args.steps]):
            if not np.array_equal(noise[i], want):
                print(f"step {i}'s noise is not mptpu's", file=sys.stderr)
                return 1

    for k, path in enumerate(files):
        name = os.path.basename(path)
        target = segment_at(datastore, get_one_audio_segment, files, k)
        fit = overfit_splat(target, n_events=N_EVENTS, event_dim=CONTEXT,
                            n_iterations=args.steps, device=dev)
        losses = fit.losses
        with torch.no_grad():
            rendered, _, _ = fit.model(generator=torch.Generator(device=dev).manual_seed(99))
        demo = splat_article(fit, target)
        constant = next(i for i in range(len(losses)) if len(set(losses[i:])) == 1)
        print(f"{name}, the port's draws: first and last 10 {np.mean(losses[:10]):.4f} -> "
              f"{np.mean(losses[-10:]):.4f}, {len(set(losses[-10:]))} distinct of the last 10, "
              f"constant from step {constant}; render peak "
              f"{float(rendered.sum(1).abs().max()):.3e}, "
              f"{int((rendered.abs().amax(-1) > 0).sum())} of {N_EVENTS} events not zero; "
              f"reconstruction peak {float(demo.recon.abs().max()):.4f} after max-norm, "
              f"perturbed {float((demo.perturbed - demo.recon).abs().max()):.4f} off",
              flush=True)
        if draws is None:
            continue
        model = OverfitHierarchicalEvents(N_SAMPLES, 22050, N_EVENTS, CONTEXT, device="cpu")
        model = convert.splat_from_flax(model, draws["params"]).to(dev)
        target = target.to(dev).reshape(1, 1, -1)
        feature = splat_loss_transform(target)
        now = {}

        def loss_fn():
            recon, _, _ = model(noise=now["noise"])
            return splat_loss(recon, target, False, feature)

        step = make_train_step(loss_fn, optimizer(model.parameters(), lr=1e-3, b1=0.9,
                                                  b2=0.999))
        carried = []
        for i in range(args.steps):
            now["noise"] = torch.from_numpy(noise[i]).to(dev)
            carried.append(float(step()))
        with torch.no_grad():
            rendered, _, _ = model(noise=now["noise"])
        want = draws.get("losses", {}).get(name, [])
        print(f"{name}, mptpu's draws: render peak {float(rendered.sum(1).abs().max()):.3e}, "
              f"{int((rendered.abs().amax(-1) > 0).sum())} of {N_EVENTS} events not zero, "
              f"{len(set(carried[-10:]))} distinct of the last 10; first losses "
              f"{' / '.join(f'{v:.3f}' for v in carried[:len(want) or 3])}"
              + (f" against mptpu's {' / '.join(f'{v:.3f}' for v in want)}" if want else ""),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
