#!/usr/bin/env python3
"""``mptpu``'s draws for the splat fit at ``scripts/splat.py``'s defaults,
written for ``tools/splat_silence.py`` to carry onto the card.

    python3 tests/reference/splat_draws.py --out build/splat_draws.pkl [--steps 1]
        [--losses 3] [--files 0,1,2,3]

Writes a pickle of numpy arrays: the flax tree of
``OverfitHierarchicalEvents.init(PRNGKey(0), PRNGKey(0))`` (2^16 samples,
64 events, context 16) under ``params``, the noise of the first
``--steps`` steps, ``uniform(fold_in(PRNGKey(0), i), (1, 1, 2^16), -1, 1)``
as the script's ``model.apply(params, key)`` draws it, under ``noise``
(the tool draws the rest with ``mptpu_torch.utils.jax_random`` and checks
these against its own), and under
``losses`` the first ``--losses`` losses of the script's loss and
``optax.adam(1e-3)`` step, jitted (its guard of non-finite losses left
out), on each demo file placed at the index that
``get_one_audio_segment(seed=0)`` draws (those of ``--files``, by their
place in name order), by file name. Prints those losses and the peak of
the rendered sum after them. Runs ``mptpu`` on JAX-CPU; needs no card.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
N_SAMPLES, N_EVENTS, CONTEXT = 2**16, 64, 16


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    parser.add_argument("--steps", type=int, default=1)
    parser.add_argument("--losses", type=int, default=3)
    parser.add_argument("--files", type=str, default="0,1,2,3")
    args = parser.parse_args()
    os.environ["MPTPU_CACHE"] = tempfile.mkdtemp()
    os.environ.pop("AUDIO_PATH", None)
    sys.path.insert(0, str(ROOT))

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from mptpu.data import datastore, get_one_audio_segment
    from mptpu.models import OverfitHierarchicalEvents, splat_loss_transform

    model = OverfitHierarchicalEvents(n_samples=N_SAMPLES, samplerate=22050, n_events=N_EVENTS,
                                      context_dim=CONTEXT)
    key = jax.random.PRNGKey(0)
    variables = model.init(key, key)
    noise = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, i),
                                                    (1, 1, N_SAMPLES), minval=-1.0, maxval=1.0))
                      for i in range(args.steps)]).astype(np.float32)

    files = sorted(datastore.iter_files(datastore._resolve_path(None), "*.wav"))
    drawn = int(np.random.default_rng(0).integers(len(files)))
    opt = optax.adam(1e-3)
    losses = {}
    for k in (int(i) for i in args.files.split(",")):
        path = files[k]
        order = list(files)
        order[drawn], order[k] = files[k], files[drawn]
        listing = datastore.iter_files
        datastore.iter_files = lambda base, pattern, order=order: iter(order)
        try:
            target = get_one_audio_segment(N_SAMPLES, 22050, seed=0).reshape(1, 1, N_SAMPLES)
        finally:
            datastore.iter_files = listing
        feature = splat_loss_transform(target)

        def loss_fn(params, key, feature=feature):   # scripts/splat.py:58-65
            recon, _, _ = model.apply(params, key)
            summed = jnp.sum(recon, axis=1, keepdims=True)
            return jnp.sum(jnp.abs(feature - splat_loss_transform(summed)))

        @jax.jit
        def step(params, opt_state, key, loss_fn=loss_fn):
            loss, grads = jax.value_and_grad(loss_fn)(params, key)
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        params, opt_state, got = variables, opt.init(variables), []
        for i in range(args.losses):
            params, opt_state, loss = step(params, opt_state, jax.random.fold_in(key, i))
            got.append(float(loss))
        losses[os.path.basename(path)] = got
        recon, _, _ = model.apply(params, key)
        print(f"{os.path.basename(path)}: losses {' / '.join(f'{v:.3f}' for v in got)}; render "
              f"peak {float(jnp.abs(jnp.sum(recon, axis=1)).max()):.3e} after {args.losses} "
              "steps", flush=True)

    as_numpy = jax.tree_util.tree_map(np.asarray, variables)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(dict(params=dict(as_numpy), noise=noise, losses=losses), f)
    print(f"wrote {args.out}: {args.steps} steps of noise, the losses of {len(losses)} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
